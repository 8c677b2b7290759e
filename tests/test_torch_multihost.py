"""The port's pod contracts on the CPU, with gloo ranks.

Counterpart of ``tests/test_multihost.py`` and the multi-process parts of
``test_multiproc_real.py`` and ``test_preemption.py``, for
``jmt_tpu_torch.parallel.mesh`` (one rank per card):

* the host-sharded loader: per-rank strides of one shuffle, disjoint,
  exhaustive and lockstep (filler batches with ``n_valid = 0``), whose
  blocks make the global batch of one process;
* ``process_rows``, ``shard_batch`` and ``Runner._device_arrays`` with a
  patched ``proc_info`` (as JAX's tests patch theirs);
* the collectives on two spawned ranks: ``gather_rows`` in rank order,
  bf16 bit for bit; ``all_gather_rows`` differentiable, its backward
  the sum over ranks (a loss that every rank computes whole comes back
  world times); ``preempt.agreed()`` True
  on every rank when the last rank alone is flagged;
* ``_assert_pod_resume_agreement`` (a patched gather), and a fit that
  writes nothing off rank 0 (a patched ``is_main_process``);
* a 2-rank ``Runner.fit`` against a 1-rank fit: the ranks agree exactly,
  the valid CCC within 2e-3 of the one-process run (JAX's pod bound,
  ``tests/test_multiproc_real.py``), the parameters within 1e-2 (its
  bound on the weights; the ranks' global batches are a permutation of
  one process's, each row with the colour factors of its position, so
  the BN statistics move apart by ~1% as well), rank 1's
  experiment root empty; with rank 1 alone preempted, both ranks stop at
  the same step and rank 0 saves.
"""
import os
import types

import numpy as np
import pytest
import torch

import torch_ranks
from jmt_tpu_torch.data.datasets import collate
from jmt_tpu_torch.data.loader import PrefetchLoader
from jmt_tpu_torch.data.synthetic import synthetic_dataset
from jmt_tpu_torch.parallel import mesh as M
from jmt_tpu_torch.train.runner import Runner

SYNTHETIC = (2, 481, 16)
FIT_CFG = {
    "exp_id": "pod", "goal": "PRETRAINING", "SEED": 0,
    "mesh_data_parallel": -1, "async_checkpoint": False,
    "train_params": {"stride": 120, "loader_params": {"batch_size": 4}},
    "val_params": {"stride": 240, "loader_params": {"batch_size": 4}},
    "model_params": {"l_vision_backbones": "R2D1", "l_audio_backbones": "",
                     "freeze_vision_R2D1": False, "R2D1_ft_dim_reduce": "MAX",
                     "max_epochs": 1, "compute_dtype": "float32"}}


def _tiny_ds():
    return synthetic_dataset("train", n_videos=2, length=481, stride=481,
                             img_size=16, check_coverage=False)


def test_host_shards_disjoint_exhaustive_lockstep():
    ds = _tiny_ds()
    n = len(ds)
    assert n >= 2
    l0, l1 = (PrefetchLoader(ds, 2, shuffle=True,
                             rng=np.random.default_rng(7),
                             host_shard=(i, 2)) for i in range(2))
    b0, b1 = list(l0._index_batches()), list(l1._index_batches())
    assert len(b0) == len(b1) == len(l0) == len(l1)
    all0, all1 = np.concatenate(b0), np.concatenate(b1)
    assert set(all0) & set(all1) == set()
    assert set(all0) | set(all1) == set(range(n))


def test_lockstep_filler_batches():
    """More ranks than samples: the last rank's batches are all filler,
    one sample each, as many as the first rank's real ones."""
    ds = _tiny_ds()
    count = len(ds) + 1
    loaders = [PrefetchLoader(ds, 2, host_shard=(i, count))
               for i in range(count)]
    assert len({len(ld) for ld in loaders}) == 1
    first, last = list(loaders[0]), list(loaders[-1])
    assert len(first) == len(last) == len(loaders[-1]) >= 1
    assert all(b.n_valid is None for b in first)
    assert all(b.n_valid == 0 and b.clips.shape[0] == 1 for b in last)


def test_two_process_blocks_equal_single_process_batch():
    ds = _tiny_ds()
    whole = PrefetchLoader(ds, 4, shuffle=True, rng=np.random.default_rng(3))
    l0, l1 = (PrefetchLoader(ds, 2, shuffle=True,
                             rng=np.random.default_rng(3),
                             host_shard=(i, 2)) for i in range(2))
    for g, a, b in zip(whole._index_batches(), l0._index_batches(),
                       l1._index_batches()):
        assert set(g) == set(a) | set(b)


def test_process_rows(monkeypatch):
    monkeypatch.setattr(M, "proc_info", lambda: (1, 4))
    assert M.process_rows(8) == slice(2, 4)
    with pytest.raises(ValueError, match="split"):
        M.process_rows(6)
    monkeypatch.setattr(M, "proc_info", lambda: (0, 1))
    assert M.process_rows(8) == slice(0, 8)


def test_shard_batch_and_device_arrays_branches(monkeypatch):
    """A global batch keeps the rank's block; a host-sharded one is the
    rank's already. ``_device_arrays`` pads to the global or the per-rank
    batch and its row weights mark the real rows (a filler: none)."""
    x = {"a": np.arange(32, dtype=np.float32).reshape(8, 4)}
    monkeypatch.setattr(M, "proc_info", lambda: (1, 2))
    out = M.shard_batch(x, "cpu")
    np.testing.assert_array_equal(out["a"].numpy(), x["a"][4:])
    out = M.shard_batch(x, "cpu", distributed_load=True)
    np.testing.assert_array_equal(out["a"].numpy(), x["a"])
    ds = _tiny_ds()
    fake = types.SimpleNamespace(procs=(1, 2), device=torch.device("cpu"))
    batch = collate([ds[0], ds[1], ds[0]])
    arrays, n_real = Runner._device_arrays(fake, batch, 4)
    assert n_real == 3 and arrays["clips"].shape[0] == 2
    np.testing.assert_array_equal(arrays["row_weight"].numpy(), [1, 0])
    np.testing.assert_array_equal(arrays["labels_v"].numpy()[0],
                                  batch.labels_v[2])
    arrays, n_real = Runner._device_arrays(fake, collate([ds[1]]), 4,
                                           distributed_load=True)
    assert n_real == 1
    np.testing.assert_array_equal(arrays["row_weight"].numpy(), [1, 0])
    filler = collate([ds[0]])
    filler.n_valid = 0
    arrays, n_real = Runner._device_arrays(fake, filler, 4,
                                           distributed_load=True)
    assert n_real == 0 and not arrays["row_weight"].numpy().any()


def test_gather_rows_one_process():
    x = torch.arange(6, dtype=torch.bfloat16).reshape(3, 2)
    np.testing.assert_array_equal(M.gather_rows(x),
                                  np.arange(6, dtype=np.float32).reshape(3, 2))
    assert M.proc_info() == (0, 1)


def test_collectives_on_two_ranks():
    r0, r1 = M.spawn_ranks(torch_ranks.collectives, 2, device="cpu",
                           timeout=300)
    for rank, r in enumerate((r0, r1)):
        assert r["proc_info"] == (rank, 2)
        np.testing.assert_array_equal(
            r["gather"], np.repeat([0, 0, 1, 1], 3).reshape(4, 3))
        want = torch.tensor([[1 + 2 ** -7, -0.0], [1 + 2 ** -6, -0.0]],
                            dtype=torch.bfloat16).view(torch.int16)
        np.testing.assert_array_equal(r["gather_bf16"][:, 0],
                                      want[:, 0].numpy())
        np.testing.assert_array_equal(r["gathered"], [1.0, 2.0])
        # L = sum of the gathered x^2 on each of 2 ranks: 2 * 2 x_r
        np.testing.assert_array_equal(r["gather_grad"], [4.0 * (rank + 1)])
        np.testing.assert_array_equal(r["agree"], [[0, 7], [1, 7]])
        assert not r["agreed_none"] and r["agreed_last"]
        assert r["requested"] == (rank == 1)
        assert r["rows"] == slice(4 * rank, 4 * rank + 4)


def test_pod_resume_agreement(monkeypatch):
    """``fit`` fails at once when the ranks restored different
    checkpoints."""
    ns = types.SimpleNamespace(procs=(0, 2), _mid_epoch=None)
    monkeypatch.setattr(M, "all_agree",
                        lambda v: np.stack([np.asarray(v)] * 2))
    Runner._assert_pod_resume_agreement(ns, 3)
    monkeypatch.setattr(M, "all_agree", lambda v: np.stack(
        [np.asarray(v), np.zeros_like(np.asarray(v))]))
    with pytest.raises(RuntimeError, match="shared"):
        Runner._assert_pod_resume_agreement(ns, 3)
    ns_mid = types.SimpleNamespace(procs=(0, 2), _mid_epoch={"step": 5})
    monkeypatch.setattr(M, "all_agree", lambda v: np.stack(
        [np.asarray(v), np.asarray([v[0], -1])]))
    with pytest.raises(RuntimeError, match="disagreement"):
        Runner._assert_pod_resume_agreement(ns_mid, 3)
    Runner._assert_pod_resume_agreement(
        types.SimpleNamespace(procs=(0, 1), _mid_epoch=None), 0)


def test_fit_writes_nothing_off_main_process(tmp_path, monkeypatch):
    monkeypatch.setattr(M, "is_main_process", lambda: False)
    out = torch_ranks.fit(1, FIT_CFG, str(tmp_path), SYNTHETIC)
    assert np.isfinite(out["perfs"]["best"]["valid_v"])
    assert out["files"] == []
    assert not os.path.exists(tmp_path / "rank1")


@pytest.fixture(scope="module")
def one_rank_fit(tmp_path_factory):
    return torch_ranks.fit(0, FIT_CFG, str(tmp_path_factory.mktemp("one")),
                           SYNTHETIC)


def test_two_rank_fit_matches_one_rank(one_rank_fit, tmp_path):
    r0, r1 = M.spawn_ranks(torch_ranks.fit, 2, FIT_CFG, str(tmp_path),
                           SYNTHETIC, device="cpu", timeout=600)
    assert r0["perfs"] == r1["perfs"]
    for k in r0["weights"]:
        np.testing.assert_array_equal(r0["weights"][k], r1["weights"][k])
    assert r1["files"] == []
    assert "passed.txt" in " ".join(r0["files"])
    one = one_rank_fit["perfs"]["best"]
    two = r0["perfs"]["best"]
    for key in ("valid_v", "valid_a"):
        assert np.isfinite(two[key])
        assert abs(two[key] - one[key]) <= 2e-3, (key, two[key], one[key])
    for k, w in one_rank_fit["weights"].items():
        if not k.endswith(("running_mean", "running_var",
                           "num_batches_tracked")):
            np.testing.assert_allclose(r0["weights"][k], w, rtol=0,
                                       atol=1e-2, err_msg=k)


def test_preempted_rank_stops_every_rank_at_the_same_step(tmp_path):
    cfg = dict(FIT_CFG, preempt_save_steps=1)
    r0, r1 = M.spawn_ranks(torch_ranks.fit, 2, cfg, str(tmp_path),
                           SYNTHETIC, 1, device="cpu", timeout=600)
    assert r0["perfs"]["preempted"] and r1["perfs"]["preempted"]
    assert r0["steps"] == r1["steps"] == 1
    assert "id_pod/preempted.txt" in r0["files"]
    assert "id_pod/SavedWeights/train_state.pt" in r0["files"]
    assert r1["files"] == []
