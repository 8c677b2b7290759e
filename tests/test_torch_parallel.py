"""Data parallelism: a 2-rank train step against JAX's single-device step.

Counterpart of ``tests/test_parallel.py`` for ``jmt_tpu_torch.parallel.
mesh`` and ``train/loops.make_train_step`` under a process group:

* ``make_mesh`` (-1 is the world; a mesh that the launch does not match
  raises naming ``torch.distributed.run``), the backend rule,
  ``init_distributed`` without ``torchrun``'s variables, ``pad_batch_to``;
* two gloo ranks, each with its half of a global batch (B = 4, S = 2,
  32 px, fp32, row 3 weight 0), take one train step, against
  ``jax.jit`` of JAX's ``make_train_step`` on the whole batch with the
  same colour factors (the ranks get their rows of them):
  - ``slice`` (R2D1 + ResNet-18 & wavLM, encoder_plus_self_attention,
    frozen backbones): the ranks' losses equal each other and JAX's
    within 1e-4, every trainable tensor's update within 1e-3 of the
    step's largest |update|, frozen tensors unchanged. The labels of
    rank 0's rows lie 0.8 above those of rank 1's, so that the mean of
    the ranks' own CCC losses (plain DDP's loss) is more than ten times
    the bound from the global one; the test asserts that gap;
  - R2D1 alone (``PRETRAINING``) finetuned, batch-statistics BN: the
    loss within 1e-4, every BN's running statistics within 1e-5 of JAX's
    global ones and its count, the updates within 5e-2 of the step's
    largest, ``test_torch_train.py``'s bound for a finetuned backbone's
    first step. That bound is float32's, not the port's: in one process
    the same step with the global-statistics BN formula in place of
    ``F.batch_norm`` moves R2D1's stem update by 8e-3 of the step's
    largest, and the 2-rank step's stem update lay 2.7e-2 from JAX's with
    a frozen ResNet-18 beside R2D1 (cancellation in a train-mode BN
    backward, as ``test_torch_train.py`` finds for ResNet-18). Each
    rank's own batch statistics (plain DDP's BN) lie more than ten times
    the statistics bound from JAX's; the test asserts that gap.
"""
import numpy as np
import pytest
import torch

import jax

import torch_ranks
from jmt_tpu.data import transforms as jtransforms
from jmt_tpu.models.jmt_model import JMTModel as JJMTModel
from jmt_tpu.train import loops as jloops
from jmt_tpu.train import optim as jopt
from jmt_tpu_torch.models import convert
from jmt_tpu_torch.models.jmt_model import JMTModel
from jmt_tpu_torch.ops.ccc import ccc_loss
from jmt_tpu_torch.parallel import mesh as M
from test_torch_train import OPT, _configs, _np_tree

B, S, PX = 4, 2, 32
KEY = jax.random.PRNGKey(11)
LOSS_TOL, STAT_TOL = 1e-4, 1e-5
CASES = {
    "slice": (dict(vision_backbones=("R2D1",),
                   audio_backbones=("ResNet18", "wavLM"),
                   intra_modal_fusion="encoder_plus_self_attention"), (),
              1e-3),
    "r2d1_finetune": (dict(vision_backbones=("R2D1",), audio_backbones=(),
                           goal="PRETRAINING"), ("R2D1",), 5e-2)}


def test_make_mesh_is_the_world():
    assert M.make_mesh(-1) == M.make_mesh(1) == 1
    assert M.make_mesh(-1, n_dcn=1) == 1
    for n_data, n_dcn in ((2, 1), (1, 2), (-1, 2)):
        with pytest.raises(ValueError, match="torch.distributed.run"):
            M.make_mesh(n_data, n_dcn=n_dcn)


def test_backend_rule(monkeypatch):
    assert M.choose_backend(torch.device("cpu"), 2) == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert M.choose_backend(torch.device("cuda", 0), 2) == "nccl"
    assert M.choose_backend(torch.device("cuda", 0), 4) == "gloo"


def test_init_distributed_without_torchrun_is_a_no_op(monkeypatch):
    for var in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    assert M.init_distributed() is None
    assert M.proc_info() == (0, 1) and M.is_main_process()
    assert M.host_shard() == (0, 1)


def test_pad_batch_to():
    arrays = {"x": np.ones((3, 2), np.float32),
              "w": np.ones(3, np.float32)}
    padded, n_real = M.pad_batch_to(arrays, 4)
    assert n_real == 3 and padded["x"].shape == (4, 2)
    assert padded["x"][3].sum() == 0 and padded["w"][3] == 0
    same, n = M.pad_batch_to(arrays, 3)
    assert n == 3 and same["x"] is arrays["x"]


def _arrays(wavlm):
    rng = np.random.default_rng(1)
    out = {"clips": rng.integers(0, 256, (B, S, 8, PX, PX, 3),
                                 dtype=np.uint8),
           "audio": (0.1 * rng.normal(size=(B, S, 45599))).astype(
               np.float32),
           "labels_v": rng.uniform(-0.2, 0.2, (B, S)).astype(np.float32),
           "labels_a": rng.uniform(-0.2, 0.2, (B, S)).astype(np.float32),
           "row_weight": np.array([1, 1, 1, 0], np.float32)}
    for k in ("labels_v", "labels_a"):
        out[k][:B // 2] += 0.4
        out[k][B // 2:] -= 0.4
    if wavlm:
        out["wavlm"] = rng.normal(size=(B, S, 768)).astype(np.float32)
    return out


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    """JAX's single-device step on the global batch, and the port's step
    on two gloo ranks."""
    cfg, finetune, upd_tol = CASES[request.param]
    jm = JJMTModel(**cfg, finetune=finetune)
    # a config lists an audio backbone; the R2D1-alone model has none,
    # and the flags of one it does not have freeze nothing
    jcfg, _ = _configs(dict(cfg, audio_backbones=cfg["audio_backbones"]
                            or ("ResNet18",)), finetune)
    arrays = _arrays("wavLM" in cfg["audio_backbones"])
    tx = jopt.build_optimizer(jcfg.model_params.opt)
    state = jloops.init_state(jm, jcfg, jax.random.PRNGKey(0), arrays, tx)
    before = _np_tree({"params": state.params(),
                       "batch_stats": state.batch_stats})
    state, loss, vouts, aouts = jloops.make_train_step(jm, tx)(
        state, arrays, KEY)
    after = _np_tree({"params": state.params(),
                      "batch_stats": state.batch_stats})
    pre_key, _ = jax.random.split(KEY)
    kc = jax.random.split(pre_key, 3)[2]
    factors = tuple(np.array(x) for x in
                    jtransforms.sample_color_factors(kc, B * S))
    ranks = M.spawn_ranks(
        torch_ranks.train_step, 2,
        dict(model=cfg, finetune=finetune, opt=OPT, variables=before,
             arrays=arrays, factors=factors, local_bn=bool(finetune)),
        device="cpu", timeout=600)
    model = JMTModel(**cfg, finetune=finetune)
    return dict(name=request.param, upd_tol=upd_tol, arrays=arrays,
                loss=float(loss), vouts=np.asarray(vouts),
                aouts=np.asarray(aouts), ranks=ranks,
                want=convert.state_dict_from_jax(model, after),
                old=convert.state_dict_from_jax(model, before))


def test_two_rank_step_matches_jax_global_step(case):
    r0, r1 = case["ranks"]
    assert r0["loss"] == r1["loss"]
    assert abs(r0["loss"] - case["loss"]) <= LOSS_TOL, (r0["loss"],
                                                        case["loss"])
    np.testing.assert_allclose(np.concatenate([r0["vouts"], r1["vouts"]]),
                               case["vouts"], rtol=0, atol=1e-4)
    assert r0["frozen_same"] and r1["frozen_same"]
    want, old = case["want"], case["old"]
    upds = {n: (r0["updates"][n], want[n] - old[n]) for n in r0["updates"]}
    scale = max(np.abs(w).max() for _, w in upds.values())
    assert scale > 0
    for name, (got, upd_want) in upds.items():
        np.testing.assert_array_equal(got, r1["updates"][name])
        err = np.maximum(np.abs(got - upd_want)
                         - np.spacing(np.abs(want[name])), 0).max()
        assert err <= case["upd_tol"] * scale, (name, err, scale)
    for name, x in r0["buffers"].items():
        np.testing.assert_array_equal(x, r1["buffers"][name])
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(x, want[name], rtol=0,
                                       atol=STAT_TOL, err_msg=name)
        else:  # JAX keeps no count: one update where its statistics moved
            mean = name.replace("num_batches_tracked", "running_mean")
            moved = not np.array_equal(want[mean], old[mean])
            assert int(x) == int(moved), (name, x)
            assert moved == bool(case["name"] == "r2d1_finetune"
                                 and name.startswith("backbones.vision"))


def test_plain_ddp_would_be_off_by_more_than_ten_bounds(case):
    """The mean of the ranks' own CCC losses (on JAX's outputs) and, with
    batch-statistics BN, each rank's own statistics lie more than ten
    times the bounds from the global step's."""
    arrays = case["arrays"]
    rows = (slice(0, B // 2), slice(B // 2, B))
    per_rank = []
    for r in rows:
        w = torch.from_numpy(np.repeat(arrays["row_weight"][r], S))
        per_rank.append(sum(
            float(ccc_loss(torch.tensor(case[o][r]).reshape(-1),
                           torch.tensor(arrays[k][r]).reshape(-1),
                           weight=w))
            for o, k in (("vouts", "labels_v"), ("aouts", "labels_a"))))
    assert abs(np.mean(per_rank) - case["loss"]) > 10 * LOSS_TOL
    if case["name"] != "r2d1_finetune":
        return
    for r in case["ranks"]:
        gap = max(np.abs(x - case["want"][k]).max()
                  for k, x in r["local_stats"].items()
                  if k.startswith("backbones.vision_r2d1"))
        assert gap > 10 * STAT_TOL, gap
