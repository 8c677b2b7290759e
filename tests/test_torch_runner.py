"""The port's Runner against the JAX Runner, fp32 on CPU; SavedWeights.

One JAX ``Runner`` (a module fixture) and one port ``Runner`` take the
same command line: ``config.json`` with the ``slice`` configuration of
``test_torch_train.py`` (R2D1 MAX + ResNet18 & wavLM fused by
encoder_plus_self_attention, JMT SELF_ATTEN), fp32, SGD lr 1e-2,
``--synthetic 3:481:32`` at B = 2 and stride 480 (3 train windows: two
steps, the second with a zero pad row; 6 val windows; stride 1 would
give 96 val windows, too many for a CPU test), from the same
initial weights (the port's, through its SavedWeights and the JAX
``assemble_from_components``), the port fed the colour factors each JAX
step draws.

* one train epoch: train CCC and stitched valid CCC within 1e-5 (the
  loss bound of ``test_torch_train.py``'s ``BOUNDS``: the loss is 1 - CCC
  per output), every trainable tensor's update over the epoch within 1e-3
  of the epoch's largest |update| (``BOUNDS["slice"]``; measured: the V
  head's last bias, which moves 3.4e-6, is 5.6e-9 off);
* the port's ``SavedWeights/*.pt`` hold the keys and values that the JAX
  ``export_reference_pt`` writes for the same weights, and the JAX
  ``assemble_from_components`` on the port's directory gives a JAX eval
  forward within 2e-5 of the port's (V/A, ``test_torch_model.py``'s
  bound);
* a best snapshot and an asynchronous save are CPU copies: weights
  changed in place after them leave both as they were; a failed
  asynchronous write raises at ``wait()``.
"""
import os

import jax
import numpy as np
import pytest
import torch

from jmt_tpu import cli as jcli
from jmt_tpu.core import checkpoint as jckpt
from jmt_tpu.data import transforms as jtransforms
from jmt_tpu.models.torch_export import export_reference_pt
from jmt_tpu.train.runner import Runner as JRunner
from jmt_tpu_torch import cli
from jmt_tpu_torch.core import checkpoint as ckpt
from jmt_tpu_torch.data.datasets import collate
from jmt_tpu_torch.models import convert
from jmt_tpu_torch.train.loops import device_batch
from jmt_tpu_torch.train.runner import Runner, pad_batch_to

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, SYNTHETIC = 2, "3:481:32"


def _argv(outd):
    return ["--config", os.path.join(ROOT, "config.json"),
            "--l_audio_backbones", "ResNet18+wavLM",
            "--intra_modal_fusion", "encoder_plus_self_attention",
            "--output_format", "SELF_ATTEN", "--compute_dtype", "float32",
            "--train_params__batch_size", str(B),
            "--val_params__batch_size", str(B),
            "--train_params__stride", "480", "--opt__lr", "0.01",
            "--mesh_data_parallel", "1", "--max_epochs", "1",
            "--verbose", "False", "--outd", str(outd)]


def _np_tree(tree):
    return jax.tree.map(lambda x: np.array(x, copy=True), tree)


def _variables(jr):
    return _np_tree({"params": jr.state.params(),
                     "batch_stats": jr.state.batch_stats})


def _jax_color_factors(seed, epoch, steps, n_clips):
    """The factors each step of a JAX train epoch draws (its key split
    chain: the runner's per-step split, the step's, the preprocessing's)."""
    key, out = jax.random.PRNGKey(seed + epoch), []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        pre_key, _ = jax.random.split(sub)
        kc = jax.random.split(pre_key, 3)[2]
        out.append(tuple(torch.from_numpy(np.array(x)) for x in
                         jtransforms.sample_color_factors(kc, n_clips)))
    return out


def _port_runner(outd, variables=None):
    cfg = cli.build_config(cli.parse_args(_argv(outd)))
    train, val, test, store = cli.make_datasets(cfg, SYNTHETIC)
    runner = Runner(cfg, train, val, wavlm_store=store, test_ds=test,
                    device="cpu")
    runner.initialize()
    if variables is not None:
        convert.load_jax_variables(runner.model, variables)
    return runner


def _init_from(weights_dir):
    """A stand-in for the JAX ``init_state`` (its eager ``model.init``
    compiles hundreds of small programs): the variables' shapes from
    ``jax.eval_shape``, their values from the SavedWeights in
    ``weights_dir`` through the JAX ``assemble_from_components``."""
    from jmt_tpu.train.loops import _preprocess
    from jmt_tpu.train.state import (TrainState, frozen_prefixes,
                                     partition_params)

    def init_state(model, cfg, rng, arrays, tx, variables_hook=None):
        arrays = {k: v[:1, :1] for k, v in arrays.items()}
        spec, clips = _preprocess(model, arrays, None, augment=False)
        shapes = jax.eval_shape(model.init, rng, spec, clips,
                                arrays.get("wavlm"))

        def zeros(tree):
            return jax.tree.map(lambda s: np.zeros(s.shape, s.dtype),
                                dict(tree))

        params, stats = zeros(shapes["params"]), zeros(shapes["batch_stats"])
        jckpt.assemble_from_components(weights_dir, cfg, params, stats)
        trainable, frozen = partition_params(params, frozen_prefixes(cfg))
        return TrainState(trainable=trainable, frozen=frozen,
                          batch_stats=stats, opt_state=tx.init(trainable),
                          epoch=0)

    return init_state


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The port's initial weights (SavedWeights) and the JAX Runner
    started from them: their reference .pt export, one train epoch and
    its validation, the trained weights."""
    tmp = tmp_path_factory.mktemp("jax")
    port = _port_runner(tmp / "port")
    port.dump_best()
    jcfg = jcli.build_config(jcli.parse_args(_argv(tmp / "exps")))
    train, val, _, store = jcli.make_datasets(jcfg, SYNTHETIC)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr("jmt_tpu.train.runner.init_state",
                   _init_from(port.exp.weights_dir))
        jr = JRunner(jcfg, train, val, wavlm_store=store)
        jr.initialize()
    run = {"runner": jr, "before": _variables(jr), "pt_dir": str(tmp / "pt")}
    jckpt.export_components(run["pt_dir"], jr.state.params(),
                            jr.state.batch_stats)
    run["exported"] = export_reference_pt(run["pt_dir"])
    run["train"] = jr.train_epoch(0)
    run["valid"] = jr.validate()
    run["after"] = _variables(jr)
    run["factors"] = _jax_color_factors(jcfg.SEED, 0, 2, B * 16)
    return run


def test_epoch_matches_the_jax_runner(jax_run, tmp_path):
    runner = _port_runner(tmp_path, jax_run["before"])
    factors = iter(jax_run["factors"])
    runner._color_factors = lambda epoch, step, n: next(factors)
    before = {k: v.clone() for k, v in runner.model.state_dict().items()}
    tm = runner.train_epoch(0)
    assert next(factors, None) is None           # two steps took two
    vm = runner.validate()
    jt, jv = jax_run["train"], jax_run["valid"]
    for got, want in ((tm.train_ccc_v, jt.train_ccc_v),
                      (tm.train_ccc_a, jt.train_ccc_a),
                      (vm.valid_ccc_v, jv.valid_ccc_v),
                      (vm.valid_ccc_a, jv.valid_ccc_a)):
        assert np.isfinite(got) and abs(got - want) <= 1e-5, (got, want)
    after = runner.model.state_dict()
    want_after = convert.state_dict_from_jax(runner.model, jax_run["after"])
    want_before = convert.state_dict_from_jax(runner.model,
                                              jax_run["before"])
    upd = {n: ((after[n] - before[n]).numpy(), want_after[n] - want_before[n])
           for n in runner.state.trainable}
    scale = max(np.abs(w).max() for _, w in upd.values())
    for name, (got, want) in upd.items():
        own = np.abs(want).max()
        if own == 0:  # the visual fusion's fc, unused over 512-d streams
            assert not np.abs(got).max(), name
            continue
        err = np.maximum(np.abs(got - want)
                         - np.spacing(np.abs(want_after[name])), 0).max()
        assert err <= 1e-3 * scale, (name, err, scale)
    for name in runner.state.frozen:
        assert torch.equal(after[name], before[name]), name


def test_saved_weights_are_the_jax_export(jax_run, tmp_path):
    runner = _port_runner(tmp_path, jax_run["before"])
    runner.dump_best()
    wdir = runner.exp.weights_dir
    written = sorted(f[:-3] for f in os.listdir(wdir) if f.endswith(".pt"))
    assert written == sorted(jax_run["exported"]) == sorted(
        ["all_backbones", "audio_resnet18", "vision_r2d1", "fusion_w",
         "transformer_audio_modality_fusion"])
    for name in written:
        got = torch.load(os.path.join(wdir, f"{name}.pt"), weights_only=True)
        want = torch.load(jax_run["exported"][name], weights_only=True)
        assert sorted(got) == sorted(want), name
        for k in want:
            assert got[k].dtype == want[k].dtype, (name, k)
            assert torch.equal(got[k], want[k]), (name, k)


def test_jax_assembles_the_ports_saved_weights(jax_run, tmp_path):
    """The port's trained weights, through SavedWeights, into JAX."""
    runner = _port_runner(tmp_path, jax_run["after"])
    with torch.no_grad():
        for p in runner.model.fusion_model.parameters():
            p.mul_(1.5)                 # weights JAX has not seen
    runner.dump_best()
    jr = jax_run["runner"]
    jr.load_components(runner.exp.weights_dir)
    batch = collate([runner.val_ds[0], runner.val_ds[3]])
    batch.wavlm = runner.wavlm_store.lookup_batch(batch.wav_paths)
    arrays, _ = pad_batch_to(device_batch(batch), B)
    jv, ja = jr.eval_step(jr.state, arrays)
    v, a = runner.eval_step(runner.state, arrays)
    assert float(np.std(np.asarray(jv))) > 1e-4
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=0, atol=2e-5)
    np.testing.assert_allclose(a.numpy(), np.asarray(ja), rtol=0, atol=2e-5)


# ---------------------------------------------------------------------------
# copies, not aliases
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def small_runner(tmp_path_factory):
    """A port Runner of the PRETRAINING configuration on ResNet-18 alone,
    one train epoch taken (momentum buffers exist)."""
    tmp = tmp_path_factory.mktemp("small")
    argv = ["--l_vision_backbones", "None", "--l_audio_backbones",
            "ResNet18", "--goal", "PRETRAINING", "--compute_dtype",
            "float32", "--train_params__batch_size", "2",
            "--val_params__batch_size", "2", "--train_params__stride", "480",
            "--freeze_audio_ResNet18", "False", "--verbose", "False",
            "--outd", str(tmp)]
    cfg = cli.build_config(cli.parse_args(argv))
    train, val, _, _ = cli.make_datasets(cfg, "3:481:16")
    runner = Runner(cfg, train, val, device="cpu")
    runner.initialize()
    runner.train_epoch(0)
    return runner


def _bump(model):
    with torch.no_grad():
        for p in model.parameters():
            p.add_(1.0)
        for name, b in model.named_buffers():
            if name.endswith("running_mean"):
                b.add_(1.0)


def test_best_snapshot_is_a_copy(small_runner):
    r = small_runner
    want = {k: v.clone() for k, v in r.model.state_dict().items()}
    r.snapshot_best()
    _bump(r.model)
    assert set(r._best_snapshot) == set(want)
    for k, v in want.items():
        assert torch.equal(r._best_snapshot[k], v), k
    assert not torch.equal(r.model.state_dict()["backbones.audio_resnet18."
                                                "resnet.conv1.weight"],
                           want["backbones.audio_resnet18.resnet.conv1."
                                "weight"])


def test_async_save_writes_the_weights_of_the_call(small_runner, tmp_path,
                                                   monkeypatch):
    """The writer thread starts only after the weights and momentum
    buffers changed in place: the files still hold those of the call."""
    import threading
    r = small_runner
    go = threading.Event()
    save = ckpt._save

    def held(path, obj):
        assert go.wait(60)
        return save(path, obj)

    monkeypatch.setattr(ckpt, "_save", held)
    conv1 = "backbones.audio_resnet18.resnet.conv1.weight"
    acp = ckpt.AsyncCheckpointer()
    try:
        want = {k: v.clone() for k, v in r.model.state_dict().items()}
        momentum = [s["momentum_buffer"].clone()
                    for s in r.state.optimizer.state.values()]
        assert momentum and all(m.abs().max() > 0 for m in momentum)
        acp.save_train_state(str(tmp_path), r.state, {"best": {"epoch": 1}})
        _bump(r.model)
        for s in r.state.optimizer.state.values():
            s["momentum_buffer"].add_(1.0)
        go.set()
        acp.wait()
        go.clear()
        bumped = r.model.state_dict()[conv1].clone()
        acp.export_components(str(tmp_path), r.model.state_dict())
        _bump(r.model)
        go.set()
    finally:
        go.set()
        acp.close()
    payload = torch.load(tmp_path / ckpt.STATE_FILE, weights_only=True)
    for k, v in want.items():
        assert torch.equal(payload["model"][k], v), k
    got_momentum = [s["momentum_buffer"]
                    for s in payload["optimizer"]["state"].values()]
    assert all(torch.equal(g, w) for g, w in zip(got_momentum, momentum))
    assert payload["extra"] == {"best": {"epoch": 1}}
    comp = torch.load(tmp_path / "audio_resnet18.pt", weights_only=True)
    assert torch.equal(comp["resnet.conv1.weight"], bumped)
    assert not torch.equal(bumped, r.model.state_dict()[conv1])


def test_async_write_failure_surfaces_at_wait(small_runner, tmp_path,
                                              monkeypatch):
    def fail(path, obj):
        raise OSError("disk full")

    monkeypatch.setattr(ckpt, "_save", fail)
    acp = ckpt.AsyncCheckpointer()
    acp.save_train_state(str(tmp_path), small_runner.state)
    with pytest.raises(OSError, match="disk full"):
        acp.wait()
    acp.close()
    assert not os.path.exists(tmp_path / ckpt.STATE_FILE)
