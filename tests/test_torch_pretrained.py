"""Pretrained backbone init (``init_w_*``) against the JAX package.

For each (backbone, source) pair of ``_FILES`` a seeded state dict is
written under ``tmp_path`` in the reference's layout for it (torchvision
files with their ``fc`` head, the 4-channel AFFWILD2 stem, ``{'net': sd}``
with DataParallel ``module.`` prefixes, a raw InceptionI3d with its
``logits``, the SavedWeights components of a PRETRAINING run); JAX's
``apply_pretrained`` grafts it into flax trees, the port's loads it into
its modules, and the two are held bitwise equal through
``load_jax_variables``. The two I3D_WSDDA sources (AFFWILD2,
OUR_AFFWILD2) are written there without the trunk's ``logits`` head, the
only layout JAX accepts; the reference's files carry that head, JAX
refuses them and the port drops it, so those files are held instead
against torch's own ``load_state_dict(strict=False)`` of the
reference-keyed module (``test_i3d_wsdda_logits_head_is_dropped``). One
CPU forward (ResNet-18 on a log-mel, IMAGENET weights) is held within the
backbones' 3e-4. Then the errors, the ``.msgpack`` refusal, and a
``Runner`` that logs and freezes what it loaded.
"""
import os
import types

import numpy as np
import pytest
import torch

from jmt_tpu.models import pretrained as jp
from jmt_tpu.models import torch_io as tio
from jmt_tpu.models.resnet18 import ResNet18 as JResNet18
from jmt_tpu_torch import cli
from jmt_tpu_torch.models import pretrained as pp
from jmt_tpu_torch.models.common import init_parameters
from jmt_tpu_torch.models.convert import (load_jax_variables,
                                          synthesize_dead_keys)
from jmt_tpu_torch.models.i3d import I3DTCN
from jmt_tpu_torch.models.resnet18 import ResNet18
from jmt_tpu_torch.models.tsav import TwoStreamBackbones
from jmt_tpu_torch.models.video_resnet import r2plus1d_18
from jmt_tpu_torch.train.runner import Runner

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAIRS = sorted(k for k in jp._FILES)
SUB = {"R2D1": ("vision_r2d1", "r2plus1d"),
       "ResNet18": ("audio_resnet18", "resnet"),
       "I3D": ("vision_i3d", "")}


def test_the_file_table_is_jax_s():
    assert pp._FILES == jp._FILES
    assert PAIRS == sorted(pp._FILES) and len(PAIRS) == 9


def _backbones(seed):
    return init_parameters(
        TwoStreamBackbones(vision_backbones=("R2D1", "I3D"),
                           audio_backbones=("ResNet18",)),
        torch.Generator().manual_seed(seed))


def _rand(shape, rng):
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32))


def _module_sd(backbones, backbone):
    comp, sub = SUB[backbone]
    mod = getattr(backbones, comp)
    return (mod.get_submodule(sub) if sub else mod).state_dict()


def _write(root, backbone, source, seed=1, i3d_logits=False):
    """A seeded file of (backbone, source) in the reference's layout;
    returns the state dict the port should load from it (module keys,
    transforms applied, without num_batches_tracked)."""
    rng = np.random.default_rng(seed)
    src = _backbones(seed + 100)
    sd = {k: v.clone() for k, v in _module_sd(src, backbone).items()}
    want = {k: v.clone() for k, v in sd.items()
            if not k.endswith("num_batches_tracked")}
    if backbone == "R2D1":
        if source == "KINETICS400":
            payload = dict(sd, **{"fc.weight": _rand((400, 512), rng),
                                  "fc.bias": _rand((400,), rng)})
        elif source == "AFFWILD2":
            stem = sd["stem.0.weight"]
            sd["stem.0.weight"] = torch.cat(
                [stem, _rand((45, 1, 1, 7, 7), rng)], dim=1)
            payload = {f"r2plus1d.{k}": v for k, v in sd.items()}
            payload["r2plus1d.fc.1.weight"] = _rand((17, 512), rng)
            payload["r2plus1d.fc.1.bias"] = _rand((17,), rng)
        else:
            payload = synthesize_dead_keys(
                "vision_r2d1", {f"r2plus1d.{k}": v for k, v in sd.items()})
    elif backbone == "ResNet18":
        if source == "IMAGENET":
            w3 = _rand((64, 3, 7, 7), rng)
            sd["conv1.weight"] = w3
            want["conv1.weight"] = torch.from_numpy(
                w3.numpy().mean(axis=1, keepdims=True))
            payload = dict(sd, **{"fc.weight": _rand((1000, 512), rng),
                                  "fc.bias": _rand((1000,), rng)})
        else:
            payload = {f"resnet.{k}": v for k, v in sd.items()}
    else:
        heads = synthesize_dead_keys("vision_i3d", {})
        if not i3d_logits:
            heads = {k: v for k, v in heads.items() if "logits" not in k}
        if source == "KINETICS400":
            want = {k[len("i3d_WSDDA."):]: v for k, v in want.items()
                    if k.startswith("i3d_WSDDA.")}
            payload = {k[len("i3d_WSDDA."):]: v for k, v in sd.items()
                       if k.startswith("i3d_WSDDA.")}
            payload["logits.conv3d.weight"] = _rand((400, 1024, 1, 1, 1),
                                                    rng)
            payload["logits.conv3d.bias"] = _rand((400,), rng)
        elif source == "AFFWILD2":
            payload = {"net": {f"module.{k}": torch.as_tensor(v)
                               for k, v in dict(sd, **heads).items()}}
        else:
            payload = dict(sd, **heads)
    path = os.path.join(root, jp._FILES[(backbone, source)][-1])
    os.makedirs(os.path.dirname(path), exist_ok=True)
    if not (backbone == "I3D" and source == "AFFWILD2"):
        payload = {k: torch.as_tensor(v) for k, v in payload.items()}
    torch.save(payload, path)
    return path, want


def _cfg(root, backbone, source, reduce="MAX"):
    mp = types.SimpleNamespace(
        l_vision_backbones=[b for b in ("R2D1", "I3D") if b == backbone],
        l_audio_backbones=["ResNet18"] if backbone == "ResNet18" else [],
        init_w_R2D1="RANDOM", init_w_ResNet18="RANDOM", init_w_I3D="RANDOM",
        R2D1_ft_dim_reduce=reduce)
    setattr(mp, f"init_w_{backbone}", source)
    return types.SimpleNamespace(model_params=mp,
                                 pretrained_weights_dir=str(root))


def _jax_trees(backbones):
    """The flax variables of the port's backbones (the JAX package's own
    torch converters), as JAX's ``init_state`` would hold them."""
    def arrays(backbone):  # copies: the port loads in place
        return {k: v.numpy().copy()
                for k, v in _module_sd(backbones, backbone).items()}

    r2d1 = tio.video_resnet_vars(arrays("R2D1"))
    rn = tio.resnet18_vars(arrays("ResNet18"))
    i3d = tio.i3d_tcn_vars(arrays("I3D"))
    trees = {"vision_r2d1": r2d1, "audio_resnet18": rn, "vision_i3d": i3d}
    return ({"backbones": {c: t["params"] for c, t in trees.items()}},
            {"backbones": {c: t["batch_stats"] for c, t in trees.items()}})


def _jax_module(backbone, params, stats):
    """The port module loaded from JAX's grafted trees."""
    comp = SUB[backbone][0]
    variables = {"params": params["backbones"][comp],
                 "batch_stats": stats["backbones"][comp]}
    fresh = {"R2D1": r2plus1d_18, "ResNet18": ResNet18,
             "I3D": I3DTCN}[backbone]()
    return load_jax_variables(fresh, variables)


@pytest.mark.parametrize("backbone,source", PAIRS,
                         ids=[f"{b}-{s}" for b, s in PAIRS])
def test_apply_pretrained_matches_jax_bitwise(backbone, source, tmp_path):
    path, want = _write(tmp_path, backbone, source)
    cfg = _cfg(tmp_path, backbone, source)
    port = _backbones(0)
    params, stats = _jax_trees(port)
    params, stats, jreport = jp.apply_pretrained(cfg, params, stats)
    report = pp.apply_pretrained(cfg, types.SimpleNamespace(backbones=port))
    assert report == jreport == {SUB[backbone][0]: path}
    got = _module_sd(port, backbone)
    if backbone == "I3D" and source == "KINETICS400":
        # the trunk loaded, the TCN left as initialized on both sides
        got = {k[len("i3d_WSDDA."):]: v for k, v in got.items()
               if k.startswith("i3d_WSDDA.")}
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    jgot = _jax_module(backbone, params, stats).state_dict()
    full = _module_sd(port, backbone)
    assert jgot.keys() == full.keys()
    for k in jgot:
        assert torch.equal(jgot[k], full[k]), k


def test_imagenet_resnet18_forward_matches_jax(tmp_path):
    """The IMAGENET-loaded ResNet-18 on a log-mel, port against JAX, f32:
    within 3e-4 (the backbones' bound)."""
    _write(tmp_path, "ResNet18", "IMAGENET", seed=4)
    cfg = _cfg(tmp_path, "ResNet18", "IMAGENET")
    port = _backbones(0)
    params, stats = _jax_trees(port)
    params, stats, _ = jp.apply_pretrained(cfg, params, stats)
    pp.apply_pretrained(cfg, types.SimpleNamespace(backbones=port))
    spec = np.random.default_rng(5).normal(size=(2, 64, 104)).astype(
        np.float32)
    want = np.asarray(JResNet18(in_channels=1).apply(
        {"params": params["backbones"]["audio_resnet18"],
         "batch_stats": stats["backbones"]["audio_resnet18"]},
        spec[..., None]))
    with torch.inference_mode():
        got = port.audio_resnet18.resnet.eval()(
            torch.from_numpy(spec)[:, None])
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=3e-4)


@pytest.mark.parametrize("source", ["AFFWILD2", "OUR_AFFWILD2"])
def test_i3d_wsdda_logits_head_is_dropped(source, tmp_path):
    """An I3D_WSDDA file with its trunk's 400-class ``logits`` head (the
    reference's, and every SavedWeights ``vision_i3d.pt``): the port drops
    the head and loads what it loads without it; JAX refuses the file
    (a recorded difference). The witness, independent of both loaders:
    the file as the reference reads it (``net`` unwrapped, ``module.``
    stripped) through torch's ``load_state_dict(strict=False)`` into a
    fresh module with the reference's keys, which must find every key it
    needs and leave out only the dead heads; trunk and TCN then equal
    what the port loaded, every key."""
    path, want = _write(tmp_path, "I3D", source, i3d_logits=True)
    cfg = _cfg(tmp_path, "I3D", source)
    port = _backbones(0)
    pp.apply_pretrained(cfg, types.SimpleNamespace(backbones=port))
    got = _module_sd(port, "I3D")
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    raw = torch.load(path, map_location="cpu", weights_only=True)
    raw = {k[len("module."):] if k.startswith("module.") else k: v
           for k, v in raw.get("net", raw).items()}
    witness = _backbones(7).vision_i3d
    res = witness.load_state_dict(raw, strict=False)
    assert res.missing_keys == []
    assert {k.split(".")[0] if not k.startswith("i3d_WSDDA.")
            else ".".join(k.split(".")[:2])
            for k in res.unexpected_keys} == {
        "i3d_WSDDA.logits", "predictions", "vregressor", "aregressor"}
    wsd = witness.state_dict()
    assert wsd.keys() == got.keys()
    for k in wsd:
        assert torch.equal(wsd[k], got[k]), k
    params, stats = _jax_trees(_backbones(0))
    with pytest.raises(ValueError, match="logits"):
        jp.apply_pretrained(cfg, params, stats)


def test_random_everywhere_is_a_no_op(tmp_path):
    cfg = _cfg(tmp_path, "R2D1", "RANDOM")
    port = _backbones(0)
    before = {k: v.clone() for k, v in port.state_dict().items()}
    assert pp.apply_pretrained(cfg, types.SimpleNamespace(
        backbones=port)) == {}
    assert all(torch.equal(before[k], v)
               for k, v in port.state_dict().items())


def test_missing_directory_and_file_raise_as_jax(tmp_path):
    model = types.SimpleNamespace(backbones=_backbones(0))
    cfg = _cfg("", "ResNet18", "IMAGENET")
    with pytest.raises(ValueError, match="pretrained_weights_dir"):
        pp.apply_pretrained(cfg, model)
    cfg = _cfg(tmp_path, "ResNet18", "IMAGENET")
    with pytest.raises(FileNotFoundError) as port_err:
        pp.apply_pretrained(cfg, model)
    params, stats = _jax_trees(_backbones(0))
    with pytest.raises(FileNotFoundError) as jax_err:
        jp.apply_pretrained(cfg, params, stats)
    assert str(port_err.value) == str(jax_err.value)


def test_shape_mismatch_and_unexpected_keys_are_collected(tmp_path):
    """Every unexpected key and shape mismatch in one ValueError, worded
    as JAX's (``pretrained grafting failed:`` then one line each); the
    module is left as it was."""
    rng = np.random.default_rng(2)
    sd = {k: v.clone() for k, v in _module_sd(_backbones(1),
                                              "ResNet18").items()}
    sd["layer1.0.conv1.weight"] = _rand((64, 64, 3, 5), rng)
    sd["layer1.0.extra.weight"] = _rand((3,), rng)
    torch.save({f"resnet.{k}": v for k, v in sd.items()},
               os.path.join(tmp_path, "audio_TSAV_Sub4_544k.pt"))
    cfg = _cfg(tmp_path, "ResNet18", "AFFWILD2")
    port = _backbones(0)
    before = {k: v.clone() for k, v in port.state_dict().items()}
    with pytest.raises(ValueError) as err:
        pp.apply_pretrained(cfg, types.SimpleNamespace(backbones=port))
    msg = str(err.value)
    assert msg.startswith("pretrained grafting failed:\n  ")
    assert ("audio_resnet18[AFFWILD2]: shape mismatch at "
            "layer1.0.conv1.weight: init (64, 64, 3, 3) vs checkpoint "
            "(64, 64, 3, 5)") in msg
    assert "audio_resnet18[AFFWILD2]: unexpected key layer1.0.extra.weight" \
        in msg
    assert all(torch.equal(before[k], v)
               for k, v in port.state_dict().items())
    params, stats = _jax_trees(_backbones(0))
    with pytest.raises(ValueError, match="shape mismatch") as jerr:
        jp.apply_pretrained(cfg, params, stats)
    assert str(jerr.value).startswith("pretrained grafting failed:\n  ")


def test_a_missing_key_raises_key_error(tmp_path):
    sd = dict(_module_sd(_backbones(1), "ResNet18"))
    del sd["bn1.running_var"]
    torch.save({f"resnet.{k}": v for k, v in sd.items()},
               os.path.join(tmp_path, "audio_TSAV_Sub4_544k.pt"))
    cfg = _cfg(tmp_path, "ResNet18", "AFFWILD2")
    with pytest.raises(KeyError, match="bn1.running_var"):
        pp.apply_pretrained(cfg, types.SimpleNamespace(
            backbones=_backbones(0)))
    params, stats = _jax_trees(_backbones(0))
    with pytest.raises(KeyError):
        jp.apply_pretrained(cfg, params, stats)


def test_our_affwild2_r2d1_needs_max_reduce(tmp_path):
    _write(tmp_path, "R2D1", "OUR_AFFWILD2")
    model = types.SimpleNamespace(backbones=_backbones(0))
    trees = _jax_trees(_backbones(0))
    for apply in (lambda c: pp.apply_pretrained(c, model),
                  lambda c: jp.apply_pretrained(c, *trees)):
        with pytest.raises(AssertionError):
            apply(_cfg(tmp_path, "R2D1", "OUR_AFFWILD2", reduce="MEAN"))


def test_msgpack_component_is_refused_naming_the_converter(tmp_path):
    d = os.path.join(tmp_path, "I3D_OUR_AffWild2", "SavedWeights")
    os.makedirs(d)
    open(os.path.join(d, "vision_i3d.msgpack"), "wb").close()
    cfg = _cfg(tmp_path, "I3D", "OUR_AFFWILD2")
    with pytest.raises(ValueError, match="--export-pt"):
        pp.apply_pretrained(cfg, types.SimpleNamespace(
            backbones=_backbones(0)))


def test_runner_logs_loads_and_freezes_pretrained_weights(tmp_path):
    """A ResNet-18 PRETRAINING run from an IMAGENET file: the Runner logs
    ``Loaded pretrained weights [audio_resnet18]: <file>``, its backbone
    holds the file's weights (conv1 the RGB mean) and, frozen, still holds
    them bitwise after a train epoch."""
    weights = tmp_path / "weights"
    path, want = _write(weights, "ResNet18", "IMAGENET", seed=6)
    argv = ["--l_vision_backbones", "None", "--l_audio_backbones",
            "ResNet18", "--goal", "PRETRAINING", "--compute_dtype",
            "float32", "--train_params__batch_size", "2",
            "--train_params__stride", "480", "--init_w_ResNet18",
            "IMAGENET", "--pretrained_weights_dir", str(weights),
            "--verbose", "False", "--outd", str(tmp_path / "exps")]
    cfg = cli.build_config(cli.parse_args(argv))
    train, val, test, store = cli.make_datasets(cfg, "2:481:16")
    runner = Runner(cfg, train, val, wavlm_store=store, test_ds=test,
                    device="cpu")
    logged = []
    runner.log = types.SimpleNamespace(log=logged.append)
    runner.initialize()
    assert f"Loaded pretrained weights [audio_resnet18]: {path}" in logged
    resnet = runner.model.backbones.audio_resnet18
    assert not any(p.requires_grad for p in resnet.parameters())
    for k, v in want.items():
        assert torch.equal(resnet.resnet.state_dict()[k], v), k
    runner.train_epoch(0)
    for k, v in want.items():
        assert torch.equal(resnet.resnet.state_dict()[k], v), k
