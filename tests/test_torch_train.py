"""The port's train and eval steps against the JAX package, fp32 on CPU.

At the size of ``test_torch_model.py`` (B=2, S=4, 32 px), inputs from numpy
seeds, weights carried over with ``load_jax_variables`` and back with
``state_dict_from_jax``:

* train-mode BN: one ResNet-18 forward in train mode on 8 spectrograms,
  outputs atol 1e-4 (measured 1.5e-5: each BN divides the convolutions'
  rounding by a batch std taken over as few as 64 values; the eval-mode
  backbone bound is 3e-4), running statistics atol 1e-6 against the JAX
  ``batch_stats`` after
  ``mutable=["batch_stats"]``; one I3D ``Unit3D`` with its momentum 0.01;
* the colour augmentation with explicit factors, atol 1e-5;
* two SGD steps (Nesterov, weight decay 1e-4, lr 1e-2, dropout 0) of the
  ``slice`` and ``light`` configurations with every backbone frozen, and
  of ``light`` with ResNet-18 finetuned, against ``jax.jit`` of the JAX
  ``make_train_step`` with the colour factors the JAX step draws: the
  bounds of ``BOUNDS`` on the loss, on each trainable tensor's update (new
  - old, resolved to an ulp of the new value) and on the finetuned BN's
  running statistics; frozen parameters and BN buffers bit-identical to
  before; a -5 label slot and a zero ``row_weight`` row in the batch.
  ``slice`` holds the loss at 1e-5 and every tensor's update within 1e-3
  of its own largest |update|. The others are held looser, to their
  measured spread: at random init the ``light`` model's outputs barely
  depend on its inputs (the step's largest update is 2.9e-6, float32
  cancellation leaves its small gradients 3-20% accurate), and in train
  mode a ResNet-18's float32 backward is 4% off float64 on BOTH sides
  (``test_train_mode_resnet18_backward_is_as_close_to_float64_as_jax``),
  so the finetuned configuration's second step starts from parameters
  that already differ;
* the eval step: bitwise equal to the serving forward on the same arrays,
  and to the JAX ``make_eval_step`` at atol 2e-5;
* the K3 gate and the entry points' refusal to run without a card.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from jmt_tpu.core.config import Config as JConfig
from jmt_tpu.data import transforms as jtransforms
from jmt_tpu.models.i3d import Unit3D as JUnit3D
from jmt_tpu.models.jmt_model import JMTModel as JJMTModel
from jmt_tpu.models.resnet18 import ResNet18 as JResNet18
from jmt_tpu.train import loops as jloops
from jmt_tpu.train import optim as jopt
from jmt_tpu_torch.core.config import Config, ModelParams, OptimParams
from jmt_tpu_torch.data.transforms import preprocess_clips
from jmt_tpu_torch.models import convert
from jmt_tpu_torch.models.common import init_parameters
from jmt_tpu_torch.models.i3d import InceptionModule, Unit3D
from jmt_tpu_torch.models.jmt_model import JMTModel
from jmt_tpu_torch.models.resnet18 import ResNet18
from jmt_tpu_torch.ops.kernels import inception as k3
from jmt_tpu_torch.serve import InferenceServer
from jmt_tpu_torch.train import loops
from jmt_tpu_torch.train.state import param_count

torch.set_num_threads(2)

B, S, PX = 2, 4, 32
CONFIGS = {
    "slice": (dict(vision_backbones=("R2D1",),
                   audio_backbones=("ResNet18", "wavLM"),
                   intra_modal_fusion="encoder_plus_self_attention"), ()),
    "light": (dict(vision_backbones=("R2D1",),
                   audio_backbones=("ResNet18",)), ()),
    "light_finetune_resnet18": (dict(vision_backbones=("R2D1",),
                                     audio_backbones=("ResNet18",)),
                                ("ResNet18",)),
}
OPT = dict(lr=1e-2, momentum=0.9, nesterov=True, weight_decay=1e-4)
KEYS = (jax.random.PRNGKey(11), jax.random.PRNGKey(12))


def _np_tree(tree):
    return jax.tree.map(lambda x: np.array(x, copy=True), tree)


def _arrays(seed=0, wavlm=True):
    rng = np.random.default_rng(seed)
    audio = (0.1 * rng.normal(size=(B, S, 45599))).astype(np.float32)
    audio[1, 2] = 0.0
    out = {"clips": rng.integers(0, 256, (B, S, 8, PX, PX, 3),
                                 dtype=np.uint8),
           "audio": audio,
           "labels_v": rng.uniform(-1, 1, (B, S)).astype(np.float32),
           "labels_a": rng.uniform(-1, 1, (B, S)).astype(np.float32)}
    out["labels_v"][0, 3] = -5.0
    out["labels_a"][0, 3] = -5.0
    if wavlm:
        out["wavlm"] = rng.normal(size=(B, S, 768)).astype(np.float32)
    return out


def _configs(cfg, finetune):
    """(JAX config, port config): the model's backbones, its intra-modal
    fusion, its freeze flags, SGD with Nesterov momentum."""
    mp = dict(l_vision_backbones=list(cfg["vision_backbones"]),
              l_audio_backbones=list(cfg["audio_backbones"]),
              intra_modal_fusion=cfg.get("intra_modal_fusion", "None"),
              freeze_vision_R2D1="R2D1" not in finetune,
              freeze_audio_ResNet18="ResNet18" not in finetune)
    jmp = dict(mp, opt=dict(OPT))
    jcfg = JConfig.from_dict({"train_params": {}, "val_params": {},
                              "test_params": {}, "model_params": jmp})
    return jcfg, Config(model_params=ModelParams(**mp,
                                                 opt=OptimParams(**OPT)))


def _color_factors(key):
    """The factors the JAX train step draws from ``key``."""
    pre_key, _ = jax.random.split(key)
    kc = jax.random.split(pre_key, 3)[2]
    return tuple(torch.from_numpy(np.array(x))
                 for x in jtransforms.sample_color_factors(kc, B * S))


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def jax_run(request):
    """The JAX side of one configuration: initial variables, the eval
    step's V/A at init, then two train steps' losses and variables."""
    cfg, finetune = CONFIGS[request.param]
    jm = JJMTModel(**cfg, finetune=finetune)
    jcfg, pcfg = _configs(cfg, finetune)
    arrays = _arrays(wavlm="wavLM" in cfg["audio_backbones"])
    arrays["row_weight"] = np.array([1.0, 0.0], np.float32)
    tx = jopt.build_optimizer(jcfg.model_params.opt)
    state = jloops.init_state(jm, jcfg, jax.random.PRNGKey(0), arrays, tx)

    def variables(st):
        return _np_tree({"params": st.params(),
                         "batch_stats": st.batch_stats})

    run = {"name": request.param, "cfg": cfg, "finetune": finetune,
           "pcfg": pcfg, "arrays": arrays, "variables": [variables(state)]}
    v, a = jloops.make_eval_step(jm)(state, arrays)
    run["eval"] = (np.asarray(v), np.asarray(a))
    step = jloops.make_train_step(jm, tx)
    run["losses"] = []
    for key in KEYS:
        state, loss, _, _ = step(state, arrays, key)
        run["losses"].append(float(loss))
        run["variables"].append(variables(state))
    return run


def _port_state(run):
    model = JMTModel(**run["cfg"], finetune=run["finetune"])
    state = loops.init_state(
        model, run["pcfg"], device="cpu",
        variables_hook=lambda m: convert.load_jax_variables(
            m, run["variables"][0]))
    return model, state


def _snapshot(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


# per step: (loss atol, update bound as a share of the step's largest
# |update|, running-statistics atol); None: not compared. Measured:
# slice 3e-4 of each tensor's own largest update; light 1.2e-2; light
# finetuned 2.5e-2 and statistics 6.9e-6 in step 1, then a loss 4.9e-5
# apart, 27% in the stem conv's update and statistics 1.3e-3 in step 2
BOUNDS = {"slice": [(1e-5, 1e-3, None)] * 2,
          "light": [(1e-5, 2e-2, None)] * 2,
          "light_finetune_resnet18": [(1e-5, 5e-2, 2e-5),
                                      (1e-4, None, 5e-3)]}


def test_train_steps_match_jax(jax_run):
    run = jax_run
    model, state = _port_state(run)
    step = loops.make_train_step(model, device="cpu")
    backbones = ("backbones.vision_r2d1.", "backbones.audio_resnet18.")
    finetuned = tuple(f"backbones.{m}." for name, m in
                      (("ResNet18", "audio_resnet18"),
                       ("R2D1", "vision_r2d1")) if name in run["finetune"])
    assert all(n.startswith(finetuned) or not n.startswith(backbones)
               for n in state.trainable)
    assert state.frozen and all(n.startswith(backbones)
                                for n in state.frozen)
    assert param_count(model, state.trainable) + param_count(
        model, state.frozen) == param_count(model)
    bounds = BOUNDS[run["name"]]
    for i, key in enumerate(KEYS):
        loss_tol, upd_tol, stat_tol = bounds[i]
        before = _snapshot(model)
        loss, v, a = step(state, run["arrays"], color_factors=_color_factors(
            key))
        assert v.shape == a.shape == (B, S)
        assert abs(float(loss) - run["losses"][i]) <= loss_tol, (
            float(loss), run["losses"][i])
        after = model.state_dict()
        want = convert.state_dict_from_jax(model, run["variables"][i + 1])
        old = convert.state_dict_from_jax(model, run["variables"][i])
        upds = {n: ((after[n] - before[n]).numpy(), want[n] - old[n])
                for n in state.trainable}
        step_scale = max(np.abs(w).max() for _, w in upds.values())
        for name, (upd, upd_want) in upds.items():
            scale = np.abs(upd_want).max()
            assert scale > 0 and np.abs(upd).max() > 0, name
            if upd_tol is None:
                continue
            # new - old resolves an update only to an ulp of the new value
            # (weight decay alone moves some tensors by 1e-7)
            err = np.maximum(np.abs(upd - upd_want)
                             - np.spacing(np.abs(want[name])), 0).max()
            assert err <= upd_tol * step_scale, (name, err, step_scale)
            if run["name"] == "slice":
                assert err <= 1e-3 * scale, (name, err, scale)
        for name, x in after.items():
            frozen_buffer = name.startswith(backbones) and \
                not name.startswith(finetuned)
            if name in state.frozen or frozen_buffer:
                assert torch.equal(x, before[name]), name
            elif name.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(x.numpy(), want[name], rtol=0,
                                           atol=stat_tol, err_msg=name)
                assert not torch.equal(x, before[name]), name


def test_eval_step_matches_serving_and_jax(jax_run):
    run = jax_run
    model, state = _port_state(run)
    eval_step = loops.make_eval_step(model, device="cpu")
    arrays = dict(run["arrays"])
    v, a = eval_step(state, arrays)
    server = InferenceServer(model, seq=S, buckets=(B,), img_size=PX,
                             device="cpu")
    sv, sa = server.predict(arrays["clips"], arrays["audio"],
                            arrays.get("wavlm"))
    np.testing.assert_array_equal(v.numpy(), sv)
    np.testing.assert_array_equal(a.numpy(), sa)
    np.testing.assert_allclose(v.numpy(), run["eval"][0], rtol=0, atol=2e-5)
    np.testing.assert_allclose(a.numpy(), run["eval"][1], rtol=0, atol=2e-5)


def test_train_mode_resnet18_matches_jax_batch_stats():
    """One forward in train mode: batch statistics, biased variance to
    normalize, unbiased to update, momentum 0.1."""
    x = np.random.default_rng(5).normal(size=(B * S, 64, 104, 1)).astype(
        np.float32)
    jm = JResNet18(in_channels=1)
    variables = _np_tree(jax.jit(jm.init)(jax.random.PRNGKey(1), x))
    want, upd = jm.apply(variables, x, False, mutable=["batch_stats"])
    model = convert.load_jax_variables(ResNet18(), variables)
    model.train()
    got = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=1e-4)
    sd = convert.state_dict_from_jax(
        model, {"params": variables["params"],
                "batch_stats": _np_tree(upd["batch_stats"])})
    stats = [k for k in sd if k.endswith(("running_mean", "running_var"))]
    assert len(stats) == 2 * 20
    for k in stats:
        np.testing.assert_allclose(model.state_dict()[k].numpy(), sd[k],
                                   rtol=0, atol=1e-6, err_msg=k)
    assert int(model.bn1.num_batches_tracked) == 1


def test_train_mode_resnet18_backward_is_as_close_to_float64_as_jax(
        monkeypatch):
    """A random cotangent through a train-mode ResNet-18 on 8 spectrograms:
    the port's float32 gradients are no farther from float64 (the port's
    own module in double) than the JAX package's float32 ones. Both are
    several percent of a tensor's largest gradient off in the worst
    tensor, which bounds the train-step comparison of finetuned
    configurations (``BOUNDS``)."""
    x = np.random.default_rng(5).normal(size=(B * S, 64, 104, 1)).astype(
        np.float32)
    ct = np.random.default_rng(6).normal(size=(B * S, 512)).astype(
        np.float32)
    jm = JResNet18(in_channels=1)
    variables = _np_tree(jax.jit(jm.init)(jax.random.PRNGKey(1), x))

    def jloss(params):
        out, _ = jm.apply({"params": params,
                           "batch_stats": variables["batch_stats"]},
                          x, False, mutable=["batch_stats"])
        return jnp.sum(out * ct)

    jgrads = convert.state_dict_from_jax(
        ResNet18(), {"params": _np_tree(jax.grad(jloss)(variables["params"])),
                     "batch_stats": variables["batch_stats"]})

    def grads(dtype):
        model = convert.load_jax_variables(ResNet18(), variables).to(dtype)
        model.train()
        out = model(torch.from_numpy(x).to(dtype).permute(0, 3, 1, 2))
        (out * torch.from_numpy(ct).to(dtype)).sum().backward()
        return {n: p.grad.double().numpy()
                for n, p in model.named_parameters()}

    got = grads(torch.float32)
    # the reference in double: BN as well (it casts to float32 otherwise)
    monkeypatch.setattr(
        "jmt_tpu_torch.ops.norm.TorchBatchNorm.forward",
        lambda self, x: torch.nn.functional.batch_norm(
            x, self.running_mean, self.running_var, self.weight, self.bias,
            training=self.training, momentum=self.momentum, eps=self.eps))
    exact = grads(torch.float64)

    def worst(g):
        return max(np.abs(g[n] - exact[n]).max() / np.abs(exact[n]).max()
                   for n in exact)

    assert worst(got) <= 2 * worst(jgrads) + 1e-6, (worst(got),
                                                     worst(jgrads))


def test_train_mode_unit3d_momentum_matches_jax():
    x = np.random.default_rng(6).normal(size=(2, 4, 6, 6, 3)).astype(
        np.float32)
    jm = JUnit3D(8, 3, (3, 3, 3))
    variables = _np_tree(jax.jit(jm.init)(jax.random.PRNGKey(2), x))
    variables["batch_stats"]["bn"]["mean"] += 0.5
    want, upd = jm.apply(variables, x, False, mutable=["batch_stats"])
    unit = Unit3D(3, 8, (3, 3, 3))
    assert unit.bn.momentum == 0.01 and not unit.bn.training
    unit.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in {
        **convert.inv_conv(variables["params"], "conv3d"),
        **convert.inv_bn(variables["params"]["bn"],
                         variables["batch_stats"]["bn"], "bn")}.items()})
    unit.train()
    got = unit(torch.from_numpy(x).permute(0, 4, 1, 2, 3))
    np.testing.assert_allclose(got.detach().permute(0, 2, 3, 4, 1).numpy(),
                               np.asarray(want), rtol=0, atol=1e-5)
    new = upd["batch_stats"]["bn"]
    np.testing.assert_allclose(unit.bn.running_mean.numpy(),
                               np.asarray(new["mean"]), rtol=0, atol=1e-6)
    np.testing.assert_allclose(unit.bn.running_var.numpy(),
                               np.asarray(new["var"]), rtol=0, atol=1e-6)


def test_color_augmentation_matches_jax():
    rng = np.random.default_rng(7)
    clips = rng.integers(0, 256, (5, 8, 12, 10, 3), dtype=np.uint8)
    bf, cf = jtransforms.sample_color_factors(jax.random.PRNGKey(3), 5)
    bf, cf = np.array(bf), np.array(cf)
    bf[0], cf[1] = 1.4, 0.3      # saturating brightness, strong contrast
    want = np.asarray(jtransforms.preprocess_clips(
        jnp.asarray(clips), jnp.asarray(bf), jnp.asarray(cf), augment=True))
    got = preprocess_clips(torch.from_numpy(clips), torch.from_numpy(bf),
                           torch.from_numpy(cf), augment=True)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    plain = preprocess_clips(torch.from_numpy(clips))
    assert np.abs(got.numpy() - plain.numpy()).max() > 0.1


def test_frozen_backbones_stay_in_eval_mode_in_training():
    model = JMTModel(vision_backbones=("R2D1", "I3D"),
                     audio_backbones=("ResNet18",),
                     intra_modal_fusion="feat_concat_fc",
                     finetune=("ResNet18",))
    model.train()
    bb = model.backbones
    assert not bb.vision_r2d1.training and not bb.vision_i3d.training
    assert bb.audio_resnet18.resnet.bn1.training
    assert model.fusion_model.vregressor[2].training
    model.finetune_bn = "frozen"
    model.train()
    assert not bb.audio_resnet18.resnet.bn1.training
    model.eval()
    assert not any(m.training for m in model.modules())


def _module(fused=True):
    m = InceptionModule(16, (8, 8, 8, 4, 8, 8), fused=fused)
    init_parameters(m, torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(8).normal(
        size=(1, 16, 4, 6, 6)).astype(np.float32)).relu()
    return m, x


def test_inception_train_mode_bn_takes_the_unfused_path(monkeypatch):
    calls = []
    monkeypatch.setattr(
        "jmt_tpu_torch.models.i3d.inception_module_fused",
        lambda *a, **kw: calls.append(1) or k3.inception_module_fused(
            *a, **kw))
    m, x = _module()
    m.requires_grad_(False)
    with torch.no_grad():
        m(x)
    assert calls == [1]
    m.train()
    ref, _ = _module(fused=False)
    ref.load_state_dict(m.state_dict())
    ref.train()
    with torch.no_grad():
        torch.testing.assert_close(m(x), ref(x), rtol=0, atol=0)
    assert calls == [1]


def test_inception_fused_module_that_needs_a_gradient_raises():
    """A finetuned I3D with the flag on and running-statistics BN would
    need K3's backward, which does not exist."""
    m, x = _module()
    with pytest.raises(NotImplementedError, match="i3d_fused_inception"):
        m(x)
    model = JMTModel(vision_backbones=("I3D",), audio_backbones=("wavLM",),
                     i3d_fused_inception=True, finetune=("I3D",),
                     finetune_bn="frozen")
    model.train()
    clips = torch.zeros(1, 1, 8, 16, 16, 3)
    with pytest.raises(NotImplementedError, match="i3d_fused_inception"):
        model(None, clips, torch.zeros(1, 1, 768))


def test_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg, finetune = CONFIGS["light"]
    _, pcfg = _configs(cfg, finetune)
    model = JMTModel(**cfg)
    for call in (lambda: loops.init_state(model, pcfg),
                 lambda: loops.make_train_step(model),
                 lambda: loops.make_eval_step(model)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    state = loops.init_state(model, pcfg, torch.Generator().manual_seed(0),
                             device="cpu")
    assert loops.make_eval_step(model, device="cpu") and state.trainable


def test_init_state_refuses_a_model_that_disagrees_with_the_config():
    cfg, _ = CONFIGS["light"]
    _, pcfg = _configs(cfg, ())
    with pytest.raises(ValueError, match="finetunes"):
        loops.init_state(JMTModel(**cfg, finetune=("ResNet18",)), pcfg,
                         device="cpu")
