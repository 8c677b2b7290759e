"""Finetuning the backbones: I3D chunking under batch-statistics BN, and
``remat_backbones``, fp32 on CPU.

* I3D chunking (``i3d_chunk``) streams the trunk over clip chunks only
  while the I3D's BN uses running statistics, as the JAX package gates it:
  a finetuned I3D with batch-statistics BN runs the whole batch at once.
  Against JAX's ``TwoStreamBackbones(finetune=("I3D",), i3d_chunk=1)`` in
  train mode: features atol 2e-4 (the I3D parity bound), running
  statistics atol 1e-6, and ``num_batches_tracked`` counting one update.
* ``remat_backbones``: for each backbone finetuned (batch-statistics BN)
  and both granularities, two SGD steps of the port's train step with
  remat against the same steps without it, bit for bit: the loss, every
  gradient, every parameter and BN buffer (``num_batches_tracked`` too).
  The finetuned I3D's TCN dropout is active, so the recomputed masks are
  the first ones. The units that recomputed are counted: the finetuned
  backbone whole, or its blocks / modules; none of a frozen backbone.
"""
import numpy as np
import pytest
import torch

import jax

from jmt_tpu.models.tsav import TwoStreamBackbones as JBackbones
from jmt_tpu_torch.core.config import Config, ModelParams, OptimParams
from jmt_tpu_torch.data.transforms import sample_color_factors
from jmt_tpu_torch.models.common import init_parameters
from jmt_tpu_torch.models.convert import (load_jax_variables,
                                          state_dict_from_jax)
from jmt_tpu_torch.models.jmt_model import JMTModel
from jmt_tpu_torch.models.tsav import TwoStreamBackbones
from jmt_tpu_torch.ops import norm
from jmt_tpu_torch.ops.norm import TorchBatchNorm
from jmt_tpu_torch.train import loops

torch.set_num_threads(2)


def _np_tree(tree):
    return jax.tree.map(lambda x: np.array(x, copy=True), tree)


def _normal(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=shape)).astype(
        np.float32)


def _no_dropout(module):
    for m in module.modules():
        if isinstance(m, torch.nn.Dropout1d):
            m.eval()
    return module


def test_i3d_chunking_is_off_under_batch_statistics_bn():
    """Two clips, chunks of one: with batch-statistics BN the port must
    normalize both clips together and update the running statistics
    once, as JAX does."""
    clips = _normal((1, 2, 4, 16, 16, 3), seed=4)
    kw = dict(vision_backbones=("I3D",), audio_backbones=(),
              i3d_input_size=32, i3d_chunk=1)
    jm = JBackbones(**kw, finetune=("I3D",))
    variables = _np_tree(jax.jit(jm.init)(jax.random.PRNGKey(0), None,
                                          clips))
    want, upd = jax.jit(lambda v, c: jm.apply(
        v, None, c, True, True, mutable=["batch_stats"]))(variables, clips)
    pm = load_jax_variables(TwoStreamBackbones(**kw), variables)
    _no_dropout(pm.train())
    got = pm(None, torch.from_numpy(clips))["vision_i3d"]
    np.testing.assert_allclose(got.detach().numpy(),
                               np.asarray(want["vision_i3d"]), rtol=0,
                               atol=2e-4)
    sd = state_dict_from_jax(pm, {"params": variables["params"],
                                  "batch_stats": _np_tree(
                                      upd["batch_stats"])})
    stats = [k for k in sd if k.endswith(("running_mean", "running_var"))]
    assert len(stats) == 2 * 57
    for k in stats:
        np.testing.assert_allclose(pm.state_dict()[k].numpy(), sd[k],
                                   rtol=0, atol=1e-6, err_msg=k)
    counts = {int(m.num_batches_tracked) for m in pm.modules()
              if isinstance(m, TorchBatchNorm)}
    assert counts == {1}


B, S, PX = 2, 2, 16
OPT = dict(lr=1e-2, momentum=0.9, nesterov=True, weight_decay=1e-4)
# finetuned backbone -> (vision backbones, units recomputed a step at
# "stage": R(2+1)D's 8 blocks; I3D's 2 trunk units and 9 modules, not the
# stem with its fold nor the TCN; ResNet-18 whole)
CASES = {"R2D1": (("R2D1",), 8), "I3D": (("I3D",), 11),
         "ResNet18": (("R2D1",), 1)}


def _arrays(seed=0):
    rng = np.random.default_rng(seed)
    return {"clips": rng.integers(0, 256, (B, S, 8, PX, PX, 3),
                                  dtype=np.uint8),
            "audio": (0.1 * rng.normal(size=(B, S, 45599))).astype(
                np.float32),
            "labels_v": rng.uniform(-1, 1, (B, S)).astype(np.float32),
            "labels_a": rng.uniform(-1, 1, (B, S)).astype(np.float32)}


def _run(finetune, granularity, remat, monkeypatch):
    """Two train steps of a model that finetunes ``finetune``; returns
    (losses, gradients after each step, the final state dict, units
    recomputed)."""
    vision, _ = CASES[finetune]
    mp = ModelParams(l_vision_backbones=list(vision),
                     l_audio_backbones=["ResNet18"],
                     freeze_vision_R2D1=finetune != "R2D1",
                     freeze_vision_I3D=finetune != "I3D",
                     freeze_audio_ResNet18=finetune != "ResNet18",
                     remat_backbones=remat, remat_granularity=granularity,
                     opt=OptimParams(**OPT))
    model = JMTModel(vision_backbones=vision,
                     audio_backbones=("ResNet18",), finetune=(finetune,),
                     i3d_input_size=2 * PX, remat=remat,
                     remat_granularity=granularity)
    state = loops.init_state(model, Config(model_params=mp),
                             torch.Generator().manual_seed(0), device="cpu")
    step = loops.make_train_step(model, device="cpu")
    recomputed = []
    real = norm.recomputing

    def spy():
        recomputed.append(1)
        return real()

    monkeypatch.setattr(norm, "recomputing", spy)
    torch.manual_seed(1)   # the TCN dropout draws from the global RNG
    losses, grads = [], []
    for i in range(2):
        factors = sample_color_factors(torch.Generator().manual_seed(i),
                                       B * S)
        loss, _, _ = step(state, _arrays(i), color_factors=factors)
        losses.append(loss)
        grads.append({n: p.grad.clone() for n, p in model.named_parameters()
                      if p.grad is not None})
    if finetune == "I3D":
        drops = [m for m in model.backbones.vision_i3d.modules()
                 if isinstance(m, torch.nn.Dropout1d)]
        assert drops and all(m.training and m.p > 0 for m in drops)
    return losses, grads, model.state_dict(), len(recomputed)


@pytest.mark.parametrize("granularity", ["backbone", "stage"])
@pytest.mark.parametrize("finetune", sorted(CASES))
def test_remat_changes_no_number(finetune, granularity, monkeypatch):
    losses, grads, sd, n = _run(finetune, granularity, True, monkeypatch)
    want_losses, want_grads, want_sd, n0 = _run(finetune, granularity,
                                                False, monkeypatch)
    per_step = 1 if granularity == "backbone" else CASES[finetune][1]
    assert (n, n0) == (2 * per_step, 0)
    for got, want in zip(losses, want_losses):
        assert torch.equal(got, want), (float(got), float(want))
    for got, want in zip(grads, want_grads):
        assert got.keys() == want.keys() and any(
            k.startswith("backbones.") for k in got)
        for k in want:
            assert torch.equal(got[k], want[k]), k
    assert sd.keys() == want_sd.keys()
    for k in want_sd:
        assert torch.equal(sd[k], want_sd[k]), k
    counts = {int(v) for k, v in sd.items()
              if k.endswith("num_batches_tracked")
              and k.startswith(f"backbones.{_ATTR[finetune]}.")}
    assert counts == {2}


_ATTR = {"R2D1": "vision_r2d1", "I3D": "vision_i3d",
         "ResNet18": "audio_resnet18"}


def test_frozen_or_inference_units_are_not_rematerialized(monkeypatch):
    """A model with remat on whose backbones are all frozen, and a forward
    under ``inference_mode``, run as they do without remat."""
    model = JMTModel(vision_backbones=("R2D1",),
                     audio_backbones=("ResNet18",), remat=True,
                     remat_granularity="stage")
    init_parameters(model, torch.Generator().manual_seed(0))
    monkeypatch.setattr("jmt_tpu_torch.models.common.checkpoint",
                        lambda *a, **kw: pytest.fail("checkpointed"))
    spec, clips = loops.preprocess(model, {k: torch.from_numpy(v)
                                           for k, v in _arrays().items()})
    with torch.inference_mode():
        model(spec, clips)
    model.backbones.requires_grad_(False)
    model.train()
    v, _ = model(spec, clips)
    assert v.requires_grad
    with pytest.raises(ValueError, match="remat_granularity"):
        JMTModel(remat=True, remat_granularity="layer")
