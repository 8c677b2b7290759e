"""Kernel K3's plain version, the weight folding and the port's
InceptionModule against the JAX package, fp32 on CPU.

The JAX kernel runs as its own tests run it here: ``interpret=True``.
Inputs are post-ReLU (the kernel's zero pool padding equals the reference's
-inf padding only then), made with numpy; BN statistics are randomized so
that the folding is really tested. Tolerances are relative to max |ref|:
2e-5, the bound of ``tests/test_inception_pallas.py``; the measured
deviation is ~3e-7.
"""
import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jmt_tpu.ops.inception_pallas as ip
from jmt_tpu.models.i3d import InceptionModule as JInceptionModule
from jmt_tpu.models.i3d import _I3D_STAGES
from jmt_tpu.ops.conv import tf_same_pads as jtf_same_pads
from jmt_tpu_torch.models.convert import (load_jax_variables,
                                          state_dict_from_jax)
from jmt_tpu_torch.models.i3d import I3D_STAGES, InceptionModule
from jmt_tpu_torch.models import i3d as pi3d
from jmt_tpu_torch.ops import inception
from jmt_tpu_torch.ops.conv import tf_same_pads
from jmt_tpu_torch.ops.kernels import inception as k3
from jmt_tpu_torch.ops.kernels.inception import inception_module_fused

torch.set_num_threads(2)

SPEC = (8, 4, 8, 4, 8, 8)


def _relu_x(shape, seed=0):
    """(N, T, H, W, C) >= 0 as numpy f32."""
    return np.maximum(np.random.default_rng(seed).normal(size=shape),
                      0).astype(np.float32)


def _to_port(x):
    """(N, T, H, W, C) numpy -> (N, C, T, H, W) torch, channels-last."""
    return torch.from_numpy(x).permute(0, 4, 1, 2, 3)


def _from_port(y):
    return y.numpy() if y.ndim == 3 else y.permute(0, 2, 3, 4, 1).numpy()


def _random_module_vars(m, x, seed=1):
    """init, then BN scale/bias/mean/var drawn from numpy."""
    v = flax.core.unfreeze(m.init(jax.random.PRNGKey(0), x))
    rng = np.random.default_rng(seed)
    for b in inception.BRANCHES:
        p, s = v["params"][b]["bn"], v["batch_stats"][b]["bn"]
        n = p["scale"].shape[0]
        p["scale"] = jnp.asarray(1 + 0.1 * rng.normal(size=n), jnp.float32)
        p["bias"] = jnp.asarray(0.1 * rng.normal(size=n), jnp.float32)
        s["mean"] = jnp.asarray(0.1 * rng.normal(size=n), jnp.float32)
        s["var"] = jnp.asarray(np.abs(1 + 0.1 * rng.normal(size=n)),
                               jnp.float32)
    return jax.tree.map(np.asarray, v)


def _getter(v, as_torch):
    def get(name):
        p, s = v["params"][name], v["batch_stats"][name]["bn"]
        leaves = (p["kernel"], p["bn"]["scale"], p["bn"]["bias"],
                  s["mean"], s["var"])
        return tuple(torch.from_numpy(np.array(a)) if as_torch
                     else jnp.asarray(a) for a in leaves)
    return get


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("shape,avg_tail", [((2, 4, 7, 7, 16), False),
                                            ((2, 4, 14, 14, 16), False),
                                            ((2, 4, 7, 7, 16), True)])
def test_plain_version_matches_jax_kernel(shape, avg_tail):
    """``inception_plain`` on the port's fold of the weights against the
    JAX kernel (interpret mode) on the JAX fold, at the shapes of
    ``tests/test_inception_pallas.py``."""
    x = _relu_x(shape, seed=2)
    v = _random_module_vars(JInceptionModule(shape[-1], SPEC), x)
    want = np.asarray(ip.inception_module_fused(
        jnp.asarray(x), ip.fold_inception_weights(_getter(v, False),
                                                  jnp.float32),
        SPEC, avg_tail=avg_tail, interpret=True))
    fw = inception.fold_inception_weights(_getter(v, True), torch.float32)
    got = inception.inception_plain(_to_port(x), fw, SPEC, avg_tail=avg_tail)
    assert got.shape == ((2, 3, 32) if avg_tail
                         else (shape[0], 32) + shape[1:4])
    assert _rel(_from_port(got), want) < 2e-5


@pytest.mark.parametrize("shape,pool_in,ht,avg_tail", [
    ((1, 4, 28, 28, 16), ((1, 3, 3), (1, 2, 2)), 0, False),   # multi-tile
    ((1, 4, 28, 28, 16), ((3, 3, 3), (1, 2, 2)), 0, False),   # temporal
    ((1, 4, 14, 14, 16), ((2, 2, 2), (1, 2, 2)), 0, False),   # k = 2
    ((2, 3, 14, 14, 16), ((1, 3, 3), (1, 2, 2)), 7, False),   # one tile
    ((1, 3, 14, 14, 16), ((2, 2, 2), (1, 2, 2)), 0, True)],   # + avg_tail
    ids=["multi_tile", "temporal", "k2", "single_tile", "avg_tail"])
def test_plain_pool_in_matches_jax_kernel(shape, pool_in, ht, avg_tail):
    """``inception_plain(pool_in=...)`` on the pre-pool map against the JAX
    kernel's pool prologue (interpret mode), at the shapes of
    ``tests/test_inception_pallas.py``'s pool-prologue tests."""
    x = _relu_x(shape, seed=9)
    v = _random_module_vars(JInceptionModule(shape[-1], SPEC), x, seed=10)
    want = np.asarray(ip.inception_module_fused(
        jnp.asarray(x), ip.fold_inception_weights(_getter(v, False),
                                                  jnp.float32),
        SPEC, pool_in=pool_in, avg_tail=avg_tail, ht=ht, interpret=True))
    fw = inception.fold_inception_weights(_getter(v, True), torch.float32)
    got = inception.inception_plain(_to_port(x), fw, SPEC, avg_tail=avg_tail,
                                    pool_in=pool_in)
    n, t, h, w = shape[:4]
    assert got.shape == ((n, t - 1, 32) if avg_tail
                         else (n, 32, t, h // 2, w // 2))
    assert _rel(_from_port(got), want) < 2e-5


def test_fold_matches_jax_and_bn_algebra():
    """The port's fold equals the JAX fold (f32, 1e-6), and
    conv(x, k s) + t == BN(conv(x, k)) with running stats, eps 1e-3."""
    x = _relu_x((1, 2, 3, 3, 16), seed=3)
    v = _random_module_vars(JInceptionModule(16, SPEC), x, seed=4)
    jfw = ip.fold_inception_weights(_getter(v, False), jnp.float32)
    pfw = inception.fold_inception_weights(_getter(v, True), torch.float32)
    for name, a, b in zip(pfw._fields, pfw, jfw):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7, err_msg=name)
    rng = np.random.default_rng(5)
    k = torch.from_numpy(rng.normal(size=(1, 1, 1, 4, 8)))
    g, b, mu = (torch.from_numpy(rng.normal(size=8) * s + o)
                for s, o in ((0.1, 1.0), (0.1, 0.0), (0.1, 0.0)))
    var = torch.from_numpy(np.abs(1 + 0.1 * rng.normal(size=8)))
    xx = torch.from_numpy(rng.normal(size=(2, 3, 5, 5, 4)))
    y = torch.einsum("nthwc,co->nthwo", xx, k[0, 0, 0])
    bn = (y - mu) / torch.sqrt(var + 1e-3) * g + b
    kf, bf = inception.fold_bn(k, g, b, mu, var)
    assert bf.dtype == torch.float32
    yf = torch.einsum("nthwc,co->nthwo", xx, kf[0, 0, 0]) + bf
    np.testing.assert_allclose(yf.numpy(), bn.numpy(), atol=1e-5)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("shape,kw", [
    ((2, 4, 14, 14, 16), {}),
    ((2, 4, 7, 7, 16), {"avg_tail": True}),
    ((2, 3, 14, 14, 16), {"pool_in": ((1, 3, 3), (1, 2, 2))}),
    ((1, 4, 14, 14, 16), {"pool_in": ((3, 3, 3), (1, 2, 2))}),
    ((1, 3, 14, 14, 16), {"pool_in": ((2, 2, 2), (1, 2, 2)),
                          "avg_tail": True})])
def test_inception_module_matches_jax(shape, kw, fused):
    """The port's module, unfused (merged 1x1 conv, per-branch BN + ReLU,
    -inf pool padding) and fused (on the CPU: the plain version), against
    the JAX module's unfused path, with ``pool_in`` and ``avg_tail``."""
    x = _relu_x(shape, seed=6)
    jm = JInceptionModule(shape[-1], SPEC, **kw)
    v = _random_module_vars(jm, x, seed=7)
    want = np.asarray(jm.apply(v, x))
    pm = load_jax_variables(InceptionModule(shape[-1], SPEC, fused=fused,
                                            **kw), v)
    with torch.inference_mode():
        got = _from_port(pm(_to_port(x)))
    assert got.shape == want.shape
    assert _rel(got, want) < 2e-5


@pytest.mark.parametrize("shape,kw,absorbed", [
    ((2, 3, 14, 14, 16), {"pool_in": ((1, 3, 3), (1, 2, 2))}, True),
    ((1, 4, 14, 14, 16), {"pool_in": ((3, 3, 3), (1, 2, 2))}, True),
    ((1, 3, 14, 14, 16), {"pool_in": ((2, 2, 2), (1, 2, 2)),
                          "avg_tail": True}, True),
    ((1, 3, 7, 7, 16), {"pool_in": ((2, 2, 2), (1, 2, 2))}, False)],
    ids=["k3", "temporal", "avg_tail", "unabsorbable_7x7"])
def test_absorbed_inception_module_matches_jax(shape, kw, absorbed,
                                               monkeypatch):
    """The port's fused module with the gate ``_ABSORB_POOLS`` on: an
    absorbable pool reaches the kernel's dispatcher as ``pool_in`` with the
    pre-pool x, an odd pre-pool map (7 x 7, native 112 px) is pooled
    outside first, as in JAX; either way equal to the JAX module's
    unfused path (2e-5 of max |ref|)."""
    x = _relu_x(shape, seed=11)
    jm = JInceptionModule(shape[-1], SPEC, **kw)
    v = _random_module_vars(jm, x, seed=12)
    want = np.asarray(jm.apply(v, x))
    pm = load_jax_variables(InceptionModule(shape[-1], SPEC, fused=True,
                                            **kw), v)
    seen = []

    def spy(x, fw, out_channels, *, pool_in=None, avg_tail=False):
        seen.append((tuple(x.shape), pool_in))
        return inception_module_fused(x, fw, out_channels, pool_in=pool_in,
                                      avg_tail=avg_tail)

    monkeypatch.setattr(k3, "_ABSORB_POOLS", True)
    monkeypatch.setattr(pi3d, "inception_module_fused", spy)
    with torch.inference_mode():
        got = _from_port(pm(_to_port(x)))
    pre = (shape[0], shape[4]) + shape[1:4]
    assert seen == ([(pre, kw["pool_in"])] if absorbed
                    else [((1, 16, 3, 4, 4), None)])
    assert got.shape == want.shape
    assert _rel(got, want) < 2e-5


def test_inception_module_keys_and_strict_load():
    x = _relu_x((1, 2, 7, 7, 16))
    v = _random_module_vars(JInceptionModule(16, SPEC), x)
    pm = InceptionModule(16, SPEC)
    sd = state_dict_from_jax(pm, v)
    assert set(sd) == set(pm.state_dict())
    assert {"b0.conv3d.weight", "b1b.bn.running_var",
            "b3b.bn.num_batches_tracked"} <= set(sd)
    assert sd["b1b.conv3d.weight"].shape == (8, 4, 3, 3, 3)
    sd.pop("b2a.bn.weight")
    with pytest.raises(RuntimeError, match="Missing key"):
        pm.load_state_dict({k: torch.from_numpy(np.array(a))
                            for k, a in sd.items()}, strict=True)


def test_dispatcher_on_cpu_is_the_plain_version():
    x = _relu_x((1, 3, 5, 5, 16), seed=8)
    v = _random_module_vars(JInceptionModule(16, SPEC), x)
    fw = inception.fold_inception_weights(_getter(v, True), torch.float32)
    xt = _to_port(x)
    torch.testing.assert_close(inception_module_fused(xt, fw, SPEC),
                               inception.inception_plain(xt, fw, SPEC),
                               rtol=0, atol=0)


def test_stage_table_matches_jax():
    assert I3D_STAGES == _I3D_STAGES


def _stage_shapes(size):
    """(name, (T, H, W), kernel, strides) of every conv and pool stage of
    the I3D at a clip of 8 x size x size, walking the stage table."""
    out, t, h = [], 8, size
    layers = [("Conv3d_1a_7x7", (7, 7, 7), (1, 2, 2))]
    for name, spec in _I3D_STAGES[1:]:
        if name.startswith("MaxPool"):
            layers.append((name, *spec))
        elif name.startswith("Mixed"):
            layers += [(name + ".b1b", (3, 3, 3), (1, 1, 1)),
                       (name + ".pool", (3, 3, 3), (1, 1, 1))]
        else:
            layers.append((name, (1, 1, 1) if "1x1" in name else (3, 3, 3),
                           (1, 1, 1)))
    for name, kernel, strides in layers:
        out.append((name, (t, h, h), kernel, strides))
        pads = jtf_same_pads((t, h, h), kernel, strides)
        t = (t + sum(pads[0]) - kernel[0]) // strides[0] + 1
        h = (h + sum(pads[1]) - kernel[1]) // strides[1] + 1
    return out


@pytest.mark.parametrize("size", [224, 112, 32, 16])
def test_tf_same_pads_every_stage(size):
    """Every conv and pool of the trunk at 224 and 112 px and at the test
    sizes (32, 16 px, where maps reach 1 x 1 and pads turn asymmetric)."""
    shapes = _stage_shapes(size)
    assert len(shapes) == 25
    for name, sizes, kernel, strides in shapes:
        assert tf_same_pads(sizes, kernel, strides) == \
            jtf_same_pads(sizes, kernel, strides), (name, sizes)
    if size == 224:  # the pool-4a case: asymmetric TF-SAME pads at 28 x 28
        assert tf_same_pads((8, 28, 28), (3, 3, 3), (1, 2, 2)) == \
            ((1, 1), (0, 1), (0, 1))
