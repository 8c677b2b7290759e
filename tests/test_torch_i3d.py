"""The port's I3D+TCN branch and the flagship model against the JAX
package, fp32 on CPU, inputs from numpy seeds and weights carried over with
``load_jax_variables`` (strict).

Tolerances: the stem fold 1e-5 (the JAX package's golden bound for it is
far tighter in f64); the TCN 1e-6; I3D+TCN 2e-4, the JAX package's I3D
parity bound (``PARITY.md:18``), measured ~1e-8; the flagship V/A 1e-3,
the stitched-V/A bound (``PARITY.md:72-78``), measured ~5e-8. 16 px clips
with ``i3d_input_size`` 32 run the stem fold; other sizes the resize.
"""
import contextlib

import numpy as np
import pytest
import torch

import jax

from jmt_tpu.models.i3d import I3DTCN as JI3DTCN
from jmt_tpu.models.jmt_model import JMTModel as JJMTModel
from jmt_tpu.models.tcn import TemporalConvNet as JTemporalConvNet
from jmt_tpu.models.tsav import TwoStreamBackbones as JBackbones
from jmt_tpu.ops.conv import conv3d_stem_upsample2x as jstem_fold
from jmt_tpu.train.loops import _preprocess
from jmt_tpu_torch.models import i3d as pi3d
from jmt_tpu_torch.models.convert import (load_jax_variables,
                                          state_dict_from_jax)
from jmt_tpu_torch.models.i3d import I3DTCN, InceptionI3d, Unit3D
from jmt_tpu_torch.models.jmt_model import JMTModel
from jmt_tpu_torch.models.tcn import TemporalConvNet
from jmt_tpu_torch.models.tsav import TwoStreamBackbones, resize_clips_for_i3d
from jmt_tpu_torch.ops.conv import conv3d_stem_upsample2x
from jmt_tpu_torch.ops.kernels import inception as k3
from jmt_tpu_torch.train.loops import preprocess

torch.set_num_threads(2)


def _np_tree(variables):
    return jax.tree.map(np.asarray, variables)


def _normal(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=shape)).astype(
        np.float32)


@pytest.mark.parametrize("shape", [(1, 5, 16, 16, 3), (2, 4, 12, 16, 3)])
def test_stem_fold_matches_jax_and_resize_then_conv(shape):
    """The folded stem against the JAX fold, and against the port's own
    bilinear 2x resize followed by the TF-SAME stride-(1, 2, 2) conv; H != W
    catches swapped row and column corrections. atol 1e-5."""
    x = _normal(shape, seed=0)
    w = _normal((7, 7, 7, 3, 8), seed=1, scale=0.05)   # (kt, kh, kw, I, O)
    want = np.asarray(jstem_fold(x, w, (3, 3)))          # (N, T, H, W, O)
    xt = torch.from_numpy(x).permute(0, 4, 1, 2, 3)
    wt = torch.from_numpy(w).permute(4, 3, 0, 1, 2)      # (O, I, kt, kh, kw)
    got = conv3d_stem_upsample2x(xt, wt, (3, 3))
    np.testing.assert_allclose(got.permute(0, 2, 3, 4, 1).numpy(), want,
                               rtol=0, atol=1e-5)
    unit = Unit3D(3, 8, (7, 7, 7), (1, 2, 2)).eval()
    with torch.no_grad():
        unit.conv3d.weight.copy_(wt)
        folded = unit.upsampled2x(xt)
        up = resize_clips_for_i3d(xt, 2 * shape[2]) if shape[2] == shape[3] \
            else torch.nn.functional.interpolate(
                xt, size=(shape[1], 2 * shape[2], 2 * shape[3]),
                mode="trilinear", align_corners=False)
        direct = unit(up)
    assert folded.shape == direct.shape == (shape[0], 8) + shape[1:4]
    np.testing.assert_allclose(folded.numpy(), direct.numpy(), rtol=0,
                               atol=1e-5)


def test_tcn_matches_jax_with_weight_norm_aliases():
    """Widths 24 -> 16 (1x1 downsample) -> 16 (identity residual) -> 8,
    dilations 1, 2, 4; conv1/conv2 also under net.0/net.4. atol 1e-6."""
    x = _normal((2, 7, 24), seed=2)
    jm = JTemporalConvNet((16, 16, 8), kernel_size=5)
    variables = jax.jit(jm.init)(jax.random.PRNGKey(0), x)
    want = np.asarray(jax.jit(jm.apply)(variables, x))
    pm = TemporalConvNet(24, (16, 16, 8), kernel_size=5)
    sd = state_dict_from_jax(pm, _np_tree(variables))
    assert set(sd) == set(pm.state_dict())
    assert {"network.0.net.0.weight_g", "network.0.net.4.weight_v",
            "network.0.downsample.weight", "network.2.conv2.bias"} <= set(sd)
    assert "network.1.downsample.weight" not in sd
    np.testing.assert_array_equal(sd["network.1.net.4.weight_v"],
                                  sd["network.1.conv2.weight_v"])
    assert pm.network[0].net[0] is pm.network[0].conv1
    load_jax_variables(pm, _np_tree(variables))
    with torch.inference_mode():
        got = pm(torch.from_numpy(x).transpose(1, 2)).transpose(1, 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def i3dtcn_pair():
    """JAX I3D+TCN on a (1, 4, 16, 16, 3) clip with the stem fold (32 px
    equivalent): (input, output, variables)."""
    x = np.maximum(_normal((1, 4, 16, 16, 3), seed=3), 0)
    jm = JI3DTCN()
    fold = dict(stem_upsample2x=True)
    variables = jax.jit(jm.init, static_argnames="stem_upsample2x")(
        jax.random.PRNGKey(0), x, **fold)
    out = jax.jit(jm.apply, static_argnames="stem_upsample2x")(
        variables, x, **fold)
    return x, np.asarray(out), _np_tree(variables)


@pytest.mark.parametrize("fused", [False, True, "absorbed"])
def test_i3dtcn_matches_jax(i3dtcn_pair, fused, monkeypatch):
    """End to end (stem fold, pools, nine modules, avg tail, TCN), with
    the modules unfused, fused (the plain version of K3 on the CPU), and
    fused with the gate ``_ABSORB_POOLS`` on: every pre-pool map of the
    32 px fold fixture is even, so pools 3a, 4a and 5a reach the
    dispatcher as ``pool_in`` of Mixed_3b, 4b and 5b."""
    x, want, variables = i3dtcn_pair
    pool_ins = []
    if fused == "absorbed":
        def spy(x, fw, out_channels, *, pool_in=None, avg_tail=False):
            pool_ins.append(pool_in)
            return real(x, fw, out_channels, pool_in=pool_in,
                        avg_tail=avg_tail)

        real = pi3d.inception_module_fused
        monkeypatch.setattr(k3, "_ABSORB_POOLS", True)
        monkeypatch.setattr(pi3d, "inception_module_fused", spy)
    pm = load_jax_variables(I3DTCN(fused_inception=bool(fused)), variables)
    with torch.inference_mode():
        got = pm(torch.from_numpy(x).permute(0, 4, 1, 2, 3),
                 stem_upsample2x=True)
    if fused == "absorbed":
        assert pool_ins == [((1, 3, 3), (1, 2, 2)), None,
                            ((3, 3, 3), (1, 2, 2)), None, None, None, None,
                            ((2, 2, 2), (1, 2, 2)), None]
    assert got.shape == want.shape == (1, 3, 512)
    assert float(np.abs(want).max()) > 1e-3
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-4)


def test_i3d_converters_load_strict(i3dtcn_pair):
    """I3DTCN and InceptionI3d converters: reference keys, strict loads, a
    missing key refused; the InceptionI3d loaded from the I3D subtree gives
    the I3DTCN's own features."""
    x, _, variables = i3dtcn_pair
    pm = I3DTCN()
    sd = state_dict_from_jax(pm, variables)
    assert set(sd) == set(pm.state_dict())
    assert {"i3d_WSDDA.Conv3d_1a_7x7.conv3d.weight",
            "i3d_WSDDA.Mixed_5c.b2b.bn.running_var",
            "temporal.network.3.net.4.weight_g"} <= set(sd)
    assert not any("logits" in k for k in sd)
    sd.pop("i3d_WSDDA.Mixed_4d.b3b.conv3d.weight")
    with pytest.raises(RuntimeError, match="Missing key"):
        pm.load_state_dict({k: torch.from_numpy(np.array(v))
                            for k, v in sd.items()}, strict=True)
    full = load_jax_variables(I3DTCN(), variables)
    trunk = load_jax_variables(InceptionI3d(), {
        "params": variables["params"]["i3d"],
        "batch_stats": variables["batch_stats"]["i3d"]})
    xt = torch.from_numpy(x).permute(0, 4, 1, 2, 3)
    with torch.inference_mode():
        torch.testing.assert_close(trunk(xt, stem_upsample2x=True),
                                   full.i3d_WSDDA(xt, stem_upsample2x=True),
                                   rtol=0, atol=0)


@pytest.mark.parametrize("path", ["fold", "resize"])
def test_two_stream_backbones_i3d(path):
    """The I3D branch of the container: clips (1, S, 4, 16, 16, 3); fold
    (i3d_input_size 32, chunks of 1 clip) and resize (24, chunk 2 does not
    divide S=3: warned and disabled, as in JAX). atol 2e-4."""
    size, s, chunk = (32, 2, 1) if path == "fold" else (24, 3, 2)
    clips = _normal((1, s, 4, 16, 16, 3), seed=4)
    kw = dict(vision_backbones=("I3D",), audio_backbones=(),
              i3d_input_size=size, i3d_chunk=chunk)
    jm = JBackbones(**kw)
    variables = jax.jit(jm.init)(jax.random.PRNGKey(0), None, clips)
    warned = (lambda: pytest.warns(RuntimeWarning, match="does not divide")
              if path == "resize" else contextlib.nullcontext())
    with warned():
        want = np.asarray(jax.jit(jm.apply)(variables, None,
                                            clips)["vision_i3d"])
    pm = load_jax_variables(TwoStreamBackbones(**kw), _np_tree(variables))
    assert {"vision_i3d.i3d_WSDDA.Mixed_3b.b0.conv3d.weight",
            "vision_i3d.temporal.network.0.downsample.bias"} <= \
        set(pm.state_dict())
    with torch.inference_mode(), warned():
        got = pm(None, torch.from_numpy(clips))["vision_i3d"]
    assert got.shape == want.shape == (1, s, 512)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-4)


FLAGSHIP = dict(vision_backbones=("R2D1", "I3D"),
                audio_backbones=("ResNet18", "wavLM"),
                intra_modal_fusion="encoder_plus_self_attention",
                num_heads=1, num_layers=1, i3d_input_size=32)


@pytest.fixture(scope="module")
def flagship_pair():
    """JAX flagship (R2D1 + I3D with the visual intra-modal fusion) at B=1,
    S=2, 16 px: (arrays, (V, A), variables)."""
    rng = np.random.default_rng(5)
    arrays = {"clips": rng.integers(0, 256, (1, 2, 8, 16, 16, 3),
                                    dtype=np.uint8),
              "audio": (0.1 * rng.normal(size=(1, 2, 45599))).astype(
                  np.float32),
              "wavlm": rng.normal(size=(1, 2, 768)).astype(np.float32)}
    jm = JJMTModel(**FLAGSHIP, i3d_fused_inception=False)
    spec, clips = _preprocess(jm, arrays, None, augment=False)
    variables = jax.jit(jm.init)(jax.random.PRNGKey(0), spec, clips,
                                 arrays["wavlm"])
    v, a = jax.jit(jm.apply)(variables, spec, clips, arrays["wavlm"])
    return arrays, (np.asarray(v), np.asarray(a)), _np_tree(variables)


@pytest.mark.parametrize("fused", [False, True, "auto"])
def test_flagship_matches_jax(flagship_pair, fused, monkeypatch):
    """V/A at 1e-3 (measured ~5e-8); per forward 12 attention-core calls
    and, with the flag on, 9 calls of the K3 dispatcher ("auto" is off)."""
    from jmt_tpu_torch.ops import attention
    arrays, (want_v, want_a), variables = flagship_pair
    model = load_jax_variables(JMTModel(**FLAGSHIP,
                                        i3d_fused_inception=fused), variables)
    calls = {"attention": 0, "inception": 0}

    def spy(name, real):
        def wrapped(*args, **kwargs):
            calls[name] += 1
            return real(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(attention, "fused_attention",
                        spy("attention", attention.fused_attention))
    monkeypatch.setattr(pi3d, "inception_module_fused",
                        spy("inception", pi3d.inception_module_fused))
    with torch.inference_mode():
        ta = {k: torch.from_numpy(x) for k, x in arrays.items()}
        spec, clips = preprocess(model, ta)
        v, a = model(spec, clips, ta["wavlm"])
    assert calls == {"attention": 12, "inception": 9 if fused is True else 0}
    assert v.shape == a.shape == (1, 2)
    np.testing.assert_allclose(v.numpy(), want_v, rtol=0, atol=1e-3)
    np.testing.assert_allclose(a.numpy(), want_a, rtol=0, atol=1e-3)
    assert max(np.abs(v.numpy() - want_v).max(),
               np.abs(a.numpy() - want_a).max()) < 1e-6


def test_flagship_keys_load_strict(flagship_pair):
    """The visual fusion's keys; its 768 -> 512 ``fc`` (never run on two
    512-d streams, absent from the JAX tree) arrives as zeros."""
    _, _, variables = flagship_pair
    model = JMTModel(**FLAGSHIP)
    sd = state_dict_from_jax(model, variables)
    assert set(sd) == set(model.state_dict())
    assert {"transformer_visio_modality_fusion.final_visual_encoder.layers.0"
            ".attention.in_proj_weight",
            "transformer_visio_modality_fusion.final_self_attention"
            ".out_proj.bias",
            "backbones.vision_i3d.i3d_WSDDA.Mixed_4f.b1b.conv3d.weight",
            "backbones.vision_r2d1.r2plus1d.stem.0.weight"} <= set(sd)
    assert not np.any(sd["transformer_visio_modality_fusion.fc.weight"])
    assert np.any(sd["transformer_audio_modality_fusion.fc.weight"])
    with pytest.raises(NotImplementedError):
        JMTModel(vision_backbones=("R2D1", "C3D"))
