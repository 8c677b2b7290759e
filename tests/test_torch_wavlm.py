"""The port's WavLM (``jmt_tpu_torch/models/wavlm.py``) against the JAX
package's ``wavlm_apply``, float32 on the CPU.

The JAX params come from ``wavlm_params_from_torch(port.state_dict())``:
the port's state dict is a Hugging Face ``WavLMModel`` state dict. Bound:
max |delta| / max |ref| <= 1e-5, the bound ``tests/test_wavlm.py`` holds
the JAX forward to against Hugging Face's. Geometries: the tiny one of
``tests/test_wavlm.py``, its ``conv_bias`` variant, and wavlm-base at full
width (768, 12 heads, 3072) at depth 2 on one 16,545-sample chunk. Also:
each weight-normed positional-conv layout loads, the bucket matrix is
JAX's exactly, the geometry properties, and (where ``transformers`` is
installed) a Hugging Face state dict loads ``strict=True`` and matches its
forward.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from jmt_tpu.models import wavlm as jwavlm
from jmt_tpu_torch.models.wavlm import (WavLMConfig, WavLMModel,
                                        init_parameters,
                                        relative_position_buckets)

torch.set_num_threads(2)

# tests/test_wavlm.py's tiny geometry
TINY = WavLMConfig(
    hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
    intermediate_size=48, conv_dim=(12, 12, 16), conv_stride=(4, 2, 2),
    conv_kernel=(6, 3, 3), num_conv_pos_embeddings=16,
    num_conv_pos_embedding_groups=4, num_buckets=14, max_bucket_distance=50)
POS = "encoder.pos_conv_embed.conv."


def jax_cfg(cfg: WavLMConfig) -> jwavlm.WavLMConfig:
    """The JAX config of the same geometry (conv bias is read from the
    params there)."""
    fields = dataclasses.asdict(cfg)
    fields.pop("conv_bias")
    return jwavlm.WavLMConfig(**fields)


def model(cfg: WavLMConfig, seed: int) -> WavLMModel:
    return init_parameters(WavLMModel(cfg),
                           torch.Generator().manual_seed(seed)).eval()


def jax_forward(sd, cfg: WavLMConfig, wav: np.ndarray) -> np.ndarray:
    params = jwavlm.wavlm_params_from_torch(sd, jax_cfg(cfg))
    return np.asarray(jwavlm.wavlm_apply(params, jnp.asarray(wav),
                                         jax_cfg(cfg)))


def port_forward(m: WavLMModel, wav: np.ndarray) -> np.ndarray:
    with torch.no_grad():
        return m(torch.from_numpy(wav)).numpy()


def rel_delta(out, ref) -> float:
    return float(np.abs(out - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("cfg,shape,seed", [
    (TINY, (2, 800), 0),
    (dataclasses.replace(TINY, conv_bias=True), (1, 500), 1),
    (WavLMConfig(num_hidden_layers=2), (1, 16545), 2)],
    ids=["tiny", "tiny_conv_bias", "base_depth2"])
def test_wavlm_matches_jax(cfg, shape, seed):
    m = model(cfg, seed)
    wav = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    out = port_forward(m, wav)
    ref = jax_forward(m.state_dict(), cfg, wav)
    assert out.shape == ref.shape == (shape[0], cfg.n_frames(shape[1]),
                                      cfg.hidden_size)
    assert rel_delta(out, ref) <= 1e-5


def _weight_norm_layouts(m: WavLMModel):
    """The positional conv's folded kernel as (g, v) in the two
    weight-norm layouts and as a plain weight; each a full state dict."""
    sd = m.state_dict()
    w = sd.pop(POS + "weight")
    rng = np.random.default_rng(5)
    # a v of other row norms than w's, and the g that gives w back
    v = w * torch.from_numpy(rng.uniform(0.5, 2.0, (1, 1, w.shape[2]))
                             .astype(np.float32))
    g = torch.sqrt((v ** 2).sum(dim=(0, 1), keepdim=True)) * (w / v)[:1, :1]
    return {"parametrizations": dict(sd, **{
                POS + "parametrizations.weight.original0": g,
                POS + "parametrizations.weight.original1": v}),
            "weight_g": dict(sd, **{POS + "weight_g": g, POS + "weight_v": v}),
            "plain": dict(sd, **{POS + "weight": w})}


@pytest.mark.parametrize("layout", ["parametrizations", "weight_g", "plain"])
def test_each_positional_conv_layout_loads(layout):
    src = model(TINY, 3)
    sd = _weight_norm_layouts(src)[layout]
    dst = WavLMModel(TINY)
    dst.load_state_dict({f"wavlm.{k}": v for k, v in sd.items()},
                        strict=True)
    wav = np.random.default_rng(3).normal(size=(1, 700)).astype(np.float32)
    out = port_forward(dst.eval(), wav)
    assert rel_delta(out, port_forward(src, wav)) <= 1e-5
    assert rel_delta(out, jax_forward(sd, TINY, wav)) <= 1e-5


def test_masked_spec_embed_is_dropped_and_unknown_keys_refused():
    m = model(TINY, 4)
    sd = m.state_dict()
    WavLMModel(TINY).load_state_dict(
        dict(sd, masked_spec_embed=torch.zeros(32)), strict=True)
    with pytest.raises(RuntimeError, match="Unexpected"):
        WavLMModel(TINY).load_state_dict(dict(sd, stray=torch.zeros(1)),
                                         strict=True)


@pytest.mark.parametrize("T,nb,md", [(7, 14, 50), (64, 320, 800),
                                     (199, 320, 800), (2048, 320, 800)])
def test_bucket_matrix_is_jax_bit_for_bit(T, nb, md):
    ours = relative_position_buckets(T, nb, md)
    assert ours.dtype == np.int64
    np.testing.assert_array_equal(
        ours, jwavlm.relative_position_buckets(T, nb, md))
    assert ours.max() < nb


def test_geometry_properties():
    cfg = WavLMConfig()
    assert (cfg.frame_stride, cfg.receptive_field, cfg.head_dim) == \
        (320, 400, 64)
    for n in (16000, 45599, 123457):
        assert cfg.n_frames(n) == (n - 400) // 320 + 1
    for c in (cfg, TINY):
        j = jax_cfg(c)
        assert (c.frame_stride, c.receptive_field, c.head_dim,
                c.n_frames(5000)) == (j.frame_stride, j.receptive_field,
                                      j.head_dim, j.n_frames(5000))


def test_hugging_face_state_dict_loads_strict_and_matches_its_forward():
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.WavLMConfig(
        hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
        intermediate_size=48, conv_dim=(12, 12, 16), conv_stride=(4, 2, 2),
        conv_kernel=(6, 3, 3), num_feat_extract_layers=3,
        num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4,
        num_buckets=14, max_bucket_distance=50, hidden_dropout=0.0,
        attention_dropout=0.0, feat_proj_dropout=0.0, layerdrop=0.0,
        do_stable_layer_norm=False, feat_extract_norm="group")
    torch.manual_seed(0)
    hf = transformers.WavLMModel(hf_cfg).eval()
    cfg = WavLMConfig.from_hf(hf_cfg)
    assert cfg == TINY
    m = WavLMModel(cfg)
    m.load_state_dict(hf.state_dict(), strict=True)
    wav = np.random.default_rng(0).normal(size=(2, 800)).astype(np.float32)
    with torch.no_grad():
        ref = hf(torch.from_numpy(wav)).last_hidden_state.numpy()
    assert rel_delta(port_forward(m.eval(), wav), ref) <= 1e-5
