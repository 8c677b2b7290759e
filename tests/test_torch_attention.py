"""Port attention core against the JAX package.

The plain version is held to JAX ``_core_xla`` and to the JAX Pallas
``fused_attention`` in interpret mode at the serving path's shapes (BH
scaled down) and at a head_dim <= 256 shape, atol 2e-5 (the JAX package's
kernel tolerance); the autograd backward to ``jax.vjp`` of ``_core_xla`` at
atol 1e-5. The CUDA kernel's own tests, which need no JAX, are in
``test_torch_kernels.py``.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from jmt_tpu.ops.attention import _core_xla
from jmt_tpu_torch.ops import attention
from jmt_tpu_torch.ops.kernels import fused_attention as fa

torch.set_num_threads(2)

# (BH, Lq, Lk, D): intra-modal, JMT encoders, paired cross-attentions,
# SELF_ATTEN head (BH scaled down), and a head_dim <= 256 shape
SHAPES = [(4, 2, 2, 512), (2, 16, 16, 512), (4, 16, 16, 512),
          (4, 6, 6, 512), (6, 16, 16, 64), (3, 5, 9, 64)]


@pytest.fixture()
def interpret_pallas(monkeypatch):
    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", patched)
    yield


def _qkv(bh, lq, lk, d, seed=0):
    rng = np.random.default_rng(seed)
    q = (d ** -0.5 * rng.normal(size=(bh, lq, d))).astype(np.float32)
    k = rng.normal(size=(bh, lk, d)).astype(np.float32)
    v = rng.normal(size=(bh, lk, d)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_jax_core_and_pallas_interpret(shape, interpret_pallas):
    from jmt_tpu.ops.pallas.fused_attention import fused_attention as jfa
    q, k, v = _qkv(*shape)
    got = fa.fused_attention(*map(torch.from_numpy, (q, k, v))).numpy()
    # _core_xla takes (B, L, H, hd): one head per problem
    want_xla = np.asarray(_core_xla(*(jnp.asarray(x)[:, :, None]
                                      for x in (q, k, v))))[:, :, 0]
    want_pallas = np.asarray(jfa(*map(jnp.asarray, (q, k, v)), block_bh=2))
    np.testing.assert_allclose(got, want_xla, rtol=0, atol=2e-5)
    np.testing.assert_allclose(got, want_pallas, rtol=0, atol=2e-5)


@pytest.mark.parametrize("shape", [(2, 4, 2, 8), (2, 6, 1, 512)])
def test_attention_core_backward_matches_jax_vjp(shape):
    """(B, L, H, hd) layout; several heads exercise the (BH, L, hd) fold."""
    rng = np.random.default_rng(1)
    q, k, v, g = (rng.normal(size=shape).astype(np.float32)
                  for _ in range(4))
    # q arrives pre-scaled; the cotangent is scaled alike so that dq stays
    # O(1) at head_dim 512 and fp32 rounding of both sides stays below atol
    q *= np.float32(shape[-1] ** -0.5)
    g *= np.float32(shape[-1] ** -0.5)
    out, vjp = jax.vjp(_core_xla, *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(g))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    got_out = attention.attention_core(tq, tk, tv)
    got = torch.autograd.grad(got_out, (tq, tk, tv), torch.from_numpy(g))
    np.testing.assert_allclose(got_out.detach().numpy(), np.asarray(out),
                               rtol=0, atol=2e-5)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-5)


def test_plain_casts_probabilities_to_v_dtype():
    """bf16: P is rounded to bf16 before P·V, as _core_xla does."""
    q, k, v = _qkv(2, 4, 4, 16, seed=2)
    got = fa.attention_plain(*(torch.from_numpy(x).bfloat16()
                               for x in (q, k, v)))
    want = _core_xla(*(jnp.asarray(x, jnp.bfloat16)[:, :, None]
                       for x in (q, k, v)))[:, :, 0]
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=0,
                               atol=1e-2)
