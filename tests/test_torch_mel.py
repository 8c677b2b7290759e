"""Port log-mel front end against the JAX package.

The plain version (``jmt_tpu_torch.ops.mel.log_mel_batch``) is held to the
JAX XLA path and to the JAX Pallas kernel in interpret mode at atol 5e-5
(the JAX package's own kernel-vs-XLA tolerance); the filterbank and window
to 1e-7. The CUDA kernel's own tests, which need no JAX, are in
``test_torch_kernels.py``.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from jmt_tpu.ops import mel as jmel
from jmt_tpu_torch.ops import mel
from jmt_tpu_torch.ops.kernels import melspec

torch.set_num_threads(2)


@pytest.fixture()
def interpret_pallas(monkeypatch):
    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", patched)
    yield


def _audio(shape, seed=0, zero_rows=()):
    x = (0.2 * np.random.default_rng(seed).normal(size=shape)).astype(
        np.float32)
    for idx in zero_rows:
        x[idx] = 0.0  # a pad row of a serving bucket
    return x


def test_filterbank_and_window_match_jax():
    np.testing.assert_allclose(mel.mel_filterbank(), jmel.mel_filterbank(),
                               rtol=0, atol=1e-7)
    np.testing.assert_allclose(mel._padded_hann(), jmel._padded_hann(),
                               rtol=0, atol=1e-7)
    assert mel.SPEC_FRAMES == jmel.SPEC_FRAMES == 104


@pytest.mark.parametrize("shape,batch_dims,zero_rows", [
    ((3, 45599), 1, ((2,),)),
    ((2, 2, 45599), 2, ((1, 0),)),
])
def test_log_mel_batch_matches_jax(shape, batch_dims, zero_rows):
    x = _audio(shape, zero_rows=zero_rows)
    want = np.asarray(jmel.log_mel_batch(jnp.asarray(x),
                                         batch_dims=batch_dims))
    got = mel.log_mel_batch(torch.from_numpy(x), batch_dims=batch_dims)
    assert got.shape == want.shape == (*shape[:-1], 64, 104)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=5e-5)
    assert np.isfinite(got.numpy()).all()


def test_log_mel_matches_pallas_kernel_interpret(interpret_pallas):
    from jmt_tpu.ops.pallas.melspec import log_mel_pallas
    x = _audio((3, 45599), seed=1, zero_rows=((1,),))
    want = np.asarray(log_mel_pallas(jnp.asarray(x)))
    got = melspec.log_mel_spec(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=5e-5)
