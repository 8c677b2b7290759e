"""The port's CUDA kernels and their wrappers, without JAX.

This file imports only torch, numpy and the port, so the tests marked
``cuda`` also run on a machine with a card and no JAX::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py -q

On the CPU the card tests skip; what runs here is the wrappers' CPU
dispatch, the kernel's host-side constants, and a numpy emulation of the
log-mel kernel's arithmetic held to the plain version.
"""
import numpy as np
import pytest
import torch

from jmt_tpu_torch.ops import attention, mel
from jmt_tpu_torch.ops.kernels import fused_attention as fa
from jmt_tpu_torch.ops.kernels import melspec

torch.set_num_threads(2)


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _audio(shape, seed=0, zero_rows=()):
    x = (0.2 * np.random.default_rng(seed).normal(size=shape)).astype(
        np.float32)
    for idx in zero_rows:
        x[idx] = 0.0  # a pad row of a serving bucket
    return x


def _qkv(bh, lq, lk, d, seed=0):
    rng = np.random.default_rng(seed)
    q = (d ** -0.5 * rng.normal(size=(bh, lq, d))).astype(np.float32)
    k = rng.normal(size=(bh, lk, d)).astype(np.float32)
    v = rng.normal(size=(bh, lk, d)).astype(np.float32)
    return q, k, v


# ---------------------------------------------------------------------------
# log-mel
# ---------------------------------------------------------------------------
def test_log_mel_dispatch_cpu_uses_plain_and_does_not_count():
    x = torch.from_numpy(_audio((2, 3, 45599), seed=2))
    before = melspec.log_mel_spec.launches
    got = mel.log_mel(x, batch_dims=2)
    assert melspec.log_mel_spec.launches == before
    torch.testing.assert_close(got, mel.log_mel_batch(x, batch_dims=2),
                               rtol=0, atol=0)
    with pytest.raises(ValueError):
        mel.log_mel(x, batch_dims=1)


def test_kernel_constants_reproduce_dense_filterbank_and_twiddles():
    window, twiddle, fb_w, meta = melspec._host_constants()
    fb = np.asarray(mel.mel_filterbank())
    dense = np.zeros_like(fb)
    for m in range(mel.N_MELS):
        lo, cnt, off = meta[:, m]
        dense[lo:lo + cnt, m] = fb_w[off:off + cnt]
    np.testing.assert_array_equal(dense, fb)
    assert fb_w.size == melspec.filterbank_nnz() <= 4096
    k = np.arange(mel.N_FFT // 2)
    ref = np.exp(-2j * np.pi * k / mel.N_FFT)
    np.testing.assert_allclose(twiddle[:, 0] + 1j * twiddle[:, 1], ref,
                               atol=1e-7)
    np.testing.assert_array_equal(window, mel._padded_hann())


def _emulate_kernel(audio: np.ndarray) -> np.ndarray:
    """The arithmetic of csrc/melspec.cu in numpy float32: in-kernel
    reflect framing, two frames per complex radix-2 FFT (bit-reversed
    load, DIT butterflies), spectrum split, sparse mel sum, per-wav floor."""
    window, twiddle, fb_w, meta = melspec._host_constants()
    tw = (twiddle[:, 0] + 1j * twiddle[:, 1]).astype(np.complex64)
    n_wav, length = audio.shape
    n_frames = 1 + length // mel.HOP_LENGTH
    brev = np.array([int(f"{i:010b}"[::-1], 2) for i in range(1024)])
    idx = np.arange(n_frames)[:, None] * mel.HOP_LENGTH + np.arange(1024) - 512
    idx = np.where(idx < 0, -idx, idx)
    idx = np.where(idx >= length, 2 * (length - 1) - idx, idx)
    frames = audio[:, idx] * window                     # (N, T, 1024)
    if n_frames % 2:
        frames = np.concatenate([frames, np.zeros_like(frames[:, :1])], 1)
    z = np.zeros(frames.shape[:1] + (frames.shape[1] // 2, 1024),
                 np.complex64)
    z[..., brev] = frames[:, 0::2] + 1j * frames[:, 1::2]
    half, tstep = 1, 512
    j = np.arange(512)
    while half < 1024:
        pos = j & (half - 1)
        i0 = ((j - pos) << 1) + pos
        t = tw[pos * tstep] * z[..., i0 + half]
        a = z[..., i0].copy()
        z[..., i0], z[..., i0 + half] = a + t, a - t
        half, tstep = half << 1, tstep >> 1
    k = np.arange(513)
    zk, zn = z[..., k], z[..., (1024 - k) & 1023]
    spec_a = np.float32(0.5) * (zk + np.conj(zn))
    spec_b = np.complex64(-0.5j) * (zk - np.conj(zn))
    power = np.stack([np.abs(spec_a) ** 2, np.abs(spec_b) ** 2], 2)
    power = power.reshape(n_wav, -1, 513)[:, :n_frames]  # (N, T, 513)
    out = np.zeros((n_wav, 64, n_frames), np.float32)
    for m in range(64):
        lo, cnt, off = meta[:, m]
        out[:, m] = power[..., lo:lo + cnt] @ fb_w[off:off + cnt]
    db = np.float32(10.0) * np.log10(np.maximum(out, np.float32(1e-10)))
    db = np.maximum(db, db.max(axis=(1, 2), keepdims=True) - np.float32(80))
    return (db - np.float32(-14.8)) / np.float32(19.895)


@pytest.mark.parametrize("length", [45599, 45599 - 441])
def test_kernel_algorithm_matches_plain(length):
    """The CUDA kernel's algorithm (emulated) agrees with the plain version
    at atol 5e-5; an odd frame count exercises the unpaired last frame."""
    x = _audio((2, length), seed=3, zero_rows=((1,),))
    got = _emulate_kernel(x)
    want = mel.log_mel_batch(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-5)


@pytest.mark.cuda
def test_mel_kernel_matches_plain_on_card(cuda_device):
    """N = 128 (bucket 8 x seq 16) with an all-zero pad row, atol 5e-5."""
    x = torch.from_numpy(_audio((128, 45599), seed=4, zero_rows=((127,),)))
    x = x.to(cuda_device)
    before = melspec.log_mel_spec.launches
    got = melspec.log_mel_spec(x)
    torch.cuda.synchronize()
    assert melspec.log_mel_spec.launches == before + 1
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, mel.log_mel_batch(x), rtol=0, atol=5e-5)
    with pytest.raises(TypeError):
        melspec.log_mel_spec(x.double())
    with pytest.raises(ValueError):
        melspec.log_mel_spec(x[:, ::2])


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------
def test_attention_cpu_dispatch_uses_plain_and_does_not_count():
    q, k, v = map(torch.from_numpy, _qkv(2, 3, 4, 8))
    before = fa.fused_attention.launches
    got = fa.fused_attention(q, k, v)
    assert fa.fused_attention.launches == before
    torch.testing.assert_close(got, fa.attention_plain(q, k, v), rtol=0,
                               atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5),
                                        (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("shape", [(128, 2, 2, 512), (8, 16, 16, 512),
                                   (16, 16, 16, 512), (128, 6, 6, 512),
                                   (64, 16, 16, 64), (4, 16, 128, 64),
                                   (4, 128, 128, 512)])
def test_attention_kernel_matches_plain_on_card(shape, dtype, atol,
                                                cuda_device):
    q, k, v = (torch.from_numpy(x).to(cuda_device, dtype)
               for x in _qkv(*shape, seed=3))
    v = 0.25 * v  # |out| < 1: one bf16 rounding step stays below atol
    before = fa.fused_attention.launches
    got = fa.fused_attention(q, k, v)
    torch.cuda.synchronize()
    assert fa.fused_attention.launches == before + 1
    assert got.dtype == dtype
    torch.testing.assert_close(got.float(),
                               fa.attention_plain(q, k, v).float(),
                               rtol=0, atol=atol)


@pytest.mark.cuda
def test_attention_core_backward_on_card(cuda_device):
    """Kernel forward, plain backward: the gradients on the card agree with
    the CPU's at atol 1e-5 (f32; matmul TF32 is off by default)."""
    rng = np.random.default_rng(5)
    q, k, v, g = (rng.normal(size=(2, 6, 1, 512)).astype(np.float32)
                  for _ in range(4))
    # q arrives pre-scaled; the cotangent is scaled alike so that the
    # gradients stay O(1) and f32 summation order stays below atol
    q *= np.float32(512 ** -0.5)
    g *= np.float32(512 ** -0.5)
    grads = {}
    for dev in ("cpu", cuda_device):
        leaves = [torch.from_numpy(x).to(dev).requires_grad_()
                  for x in (q, k, v)]
        out = attention.attention_core(*leaves)
        grads[str(dev)] = [x.cpu() for x in torch.autograd.grad(
            out, leaves, torch.from_numpy(g).to(dev))]
    for a, b in zip(grads["cpu"], grads[str(cuda_device)]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_attention_kernel_raises_on_inputs_it_does_not_take(cuda_device):
    q, k, v = (torch.from_numpy(x).to(cuda_device)
               for x in _qkv(2, 4, 4, 64))
    with pytest.raises(TypeError):
        fa.fused_attention(q.double(), k.double(), v.double())
    with pytest.raises(ValueError):
        fa.fused_attention(q.transpose(1, 2), k, v)
    big = torch.zeros(1, 129, 64, device=cuda_device)
    with pytest.raises(ValueError):
        fa.fused_attention(big, big, big)
    wide = torch.zeros(1, 4, 1024, device=cuda_device)
    with pytest.raises(ValueError):
        fa.fused_attention(wide, wide, wide)
