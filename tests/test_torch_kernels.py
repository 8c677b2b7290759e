"""The port's CUDA kernels and their wrappers, without JAX.

This file imports only torch, numpy and the port, so the tests marked
``cuda`` also run on a machine with a card and no JAX::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py -q

On the CPU the card tests skip; what runs here is the wrappers' CPU
dispatch and refusals, the kernels' host-side constants, and numpy
emulations of the log-mel, attention, inception (with its pool prologue,
and as the bf16 launches tile it) and pool + 1x1 kernels' arithmetic (the
latter's f32 launch and its bf16 Hopper design) held to the plain
versions. On the card also the server's CUDA graphs: each bucket's replay
against the eager forward, the kernel launches inside each capture, and a
capture that fails raising.
"""
import itertools

import numpy as np
import pytest
import torch

from jmt_tpu_torch.models.i3d import I3D_STAGES, module_channels
from jmt_tpu_torch.ops import attention, inception, mel
from jmt_tpu_torch.ops.kernels import fused_attention as fa
from jmt_tpu_torch.ops.kernels import inception as k3
from jmt_tpu_torch.ops.kernels import melspec
from jmt_tpu_torch.ops.kernels import pool1x1 as k4
from jmt_tpu_torch.ops.pool1x1 import pool3_1x1_plain

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
    """``log_mel`` flattens (2, 3, L) to (6, L) and hands that to the plain
    version: no launch is counted, and the values are those of
    ``log_mel_batch`` on the (6, L) input and on the (2, 3, L) input.

    Both comparisons hold at atol 1e-5, not bitwise. Each side is a CPU FFT
    and GEMM in f32, and two such runs need not round alike: in a run of
    the whole suite with 6 workers a gap of 3.9e-6 was seen, where a
    single process is bit-identical every time. This input's f32 values lie
    within 8.3e-7 of an f64 evaluation. 1e-5 is 2.5x the largest gap seen
    and 5x below the log-mel tolerance (5e-5)."""
    x = torch.from_numpy(_audio((2, 3, 45599), seed=2))
    before = melspec.log_mel_spec.launches
    got = mel.log_mel(x, batch_dims=2)
    assert melspec.log_mel_spec.launches == before
    flat = mel.log_mel_batch(x.reshape(6, -1)).reshape(got.shape)
    torch.testing.assert_close(got, flat, rtol=0, atol=1e-5)
    torch.testing.assert_close(got, mel.log_mel_batch(x, batch_dims=2),
                               rtol=0, atol=1e-5)
    with pytest.raises(ValueError):
        mel.log_mel(x, batch_dims=1)


def test_kernel_constants_reproduce_dense_filterbank_and_twiddles():
    """The slot-major table rebuilds the dense filterbank (996 nonzeros),
    with zeros past each band's count; every band sits in one slot; each
    slot's block is as long as its widest band, 89 steps in all against
    64 (996 / 16 = 62.25) for an ideal split, with no divergence; the
    twiddles are W1024^(k2 n1) at 32 k2 + n1."""
    window, twiddle, table, meta = melspec._host_constants()
    fb = np.asarray(mel.mel_filterbank())
    bands, first, cnt, tail = meta
    lens, offs = tail[:4], tail[4:8]
    assert sorted(bands) == list(range(mel.N_MELS))
    assert list(lens) == [int(cnt[16 * j:16 * j + 16].max()) for j in range(4)]
    assert table.size == 16 * lens.sum() == 16 * 89 <= 1536
    dense = np.zeros_like(fb)
    for slot, m in enumerate(bands):
        j, g = divmod(slot, 16)
        col = table[offs[j] + g:offs[j] + 16 * lens[j]:16]
        dense[first[slot]:first[slot] + cnt[slot], m] = col[:cnt[slot]]
        assert not col[cnt[slot]:].any()
    np.testing.assert_array_equal(dense, fb)
    assert melspec.filterbank_nnz() == 996 == np.count_nonzero(fb)
    k2, n1 = np.divmod(np.arange(1024), 32)
    ref = np.exp(-2j * np.pi * k2 * n1 / mel.N_FFT)
    np.testing.assert_allclose(twiddle[:, 0] + 1j * twiddle[:, 1], ref,
                               atol=1e-7)
    np.testing.assert_array_equal(window, mel._padded_hann())


_W32 = np.exp(-2j * np.pi * np.arange(16) / 32).astype(np.complex64)
_BREV5 = np.array([int(f"{i:05b}"[::-1], 2) for i in range(32)])


def _dif32(z: np.ndarray) -> np.ndarray:
    """The kernel's in-register 32-point radix-2 DIF over the last axis,
    complex64 with the twiddles 1 and -i exact; returns natural order."""
    z = z.copy()
    s = 32
    while s >= 2:
        h = s // 2
        for b in range(0, 32, s):
            for j in range(h):
                a, c = z[..., b + j].copy(), z[..., b + j + h].copy()
                z[..., b + j] = a + c
                w = j * (32 // s)
                d = a - c
                z[..., b + j + h] = (d if w == 0 else np.complex64(-1j) * d
                                     if w == 8 else d * _W32[w])
        s = h
    return z[..., np.argsort(_BREV5)]


def _fft_radix32(frames: np.ndarray, tw: np.ndarray) -> np.ndarray:
    """(P, 1024) complex64 -> (P, 1024): the kernel's four-step FFT. Lane
    n1 holds x[n1 + 32 n2]; DIF over n2; times W1024^(n1 k2) (none at
    k2 = 0); the slab transpose; DIF over n1; Z[k2 + 32 k1]."""
    y = _dif32(frames.reshape(-1, 32, 32).transpose(0, 2, 1))  # [p, n1, k2]
    y[..., 1:] *= tw.reshape(32, 32).T[None, :, 1:]             # [n1, k2]
    z = _dif32(y.transpose(0, 2, 1))                           # [p, k2, k1]
    return z.transpose(0, 2, 1).reshape(-1, 1024)


def _stage_window(row, base, t0, nf, fpc):
    """A CTA's staged window, as the kernel copies it: the padded samples
    [lo, hi) at win[phase + p - lo], phase = (element offset of sample lo)
    mod 4. The row's samples come in 16-byte chunks that land on 16-byte
    boundaries, with single samples at the ragged ends; the reflected
    samples (p < 0 -> -p, p >= L -> 2(L-1) - p) are single loads. Unwritten
    slots are NaN."""
    length = row.size
    lo, hi = t0 * 441 - 512, (t0 + nf - 1) * 441 + 512
    phase = (base + lo) % 4
    win = np.full(-(-((fpc - 1) * 441 + 1027) // 4) * 4, np.nan, np.float32)
    w0 = win[phase:]                       # w0[p - lo] holds sample p
    a0, a1 = max(lo, 0), min(hi, length)
    head = min((4 - (base + a0) % 4) % 4, a1 - a0)
    n_vec = (a1 - a0 - head) // 4
    tail = a0 + head + 4 * n_vec
    assert (base + a0 + head) % 4 == 0 and (phase + a0 + head - lo) % 4 == 0
    w0[a0 - lo:a0 + head - lo] = row[a0:a0 + head]
    w0[a0 + head - lo:tail - lo] = row[a0 + head:tail]
    w0[tail - lo:a1 - lo] = row[tail:a1]
    for p in range(lo, 0):
        w0[p - lo] = row[-p]
    for p in range(length, hi):
        w0[p - lo] = row[2 * (length - 1) - p]
    return win, phase, lo


def _emulate_kernel(audio: np.ndarray, base: int = 0) -> np.ndarray:
    """The arithmetic of csrc/melspec.cu in numpy float32, step for step:
    each wav split over the cluster's CTAs (F = ceil(T / 8) frames each);
    each CTA's staged, padded window (``base``: the element offset of the
    tensor's first sample, which sets the 16-byte phase; reflected samples
    only in a window that crosses an end); two frames per radix-32 x 32
    FFT; the spectrum split; the slot-major mel sum (each band summed in
    bin order, the zero weights past its count adding nothing); dB; each
    CTA's max, then the cluster's max; the floor and normalization."""
    window, tw, table, meta = melspec._host_constants()
    tw = (tw[:, 0] + 1j * tw[:, 1]).astype(np.complex64)
    n_wav, length = audio.shape
    n_frames = 1 + length // mel.HOP_LENGTH
    fpc = -(-n_frames // melspec.CLUSTER)
    out = np.full((n_wav, 64, n_frames), np.nan, np.float32)
    k = np.arange(513)
    for w in range(n_wav):
        row = audio[w]
        tiles, maxes = [], []
        for rank in range(melspec.CLUSTER):
            t0 = rank * fpc
            nf = max(0, min(n_frames - t0, fpc))
            tile = np.full((64, nf), np.nan, np.float32)
            if nf:
                win, phase, lo = _stage_window(row, base + w * length, t0,
                                               nf, fpc)
                idx = (t0 + np.arange(nf))[:, None] * 441 - 512 + np.arange(
                    1024)
                frames = win[phase + idx - lo] * window         # (nf, 1024)
                assert not np.isnan(frames).any()  # only staged samples
                if nf % 2:
                    frames = np.concatenate([frames, np.zeros_like(
                        frames[:1])])
                z = _fft_radix32((frames[0::2] + 1j * frames[1::2]).astype(
                    np.complex64), tw)
                zk, zn = z[:, k], z[:, (1024 - k) & 1023]
                h = np.float32(0.5)
                power = np.stack([
                    (h * (zk.real + zn.real)) ** 2
                    + (h * (zk.imag - zn.imag)) ** 2,
                    (h * (zk.imag + zn.imag)) ** 2
                    + (-h * (zk.real - zn.real)) ** 2], 1)
                power = power.reshape(-1, 513)[:nf]              # (nf, 513)
                for slot in range(64):  # lane slot % 16, step slot // 16
                    m, first, cnt = meta[:3, slot]
                    j, g = divmod(slot, 16)
                    w_col = table[meta[3, 4 + j] + g::16][:cnt]
                    acc = np.zeros(nf, np.float32)
                    for i in range(cnt):
                        acc = acc + w_col[i] * power[:, first + i]
                    tile[m] = np.float32(10.0) * np.log10(
                        np.maximum(acc, np.float32(1e-10)))
            tiles.append(tile)
            maxes.append(tile.max() if nf else -np.inf)
        floor = np.float32(max(maxes)) - np.float32(80)
        for rank, tile in enumerate(tiles):
            t0 = rank * fpc
            out[w, :, t0:t0 + tile.shape[1]] = (
                np.maximum(tile, floor) - np.float32(-14.8)) / np.float32(
                    19.895)
    assert not np.isnan(out).any()
    return out


# (length, element offset of the first sample): the served length, and
# T = 103 (odd, 103 % 8 != 0), T = 105 (odd), T = 46 (not a multiple of 8),
# T = 4 (CTAs 4-7 own no frame), T = 2 (CTA 1's window reflects at both
# ends); offsets 1-3 put the 16-byte chunks' phase elsewhere, offset 3 as
# x[1:] of (N, 45599) rows
_MEL_LENGTHS = ((45599, 0), (45599 - 441, 0), (45599 + 441, 1),
                (20000, 2), (1500, 3), (600, 0), (45599, 3))


@pytest.mark.parametrize("length,base", _MEL_LENGTHS)
def test_kernel_algorithm_matches_plain(length, base):
    """The CUDA kernel's algorithm (emulated) agrees with the plain version
    at atol 5e-5, an all-zero row included."""
    x = _audio((2, length), seed=3, zero_rows=((1,),))
    got = _emulate_kernel(x, base)
    want = mel.log_mel_batch(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-5)


_MEL_REFUSED = (
    ("dtype", TypeError, torch.zeros(2, 45599, dtype=torch.float64)),
    ("rank", ValueError, torch.zeros(2, 3, 45599)),
    ("strided", ValueError, torch.zeros(2, 2 * 45599)[:, ::2]),
    ("no wav", ValueError, torch.zeros(0, 45599)),
    ("short", ValueError, torch.zeros(2, 512)),
    ("too many frames for the cluster", ValueError,
     torch.zeros(1, 8 * 40 * 441)))


@pytest.mark.parametrize("exc,audio", [c[1:] for c in _MEL_REFUSED],
                         ids=[c[0] for c in _MEL_REFUSED])
def test_log_mel_wrapper_checks_before_the_library(exc, audio):
    """The wrapper's checks run before the library is bound, so they raise
    on CPU tensors too; nothing is counted. The longest length it takes,
    T = 320 frames (40 a CTA), passes."""
    fn_before, before = melspec._FN, melspec.log_mel_spec.launches
    with pytest.raises(exc):
        melspec._launch(audio)
    assert melspec._check(torch.zeros(1, 8 * 40 * 441 - 1)) == 320
    assert melspec._check(torch.empty(65535, 513, device="meta")) == 2
    assert (melspec._FN, melspec.log_mel_spec.launches) == (fn_before,
                                                            before)


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
    with pytest.raises(ValueError):  # 321 frames: 41 a CTA
        melspec.log_mel_spec(x[:1, :1].expand(1, 8 * 40 * 441).contiguous())


# (name, N, L, all-zero rows, rows dropped at the front): the buckets'
# N = 1, 16 and 128 at the served length; odd T = 103 (103 % 8 != 0);
# L = 600 (T = 2: CTA 1's window reflects at both ends, CTAs 2-7 own no
# frame); T = 320, the most the cluster takes; x[1:] of (129, 45599), whose
# base is 12 mod 16 bytes
_MEL_CARD_CASES = (("n1", 1, 45599, (), 0), ("n16", 16, 45599, ((15,),), 0),
                   ("n128", 128, 45599, ((0,), (127,)), 0),
                   ("odd_t", 5, 45599 - 441, ((4,),), 0),
                   ("short", 3, 600, (), 0),
                   ("t320", 2, 8 * 40 * 441 - 1, (), 0),
                   ("all_zero", 2, 45599, ((0,), (1,)), 0),
                   ("misaligned", 128, 45599, ((5,),), 1))


@pytest.mark.cuda
@pytest.mark.parametrize("n,length,zero_rows,drop",
                         [c[1:] for c in _MEL_CARD_CASES],
                         ids=[c[0] for c in _MEL_CARD_CASES])
def test_mel_kernel_cases_on_card(n, length, zero_rows, drop, cuda_device):
    """Each case within atol 5e-5 of the plain version, finite, in one
    launch."""
    x = torch.from_numpy(_audio((n + drop, length), seed=9,
                                zero_rows=zero_rows)).to(cuda_device)[drop:]
    assert x.is_contiguous() and x.data_ptr() % 16 == 12 * drop
    before = melspec.log_mel_spec.launches
    got = melspec.log_mel_spec(x)
    torch.cuda.synchronize()
    assert melspec.log_mel_spec.launches == before + 1
    assert got.shape == (n, 64, 1 + length // 441)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, mel.log_mel_batch(x), rtol=0, atol=5e-5)


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
                                   (4, 128, 128, 512), (4, 1, 1, 512),
                                   (3, 1, 7, 64), (2, 5, 3, 20),
                                   (1, 129, 129, 512), (4, 300, 300, 512),
                                   (2, 17, 300, 512), (2, 300, 17, 512),
                                   (1, 257, 257, 20), "unaligned"])
def test_attention_kernel_matches_plain_on_card(shape, dtype, atol,
                                                cuda_device):
    """The served shapes, the short path's edges and the long path (Lq or
    Lk > 128); D = 20 and a q that starts 2 bytes past a 16-byte boundary
    take the scalar staging."""
    unaligned = shape == "unaligned"
    if unaligned:
        shape = (8, 16, 16, 512)
    q, k, v = (torch.from_numpy(x).to(cuda_device, dtype)
               for x in _qkv(*shape, seed=3))
    if unaligned:
        q = torch.cat([q.new_zeros(1), q.flatten()])[1:].view(q.shape)
        assert q.is_contiguous() and q.data_ptr() % 16
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
    """Kernel forward, ``attention_core_bwd`` backward: the gradients on
    the card agree with the CPU's at atol 1e-5 (f32; matmul TF32 is off by
    default)."""
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
    empty = torch.zeros(1, 0, 64, device=cuda_device)
    with pytest.raises(ValueError):
        fa.fused_attention(empty, empty, empty)
    wide = torch.zeros(1, 4, 1024, device=cuda_device)
    with pytest.raises(ValueError):
        fa.fused_attention(wide, wide, wide)


@pytest.mark.cuda
def test_no_jr_fusion_over_more_than_128_rows_on_the_card(cuda_device):
    """``MultimodalTransformerNoJR`` attends over the batch axis (its
    quirk), so the attention length is the number of rows: past 128 the
    card runs K2's long path, as JAX runs ``_core_xla``; the fusion over
    129 and 300 rows on the card against the same module on the CPU (the
    plain attention), f32 within 1e-4, 4 K2 launches a forward."""
    from jmt_tpu_torch.models.jmt import MultimodalTransformerNoJR
    from jmt_tpu_torch.models.common import init_parameters
    cpu = init_parameters(MultimodalTransformerNoJR(),
                          torch.Generator().manual_seed(0))
    fusion = MultimodalTransformerNoJR()
    fusion.load_state_dict(cpu.state_dict())
    fusion.to(cuda_device)
    rng = np.random.default_rng(8)
    for rows in (129, 300):
        x, y = (torch.from_numpy(rng.normal(size=(rows, 2, 512)).astype(
            np.float32)) for _ in range(2))
        before = fa.fused_attention.launches
        with torch.inference_mode():
            got = fusion(x.to(cuda_device), y.to(cuda_device))
            torch.cuda.synchronize()
            want = cpu(x, y)
        assert fa.fused_attention.launches == before + 4
        assert got.shape == (rows, 2, 512)
        torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-4)


def _bf16(x: np.ndarray) -> np.ndarray:
    """Round float32 values to bfloat16 (nearest even), kept as float32."""
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(
        torch.bfloat16).float().numpy()


def _fma32(a, b, c):
    """f32 fused multiply-add: the f32 product is exact in f64."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def _tile_sum16(x: np.ndarray) -> np.ndarray:
    """The sum over the last axis (16) as the kernel's xor shuffles
    (offsets 8, 4, 2, 1) add it, in f32."""
    while x.shape[-1] > 1:
        half = x.shape[-1] // 2
        x = (x[..., :half] + x[..., half:]).astype(np.float32)
    return x[..., 0]


def _long_softmax(scores: np.ndarray) -> np.ndarray:
    """The long path's softmax: pass one over key tiles of 16 keeps each
    row's running max m and sum l of exp(s - m), rescaled when m grows;
    pass two P = exp(s - m) / l, all in f32."""
    lk = scores.shape[-1]
    pad = np.full(scores.shape[:-1] + (-(-lk // 16) * 16 - lk,), -np.inf,
                  np.float32)
    s = np.concatenate([scores, pad], axis=-1)
    m = np.full(scores.shape[:-1], -np.inf, np.float32)
    l = np.zeros(scores.shape[:-1], np.float32)
    for j0 in range(0, lk, 16):
        tile = s[..., j0:j0 + 16]
        mn = np.maximum(m, tile.max(-1))
        e = np.exp(tile - mn[..., None]).astype(np.float32)
        l = (l * np.exp(m - mn) + _tile_sum16(e)).astype(np.float32)
        m = mn
    return (np.exp(scores - m[..., None]) / l[..., None]).astype(np.float32)


def _emulate_attention_kernel(q, k, v, bf16: bool) -> np.ndarray:
    """csrc/fused_attention.cu in numpy float32: the 8 warps' D ranges
    (dw = round_up(ceil(round_up(D, V) / 8), V), V = 16 bytes of the
    dtype), each an FMA chain over its range, the partials added in warp
    order; softmax in f32 with max subtraction (past 128 rows the long
    path's two passes, ``_long_softmax``), P rounded to v's dtype; P.V an
    FMA chain over j in order, rounded to v's dtype."""
    bh, lq, d = q.shape
    vec = 8 if bf16 else 4
    dr = -(-d // vec) * vec
    dw = -(-(-(-dr // 8)) // vec) * vec
    scores = np.zeros((bh, lq, k.shape[1]), np.float32)
    for w in range(8):
        part = np.zeros_like(scores)
        for e in range(w * dw, min(d, (w + 1) * dw)):
            part = _fma32(q[:, :, e, None], k[:, None, :, e], part)
        scores = scores + part
    if max(lq, k.shape[1]) > 128:
        p = _long_softmax(scores)
    else:
        e = np.exp(scores - scores.max(-1, keepdims=True))
        p = e / e.sum(-1, keepdims=True, dtype=np.float32)
    p = _bf16(p) if bf16 else p.astype(np.float32)
    out = np.zeros((bh, lq, d), np.float32)
    for j in range(k.shape[1]):
        out = _fma32(p[:, :, j, None], v[:, None, j, :], out)
    return _bf16(out) if bf16 else out


# the four served shapes (BH, Lq, Lk, D) and the short path's edges:
# L = 1, Lq != Lk, L = 128, D = 64, a D that is no multiple of 16 bytes;
# then the long path: L = 129, ragged Lq or Lk past 128, D = 64 and 20
_ATTN_EMULATED = ((128, 2, 2, 512), (8, 16, 16, 512), (16, 16, 16, 512),
                  (128, 6, 6, 512), (4, 1, 1, 512), (3, 1, 7, 64),
                  (4, 16, 128, 64), (2, 128, 128, 512), (64, 16, 16, 64),
                  (2, 5, 3, 20), (1, 129, 129, 512), (2, 300, 17, 512),
                  (1, 17, 300, 64), (1, 257, 257, 20))


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5),
                                        (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("shape", _ATTN_EMULATED,
                         ids=["x".join(map(str, s)) for s in _ATTN_EMULATED])
def test_attention_kernel_algorithm_matches_plain(shape, dtype, atol):
    """K2's arithmetic (emulated) against the plain version on the same
    inputs: f32 within 2e-5, bf16 within 1e-2 (|out| < 1)."""
    q, k, v = _qkv(*shape, seed=4)
    v = 0.25 * v
    bf16 = dtype == torch.bfloat16
    if bf16:
        q, k, v = _bf16(q), _bf16(k), _bf16(v)
    got = _emulate_attention_kernel(q, k, v, bf16)
    want = fa.attention_plain(*(torch.from_numpy(x).to(dtype)
                                for x in (q, k, v))).float().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def test_attention_wrapper_sends_cpu_to_plain_without_the_library():
    """CPU tensors never reach the kernel's wrapper: the plain version,
    bitwise, no launch counted and no library loaded."""
    fn_before, before = fa._FN, fa.fused_attention.launches
    for shape in ((2, 3, 4, 8), (128, 2, 2, 512), (4, 16, 128, 64)):
        q, k, v = map(torch.from_numpy, _qkv(*shape, seed=6))
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
            torch.testing.assert_close(fa.fused_attention(q, k, v),
                                       fa.attention_plain(q, k, v),
                                       rtol=0, atol=0)
    assert fa.fused_attention.launches == before
    assert fa._FN is fn_before


_Q = torch.zeros(2, 4, 64)
_ATTN_REFUSED = (
    ("dtype", TypeError, (_Q.double(), _Q.double(), _Q.double())),
    ("mixed dtype", TypeError, (_Q, _Q.bfloat16(), _Q)),
    ("strided", ValueError, (_Q.transpose(1, 2), _Q, _Q)),
    ("rank", ValueError, (_Q[0], _Q[0], _Q[0])),
    ("k != v", ValueError, (_Q, _Q, _Q[:, :3])),
    ("bh", ValueError, (_Q, _Q[:1], _Q[:1])),
    ("lq0", ValueError, (torch.zeros(1, 0, 64),) * 3),
    ("wide", ValueError, (torch.zeros(1, 4, 1024),) * 3))


@pytest.mark.parametrize("exc,args", [c[1:] for c in _ATTN_REFUSED],
                         ids=[c[0] for c in _ATTN_REFUSED])
def test_attention_wrapper_checks_before_the_library(exc, args):
    """The checks of the wrapper's kernel path run before the library is
    bound, so they raise here too: what the kernel does not take never
    reaches it, and nothing is counted."""
    before = fa.fused_attention.launches
    with pytest.raises(exc):
        fa._launch(*args)
    assert fa.fused_attention.launches == before


# ---------------------------------------------------------------------------
# inception module (K3)
# ---------------------------------------------------------------------------
def _mixed_shapes():
    """(name, C, H = W, spec) of the nine modules at 112 px clips."""
    cin, out = 192, []
    for name, spec in I3D_STAGES:
        if name.startswith("Mixed"):
            out.append((name, cin, {"3": 28, "4": 14, "5": 7}[name[6]], spec))
            cin = module_channels(spec)
    return out


# the three modules that absorb a pool at 112 px clips: (name, C, pre-pool
# H = W, spec, pool_in) for Mixed_3b, 4b, 5b after MaxPool3d_3a, 4a, 5a
_ABSORBED = tuple((name, c, 2 * hw, spec, dict(I3D_STAGES)[
    {"Mixed_3b": "MaxPool3d_3a_3x3", "Mixed_4b": "MaxPool3d_4a_3x3",
     "Mixed_5b": "MaxPool3d_5a_2x2"}[name]])
    for name, c, hw, spec in _mixed_shapes()
    if name in ("Mixed_3b", "Mixed_4b", "Mixed_5b"))


def _folded(c, spec, dtype=torch.float32, seed=0):
    """Folded weights from random conv kernels and random BN statistics."""
    rng = np.random.default_rng(seed)
    ci = {"b0": c, "b1a": c, "b1b": spec[1], "b2a": c, "b2b": spec[3],
          "b3b": c}
    co = dict(zip(inception.BRANCHES, (spec[0], spec[1], spec[2], spec[3],
                                       spec[4], spec[5])))

    def get(name):
        k = 3 if name in ("b1b", "b2b") else 1
        fan_in = k ** 3 * ci[name]
        kernel = rng.normal(size=(k, k, k, ci[name], co[name])) * (
            2.0 / fan_in) ** 0.5
        n = co[name]
        stats = (1 + 0.1 * rng.normal(size=n), 0.1 * rng.normal(size=n),
                 0.1 * rng.normal(size=n), np.abs(1 + 0.1 * rng.normal(size=n)))
        return tuple(torch.tensor(a, dtype=torch.float32)
                     for a in (kernel, *stats))

    return inception.fold_inception_weights(get, dtype)


def _relu_input(n, c, t, h, w, seed=0):
    """x >= 0, (N, C, T, H, W) in channels-last memory."""
    x = np.maximum(np.random.default_rng(seed).normal(size=(n, t, h, w, c)),
                   0).astype(np.float32)
    return torch.from_numpy(x).permute(0, 4, 1, 2, 3)


def _sm90_tiling(ncols):
    """igemm_sm90.cuh's ``tiling``: (nw, wide, column tiles). Up to 256
    columns one tall tile of nw = round_up(ncols, 64); above, wide tiles
    (two consumers of nw columns each) over ceil(ncols / 512) tiles."""
    if ncols <= 256:
        return -(-ncols // 64) * 64, False, 1
    tiles = -(-ncols // 512)
    return -(-(-(-ncols // (2 * tiles))) // 64) * 64, True, tiles


def _emulate_inception_kernel(x, fw, o, avg_tail, pool_in=None,
                              sm90=False):
    """csrc/inception.cu in float64 numpy: the problems its ``run`` sets up
    for the two launches, ``load_a``'s gathers (1x1 rows, 3x3x3 taps with
    bounds-checked zero fill, the zero-padded pool over rows +- H W, W, 1;
    with pool_in, ``load_pooled``'s window over the pre-pool rows, whose
    result the first launch also writes for b3 to read) and ``emit``'s
    segments, f32 rounding, relu and (n, t) sums.

    With ``sm90`` the GEMMs run as igemm_sm90.cuh tiles them (its bf16
    path): column tiles of ``_sm90_tiling``, zero columns past ncols (TMA's
    fill); K tiles of 64 whose 8-wide chunks each decode their own tap
    (k // cin: a tile crosses taps when cin is 16, 24 or 48) and are zero
    past K (the ragged last tile); the f32 accumulator rounded after each
    K tile. b3 is then a 1x1 GEMM over its pool, which that path computes
    in a pass of its own (the same values as the gather here)."""
    n, c, t, h, w = x.shape
    if pool_in is not None:
        h, w = h // 2, w // 2
    rows = n * t * h * w
    xr = x.permute(0, 2, 3, 4, 1).reshape(-1, c).double().numpy()
    o0, o1, o2, o3, o4, o5 = o
    co, sa = o0 + o2 + o4 + o5, o1 + o3
    out, sums = np.zeros((rows, co)), np.zeros((n * t, co))
    scratch = np.zeros((rows, sa))
    r = np.arange(rows)
    rt, rh, rw = (r // (h * w)) % t, (r // w) % h, r % w

    def neighbour(dt, dh, dw):
        ok = ((0 <= rt + dt) & (rt + dt < t) & (0 <= rh + dh) & (rh + dh < h)
              & (0 <= rw + dw) & (rw + dw < w))
        return ok[:, None], np.clip(r + (dt * h + dh) * w + dw, 0, rows - 1)

    def load_pooled(pre):  # window t - (kt-1)/2 + [0, kt), 2h + [0, k), ...
        (kt, k, _), _ = pool_in
        hp, wp, nt = 2 * h, 2 * w, r // (h * w) - rt
        pooled = np.zeros((rows, c))
        for tt in (rt - (kt - 1) // 2 + dt for dt in range(kt)):
            for hh in (2 * rh + dh for dh in range(k)):
                for ww in (2 * rw + dw for dw in range(k)):
                    ok = (0 <= tt) & (tt < t) & (hh < hp) & (ww < wp)
                    idx = np.clip(((nt + tt) * hp + hh) * wp + ww, 0,
                                  len(pre) - 1)
                    pooled = np.maximum(pooled,
                                        np.where(ok[:, None], pre[idx], 0.0))
        return pooled

    if pool_in is not None:
        xr = load_pooled(xr)

    def load_a(mode, a, cin, aoff):
        a = a[:, aoff:aoff + cin]
        if mode == "1x1":
            return a
        if mode == "conv":  # depth k = tap * cin + channel, taps t-major
            cols = []
            for tap in range(27):
                ok, nb = neighbour(tap // 9 - 1, (tap // 3) % 3 - 1,
                                   tap % 3 - 1)
                cols.append(np.where(ok, a[nb], 0.0))
            return np.concatenate(cols, axis=1)
        pooled = a.copy()
        for tap in range(27):
            ok, nb = neighbour(tap // 9 - 1, (tap // 3) % 3 - 1, tap % 3 - 1)
            pooled = np.maximum(pooled, np.where(ok, a[nb], 0.0))
        return pooled

    def tiled(mode, a, cin, aoff, wmat):
        wm = wmat.double().numpy().reshape(-1, wmat.shape[-1])
        depth, ncols = wm.shape
        nw, wide, col_tiles = _sm90_tiling(ncols)
        width = 2 * nw if wide else nw
        whole = None if mode == "conv" else load_a(mode, a, cin, aoff)
        acc = np.zeros((rows, col_tiles * width), np.float32)
        for n0 in range(0, col_tiles * width, width):
            b = np.zeros((-(-depth // 64) * 64, width))
            b[:depth, :max(0, min(width, ncols - n0))] = wm[:, n0:n0 + width]
            for k0 in range(0, depth, 64):
                a_tile = np.zeros((rows, 64))
                for c in range(0, 64, 8):
                    k = k0 + c
                    if k >= depth:
                        continue
                    if whole is not None:
                        a_tile[:, c:c + 8] = whole[:, k:k + 8]
                        continue
                    tap, ch = divmod(k, cin)
                    ok, nb = neighbour(tap // 9 - 1, (tap // 3) % 3 - 1,
                                       tap % 3 - 1)
                    a_tile[:, c:c + 8] = np.where(
                        ok, a[nb, aoff + ch:aoff + ch + 8], 0.0)
                acc[:, n0:n0 + width] = (acc[:, n0:n0 + width]
                                         + a_tile @ b[k0:k0 + 64]
                                         ).astype(np.float32)
        return acc[:, :ncols].astype(np.float64)

    def gemm(mode, a, cin, aoff, wmat, bias, segs):
        if sm90:
            acc = tiled(mode, a, cin, aoff, wmat)
        else:
            acc = load_a(mode, a, cin, aoff) @ wmat.double().numpy().reshape(
                -1, wmat.shape[-1])
        v = acc + bias.double().numpy()
        for dst, use_sums, begin, end, off, round_first in segs:
            s = v[:, begin:end]
            if round_first:
                s = s.astype(np.float32).astype(np.float64)
            s = np.maximum(s, 0.0)
            if use_sums:
                np.add.at(sums, (r // (h * w), slice(off, off + end - begin)),
                          s)
            else:
                dst[:, off:off + end - begin] = s

    def out_seg(begin, end, off, round_first):
        return (out, avg_tail, begin, end, off, round_first)

    gemm("1x1", xr, c, 0, fw.k1, fw.b1,
         [out_seg(0, o0, 0, True),
          (scratch, False, o0, o0 + o1, 0, True),
          (scratch, False, o0 + o1, o0 + o1 + o3, o1, True)])
    gemm("conv", scratch, o1, 0, fw.kb1, fw.bb1, [out_seg(0, o2, o0, False)])
    gemm("conv", scratch, o3, o1, fw.kb2, fw.bb2,
         [out_seg(0, o4, o0 + o2, False)])
    gemm("pool", xr, c, 0, fw.k3, fw.b3,
         [out_seg(0, o5, o0 + o2 + o4, False)])
    if avg_tail:
        s = sums.reshape(n, t, co)
        return (s[:, :-1] + s[:, 1:]) * np.float32(1.0 / (2 * h * w))
    return out.reshape(n, t, h, w, co).transpose(0, 4, 1, 2, 3)


@pytest.mark.parametrize("shape,spec,avg_tail,pool_in", [
    ((2, 16, 4, 5, 6), (8, 16, 8, 8, 16, 8), False, None),
    ((1, 24, 3, 4, 4), (16, 8, 24, 16, 8, 8), False, None),
    ((2, 16, 4, 3, 3), (8, 16, 8, 8, 16, 8), True, None),
    ((2, 16, 3, 10, 8), (8, 16, 8, 8, 16, 8), False, ((1, 3, 3), (1, 2, 2))),
    ((1, 16, 4, 8, 10), (8, 16, 8, 8, 16, 8), False, ((3, 3, 3), (1, 2, 2))),
    ((2, 24, 3, 6, 4), (16, 8, 24, 16, 8, 8), True, ((2, 2, 2), (1, 2, 2)))])
def test_inception_kernel_algorithm_matches_plain(shape, spec, avg_tail,
                                                  pool_in):
    """The CUDA kernel's arithmetic (emulated, f64) against the plain
    version (f32): atol 2e-5 relative to max |plain|. H != W catches a
    swapped stride; with pool_in the shape is the pre-pool map."""
    n, c, t, h, w = shape
    x = _relu_input(n, c, t, h, w, seed=1)
    fw = _folded(c, spec, seed=2)
    want = inception.inception_plain(x, fw, spec, avg_tail=avg_tail,
                                     pool_in=pool_in).numpy()
    got = _emulate_inception_kernel(x, fw, spec, avg_tail, pool_in)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 2e-5 * np.abs(want).max()


_MIXED = {name: (c, spec) for name, c, _, spec in _mixed_shapes()}


# at the real channel counts, tiny maps: (name, (N, T, H, W), pool_in,
# the first launch's column tiles)
_SM90_CASES = (
    ("Mixed_4c", (1, 2, 3, 3), None, 1),   # b2b: K = 27 x 24 = 648
    ("Mixed_5c", (1, 2, 3, 3), None, 2),   # N = 624, avg_tail
    ("Mixed_4b", (1, 3, 6, 6), ((3, 3, 3), (1, 2, 2)), 1),  # o3 = 16
    ("Mixed_3b", (2, 2, 4, 6), ((1, 3, 3), (1, 2, 2)), 1))  # N = 176


@pytest.mark.parametrize("name,shape,pool_in,col_tiles", _SM90_CASES,
                         ids=[c[0] for c in _SM90_CASES])
def test_inception_sm90_tiling_matches_plain(name, shape, pool_in,
                                             col_tiles):
    """The bf16 launches' tiling (emulated: K tiles of 64 that cross taps,
    a ragged last K tile, column tiles with zero columns past N) against
    the plain version in f32: within 2e-5 of max |plain|. Mixed_5c's
    first launch takes two column tiles, every other one a single one, so
    pool_in's window is gathered once per row."""
    c, spec = _MIXED[name]
    n, t, h, w = shape
    o0, o1, o2, o3, o4, o5 = spec
    assert _sm90_tiling(o0 + o1 + o3)[2] == col_tiles
    x = _relu_input(n, c, t, h, w, seed=11)
    fw = _folded(c, spec, seed=12)
    avg_tail = name == "Mixed_5c"
    want = inception.inception_plain(x, fw, spec, avg_tail=avg_tail,
                                     pool_in=pool_in).numpy()
    got = _emulate_inception_kernel(x, fw, spec, avg_tail, pool_in,
                                    sm90=True)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 2e-5 * np.abs(want).max()


def _avg_slots(hw: int, bf16: bool) -> int:
    """implicit_gemm.cuh's ``avg_slots``: avg_tail's slots per (n, t)
    group of hw rows, one per 16-row block (bf16) or row (f32)."""
    return (hw + 14) // 16 + 1 if bf16 else hw


@pytest.mark.parametrize("n,t,hw", [(128, 2, 49), (1, 2, 9), (3, 5, 16),
                                    (2, 3, 17), (4, 2, 1), (2, 2, 784)])
def test_inception_avg_tail_slots_have_one_writer(n, t, hw):
    """avg_tail's fixed-order sums. The bf16 epilogue's warp of row block
    rw / 16 stores its sum over group gi's rows into slot
    rw / 16 - gi hw / 16 of gi: every slot lies below ``_avg_slots``, each
    (group, slot) belongs to one row block (one writer, no atomics), and
    a group's slot sums added in index order in f32 (the last pass) give
    the group's f64 sum within f32 rounding. The f32 epilogue's slot is
    the row's place in its group."""
    rows = n * t * hw
    row = np.arange(rows)
    block, group = row // 16, row // hw
    slot = block - group * hw // 16
    assert slot.min() >= 0 and slot.max() < _avg_slots(hw, True)
    owner = {}
    for key in zip(group.tolist(), slot.tolist(), block.tolist()):
        assert owner.setdefault(key[:2], key[2]) == key[2]
    assert (row - group * hw).max() < _avg_slots(hw, False)
    x = np.random.default_rng(3).random(rows).astype(np.float32)
    slots = np.zeros((n * t, _avg_slots(hw, True)), np.float32)
    np.add.at(slots, (group, slot), x)
    total = np.zeros(n * t, np.float32)
    for j in range(slots.shape[1]):
        total = (total + slots[:, j]).astype(np.float32)
    want = np.bincount(group, x.astype(np.float64))
    np.testing.assert_allclose(total, want, rtol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_inception_avg_tail_repeats_bitwise_on_card(dtype, cuda_device,
                                                    no_tf32):
    """K3's Mixed_5c launch (avg_tail) at its real shape, 16 clips, T 2:
    20 repeats equal the first bit for bit (the slots are added in a
    fixed order), and the first is within the kernel's tolerance of the
    plain version."""
    c, spec = _MIXED["Mixed_5c"]
    x = _relu_input(16, c, 2, 7, 7, seed=9).to(cuda_device, dtype)
    fw = inception.FoldedInception(
        *(a.to(cuda_device) for a in _folded(c, spec, dtype, seed=10)))
    first = k3.inception_module_fused(x, fw, spec, avg_tail=True)
    for _ in range(20):
        assert torch.equal(k3.inception_module_fused(x, fw, spec,
                                                     avg_tail=True), first)
    want = inception.inception_plain(x, fw, spec, avg_tail=True).float()
    tol = 5e-5 if dtype == torch.float32 else 1e-2
    assert (first.float() - want).abs().max() <= tol * want.abs().max()


def test_inception_cpu_dispatch_uses_plain_and_does_not_count():
    """Without and with pool_in (x the pre-pool map): the plain version,
    bitwise, and no launch counted."""
    spec = (8, 16, 8, 8, 16, 8)
    x = _relu_input(2, 16, 4, 10, 10)
    fw = _folded(16, spec)
    before = (k3.inception_module_fused.launches,
              k3.inception_module_fused.pool_in_launches)
    for pool_in in (None, ((3, 3, 3), (1, 2, 2))):
        for avg_tail in (False, True):
            got = k3.inception_module_fused(x, fw, spec, avg_tail=avg_tail,
                                            pool_in=pool_in)
            want = inception.inception_plain(x, fw, spec, avg_tail=avg_tail,
                                             pool_in=pool_in)
            torch.testing.assert_close(got, want, rtol=0, atol=0)
        assert got.shape == (2, 3, 40)
    assert k3.inception_module_fused(
        x, fw, spec, pool_in=((1, 3, 3), (1, 2, 2))).shape == (2, 40, 4, 5, 5)
    assert (k3.inception_module_fused.launches,
            k3.inception_module_fused.pool_in_launches) == before


@pytest.mark.parametrize("pool_in,shape", [
    (((1, 3, 3), (1, 1, 1)), (1, 16, 4, 10, 10)),    # stride
    (((1, 3, 3), (2, 2, 2)), (1, 16, 4, 10, 10)),    # temporal stride
    (((1, 3, 2), (1, 2, 2)), (1, 16, 4, 10, 10)),    # k_h != k_w
    (((1, 4, 4), (1, 2, 2)), (1, 16, 4, 12, 12)),    # k not in {2, 3}
    (((4, 3, 3), (1, 2, 2)), (1, 16, 4, 10, 10)),    # k_t not in {1, 2, 3}
    (((2, 2, 2), (1, 2, 2)), (1, 16, 4, 7, 7)),      # odd pre-pool map
    (((1, 3, 3), (1, 2, 2)), (1, 16, 4, 10, 9))])    # odd W
def test_inception_wrapper_raises_on_pool_in_it_does_not_take(pool_in,
                                                              shape):
    """On any device the wrapper takes only the pools ``pool_absorbable``
    accepts, the JAX wrapper's asserts; it never pools quietly."""
    spec = (8, 16, 8, 8, 16, 8)
    x, fw = _relu_input(*shape), _folded(16, spec)
    assert not k3.pool_absorbable(pool_in, x.shape)
    with pytest.raises(ValueError, match="pool prologue"):
        k3.inception_module_fused(x, fw, spec, pool_in=pool_in)
    assert k3.pool_absorbable(((1, 3, 3), (1, 2, 2)), (1, 16, 4, 10, 10))
    assert not k3.pool_absorbable(None, x.shape)
    assert k3._ABSORB_POOLS is False


def test_inception_wrapper_refuses_what_the_kernel_does_not_take():
    """The checks the wrapper makes before a launch, on CPU tensors."""
    spec = (8, 16, 8, 8, 16, 8)
    x, fw = _relu_input(1, 16, 4, 5, 5), _folded(16, spec)
    k3._check(x, fw, spec, avg_tail=True)   # takes the good case
    with pytest.raises(TypeError):
        k3._check(x.double(), fw, spec, False)
    with pytest.raises(ValueError, match="channels_last_3d"):
        k3._check(x.contiguous(), fw, spec, False)
    with pytest.raises(ValueError, match="multiples of 8"):
        k3._check(x, _folded(16, (8, 4, 8, 4, 8, 8)), (8, 4, 8, 4, 8, 8),
                  False)
    with pytest.raises(ValueError, match="T >= 2"):
        k3._check(x[:, :, :1], fw, spec, True)
    with pytest.raises(ValueError, match="k1"):
        k3._check(x, _folded(16, spec, dtype=torch.bfloat16), spec, False)


@pytest.fixture()
def no_tf32():
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = saved


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 5e-5),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("name,c,hw,spec", _mixed_shapes(),
                         ids=[s[0] for s in _mixed_shapes()])
def test_inception_kernel_matches_plain_on_card(name, c, hw, spec, dtype,
                                                tol, cuda_device, no_tf32):
    """Every module spec of the I3D at its real H = W, N = 2 clips, T = 8;
    Mixed_5c with its avg_tail. Relative to max |plain|: 5e-5 in f32 (TF32
    off), 1e-2 in bf16."""
    x = _relu_input(2, c, 8, hw, hw, seed=6).to(cuda_device, dtype)
    fw = inception.FoldedInception(
        *(a.to(cuda_device) for a in _folded(c, spec, dtype, seed=7)))
    avg_tail = name == "Mixed_5c"
    before = k3.inception_module_fused.launches
    got = k3.inception_module_fused(x, fw, spec, avg_tail=avg_tail)
    torch.cuda.synchronize()
    assert k3.inception_module_fused.launches == before + 1
    want = inception.inception_plain(x, fw, spec, avg_tail=avg_tail)
    assert got.shape == want.shape and got.dtype == dtype
    if not avg_tail:
        assert got.is_contiguous(memory_format=torch.channels_last_3d)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol * want.float().abs().max().item()


@pytest.mark.cuda
def test_inception_kernel_raises_on_inputs_it_does_not_take(cuda_device):
    spec = (8, 16, 8, 8, 16, 8)
    x = _relu_input(1, 16, 4, 5, 5).to(cuda_device)
    fw = inception.FoldedInception(*(a.to(cuda_device)
                                     for a in _folded(16, spec)))
    with pytest.raises(TypeError):
        k3.inception_module_fused(x.double(), fw, spec)
    with pytest.raises(ValueError):
        k3.inception_module_fused(x.contiguous(), fw, spec)
    with pytest.raises(ValueError):  # an odd (5 x 5) pre-pool map
        k3.inception_module_fused(x, fw, spec, pool_in=((1, 3, 3), (1, 2, 2)))
    with pytest.raises(ValueError):
        k3.inception_module_fused(x[:, :, :1], fw, spec, avg_tail=True)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 5e-5),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("name,c,hw,spec,pool_in", _ABSORBED,
                         ids=[s[0] for s in _ABSORBED])
def test_inception_pool_in_matches_plain_on_card(name, c, hw, spec, pool_in,
                                                 dtype, tol, cuda_device,
                                                 no_tf32):
    """The three absorbed modules on their real pre-pool maps (56, 28 and
    14), N = 2 clips, T = 8: relative to max |plain|, 5e-5 in f32 (TF32
    off), 1e-2 in bf16; one launch counted, with pool_in."""
    x = _relu_input(2, c, 8, hw, hw, seed=8).to(cuda_device, dtype)
    fw = inception.FoldedInception(
        *(a.to(cuda_device) for a in _folded(c, spec, dtype, seed=9)))
    before = (k3.inception_module_fused.launches,
              k3.inception_module_fused.pool_in_launches)
    got = k3.inception_module_fused(x, fw, spec, pool_in=pool_in)
    torch.cuda.synchronize()
    assert (k3.inception_module_fused.launches,
            k3.inception_module_fused.pool_in_launches) == (before[0] + 1,
                                                            before[1] + 1)
    want = inception.inception_plain(x, fw, spec, pool_in=pool_in)
    assert got.shape == want.shape == (2, module_channels(spec), 8, hw // 2,
                                       hw // 2)
    assert got.is_contiguous(memory_format=torch.channels_last_3d)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol * want.float().abs().max().item()


# (name, clips, T, module H = W, pool_in): row counts that are no multiple
# of the 128- or 64-row tiles (11,760 at 28 x 28, 1,176 at 7 x 7)
_RAGGED = (("Mixed_3b", 3, 5, 28, None), ("Mixed_5c", 3, 8, 7, None),
           ("Mixed_3b", 3, 5, 28, ((1, 3, 3), (1, 2, 2))),
           ("Mixed_5b", 3, 8, 7, ((2, 2, 2), (1, 2, 2))))


@pytest.mark.cuda
@pytest.mark.parametrize("name,n,t,hw,pool_in", _RAGGED,
                         ids=[f"{c[0]}-{c[3]}{'-pool' if c[4] else ''}"
                              for c in _RAGGED])
def test_inception_bf16_ragged_rows_on_card(name, n, t, hw, pool_in,
                                            cuda_device):
    """K3's bf16 launches (igemm_sm90.cuh) where the last row tile is
    partly past the rows, with and without pool_in (x the pre-pool map):
    within 1e-2 of max |plain|."""
    c, spec = _MIXED[name]
    pre = 2 * hw if pool_in else hw
    x = _relu_input(n, c, t, pre, pre, seed=15).to(cuda_device,
                                                   torch.bfloat16)
    fw = inception.FoldedInception(*(a.to(cuda_device) for a in _folded(
        c, spec, torch.bfloat16, seed=16)))
    avg_tail = name == "Mixed_5c"
    got = k3.inception_module_fused(x, fw, spec, avg_tail=avg_tail,
                                    pool_in=pool_in)
    torch.cuda.synchronize()
    want = inception.inception_plain(x, fw, spec, avg_tail=avg_tail,
                                     pool_in=pool_in)
    assert got.shape == want.shape and torch.isfinite(got).all()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= 1e-2 * want.float().abs().max().item()


# ---------------------------------------------------------------------------
# pool + 1x1 (K4)
# ---------------------------------------------------------------------------
def _normal_input(n, c, t, h, w, seed=0):
    """x ~ N(0, 1), any sign, (N, C, T, H, W) in channels-last memory."""
    x = np.random.default_rng(seed).normal(size=(n, t, h, w, c)).astype(
        np.float32)
    return torch.from_numpy(x).permute(0, 4, 1, 2, 3)


def _k4_weight(c, co, seed=0):
    return torch.from_numpy((0.1 * np.random.default_rng(seed).normal(
        size=(c, co))).astype(np.float32))


def _emulate_pool1x1_kernel(x, k):
    """csrc/pool1x1.cu's f32 launch in float64 numpy: ``load_a``'s
    kPoolGemm gather under kNegInf (start from the row itself, skip the 26
    neighbours past the map: -inf padding, over rows +- H W, W, 1) and the
    epilogue's plain cast."""
    n, c, t, h, w = x.shape
    rows = n * t * h * w
    xr = x.permute(0, 2, 3, 4, 1).reshape(rows, c).double().numpy()
    r = np.arange(rows)
    rt, rh, rw = (r // (h * w)) % t, (r // w) % h, r % w
    pooled = xr.copy()
    for tap in range(27):
        dt, dh, dw = tap // 9 - 1, (tap // 3) % 3 - 1, tap % 3 - 1
        ok = ((0 <= rt + dt) & (rt + dt < t) & (0 <= rh + dh) & (rh + dh < h)
              & (0 <= rw + dw) & (rw + dw < w))
        nb = np.clip(r + (dt * h + dh) * w + dw, 0, rows - 1)
        pooled = np.where(ok[:, None], np.maximum(pooled, xr[nb]), pooled)
    out = (pooled @ k.double().numpy()).astype(np.float32)
    return out.reshape(n, t, h, w, -1).transpose(0, 4, 1, 2, 3)


# csrc/pool1x1_sm90.cuh's constants: a halo box is 4 planes x 6 rows x 16
# columns of 128 bytes (a band of 4 output rows x 14 columns, 64 rows of A
# with rows 14 and 15 of each 16 unused); the ring's bytes, a B box (64 x
# 64 bf16), the wgmma widths a column tile takes
_K4_PLANES, _K4_NB, _K4_SEGW = 4, 6, 16
_K4_HB, _K4_WB = _K4_NB - 2, _K4_SEGW - 2
_K4_RING, _K4_BOX = 197632, 8192
_K4_WIDTHS = (8, 16, 32, 64, 128, 192, 256)


def _k4_sm90_geometry(h, w, co):
    """pool1x1_sm90.cuh's ``geometry``: bands of W and H, the column tile
    width nw (a wgmma N), the column tiles and the ring's stages (a halo
    box and k's boxes each)."""
    col_tiles = -(-co // 256)
    per = -(-co // col_tiles)
    nw = next(x for x in _K4_WIDTHS if x >= per)
    stage = (_K4_PLANES * _K4_NB * _K4_SEGW * 128
             + -(-nw // 64) * _K4_BOX)
    return (-(-w // _K4_WB), -(-h // _K4_HB), nw, col_tiles,
            min(4, _K4_RING // stage))


def _emulate_pool1x1_sm90(x, k):
    """csrc/pool1x1_sm90.cuh (K4's bf16 launch) in numpy: per item (n, a
    pair of planes t0 and t0 + 1, a band of 4 rows of H and 14 columns of
    W, a column tile), per 64-channel chunk, the halo box as TMA stages it
    (planes t0-1..t0+2, rows h0-1..h0+4, columns w0-1..w0+14; zeros past
    the map and past C); consumer warpgroup cw takes output plane t0 + cw
    from box planes cw..cw+2: the separable max over T, H and W with
    positions past the map masked to -inf by index, into A row 16 hr + c
    (zero where the output lies past the map), and the product of each
    chunk (f64, exact for bf16 values) added to f32 accumulators; the
    epilogue keeps the rows and columns inside the output. Returns the f32
    sums before the cast to bf16, (N, Co, T, H, W)."""
    n, c, t, h, w = x.shape
    co = k.shape[1]
    xs = x.permute(0, 2, 3, 4, 1).double().numpy()       # (N, T, H, W, C)
    kk = k.double().numpy()
    nwb, nhb, nw, col_tiles, _ = _k4_sm90_geometry(h, w, co)
    hb, wb, nk = _K4_HB, _K4_WB, -(-c // 64)
    xpad = np.zeros((n, t + 3, nhb * hb + 2, nwb * wb + 2, nk * 64))
    xpad[:, 1:t + 1, 1:h + 1, 1:w + 1, :c] = xs          # TMA's zero fill
    kpad = np.zeros((nk * 64, col_tiles * nw))
    kpad[:c, :co] = kk
    hr, cc = np.divmod(np.arange(64), _K4_SEGW)          # A row 16 hr + c
    used = cc < wb
    hr, cc = hr[used], cc[used]
    out = np.zeros((n, t, h, w, co), np.float32)
    for ni, t0, h0, w0, col in itertools.product(
            range(n), range(0, t, 2), range(0, h, hb), range(0, w, wb),
            range(col_tiles)):
        # mask by index: plane, row and column inside the map
        qt = (t0 - 1 + np.arange(_K4_PLANES) >= 0) & (
            t0 - 1 + np.arange(_K4_PLANES) < t)
        bh = (h0 - 1 + np.arange(_K4_NB) >= 0) & (h0 - 1 + np.arange(_K4_NB)
                                                  < h)
        lw = (w0 - 1 + np.arange(_K4_SEGW) >= 0) & (
            w0 - 1 + np.arange(_K4_SEGW) < w)
        ok = qt[:, None, None] & bh[None, :, None] & lw[None, None, :]
        center = (h0 + hr < h) & (w0 + cc < w)
        cols = min(nw, co - col * nw)
        for cw in (0, 1):
            if t0 + cw >= t:
                continue                  # T odd: the last pair is one
            acc = np.zeros((len(hr), nw), np.float32)
            for kc in range(nk):
                box = xpad[ni, t0:t0 + _K4_PLANES, h0:h0 + _K4_NB,
                           w0:w0 + _K4_SEGW, kc * 64:kc * 64 + 64]
                box = np.where(ok[..., None], box, -np.inf)
                tm = box[cw:cw + 3].max(axis=0)                      # T
                hm = np.maximum(np.maximum(tm[:-2], tm[1:-1]), tm[2:])  # H
                wm = np.maximum(np.maximum(hm[:, :-2], hm[:, 1:-1]),
                                hm[:, 2:])                           # W
                a = np.where(center[:, None], wm[hr, cc], 0.0)
                b = kpad[kc * 64:kc * 64 + 64, col * nw:col * nw + nw]
                acc = (acc + a @ b).astype(np.float32)
            out[ni, t0 + cw, h0 + hr[center], w0 + cc[center],
                col * nw:col * nw + cols] = acc[center, :cols]
    return out.transpose(0, 4, 1, 2, 3)


# the TPU tool's check shapes and (N, C, T, H, W) -> Co cases the emulations
# share: the tool's six timed shapes at N = 1, T = 1 with H = 1 and W = 2,
# rows that fill no tile (45 a strip, 135 in all, T odd), C = 200 (a last
# chunk of 8 channels) with Co = 264 (two column tiles), W = 40 (three W
# bands)
_K4_EMULATED = (((2, 16, 4, 6, 6), 8), ((1, 32, 8, 14, 14), 16),
                ((2, 24, 3, 5, 7), 16),
                ((1, 512, 8, 14, 14), 64), ((1, 832, 4, 7, 7), 128),
                ((1, 256, 8, 28, 28), 64), ((1, 480, 8, 14, 14), 64),
                ((1, 528, 8, 14, 14), 128), ((1, 192, 8, 28, 28), 32),
                ((2, 16, 1, 1, 2), 8), ((1, 24, 3, 5, 9), 16),
                ((1, 200, 2, 6, 7), 264), ((1, 8, 2, 3, 40), 16))
_K4_EMULATED_IDS = [f"{c}x{t}x{h}x{w}-{co}" for (_, c, t, h, w), co
                    in _K4_EMULATED]


@pytest.mark.parametrize("shape,co", _K4_EMULATED[:3])
def test_pool1x1_kernel_algorithm_matches_plain(shape, co):
    """K4's f32 arithmetic (emulated, f64) against the plain version (f32)
    on inputs of both signs, where -inf and zero padding differ: atol 1e-5
    relative to max |plain|. The first two are the TPU tool's check
    shapes; H != W catches a swapped stride."""
    x, k = _normal_input(*shape, seed=10), _k4_weight(shape[1], co, seed=11)
    want = pool3_1x1_plain(x, k).numpy()
    got = _emulate_pool1x1_kernel(x, k)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("shape,co", _K4_EMULATED[3:],
                         ids=_K4_EMULATED_IDS[3:])
def test_pool1x1_f32_algorithm_matches_plain_at_more_shapes(shape, co):
    """The f32 launch's emulation at the TPU tool's shapes (N = 1) and the
    edge shapes, as above: atol 1e-5 relative to max |plain|."""
    x, k = _normal_input(*shape, seed=15), _k4_weight(shape[1], co, seed=16)
    want = pool3_1x1_plain(x, k).numpy()
    got = _emulate_pool1x1_kernel(x, k)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("shape,co", _K4_EMULATED, ids=_K4_EMULATED_IDS)
def test_pool1x1_sm90_algorithm_matches_plain(shape, co):
    """K4's bf16 design (emulated) against the plain version in f32 on the
    same bf16-valued inputs of both signs: the pool is exact and the
    products exact in f64, so the f32 sums agree within atol 1e-5
    relative to max |plain| (the cast to bf16 is the plain version's too)."""
    x = _normal_input(*shape, seed=17).bfloat16().float()
    k = _k4_weight(shape[1], co, seed=18).bfloat16().float()
    want = pool3_1x1_plain(x, k).numpy()
    got = _emulate_pool1x1_sm90(x, k)
    assert got.shape == want.shape and np.isfinite(got).all()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_pool1x1_sm90_geometry():
    """The bands, wgmma width, column tiles and ring stages of the bf16
    design at the TPU tool's shapes (N = Co in one column tile) and at the
    edge shapes."""
    assert _k4_sm90_geometry(14, 14, 64) == (1, 4, 64, 1, 3)
    assert _k4_sm90_geometry(7, 7, 128) == (1, 2, 128, 1, 3)
    assert _k4_sm90_geometry(28, 28, 32) == (2, 7, 32, 1, 3)
    assert _k4_sm90_geometry(14, 14, 128) == (1, 4, 128, 1, 3)
    assert _k4_sm90_geometry(6, 7, 264) == (1, 2, 192, 2, 2)
    assert _k4_sm90_geometry(3, 40, 256) == (3, 1, 256, 1, 2)


def test_pool1x1_cpu_dispatch_uses_plain_and_does_not_count():
    x, k = _normal_input(2, 16, 4, 5, 6, seed=12), _k4_weight(16, 8)
    before = k4.pool3_1x1.launches
    got = k4.pool3_1x1(x, k)
    assert k4.pool3_1x1.launches == before
    torch.testing.assert_close(got, pool3_1x1_plain(x, k), rtol=0, atol=0)
    assert got.shape == (2, 8, 4, 5, 6) and got.dtype == torch.float32
    assert got.is_contiguous(memory_format=torch.channels_last_3d)


def test_pool1x1_wrapper_refuses_what_the_kernel_does_not_take():
    """The checks the wrapper makes before a launch, on CPU tensors."""
    x, k = _normal_input(1, 16, 4, 5, 5), _k4_weight(16, 8)
    k4._check(x, k)   # takes the good case
    with pytest.raises(TypeError):
        k4._check(x.double(), k.double())
    with pytest.raises(ValueError, match="channels_last_3d"):
        k4._check(x.contiguous(), k)
    with pytest.raises(ValueError, match="k must be"):
        k4._check(x, k.bfloat16())
    with pytest.raises(ValueError, match="k must be"):
        k4._check(x, _k4_weight(8, 8))
    with pytest.raises(ValueError, match="multiples of 8"):
        k4._check(x, _k4_weight(16, 12))
    with pytest.raises(ValueError, match="multiples of 8"):
        k4._check(_normal_input(1, 12, 4, 5, 5), _k4_weight(12, 8))


# the TPU tool's six timed shapes (N, T, H, W, C) -> Co, at N = 2 clips,
# then the edge shapes of the emulations: T = 1, H = 1, W = 2; 135 rows;
# C = 200 with Co = 264; W = 40 (two W bands); Co = 8 and 16 (the narrow
# wgmma widths)
_K4_SHAPES = (((2, 8, 14, 14, 512), 64), ((2, 4, 7, 7, 832), 128),
              ((2, 8, 28, 28, 256), 64), ((2, 8, 14, 14, 480), 64),
              ((2, 8, 14, 14, 528), 128), ((2, 8, 28, 28, 192), 32),
              ((2, 1, 1, 2, 16), 8), ((1, 3, 5, 9, 24), 16),
              ((1, 2, 6, 7, 200), 264), ((1, 2, 3, 40, 8), 16))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("shape,co", _K4_SHAPES,
                         ids=[f"{s[2]}x{s[3]}x{s[4]}-{co}"
                              + ("" if s[0] == 2 and s[1] > 1 else
                                 f"-n{s[0]}t{s[1]}")
                              for s, co in _K4_SHAPES])
def test_pool1x1_kernel_matches_plain_on_card(shape, co, dtype, tol,
                                              cuda_device, no_tf32):
    """K4 at the TPU tool's timed shapes (the 28 x 28 x 256 and C = 832
    ones did not compile on the TPU), inputs of both signs: relative to max
    |plain|, 1e-5 in f32 (TF32 off), 1e-2 in bf16; one launch counted."""
    n, t, h, w, c = shape
    x = _normal_input(n, c, t, h, w, seed=13).to(cuda_device, dtype)
    k = _k4_weight(c, co, seed=14).to(cuda_device, dtype)
    before = k4.pool3_1x1.launches
    got = k4.pool3_1x1(x, k)
    torch.cuda.synchronize()
    assert k4.pool3_1x1.launches == before + 1
    want = pool3_1x1_plain(x, k)
    assert got.shape == want.shape == (n, co, t, h, w)
    assert got.dtype == dtype
    assert got.is_contiguous(memory_format=torch.channels_last_3d)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol * want.float().abs().max().item()


@pytest.mark.cuda
def test_pool1x1_kernel_raises_on_inputs_it_does_not_take(cuda_device):
    x = _normal_input(1, 16, 4, 5, 5).to(cuda_device)
    k = _k4_weight(16, 8).to(cuda_device)
    with pytest.raises(TypeError):
        k4.pool3_1x1(x.double(), k.double())
    with pytest.raises(ValueError):
        k4.pool3_1x1(x.contiguous(), k)
    with pytest.raises(ValueError):
        k4.pool3_1x1(x, k.cpu())
    with pytest.raises(ValueError):
        k4.pool3_1x1(x, _k4_weight(16, 12).to(cuda_device))


# ---------------------------------------------------------------------------
# the server's CUDA graphs
# ---------------------------------------------------------------------------
FLAGSHIP = dict(vision_backbones=("R2D1", "I3D"),
                audio_backbones=("ResNet18", "wavLM"),
                intra_modal_fusion="encoder_plus_self_attention",
                r2d1_reduce="MAX", i3d_input_size=224,
                i3d_fused_inception=True)


def _flagship_server(dtype, cuda_device):
    from jmt_tpu_torch.models.common import init_parameters
    from jmt_tpu_torch.models.jmt_model import JMTModel
    from jmt_tpu_torch.serve import InferenceServer
    model = init_parameters(JMTModel(**FLAGSHIP, dtype=dtype),
                            torch.Generator().manual_seed(0))
    return InferenceServer(model, seq=2, buckets=(1, 2), device=cuda_device)


def _request(n, seq=2, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (n, seq, 8, 112, 112, 3), dtype=np.uint8),
            (0.1 * rng.normal(size=(n, seq, 45599))).astype(np.float32),
            rng.normal(size=(n, seq, 768)).astype(np.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-3)],
                         ids=["f32", "bf16"])
def test_graph_replay_matches_eager_forward_on_card(dtype, tol, cuda_device,
                                                    monkeypatch):
    """Replay against the eager forward on the same bucket inputs. bf16:
    K3's Mixed_5c launch sums its average pool by f32 atomics, whose
    order varies run to run (V 4.9e-4, A 9.8e-4 seen); f32 with TF32 off.
    Each bucket's capture holds 1 log-mel, 12 attention and 9 inception
    launches."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    server = _flagship_server(dtype, cuda_device)
    for b, graph in server.graphs.items():
        assert graph.launches == {"log_mel": 1, "fused_attention": 12,
                                  "inception_module_fused": 9,
                                  "inception_pool_in": 0, "pool3_1x1": 0}
        req = _request(b, seed=b)
        v, a = server.predict(*req)
        arrays = {k: torch.from_numpy(x).to(cuda_device)
                  for k, x in zip(("clips", "audio", "wavlm"), req)}
        ve, ae = server.forward(arrays)
        for got, want in ((v, ve), (a, ae)):
            want = want.float().cpu().numpy()
            assert np.isfinite(got).all() and np.std(got) > 0
            np.testing.assert_allclose(got, want, rtol=0, atol=tol)


@pytest.mark.cuda
def test_failed_capture_raises_and_moved_weights_are_refused(cuda_device):
    from jmt_tpu_torch.serve import InferenceServer

    class HostRead(torch.nn.Module):
        vision_backbones, audio_backbones = (), ("wavLM",)
        use_wavlm, dtype = True, None

        def __init__(self):
            super().__init__()
            self.fc = torch.nn.Linear(768, 2)

        def forward(self, spec, clips, wavlm):
            out = self.fc(wavlm)
            if float(out.sum()) > 1e30:  # a host read: no graph can hold it
                out = 2 * out
            return out[..., 0], out[..., 1]

    with pytest.raises(Exception, match="captur"):
        InferenceServer(HostRead(), seq=2, buckets=(1,), device=cuda_device)
    torch.cuda.synchronize()
    server = _flagship_server(torch.bfloat16, cuda_device)
    server.model.cpu()
    with pytest.raises(RuntimeError, match="moved"):
        server.predict(*_request(1))
