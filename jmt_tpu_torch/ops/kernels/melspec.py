"""Wrapper of the CUDA log-mel kernel (``csrc/melspec.cu``).

Replaces the TPU kernel ``jmt_tpu/ops/pallas/melspec.py`` (``log_mel_pallas``,
body ``_kernel``). The source note in ``csrc/melspec.cu`` says what bounds
it on an H100 and how its design answers that: one launch of resident
thread-block clusters that walk the wavs (``CLUSTER`` CTAs a wav, each
staging its audio window once, the next wav's while it computes, and
resolving the per-wav dB floor through distributed shared memory), a
register-resident radix-32 x 32 FFT per warp carrying two frames per
complex transform instead of the TPU's cos/sin GEMMs, a lane-parallel
sparse mel sum, full fp32.

``log_mel_spec`` is the dispatcher: a CPU tensor goes to the plain version
``ops.mel.log_mel_batch``; a CUDA tensor goes to the kernel, or the call
raises. ``log_mel_spec.launches`` counts kernel launches.

A call takes a few microseconds on the card, so the host's path is kept
short: the C function's argument types are bound once (``_kernel_fn``), the
stream is read as a raw handle, and the device context is entered only when
the audio lies on another device than the current.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from jmt_tpu_torch.ops.kernels import build
from jmt_tpu_torch.ops.mel import (HOP_LENGTH, N_FFT, N_MELS, _padded_hann,
                                   log_mel_batch, mel_filterbank)

CLUSTER = 8                 # CTAs per wav, kCluster in the source
MAX_FRAMES_PER_CTA = 40     # kMaxFramesPerCta: T <= 320
MEL_SLOTS = 4               # kMelSlots: bands per lane, 16 lanes a frame
_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


@functools.lru_cache(maxsize=1)
def _host_constants():
    """Window, FFT twiddles and the filterbank as the kernel reads them, as
    numpy: the (1024,) padded Hann; the (32 x 32, 2) twiddles W1024^(k2 n1)
    at row 32 k2 + n1 as (cos, -sin); the slot-major filterbank table;
    (4, 64) int32 meta.

    The bands, sorted by bin count, fill MEL_SLOTS slots of 16: lane g of a
    frame sums the band of slot 16 j + g for each j, all 16 lanes for len_j
    steps, the slot's widest band. Slot j's block of the table is (len_j,
    16), column g the weights of its band, zero past the band's count. Meta
    rows: each slot's band, first bin and bin count; then len_j and the
    blocks' offsets."""
    k2, n1 = np.meshgrid(np.arange(32), np.arange(32), indexing="ij")
    ang = 2.0 * np.pi * (k2 * n1).reshape(-1) / N_FFT
    twiddle = np.stack([np.cos(ang), -np.sin(ang)], axis=1).astype(np.float32)
    fb = mel_filterbank()                               # (513, 64)
    first, cnt = np.zeros(N_MELS, np.int32), np.zeros(N_MELS, np.int32)
    for m in range(N_MELS):
        nz = np.nonzero(fb[:, m])[0]
        first[m], cnt[m] = nz[0], nz[-1] - nz[0] + 1
    bands = np.array(sorted(range(N_MELS), key=lambda m: (cnt[m], m)))
    lens = cnt[bands].reshape(MEL_SLOTS, 16).max(1)
    offs = np.concatenate([[0], np.cumsum(16 * lens)[:-1]])
    table = np.zeros(16 * lens.sum(), np.float32)
    for slot, m in enumerate(bands):
        j, g = divmod(slot, 16)
        table[offs[j] + g + 16 * np.arange(cnt[m])] = \
            fb[first[m]:first[m] + cnt[m], m]
    tail = np.zeros(N_MELS, np.int32)
    tail[:2 * MEL_SLOTS] = np.concatenate([lens, offs])
    meta = np.stack([bands, first[bands], cnt[bands], tail]).astype(np.int32)
    return np.array(_padded_hann()), twiddle, table, meta


@functools.lru_cache(maxsize=4)
def _device_constants(device: torch.device):
    return tuple(torch.from_numpy(a).to(device) for a in _host_constants())


def filterbank_nnz() -> int:
    """Nonzeros of the mel filterbank (each band's bin count, summed)."""
    return int(_host_constants()[3][2].sum())


def _check(audio: torch.Tensor) -> int:
    """Raise on what the kernel does not take; return the frame count."""
    if audio.dtype != torch.float32:
        raise TypeError(f"log-mel kernel takes float32, got {audio.dtype}")
    if audio.ndim != 2 or not audio.is_contiguous():
        raise ValueError("log-mel kernel takes a contiguous (N, L) tensor, "
                         f"got {tuple(audio.shape)} "
                         f"(contiguous={audio.is_contiguous()})")
    n, length = audio.shape
    if not 0 < n <= 65535 or length <= N_FFT // 2:
        raise ValueError(f"log-mel kernel takes 1 <= N <= 65535 wavs of more "
                         f"than {N_FFT // 2} samples, got {tuple(audio.shape)}")
    n_frames = 1 + length // HOP_LENGTH
    if -(-n_frames // CLUSTER) > MAX_FRAMES_PER_CTA:
        raise ValueError(f"log-mel kernel splits a wav's frames over "
                         f"{CLUSTER} CTAs of at most {MAX_FRAMES_PER_CTA}: "
                         f"{n_frames} frames (L = {length}) do not fit")
    return n_frames


_FN = None


def _kernel_fn():
    """``jmt_log_mel`` of the built library, its argument types bound once;
    the library's limits are checked against the wrapper's at binding."""
    global _FN
    if _FN is None:
        lib = build.load("melspec")
        if (lib.jmt_mel_cluster(), lib.jmt_mel_max_frames_per_cta(),
                lib.jmt_mel_slots()) != (CLUSTER, MAX_FRAMES_PER_CTA,
                                         MEL_SLOTS):
            raise RuntimeError("log-mel kernel library disagrees with its "
                               "wrapper on the cluster or slot geometry")
        fn = lib.jmt_log_mel
        fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
        _FN = fn
    return _FN


def _launch(audio: torch.Tensor) -> torch.Tensor:
    n_frames = _check(audio)
    fn = _kernel_fn()
    n, length = audio.shape
    device = audio.device
    window, twiddle, fb_table, fb_meta = _device_constants(device)
    out = torch.empty((n, N_MELS, n_frames), dtype=torch.float32,
                      device=device)
    args = (audio.data_ptr(), out.data_ptr(), window.data_ptr(),
            twiddle.data_ptr(), fb_table.data_ptr(), fb_meta.data_ptr(),
            fb_table.numel(), n, length, n_frames)
    index = device.index
    if index == torch.cuda.current_device():
        status = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(device):
            status = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    if status:
        build.check(build.load("melspec"), status, "log-mel kernel")
    log_mel_spec.launches += 1
    return out


def log_mel_spec(audio: torch.Tensor) -> torch.Tensor:
    """(N, L) f32 wavs -> (N, 64, 1 + L // 441) normalized log-mel with a
    per-wav dB floor. CUDA: the kernel; CPU: ``log_mel_batch``."""
    if audio.is_cuda:
        return _launch(audio)
    return log_mel_batch(audio, batch_dims=1)


log_mel_spec.launches = 0
