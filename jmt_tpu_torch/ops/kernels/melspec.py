"""Wrapper of the CUDA log-mel kernel (``csrc/melspec.cu``).

Replaces the TPU kernel ``jmt_tpu/ops/pallas/melspec.py`` (``log_mel_pallas``,
body ``_kernel``). The source note in ``csrc/melspec.cu`` says what bounds
it on an H100 and how its design answers that: framing inside the kernel,
an in-kernel radix-2 FFT carrying two frames per complex transform instead
of the TPU's cos/sin GEMMs, a sparse mel GEMM, full fp32, and a second pass
for the per-wav dB floor.

``log_mel_spec`` is the dispatcher: a CPU tensor goes to the plain version
``ops.mel.log_mel_batch``; a CUDA tensor goes to the kernel, or the call
raises. ``log_mel_spec.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from jmt_tpu_torch.ops.kernels import build
from jmt_tpu_torch.ops.mel import (HOP_LENGTH, N_FFT, N_MELS, _padded_hann,
                                   log_mel_batch, mel_filterbank)

_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


@functools.lru_cache(maxsize=1)
def _host_constants():
    """Window, FFT twiddles and the compact filterbank, as numpy."""
    k = np.arange(N_FFT // 2)
    ang = 2.0 * np.pi * k / N_FFT
    twiddle = np.stack([np.cos(ang), -np.sin(ang)], axis=1).astype(np.float32)
    fb = mel_filterbank()                               # (513, 64)
    lo, cnt, off, weights = [], [], [], []
    for m in range(N_MELS):
        nz = np.nonzero(fb[:, m])[0]
        first, n = (int(nz[0]), int(nz[-1] - nz[0] + 1)) if nz.size else (0, 0)
        lo.append(first)
        cnt.append(n)
        off.append(sum(len(w) for w in weights))
        weights.append(fb[first:first + n, m])
    meta = np.array([lo, cnt, off], np.int32)           # (3, 64)
    return (np.array(_padded_hann()), twiddle,
            np.concatenate(weights).astype(np.float32), meta)


@functools.lru_cache(maxsize=4)
def _device_constants(device: torch.device):
    return tuple(torch.from_numpy(a).to(device) for a in _host_constants())


def filterbank_nnz() -> int:
    """Nonzeros of the compact filterbank the kernel reads."""
    return int(_host_constants()[2].size)


def _launch(audio: torch.Tensor) -> torch.Tensor:
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
    lib = build.load("melspec")
    fn = lib.jmt_log_mel
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    window, twiddle, fb_w, fb_meta = _device_constants(audio.device)
    if fb_w.numel() > lib.jmt_mel_max_nnz():
        raise ValueError("filterbank has more nonzeros than the kernel holds")
    out = torch.empty((n, N_MELS, n_frames), dtype=torch.float32,
                      device=audio.device)
    scratch = torch.empty((n,), dtype=torch.int32, device=audio.device)
    with torch.cuda.device(audio.device):
        stream = torch.cuda.current_stream(audio.device).cuda_stream
        status = fn(audio.data_ptr(), out.data_ptr(), scratch.data_ptr(),
                    window.data_ptr(), twiddle.data_ptr(), fb_w.data_ptr(),
                    fb_meta.data_ptr(), n, length, n_frames, fb_w.numel(),
                    stream)
    build.check(lib, status, "log-mel kernel")
    log_mel_spec.launches += 1
    return out


def log_mel_spec(audio: torch.Tensor) -> torch.Tensor:
    """(N, L) f32 wavs -> (N, 64, 1 + L // 441) normalized log-mel with a
    per-wav dB floor. CUDA: the kernel; CPU: ``log_mel_batch``."""
    if audio.is_cuda:
        return _launch(audio)
    return log_mel_batch(audio, batch_dims=1)


log_mel_spec.launches = 0
