"""Log-mel spectrogram front end (plain PyTorch version and dispatcher).

Counterpart of ``jmt_tpu/ops/mel.py``: torchaudio's
``MelSpectrogram(sample_rate=44100, win_length=882, hop_length=441,
n_mels=64, n_fft=1024, hann window, power=2)`` -> ``AmplitudeToDB('power',
top_db=80)`` -> ``Normalize(-14.8, 19.895)``, per wav.

* STFT center=True with REFLECT padding of n_fft // 2 (no edge repeat),
  periodic Hann of win_length zero-padded symmetrically to n_fft, one-sided
  spectrum, |X|^2.
* HTK mel filterbank (norm=None, f_min=0, f_max=sr/2).
* dB floor at (max - top_db), the max taken over each wav's whole
  (64, frames) spectrogram.

``log_mel_batch`` is the plain version (``torch.fft.rfft`` + GEMM). The
serving path calls ``log_mel``, which hands CUDA tensors to the CUDA kernel
of ``ops/kernels/melspec.py`` and CPU tensors to ``log_mel_batch``.
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

SAMPLE_RATE = 44100
N_FFT = 1024
WIN_LENGTH = 882
HOP_LENGTH = 441
N_MELS = 64
AUDIO_SAMPLES = 45599  # fixed left-padded wav length
SPEC_FRAMES = 1 + AUDIO_SAMPLES // HOP_LENGTH  # = 104
SPEC_MEAN = -14.8
SPEC_STD = 19.895
TOP_DB = 80.0
AMIN = 1e-10


def hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, dtype=np.float64) / 700.0)


def mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m, dtype=np.float64) / 2595.0) - 1.0)


@functools.lru_cache(maxsize=8)
def mel_filterbank(n_freqs: int = N_FFT // 2 + 1, n_mels: int = N_MELS,
                   sample_rate: int = SAMPLE_RATE, f_min: float = 0.0,
                   f_max: Optional[float] = None) -> np.ndarray:
    """HTK-scale triangular filterbank (n_freqs, n_mels), norm=None —
    torchaudio melscale_fbanks defaults. Read-only: callers copy."""
    f_max = f_max if f_max is not None else sample_rate / 2.0
    all_freqs = np.linspace(0, sample_rate // 2, n_freqs)
    m_pts = np.linspace(hz_to_mel(f_min), hz_to_mel(f_max), n_mels + 2)
    f_pts = mel_to_hz(m_pts)
    f_diff = f_pts[1:] - f_pts[:-1]                       # (n_mels+1,)
    slopes = f_pts[None, :] - all_freqs[:, None]          # (n_freqs, n_mels+2)
    down = -slopes[:, :-2] / f_diff[:-1]                  # rising edge
    up = slopes[:, 2:] / f_diff[1:]                       # falling edge
    fb = np.maximum(0.0, np.minimum(down, up)).astype(np.float32)
    fb.setflags(write=False)
    return fb


@functools.lru_cache(maxsize=8)
def _padded_hann(win_length: int = WIN_LENGTH,
                 n_fft: int = N_FFT) -> np.ndarray:
    """torch.hann_window(win_length, periodic=True), zero-padded
    symmetrically to n_fft. Read-only: callers copy."""
    w = 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(win_length) / win_length))
    lpad = (n_fft - win_length) // 2
    out = np.zeros(n_fft)
    out[lpad:lpad + win_length] = w
    out = out.astype(np.float32)
    out.setflags(write=False)
    return out


def _frame(x: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """(..., L) zero-centered framing with reflect pad -> (..., T, n_fft)."""
    lead = x.shape[:-1]
    pad = n_fft // 2
    xp = F.pad(x.reshape(-1, x.shape[-1]), (pad, pad), mode="reflect")
    frames = xp.unfold(-1, n_fft, hop)                     # (M, T, n_fft)
    return frames.reshape(*lead, *frames.shape[-2:])


def mel_spectrogram(audio: torch.Tensor) -> torch.Tensor:
    """audio: (..., L) float in [-1, 1] -> mel power spectrogram
    (..., n_mels, T)."""
    frames = _frame(audio.float(), N_FFT, HOP_LENGTH)
    window = torch.tensor(np.array(_padded_hann()), device=audio.device)
    spec = torch.fft.rfft(frames * window, dim=-1)         # (..., T, 513)
    p = spec.abs() ** 2
    fb = torch.tensor(np.array(mel_filterbank()), device=audio.device)
    return torch.matmul(p, fb).transpose(-1, -2)           # (..., 64, T)


def amplitude_to_db(x: torch.Tensor, top_db: float = TOP_DB,
                    amin: float = AMIN,
                    per_item_axes: Optional[int] = None) -> torch.Tensor:
    """torchaudio AmplitudeToDB('power', top_db).

    per_item_axes: number of LEADING batch axes; the floor uses the max over
    the remaining (per-item) axes. None = one global max.
    """
    db = 10.0 * torch.log10(torch.clamp(x, min=amin))
    if per_item_axes is None:
        floor = db.amax() - top_db
    else:
        dims = tuple(range(per_item_axes, db.ndim))
        floor = db.amax(dim=dims, keepdim=True) - top_db
    return torch.maximum(db, floor)


def log_mel_batch(audio: torch.Tensor, batch_dims: int = 1) -> torch.Tensor:
    """Plain version of the whole front end for fixed-length wavs.

    audio: (*batch, L) -> normalized log-mel (*batch, 64, 1 + L // 441).
    """
    db = amplitude_to_db(mel_spectrogram(audio), per_item_axes=batch_dims)
    return (db - SPEC_MEAN) / SPEC_STD


def log_mel(audio: torch.Tensor, batch_dims: int = 1) -> torch.Tensor:
    """Serving front end: (*batch, L) -> (*batch, 64, T), one wav per row of
    the flattened batch. CUDA tensors go to the CUDA kernel, CPU tensors to
    ``log_mel_batch``."""
    from jmt_tpu_torch.ops.kernels.melspec import log_mel_spec
    lead = audio.shape[:-1]
    if len(lead) != batch_dims:
        raise ValueError(f"log_mel: {tuple(audio.shape)} does not have "
                         f"{batch_dims} batch dims before the samples")
    out = log_mel_spec(audio.reshape(-1, audio.shape[-1]))
    return out.reshape(*lead, *out.shape[1:])
