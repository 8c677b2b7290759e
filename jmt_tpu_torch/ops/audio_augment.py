"""The heavy audio augmentation (``use_more_audio_data_augm``), on the
device.

Counterpart of ``jmt_tpu/ops/audio_augment.py``: complex STFT -> random
time stretch by phase vocoder (p 0.6, rate 1.2 or 0.9 with equal odds) ->
magnitude -> random time masking (p 0.6, width U[0, 80)) -> mel scale ->
random frequency masking (p 0.6). The reference's quirks are kept, as the
JAX package keeps them: the mel scale takes the MAGNITUDE, not the power,
and there is no dB and no normalize after it.

Every augmented spectrogram lives in a fixed (64, ``AUG_FRAMES`` = 128)
buffer, its content right-aligned after zeros (the reference's collate
pads that way); rate 1.0 is the identity. Split in two, as the vision
augmentation: ``sample_audio_augment`` draws the parameters from a
``torch.Generator`` with JAX's distributions, ``more_audio_augment``
applies given ones. Plain PyTorch: JAX computes all of it in XLA, with no
Pallas kernel.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from jmt_tpu_torch.ops.mel import (HOP_LENGTH, N_FFT, N_MELS, _frame,
                                   _padded_hann, mel_filterbank)

N_FREQS = N_FFT // 2 + 1
AUG_FRAMES = 128  # >= ceil(104 / 0.9) = 116
MASK_PARAM = 80   # the masks' widths ~ U[0, 80)
MASK_P = 0.6
STRETCH_P = 0.6


class AudioAugment(NamedTuple):
    """Per-wav (N,) parameters of ``more_audio_augment``: the stretch
    ``rate`` (1.0, 1.2 or 0.9); each mask's ``*_width`` and ``*_start``
    (int64, frames of the 128-frame buffer or mel bins) and whether it
    applies (``*_on``, bool)."""
    rate: torch.Tensor
    time_width: torch.Tensor
    time_start: torch.Tensor
    time_on: torch.Tensor
    freq_width: torch.Tensor
    freq_start: torch.Tensor
    freq_on: torch.Tensor

    def to(self, device) -> "AudioAugment":
        return AudioAugment(*(t.to(device) for t in self))


def sample_audio_augment(generator: Optional[torch.Generator], n: int,
                         device=None) -> AudioAugment:
    """Each wav's parameters, JAX's distributions: stretch with p 0.6, to
    rate 1.2 or 0.9 with p 0.5 each; per mask (time over the 128 frames,
    frequency over the 64 mel bins) a width floor(min(U * 80, dim)), a
    start floor(U * (dim - width + 1)) and p 0.6 to apply. Drawn from
    ``generator`` on its device (torch's default generator of ``device``
    when None)."""
    if generator is not None:
        device = generator.device

    def rand():
        return torch.rand(n, generator=generator, device=device)

    do, fast = rand() < STRETCH_P, rand() < 0.5
    one = torch.ones(n, device=device)
    rate = torch.where(do, torch.where(fast, 1.2 * one, 0.9 * one), one)
    masks = []
    for dim in (AUG_FRAMES, N_MELS):
        width = torch.clamp(rand() * MASK_PARAM, max=dim).long()
        start = (rand() * (dim - width + 1)).long()
        masks += [width, start, rand() < MASK_P]
    return AudioAugment(rate, *masks)


def complex_stft(audio: torch.Tensor) -> torch.Tensor:
    """(N, L) -> complex (N, T = 1 + L // 441, 513): the log-mel front
    end's framing and window (``ops/mel``), one-sided."""
    frames = _frame(audio.float(), N_FFT, HOP_LENGTH)
    window = torch.from_numpy(np.array(_padded_hann())).to(audio.device)
    return torch.fft.rfft(frames * window, dim=-1)


def _read_positions(t: int, rate: torch.Tensor, out_frames: int):
    """(idx0, idx1, frac, valid_len) of each output frame: output frame
    t' reads input position t' * rate, linearly between idx0 and idx1;
    frames from ceil(t / rate) on are invalid."""
    steps = torch.arange(out_frames, dtype=torch.float32,
                         device=rate.device)
    pos = steps[None, :] * rate.float()[:, None]          # (N, T')
    idx0 = torch.clamp(torch.floor(pos).long(), 0, t - 1)
    idx1 = torch.clamp(idx0 + 1, 0, t - 1)
    frac = torch.clamp(pos - idx0, 0.0, 1.0)
    valid_len = torch.ceil(t / rate.float()).long()       # (N,)
    return idx0, idx1, frac, valid_len


def _take(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """arr (N, T, F), idx (N, T') -> (N, T', F)."""
    return torch.gather(arr, 1, idx[..., None].expand(-1, -1, arr.shape[2]))


def _valid(valid_len: torch.Tensor, out_frames: int) -> torch.Tensor:
    steps = torch.arange(out_frames, device=valid_len.device)
    return (steps[None, :] < valid_len[:, None])[..., None]   # (N, T', 1)


def phase_vocoder(spec: torch.Tensor, rate: torch.Tensor,
                  out_frames: int = AUG_FRAMES
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """torchaudio-style phase vocoder. spec: complex (N, T, F); rate (N,).
    Returns (complex (N, out_frames, F), valid_len (N,)): output frame t'
    of wav n holds the magnitude interpolated at t' * rate[n] and the
    phase advanced frame by frame, and is zero from valid_len[n] =
    ceil(T / rate[n]) on."""
    n, t, f = spec.shape
    phi_adv = torch.from_numpy(np.linspace(
        0, np.pi * HOP_LENGTH, f, dtype=np.float32)).to(spec.device)
    mag, phase = spec.abs(), torch.angle(spec)
    idx0, idx1, frac, valid_len = _read_positions(t, rate, out_frames)
    out_mag = (1 - frac)[..., None] * _take(mag, idx0) \
        + frac[..., None] * _take(mag, idx1)
    ph0, ph1 = _take(phase, idx0), _take(phase, idx1)
    dphi = ph1 - ph0 - phi_adv
    dphi = dphi - 2 * np.pi * torch.round(dphi / (2 * np.pi))
    step_phase = dphi + phi_adv                           # (N, T', F)
    # phase[t'] = phase0[0] + the sum of step_phase[s] for s < t', added
    # in order in float32 as JAX's scan adds them (torch.cumsum on the CPU
    # accumulates in float64)
    acc = torch.zeros(n, f, device=spec.device)
    prefix = []
    for s in range(out_frames):
        prefix.append(acc)
        acc = acc + step_phase[:, s]
    out_phase = ph0[:, 0:1, :] + torch.stack(prefix, dim=1)
    out = torch.polar(out_mag, out_phase)
    return torch.where(_valid(valid_len, out_frames), out, 0), valid_len


def _mask(width: torch.Tensor, start: torch.Tensor, on: torch.Tensor,
          dim: int) -> torch.Tensor:
    """(N, dim) multiplicative mask: 0 on [start, start + width) where
    ``on``, else 1."""
    pos = torch.arange(dim, device=width.device)[None, :]
    masked = (pos >= start[:, None]) & (pos < (start + width)[:, None])
    return torch.where(on[:, None] & masked, 0.0, 1.0)


def more_audio_augment(audio: torch.Tensor,
                       params: AudioAugment) -> torch.Tensor:
    """audio (N, L) and the (N,) ``params`` -> augmented mel magnitudes
    (N, 64, AUG_FRAMES), content right-aligned.

    The magnitude is taken right after the vocoder, so the vocoder's
    phase never reaches the output: this computes the interpolated
    magnitude alone (``phase_vocoder``'s ``out_mag``), which equals
    |out_mag e^(i phase)| to a rounding."""
    p = params.to(audio.device)
    mag = complex_stft(audio).abs()                       # (N, T, 513)
    idx0, idx1, frac, valid_len = _read_positions(mag.shape[1], p.rate,
                                                  AUG_FRAMES)
    mag = (1 - frac)[..., None] * _take(mag, idx0) \
        + frac[..., None] * _take(mag, idx1)
    mag = torch.where(_valid(valid_len, AUG_FRAMES), mag, 0.0)
    mag = mag * _mask(p.time_width, p.time_start, p.time_on,
                      AUG_FRAMES)[..., None]
    fb = torch.from_numpy(np.array(mel_filterbank())).to(audio.device)
    mel = torch.matmul(mag, fb).transpose(1, 2)           # (N, 64, T')
    mel = mel * _mask(p.freq_width, p.freq_start, p.freq_on,
                      N_MELS)[..., None]
    # right-align: frame valid_len - 1 lands at the buffer's end
    src = torch.arange(AUG_FRAMES, device=audio.device)[None, :] \
        - (AUG_FRAMES - valid_len)[:, None]               # (N, T')
    out = torch.gather(mel, 2, src.clamp(0, AUG_FRAMES - 1)[:, None, :]
                       .expand(-1, N_MELS, -1))
    return torch.where((src >= 0)[:, None, :], out, 0.0)
