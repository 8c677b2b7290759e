"""Seeded inputs, made on the device in a few large calls.

A window is ``seq`` timesteps, each an 8-frame RGB clip (uint8), a wav
chunk of ``audio_samples`` samples at 44.1 kHz, and a wavLM feature. The
content is varied so that the backbones' features differ from window to
window, as real faces and voices make them differ (i.i.d. pixel noise
would give every clip nearly the same features):

* each clip is a smooth random pattern (3 x 4 x 4 normal values per
  channel, upsampled over time and space) at a random mean (40-210) and
  contrast (10-70), plus pixel noise of 8 levels;
* each wav chunk is a tone of 100-2000 Hz at a random phase plus half as
  much white noise, at an amplitude of 0.005-0.5;
* each wavLM feature is N(0, 1) times 0.5-2.

Each stream of the run (the requests, the calibration request, the
training batches) has its own generator, seeded from the run's seed.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F


def stream_seed(seed: int, stream: int) -> int:
    return (int(seed) * 1_000_003 + stream) % (2 ** 63)


def windows(n: int, inp: dict, seed: int, stream: int, device
            ) -> Dict[str, torch.Tensor]:
    """``n`` windows: clips (n, seq, T, H, W, 3) uint8, audio (n, seq, L)
    and wavlm (n, seq, 768) float32, on ``device``."""
    g = torch.Generator(device=device).manual_seed(stream_seed(seed, stream))
    seq, t, p = inp["seq"], inp["frames"], inp["size"]
    length, dim = inp["audio_samples"], inp["wavlm_dim"]
    m = n * seq
    kw = dict(generator=g, device=device)

    def rand(*shape):
        return torch.rand(*shape, **kw)

    coarse = torch.randn(m, 3, 3, 4, 4, **kw)
    smooth = F.interpolate(coarse, size=(t, p, p), mode="trilinear",
                           align_corners=False)
    x = (40 + 170 * rand(m, 1, 1, 1, 1) + (10 + 60 * rand(m, 1, 1, 1, 1))
         * smooth + 8 * torch.randn(m, 3, t, p, p, **kw))
    clips = x.clamp(0, 255).round().to(torch.uint8).permute(0, 2, 3, 4, 1)
    clips = clips.reshape(n, seq, t, p, p, 3).contiguous()
    del x, smooth
    time_s = torch.arange(length, device=device, dtype=torch.float32) / 44100
    freq = 100 + 1900 * rand(m, 1)
    phase = 2 * math.pi * rand(m, 1)
    amp = 10 ** (-2.3 + 2 * rand(m, 1))
    audio = amp * (torch.sin(2 * math.pi * freq * time_s + phase)
                   + 0.5 * torch.randn(m, length, **kw))
    wavlm = torch.randn(m, dim, **kw) * (0.5 + 1.5 * rand(m, 1))
    return {"clips": clips, "audio": audio.reshape(n, seq, length),
            "wavlm": wavlm.reshape(n, seq, dim)}


def train_extras(n: int, seq: int, seed: int, stream: int, device
                 ) -> Dict[str, torch.Tensor]:
    """A batch's labels (V, A uniform in [-1, 1]), its row weights (all
    rows real) and the colour augmentation's per-clip brightness and
    contrast factors, U(0.8, 1.2) as the trainer draws them."""
    g = torch.Generator(device=device).manual_seed(stream_seed(seed, stream))
    kw = dict(generator=g, device=device)
    labels = 2 * torch.rand(2, n, seq, **kw) - 1
    factors = 0.8 + 0.4 * torch.rand(2, n * seq, **kw)
    return {"labels_v": labels[0], "labels_a": labels[1],
            "row_weight": torch.ones(n, device=device),
            "brightness": factors[0], "contrast": factors[1]}


def to_host(arrays: Dict[str, torch.Tensor]) -> Dict:
    """The arrays as numpy arrays on the host."""
    return {k: v.cpu().numpy() for k, v in arrays.items()}
