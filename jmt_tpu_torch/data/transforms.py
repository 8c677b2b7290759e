"""Device-side clip preprocessing: colour augmentation and normalize.

Counterpart of ``jmt_tpu/data/transforms.py`` ``sample_color_factors`` and
``preprocess_clips``: uint8 in; with ``augment=True`` first the per-clip
brightness (multiply, clamp to [0, 255]) and contrast (blend with the mean
of the clip's luma over all its frames, clamp), the reference's
RandomColorAugment applied alike to a clip's frames; then / 255 and the
per-channel normalize with the reference's mean and std. Layout stays
channels-last (N, T, H, W, 3), the JAX package's layout; the backbones
convert to NCTHW.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

VIS_MEAN = np.array([0.43216, 0.394666, 0.37645], np.float32)
VIS_STD = np.array([0.22803, 0.22145, 0.216989], np.float32)
# ITU-R 601-2 luma weights (PIL's 'L' conversion, which contrast uses)
_LUMA = np.array([0.299, 0.587, 0.114], np.float32)


def sample_color_factors(generator: Optional[torch.Generator],
                         n_clips: int, brightness: float = 0.2,
                         contrast: float = 0.2, device=None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-clip brightness and contrast factors ~ U(1 - b, 1 + b), drawn
    from ``generator`` on its device (torch's default generator of
    ``device`` when None)."""
    if generator is not None:
        device = generator.device

    def uniform(width):
        lo = max(0.0, 1 - width)
        u = torch.rand(n_clips, generator=generator, device=device)
        return lo + u * (1 + width - lo)

    bf = uniform(brightness)
    return bf, uniform(contrast)


@functools.lru_cache(maxsize=8)
def _constants(device: torch.device) -> Tuple[torch.Tensor, ...]:
    """Mean, std and luma weights on ``device``, copied there once, so
    that a forward makes no host-to-device copy (a CUDA graph captures
    it)."""
    with torch.inference_mode(False):
        return tuple(torch.from_numpy(a).to(device)
                     for a in (VIS_MEAN, VIS_STD, _LUMA))


def preprocess_clips(clips_u8: torch.Tensor,
                     brightness: Optional[torch.Tensor] = None,
                     contrast: Optional[torch.Tensor] = None,
                     augment: bool = False) -> torch.Tensor:
    """clips_u8: (..., 3) uint8 -> normalized float32 of the same shape.

    With ``augment``: clips (N, T, H, W, 3) and the (N,) factors of
    ``sample_color_factors``."""
    if clips_u8.dtype != torch.uint8:
        raise TypeError(f"preprocess_clips takes uint8, got {clips_u8.dtype}")
    dev = clips_u8.device
    mean, std, luma_weights = _constants(dev)
    x = clips_u8.float()
    if augment:
        if brightness is None or contrast is None:
            raise ValueError("augment=True takes brightness and contrast "
                             "factors (sample_color_factors)")
        if clips_u8.ndim != 5:
            raise ValueError(f"augment=True takes clips (N, T, H, W, 3), "
                             f"got {tuple(clips_u8.shape)}")
        shape = (-1, 1, 1, 1, 1)
        x = torch.clamp(x * brightness.to(dev).view(shape), 0.0, 255.0)
        gray = torch.einsum("nthwc,c->nthw", x, luma_weights)
        luma = torch.mean(gray, dim=(1, 2, 3)).view(shape)
        c = contrast.to(dev).view(shape)
        x = torch.clamp(c * x + (1.0 - c) * luma, 0.0, 255.0)
    return (x / 255.0 - mean) / std
