"""Device-side clip preprocessing (normalize, no augmentation).

Counterpart of ``jmt_tpu/data/transforms.py`` ``preprocess_clips`` with
``augment=False``: uint8 / 255, then per-channel normalize with the
reference's mean and std. Layout stays channels-last (N, T, H, W, 3), the
JAX package's layout; the backbone converts to NCTHW. The colour
augmentation belongs to training and is not ported yet.
"""
from __future__ import annotations

import numpy as np
import torch

VIS_MEAN = np.array([0.43216, 0.394666, 0.37645], np.float32)
VIS_STD = np.array([0.22803, 0.22145, 0.216989], np.float32)


def preprocess_clips(clips_u8: torch.Tensor) -> torch.Tensor:
    """clips_u8: (..., 3) uint8 -> normalized float32 of the same shape."""
    if clips_u8.dtype != torch.uint8:
        raise TypeError(f"preprocess_clips takes uint8, got {clips_u8.dtype}")
    mean = torch.from_numpy(VIS_MEAN).to(clips_u8.device)
    std = torch.from_numpy(VIS_STD).to(clips_u8.device)
    return (clips_u8.float() / 255.0 - mean) / std
