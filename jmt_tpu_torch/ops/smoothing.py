"""Prediction post-processing: clip to [-1, 1], then a moving average.

Counterpart of ``jmt_tpu/ops/smoothing.py``: the reference's eval smoothing
is ``np.clip(pred, -1, 1)`` then ``scipy.ndimage.uniform_filter1d`` with
size 20 (valence) and 50 (arousal), ``mode='constant'`` (zero fill).

scipy's window for origin 0: output[i] averages
input[i - size//2 : i + size - size//2], so an even size puts its extra
tap on the LEFT. A cumulative sum over the zero-padded trace gives every
window in O(n). It runs in float32 in the order XLA's CPU cumsum adds (a
sequential prefix within blocks of 16, then the same over the block
totals) and divides as XLA does (a product with 1/size), so the traces
equal the JAX package's bit for bit and the challenge files come out
byte-identical; both lie within 7e-7 of scipy's float64 result on 530
frames in [-1, 1] (5e-6 at 4000 frames and size 1).
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

_BLOCK = 16


def _blocked_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive float32 prefix sum of a 1-D tensor, blocked by 16."""
    n = x.shape[0]
    nb = -(-n // _BLOCK)
    rows = F.pad(x, (0, nb * _BLOCK - n)).view(nb, _BLOCK)
    cols = [rows[:, 0]]
    for j in range(1, _BLOCK if nb > 1 else n):
        cols.append(cols[-1] + rows[:, j])
    inner = torch.stack(cols, dim=1)
    if nb == 1:
        return inner[0, :n]
    offsets = F.pad(_blocked_cumsum(inner[:, -1])[:-1], (1, 0))
    return (inner + offsets[:, None]).reshape(-1)[:n]


def uniform_filter1d(x: torch.Tensor, size: int) -> torch.Tensor:
    """scipy.ndimage.uniform_filter1d(x, size, mode='constant', cval=0) on
    a 1-D tensor, in float32."""
    if size < 1:
        raise ValueError(f"size must be >= 1, got {size}")
    left = size // 2
    xp = F.pad(torch.as_tensor(x).to(torch.float32),
               (left, size - 1 - left))
    cs = F.pad(_blocked_cumsum(xp), (1, 0))
    return (cs[size:] - cs[:-size]) * (1.0 / size)


def clip_and_smooth(pred_v: torch.Tensor, pred_a: torch.Tensor,
                    v_size: int = 20, a_size: int = 50
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Clip to [-1, 1], then smooth V and A with their window sizes."""
    v = torch.clamp(torch.as_tensor(pred_v), -1.0, 1.0)
    a = torch.clamp(torch.as_tensor(pred_a), -1.0, 1.0)
    return uniform_filter1d(v, v_size), uniform_filter1d(a, a_size)
