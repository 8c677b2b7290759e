"""The plain PyTorch version of kernel K4: a 3x3x3 stride-1 SAME max pool,
then a 1x1 product (the inception b3 branch without its BN and ReLU).

Counterpart of ``tools/pallas_pool1x1_experiment.py`` ``pool3_1x1``: the
pool pads with -inf (the TPU kernel padded with the dtype's lowest value;
the center of every window is real, so the two agree), then x . k with f32
accumulation, cast to x's dtype. Inputs may have any sign. The kernel
wrapper is ``ops/kernels/pool1x1.py``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def pool3_1x1_plain(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """x (N, C, T, H, W), k (C, Co) -> (N, Co, T, H, W) in x's dtype, in
    channels-last memory."""
    pooled = F.max_pool3d(F.pad(x, (1,) * 6, value=-math.inf), 3, stride=1)
    y = torch.matmul(pooled.permute(0, 2, 3, 4, 1).float(), k.float())
    return y.to(x.dtype).permute(0, 4, 1, 2, 3)
