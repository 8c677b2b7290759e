"""BatchNorm with torch semantics, eval mode (running statistics).

Counterpart of ``jmt_tpu/ops/norm.py`` ``TorchBatchNorm`` with
``use_running_average=True``: normalize with the running mean and variance
in fp32, apply the affine scale and bias, cast to the compute dtype. The
state-dict keys are torch BatchNorm's (``weight``, ``bias``,
``running_mean``, ``running_var``, ``num_batches_tracked``). Train-mode
batch statistics are not part of the serving path.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F


class TorchBatchNorm(nn.Module):
    """Channel axis 1 (NC..., torch layout)."""

    def __init__(self, features: int, eps: float = 1e-5,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.register_buffer("num_batches_tracked",
                             torch.zeros((), dtype=torch.long))

    @torch.no_grad()
    def reset_parameters(self) -> None:
        self.weight.fill_(1.0)
        self.bias.zero_()
        self.running_mean.zero_()
        self.running_var.fill_(1.0)
        self.num_batches_tracked.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.batch_norm(x.float(), self.running_mean, self.running_var,
                         self.weight, self.bias, training=False, eps=self.eps)
        return y.to(self.dtype) if self.dtype is not None else y
