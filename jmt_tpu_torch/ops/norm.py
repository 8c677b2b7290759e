"""BatchNorm with torch semantics.

Counterpart of ``jmt_tpu/ops/norm.py`` ``TorchBatchNorm``, in fp32 whatever
the compute dtype, the output cast to it:

* eval mode (``module.eval()``, the JAX ``use_running_average=True``):
  normalize with the running mean and variance;
* train mode: normalize with the batch mean and the BIASED batch variance,
  and update the running variance with the UNBIASED one, with torch's
  momentum convention ``new = (1 - m) old + m batch`` (0.1 by default;
  I3D's units pass 0.01); ``num_batches_tracked`` counts the updates.

A new module starts in eval mode, as the JAX module's default is the
running statistics; ``model.train()`` switches it. The state-dict keys are
torch BatchNorm's (``weight``, ``bias``, ``running_mean``,
``running_var``, ``num_batches_tracked``).

Under ``recomputing()`` (the recompute of a rematerialized unit, which
runs its forward a second time in the backward) a train-mode BN
normalizes with the same batch statistics but leaves its buffers alone:
the momentum update goes to scratch copies and the count stays, so a
rematerialized step updates them once, as JAX's remat does.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Iterator, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F


_RECOMPUTE = threading.local()


@contextlib.contextmanager
def recomputing() -> Iterator[None]:
    """BN in train mode within leaves its running statistics and count as
    they are (the recompute context of ``models/common.remat``)."""
    prev = getattr(_RECOMPUTE, "on", False)
    _RECOMPUTE.on = True
    try:
        yield
    finally:
        _RECOMPUTE.on = prev


class TorchBatchNorm(nn.Module):
    """Channel axis 1 (NC..., torch layout)."""

    def __init__(self, features: int, eps: float = 1e-5,
                 momentum: float = 0.1, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.register_buffer("num_batches_tracked",
                             torch.zeros((), dtype=torch.long))
        self.train(False)

    @torch.no_grad()
    def reset_parameters(self) -> None:
        self.weight.fill_(1.0)
        self.bias.zero_()
        self.running_mean.zero_()
        self.running_var.fill_(1.0)
        self.num_batches_tracked.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean, var = self.running_mean, self.running_var
        if self.training and getattr(_RECOMPUTE, "on", False):
            # the same call on scratch buffers: the same batch statistics
            # and kernel as the first forward, no update
            mean, var = mean.clone(), var.clone()
        elif self.training:
            self.num_batches_tracked.add_(1)
        y = F.batch_norm(x.float(), mean, var,
                         self.weight, self.bias, training=self.training,
                         momentum=self.momentum, eps=self.eps)
        return y.to(self.dtype) if self.dtype is not None else y
