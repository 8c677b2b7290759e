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

Under ``global_batch_statistics()`` (the train step of a process group,
``train/loops.make_train_step``) a train-mode BN takes the statistics of
the global batch, every rank's rows, as JAX's do under GSPMD: each rank's
count, mean and sum of squared deviations are gathered
(``parallel.mesh.all_gather_rows``, differentiable, so the backward
reduces across ranks as well) and merged (Chan et al.); the running
variance takes the unbiased factor of the global count N. Pad rows
count, as in JAX. The recompute of a rematerialized unit gathers again,
in the same order on every rank.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Iterator, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from jmt_tpu_torch.models.common import pad_channels

_RECOMPUTE = threading.local()
# process-wide, not per thread: the backward, and a remat recompute in it,
# runs on autograd's threads
_GLOBAL_STATS = {"on": False}


@contextlib.contextmanager
def global_batch_statistics(on: bool = True) -> Iterator[None]:
    """Train-mode BN within normalizes with the statistics of the global
    batch over the ranks of the process group."""
    prev = _GLOBAL_STATS["on"]
    _GLOBAL_STATS["on"] = on
    try:
        yield
    finally:
        _GLOBAL_STATS["on"] = prev


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

    def _global_forward(self, x: torch.Tensor) -> torch.Tensor:
        """Train mode over the global batch (``global_batch_statistics``)."""
        from jmt_tpu_torch.parallel.mesh import all_gather_rows
        x32 = x.float()
        c = x32.shape[1]
        dims = [0] + list(range(2, x32.ndim))
        shape = (1, c) + (1,) * (x32.ndim - 2)
        mean_l = x32.mean(dims)
        m2_l = ((x32 - mean_l.view(shape)) ** 2).sum(dims)
        n_l = torch.full((1,), float(x32.numel() // c), device=x32.device)
        stats = all_gather_rows(torch.cat([mean_l, m2_l, n_l])[None])
        means, m2s, ns = stats[:, :c], stats[:, c:2 * c], stats[:, 2 * c:]
        n = ns.sum()
        mean = (ns * means).sum(0) / n
        var = (m2s + ns * (means - mean) ** 2).sum(0) / n      # biased
        if not getattr(_RECOMPUTE, "on", False):
            m = self.momentum
            with torch.no_grad():
                self.running_mean.mul_(1 - m).add_(m * mean)
                self.running_var.mul_(1 - m).add_(
                    m * var * (n / torch.clamp(n - 1, min=1)))
                self.num_batches_tracked.add_(1)
        y = (x32 - mean.view(shape)) / torch.sqrt(var.view(shape) + self.eps)
        y = y * self.weight.view(shape) + self.bias.view(shape)
        return y.to(self.dtype) if self.dtype is not None else y

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x of this BN's channels, or in eval mode of more: an aligned
        conv's zero channels past them (``ops/conv.py``'s note), which
        take weight 0, bias 0, mean 0 and variance 1 and stay zero."""
        if self.training and _GLOBAL_STATS["on"]:
            return self._global_forward(x)
        mean, var = self.running_mean, self.running_var
        weight, bias = self.weight, self.bias
        width = x.shape[1]
        if width != weight.shape[0]:
            if self.training:
                raise ValueError(
                    f"BN of {weight.shape[0]} channels in train mode got "
                    f"{width}: only running statistics take aligned "
                    f"channels")
            mean, var = (pad_channels(mean, 0, width),
                         pad_channels(var, 0, width, 1.0))
            weight, bias = (pad_channels(weight, 0, width),
                            pad_channels(bias, 0, width))
        elif self.training and getattr(_RECOMPUTE, "on", False):
            # the same call on scratch buffers: the same batch statistics
            # and kernel as the first forward, no update
            mean, var = mean.clone(), var.clone()
        elif self.training:
            self.num_batches_tracked.add_(1)
        y = F.batch_norm(x.float(), mean, var, weight, bias,
                         training=self.training, momentum=self.momentum,
                         eps=self.eps)
        return y.to(self.dtype) if self.dtype is not None else y
