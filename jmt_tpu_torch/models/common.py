"""Shared building blocks with torch-default numerics.

Counterpart of ``jmt_tpu/models/common.py``. Parameters are kept in fp32 and
cast at use to the module's compute ``dtype`` (None = no cast), so one
module serves the fp32 CPU tests and the bf16 card runs. State-dict keys
follow the reference torch modules (``weight``, ``bias``).
"""
from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def cast(x: Optional[torch.Tensor], dtype: Optional[torch.dtype]
         ) -> Optional[torch.Tensor]:
    return x if x is None or dtype is None else x.to(dtype)


def pad_channels(t: torch.Tensor, dim: int, size: int,
                 value: float = 0.0) -> torch.Tensor:
    """``t`` with ``value`` appended along ``dim`` up to ``size`` entries
    (``t`` itself when it has as many)."""
    extra = size - t.shape[dim]
    if extra <= 0:
        return t
    return F.pad(t, [0, 0] * (t.ndim - 1 - dim) + [0, extra], value=value)


class Linear(nn.Module):
    """nn.Linear equivalent, weight (out, in), cast at use to ``dtype``
    (its output features split over devices under
    ``parallel/tp.tensor_parallel``)."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = (nn.Parameter(torch.empty(out_features)) if bias
                     else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        from jmt_tpu_torch.parallel.tp import linear
        return linear(cast(x, self.dtype), cast(self.weight, self.dtype),
                      cast(self.bias, self.dtype))


class LayerNorm(nn.Module):
    """nn.LayerNorm equivalent (eps=1e-5, affine). Computed in fp32, cast
    back to the compute dtype."""

    def __init__(self, dim: int, dtype: Optional[torch.dtype] = None,
                 eps: float = 1e-5):
        super().__init__()
        self.dtype = dtype
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), self.weight.shape, self.weight,
                         self.bias, self.eps)
        return y.to(self.dtype) if self.dtype is not None else y


def _recompute_contexts():
    from jmt_tpu_torch.ops.norm import recomputing
    return contextlib.nullcontext(), recomputing()


def remat(unit: nn.Module, *args, **kwargs):
    """``unit(*args, **kwargs)``, rematerialized when a gradient flows
    into its parameters: ``torch.utils.checkpoint`` (non-reentrant) keeps
    no activation of it for the backward and runs it again there, with
    the RNG states replayed (the same dropout masks) and BN's buffers left
    alone (``ops/norm.recomputing``). A frozen unit, or any unit under
    ``no_grad`` / ``inference_mode``, runs as it is. The counterpart of
    JAX's ``nn.remat``, which changes no number either."""
    if torch.is_grad_enabled() and any(p.requires_grad
                                       for p in unit.parameters()):
        return checkpoint(unit, *args, use_reentrant=False,
                          context_fn=_recompute_contexts, **kwargs)
    return unit(*args, **kwargs)


def l2_normalize(x: torch.Tensor, dim: int = -1,
                 eps: float = 1e-12) -> torch.Tensor:
    """torch F.normalize(p=2): x / max(||x||, eps), the norm in fp32."""
    norm = torch.sqrt(torch.sum(x.float() ** 2, dim=dim, keepdim=True))
    return x / torch.clamp(norm, min=eps).to(x.dtype)


@torch.no_grad()
def init_parameters(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fill every parameter with the torch-default initializers the JAX
    package mirrors (``jmt_tpu/ops/initializers.py``), drawing from
    ``generator``:

    * Linear: weight and bias ~ U(+-1/sqrt(fan_in));
    * conv: kaiming_normal(fan_out, relu), a bias ~ U(+-1/sqrt(fan_in));
    * the TCN's weight-normed conv: v xavier_uniform(gain sqrt 2), g the
      row norms of a U(+-1/sqrt(fan_in)) weight, bias ~ U(+-1/sqrt(fan_in));
    * LayerNorm and BatchNorm: ones / zeros, running stats 0 / 1;
    * MultiheadAttention: xavier_uniform packed in-proj, zero in- and
      out-proj biases (the out-proj weight keeps the Linear default).
    """
    from jmt_tpu_torch.ops.attention import MultiheadAttention
    from jmt_tpu_torch.ops.conv import WeightNormConv1d
    from jmt_tpu_torch.ops.norm import TorchBatchNorm
    for mod in model.modules():
        if isinstance(mod, Linear):
            bound = 1.0 / math.sqrt(mod.weight.shape[1])
            nn.init.uniform_(mod.weight, -bound, bound, generator=generator)
            if mod.bias is not None:
                nn.init.uniform_(mod.bias, -bound, bound, generator=generator)
        elif isinstance(mod, ConvNd):
            nn.init.kaiming_normal_(mod.weight, mode="fan_out",
                                    nonlinearity="relu", generator=generator)
            if mod.bias is not None:
                bound = 1.0 / math.sqrt(mod.weight[0].numel())
                nn.init.uniform_(mod.bias, -bound, bound, generator=generator)
        elif isinstance(mod, WeightNormConv1d):
            # the reference re-inits v (xavier, gain sqrt 2) after wrapping;
            # g keeps the row norms of the conv's default weight
            fan_in = mod.weight_v[0].numel()
            bound = 1.0 / math.sqrt(fan_in)
            nn.init.xavier_uniform_(mod.weight_v, gain=math.sqrt(2.0),
                                    generator=generator)
            w0 = torch.empty_like(mod.weight_v).uniform_(
                -bound, bound, generator=generator)
            mod.weight_g.copy_(w0.norm(dim=(1, 2), keepdim=True))
            nn.init.uniform_(mod.bias, -bound, bound, generator=generator)
        elif isinstance(mod, LayerNorm):
            nn.init.ones_(mod.weight)
            nn.init.zeros_(mod.bias)
        elif isinstance(mod, TorchBatchNorm):
            mod.reset_parameters()
    for mod in model.modules():
        if isinstance(mod, MultiheadAttention):
            nn.init.xavier_uniform_(mod.in_proj_weight, generator=generator)
            nn.init.zeros_(mod.in_proj_bias)
            nn.init.zeros_(mod.out_proj.bias)
    return model


class ConvNd(nn.Module):
    """Conv (1-, 2- or 3-D by kernel rank), weight (O, I, *k) as in torch,
    bias-free unless ``bias``, cast at use to ``dtype``, run by
    ``ops/conv.conv_nd`` (int8 under an int8 context; channels aligned as
    it says). A bias is added after the conv, in ``dtype``, as the JAX
    modules add theirs."""

    def __init__(self, in_ch: int, out_ch: int, kernel, stride=1, padding=0,
                 dtype: Optional[torch.dtype] = None, bias: bool = False):
        super().__init__()
        kernel = tuple(kernel)
        self.dtype = dtype
        self.stride = stride
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, *kernel))
        self.bias = nn.Parameter(torch.empty(out_ch)) if bias else None
        pad = (padding,) * len(kernel) if isinstance(padding, int) \
            else tuple(padding)
        self.pads = tuple((p, p) for p in pad)

    def forward(self, x: torch.Tensor, width: Optional[int] = None
                ) -> torch.Tensor:
        """width: output channels to compute, those past the weight's
        zero (``conv_nd``'s)."""
        from jmt_tpu_torch.ops.conv import conv_nd  # ops.conv imports cast
        y = conv_nd(cast(x, self.dtype), cast(self.weight, self.dtype),
                    self.stride, self.pads, width=width)
        if self.bias is None:
            return y
        return y + cast(self.bias, self.dtype).view(-1, *[1] * (y.ndim - 2))
