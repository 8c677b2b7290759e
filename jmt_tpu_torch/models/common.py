"""Shared building blocks with torch-default numerics.

Counterpart of ``jmt_tpu/models/common.py``. Parameters are kept in fp32 and
cast at use to the module's compute ``dtype`` (None = no cast), so one
module serves the fp32 CPU tests and the bf16 card runs. State-dict keys
follow the reference torch modules (``weight``, ``bias``).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F


def cast(x: Optional[torch.Tensor], dtype: Optional[torch.dtype]
         ) -> Optional[torch.Tensor]:
    return x if x is None or dtype is None else x.to(dtype)


class Linear(nn.Module):
    """nn.Linear equivalent, weight (out, in), cast at use to ``dtype``."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = (nn.Parameter(torch.empty(out_features)) if bias
                     else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(cast(x, self.dtype), cast(self.weight, self.dtype),
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
    * conv: kaiming_normal(fan_out, relu);
    * LayerNorm and BatchNorm: ones / zeros, running stats 0 / 1;
    * MultiheadAttention: xavier_uniform packed in-proj, zero in- and
      out-proj biases (the out-proj weight keeps the Linear default).
    """
    from jmt_tpu_torch.ops.attention import MultiheadAttention
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
    """Bias-free conv (2-D or 3-D by kernel rank), weight (O, I, *k) as in
    torch, cast at use to ``dtype``."""

    def __init__(self, in_ch: int, out_ch: int, kernel, stride=1, padding=0,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        kernel = tuple(kernel)
        self.dtype = dtype
        self.stride = stride
        self.padding = padding
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, *kernel))
        self._conv = {2: F.conv2d, 3: F.conv3d}[len(kernel)]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv(cast(x, self.dtype), cast(self.weight, self.dtype),
                          None, self.stride, self.padding)
