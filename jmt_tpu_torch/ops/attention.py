"""Multi-head attention with torch ``nn.MultiheadAttention`` numerics.

Counterpart of ``jmt_tpu/ops/attention.py``: packed QKV in-projection with
bias, q scaled by head_dim**-0.5 in the compute dtype AFTER projection, no
dropout, no masks, batch-first (B, L, E). State-dict keys are the reference
module's: ``in_proj_weight`` (3E, E), ``in_proj_bias``, ``out_proj.weight``,
``out_proj.bias``.

The attention core runs the CUDA kernel of ``ops/kernels/fused_attention.py``
on CUDA tensors and its plain version on CPU tensors. Its backward is the
plain torch formula, as in the JAX package (``_attention_bwd``): the TPU
kernel had no backward either.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from jmt_tpu_torch.models.common import Linear, cast
from jmt_tpu_torch.ops.kernels.fused_attention import (attention_plain,
                                                       fused_attention)


class _AttentionCore(torch.autograd.Function):
    """(BH, L, D) core: the kernel forward, the plain formula's backward."""

    @staticmethod
    def forward(ctx, q_scaled, k, v):
        ctx.save_for_backward(q_scaled, k, v)
        return fused_attention(q_scaled, k, v)

    @staticmethod
    def backward(ctx, g):
        with torch.enable_grad():
            leaves = [x.detach().requires_grad_() for x in ctx.saved_tensors]
            out = attention_plain(*leaves)
            return torch.autograd.grad(out, leaves, g)


def attention_core(q_scaled: torch.Tensor, k: torch.Tensor,
                   v: torch.Tensor) -> torch.Tensor:
    """softmax(q kᵀ) v over (B, L, H, hd) inputs, q pre-scaled by
    hd**-0.5 -> (B, Lq, H, hd). The heads fold into the kernel's BH axis."""
    b, lq, h, hd = q_scaled.shape
    lk = k.shape[1]

    def to_bh(x, length):
        return x.transpose(1, 2).reshape(b * h, length, hd).contiguous()

    out = _AttentionCore.apply(to_bh(q_scaled, lq), to_bh(k, lk),
                               to_bh(v, lk))
    return out.reshape(b, h, lq, hd).transpose(1, 2)


def multi_head_attention(q_in: torch.Tensor, k_in: torch.Tensor,
                         v_in: torch.Tensor,
                         in_proj_weight: torch.Tensor,
                         in_proj_bias: torch.Tensor,
                         out_proj_weight: torch.Tensor,
                         out_proj_bias: torch.Tensor,
                         num_heads: int,
                         dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Functional core, batch-first (B, L, E), torch weight layout."""
    embed_dim = q_in.shape[-1]
    head_dim = embed_dim // num_heads
    if head_dim * num_heads != embed_dim:
        raise ValueError(f"embed_dim {embed_dim} is not divisible by "
                         f"num_heads {num_heads}")
    wq, wk, wv = (cast(w, dtype) for w in in_proj_weight.chunk(3, dim=0))
    bq, bk, bv = (cast(b, dtype) for b in in_proj_bias.chunk(3))
    q = F.linear(cast(q_in, dtype), wq, bq)  # (B, Lq, E)
    k = F.linear(cast(k_in, dtype), wk, bk)  # (B, Lk, E)
    v = F.linear(cast(v_in, dtype), wv, bv)

    b, lq, _ = q.shape
    lk = k.shape[1]
    # the scale in the compute dtype, as the JAX package's weak-typed
    # python scalar is: round(q * dtype(scale))
    scale = float(torch.tensor(head_dim ** -0.5, dtype=q.dtype))
    q = q.reshape(b, lq, num_heads, head_dim) * scale
    k = k.reshape(b, lk, num_heads, head_dim)
    v = v.reshape(b, lk, num_heads, head_dim)

    out = attention_core(q, k, v).reshape(b, lq, embed_dim)
    return F.linear(cast(out, dtype), cast(out_proj_weight, dtype),
                    cast(out_proj_bias, dtype))


class MultiheadAttention(nn.Module):
    """torch-parity MHA, batch-first (B, L, E)."""

    def __init__(self, embed_dim: int, num_heads: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.num_heads = num_heads
        self.dtype = dtype
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dim,
                                                       embed_dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * embed_dim))
        self.out_proj = Linear(embed_dim, embed_dim, dtype=dtype)

    def forward(self, query: torch.Tensor, key: torch.Tensor,
                value: torch.Tensor) -> torch.Tensor:
        return multi_head_attention(query, key, value, self.in_proj_weight,
                                    self.in_proj_bias, self.out_proj.weight,
                                    self.out_proj.bias, self.num_heads,
                                    dtype=self.dtype)
