"""Post-LN transformer encoder matching the reference's hand-rolled layer.

Counterpart of ``jmt_tpu/models/encoder.py``::

    x = LayerNorm1(x + MHA(x, x, x))
    x = LayerNorm2(x + Linear(ReLU(Linear(x))))

No dropout, batch-first. Keys: ``layers.{i}.attention``,
``layers.{i}.feed_forward.{0,2}``, ``layers.{i}.layer_norm{1,2}``.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from jmt_tpu_torch.models.common import LayerNorm, Linear
from jmt_tpu_torch.ops.attention import MultiheadAttention


class TransformerEncoderLayer(nn.Module):
    def __init__(self, input_dim: int, num_heads: int, hidden_dim: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.attention = MultiheadAttention(input_dim, num_heads, dtype=dtype)
        self.feed_forward = nn.Sequential(
            Linear(input_dim, hidden_dim, dtype=dtype), nn.ReLU(),
            Linear(hidden_dim, input_dim, dtype=dtype))
        self.layer_norm1 = LayerNorm(input_dim, dtype=dtype)
        self.layer_norm2 = LayerNorm(input_dim, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.layer_norm1(x + self.attention(x, x, x))
        return self.layer_norm2(x + self.feed_forward(x))


class TransformerEncoderBlock(nn.Module):
    def __init__(self, input_dim: int, num_heads: int, hidden_dim: int,
                 num_layers: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.layers = nn.ModuleList(
            TransformerEncoderLayer(input_dim, num_heads, hidden_dim,
                                    dtype=dtype)
            for _ in range(num_layers))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x)
        return x
