"""Intra-modality fusion of two backbone feature streams.

Counterpart of ``jmt_tpu/models/intra_modal.py``:

* ``FcLayer`` — Linear(in -> 512), used by 'feat_concat_fc' (concat of the
  two streams) and for a lone wavLM stream (768 -> 512). Key ``fc_layer``.
* ``IntraModalTransformerFusion`` ('encoder_plus_self_attention') — stack
  the two per-timestep features as a 2-token sequence, run a post-LN
  encoder and an MHA over the tokens, keep token -1. A shared
  Linear(768 -> 512) ``fc`` is applied to whichever input is 768-d (wavLM).
  Keys ``final_visual_encoder``, ``final_self_attention``, ``fc``.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from jmt_tpu_torch.models.common import Linear
from jmt_tpu_torch.models.encoder import TransformerEncoderBlock
from jmt_tpu_torch.ops.attention import MultiheadAttention


class FcLayer(nn.Module):
    def __init__(self, input_dim: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.fc_layer = Linear(input_dim, 512, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc_layer(x)


class IntraModalTransformerFusion(nn.Module):
    def __init__(self, num_heads: int = 1, num_layers: int = 1,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.final_visual_encoder = TransformerEncoderBlock(
            512, num_heads, 512, num_layers, dtype=dtype)
        self.final_self_attention = MultiheadAttention(512, num_heads,
                                                       dtype=dtype)
        self.fc = Linear(768, 512, dtype=dtype)  # 768 -> 512 reducer

    def forward(self, features_a: torch.Tensor,
                features_b: torch.Tensor) -> torch.Tensor:
        """features_*: (B, L, 512 or 768). Returns (B, L, 512)."""
        if features_a.shape[-1] == 768:
            features_a = self.fc(features_a)
        if features_b.shape[-1] == 768:
            features_b = self.fc(features_b)
        stack = torch.stack([features_a, features_b], dim=2)  # (B, L, 2, E)
        b, l, k, e = stack.shape
        enc = self.final_visual_encoder(stack.reshape(b * l, k, e))
        attn = self.final_self_attention(enc, enc, enc)
        return attn.reshape(b, l, k, e)[:, :, -1, :]
