"""Fusion top level and valence/arousal heads.

Counterpart of ``jmt_tpu/models/fusion.py``:

* ``Regressor`` — Linear(512 -> 128) -> ReLU -> Dropout -> Linear(128 -> 1);
  keys ``0`` and ``3`` as the reference's nn.Sequential. Eval only, so the
  dropout slot is an identity.
* ``TwoTransformers`` — L2-normalize both 512-d streams, run the joint
  multimodal transformer, then the two regressors. Called in the reference
  order ``(audio, video)``. This is ``joint_modalities='TRANSFORMER'``
  with the SELF_ATTEN head, the one combination ported.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

from jmt_tpu_torch.models.common import Linear, l2_normalize
from jmt_tpu_torch.models.jmt import JointMultimodalTransformer


class Regressor(nn.Sequential):
    def __init__(self, dtype: Optional[torch.dtype] = None):
        super().__init__(Linear(512, 128, dtype=dtype), nn.ReLU(),
                         nn.Identity(), Linear(128, 1, dtype=dtype))


class TwoTransformers(nn.Module):
    def __init__(self, num_heads: int = 1, num_layers: int = 1,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.mm_transformer = JointMultimodalTransformer(
            num_heads=num_heads, num_layers=num_layers, dtype=dtype)
        self.vregressor = Regressor(dtype=dtype)
        self.aregressor = Regressor(dtype=dtype)

    def forward(self, f1_audio: torch.Tensor, f2_video: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(audio_feats, visual_feats), each (B, L, 512) -> (vouts, aouts),
        each (B, L)."""
        video = l2_normalize(f2_video, dim=-1)
        audio = l2_normalize(f1_audio, dim=-1)
        features = self.mm_transformer(video, audio)
        return (self.vregressor(features)[..., 0],
                self.aregressor(features)[..., 0])
