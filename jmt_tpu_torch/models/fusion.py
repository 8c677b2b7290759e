"""Fusion top level, valence/arousal heads and the pretraining head.

Counterpart of ``jmt_tpu/models/fusion.py``:

* ``Regressor`` — Linear(in -> 128) -> ReLU -> Dropout -> Linear(128 ->
  1 or 2); keys ``0`` and ``3`` as the reference's nn.Sequential, the
  dropout in slot ``2`` (built in eval mode; ``model.train()`` switches
  it).
* ``TwoTransformers`` — L2-normalize both 512-d streams, then dispatch on
  ``joint_modalities``: 'TRANSFORMER' (the joint multimodal transformer
  with the SELF_ATTEN or FC head), 'FC' (``FeatureConcatFC``) or 'NONE'
  (``MultimodalTransformerNoJR``, FC format only); then the two
  regressors, whose input is 1024-d after the FC head and 512-d
  otherwise. Called in the reference order ``(audio, video)``.
* ``SingleBackbonePretrainer`` — ``Regressor(2)`` named ``regressor`` on
  one backbone's features: (vouts, aouts) are its two outputs.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

from jmt_tpu_torch.models.common import Linear, l2_normalize
from jmt_tpu_torch.models.jmt import (OUTPUT_FORMATS, FeatureConcatFC,
                                      JointMultimodalTransformer,
                                      MultimodalTransformerNoJR)

JOINT_MODALITIES = ("NONE", "TRANSFORMER", "FC")


class Regressor(nn.Sequential):
    def __init__(self, dropout: float = 0.0, in_dim: int = 512,
                 out_dim: int = 1, dtype: Optional[torch.dtype] = None):
        super().__init__(Linear(in_dim, 128, dtype=dtype), nn.ReLU(),
                         nn.Dropout(dropout).eval(),
                         Linear(128, out_dim, dtype=dtype))


class TwoTransformers(nn.Module):
    def __init__(self, v_dropout: float = 0.0, a_dropout: float = 0.0,
                 num_heads: int = 1, num_layers: int = 1,
                 joint_modalities: str = "TRANSFORMER",
                 output_format: str = "SELF_ATTEN",
                 fc_transpose_quirk: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        if joint_modalities not in JOINT_MODALITIES:
            raise ValueError(f"joint_modalities={joint_modalities!r}")
        if output_format not in OUTPUT_FORMATS:
            raise ValueError(f"output_format={output_format!r}")
        if joint_modalities == "TRANSFORMER":
            self.mm_transformer = JointMultimodalTransformer(
                num_heads=num_heads, num_layers=num_layers,
                output_format=output_format,
                fc_transpose_quirk=fc_transpose_quirk, dtype=dtype)
        elif joint_modalities == "FC":
            self.mm_transformer = FeatureConcatFC(dtype=dtype)
        else:
            if output_format != "FC":
                raise ValueError("joint_modalities='NONE' takes "
                                 "output_format='FC'")
            self.mm_transformer = MultimodalTransformerNoJR(
                num_heads=num_heads, num_layers=num_layers, dtype=dtype)
        dim = self.mm_transformer.out_dim
        self.vregressor = Regressor(v_dropout, dim, dtype=dtype)
        self.aregressor = Regressor(a_dropout, dim, dtype=dtype)

    def forward(self, f1_audio: torch.Tensor, f2_video: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(audio_feats, visual_feats), each (B, L, 512) -> (vouts, aouts),
        each (B, L)."""
        video = l2_normalize(f2_video, dim=-1)
        audio = l2_normalize(f1_audio, dim=-1)
        features = self.mm_transformer(video, audio)
        return (self.vregressor(features)[..., 0],
                self.aregressor(features)[..., 0])


class SingleBackbonePretrainer(nn.Module):
    def __init__(self, a_dropout: float = 0.0,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.regressor = Regressor(a_dropout, out_dim=2, dtype=dtype)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """x (B, L, 512) -> (vouts, aouts), each (B, L)."""
        if x.ndim != 3:
            raise ValueError(f"the pretrainer takes (B, L, 512), got "
                             f"{tuple(x.shape)}")
        out = self.regressor(x)
        return out[..., 0], out[..., 1]
