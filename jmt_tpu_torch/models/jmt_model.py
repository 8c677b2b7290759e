"""The composed model: backbones -> intra-modal fusion -> JMT -> heads.

Counterpart of ``jmt_tpu/models/jmt_model.py`` ``JMTModel`` (goal
TRAINING, eval forward) over the lattice this slice ports:

* vision {R2D1};
* audio {ResNet18}, {wavLM} (-> FcLayer(768 -> 512)), {ResNet18, wavLM}
  fused by 'encoder_plus_self_attention' (IntraModalTransformerFusion) or
  'feat_concat_fc' (FcLayer(1280 -> 512));
* JMT 'TRANSFORMER' with the SELF_ATTEN head, then the V/A regressors.

Keys follow the reference's assembly: ``backbones.*``,
``transformer_audio_modality_fusion.*``, ``fc_layer_for_audio_concat.*``,
``fusion_model.*``.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn

from jmt_tpu_torch.models.fusion import TwoTransformers
from jmt_tpu_torch.models.intra_modal import (FcLayer,
                                              IntraModalTransformerFusion)
from jmt_tpu_torch.models.tsav import TwoStreamBackbones


class JMTModel(nn.Module):
    def __init__(self, vision_backbones: Sequence[str] = ("R2D1",),
                 audio_backbones: Sequence[str] = ("ResNet18",),
                 intra_modal_fusion: str = "None",
                 num_heads: int = 1, num_layers: int = 1,
                 r2d1_reduce: str = "MAX",
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.vision_backbones = tuple(vision_backbones)
        self.audio_backbones = tuple(audio_backbones)
        self.dtype = dtype
        if self.vision_backbones != ("R2D1",):
            raise NotImplementedError(
                f"vision_backbones={self.vision_backbones}: only ('R2D1',) "
                "is ported")
        self.backbones = TwoStreamBackbones(
            vision_backbones=self.vision_backbones,
            audio_backbones=self.audio_backbones,
            r2d1_reduce=r2d1_reduce, dtype=dtype)

        self.fc_layer_for_audio_concat = None
        self.transformer_audio_modality_fusion = None
        if len(self.audio_backbones) == 2:
            if intra_modal_fusion == "feat_concat_fc":
                self.fc_layer_for_audio_concat = FcLayer(512 + 768,
                                                         dtype=dtype)
            elif intra_modal_fusion == "encoder_plus_self_attention":
                self.transformer_audio_modality_fusion = \
                    IntraModalTransformerFusion(
                        num_heads=num_heads, num_layers=num_layers,
                        dtype=dtype)
            else:
                raise NotImplementedError(intra_modal_fusion)
        elif self.audio_backbones == ("wavLM",):
            self.fc_layer_for_audio_concat = FcLayer(768, dtype=dtype)

        self.fusion_model = TwoTransformers(
            num_heads=num_heads, num_layers=num_layers, dtype=dtype)

    @property
    def use_wavlm(self) -> bool:
        return "wavLM" in self.audio_backbones

    def forward(self, audio_spec: Optional[torch.Tensor],
                clips: Optional[torch.Tensor],
                wavlm: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """audio_spec (B,S,64,T) | clips (B,S,8,H,W,3) | wavlm (B,S,768).
        Returns (vouts, aouts), each (B, S)."""
        feats = self.backbones(audio_spec, clips)
        visual_feats = feats["vision_r2d1"]
        if len(self.audio_backbones) == 2:
            rn = feats["audio_resnet18"]
            if self.fc_layer_for_audio_concat is not None:
                aud_feats = self.fc_layer_for_audio_concat(
                    torch.cat([rn, wavlm.to(rn.dtype)], dim=-1))
            else:
                aud_feats = self.transformer_audio_modality_fusion(rn, wavlm)
        elif self.use_wavlm:
            aud_feats = self.fc_layer_for_audio_concat(wavlm)
        else:
            aud_feats = feats["audio_resnet18"]
        return self.fusion_model(aud_feats, visual_feats)
