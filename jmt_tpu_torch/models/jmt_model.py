"""The composed model: backbones -> intra-modal fusion -> JMT -> heads.

Counterpart of ``jmt_tpu/models/jmt_model.py`` ``JMTModel`` (eval and
train forward) and ``model_from_config``, over the config lattice:

* vision {R2D1}, {I3D}, {R2D1, I3D}; the pair fused by
  'encoder_plus_self_attention' (IntraModalTransformerFusion over
  (r2d1, i3d)) or 'feat_concat_fc' (FcLayer(1024 -> 512));
* audio {ResNet18}, {wavLM} (-> FcLayer(768 -> 512)), {ResNet18, wavLM}
  fused by 'encoder_plus_self_attention' or 'feat_concat_fc'
  (FcLayer(1280 -> 512));
* goal TRAINING: ``TwoTransformers`` (``joint_modalities`` TRANSFORMER
  with the SELF_ATTEN or FC head, FC, or NONE), then the V/A regressors;
  goal PRETRAINING: ``SingleBackbonePretrainer`` on the one backbone.

Modes follow the reference's training loop: ``model.train()`` puts every
module in train mode, then every backbone not in ``finetune`` back in eval
mode (running-statistics BN, no dropout), and with
``finetune_bn="frozen"`` the BN of the finetuned ones too; ``model.eval()``
is the eval forward. Parameters of the frozen backbones are the caller's
to exclude (``train/state.partition_params``).

Keys follow the reference's assembly: ``backbones.*``,
``transformer_visio_modality_fusion.*``, ``fc_layer_for_video_concat.*``,
``transformer_audio_modality_fusion.*``, ``fc_layer_for_audio_concat.*``,
``fusion_model.*`` or ``backbone_pretrainer.*``.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn as nn

from jmt_tpu_torch.models.fusion import (SingleBackbonePretrainer,
                                         TwoTransformers)
from jmt_tpu_torch.models.intra_modal import (FcLayer,
                                              IntraModalTransformerFusion)
from jmt_tpu_torch.models.tsav import TwoStreamBackbones
from jmt_tpu_torch.ops.norm import TorchBatchNorm


def _intra_modal(kind: str, concat_dim: int, num_heads: int,
                 num_layers: int, dtype):
    """(fc layer, transformer fusion) of one modality's backbone pair."""
    if kind == "feat_concat_fc":
        return FcLayer(concat_dim, dtype=dtype), None
    if kind == "encoder_plus_self_attention":
        return None, IntraModalTransformerFusion(
            num_heads=num_heads, num_layers=num_layers, dtype=dtype)
    raise NotImplementedError(kind)


class JMTModel(nn.Module):
    def __init__(self, vision_backbones: Sequence[str] = ("R2D1",),
                 audio_backbones: Sequence[str] = ("ResNet18",),
                 intra_modal_fusion: str = "None",
                 joint_modalities: str = "TRANSFORMER",
                 output_format: str = "SELF_ATTEN", goal: str = "TRAINING",
                 num_heads: int = 1, num_layers: int = 1,
                 r2d1_reduce: str = "MAX", i3d_input_size: int = 224,
                 i3d_fused_inception: Union[bool, str] = "auto",
                 i3d_chunk: int = 0, v_dropout: float = 0.0,
                 a_dropout: float = 0.0, finetune: Sequence[str] = (),
                 finetune_bn: str = "batch",
                 fc_transpose_quirk: bool = False,
                 dtype: Optional[torch.dtype] = None):
        """i3d_fused_inception: True runs the nine inception modules as
        kernel K3; "auto" resolves to False, as in the JAX package, until a
        measurement on this card says otherwise (``PERF.md`` records both
        paths' times). finetune: the backbones (R2D1, I3D, ResNet18) that
        train; finetune_bn: "batch" (train-mode BN in them) or "frozen"
        (running statistics)."""
        super().__init__()
        self.vision_backbones = tuple(vision_backbones)
        self.audio_backbones = tuple(audio_backbones)
        self.dtype = dtype
        if finetune_bn not in ("batch", "frozen"):
            raise ValueError(f"finetune_bn={finetune_bn!r}")
        self.finetune = tuple(finetune)
        self.finetune_bn = finetune_bn
        if goal not in ("TRAINING", "PRETRAINING"):
            raise ValueError(f"goal={goal!r}")
        self.goal = goal
        if not set(self.vision_backbones) <= {"R2D1", "I3D"} or (
                goal == "TRAINING" and not self.vision_backbones):
            raise NotImplementedError(
                f"vision_backbones={self.vision_backbones}: a subset of "
                "('R2D1', 'I3D'), non-empty in training, is ported")
        fused = False if i3d_fused_inception == "auto" \
            else bool(i3d_fused_inception)
        self.backbones = TwoStreamBackbones(
            vision_backbones=self.vision_backbones,
            audio_backbones=self.audio_backbones,
            r2d1_reduce=r2d1_reduce, i3d_input_size=i3d_input_size,
            i3d_fused_inception=fused, i3d_chunk=i3d_chunk, dtype=dtype)

        self.fc_layer_for_video_concat = None
        self.transformer_visio_modality_fusion = None
        if len(self.vision_backbones) == 2:
            (self.fc_layer_for_video_concat,
             self.transformer_visio_modality_fusion) = _intra_modal(
                intra_modal_fusion, 512 + 512, num_heads, num_layers, dtype)

        self.fc_layer_for_audio_concat = None
        self.transformer_audio_modality_fusion = None
        if len(self.audio_backbones) == 2:
            (self.fc_layer_for_audio_concat,
             self.transformer_audio_modality_fusion) = _intra_modal(
                intra_modal_fusion, 512 + 768, num_heads, num_layers, dtype)
        elif self.audio_backbones == ("wavLM",):
            self.fc_layer_for_audio_concat = FcLayer(768, dtype=dtype)

        self.fusion_model = self.backbone_pretrainer = None
        if goal == "TRAINING":
            self.fusion_model = TwoTransformers(
                v_dropout=v_dropout, a_dropout=a_dropout,
                num_heads=num_heads, num_layers=num_layers,
                joint_modalities=joint_modalities,
                output_format=output_format,
                fc_transpose_quirk=fc_transpose_quirk, dtype=dtype)
        else:
            self.backbone_pretrainer = SingleBackbonePretrainer(
                a_dropout=a_dropout, dtype=dtype)

    def train(self, mode: bool = True) -> "JMTModel":
        super().train(mode)
        if mode:
            for name, backbone in self.backbones.by_name().items():
                if name not in self.finetune:
                    backbone.eval()
                elif self.finetune_bn == "frozen":
                    for mod in backbone.modules():
                        if isinstance(mod, TorchBatchNorm):
                            mod.eval()
        return self

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
        visual_feats = aud_feats = None
        if len(self.vision_backbones) == 2:
            r2d1, i3d = feats["vision_r2d1"], feats["vision_i3d"]
            if self.fc_layer_for_video_concat is not None:
                visual_feats = self.fc_layer_for_video_concat(
                    torch.cat([r2d1, i3d], dim=-1))
            else:
                visual_feats = self.transformer_visio_modality_fusion(
                    r2d1, i3d)
        elif "R2D1" in self.vision_backbones:
            visual_feats = feats["vision_r2d1"]
        elif "I3D" in self.vision_backbones:
            visual_feats = feats["vision_i3d"]
        if len(self.audio_backbones) == 2:
            rn = feats["audio_resnet18"]
            if self.fc_layer_for_audio_concat is not None:
                aud_feats = self.fc_layer_for_audio_concat(
                    torch.cat([rn, wavlm.to(rn.dtype)], dim=-1))
            else:
                aud_feats = self.transformer_audio_modality_fusion(rn, wavlm)
        elif self.use_wavlm:
            aud_feats = self.fc_layer_for_audio_concat(wavlm)
        elif "ResNet18" in self.audio_backbones:
            aud_feats = feats["audio_resnet18"]
        if self.fusion_model is not None:
            return self.fusion_model(aud_feats, visual_feats)
        return self.backbone_pretrainer(
            visual_feats if visual_feats is not None else aud_feats)


def model_from_config(cfg) -> JMTModel:
    """The composed model of a ``core.config.Config``, with random
    backbones: the ``init_w_*`` policy loads its pretrained ones later,
    before the freeze partition (``models/pretrained.apply_pretrained``,
    run by ``train/runner.Runner.initialize``). Raises
    ``NotImplementedError`` naming the key for what the port leaves out:
    ``remat_backbones``, a data mesh of more than one card
    (``mesh_data_parallel``), the heavy augmentations
    (``use_more_vision_data_augm`` / ``use_more_audio_data_augm``)."""
    mp = cfg.model_params
    if mp.remat_backbones:
        raise NotImplementedError("model_params.remat_backbones: not "
                                  "ported yet")
    n_mesh = cfg.mesh_data_parallel
    if n_mesh == -1:
        n_mesh = max(torch.cuda.device_count(), 1)
    if n_mesh > 1:
        raise NotImplementedError(
            f"mesh_data_parallel={cfg.mesh_data_parallel} resolves to "
            f"{n_mesh} cards: the port trains on one device")
    for split in ("train_params", "val_params", "test_params"):
        for key in ("use_more_vision_data_augm", "use_more_audio_data_augm"):
            if getattr(getattr(cfg, split), key):
                raise NotImplementedError(f"{split}.{key}: the heavy "
                                          "augmentations are not ported yet")
    return JMTModel(
        vision_backbones=tuple(mp.l_vision_backbones),
        audio_backbones=tuple(mp.l_audio_backbones),
        intra_modal_fusion=mp.intra_modal_fusion,
        joint_modalities=mp.joint_modalities,
        output_format=mp.output_format, goal=cfg.goal,
        num_heads=mp.num_heads, num_layers=mp.num_layers,
        r2d1_reduce=mp.R2D1_ft_dim_reduce,
        i3d_input_size=mp.i3d_input_size,
        i3d_fused_inception=mp.i3d_fused_inception,
        i3d_chunk=mp.i3d_chunk, v_dropout=mp.v_dropout,
        a_dropout=mp.a_dropout, finetune=mp.finetune(),
        finetune_bn=mp.finetune_bn,
        dtype=torch.bfloat16 if mp.compute_dtype == "bfloat16" else None)
