"""Two-stream aural-visual backbone container.

Counterpart of ``jmt_tpu/models/tsav.py`` ``TwoStreamBackbones`` (eval
forward): the audio ResNet-18 on the log-mel spectrogram and the R(2+1)D-18
vision backbone with the MAX / AVG / FLATTEN feature reduce. The (B, S, ...)
batch is flattened to (B*S, ...) and each backbone runs once on it.

Keys follow the reference container: ``audio_resnet18.resnet.*``,
``vision_r2d1.r2plus1d.*`` and, for FLATTEN, ``vision_r2d1_fc``. The
reference's R2D1 fc head never runs and is not constructed.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn

from jmt_tpu_torch.models.common import Linear
from jmt_tpu_torch.models.resnet18 import ResNet18
from jmt_tpu_torch.models.video_resnet import r2plus1d_18

I3D_NOT_PORTED = ("the I3D vision backbone (with TCN, the stem-upsample fold "
                  "and the inception kernel) belongs to the next slice of "
                  "the port")


class AudioModel(nn.Module):
    def __init__(self, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.resnet = ResNet18(dtype=dtype)

    def forward(self, x):
        return self.resnet(x)


class VideoModel(nn.Module):
    def __init__(self, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.r2plus1d = r2plus1d_18(dtype=dtype)

    def forward(self, x):
        return self.r2plus1d(x)


class TwoStreamBackbones(nn.Module):
    def __init__(self, vision_backbones: Sequence[str] = ("R2D1",),
                 audio_backbones: Sequence[str] = ("ResNet18",),
                 r2d1_reduce: str = "MAX", flatten_dim: int = 512 * 7 * 7,
                 dtype: Optional[torch.dtype] = None):
        """flatten_dim: input width of the FLATTEN reduce's Linear (512 x
        T' x H' x W' of the layer4 map; 512 x 1 x 7 x 7 at 8 x 112 x 112)."""
        super().__init__()
        if "I3D" in vision_backbones:
            raise NotImplementedError(I3D_NOT_PORTED)
        if r2d1_reduce not in ("MAX", "AVG", "FLATTEN"):
            raise ValueError(f"r2d1_reduce={r2d1_reduce!r}")
        self.vision_backbones = tuple(vision_backbones)
        self.audio_backbones = tuple(audio_backbones)
        self.r2d1_reduce = r2d1_reduce
        if "R2D1" in self.vision_backbones:
            self.vision_r2d1 = VideoModel(dtype=dtype)
            if r2d1_reduce == "FLATTEN":
                self.vision_r2d1_fc = Linear(flatten_dim, 512, dtype=dtype)
        if "ResNet18" in self.audio_backbones:
            self.audio_resnet18 = AudioModel(dtype=dtype)

    def forward(self, audio_spec: Optional[torch.Tensor],
                clips: Optional[torch.Tensor]) -> Dict[str, torch.Tensor]:
        """audio_spec: (B, S, 64, T) log-mel; clips: (B, S, T, H, W, 3).
        Returns per-backbone features, each (B, S, 512)."""
        feats: Dict[str, torch.Tensor] = {}
        if "ResNet18" in self.audio_backbones:
            b, s = audio_spec.shape[:2]
            flat = audio_spec.reshape(b * s, 1, *audio_spec.shape[2:])
            feats["audio_resnet18"] = self.audio_resnet18(flat).reshape(
                b, s, 512)
        if "R2D1" in self.vision_backbones:
            b, s = clips.shape[:2]
            flat = clips.reshape(b * s, *clips.shape[2:])
            fmap = self.vision_r2d1(
                flat.permute(0, 4, 1, 2, 3).contiguous())  # (N, 512, T, H, W)
            n = fmap.shape[0]
            if self.r2d1_reduce == "MAX":
                f = torch.amax(fmap, dim=(2, 3, 4))
            elif self.r2d1_reduce == "AVG":
                f = torch.mean(fmap, dim=(2, 3, 4))
            else:  # FLATTEN in the reference's (C, T, H, W) order
                f = self.vision_r2d1_fc(fmap.reshape(n, -1))
            feats["vision_r2d1"] = f.reshape(b, s, 512)
        return feats
