"""Two-stream aural-visual backbone container.

Counterpart of ``jmt_tpu/models/tsav.py`` ``TwoStreamBackbones``: the
audio ResNet-18 on the log-mel spectrogram, the R2D1 video ResNet-18
(``r2d1_arch``: R(2+1)D, R3D or MC3) with the MAX / AVG / FLATTEN
feature reduce, and the I3D+TCN vision backbone with a max over time. The
(B, S, ...) batch is flattened to (B*S, ...) and each backbone runs once
on it. I3D runs in chunks of ``i3d_chunk`` clips only while its BN uses
running statistics (frozen, ``finetune_bn="frozen"`` or eval), as in JAX:
chunked batch statistics would differ from the whole batch's. Under int8
the chunks run through ``ops/quant.stream_chunks``, the counterpart of
JAX's scan: one set of int8 weights for every chunk; static int8 refuses
a streamed batch, as JAX's does.

``remat`` (``remat_backbones``) rematerializes the backbones that train
(``models/common.remat``): with ``remat_granularity="backbone"`` each
whole backbone, with ``"stage"`` each R(2+1)D residual block, each I3D
inception module and trunk-level unit, and ResNet-18 whole, as JAX's.

I3D input: when ``i3d_input_size`` is twice the clip size, the 2x upsample
is folded into the stem (``ops/conv.conv3d_stem_upsample2x``) and the
upsampled clip never exists; otherwise the clips are resized per frame,
bilinear with half-pixel centres (the reference's trilinear interpolate
with align_corners=False, an identity along T), or used as they are at
equal size.

Keys follow the reference container: ``audio_resnet18.resnet.*``,
``vision_r2d1.r2plus1d.*`` (whatever the arch), ``vision_r2d1_fc`` for FLATTEN,
``vision_i3d.i3d_WSDDA.*`` and ``vision_i3d.temporal.*``. The reference's
R2D1 fc and I3D heads never run and are not constructed.
"""
from __future__ import annotations

import warnings
from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from jmt_tpu_torch.models.common import Linear, remat
from jmt_tpu_torch.models.i3d import I3DTCN
from jmt_tpu_torch.models.resnet18 import ResNet18
from jmt_tpu_torch.models.video_resnet import VideoResNet
from jmt_tpu_torch.ops import quant
from jmt_tpu_torch.ops.norm import TorchBatchNorm


def resize_clips_for_i3d(clips: torch.Tensor, size: int = 224
                         ) -> torch.Tensor:
    """clips (N, C, T, H, W) -> (N, C, T, size, size), bilinear per frame
    with half-pixel centres; the clips themselves at equal size."""
    n, c, t, h, w = clips.shape
    if h == size and w == size:
        return clips
    return F.interpolate(clips, size=(t, size, size), mode="trilinear",
                         align_corners=False)


class AudioModel(nn.Module):
    def __init__(self, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.resnet = ResNet18(dtype=dtype)

    def forward(self, x):
        return self.resnet(x)


class VideoModel(nn.Module):
    def __init__(self, arch: str = "r2plus1d", remat_blocks: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.r2plus1d = VideoResNet(arch, remat_blocks, dtype=dtype)

    def forward(self, x):
        return self.r2plus1d(x)


class TwoStreamBackbones(nn.Module):
    def __init__(self, vision_backbones: Sequence[str] = ("R2D1",),
                 audio_backbones: Sequence[str] = ("ResNet18",),
                 r2d1_arch: str = "r2plus1d",
                 r2d1_reduce: str = "MAX", flatten_dim: int = 512 * 7 * 7,
                 i3d_input_size: int = 224, i3d_fused_inception: bool = False,
                 i3d_chunk: int = 0, remat: bool = False,
                 remat_granularity: str = "backbone",
                 dtype: Optional[torch.dtype] = None):
        """flatten_dim: input width of the FLATTEN reduce's Linear (512 x
        T' x H' x W' of the layer4 map; 512 x 1 x 7 x 7 at 8 x 112 x 112).
        i3d_fused_inception: run the inception modules as kernel K3."""
        super().__init__()
        if r2d1_reduce not in ("MAX", "AVG", "FLATTEN"):
            raise ValueError(f"r2d1_reduce={r2d1_reduce!r}")
        if remat_granularity not in ("backbone", "stage"):
            raise ValueError(f"remat_granularity={remat_granularity!r}")
        self.vision_backbones = tuple(vision_backbones)
        self.audio_backbones = tuple(audio_backbones)
        self.r2d1_reduce = r2d1_reduce
        self.i3d_input_size = i3d_input_size
        self.i3d_chunk = i3d_chunk
        stage = remat and remat_granularity == "stage"
        # the backbones rematerialized whole (ResNet-18 is small: whole
        # at either granularity)
        self.remat_whole = () if not remat else ("ResNet18",) if stage \
            else ("R2D1", "I3D", "ResNet18")
        if "R2D1" in self.vision_backbones:
            self.vision_r2d1 = VideoModel(r2d1_arch, stage, dtype=dtype)
            if r2d1_reduce == "FLATTEN":
                self.vision_r2d1_fc = Linear(flatten_dim, 512, dtype=dtype)
        if "I3D" in self.vision_backbones:
            self.vision_i3d = I3DTCN(fused_inception=i3d_fused_inception,
                                     remat_stages=stage, dtype=dtype)
        if "ResNet18" in self.audio_backbones:
            self.audio_resnet18 = AudioModel(dtype=dtype)

    def by_name(self) -> Dict[str, nn.Module]:
        """The backbones in use by their config names (R2D1, I3D,
        ResNet18), the units that are frozen or finetuned whole."""
        names = {"R2D1": "vision_r2d1", "I3D": "vision_i3d",
                 "ResNet18": "audio_resnet18"}
        return {k: getattr(self, v) for k, v in names.items()
                if hasattr(self, v)}

    def _run(self, name: str, module: nn.Module, *args, **kwargs):
        """module(*args, **kwargs), rematerialized whole when ``name`` is
        one of ``remat_whole``."""
        if name in self.remat_whole:
            return remat(module, *args, **kwargs)
        return module(*args, **kwargs)

    def _i3d_trunk(self, x: torch.Tensor) -> torch.Tensor:
        """x (N, 3, T, H, W) -> (N, T', 512)."""
        size = self.i3d_input_size
        if size == 2 * x.shape[3] and size == 2 * x.shape[4]:
            return self._run("I3D", self.vision_i3d, x, stem_upsample2x=True)
        return self._run("I3D", self.vision_i3d,
                         resize_clips_for_i3d(x, size))

    def _i3d_running_stats(self) -> bool:
        """Whether the I3D's BN normalizes with its running statistics
        (JAX's ``ura("I3D")``)."""
        return not any(m.training for m in self.vision_i3d.modules()
                       if isinstance(m, TorchBatchNorm))

    def i3d_chunks(self, n: int) -> int:
        """The chunks I3D streams ``n`` flat clips in (1: one call)."""
        ck = self.i3d_chunk
        if "I3D" in self.vision_backbones and 0 < ck < n and n % ck == 0 \
                and self._i3d_running_stats():
            return n // ck
        return 1

    def forward(self, audio_spec: Optional[torch.Tensor],
                clips: Optional[torch.Tensor]) -> Dict[str, torch.Tensor]:
        """audio_spec: (B, S, 64, T) log-mel; clips: (B, S, T, H, W, 3).
        Returns per-backbone features, each (B, S, 512)."""
        feats: Dict[str, torch.Tensor] = {}
        if "ResNet18" in self.audio_backbones:
            b, s = audio_spec.shape[:2]
            flat = audio_spec.reshape(b * s, 1, *audio_spec.shape[2:])
            feats["audio_resnet18"] = self._run(
                "ResNet18", self.audio_resnet18, flat).reshape(b, s, 512)
        if "R2D1" in self.vision_backbones:
            b, s = clips.shape[:2]
            flat = clips.reshape(b * s, *clips.shape[2:])
            fmap = self._run("R2D1", self.vision_r2d1, flat.permute(
                0, 4, 1, 2, 3).contiguous())             # (N, 512, T, H, W)
            n = fmap.shape[0]
            if self.r2d1_reduce == "MAX":
                f = torch.amax(fmap, dim=(2, 3, 4))
            elif self.r2d1_reduce == "AVG":
                f = torch.mean(fmap, dim=(2, 3, 4))
            else:  # FLATTEN in the reference's (C, T, H, W) order
                f = self.vision_r2d1_fc(fmap.reshape(n, -1))
            feats["vision_r2d1"] = f.reshape(b, s, 512)
        if "I3D" in self.vision_backbones:
            b, s = clips.shape[:2]
            # (N, T, H, W, 3) viewed as (N, 3, T, H, W): channels-last
            flat = clips.reshape(b * s, *clips.shape[2:]).permute(0, 4, 1, 2, 3)
            n, ck = flat.shape[0], self.i3d_chunk
            if ck > 0 and n > ck and n % ck:
                # a chunk that does not divide B*S silently disabling the
                # memory knob is the out-of-memory-with-no-hint failure
                warnings.warn(
                    f"i3d_chunk={ck} does not divide the flat clip count "
                    f"{n}: chunk streaming DISABLED; pick a divisor "
                    f"(e.g. B=12,S=16 -> 96; B=16 -> 128)", RuntimeWarning)
            if self.i3d_chunks(n) > 1:
                # every chunk runs the same int8 weights (quant's note)
                tfeat = torch.cat(quant.stream_chunks(self._i3d_trunk,
                                                      flat.split(ck)))
            else:
                tfeat = self._i3d_trunk(flat)
            feats["vision_i3d"] = torch.amax(tfeat, dim=1).reshape(b, s, 512)
        return feats
