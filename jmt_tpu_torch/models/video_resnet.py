"""R(2+1)D-18 video backbone, features only.

Counterpart of ``jmt_tpu/models/video_resnet.py`` ``VideoResNet`` /
``r2plus1d_18`` with ``features_only=True``: the layer4 activations, no
avgpool or fc head. NCTHW here: (N, 3, T, H, W) -> (N, 512, T', H', W');
for T=8 at 112 px that is (N, 512, 1, 7, 7).

The JAX stem's space-to-depth rewrite (``conv3d_s2d_hw``) was a TPU
lane-utilisation trick; a plain conv3d computes the same function.

Keys follow the reference's torchvision-derived module: ``stem.{0,1,3,4}``;
``layer{N}.{i}.conv1.0.{0,1,3}`` (spatial conv, BN, temporal conv),
``conv1.1`` (BN), ``conv2.0.{0,1,3}``, ``conv2.1``, ``downsample.{0,1}``.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from jmt_tpu_torch.models.common import ConvNd
from jmt_tpu_torch.ops.norm import TorchBatchNorm


def _midplanes(inp: int, out: int) -> int:
    return (inp * out * 3 * 3 * 3) // (inp * 3 * 3 + 3 * out)


class Conv2Plus1D(nn.Sequential):
    """Spatial 1x3x3 -> BN -> ReLU -> temporal 3x1x1."""

    def __init__(self, in_planes: int, out_planes: int, midplanes: int,
                 stride: int = 1, dtype: Optional[torch.dtype] = None):
        super().__init__(
            ConvNd(in_planes, midplanes, (1, 3, 3), (1, stride, stride),
                   (0, 1, 1), dtype=dtype),
            TorchBatchNorm(midplanes, dtype=dtype),
            nn.ReLU(),
            ConvNd(midplanes, out_planes, (3, 1, 1), (stride, 1, 1),
                   (1, 0, 0), dtype=dtype))


class BasicBlock3d(nn.Module):
    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        # midplanes computed once per block from the block's INPUT planes
        # and used for both convs, as the reference does
        mid = _midplanes(inplanes, planes)
        self.conv1 = nn.Sequential(
            Conv2Plus1D(inplanes, planes, mid, stride, dtype=dtype),
            TorchBatchNorm(planes, dtype=dtype), nn.ReLU())
        self.conv2 = nn.Sequential(
            Conv2Plus1D(planes, planes, mid, dtype=dtype),
            TorchBatchNorm(planes, dtype=dtype))
        self.downsample = None
        if stride != 1 or inplanes != planes:
            self.downsample = nn.Sequential(
                ConvNd(inplanes, planes, (1, 1, 1), stride, 0, dtype=dtype),
                TorchBatchNorm(planes, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv2(self.conv1(x))
        res = x if self.downsample is None else self.downsample(x)
        return F.relu(h + res)


class VideoResNet(nn.Module):
    """18-layer R(2+1)D trunk: (N, 3, T, H, W) -> layer4 features."""

    def __init__(self, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.stem = nn.Sequential(
            ConvNd(3, 45, (1, 7, 7), (1, 2, 2), (0, 3, 3), dtype=dtype),
            TorchBatchNorm(45, dtype=dtype), nn.ReLU(),
            ConvNd(45, 64, (3, 1, 1), 1, (1, 0, 0), dtype=dtype),
            TorchBatchNorm(64, dtype=dtype), nn.ReLU())
        inplanes = 64
        for li, planes in enumerate((64, 128, 256, 512), start=1):
            blocks = []
            for bi in range(2):
                stride = 2 if (li > 1 and bi == 0) else 1
                blocks.append(BasicBlock3d(inplanes, planes, stride,
                                           dtype=dtype))
                inplanes = planes
            setattr(self, f"layer{li}", nn.Sequential(*blocks))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.stem(x)
        return self.layer4(self.layer3(self.layer2(self.layer1(h))))


def r2plus1d_18(dtype: Optional[torch.dtype] = None) -> VideoResNet:
    return VideoResNet(dtype=dtype)
