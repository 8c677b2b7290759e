"""2-D ResNet-18 — the audio backbone on log-mel spectrograms.

Counterpart of ``jmt_tpu/models/resnet18.py``: torchvision resnet18 with a
1-channel ``conv1`` and no fc head, emitting 512-d features. NCHW here:
input (N, 1, 64 mels, frames) -> (N, 512). Keys follow torchvision
(``conv1``, ``bn1``, ``layer{1..4}.{0,1}.{conv1,bn1,conv2,bn2}``,
``downsample.{0,1}``).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from jmt_tpu_torch.models.common import ConvNd
from jmt_tpu_torch.ops.norm import TorchBatchNorm


class BasicBlock2d(nn.Module):
    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv1 = ConvNd(inplanes, planes, (3, 3), stride, 1, dtype=dtype)
        self.bn1 = TorchBatchNorm(planes, dtype=dtype)
        self.conv2 = ConvNd(planes, planes, (3, 3), 1, 1, dtype=dtype)
        self.bn2 = TorchBatchNorm(planes, dtype=dtype)
        self.downsample = None
        if stride != 1 or inplanes != planes:
            self.downsample = nn.Sequential(
                ConvNd(inplanes, planes, (1, 1), stride, 0, dtype=dtype),
                TorchBatchNorm(planes, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.bn1(self.conv1(x)))
        h = self.bn2(self.conv2(h))
        res = x if self.downsample is None else self.downsample(x)
        return F.relu(h + res)


class ResNet18(nn.Module):
    """Feature extractor: (N, 1, H, W) -> (N, 512)."""

    def __init__(self, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.conv1 = ConvNd(1, 64, (7, 7), 2, 3, dtype=dtype)
        self.bn1 = TorchBatchNorm(64, dtype=dtype)
        inplanes = 64
        for li, planes in enumerate((64, 128, 256, 512), start=1):
            blocks = []
            for bi in range(2):
                stride = 2 if (li > 1 and bi == 0) else 1
                blocks.append(BasicBlock2d(inplanes, planes, stride,
                                           dtype=dtype))
                inplanes = planes
            setattr(self, f"layer{li}", nn.Sequential(*blocks))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.max_pool2d(h, 3, 2, 1)
        h = self.layer4(self.layer3(self.layer2(self.layer1(h))))
        # adaptive avg pool (1, 1) + flatten == mean over space
        out = torch.mean(h, dim=(2, 3))
        return out.to(self.dtype) if self.dtype is not None else out
