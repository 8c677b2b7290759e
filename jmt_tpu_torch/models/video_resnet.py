"""Video ResNets: R(2+1)D-18, R3D-18 and MC3-18, features only.

Counterpart of ``jmt_tpu/models/video_resnet.py`` ``VideoResNet`` /
``r2plus1d_18`` / ``r3d_18`` / ``mc3_18`` with ``features_only=True``:
the layer4 activations, no avgpool or fc head. NCTHW here: (N, 3, T, H,
W) -> (N, 512, T', H', W'); for T=8 at 112 px that is (N, 512, 1, 7, 7)
for R(2+1)D and R3D (their blocks stride time too) and (N, 512, 8, 7, 7)
for MC3 (3-D convs in layer1 only, 1x3x3 after it).

The conv builders: ``Conv2Plus1D`` (spatial 1x3x3, BN, ReLU, temporal
3x1x1; arch ``r2plus1d``), a 3x3x3 conv (``r3d``) and a 1x3x3 conv
(``mc3`` after layer1), each with its downsample stride. The stem is
``R2Plus1dStem``'s factorized pair for ``r2plus1d`` and the 3x7x7
``BasicStem`` otherwise. The factorized pairs' mid planes (45, 144, 230,
460, 921) and the stems' 3-colour input run aligned to multiples of 32
under running-statistics BN (``AlignedPair``, ``BasicStem``;
``ops/conv.py``'s note), so that cuDNN takes its bf16 tensor-core
engines. The JAX stem's space-to-depth rewrite
(``conv3d_s2d_hw``) was a TPU lane-utilisation trick; a plain conv3d
computes the same function.

``remat_blocks``: each residual block is rematerialized when it trains
(``models/common.remat``), the stem not: JAX's ``remat_granularity=
"stage"``.

Keys follow the reference's torchvision-derived modules: R(2+1)D
``stem.{0,1,3,4}``, ``layer{N}.{i}.conv1.0.{0,1,3}`` (spatial conv, BN,
temporal conv); R3D and MC3 ``stem.{0,1}``, ``layer{N}.{i}.conv1.0``
(one conv); then ``conv1.1`` (BN), ``conv2.0``, ``conv2.1``,
``downsample.{0,1}``.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from jmt_tpu_torch.models.common import ConvNd, pad_channels, remat
from jmt_tpu_torch.ops.conv import aligned_width
from jmt_tpu_torch.ops.norm import TorchBatchNorm


def _midplanes(inp: int, out: int) -> int:
    return (inp * out * 3 * 3 * 3) // (inp * 3 * 3 + 3 * out)


class AlignedPair(nn.Sequential):
    """conv -> BN -> ReLU -> conv, then any further modules, channels
    aligned (``ops/conv.py``'s note) while BN uses its running
    statistics: a narrow input (the stem's 3 colours) zero-padded, the
    mid planes computed zero-padded to a multiple of ``ALIGN``, kept zero
    by BN and ReLU and met by the second conv with zero weights. One
    padded activation, no copy; parameters and keys as they are."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        first, bn, relu, second, *rest = self
        x = pad_channels(x, 1, aligned_width(x.shape[1], bn))
        h = first(x, aligned_width(first.weight.shape[0], bn))
        h = second(relu(bn(h)))
        for module in rest:
            h = module(h)
        return h


class BasicStem(nn.Sequential):
    """conv -> BN -> ReLU, its 3-colour input aligned as ``AlignedPair``'s."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv, bn, relu = self
        return relu(bn(conv(pad_channels(x, 1, aligned_width(x.shape[1],
                                                             bn)))))


class Conv2Plus1D(AlignedPair):
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


ARCHS = ("r2plus1d", "r3d", "mc3")


def _builder_conv(builder: str, in_planes: int, out_planes: int, mid: int,
                  stride: int = 1, dtype: Optional[torch.dtype] = None
                  ) -> nn.Module:
    """The block conv of a builder: Conv2Plus1D (r2plus1d), 3x3x3 (r3d)
    or 1x3x3 (mc3)."""
    if builder == "r2plus1d":
        return Conv2Plus1D(in_planes, out_planes, mid, stride, dtype=dtype)
    if builder == "r3d":
        return ConvNd(in_planes, out_planes, (3, 3, 3), stride, 1,
                      dtype=dtype)
    return ConvNd(in_planes, out_planes, (1, 3, 3), (1, stride, stride),
                  (0, 1, 1), dtype=dtype)


class BasicBlock3d(nn.Module):
    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 builder: str = "r2plus1d",
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        # midplanes computed once per block from the block's INPUT planes
        # and used for both convs, as the reference does (r2plus1d only)
        mid = _midplanes(inplanes, planes)
        self.conv1 = nn.Sequential(
            _builder_conv(builder, inplanes, planes, mid, stride, dtype),
            TorchBatchNorm(planes, dtype=dtype), nn.ReLU())
        self.conv2 = nn.Sequential(
            _builder_conv(builder, planes, planes, mid, 1, dtype),
            TorchBatchNorm(planes, dtype=dtype))
        self.downsample = None
        if stride != 1 or inplanes != planes:
            ds = (1, stride, stride) if builder == "mc3" else stride
            self.downsample = nn.Sequential(
                ConvNd(inplanes, planes, (1, 1, 1), ds, 0, dtype=dtype),
                TorchBatchNorm(planes, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv2(self.conv1(x))
        res = x if self.downsample is None else self.downsample(x)
        return F.relu(h + res)


def _stem(arch: str, dtype: Optional[torch.dtype]) -> nn.Sequential:
    if arch == "r2plus1d":
        return AlignedPair(
            ConvNd(3, 45, (1, 7, 7), (1, 2, 2), (0, 3, 3), dtype=dtype),
            TorchBatchNorm(45, dtype=dtype), nn.ReLU(),
            ConvNd(45, 64, (3, 1, 1), 1, (1, 0, 0), dtype=dtype),
            TorchBatchNorm(64, dtype=dtype), nn.ReLU())
    return BasicStem(
        ConvNd(3, 64, (3, 7, 7), (1, 2, 2), (1, 3, 3), dtype=dtype),
        TorchBatchNorm(64, dtype=dtype), nn.ReLU())


class VideoResNet(nn.Module):
    """18-layer video ResNet trunk: (N, 3, T, H, W) -> layer4 features.
    ``arch`` in ``ARCHS``."""

    def __init__(self, arch: str = "r2plus1d", remat_blocks: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        if arch not in ARCHS:
            raise ValueError(f"arch={arch!r}: one of {ARCHS}")
        self.arch = arch
        self.remat_blocks = remat_blocks
        self.stem = _stem(arch, dtype)
        # mc3 mixes makers: 3-D convs in layer1, 1x3x3 after it
        builders = ("r3d", "mc3", "mc3", "mc3") if arch == "mc3" \
            else (arch,) * 4
        inplanes = 64
        for li, planes in enumerate((64, 128, 256, 512), start=1):
            blocks = []
            for bi in range(2):
                stride = 2 if (li > 1 and bi == 0) else 1
                blocks.append(BasicBlock3d(inplanes, planes, stride,
                                           builders[li - 1], dtype=dtype))
                inplanes = planes
            setattr(self, f"layer{li}", nn.Sequential(*blocks))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.stem(x)
        for li in range(1, 5):
            for block in getattr(self, f"layer{li}"):
                h = remat(block, h) if self.remat_blocks \
                    else block(h)
        return h


def r2plus1d_18(dtype: Optional[torch.dtype] = None,
                **kw) -> VideoResNet:
    return VideoResNet("r2plus1d", dtype=dtype, **kw)


def r3d_18(dtype: Optional[torch.dtype] = None, **kw) -> VideoResNet:
    return VideoResNet("r3d", dtype=dtype, **kw)


def mc3_18(dtype: Optional[torch.dtype] = None, **kw) -> VideoResNet:
    return VideoResNet("mc3", dtype=dtype, **kw)
