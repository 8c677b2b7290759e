"""Inception-v1 I3D backbone + TCN temporal head.

Counterpart of ``jmt_tpu/models/i3d.py``: ``Unit3D`` (TF-SAME conv3d
without bias, BN eps 1e-3 and momentum 0.01, ReLU), ``InceptionModule``,
``InceptionI3d`` on its feature path (Mixed_5c -> AvgPool3d((2, H, W)) ->
(N, T-1, 1024)) and ``I3DTCN`` (I3D features -> 4-layer TCN(1024 -> 512,
k=5, dropout 0.1) -> (N, T-1, 512)).

``remat_stages`` (JAX's ``remat_granularity="stage"``): each inception
module and each trunk-level ``Unit3D`` is rematerialized when it trains
(``models/common.remat``); the TCN is not, nor the stem with its
upsample fold (JAX's remat wraps ``Unit3D.__call__`` only).

Torch layout (N, C, T, H, W). After the stem the trunk runs in
``torch.channels_last_3d`` memory: cuDNN gets its NDHWC layout and the
inception kernel reads (N, T, H, W, C) rows without a transpose.

Keys follow the reference (``Conv3d_1a_7x7.conv3d.weight``,
``Mixed_3b.b1b.bn.running_var``, ...). The unused logits head is not
built.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from jmt_tpu_torch.models.common import ConvNd, cast, pad_channels, remat
from jmt_tpu_torch.models.tcn import TemporalConvNet
from jmt_tpu_torch.ops.conv import (aligned_width, avg_pool,
                                    conv3d_stem_upsample2x, conv_nd,
                                    max_pool_same, tf_same_pads)
from jmt_tpu_torch.ops.inception import BN_EPS, fold_inception_weights
from jmt_tpu_torch.ops.kernels import inception as inception_kernel
from jmt_tpu_torch.ops.kernels.inception import (inception_module_fused,
                                                 pool_absorbable)
from jmt_tpu_torch.ops.norm import TorchBatchNorm

CHANNELS_LAST = torch.channels_last_3d


class Unit3D(nn.Module):
    """Conv3d with TF-SAME padding, no bias, then BN(eps 1e-3) and ReLU."""

    def __init__(self, in_ch: int, out_ch: int,
                 kernel: Sequence[int] = (1, 1, 1),
                 stride: Sequence[int] = (1, 1, 1),
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.kernel, self.stride = tuple(kernel), tuple(stride)
        self.dtype = dtype
        self.conv3d = ConvNd(in_ch, out_ch, kernel, stride, dtype=dtype)
        self.bn = TorchBatchNorm(out_ch, eps=BN_EPS, momentum=0.01,
                                 dtype=dtype)

    def epilogue(self, y: torch.Tensor) -> torch.Tensor:
        """BN + ReLU on a precomputed conv output."""
        return F.relu(self.bn(y))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pads = tf_same_pads(x.shape[2:], self.kernel, self.stride)
        y = conv_nd(cast(x, self.dtype), cast(self.conv3d.weight, self.dtype),
                    self.stride, pads)
        return self.epilogue(y)

    def upsampled2x(self, x: torch.Tensor) -> torch.Tensor:
        """``self(upsample2x_hw(x))`` without the 2x tensor (the exact fold,
        ``ops/conv.conv3d_stem_upsample2x``); stem only: kernel (kt, 7, 7),
        stride (1, 2, 2). The output keeps x's spatial size."""
        if self.stride != (1, 2, 2):
            raise ValueError(f"the stem fold takes stride (1, 2, 2), got "
                             f"{self.stride}")
        t_pad = tf_same_pads((x.shape[2],), (self.kernel[0],), (1,))[0]
        return self.epilogue(conv3d_stem_upsample2x(
            x, self.conv3d.weight, t_pad, compute_dtype=self.dtype,
            channels=aligned_width(x.shape[1], self.bn)))


class InceptionModule(nn.Module):
    """Four branches over one input, concatenated on channels.

    Unfused: the b0 | b1a | b2a 1x1 convs run as ONE conv (weights
    concatenated on the output axis), then each branch's BN + ReLU on its
    split, as the JAX module does. Fused: BN is folded into the weights and
    the whole module is kernel K3 (``ops/kernels/inception.py``); only
    while its BN is in eval mode, as JAX gates it (train-mode BN takes the
    unfused path). K3 has no backward: a fused module whose parameters
    need a gradient raises. ``pool_in``
    (the preceding MaxPool3dSamePadding) is applied first, except on the
    fused path with the gate ``ops/kernels/inception._ABSORB_POOLS`` on
    (off by default, as in JAX) and a pool the kernel absorbs
    (``pool_absorbable``): then K3 takes the pre-pool x and pools in its
    prologue. ``avg_tail`` (Mixed_5c) applies AvgPool3d((2, H, W)) and
    returns (N, T-1, C).
    """

    def __init__(self, in_ch: int, out_channels: Sequence[int],
                 fused: bool = False, pool_in: Optional[Tuple] = None,
                 avg_tail: bool = False, dtype: Optional[torch.dtype] = None):
        super().__init__()
        o = self.out_channels = tuple(out_channels)
        self.fused, self.pool_in, self.avg_tail = fused, pool_in, avg_tail
        self.dtype = dtype
        kw = dict(dtype=dtype)
        self.b0 = Unit3D(in_ch, o[0], **kw)
        self.b1a = Unit3D(in_ch, o[1], **kw)
        self.b1b = Unit3D(o[1], o[2], (3, 3, 3), **kw)
        self.b2a = Unit3D(in_ch, o[3], **kw)
        self.b2b = Unit3D(o[3], o[4], (3, 3, 3), **kw)
        self.b3b = Unit3D(in_ch, o[5], **kw)

    def _folded_branch(self, name: str):
        u = getattr(self, name)
        return (u.conv3d.weight.permute(2, 3, 4, 1, 0),  # (kt, kh, kw, ci, co)
                u.bn.weight, u.bn.bias, u.bn.running_mean, u.bn.running_var)

    def _check_no_backward(self) -> None:
        if torch.is_grad_enabled() and any(p.requires_grad
                                           for p in self.parameters()):
            raise NotImplementedError(
                "i3d_fused_inception=True runs kernel K3, which has no "
                "backward: finetuning I3D with running-statistics BN "
                "(finetune_bn='frozen') needs i3d_fused_inception=False")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or x.dtype
        if self.fused and not self.b0.bn.training:
            self._check_no_backward()
            absorb = (inception_kernel._ABSORB_POOLS
                      and pool_absorbable(self.pool_in, x.shape))
            if self.pool_in is not None and not absorb:
                x = max_pool_same(x, *self.pool_in)
            fw = fold_inception_weights(self._folded_branch, dt)
            x = x.to(dt).contiguous(memory_format=CHANNELS_LAST)
            return inception_module_fused(
                x, fw, self.out_channels,
                pool_in=self.pool_in if absorb else None,
                avg_tail=self.avg_tail)
        if self.pool_in is not None:
            x = max_pool_same(x, *self.pool_in)
        o = self.out_channels
        k = torch.cat([self.b0.conv3d.weight, self.b1a.conv3d.weight,
                       self.b2a.conv3d.weight])
        y = conv_nd(cast(x, self.dtype), cast(k, self.dtype))
        y0, y1, y2 = torch.split(y, [o[0], o[1], o[3]], dim=1)
        out = torch.cat([
            self.b0.epilogue(y0),
            self.b1b(self.b1a.epilogue(y1)),
            self.b2b(self.b2a.epilogue(y2)),
            self.b3b(max_pool_same(x, (3, 3, 3), (1, 1, 1)))], dim=1)
        if self.avg_tail:
            out = avg_pool(out, (2, out.shape[3], out.shape[4]), (1, 1, 1))
            return out.flatten(2).transpose(1, 2)          # (N, T-1, C)
        return out


# (endpoint name, inception channel spec or pool (kernel, strides)) in
# forward order
I3D_STAGES: Tuple = (
    ("Conv3d_1a_7x7", None),
    ("MaxPool3d_2a_3x3", ((1, 3, 3), (1, 2, 2))),
    ("Conv3d_2b_1x1", None),
    ("Conv3d_2c_3x3", None),
    ("MaxPool3d_3a_3x3", ((1, 3, 3), (1, 2, 2))),
    ("Mixed_3b", (64, 96, 128, 16, 32, 32)),
    ("Mixed_3c", (128, 128, 192, 32, 96, 64)),
    ("MaxPool3d_4a_3x3", ((3, 3, 3), (1, 2, 2))),
    ("Mixed_4b", (192, 96, 208, 16, 48, 64)),
    ("Mixed_4c", (160, 112, 224, 24, 64, 64)),
    ("Mixed_4d", (128, 128, 256, 24, 64, 64)),
    ("Mixed_4e", (112, 144, 288, 32, 64, 64)),
    ("Mixed_4f", (256, 160, 320, 32, 128, 128)),
    ("MaxPool3d_5a_2x2", ((2, 2, 2), (1, 2, 2))),
    ("Mixed_5b", (256, 160, 320, 32, 128, 128)),
    ("Mixed_5c", (384, 192, 384, 48, 128, 128)),
)
_UNITS = {"Conv3d_2b_1x1": (64, (1, 1, 1)), "Conv3d_2c_3x3": (192, (3, 3, 3))}


def module_channels(spec: Sequence[int]) -> int:
    """An inception module's output channels: o0 + o2 + o4 + o5."""
    return spec[0] + spec[2] + spec[4] + spec[5]


class InceptionI3d(nn.Module):
    """The feature path: (N, 3, T, H, W) -> (N, T-1, 1024). A MaxPool
    right before a Mixed module becomes that module's ``pool_in``; the
    tail AvgPool3d is Mixed_5c's ``avg_tail``."""

    def __init__(self, fused_inception: bool = False,
                 remat_stages: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.remat_stages = remat_stages
        self.Conv3d_1a_7x7 = Unit3D(3, 64, (7, 7, 7), (1, 2, 2), dtype=dtype)
        self._plan = []
        cin, pending = 64, None
        stages = I3D_STAGES[1:]
        for idx, (name, spec) in enumerate(stages):
            if name.startswith("MaxPool"):
                if stages[idx + 1][0].startswith("Mixed"):
                    pending = spec
                else:
                    self._plan.append(("pool", spec))
            elif name.startswith("Mixed"):
                setattr(self, name, InceptionModule(
                    cin, spec, fused=fused_inception, pool_in=pending,
                    avg_tail=name == "Mixed_5c", dtype=dtype))
                self._plan.append(("module", name))
                pending, cin = None, module_channels(spec)
            else:
                feats, kernel = _UNITS[name]
                setattr(self, name, Unit3D(cin, feats, kernel, dtype=dtype))
                self._plan.append(("module", name))
                cin = feats

    def forward(self, x: torch.Tensor,
                stem_upsample2x: bool = False) -> torch.Tensor:
        """stem_upsample2x: x is the half-resolution clip, and the stem is
        the exact fold of (2x bilinear upsample o conv)."""
        stem = self.Conv3d_1a_7x7
        if stem_upsample2x:
            h = stem.upsampled2x(x)
        else:   # the clip's colours aligned (ops/conv.aligned_width)
            h = self._stage(stem, pad_channels(
                x, 1, aligned_width(x.shape[1], stem.bn)))
        h = h.contiguous(memory_format=CHANNELS_LAST)
        for kind, arg in self._plan:
            h = max_pool_same(h, *arg) if kind == "pool" else \
                self._stage(getattr(self, arg), h)
        return h

    def _stage(self, unit: nn.Module, x: torch.Tensor) -> torch.Tensor:
        return remat(unit, x) if self.remat_stages else unit(x)


class I3DTCN(nn.Module):
    """I3D features -> TCN: (N, 3, T, H, W) -> (N, T-1, 512)."""

    def __init__(self, fused_inception: bool = False,
                 remat_stages: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.i3d_WSDDA = InceptionI3d(fused_inception, remat_stages,
                                      dtype=dtype)
        self.temporal = TemporalConvNet(1024, (512, 512, 512, 512),
                                        kernel_size=5, dropout=0.1,
                                        dtype=dtype)

    def forward(self, x: torch.Tensor,
                stem_upsample2x: bool = False) -> torch.Tensor:
        feats = self.i3d_WSDDA(x, stem_upsample2x)         # (N, T', 1024)
        return self.temporal(feats.transpose(1, 2)).transpose(1, 2)
