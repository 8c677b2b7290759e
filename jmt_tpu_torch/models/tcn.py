"""Temporal Convolutional Network (dilated causal conv stack).

Counterpart of ``jmt_tpu/models/tcn.py``: ``TemporalBlock`` is two
weight-normed dilated causal Conv1d, each followed by LeakyReLU(0.01) and a
channel dropout (``nn.Dropout1d``: whole (sample, channel) rows, built in
eval mode; ``model.train()`` switches it), plus a 1x1 downsample residual when
the widths differ; ``TemporalConvNet`` stacks blocks with dilation 2**i.
Torch layout (N, C, L).

Keys follow the reference: ``network.{i}.conv1.*``, ``conv2.*``,
``downsample.*``. The reference block registers conv1 and conv2 both as
attributes and inside its ``nn.Sequential`` ``net`` (slots 0 and 4, between
its Chomp1d, ReLU and Dropout slots), so its state dict carries both
aliases; ``net`` here holds the same two module objects at the same slots,
so a strict load sees both keys.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from jmt_tpu_torch.models.common import ConvNd
from jmt_tpu_torch.ops.conv import WeightNormConv1d


class TemporalBlock(nn.Module):
    def __init__(self, n_inputs: int, n_outputs: int, kernel_size: int,
                 dilation: int, dropout: float = 0.2,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv1 = WeightNormConv1d(n_inputs, n_outputs, kernel_size,
                                      dilation, dtype=dtype)
        self.conv2 = WeightNormConv1d(n_outputs, n_outputs, kernel_size,
                                      dilation, dtype=dtype)
        # the causal pad lives in the convs, so the chomp slots are
        # identities
        self.net = nn.Sequential(
            self.conv1, nn.Identity(), nn.LeakyReLU(0.01),
            nn.Dropout1d(dropout).eval(),
            self.conv2, nn.Identity(), nn.LeakyReLU(0.01),
            nn.Dropout1d(dropout).eval())
        self.downsample = (ConvNd(n_inputs, n_outputs, (1,), dtype=dtype,
                                  bias=True)
                           if n_inputs != n_outputs else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.net(x)
        res = x if self.downsample is None else self.downsample(x)
        return F.leaky_relu(h + res, 0.01)


class TemporalConvNet(nn.Module):
    def __init__(self, num_inputs: int, num_channels: Sequence[int],
                 kernel_size: int = 2, dropout: float = 0.2,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        blocks = []
        for i, ch in enumerate(num_channels):
            cin = num_inputs if i == 0 else num_channels[i - 1]
            blocks.append(TemporalBlock(cin, ch, kernel_size, 2 ** i,
                                        dropout=dropout, dtype=dtype))
        self.network = nn.Sequential(*blocks)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (N, C_in, L) -> (N, num_channels[-1], L)."""
        return self.network(x)
