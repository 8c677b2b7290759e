"""Convolution and pooling helpers of the I3D and TCN branches.

Counterpart of what ``jmt_tpu/ops/conv.py`` gives the I3D and TCN modules,
in torch's NC... layout:

* ``tf_same_pads``: the reference's TF-style 'SAME' padding, computed from
  static sizes (pure Python);
* ``max_pool_same``: MaxPool3dSamePadding. TF-SAME pads can be
  asymmetric (pool 4a, (3, 3, 3) / (1, 2, 2) at 28 x 28, pads H by (0, 1)),
  which ``F.max_pool3d``'s symmetric ``padding`` cannot say, so the input is
  padded with -inf first: the same -inf init as ``reduce_window``;
* ``avg_pool``: VALID average pool;
* ``conv3d_stem_upsample2x``: the exact fold of the 112 -> 224 bilinear
  upsample into the I3D stem (7 x 7 x 7, stride (1, 2, 2)): one 7 x 5 x 5
  conv on the edge-replicated, zero-padded input plus row, column and
  corner corrections;
* ``WeightNormConv1d``: the TCN's causal dilated conv under torch
  ``weight_norm``, weight ``g * v / ||v||``.

* ``conv_nd``: every conv of the backbones, the counterpart of JAX's
  ``conv_nd``: int8 (``ops/quant.py``) under an int8 context when the
  weight is ``eligible``, else ``F.conv1d/2d/3d``; either way its output
  channels split over devices under ``parallel/tp.tensor_parallel``.

Channel alignment: cuDNN's heuristics run a bf16 conv of the backbones on
an f32 FMA engine (``sm80_xmma_fprop_implicit_gemm_indexed_f32f32``,
some 40 times below the card's bf16 peak) unless its channel counts are
multiples of ``ALIGN`` (32); at 8 and 16 the engine stays the f32 one
(measured on the H100, ``PERF.md``). A conv whose BN uses its running
statistics, outside an int8 context, computes with zero channels up to
the next multiple (``aligned_width``): its owner pads a narrow input (a
clip's 3 colours, a spectrogram's 1: the stems, ResNet-18's ``conv1``;
the folded I3D stem moves its 5 W taps into channels first), and odd mid
planes (R(2+1)D's 45, 144, 230, 460, 921) run padded from their producer
through BN and ReLU into their consumer (``models/video_resnet
.AlignedPair``), which ``conv_nd`` meets with zero weights (``width``,
and x wider than the weight). Eval BN pads its vectors to weight 0, bias
0, mean 0, variance 1, so the planes stay zero. The numbers are the same
but for the order of the f32 additions: zero operands add exact zeros.
Train-mode BN keeps every shape (padded running statistics would need
updating), as does an int8 context (its int8 path and prepared weights
keep theirs). ``conv_counts`` counts the convs run and those aligned.

The JAX package's space-to-depth stem (``conv3d_s2d_hw``) was a TPU
lane-packing trick: a plain conv3d computes the same function, int8
included (the zero taps and pads change neither the maxima nor the sums).
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from jmt_tpu_torch.models.common import cast, pad_channels
from jmt_tpu_torch.ops import quant
from jmt_tpu_torch.parallel import tp

Pads = Tuple[Tuple[int, int], ...]
_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}

ALIGN = 32
# convs run by conv_nd in this process, and their operations by the
# unpadded shapes: all, and those that ran aligned
_COUNTS = {"convs": 0, "flops": 0, "aligned_convs": 0, "aligned_flops": 0}


def aligned_width(c: int, bn: nn.Module) -> int:
    """The channels a conv followed by ``bn`` computes ``c`` of them with:
    ``c`` rounded up to a multiple of ``ALIGN`` while ``bn`` uses its
    running statistics outside an int8 context, else ``c``."""
    if bn.training or quant.quant_enabled():
        return c
    return -(-c // ALIGN) * ALIGN


def conv_counts() -> Dict[str, int]:
    """``conv_nd``'s convs so far and their operations (2 x MACs by the
    unpadded channels): ``convs``, ``flops``, and of them
    ``aligned_convs``, ``aligned_flops``."""
    return dict(_COUNTS)


def aligned_share(before: Dict[str, int], after: Dict[str, int]
                  ) -> Tuple[int, float]:
    """Between two ``conv_counts``: the convs that ran aligned, and their
    share of the operations of all convs run (0 when none ran)."""
    ran = {k: after[k] - before[k] for k in after}
    return (ran["aligned_convs"],
            ran["aligned_flops"] / ran["flops"] if ran["flops"] else 0.0)


def tf_same_pads(sizes: Sequence[int], kernel: Sequence[int],
                 strides: Sequence[int]) -> Pads:
    """TF-SAME (front, back) padding per spatial dim: pad = max(k - s, 0)
    if size % s == 0 else max(k - size % s, 0); front = pad // 2."""
    out = []
    for size, k, s in zip(sizes, kernel, strides):
        pad = max(k - s, 0) if size % s == 0 else max(k - size % s, 0)
        out.append((pad // 2, pad - pad // 2))
    return tuple(out)


def pad_arg(pads: Pads) -> list:
    """(front, back) pairs in dim order -> ``F.pad``'s last-dim-first list."""
    return [v for p in reversed(pads) for v in p]


def conv_nd(x: torch.Tensor, weight: torch.Tensor, stride=1,
            pads: Optional[Pads] = None, dilation=1,
            width: Optional[int] = None) -> torch.Tensor:
    """x (N, I, *spatial), weight (O, I, *k), both in the compute dtype;
    pads: (lo, hi) per spatial dim, or None. Under an int8 context an
    eligible weight takes the int8 path (in calibration: records max |x|
    and computes as below); otherwise ``F.conv*``, with an asymmetric pad
    applied first.

    Aligned channels (the module's note): x may carry zero channels past
    I, which meet zero weights, and ``width`` > O asks for zero output
    channels up to it."""
    channels = tuple(weight.shape[:2])
    weight = pad_channels(weight, 1, x.shape[1])
    if width is not None:
        weight = pad_channels(weight, 0, width)

    def conv(xs, w):
        xp, padding = xs, 0
        if pads is not None:
            if any(lo != hi for lo, hi in pads):
                xp = F.pad(xs, pad_arg(pads))
            else:
                padding = tuple(lo for lo, _ in pads)
        return _CONV[w.ndim - 2](xp, w, None, stride, padding, dilation)

    def float_conv():
        return tp.split_output(conv, x, weight)

    if quant.quant_enabled() and quant.eligible(weight.shape):
        y = quant.int8_conv(x, weight, stride, pads, dilation, float_conv)
    else:
        y = float_conv()
    flops = (2 * y.shape[0] * math.prod(y.shape[2:]) * math.prod(channels)
             * math.prod(weight.shape[2:]))
    _COUNTS["convs"] += 1
    _COUNTS["flops"] += flops
    if tuple(weight.shape[:2]) != channels:
        _COUNTS["aligned_convs"] += 1
        _COUNTS["aligned_flops"] += flops
    return y


def max_pool_same(x: torch.Tensor, kernel: Sequence[int],
                  strides: Sequence[int]) -> torch.Tensor:
    """x (N, C, T, H, W); TF-SAME max pool with -inf padding."""
    pads = tf_same_pads(x.shape[2:], kernel, strides)
    if any(p != (0, 0) for p in pads):
        x = F.pad(x, pad_arg(pads), value=-math.inf)
    return F.max_pool3d(x, tuple(kernel), tuple(strides))


def avg_pool(x: torch.Tensor, window: Sequence[int],
             strides: Sequence[int]) -> torch.Tensor:
    """x (N, C, T, H, W); VALID average pool: window sum / window size."""
    return F.avg_pool3d(x, tuple(window), tuple(strides))


# Fold matrix for (2x bilinear half-pixel upsample) o (7-tap stride-2 conv):
# output j of the composite reads upsampled positions u = 2j-2+t (TF-SAME
# pad (2, 3) on the 2n grid); each u is a 2-tap combination of the
# edge-clamped input, so the 7 taps collapse onto 5 original-grid taps
# x^[j-1+d] with weights w5[d] = sum_t FOLD[d, t] w7[t].
_UPSAMPLE2X_FOLD = np.zeros((5, 7))
for _d, _t, _w in ((0, 0, .25), (1, 0, .75), (1, 1, .75), (1, 2, .25),
                   (2, 1, .25), (2, 2, .75), (2, 3, .75), (2, 4, .25),
                   (3, 3, .25), (3, 4, .75), (3, 5, .75), (3, 6, .25),
                   (4, 5, .25), (4, 6, .75)):
    _UPSAMPLE2X_FOLD[_d, _t] = _w

# The conv's zero padding on the 2n grid drops taps with u < 0 or u > 2n-1;
# the folded conv over the replicate+zero extended x^ still counts them.
# At each affected border output the phantom terms are multiples of the
# edge pixel; ALPHA gives the per-tap coefficient on it.
_UPSAMPLE2X_ALPHA = {
    "lo": np.array([.75, 1., 0., 0., 0., 0., 0.]),       # j = 0
    "hi1": np.array([0., 0., 0., 0., 0., 0., 1.]),       # j = n-2
    "hi0": np.array([0., 0., 0., 0., 1., .75, .25]),     # j = n-1
}


@functools.lru_cache(maxsize=8)
def _fold_constants(device: torch.device):
    """The fold matrix and the border alphas on ``device``, copied there
    once, so that a forward makes no host-to-device copy (a CUDA graph
    captures it) and autograd may save them."""
    with torch.inference_mode(False):
        m = torch.tensor(_UPSAMPLE2X_FOLD, dtype=torch.float32,
                         device=device)
        alphas = {k: torch.tensor(a, dtype=torch.float32, device=device)
                  for k, a in _UPSAMPLE2X_ALPHA.items()}
    return m, alphas


def _w_taps_in_channels(xz: torch.Tensor, t_pad: Tuple[int, int]
                        ) -> torch.Tensor:
    """xz (N, C, T, H, W + 4) -> (N, 5C rounded up to a multiple of
    ``ALIGN``, t0 + T + t1, H, W), channels-last: channel 5c + d holds xz's
    column w + d, so that a (kt, 5, 5) conv over xz is a (kt, 5, 1) conv
    over it; T and the extra channels zero."""
    n, c, t, h, w4 = xz.shape
    t0, t1 = t_pad
    buf = xz.new_zeros(n, t0 + t + t1, h, w4 - 4, -(-5 * c // ALIGN) * ALIGN)
    buf[:, t0:t0 + t, :, :, :5 * c].view(n, t, h, w4 - 4, c, 5).copy_(
        xz.unfold(4, 5, 1).permute(0, 2, 3, 4, 1, 5))
    return buf.permute(0, 4, 1, 2, 3)


def conv3d_stem_upsample2x(x: torch.Tensor, weight: torch.Tensor,
                           t_pad: Tuple[int, int],
                           compute_dtype: Optional[torch.dtype] = None,
                           channels: Optional[int] = None) -> torch.Tensor:
    """``conv7x7x7_tf_same_stride_(1,2,2)(upsample2x_hw(x))`` without the 2x
    tensor: one stride-1 7 x 5 x 5 conv plus border corrections.

    x (N, Ci, T, H, W); weight (Co, Ci, kt, 7, 7), the unfolded stem
    weight; t_pad: TF-SAME pads of T (stride 1); channels (aligned,
    ``aligned_width``; > Ci): the main conv runs on the 5 W taps moved
    into channels (``_w_taps_in_channels``), a (kt, 5, 1) conv, and the
    border corrections' inputs are zero-padded to ``channels`` in their
    last copy. Returns (N, Co, T', H, W).
    """
    co, ci, kt, kh, kw = weight.shape
    if (kh, kw) != (7, 7):
        raise ValueError(f"stem fold takes a (kt, 7, 7) kernel, got "
                         f"{(kt, kh, kw)}")
    h, w = x.shape[3], x.shape[4]
    if h < 4 or w < 4:  # the border sets {0, n-2, n-1} must be distinct
        raise ValueError(f"stem fold needs H, W >= 4, got {(h, w)}")
    wf = weight.float()
    m, alpha = _fold_constants(weight.device)
    k5 = cast(torch.einsum("ah,bw,oithw->oitab", m, m, wf), compute_dtype)
    x = cast(x, compute_dtype)
    # x^ extended: replicate 1 (the upsample's edge clamp), then zero 1
    xr = F.pad(x, (1, 1, 1, 1, 0, 0), mode="replicate")
    xz = F.pad(xr, (1, 1, 1, 1))
    t0, t1 = t_pad
    if channels is None or channels == ci:
        cpad = ()
        out = conv_nd(F.pad(xz, (0, 0, 0, 0, t0, t1)), k5)
    else:
        cpad = (0, channels - ci)
        out = conv_nd(_w_taps_in_channels(xz, t_pad), k5.permute(
            0, 1, 4, 2, 3).reshape(co, 5 * ci, kt, 5, 1))

    alphas = {0: alpha["lo"], h - 2: alpha["hi1"], h - 1: alpha["hi0"]}
    walphas = {0: alpha["lo"], w - 2: alpha["hi1"], w - 1: alpha["hi0"]}
    border_row = {0: 0, h - 2: h - 1, h - 1: h - 1}
    border_col = {0: 0, w - 2: w - 1, w - 1: w - 1}
    tpad = (t0, t1) + cpad
    # subtract the folded conv's phantom terms on border rows and columns
    for jh, av in alphas.items():
        krow = cast(torch.einsum("h,bw,oithw->oitb", av, m, wf),
                    compute_dtype)
        row = xz[:, :, :, border_row[jh] + 2, :]          # (N, Ci, T, W+4)
        out[:, :, :, jh, :] -= conv_nd(F.pad(row, (0, 0) + tpad), krow)
    for jw, av in walphas.items():
        kcol = cast(torch.einsum("w,ah,oithw->oita", av, m, wf),
                    compute_dtype)
        col = xz[:, :, :, :, border_col[jw] + 2]          # (N, Ci, T, H+4)
        out[:, :, :, :, jw] -= conv_nd(F.pad(col, (0, 0) + tpad), kcol)
    # corners were subtracted twice: add back once
    for jh, ah in alphas.items():
        for jw, aw in walphas.items():
            kc = cast(torch.einsum("h,w,oithw->oit", ah, aw, wf),
                      compute_dtype)
            px = x[:, :, :, border_row[jh], border_col[jw]]  # (N, Ci, T)
            out[:, :, :, jh, jw] += conv_nd(F.pad(px, tpad), kc)
    return out


class WeightNormConv1d(nn.Module):
    """Causal dilated Conv1d under torch ``weight_norm`` (dim 0).

    Keys ``weight_g`` (O, 1, 1), ``weight_v`` (O, I, k), ``bias`` (O,), the
    torch <= 2.0 layout the reference saves. The weight is ``g * v / ||v||``
    with the norm over (I, k) per output channel, in f32. The reference pads
    (k-1)*dilation on both sides and trims the right; left-only padding is
    the same function. x (N, I, L) -> (N, O, L).
    """

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int,
                 dilation: int = 1, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.dilation = dilation
        self.weight_g = nn.Parameter(torch.ones(out_ch, 1, 1))
        self.weight_v = nn.Parameter(torch.empty(out_ch, in_ch, kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_ch))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        v = self.weight_v.float()
        norm = torch.sqrt(torch.sum(v ** 2, dim=(1, 2), keepdim=True))
        weight = (self.weight_g / norm) * v
        pad = (self.weight_v.shape[-1] - 1) * self.dilation
        y = conv_nd(F.pad(cast(x, self.dtype), (pad, 0)),
                    cast(weight, self.dtype), dilation=self.dilation)
        return y + cast(self.bias, self.dtype)[:, None]
