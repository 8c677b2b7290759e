"""One whole I3D inception module with frozen BN: weight folding and the
plain PyTorch version of kernel K3.

Counterpart of ``jmt_tpu/ops/inception_pallas.py``: ``FoldedInception``,
``fold_bn`` (eps 1e-3) and ``fold_inception_weights`` are its own copies;
``inception_plain`` computes what the TPU kernel's body ``_kernel``
computes, with its cast points:

* b0 | b1a | b2a: one merged 1x1 GEMM over x, f32 accumulation, + f32 bias,
  then the result drops to the working dtype;
* b0 = relu of its slice; a1, a2 = relu of theirs (working dtype);
* b1b, b2b: SAME 3x3x3 convs over a1, a2 with zero padding (a pad position
  contributes 0, not relu(bias)), f32 accumulation, + bias, relu, cast on
  emit;
* b3: 3x3x3 stride-1 max pool of x with ZERO padding in the working dtype
  (equal to the reference's -inf padding only because x >= 0), then a 1x1
  GEMM, f32, + bias, relu, cast on emit;
* ``avg_tail`` (Mixed_5c): per branch the f32 sum over (H, W) of the
  branch's value as emitted above (b0 already rounded, the others in f32),
  then ``(s[t] + s[t+1]) / (2 H W)``, cast: (N, T-1, co);
* ``pool_in`` (the absorbed MaxPool3d_3a/4a/5a): x is the pre-pool map and
  the module first takes its TF-SAME max pool with ZERO padding (again equal
  to -inf padding because x >= 0). The pads are asymmetric on the right:
  (1, 3, 3) / (1, 2, 2) on an even H pads H and W by (0, 1).

Layouts are torch's: x is (N, C, T, H, W) (the port's I3D keeps it in
``torch.channels_last_3d`` memory), the module output (N, co, T, H, W) in
the same memory format. Folded weights use the JAX layout: k1 (C, o0+o1+o3),
kb1 (27, o1, o2) with taps t-major (dt, dh, dw), kb2 (27, o3, o4), k3 (C,
o5), f32 biases. The kernel wrapper is ``ops/kernels/inception.py``.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from jmt_tpu_torch.ops.conv import pad_arg, tf_same_pads

BN_EPS = 1e-3
BRANCHES = ("b0", "b1a", "b1b", "b2a", "b2b", "b3b")


class FoldedInception(NamedTuple):
    """BN-folded weights of one inception module (biases f32)."""
    k1: torch.Tensor    # (C, o0+o1+o3) merged b0 | b1a | b2a 1x1 kernels
    b1: torch.Tensor    # (o0+o1+o3,)
    kb1: torch.Tensor   # (27, o1, o2) b1b 3x3x3 taps, t-major
    bb1: torch.Tensor   # (o2,)
    kb2: torch.Tensor   # (27, o3, o4) b2b taps
    bb2: torch.Tensor   # (o4,)
    k3: torch.Tensor    # (C, o5) b3b 1x1 kernel
    b3: torch.Tensor    # (o5,)


def fold_bn(kernel: torch.Tensor, gamma, beta, mean, var,
            eps: float = BN_EPS) -> Tuple[torch.Tensor, torch.Tensor]:
    """conv + BN(running stats) == conv(k * s) + (beta - mean * s), with
    s = gamma / sqrt(var + eps) over the kernel's last (output) axis."""
    s = gamma / torch.sqrt(var + eps)
    return kernel * s, (beta - mean * s).float()


def fold_inception_weights(get: Callable, dtype: torch.dtype
                           ) -> FoldedInception:
    """get(branch) -> (kernel (kt, kh, kw, ci, co), gamma, beta, mean, var);
    kernels are folded in f32 and then cast to ``dtype``."""
    parts = {}
    for name in BRANCHES:
        k, g, b, m, v = get(name)
        kf, bf = fold_bn(k, g, b, m, v)
        parts[name] = (kf.to(dtype).contiguous(), bf.contiguous())

    def mat(name):  # (1, 1, 1, ci, co) -> (ci, co)
        k = parts[name][0]
        return k.reshape(k.shape[-2], -1)

    def taps(name):  # (3, 3, 3, ci, co) -> (27, ci, co)
        k = parts[name][0]
        return k.reshape(27, *k.shape[-2:])

    return FoldedInception(
        torch.cat([mat("b0"), mat("b1a"), mat("b2a")], dim=-1),
        torch.cat([parts["b0"][1], parts["b1a"][1], parts["b2a"][1]]),
        taps("b1b"), parts["b1b"][1], taps("b2b"), parts["b2b"][1],
        mat("b3b"), parts["b3b"][1])


def _gemm_1x1(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """x (N, T, H, W, C) @ k (C, o) in f32 accumulation -> f32."""
    return torch.matmul(x.float(), k.float())


def _conv3(a: torch.Tensor, kt: torch.Tensor, bias: torch.Tensor
           ) -> torch.Tensor:
    """SAME 3x3x3 zero-padded conv of a (N, T, H, W, ci) with taps kt
    (27, ci, co), f32, + bias, relu -> f32 (N, T, H, W, co)."""
    ci, co = kt.shape[1:]
    w = kt.float().reshape(3, 3, 3, ci, co).permute(4, 3, 0, 1, 2)
    out = F.conv3d(a.permute(0, 4, 1, 2, 3).float(), w, padding=1)
    return torch.relu(out.permute(0, 2, 3, 4, 1) + bias)


def _pool_zero_padded(x: torch.Tensor, kernel: Sequence[int],
                  strides: Sequence[int]) -> torch.Tensor:
    """TF-SAME max pool of x (N, C, T, H, W) >= 0 with zero padding."""
    pads = tf_same_pads(x.shape[2:], kernel, strides)
    return F.max_pool3d(F.pad(x, pad_arg(pads)), tuple(kernel),
                        tuple(strides))


def inception_plain(x: torch.Tensor, fw: FoldedInception,
                    out_channels: Sequence[int], avg_tail: bool = False,
                    pool_in: Optional[Tuple] = None) -> torch.Tensor:
    """x (N, C, T, H, W) in the working dtype -> (N, co, T, H, W), or
    (N, T-1, co) with ``avg_tail``. ``pool_in`` = (kernel, strides): x is
    the pre-pool map, and H, W above are the pooled ones."""
    o0, o1, o2, o3, o4, o5 = out_channels
    if pool_in is not None:
        x = _pool_zero_padded(x, *pool_in)
    dt = x.dtype
    xl = x.permute(0, 2, 3, 4, 1)                          # (N, T, H, W, C)
    y = (_gemm_1x1(xl, fw.k1) + fw.b1).to(dt)
    b0 = torch.relu(y[..., :o0])
    a1 = torch.relu(y[..., o0:o0 + o1])
    a2 = torch.relu(y[..., o0 + o1:])
    b1 = _conv3(a1, fw.kb1, fw.bb1)
    b2 = _conv3(a2, fw.kb2, fw.bb2)
    pooled = F.max_pool3d(F.pad(x, (1, 1, 1, 1, 1, 1)), 3, stride=1)
    b3 = torch.relu(_gemm_1x1(pooled.permute(0, 2, 3, 4, 1), fw.k3) + fw.b3)
    branches = (b0, b1, b2, b3)
    if not avg_tail:
        out = torch.cat([b.to(dt) for b in branches], dim=-1)
        return out.permute(0, 4, 1, 2, 3)                  # channels-last
    h, w = x.shape[3], x.shape[4]
    sums = [b.float().sum(dim=(2, 3)) for b in branches]   # (N, T, o)
    return torch.cat([((s[:, :-1] + s[:, 1:]) * (1.0 / (2 * h * w))).to(dt)
                      for s in sums], dim=-1)
