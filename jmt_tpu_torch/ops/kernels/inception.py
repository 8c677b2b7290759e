"""Wrapper of the CUDA whole-inception-module kernel (``csrc/inception.cu``).

Replaces the TPU kernel ``jmt_tpu/ops/inception_pallas.py``
(``inception_module_fused``, body ``_kernel``): one I3D inception module
with frozen BN folded into its weights (``ops/inception.py``
``fold_inception_weights``). The source note in ``csrc/inception.cu`` says
what bounds it on an H100 and how its design answers that: bf16 runs on
the Hopper pipeline of ``csrc/igemm_sm90.cuh`` (TMA, cp.async, wgmma),
f32 (the parity path) on the FMA tiles of ``csrc/implicit_gemm.cuh``.

``inception_module_fused`` is the dispatcher: a CPU tensor goes to the plain
version ``ops.inception.inception_plain``; a CUDA tensor goes to the kernel,
or the call raises. ``inception_module_fused.launches`` counts wrapper calls
that launched the kernel (one call makes two to four launches), and
``inception_module_fused.pool_in_launches`` those among them with
``pool_in``.

The kernel takes x (N, C, T, H, W) in ``torch.channels_last_3d`` memory, so
it reads (N, T, H, W, C) rows without a transpose, f32 or bf16, with every
channel count a multiple of 8. ``pool_in`` (the pool-absorption prologue)
takes exactly the pools that ``pool_absorbable`` accepts, on either device;
any other ``pool_in`` raises. Whether the model absorbs its pools at all is
the gate ``_ABSORB_POOLS``, off by default as in the JAX package.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from jmt_tpu_torch.ops.inception import FoldedInception, inception_plain
from jmt_tpu_torch.ops.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 15 + [ctypes.c_void_p]

# pool-prologue gate of the fused path (``models/i3d.InceptionModule``),
# the counterpart of the JAX package's ``_ABSORB_POOLS``: off, as there.
_ABSORB_POOLS = False


def pool_absorbable(pool_in: Optional[Tuple], shape: Sequence[int]) -> bool:
    """Whether the kernel computes ``pool_in`` = (kernel, strides) on the
    pre-pool x of ``shape`` (N, C, T, H, W): kernel (1|2|3, k, k) with k in
    {2, 3}, stride (1, 2, 2), even H and W, the reference's pools 3a, 4a
    and 5a."""
    if pool_in is None:
        return False
    (kt, kh, kw), strides = pool_in
    return (tuple(strides) == (1, 2, 2) and kh == kw and kh in (2, 3)
            and kt in (1, 2, 3) and shape[3] % 2 == 0 and shape[4] % 2 == 0)


def _check(x: torch.Tensor, fw: FoldedInception, o: Sequence[int],
           avg_tail: bool) -> None:
    if x.dtype not in _DTYPES:
        raise TypeError("inception kernel takes float32 or bfloat16, got "
                        f"{x.dtype}")
    if x.ndim != 5 or not x.is_contiguous(
            memory_format=torch.channels_last_3d):
        raise ValueError("inception kernel takes x (N, C, T, H, W) "
                         "contiguous in torch.channels_last_3d memory")
    n, c, t, h, w = x.shape
    if len(o) != 6 or min(o) <= 0 or any(v % 8 for v in (c, *o)):
        raise ValueError(f"inception kernel takes channel counts that are "
                         f"positive multiples of 8; got C={c}, spec={o}")
    if avg_tail and t < 2:
        raise ValueError(f"avg_tail needs T >= 2, got T={t}")
    o0, o1, o2, o3, o4, o5 = o
    shapes = ((c, o0 + o1 + o3), (o0 + o1 + o3,), (27, o1, o2), (o2,),
              (27, o3, o4), (o4,), (c, o5), (o5,))
    for name, a, shape in zip(fw._fields, fw, shapes):
        want = x.dtype if a.ndim > 1 else torch.float32
        if (tuple(a.shape) != shape or a.dtype != want
                or a.device != x.device or not a.is_contiguous()):
            raise ValueError(f"inception kernel: {name} must be a contiguous "
                             f"{want} {shape} on {x.device}; got "
                             f"{a.dtype} {tuple(a.shape)} on {a.device}")


def _launch(x: torch.Tensor, fw: FoldedInception, o: Sequence[int],
            avg_tail: bool, pool_in: Optional[Tuple]) -> torch.Tensor:
    _check(x, fw, o, avg_tail)
    n, c, t, h, w = x.shape
    pool_kt = pool_k = 0
    if pool_in is not None:
        (pool_kt, pool_k, _), _ = pool_in
        h, w = h // 2, w // 2
    o0, o1, o2, o3, o4, o5 = o
    co = o0 + o2 + o4 + o5
    kw = dict(dtype=x.dtype, device=x.device)
    if avg_tail:
        out = torch.empty(n, t - 1, co, **kw)
        sums = torch.zeros(n * t, co, dtype=torch.float32, device=x.device)
    else:
        out = torch.empty((n, co, t, h, w),
                          memory_format=torch.channels_last_3d, **kw)
        sums = None
    scratch = torch.empty(n * t * h * w, o1 + o3, **kw)
    # pool_in's pooled rows (f32 and bf16), then in bf16 b3's 3x3x3 pool
    n_pooled = bool(pool_k) + (x.dtype == torch.bfloat16)
    pooled = (torch.empty(n_pooled * n * t * h * w, c, **kw) if n_pooled
              else None)
    lib = build.load("inception")
    fn = lib.jmt_inception_module
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        status = fn(x.data_ptr(), out.data_ptr(), scratch.data_ptr(),
                    0 if pooled is None else pooled.data_ptr(),
                    0 if sums is None else sums.data_ptr(),
                    *(a.data_ptr() for a in fw), n, t, h, w, c, *o,
                    int(pool_kt), int(pool_k), int(avg_tail),
                    _DTYPES[x.dtype], stream)
    build.check(lib, status, "inception kernel")
    inception_module_fused.launches += 1
    inception_module_fused.pool_in_launches += bool(pool_k)
    return out


def inception_module_fused(x: torch.Tensor, fw: FoldedInception,
                           out_channels: Sequence[int], *,
                           pool_in: Optional[Tuple] = None,
                           avg_tail: bool = False) -> torch.Tensor:
    """x (N, C, T, H, W), NONNEGATIVE (post-ReLU or pool: the kernel's zero
    pool padding equals -inf padding only then). ``pool_in`` = (kernel,
    strides): x is the pre-pool map, and the module runs on its max pool.
    Returns the module output (N, co, T, H, W) in channels-last memory, or
    (N, T-1, co) with ``avg_tail``. CUDA: the kernel; CPU:
    ``inception_plain``."""
    if pool_in is not None and not pool_absorbable(pool_in, x.shape):
        raise ValueError(f"the inception kernel's pool prologue takes kernel "
                         f"(1|2|3, k, k), k in {{2, 3}}, stride (1, 2, 2) on "
                         f"an even H and W; got {pool_in} on {tuple(x.shape)}")
    o = tuple(int(v) for v in out_channels)
    if x.is_cuda:
        return _launch(x, fw, o, avg_tail, pool_in)
    return inception_plain(x, fw, o, avg_tail=avg_tail, pool_in=pool_in)


inception_module_fused.launches = 0
inception_module_fused.pool_in_launches = 0
