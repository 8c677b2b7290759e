"""Wrapper of the CUDA pool + 1x1 kernel K4 (``csrc/pool1x1.cu``).

Replaces the TPU kernel ``tools/pallas_pool1x1_experiment.py``
(``pool3_1x1``): a 3x3x3 stride-1 max pool padded with -inf, then x . k
with f32 accumulation, no bias, no ReLU. Like the TPU kernel it is an
experiment (``jmt_tpu_torch.tools.pool1x1_experiment``), not wired into
the model. The source note in ``csrc/pool1x1.cu`` says what bounds it on
an H100 and how its design answers that.

``pool3_1x1`` is the dispatcher: a CPU tensor goes to the plain version
``ops.pool1x1.pool3_1x1_plain``; a CUDA tensor goes to the kernel, or the
call raises. ``pool3_1x1.launches`` counts kernel launches. The kernel
takes x (N, C, T, H, W) in ``torch.channels_last_3d`` memory and k (C, Co)
contiguous, both f32 (full-fp32 FMA, no TF32) or both bf16, with C and Co
multiples of 8.
"""
from __future__ import annotations

import ctypes

import torch

from jmt_tpu_torch.ops.kernels import build
from jmt_tpu_torch.ops.pool1x1 import pool3_1x1_plain

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


def _check(x: torch.Tensor, k: torch.Tensor) -> None:
    if x.dtype not in _DTYPES:
        raise TypeError(f"pool3_1x1 kernel takes float32 or bfloat16, got "
                        f"{x.dtype}")
    if x.ndim != 5 or not x.is_contiguous(
            memory_format=torch.channels_last_3d):
        raise ValueError("pool3_1x1 kernel takes x (N, C, T, H, W) "
                         "contiguous in torch.channels_last_3d memory")
    c = x.shape[1]
    if (k.ndim != 2 or k.shape[0] != c or k.dtype != x.dtype
            or k.device != x.device or not k.is_contiguous()):
        raise ValueError(f"pool3_1x1 kernel: k must be a contiguous "
                         f"{x.dtype} (C={c}, Co) on {x.device}; got "
                         f"{k.dtype} {tuple(k.shape)} on {k.device}")
    if c % 8 or k.shape[1] % 8 or k.shape[1] == 0:
        raise ValueError(f"pool3_1x1 kernel takes C and Co that are "
                         f"multiples of 8; got {tuple(k.shape)}")


def _launch(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    _check(x, k)
    n, c, t, h, w = x.shape
    co = k.shape[1]
    out = torch.empty((n, co, t, h, w), dtype=x.dtype, device=x.device,
                      memory_format=torch.channels_last_3d)
    lib = build.load("pool1x1")
    fn = lib.jmt_pool3_1x1
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        status = fn(x.data_ptr(), k.data_ptr(), out.data_ptr(), n, t, h, w,
                    c, co, _DTYPES[x.dtype], stream)
    build.check(lib, status, "pool3_1x1 kernel")
    pool3_1x1.launches += 1
    return out


def pool3_1x1(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """x (N, C, T, H, W), k (C, Co) -> (N, Co, T, H, W) in x's dtype,
    channels-last memory. CUDA: the kernel; CPU: ``pool3_1x1_plain``."""
    if x.is_cuda:
        return _launch(x, k)
    return pool3_1x1_plain(x, k)


pool3_1x1.launches = 0
