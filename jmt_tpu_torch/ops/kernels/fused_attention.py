"""Wrapper of the CUDA fused-attention kernel (``csrc/fused_attention.cu``).

Replaces the TPU kernel ``jmt_tpu/ops/pallas/fused_attention.py``
(``fused_attention``, body ``_kernel``): ``softmax(q kᵀ) v`` over BH
independent problems, q pre-scaled, scores and softmax in f32, P cast to
v's dtype before P·V, P·V accumulated in f32. The source note in
``csrc/fused_attention.cu`` says what bounds it on an H100, how the design
answers that, and why its gate (any Lq, Lk at D <= 512) differs from the
TPU's ``L <= 128, head_dim <= 256``: Lq, Lk <= 128 take the short path,
longer problems a path tiled over query rows with two passes over the keys.

``fused_attention`` is the dispatcher: a CPU tensor goes to the plain
version ``attention_plain``; a CUDA tensor goes to the kernel, or the call
raises. ``fused_attention.launches`` counts kernel launches.

The served problems take a few microseconds on the card, so the host's
call path matters: the C function's argument types are bound once
(``_kernel_fn``), the stream is read as a raw handle, and the device
context is entered only when q lies on another device than the current.
"""
from __future__ import annotations

import ctypes

import torch

from jmt_tpu_torch.ops.kernels import build

MAX_D = 512
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def attention_plain(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """Plain version: q (BH, Lq, D) pre-scaled, k/v (BH, Lk, D)."""
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
    attn = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.matmul(attn.float(), v.float()).to(v.dtype)


_FN = None


def _kernel_fn():
    """``jmt_fused_attention`` of the built library, its argument types
    bound once."""
    global _FN
    if _FN is None:
        fn = build.load("fused_attention").jmt_fused_attention
        fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
        _FN = fn
    return _FN


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
            ) -> torch.Tensor:
    dtype = q.dtype
    if not (dtype == k.dtype == v.dtype) or dtype not in _DTYPES:
        raise TypeError("attention kernel takes q, k, v of one dtype, "
                        f"float32 or bfloat16; got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    device = q.device
    if not (k.device == device and v.device == device):
        raise ValueError("attention kernel: q, k, v must be on one CUDA "
                         "device")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("attention kernel takes contiguous q, k, v")
    if q.ndim != 3 or k.ndim != 3 or k.shape != v.shape:
        raise ValueError("attention kernel takes q (BH, Lq, D) and k, v "
                         f"(BH, Lk, D); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    bh, lq, d = q.shape
    if k.shape[0] != bh or k.shape[2] != d:
        raise ValueError(f"attention kernel: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} disagree on BH or D")
    lk = k.shape[1]
    if not (bh >= 1 and lq >= 1 and lk >= 1 and 1 <= d <= MAX_D):
        raise ValueError(f"attention kernel takes BH, Lq, Lk >= 1 and "
                         f"1 <= D <= {MAX_D}; got BH={bh}, Lq={lq}, "
                         f"Lk={lk}, D={d}")
    fn = _kernel_fn()
    out = torch.empty_like(q)
    index = device.index
    if index == torch.cuda.current_device():
        status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    bh, lq, lk, d, _DTYPES[dtype],
                    torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(device):
            status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr(), bh, lq, lk, d, _DTYPES[dtype],
                        torch._C._cuda_getCurrentRawStream(index))
    if status:
        build.check(build.load("fused_attention"), status,
                    "attention kernel")
    fused_attention.launches += 1
    return out


def fused_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """q (BH, Lq, D) ALREADY scaled; k/v (BH, Lk, D) -> (BH, Lq, D).
    CUDA: the kernel; CPU: ``attention_plain``."""
    if q.is_cuda:
        return _launch(q, k, v)
    return attention_plain(q, k, v)


fused_attention.launches = 0
