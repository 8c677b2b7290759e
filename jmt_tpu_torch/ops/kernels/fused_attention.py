"""Wrapper of the CUDA fused-attention kernel (``csrc/fused_attention.cu``).

Replaces the TPU kernel ``jmt_tpu/ops/pallas/fused_attention.py``
(``fused_attention``, body ``_kernel``): ``softmax(q kᵀ) v`` over BH
independent problems, q pre-scaled, scores and softmax in f32, P cast to
v's dtype before P·V, P·V accumulated in f32. The source note in
``csrc/fused_attention.cu`` says what bounds it on an H100, how the design
answers that, and why its gate (Lq, Lk <= 128, D <= 512) differs from the
TPU's ``head_dim <= 256``.

``fused_attention`` is the dispatcher: a CPU tensor goes to the plain
version ``attention_plain``; a CUDA tensor goes to the kernel, or the call
raises. ``fused_attention.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from jmt_tpu_torch.ops.kernels import build

MAX_L = 128
MAX_D = 512
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def attention_plain(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """Plain version: q (BH, Lq, D) pre-scaled, k/v (BH, Lk, D)."""
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
    attn = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.matmul(attn.float(), v.float()).to(v.dtype)


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
            ) -> torch.Tensor:
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise TypeError("attention kernel takes q, k, v of one dtype, "
                        f"float32 or bfloat16; got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if not (k.is_cuda and v.is_cuda and q.device == k.device == v.device):
        raise ValueError("attention kernel: q, k, v must be on one CUDA "
                         "device")
    if not all(x.is_contiguous() for x in (q, k, v)):
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
    if not (bh >= 1 and 1 <= lq <= MAX_L and 1 <= lk <= MAX_L
            and 1 <= d <= MAX_D):
        raise ValueError(f"attention kernel takes BH >= 1, Lq, Lk <= "
                         f"{MAX_L}, D <= {MAX_D}; got BH={bh}, Lq={lq}, "
                         f"Lk={lk}, D={d}")
    lib = build.load("fused_attention")
    fn = lib.jmt_fused_attention
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    bh, lq, lk, d, _DTYPES[q.dtype], stream)
    build.check(lib, status, "attention kernel")
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
