"""Wrappers of the int8 kernels (``csrc/int8_conv.cu``) and their plain
versions: K5 ``int8_conv``, the s8 x s8 -> s32 convolution with a
dequantizing epilogue, and K6 ``quantize_act``, the per-tensor activation
quantizer. Neither replaces a TPU kernel: JAX's int8 conv is XLA's
(``jmt_tpu/ops/quant.py:159-166``). The source note says what bounds them
on an H100 and how their design answers that.

Each is a dispatcher: a CPU tensor goes to the plain version
(``int8_conv_plain``, ``quantize_act_plain``), a CUDA tensor to the
kernel, or the call raises. ``.launches`` counts kernel launches. 1-D and
2-D convs are viewed as 3-D with unit dims in front.

* ``quantize_act(x, scale=None)``: x (N, C, *spatial) f32 or bf16, any
  memory format -> (int8 x, s_x). Dynamic (``scale=None``): s_x is a 0-d
  f32 tensor on x's device, ``max(max|x| / 127, 1e-12)``; static: s_x is
  ``scale`` itself, a Python float. On the card the int8 x is in
  channels-last memory.
* ``int8_conv(x_q, w_q, s_x, s_w, stride, dilation, pads, out_dtype)``:
  ``float(q(x) * q(w)) * (s_x * s_w[c])`` in f32, cast to ``out_dtype``
  (f32 or bf16); pads ((lo, hi), ...) per spatial dim. On the card the
  output is in channels-last memory. ``return_acc=True`` also returns
  the s32 sums (the card test's and ``chip_smoke.py``'s check).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from jmt_tpu_torch.ops import quant
from jmt_tpu_torch.ops.kernels import build

CL3 = torch.channels_last_3d
_OUT_DTYPES = (torch.float32, torch.bfloat16)
Scale = Union[torch.Tensor, float]


# ---------------------------------------------------------------- shapes
def _as_3d(x: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """(N, C, *spatial) with 1-3 spatial dims -> (N, C, T, H, W), and the
    number of unit dims put in front."""
    lead = 5 - x.ndim
    if lead not in (0, 1, 2):
        raise ValueError(f"int8 conv takes 1-3 spatial dims, got a "
                         f"{x.ndim}-d tensor")
    for _ in range(lead):
        x = x.unsqueeze(2)
    return x, lead


def _geometry(nd: int, stride, dilation, pads):
    """stride, dilation (int or per dim) and pads (None or (lo, hi) per
    dim) -> three 3-tuples with unit / zero entries in front."""
    def per_dim(v, name):
        v = (v,) * nd if isinstance(v, int) else tuple(v)
        if len(v) != nd:
            raise ValueError(f"{name} {v} for {nd} spatial dims")
        return (1,) * (3 - nd) + v
    pads = ((0, 0),) * nd if pads is None else tuple(tuple(p) for p in pads)
    if len(pads) != nd:
        raise ValueError(f"pads {pads} for {nd} spatial dims")
    return (per_dim(stride, "stride"), per_dim(dilation, "dilation"),
            ((0, 0),) * (3 - nd) + pads)


def _out_size(size: int, k: int, s: int, d: int, lo: int, hi: int) -> int:
    return (size + lo + hi - d * (k - 1) - 1) // s + 1


# ---------------------------------------------------------------- plain
def quantize_act_plain(x: torch.Tensor, scale: Optional[float] = None
                       ) -> Tuple[torch.Tensor, Scale]:
    """K6's plain version: x's layout kept; dynamic is
    ``quant.quantize_tensor``."""
    if scale is None:
        return quant.quantize_tensor(x)
    s = torch.tensor(scale, dtype=torch.float32, device=x.device)
    return torch.clamp(torch.round(x.float() / s), -127, 127).to(
        torch.int8), scale


def int8_acc_plain(x_q: torch.Tensor, w_q: torch.Tensor, stride,
                   dilation, pads) -> torch.Tensor:
    """The s32 sums of the conv, computed in float64 on the integer values
    (exact: |acc| <= 127^2 x Cin x taps < 2^53), as int32."""
    x3, lead = _as_3d(x_q)
    w3, _ = _as_3d(w_q)
    st, dil, pd = _geometry(x_q.ndim - 2, stride, dilation, pads)
    xd = F.pad(x3.double().contiguous(),
               [v for p in reversed(pd) for v in p])
    acc = F.conv3d(xd, w3.double().contiguous(), None, st, 0, dil)
    acc = torch.round(acc).to(torch.int32)
    for _ in range(lead):
        acc = acc.squeeze(2)
    return acc


def dequantize(acc: torch.Tensor, s_x: Scale, s_w: torch.Tensor,
               out_dtype: torch.dtype) -> torch.Tensor:
    """``float(acc) * (s_x * s_w[c])`` in f32, cast to ``out_dtype``."""
    sx = torch.as_tensor(s_x, dtype=torch.float32, device=acc.device)
    prod = (sx * s_w.float()).view(1, -1, *[1] * (acc.ndim - 2))
    return (acc.to(torch.float32) * prod).to(out_dtype)


def int8_conv_plain(x_q: torch.Tensor, w_q: torch.Tensor, s_x: Scale,
                    s_w: torch.Tensor, stride, dilation, pads,
                    out_dtype: torch.dtype) -> torch.Tensor:
    """K5's plain version: x_q (N, I, *spatial) int8, w_q (O, I, *k) int8,
    s_x a 0-d f32 tensor or a float, s_w (O,) f32."""
    return dequantize(int8_acc_plain(x_q, w_q, stride, dilation, pads),
                      s_x, s_w, out_dtype)


# ---------------------------------------------------------------- kernels
@functools.lru_cache(maxsize=None)
def _kernel_fns():
    lib = build.load("int8_conv")
    conv = lib.jmt_int8_conv
    conv.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_float]
                     + [ctypes.c_void_p] * 4)
    conv.restype = ctypes.c_int
    quant = lib.jmt_quantize_act
    quant.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_float]
                      + [ctypes.c_void_p] + [ctypes.c_int] * 3
                      + [ctypes.c_void_p])
    quant.restype = ctypes.c_int
    return lib, conv, quant


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _launch_quantize(x: torch.Tensor, scale: Optional[float]
                     ) -> Tuple[torch.Tensor, Scale]:
    if x.dtype not in _OUT_DTYPES:
        raise TypeError(f"quantize_act kernel takes float32 or bfloat16, "
                        f"got {x.dtype}")
    x3, lead = _as_3d(x)
    if scale is not None and not (isinstance(scale, float) and scale > 0):
        raise ValueError(f"quantize_act: a static scale is a positive "
                         f"float, got {scale!r}")
    q = torch.empty(x3.shape, dtype=torch.int8, device=x.device,
                    memory_format=CL3)
    dims = (ctypes.c_longlong * 10)(*x3.shape, *x3.stride())
    lib, _, fn = _kernel_fns()
    if scale is None:
        s = torch.empty((), dtype=torch.float32, device=x.device)
        amax = torch.empty(1, dtype=torch.int32, device=x.device)
        args = (s.data_ptr(), amax.data_ptr(), 0.0)
    else:
        s, args = scale, (None, None, scale)
    with torch.cuda.device(x.device):
        status = fn(x3.data_ptr(), q.data_ptr(), *args, dims,
                    int(x.dtype == torch.bfloat16),
                    int(x3.is_contiguous()),
                    int(x3.is_contiguous(memory_format=CL3)), _stream(x))
    build.check(lib, status, "quantize_act kernel")
    quantize_act.launches += 1
    for _ in range(lead):
        q = q.squeeze(2)
    return q, s


def _check_conv(x3: torch.Tensor, w3: torch.Tensor, s_x: Scale,
                s_w: torch.Tensor, out_dtype: torch.dtype) -> None:
    dev = x3.device
    if x3.dtype != torch.int8 or w3.dtype != torch.int8:
        raise TypeError(f"int8_conv kernel takes int8 x and w, got "
                        f"{x3.dtype} and {w3.dtype}")
    if not x3.is_contiguous(memory_format=CL3) or x3.data_ptr() % 16:
        raise ValueError("int8_conv kernel takes x in channels-last memory "
                         "(quantize_act's output), 16-byte aligned")
    if w3.ndim != 5 or w3.shape[1] != x3.shape[1] or w3.device != dev:
        raise ValueError(f"int8_conv kernel: w must be (O, I={x3.shape[1]}, "
                         f"*k) on {dev} (grouped convs are not taken); got "
                         f"{tuple(w3.shape)} on {w3.device}")
    if (s_w.dtype != torch.float32 or s_w.shape != (w3.shape[0],)
            or s_w.device != dev):
        raise ValueError(f"int8_conv kernel: s_w must be f32 ({w3.shape[0]},)"
                         f" on {dev}")
    if isinstance(s_x, torch.Tensor):
        if s_x.dtype != torch.float32 or s_x.numel() != 1 or s_x.device != dev:
            raise ValueError("int8_conv kernel: a tensor s_x is one f32 on "
                             "x's device")
    elif not isinstance(s_x, float):
        raise TypeError(f"int8_conv kernel: s_x is a tensor or a float, got "
                        f"{type(s_x)}")
    if out_dtype not in _OUT_DTYPES:
        raise TypeError(f"int8_conv kernel writes float32 or bfloat16, got "
                        f"{out_dtype}")


def _launch_conv(x_q, w_q, s_x, s_w, stride, dilation, pads, out_dtype,
                 return_acc):
    x3, lead = _as_3d(x_q)
    if w_q.ndim != x_q.ndim:
        raise ValueError(f"int8_conv: w {tuple(w_q.shape)} against x "
                         f"{tuple(x_q.shape)}")
    w3, _ = _as_3d(w_q)
    _check_conv(x3, w3, s_x, s_w, out_dtype)
    st, dil, pd = _geometry(x_q.ndim - 2, stride, dilation, pads)
    n, c, t, h, w = x3.shape
    co, _, kt, kh, kw = w3.shape
    outs = [_out_size(sz, k, s, d, lo, hi) for sz, k, s, d, (lo, hi)
            in zip((t, h, w), (kt, kh, kw), st, dil, pd)]
    if min(outs) < 1:
        raise ValueError(f"int8_conv: empty output {outs}")
    k = kt * kh * kw * c
    kp = -(-k // 32) * 32
    wmat = F.pad(w3.permute(0, 2, 3, 4, 1).reshape(co, k), (0, kp - k))
    out = torch.empty((n, co, *outs), dtype=out_dtype, device=x3.device,
                      memory_format=CL3)
    acc = (torch.empty((n, co, *outs), dtype=torch.int32, device=x3.device,
                       memory_format=CL3) if return_acc else None)
    gran = 16 if c % 16 == 0 else 4 if c % 4 == 0 else 1
    geom = (ctypes.c_int * 25)(n, t, h, w, c, *outs, co, kt, kh, kw, *st,
                               *dil, *(lo for lo, _ in pd), kp,
                               int(out_dtype == torch.bfloat16), gran, 0)
    dyn = isinstance(s_x, torch.Tensor)
    lib, fn, _ = _kernel_fns()
    with torch.cuda.device(x3.device):
        status = fn(x3.data_ptr(), wmat.data_ptr(), s_w.data_ptr(),
                    s_x.data_ptr() if dyn else None,
                    0.0 if dyn else s_x, out.data_ptr(),
                    None if acc is None else acc.data_ptr(), geom,
                    _stream(x3))
    build.check(lib, status, "int8_conv kernel")
    int8_conv.launches += 1
    for _ in range(lead):
        out = out.squeeze(2)
        acc = None if acc is None else acc.squeeze(2)
    return (out, acc) if return_acc else out


# ---------------------------------------------------------------- dispatch
def quantize_act(x: torch.Tensor, scale: Optional[float] = None
                 ) -> Tuple[torch.Tensor, Scale]:
    """Per-tensor symmetric int8 of x. CUDA: K6; CPU: the plain version."""
    if x.is_cuda:
        return _launch_quantize(x, scale)
    return quantize_act_plain(x, scale)


def int8_conv(x_q: torch.Tensor, w_q: torch.Tensor, s_x: Scale,
              s_w: torch.Tensor, stride: Union[int, Sequence[int]] = 1,
              dilation: Union[int, Sequence[int]] = 1, pads=None,
              out_dtype: torch.dtype = torch.float32,
              return_acc: bool = False):
    """The dequantized s8 conv. CUDA: K5; CPU: the plain version."""
    if x_q.is_cuda:
        return _launch_conv(x_q, w_q, s_x, s_w, stride, dilation, pads,
                            out_dtype, return_acc)
    acc = int8_acc_plain(x_q, w_q, stride, dilation, pads)
    out = dequantize(acc, s_x, s_w, out_dtype)
    return (out, acc) if return_acc else out


quantize_act.launches = 0
int8_conv.launches = 0

