"""Wrappers of the int8 kernels (``csrc/int8_conv.cu``) and their plain
versions: K5 ``int8_conv``, the s8 x s8 -> s32 convolution with a
dequantizing epilogue, and K6 ``quantize_act``, the per-tensor
activation quantizer. Neither replaces a TPU kernel: JAX's int8 conv is
XLA's (``jmt_tpu/ops/quant.py:159-166``). The source note says what bounds
them on an H100 and how their design answers that.

Each is a dispatcher: a CPU tensor goes to the plain version
(``int8_conv_plain``, ``quantize_act_plain``), a CUDA tensor to the
kernel, or the call raises. ``.launches`` counts kernel launches. 1-D and
2-D convs are viewed as 3-D with unit dims in front.

* ``quantize_act(x, scale=None, unfold=None)``: x (N, C, *spatial) f32
  or bf16, any memory format -> (int8 x, s_x). Dynamic (``scale=None``):
  s_x is a 0-d f32 tensor on x's device, ``max(max|x| / 127, 1e-12)``;
  static: s_x is ``scale`` itself, a Python float. On the card the int8 x
  lies in channels-last rows of ``channel_pitch(C)`` bytes, the pad
  channels zero: the returned tensor is the (N, C, ...) view of them.
  ``unfold`` (an ``Unfold``, a stem's): x' with the last kernel axis's
  taps in its channels instead.
* ``prepare_weight(w_q, s_w, unfold=False)``: an ``Int8Weight``, the
  quantized weight laid out once as K5's B (``relayout``: (Co, Kp) rows,
  the channels of each tap padded to ``channel_pitch(C)``; a stem's
  unfolded first) with, on the card, its TMA tensor map;
  ``prepare_weight.calls`` counts them. ``ops/quant.py`` prepares each
  eligible weight per call, or once per capture (a list made by an eager
  forward), and on the card unfolds the stems (``unfolds``,
  ``unfold_geometry``).
* ``int8_conv(x_q, w, s_x, s_w, stride, dilation, pads, out_dtype)``:
  ``float(q(x) * q(w)) * (s_x * s_w[c])`` in f32, cast to ``out_dtype``
  (f32 or bf16); ``w`` an int8 (O, I, *k) weight or an ``Int8Weight``;
  pads ((lo, hi), ...) per spatial dim. On the card the output is in
  channels-last memory; x in any channels-last layout (K6's rows are taken
  as they are, other rows copied into them). ``return_acc=True`` also
  returns the s32 sums (the card tests' and ``chip_smoke.py``'s check).
  The padded channels change no sum: they are zero in x and w.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import NamedTuple, Optional, Sequence, Tuple, Union

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


def channel_pitch(c: int) -> int:
    """K5's contraction per tap and K6's row pitch for ``c`` channels: ``c``
    rounded up to a multiple of 16, so that K5 gathers x 16 bytes at a
    time and no 16 bytes straddle a tap."""
    return -(-c // 16) * 16


def relayout(w_q: torch.Tensor) -> torch.Tensor:
    """An int8 weight (O, I, *k) as K5's B: (O, Kp) rows,
    ``k = tap * cpt + ci`` with taps in (kt, kh, kw) order and
    ``cpt = channel_pitch(I)``, zero for ``ci >= I`` and past the taps; Kp
    the taps x cpt rounded up to 16 (TMA's row stride)."""
    w3, _ = _as_3d(w_q)
    co, c = w3.shape[:2]
    cpt = channel_pitch(c)
    k = math.prod(w3.shape[2:]) * cpt
    rows = F.pad(w3.permute(0, 2, 3, 4, 1), (0, cpt - c)).reshape(co, k)
    return F.pad(rows, (0, -(-k // 16) * 16 - k)).contiguous()


class Unfold(NamedTuple):
    """A stem conv (I <= 4 input channels) as K5 runs it on the card: K6
    writes x with the kernel's last-axis taps unfolded into the channels,
    ``x'[..., w', j * I + c] = x[..., c, w' * s - lo + j * d]`` (zero
    outside the map) for w' < ``width``, the last axis's output size, and
    K5 convolves it with the weight whose last kernel axis went into the
    channels the same way, under ``stride``, ``dilation`` and ``pads``
    (the conv's own, the last axis's kernel, stride and dilation now 1 and
    unpadded). The products and sums are the same integers; the K per tap
    becomes a multiple of 16."""
    k: int
    d: int
    s: int
    lo: int
    width: int
    stride: Tuple[int, ...]
    dilation: Tuple[int, ...]
    pads: Tuple[Tuple[int, int], ...]


def unfolds(w_shape) -> bool:
    """K5 unfolds the convs of at most 4 input channels and a last kernel
    axis longer than 1 (the stems)."""
    return w_shape[1] <= 4 and len(w_shape) >= 3 and w_shape[-1] > 1


def unfold_geometry(w_shape, x_shape, stride, dilation, pads
                    ) -> Optional[Unfold]:
    """The ``Unfold`` of a conv with weight ``w_shape`` on x ``x_shape``,
    or None when it does not unfold."""
    if not unfolds(w_shape):
        return None
    nd = len(x_shape) - 2
    st, dil, pd = _geometry(nd, stride, dilation, pads)
    wo = _out_size(x_shape[-1], w_shape[-1], st[2], dil[2], *pd[2])
    return Unfold(w_shape[-1], dil[2], st[2], pd[2][0], wo,
                  st[3 - nd:-1] + (1,), dil[3 - nd:-1] + (1,),
                  pd[3 - nd:-1] + ((0, 0),))


def unfold_weight(w_q: torch.Tensor) -> torch.Tensor:
    """(O, I, ..., k) -> (O, k * I, ..., 1), channel j * I + c from tap j of
    channel c: the weight of an ``Unfold``."""
    o, c, k = w_q.shape[0], w_q.shape[1], w_q.shape[-1]
    return w_q.movedim(-1, 1).reshape(o, k * c, *w_q.shape[2:-1], 1)


def unfold_plain(q: torch.Tensor, u: Unfold) -> torch.Tensor:
    """x (N, I, ..., W) -> x' (N, k * I, ..., u.width) of ``Unfold`` u."""
    span = (u.width - 1) * u.s + 1
    need = span + (u.k - 1) * u.d
    qp = F.pad(q, (u.lo, max(0, need - u.lo - q.shape[-1])))
    return torch.cat([qp[..., j * u.d:j * u.d + span:u.s]
                      for j in range(u.k)], dim=1)


@dataclasses.dataclass(frozen=True, eq=False)
class Int8Weight:
    """A weight quantized and laid out for K5 once: ``w_q`` int8, the
    weight K5 computes with (the plain version's operand; on the card a
    stem's is ``unfold_weight`` of the conv's), ``s_w`` (O,) f32, ``wmat``
    its ``relayout``, ``shape`` the conv's weight shape, ``unfold``
    whether x goes through an ``Unfold``, and on the card ``bmap``, K5's
    TMA tensor map of ``wmat`` (128 bytes on the host, which a CUDA graph
    bakes in)."""
    w_q: torch.Tensor
    s_w: torch.Tensor
    wmat: torch.Tensor
    shape: Tuple[int, ...]
    unfold: bool = False
    bmap: Optional[ctypes.Array] = None


# ---------------------------------------------------------------- plain
def quantize_act_plain(x: torch.Tensor, scale: Optional[float] = None,
                       unfold: Optional[Unfold] = None
                       ) -> Tuple[torch.Tensor, Scale]:
    """K6's plain version: x's layout kept; dynamic is
    ``quant.quantize_tensor``; with ``unfold``, q unfolded."""
    if scale is None:
        q, s = quant.quantize_tensor(x)
    else:
        t = torch.tensor(scale, dtype=torch.float32, device=x.device)
        q, s = torch.clamp(torch.round(x.float() / t), -127, 127).to(
            torch.int8), scale
    return (q, s) if unfold is None else (unfold_plain(q, unfold), s)


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
    conv.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_float]
                     + [ctypes.c_void_p] * 5)
    conv.restype = ctypes.c_int
    quant = lib.jmt_quantize_act
    quant.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_float]
                      + [ctypes.c_void_p] + [ctypes.c_int] * 4
                      + [ctypes.c_void_p])
    quant.restype = ctypes.c_int
    lib.jmt_int8_weight_map.argtypes = ([ctypes.c_void_p, ctypes.c_int,
                                         ctypes.c_int, ctypes.c_void_p])
    lib.jmt_int8_weight_map.restype = ctypes.c_int
    lib.jmt_int8_conv_splits.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.jmt_int8_conv_splits.restype = ctypes.c_int
    return lib, conv, quant


def prepare_weight(w_q: torch.Tensor, s_w: torch.Tensor,
                   unfold: bool = False) -> Int8Weight:
    """``w_q`` (O, I, *k) int8 and its scales ``s_w`` (O,) f32 as an
    ``Int8Weight``: with ``unfold`` (a stem, ``unfolds``) its weight
    unfolded, then the re-layout, and on the card the tensor map."""
    if w_q.dtype != torch.int8:
        raise TypeError(f"prepare_weight takes an int8 weight, got "
                        f"{w_q.dtype}")
    shape = tuple(w_q.shape)
    if unfold and not unfolds(shape):
        raise ValueError(f"prepare_weight: a {shape} weight does not "
                         f"unfold")
    if unfold:
        w_q = unfold_weight(w_q)
    wmat = relayout(w_q)
    bmap = None
    if wmat.is_cuda:
        lib = _kernel_fns()[0]
        bmap = (ctypes.c_ubyte * 128)()
        with torch.cuda.device(wmat.device):
            status = lib.jmt_int8_weight_map(wmat.data_ptr(), wmat.shape[0],
                                             wmat.shape[1], bmap)
        build.check(lib, status, "int8_conv weight map")
    prepare_weight.calls += 1
    return Int8Weight(w_q, s_w, wmat, shape, unfold, bmap)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _launch_quantize(x: torch.Tensor, scale: Optional[float],
                     unfold: Optional[Unfold] = None
                     ) -> Tuple[torch.Tensor, Scale]:
    if x.dtype not in _OUT_DTYPES:
        raise TypeError(f"quantize_act kernel takes float32 or bfloat16, "
                        f"got {x.dtype}")
    x3, lead = _as_3d(x)
    if scale is not None and not (isinstance(scale, float) and scale > 0):
        raise ValueError(f"quantize_act: a static scale is a positive "
                         f"float, got {scale!r}")
    n, c, t, h, w = x3.shape
    u = unfold or Unfold(1, 1, 1, 0, w, (), (), ())
    cq = u.k * c
    cp = channel_pitch(cq)
    q = torch.empty((n, cp, t, h, u.width), dtype=torch.int8,
                    device=x.device, memory_format=CL3)
    dims = (ctypes.c_longlong * 15)(*x3.shape, *x3.stride(), u.k, u.d, u.s,
                                    u.lo, u.width)
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
                    int(x3.is_contiguous(memory_format=CL3)), cp,
                    _stream(x))
    build.check(lib, status, "quantize_act kernel")
    quantize_act.launches += 1
    q = q[:, :cq]
    for _ in range(lead):
        q = q.squeeze(2)
    return q, s


def _row_pitch(x3: torch.Tensor) -> Optional[int]:
    """The pitch P of x (N, C, T, H, W) when it lies in channels-last rows
    P elements apart (channels innermost, rows dense), else None."""
    n, c, t, h, w = x3.shape
    if c > 1 and x3.stride(1) != 1:
        return None
    inner = {4: 1, 3: w, 2: h * w, 0: t * h * w}
    pitch = None
    for d, rows in inner.items():
        if x3.shape[d] > 1:
            pitch, rem = divmod(x3.stride(d), rows)
            if rem:
                return None
            break
    if pitch is None:  # a single row
        return channel_pitch(c)
    if pitch < c or any(x3.shape[d] > 1 and x3.stride(d) != rows * pitch
                        for d, rows in inner.items()):
        return None
    return pitch


def as_rows(x_q: torch.Tensor) -> torch.Tensor:
    """An int8 x (N, C, *spatial) in channels-last memory as K6 lays it
    out: rows of ``channel_pitch(C)``, the pad zero; the (N, C, ...) view.
    x itself when it already is."""
    x3, lead = _as_3d(x_q)
    n, c, t, h, w = x3.shape
    cp = channel_pitch(c)
    pitch = _row_pitch(x3)
    if pitch is not None and pitch % 16 == 0 and x3.data_ptr() % 16 == 0:
        return x_q
    rows = torch.empty((n, cp, t, h, w), dtype=x_q.dtype, device=x_q.device,
                       memory_format=CL3).zero_()
    rows[:, :c] = x3
    rows = rows[:, :c]
    for _ in range(lead):
        rows = rows.squeeze(2)
    return rows


def _check_conv(x3: torch.Tensor, w: Int8Weight, s_x: Scale,
                out_dtype: torch.dtype) -> None:
    dev = x3.device
    w3, _ = _as_3d(w.w_q)
    if x3.dtype != torch.int8 or w3.dtype != torch.int8:
        raise TypeError(f"int8_conv kernel takes int8 x and w, got "
                        f"{x3.dtype} and {w3.dtype}")
    if _row_pitch(x3) is None:
        raise ValueError("int8_conv kernel takes x in channels-last rows "
                         "(quantize_act's output)")
    if w3.ndim != 5 or w3.shape[1] != x3.shape[1] or w.wmat.device != dev:
        raise ValueError(f"int8_conv kernel: w must be (O, I={x3.shape[1]}, "
                         f"*k) on {dev} (grouped convs are not taken); got "
                         f"{tuple(w3.shape)} on {w.wmat.device}")
    if (w.s_w.dtype != torch.float32 or w.s_w.shape != (w3.shape[0],)
            or w.s_w.device != dev):
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


def _launch_conv(x_q, w: Int8Weight, s_x, stride, dilation, pads, out_dtype,
                 return_acc):
    x3, lead = _as_3d(x_q)
    if w.w_q.ndim != x_q.ndim:
        raise ValueError(f"int8_conv: w {w.shape} against x "
                         f"{tuple(x_q.shape)}")
    _check_conv(x3, w, s_x, out_dtype)
    x3, _ = _as_3d(as_rows(x_q))
    st, dil, pd = _geometry(x_q.ndim - 2, stride, dilation, pads)
    n, c, t, h, wd = x3.shape
    co, _, kt, kh, kw = _as_3d(w.w_q)[0].shape
    outs = [_out_size(sz, k, s, d, lo, hi) for sz, k, s, d, (lo, hi)
            in zip((t, h, wd), (kt, kh, kw), st, dil, pd)]
    if min(outs) < 1:
        raise ValueError(f"int8_conv: empty output {outs}")
    out = torch.empty((n, co, *outs), dtype=out_dtype, device=x3.device,
                      memory_format=CL3)
    acc = (torch.empty((n, co, *outs), dtype=torch.int32, device=x3.device,
                       memory_format=CL3) if return_acc else None)
    geom = (ctypes.c_int * 25)(n, t, h, wd, c, _row_pitch(x3), *outs, co,
                               kt, kh, kw, *st, *dil, *(lo for lo, _ in pd),
                               channel_pitch(c), w.wmat.shape[1],
                               int(out_dtype == torch.bfloat16))
    dyn = isinstance(s_x, torch.Tensor)
    lib, fn, _ = _kernel_fns()
    with torch.cuda.device(x3.device):
        splits = ctypes.c_int(1)
        build.check(lib, lib.jmt_int8_conv_splits(geom, ctypes.byref(splits)),
                    "int8_conv kernel")
        ws = (torch.empty(out.numel(), dtype=torch.int32, device=x3.device)
              if splits.value > 1 and acc is None else None)
        status = fn(x3.data_ptr(), w.wmat.data_ptr(), w.bmap,
                    w.s_w.data_ptr(), s_x.data_ptr() if dyn else None,
                    0.0 if dyn else s_x, out.data_ptr(),
                    None if acc is None else acc.data_ptr(),
                    None if ws is None else ws.data_ptr(), geom,
                    _stream(x3))
    build.check(lib, status, "int8_conv kernel")
    int8_conv.launches += 1
    for _ in range(lead):
        out = out.squeeze(2)
        acc = None if acc is None else acc.squeeze(2)
    return (out, acc) if return_acc else out


# ---------------------------------------------------------------- dispatch
def quantize_act(x: torch.Tensor, scale: Optional[float] = None,
                 unfold: Optional[Unfold] = None
                 ) -> Tuple[torch.Tensor, Scale]:
    """Per-tensor symmetric int8 of x, unfolded by ``unfold`` if given.
    CUDA: K6; CPU: the plain version."""
    if x.is_cuda:
        return _launch_quantize(x, scale, unfold)
    return quantize_act_plain(x, scale, unfold)


def int8_conv(x_q: torch.Tensor, w: Union[torch.Tensor, Int8Weight],
              s_x: Scale, s_w: Optional[torch.Tensor] = None,
              stride: Union[int, Sequence[int]] = 1,
              dilation: Union[int, Sequence[int]] = 1, pads=None,
              out_dtype: torch.dtype = torch.float32,
              return_acc: bool = False):
    """The dequantized s8 conv of x_q and ``w``, an int8 (O, I, *k) weight
    with its scales ``s_w`` or an ``Int8Weight`` (``s_w`` None or its
    own). CUDA: K5; CPU: the plain version."""
    if isinstance(w, Int8Weight):
        if s_w is not None and s_w is not w.s_w:
            raise ValueError("int8_conv: a prepared weight carries its own "
                             "s_w")
    elif s_w is None:
        raise ValueError("int8_conv: an int8 weight needs its s_w")
    if x_q.is_cuda:
        if not isinstance(w, Int8Weight):
            w = prepare_weight(w, s_w)
        return _launch_conv(x_q, w, s_x, stride, dilation, pads, out_dtype,
                            return_acc)
    if isinstance(w, Int8Weight):
        w, s_w = w.w_q, w.s_w
    acc = int8_acc_plain(x_q, w, stride, dilation, pads)
    out = dequantize(acc, s_x, s_w, out_dtype)
    return (out, acc) if return_acc else out


quantize_act.launches = 0
int8_conv.launches = 0
prepare_weight.calls = 0

