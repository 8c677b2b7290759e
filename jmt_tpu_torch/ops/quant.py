"""int8 inference: s8 x s8 -> s32 convolutions with per-channel weight and
per-tensor activation scales.

Counterpart of ``jmt_tpu/ops/quant.py``, with its numerics:

* weights: per output channel, symmetric: ``s_w = max(max|w| / 127,
  1e-12)`` over (Cin x window), ``q = clip(round(w / s_w), -127, 127)``,
  taken on the weight as the caller cast it to the compute dtype;
* activations: per tensor, symmetric: dynamic ``s_x = max(max|x| / 127,
  1e-12)`` per call, or static, the next entry of calibrated
  ``act_scales`` in execution order;
* ``round`` is round-half-to-even and ``/`` a true f32 division
  (``true_div_127``);
* accumulate in s32, then ``float(acc) * (s_x * s_w[c])`` in f32 (the
  scale product first), cast to x's dtype.

A conv goes int8 when a context is active and ``eligible`` holds
(Cin x window >= 64): ``ops/conv.conv_nd`` asks. The contexts are
thread-local and read at FORWARD time (the port's counterpart of JAX's
trace time): a CUDA graph captured inside one bakes its mode, and in static
mode its scales, into the graph.

* ``int8_inference(enabled, act_scales)``: dynamic, or static with
  ``act_scales``. Each entry is one forward: it consumes the scales from
  the first, raises when they run out, and raises on leaving when some
  were left over (a persisted scale list of another configuration);
* ``int8_calibration(collector)``: each eligible conv appends its max |x|
  (a 0-d f32 tensor on x's device) and computes in its own dtype; feed
  them to ``act_scales_from_maxes``;
* prepared weights: ``int8_inference(..., weights=...)`` takes each
  eligible conv's quantized, re-laid weight (``kernels.Int8Weight``) from
  a list in execution order instead of preparing it per call (the same
  bits), and raises, as the scales do, when the list runs out or is left
  over. ``collect_int8_weights(forward)`` makes the list by one eager int8
  forward. The list is a snapshot: it does not follow an in-place update
  of the weights (``serve.InferenceServer`` refuses to replay after one).

* under a model mesh (``parallel/tp.tensor_parallel``) a conv that the
  rule splits takes one prepared weight per device slice; calibration's
  float convs split as every float conv does;
* chunk streaming (``stream_chunks``, I3D's ``i3d_chunk``): the chunks of
  one forward run the same convs against the same prepared weights, as
  JAX's scan traces its body once; static scales and calibration refuse
  a streamed batch.

The s8 product and the activation quantizer are kernels K5 and K6
(``ops/kernels/int8_conv.py``). Training is never quantized: the kernels
have no backward, so an int8 conv under autograd raises.
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Callable, List, Optional, Sequence, Tuple

import torch

_STATE = threading.local()

# minimum contraction (Cin x window taps) for the int8 path: tiny stems
# gain nothing and lose accuracy, so they stay in the compute dtype
_MIN_CONTRACTION = 64

# flagship eval V/A absolute drift bound against the unquantized path
# (jmt_tpu/ops/quant.py:49)
FLAGSHIP_VA_ABS_BOUND = 0.1

_REMEDY = "calibrate with the same model/config"


def quant_enabled() -> bool:
    return (getattr(_STATE, "int8", False)
            or getattr(_STATE, "calib", None) is not None)


@contextlib.contextmanager
def int8_inference(enabled: bool = True,
                   act_scales: Optional[Sequence[float]] = None,
                   weights: Optional[Sequence] = None):
    """One forward with eligible convs in int8: dynamic activation scales,
    or static ones (``act_scales``, execution order); each weight prepared
    per call, or taken from ``weights`` (``collect_int8_weights``,
    execution order)."""
    keys = ("int8", "scales", "pos", "weights", "wpos")
    saved = tuple(getattr(_STATE, k, None) for k in keys)
    _STATE.int8 = bool(enabled)
    _STATE.scales = ([float(s) for s in act_scales]
                     if enabled and act_scales is not None else None)
    _STATE.weights = (list(weights) if enabled and weights is not None
                      else None)
    _STATE.pos = _STATE.wpos = 0
    try:
        yield
        scales, pos = _STATE.scales, _STATE.pos
        if scales is not None and pos != len(scales):
            raise RuntimeError(
                f"int8 act_scales left over: the forward ran {pos} eligible "
                f"convs but {len(scales)} scales were given — {_REMEDY}")
        prepared, wpos = _STATE.weights, _STATE.wpos
        if prepared is not None and wpos != len(prepared):
            raise RuntimeError(
                f"int8 prepared weights left over: the forward ran {wpos} "
                f"eligible convs but {len(prepared)} weights were prepared "
                f"— {_REMEDY}")
    finally:
        for k, v in zip(keys, saved):
            setattr(_STATE, k, v)


def collect_int8_weights(forward: Callable[[], object]) -> list:
    """The prepared weights of one eager int8 forward (``forward()`` runs
    it under ``int8_inference``): each eligible conv appends the
    ``kernels.Int8Weight`` it prepares, in execution order, the list to
    pass as ``int8_inference(weights=...)``."""
    saved = getattr(_STATE, "wcoll", None)
    _STATE.wcoll = coll = []
    try:
        forward()
    finally:
        _STATE.wcoll = saved
    return coll


@contextlib.contextmanager
def int8_calibration(collector: list):
    """Eligible convs compute in their dtype and append max |x| (0-d f32
    tensors, execution order) to ``collector``."""
    saved = getattr(_STATE, "calib", None)
    _STATE.calib = collector
    try:
        yield
    finally:
        _STATE.calib = saved


def stack_maxes(collector: List[torch.Tensor]) -> torch.Tensor:
    """A calibration's maxes as one f32 vector on the host, copied once;
    ``zeros(0)`` when no conv was eligible."""
    if not collector:
        return torch.zeros(0, dtype=torch.float32)
    return torch.stack(collector).float().cpu()


def act_scales_from_maxes(maxes, margin: float = 1.0) -> List[float]:
    """Per-conv max |x| -> static activation scales
    ``max(m * margin, 1e-12) / 127`` (Python floats, as JAX's)."""
    flat = torch.as_tensor(maxes, dtype=torch.float32).reshape(-1).tolist()
    return [max(m * margin, 1e-12) / 127.0 for m in flat]


def true_div_127(m: torch.Tensor) -> torch.Tensor:
    """m / 127 as an f32 division. On CUDA, PyTorch divides by a Python
    scalar as a product with its reciprocal, one ulp off at times; a
    divisor tensor made on the device keeps the true division (and makes
    no host-to-device copy, so a CUDA graph can hold it)."""
    return m / torch.full_like(m, 127.0)


def eligible(weight_shape) -> bool:
    """weight (O, I, *k): int8 when I x prod(k) >= 64."""
    return math.prod(weight_shape[1:]) >= _MIN_CONTRACTION


def quantize_weight_per_channel(weight: torch.Tensor
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """weight (O, I, *k) -> (int8 weight, f32 scale (O,))."""
    wf = weight.float()
    s = true_div_127(torch.amax(wf.abs().reshape(wf.shape[0], -1), dim=1))
    s = torch.clamp_min(s, 1e-12)
    q = torch.clamp(torch.round(wf / s.view(-1, *[1] * (wf.ndim - 1))),
                    -127, 127).to(torch.int8)
    return q, s


def quantize_tensor(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor dynamic int8: (int8 x, 0-d f32 scale), x's layout."""
    xf = x.float()
    s = torch.clamp_min(true_div_127(torch.amax(xf.abs())), 1e-12)
    return torch.clamp(torch.round(xf / s), -127, 127).to(torch.int8), s


def _next_scale() -> Optional[float]:
    """The next static scale, or None in dynamic mode."""
    scales = _STATE.scales
    if scales is None:
        return None
    if _STATE.pos >= len(scales):
        raise RuntimeError(
            "int8 act_scales exhausted: the model traces more eligible "
            f"convs than the calibration recorded — {_REMEDY}")
    _STATE.pos += 1
    return scales[_STATE.pos - 1]


def _prepare(weight: torch.Tensor, devices) -> object:
    """The conv's ``kernels.Int8Weight``, or under a model mesh the tuple
    of its output-channel slices, slice i on device i (each channel's
    scale and integers are the whole weight's)."""
    from jmt_tpu_torch.ops.kernels import int8_conv as kernels
    q, s = quantize_weight_per_channel(weight)
    # on the card K5 runs a stem on K6's unfolded x (kernels.Unfold)
    unfold = weight.is_cuda and kernels.unfolds(weight.shape)
    if devices is None:
        return kernels.prepare_weight(q, s, unfold=unfold)
    n = len(devices)
    return tuple(kernels.prepare_weight(qi.to(d), si.to(d), unfold=unfold)
                 for d, qi, si in zip(devices, q.chunk(n), s.chunk(n)))


def _prepared_weight(weight: torch.Tensor, devices=None):
    """The conv's prepared weight (``_prepare``; ``devices``: the model
    mesh when it splits the conv): the next of the prepared list, or
    prepared now (and collected, under ``collect_int8_weights``)."""
    prepared = getattr(_STATE, "weights", None)
    if prepared is None:
        w = _prepare(weight, devices)
        coll = getattr(_STATE, "wcoll", None)
        if coll is not None:
            coll.append(w)
        return w
    pos = _STATE.wpos
    if pos >= len(prepared):
        raise RuntimeError(
            "int8 prepared weights exhausted: the model runs more eligible "
            f"convs than were prepared — {_REMEDY}")
    w = prepared[pos]
    if devices is None:
        want = [(tuple(weight.shape), weight.device)]
    else:
        rows = (weight.shape[0] // len(devices),) + tuple(weight.shape[1:])
        want = [(rows, d) for d in devices]
    got = list(w) if isinstance(w, tuple) else [w]
    if [(g.shape, g.wmat.device) for g in got] != want:
        raise RuntimeError(
            f"int8 prepared weight {pos} is "
            f"{[(g.shape, str(g.wmat.device)) for g in got]}, the conv "
            f"takes {[(r, str(d)) for r, d in want]} (one per device of a "
            f"model mesh that splits it) — {_REMEDY} and model mesh")
    _STATE.wpos = pos + 1
    return w


def stream_chunks(run: Callable[[torch.Tensor], torch.Tensor],
                  chunks: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """``[run(c) for c in chunks]``, the I3D chunks of one forward
    (``i3d_chunk``), as JAX's ``nn.scan`` over them, which traces ``run``
    once. Under dynamic int8 every chunk runs the same eligible convs
    against the same prepared weights: those the first chunk took from
    the prepared list (which then advances once) or prepared itself; each
    chunk's K6 takes the max of its own chunk, as the quantize inside
    JAX's scan body. A chunk that runs another count of eligible convs
    raises. Static int8 and
    calibration raise, naming ``i3d_chunk``: their scales are one per conv
    call of a forward that is not streamed (JAX's static forward fails
    here with 'int8 act_scales exhausted', its calibration step with an
    UnexpectedTracerError)."""
    why = (f"i3d_chunk streams this batch in {len(chunks)} chunks, and "
           f"static int8 scales are one per conv call of a forward that is "
           f"not streamed (JAX fails here too)")
    if getattr(_STATE, "calib", None) is not None:
        raise RuntimeError(f"int8 calibration cannot run here: {why}; "
                           f"calibrate on a batch that i3d_chunk does not "
                           f"split, or set i3d_chunk=0")
    if not getattr(_STATE, "int8", False):
        return [run(c) for c in chunks]
    if _STATE.scales is not None:
        raise RuntimeError(f"static int8 cannot run here: {why}; use "
                           f"dynamic int8 or i3d_chunk=0")
    prepared = _STATE.weights
    if prepared is None:
        outer = getattr(_STATE, "wcoll", None)
        _STATE.wcoll = first = []
        try:
            outs = [run(chunks[0])]
        finally:
            _STATE.wcoll = outer
        if outer is not None:
            outer.extend(first)
    else:
        start = _STATE.wpos
        outs = [run(chunks[0])]
        first = prepared[start:_STATE.wpos]
    after = _STATE.wpos
    _STATE.weights = first
    try:
        for i, c in enumerate(chunks[1:], 1):
            _STATE.wpos = 0
            outs.append(run(c))
            if _STATE.wpos != len(first):
                raise RuntimeError(
                    f"i3d_chunk: chunk {i} ran {_STATE.wpos} eligible int8 "
                    f"convs, the first chunk {len(first)}")
    finally:
        _STATE.weights, _STATE.wpos = prepared, after
    return outs


def int8_conv(x: torch.Tensor, weight: torch.Tensor, stride, pads,
              dilation, float_conv) -> torch.Tensor:
    """An eligible conv under a context: x (N, I, *spatial), weight
    (O, I, *k), both in the compute dtype; pads ((lo, hi), ...) per
    spatial dim. Calibration records max |x| and returns
    ``float_conv()``; inference quantizes x (K6), takes the prepared
    weight (or quantizes and lays it out), runs the s8 product (K5) and
    returns x's dtype. Under ``parallel/tp.tensor_parallel``, when the rule
    splits the conv, x is quantized once on the lead device and each
    device runs K5 on its slice of the weight; the slices are gathered on
    the lead."""
    from jmt_tpu_torch.ops.kernels import int8_conv as kernels
    from jmt_tpu_torch.parallel import tp
    coll = getattr(_STATE, "calib", None)
    if coll is not None:
        coll.append(torch.amax(x.detach().abs()).float())
        return float_conv()
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad):
        raise RuntimeError(
            "int8 inference has no backward: run it under "
            "torch.inference_mode() or torch.no_grad(); training is never "
            "quantized")
    devices = tp.split_devices(weight.shape[0])
    w = _prepared_weight(weight, devices)
    if not (w if devices is None else w[0]).unfold:
        x_q, s_x = kernels.quantize_act(x, _next_scale())
        geom = (stride, dilation, pads)
    else:  # a stem on the card: K6 unfolds x for K5 (kernels.Unfold)
        u = kernels.unfold_geometry(weight.shape, x.shape, stride, dilation,
                                    pads)
        x_q, s_x = kernels.quantize_act(x, _next_scale(), u)
        geom = (u.stride, u.dilation, u.pads)
    if devices is None:
        return kernels.int8_conv(x_q, w, s_x, None, *geom, x.dtype)
    return tp.gather([kernels.int8_conv(
        x_q.to(d), wi, s_x.to(d) if isinstance(s_x, torch.Tensor) else s_x,
        None, *geom, x.dtype) for d, wi in zip(devices, w)])
