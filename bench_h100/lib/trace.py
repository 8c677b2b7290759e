"""The traced window: torch.profiler over the traffic, read into records.

``traced(fn)`` runs ``fn()`` under ``torch.profiler`` (CPU and CUDA
activities) inside a ``bench.window`` range, and reads the trace with the
profiler's own event accessors:

* ``kernel_s``: device seconds by kernel name, and ``copy_s`` those of
  memory copies and sets, inside the window;
* ``busy_s``: the union of every device interval (kernels, copies,
  sets), so that overlapping work counts once; ``window_s``: the window
  range's length;
* ``breakdown``: the ten device operations that took most time, and the
  idle gaps between device intervals summed by what the host was doing
  at each gap's middle (the innermost host range or operation there).
"""
from __future__ import annotations

import bisect
from typing import Callable, Dict, List, Tuple

import torch
from torch.profiler import ProfilerActivity, profile, record_function

WINDOW = "bench.window"
# kernel names by the port's hand-written kernel they belong to
KERNELS = {
    "K1": ("log_mel_cluster",),
    "K2": ("attention_kernel", "attention_long_kernel"),
    "K3": ("igemm_sm90", "inception_gemm", "pool3x3x3", "avg_tail_finish"),
    "K4": ("pool1x1_sm90",),
    "K5": ("int8_conv_sm90", "int8_conv_dequant"),
    "K6": ("absmax_kernel", "quantize_cl_kernel", "quantize_nc_kernel",
           "unfold_kernel", "quantize_rows_kernel"),
}


def kernel_of(name: str) -> str:
    """K1-K6 for a hand-written kernel's name, "" for any other."""
    for k, parts in KERNELS.items():
        if any(p in name for p in parts):
            return k
    return ""


def _is_copy(name: str, activity: str) -> bool:
    low = name.lower()
    return ("memcpy" in activity or "memset" in activity
            or low.startswith("memcpy") or low.startswith("memset"))


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def _host_label(spans, starts, t: int) -> str:
    """The innermost host span covering ``t`` (the latest-starting one
    that has not ended), among the 4,000 that start last before it."""
    i = bisect.bisect_right(starts, t)
    for j in range(i - 1, max(-1, i - 4001), -1):
        s, e, name = spans[j]
        if e >= t:
            return name
    return "no host activity"


def read(prof) -> Dict:
    """The records of a profile that holds one ``bench.window`` range."""
    events = prof.profiler.kineto_results.events()
    window = None
    device: List[Tuple[int, int, str, bool]] = []
    host: List[Tuple[int, int, str]] = []
    for ev in events:
        name = ev.name()
        start, end = ev.start_ns(), ev.end_ns()
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            activity = str(getattr(ev, "activity_type", str)())
            if (not ev.is_user_annotation() and "annotation" not in activity
                    and end > start):
                device.append((start, end, name, _is_copy(name, activity)))
        elif name == WINDOW:
            window = (start, end)
        elif end > start:
            host.append((start, end, name))
    if window is None:
        raise RuntimeError("the trace has no bench.window range")
    w0, w1 = window
    device = [(max(s, w0), min(e, w1), n, c) for s, e, n, c in device
              if e > w0 and s < w1]
    if not device:
        raise RuntimeError("the profiler traced no device operation in "
                           "the window")
    kernel_s: Dict[str, float] = {}
    copy_s = 0.0
    for s, e, n, c in device:
        if c:
            copy_s += (e - s) / 1e9
        else:
            kernel_s[n] = kernel_s.get(n, 0.0) + (e - s) / 1e9
    busy = _union([(s, e) for s, e, _, _ in device])
    busy_s = sum(e - s for s, e in busy) / 1e9
    host.sort()
    starts = [s for s, _, _ in host]
    gaps: Dict[str, float] = {}
    edges = [(w0, w0)] + busy + [(w1, w1)]
    for (_, e0), (s1, _) in zip(edges, edges[1:]):
        if s1 > e0:
            label = _host_label(host, starts, (e0 + s1) // 2)
            gaps[label] = gaps.get(label, 0.0) + (s1 - e0) / 1e9
    by_op: Dict[str, float] = dict(kernel_s)
    if copy_s:
        by_op["memory copies and sets"] = copy_s
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
    return {"window_s": (w1 - w0) / 1e9, "busy_s": busy_s,
            "kernel_s": kernel_s, "copy_s": copy_s,
            "breakdown": {
                "device_ops": [[n[:120], v] for n, v in top],
                "idle_gaps": [[n[:120], v] for n, v in sorted(
                    gaps.items(), key=lambda kv: -kv[1])[:10]]}}


def traced(fn: Callable[[], object]) -> Tuple[object, Dict]:
    """``fn()`` under the profiler, inside the window range; returns its
    result and the trace's records."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            out = fn()
            torch.cuda.synchronize()
    return out, read(prof)


def span(name: str):
    """A host range of the harness, named ``bench.<name>``, that labels
    the device's idle gaps under it."""
    return record_function("bench." + name)
