"""Arithmetic the per-layer metric readers share. Each reader returns
None where the run's records hold nothing for it to read."""
from __future__ import annotations

from typing import Dict, Optional

from bench_h100.lib.trace import kernel_of


def device_idle_share(rec: Dict) -> Optional[float]:
    """% of the traced window in which no kernel, copy or set ran."""
    if not rec.get("window_s"):
        return None
    return 100.0 * (1.0 - rec["busy_s"] / rec["window_s"])


def kernel_seconds(rec: Dict, kernel: str) -> float:
    """Device seconds of one hand-written kernel (K1-K6) in the window."""
    return sum(s for n, s in rec.get("kernel_s", {}).items()
               if kernel_of(n) == kernel)


def roofline(rec: Dict, kernel: str, bound_s: float) -> Optional[float]:
    """% of its least time that the kernel reached: the units' summed
    bound over the kernel's device time in the window."""
    t = kernel_seconds(rec, kernel)
    if t <= 0 or not rec.get("units") or bound_s <= 0:
        return None
    return 100.0 * rec["units"] * bound_s / t
