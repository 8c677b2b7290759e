"""library_device_ms: device ms a request spends outside the hand-written
kernels K1-K6 and outside memory copies: cuDNN's convs, eval BN, casts,
pools, transposes. Moves serve_clips_per_s."""
from bench_h100.lib.trace import kernel_of


def read(rec):
    if not rec.get("units") or "kernel_s" not in rec:
        return None
    rest = sum(s for n, s in rec["kernel_s"].items() if not kernel_of(n))
    return 1e3 * rest / rec["units"]
