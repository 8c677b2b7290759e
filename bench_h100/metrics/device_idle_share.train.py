"""device_idle_share.train: % of the traced window in which the card ran
no kernel, copy or set (the union of the profiler's device intervals)."""
from bench_h100.lib.readers import device_idle_share


def read(rec):
    return device_idle_share(rec)
