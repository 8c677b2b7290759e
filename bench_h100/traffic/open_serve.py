"""Open-loop serving: requests arrive on a fixed schedule, whether or not
the server is free.

Mix parameters: ``bucket``, ``windows``, ``distinct`` (as for
``closed_serve``), ``rate_per_s`` and ``arrival_seed``. The arrivals are
a Poisson process at the fixed rate, drawn from the mix's own
``arrival_seed``, so that every run's seed sees the same schedule (the
tail of a queue depends on where the bursts fall far more than on
anything else); the run's seed draws the requests and the order in which
they go to the arrivals. The server is single-threaded: a request waits
in the client's FIFO while the one before it runs. End-to-end metric
``request_p95_ms``: the 95th percentile (linear interpolation) over every
request due in the window of its time from when it was due to its
return. The queue drains after the window closes.
"""
from __future__ import annotations

import time

import numpy as np

from bench_h100.lib import serving, trace


def schedule(rate: float, seconds: float, seed: int) -> np.ndarray:
    """Due times, seconds from the window's start, of a Poisson process."""
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate, size=int(rate * seconds * 3) + 100)
    due = np.cumsum(gaps)
    return due[due < seconds]


def make_loop(rate: float, arrival_seed: int):
    def loop(server, host, seq, seconds):
        served, service, latency, late = [], [], [], 0.0
        start = time.perf_counter()
        for i, d in enumerate(schedule(rate, seconds, arrival_seed)):
            target = start + float(d)
            now = time.perf_counter()
            if now < target:
                with trace.span("wait"):
                    time.sleep(target - now)
            idx = int(seq[i % len(seq)])
            t = time.perf_counter()
            late = max(late, t - target)
            v, a = serving.predict(server, host[idx])
            done = time.perf_counter()
            served.append((idx, v, a))
            service.append(done - t)
            latency.append(done - target)
        return {"served": served, "service_s": service,
                "metrics": {"request_p95_ms":
                            float(np.percentile(latency, 95)) * 1e3},
                "notes": {"requests": len(latency),
                          "latency_p50_ms":
                          float(np.percentile(latency, 50)) * 1e3,
                          "queue_wait_max_ms": late * 1e3,
                          "service_ms_p50":
                          float(np.percentile(service, 50)) * 1e3,
                          "service_ms_mean": float(np.mean(service)) * 1e3}}
    return loop


def run(ctx):
    return serving.run(ctx, make_loop(float(ctx.mix["rate_per_s"]),
                                      int(ctx.mix["arrival_seed"])))
