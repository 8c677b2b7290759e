"""Closed-loop serving: one client sends its next request when the last
returns.

Mix parameters: ``bucket`` (the server's one bucket), ``windows`` (per
request), ``distinct`` (requests drawn from the seed, sent in the seed's
order, cycled). End-to-end metric ``serve_clips_per_s``: every clip of
every request completed in the window over the window, from its start to
the last completion. Each request pays its copies in and out
(``InferenceServer.predict`` takes and returns host arrays).
"""
from __future__ import annotations

import time

import numpy as np

from bench_h100.lib import serving


def loop(server, host, seq, seconds):
    served, service = [], []
    start = time.perf_counter()
    deadline, done, i = start + seconds, start, 0
    while time.perf_counter() < deadline:
        idx = int(seq[i % len(seq)])
        t = time.perf_counter()
        v, a = serving.predict(server, host[idx])
        done = time.perf_counter()
        served.append((idx, v, a))
        service.append(done - t)
        i += 1
    clips = sum(host[idx]["clips"].shape[0] * host[idx]["clips"].shape[1]
                for idx, _, _ in served)
    med = float(np.median(service))
    notes = {"service_ms_p50": 1e3 * med,
             "service_ms_max": 1e3 * max(service),
             "stall_s": sum(s - med for s in service if s > 1.25 * med)}
    return {"served": served, "service_s": service, "notes": notes,
            "metrics": {"serve_clips_per_s": clips / (done - start)}}


def run(ctx):
    return serving.run(ctx, loop)
