"""What the serve drivers share: set-up, the timed or traced window, and
the check of every answer served against the reference.

Set-up (``prepare``): the run's distinct requests (host arrays, as a
client sends them), the server of the mix's bucket with the seed's
weights (static int8 calibrated on a request of its own first), two
requests through ``predict`` to warm the host path. The window runs
``loop(server, requests, order, seconds)``, which returns the answers it
got and its own numbers. After it: the peak memory, the server freed,
then the reference over every distinct request (``reference``), and the
seed's bf16 rounding noise that the gap is measured in (``noise_scale``).
"""
from __future__ import annotations

import gc
import time
from typing import Callable, Dict, List

import numpy as np
import torch

from bench_h100.lib import check, inputs, program, trace, weights

REQUESTS, CALIBRATION, ORDER = 1, 2, 4


def split(arrays: Dict[str, torch.Tensor], n: int, windows: int
          ) -> List[Dict]:
    return [{k: v[i * windows:(i + 1) * windows] for k, v in arrays.items()}
            for i in range(n)]


def order(seed: int, n: int) -> np.ndarray:
    """The order in which the seed sends the distinct requests."""
    rng = np.random.default_rng(inputs.stream_seed(seed, ORDER))
    return rng.permutation(n)


def predict(server, r: Dict):
    with trace.span("predict"):
        return server.predict(r["clips"], r["audio"], r["wavlm"])


def warm_profiler(fn: Callable[[], object], tries: int = 5) -> None:
    """Profile ``fn()`` until a trace holds device work: a process's
    first traces can come back empty."""
    for _ in range(tries):
        try:
            trace.traced(fn)
            return
        except RuntimeError:
            continue


def prepare(ctx, int8=None) -> Dict:
    """The requests, the calibration request, the weights (a copy on the
    host, for the reference) and the warmed server (``int8``: the
    configuration's mode unless given)."""
    cfg, mix, dev = ctx.config, ctx.mix, ctx.device
    inp, bucket = cfg["input"], mix["bucket"]
    n, wins = mix["distinct"], mix["windows"]
    host = [inputs.to_host(r) for r in split(
        inputs.windows(n * wins, inp, ctx.seed, REQUESTS, dev), n, wins)]
    calib = None
    if cfg["int8"] == "static":
        calib = inputs.to_host(inputs.windows(bucket, inp, ctx.seed,
                                              CALIBRATION, dev))
    t = time.perf_counter()
    w = weights.build(cfg, ctx.seed, dev)
    weights_s = time.perf_counter() - t
    server = program.build_server(cfg, bucket, w, dev, calib, int8)
    w = weights.to(w, "cpu")
    seq = order(ctx.seed, n)
    for i in range(2):
        predict(server, host[seq[i % n]])
    return {"server": server, "host": host, "calib": calib, "order": seq,
            "weights": w, "weights_s": weights_s}


def free(dev) -> None:
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def _on_device(ctx, got: Dict):
    def on(arrays):
        return {k: torch.from_numpy(v).to(ctx.device)
                for k, v in arrays.items()}
    calib = got["calib"]
    return [on(r) for r in got["host"]], None if calib is None else on(calib)


def reference(ctx, got: Dict, control: bool = False):
    """The reference's (V, A) of every distinct request of ``prepare``'s
    result (``control``: in the precision below the configuration's)."""
    requests, calib = _on_device(ctx, got)
    return check.reference_va(ctx.config, got["weights"], ctx.device,
                              requests, calib, control)


def noise_scale(ctx, got: Dict) -> float:
    """``check.noise_scale`` over every distinct request of ``prepare``'s
    result."""
    requests, calib = _on_device(ctx, got)
    return check.noise_scale(ctx.config, got["weights"], ctx.device,
                             requests, calib)


def run(ctx, loop: Callable) -> Dict:
    dev = ctx.device
    got = prepare(ctx)
    server, host = got["server"], got["host"]
    if ctx.trace:
        warm_profiler(lambda: predict(server, host[got["order"][0]]))
    if dev.type == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - ctx.t0
    seconds = min(ctx.seconds, ctx.cell["trace_seconds"]) if ctx.trace \
        else ctx.seconds
    records: Dict = {}
    if ctx.trace:
        out, records = trace.traced(lambda: loop(server, host, got["order"],
                                                 seconds))
    else:
        out = loop(server, host, got["order"], seconds)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    records.update(kind="serve", capture_s=program.capture_seconds(server),
                   units=len(out["served"]), service_s=out["service_s"])
    del server, got["server"]
    free(dev)
    ref = reference(ctx, got)
    scale = noise_scale(ctx, got)
    return {"setup_s": setup_s, "metrics": out["metrics"],
            "records": records, "memory_peak_bytes": peak,
            "attempted": len(out["served"]), "failed": 0,
            "numbers": {"va_gap_rel": check.va_gap_rel(out["served"], ref,
                                                       scale)},
            "notes": dict(out.get("notes", {}), weights_s=got["weights_s"],
                          va_gap=check.va_gap(out["served"], ref),
                          noise_scale=scale)}
