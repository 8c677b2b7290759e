"""Run one cell of the benchmark once and print its result line.

    python3 bench_h100/run.py --workload <cell> --seed <n> \\
        --seconds <run_seconds> --trace <0|1>

From the root of a checkout, on a machine with an NVIDIA card. The run
builds the cell's system from the seed (weights and inputs on the card),
warms it up (set-up, ``setup_s``), measures for ``--seconds`` (with
``--trace 1``: the cell's ``trace_seconds`` under torch.profiler, and the
per-layer metrics in place of the end-to-end ones), checks what the timed
path produced against the plain reference, and prints one JSON line as
the last line of standard output; the numbers compared go to standard
error too, each beside its limit. It exits non-zero without a result when
there is no card (or fewer than the cell asks for), when a module of JAX
or of the JAX package is loaded, or when a step fails. Caches (the
kernels' nvcc builds, Triton's) stay in ``build/`` of the checkout.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BANNED = ("jax", "jaxlib", "flax", "jmt_tpu")


@dataclasses.dataclass
class Context:
    """What a traffic driver gets: the cell's files, the run's arguments,
    the device and the process's start on the host clock."""
    cell: Dict
    config: Dict
    mix: Dict
    seed: int
    seconds: float
    trace: bool
    device: object
    t0: float


def banned_modules() -> List[str]:
    """Loaded modules of JAX or the JAX package, by whole top-level
    name."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(BANNED))


def cache_dirs(root: Path) -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the port's nvcc builds already go to ``build/jmt_tpu_torch``)."""
    cache = root / "build" / "bench_h100"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")


def run_cell(bench, name: str, seed: int, seconds: float, trace: bool,
             device, t0: Optional[float] = None) -> Dict:
    """One run of cell ``name`` of ``bench`` (``lib.tree.Bench``) on
    ``device``: the driver's result, with its checks, its end-to-end or
    per-layer metrics and the trace's device numbers."""
    import torch
    from bench_h100.lib import tree
    cell = bench.cell(name)
    ctx = Context(cell=cell, config=bench.config(cell["config"]),
                  mix=bench.mix(cell["traffic"]), seed=int(seed),
                  seconds=float(seconds), trace=bool(trace),
                  device=torch.device(device),
                  t0=T0 if t0 is None else t0)
    out = tree.module("traffic", ctx.mix["driver"]).run(ctx)
    limits = cell["limits"]
    out["checks"] = {k: {"value": v, "limit": limits[k]}
                     for k, v in out["numbers"].items()}
    out["correct"] = (out["failed"] == 0 and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in out["checks"].values()))
    metrics = {}
    if trace:
        from bench_h100 import counts
        records = dict(out["records"], config=ctx.config, mix=ctx.mix,
                       census=counts.census(ctx.config,
                                            ctx.mix.get("windows",
                                                        ctx.mix.get("batch"))))
        for m in bench.metrics("per_layer", name):
            value = tree.module("metrics", m["name"]).read(records)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(out["metrics"], setup_s=out["setup_s"])
        for m in bench.metrics("end_to_end", name):
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    out["metric_values"] = metrics
    return out


def result_line(out: Dict, kind: str, count: int) -> Dict:
    device = {"platform": "gpu", "kind": kind, "count": count,
              "memory_peak_bytes": int(out["memory_peak_bytes"])}
    line = {"correct": out["correct"], "attempted": out["attempted"],
            "failed": out["failed"], "metrics": out["metric_values"],
            "device": device}
    rec = out["records"]
    if "busy_s" in rec:
        device.update(busy_s=rec["busy_s"], window_s=rec["window_s"])
        line["breakdown"] = rec["breakdown"]
    line["checks"] = out["checks"]
    return line


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    cache_dirs(ROOT)
    import torch
    from bench_h100.lib import tree
    bench = tree.Bench(ROOT)
    chips = bench.cell(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"no result: cell {args.workload} needs {chips} CUDA "
              f"device(s), this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = run_cell(bench, args.workload, args.seed, args.seconds,
                   bool(args.trace), "cuda")
    banned = banned_modules()
    if banned:
        print(f"no result: the process loaded {banned}", file=sys.stderr)
        return 3
    line = result_line(out, torch.cuda.get_device_name(0), chips)
    print(json.dumps({"notes": out.get("notes", {})}), file=sys.stderr)
    for k, c in out["checks"].items():
        print(f"check {k} = {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
