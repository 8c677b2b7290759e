"""Readings that the correctness limits are set from: the program's sound
runs, its controls and its faults, at a cell's own size, several seeds in
one process.

    python3 bench_h100/control.py --workload <cell> --seeds 1,2,3 \\
        [--controls 1,2,3]

One JSON line per reading on standard output: the cell, the seed, what
was read, and the numbers the cell compares.

* ``program``: what a run compares, of one pass over the distinct
  requests (a graph replay repeats bitwise, so a window's repeats compare
  the same answers), or of the first three train steps;
* ``control:fp8`` (bf16 configurations): the reference in the program's
  place computed in float8 e4m3 where the configuration states bf16
  (``reference.jmt.Fp8Ops``); ``control:int4`` (a static int8
  configuration): its int8 convs in int4 and the rest in e4m3
  (``reference.jmt.Int4Ops``);
* ``control:program_int8_dynamic``, ``control:program_int8_static`` (a
  bf16 configuration): the program with its own lower-precision path
  switched on, its eligible convs in int8;
* ``fault:half_batch`` (train cells): the program's step fed the first
  half of each batch's rows, its mean taken over them;
  ``info:program_float32``: the program computing in float32 against the
  float32 reference, a second witness.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def serve_readings(ctx, controls: bool):
    from bench_h100.lib import check, serving

    def answers(config):
        got = serving.prepare(dataclasses.replace(ctx, config=config))
        served = [(i, *serving.predict(got["server"], r))
                  for i, r in enumerate(got["host"])]
        del got["server"]
        serving.free(ctx.device)
        return served, got

    served, got = answers(ctx.config)
    ref = serving.reference(ctx, got)
    scale = serving.noise_scale(ctx, got)

    def numbers(answers):
        return {"va_gap_rel": check.va_gap_rel(answers, ref, scale),
                "va_gap": check.va_gap(answers, ref), "noise_scale": scale}

    out = [("program", numbers(served))]
    if not controls:
        return out
    low = serving.reference(ctx, got, control=True)
    name = "int4" if ctx.config["int8"] == "static" else "fp8"
    out.append((f"control:{name}",
                numbers([(i, v, a) for i, (v, a) in enumerate(low)])))
    if not ctx.config["int8"]:
        for mode, name in ((True, "dynamic"), ("static", "static")):
            served, _ = answers(dict(ctx.config, int8=mode))
            out.append((f"control:program_int8_{name}", numbers(served)))
    return out


def train_readings(ctx, controls: bool):
    from bench_h100.lib import check, weights
    from bench_h100.lib.serving import free
    from bench_h100.reference import jmt
    from bench_h100.traffic import train_steps as ts
    from jmt_tpu_torch.train import loops
    keys = ts.NUMBERS + ts.READ

    def program_numbers(c):
        got = ts.prepare(c)
        del got["state"], got["step"], got["one"]
        free(c.device)
        return {k: v for k, v in ts.gaps(c, got).items() if k in keys}

    out = [("program", program_numbers(ctx))]
    if not controls:
        return out
    out.append(("info:program_float32", program_numbers(dataclasses.replace(
        ctx, config=dict(ctx.config, compute_dtype="float32")))))
    made = loops.make_train_step

    def half_batch(model, *a, **kw):
        step = made(model, *a, **kw)

        def broken(state, arrays, generator=None, color_factors=None, **k):
            b = arrays["labels_v"].shape[0] // 2
            s = arrays["labels_v"].shape[1]
            return step(state, {n: v[:b] for n, v in arrays.items()},
                        generator, tuple(f[:b * s] for f in color_factors),
                        **k)
        return broken

    loops.make_train_step = half_batch
    try:
        out.append(("fault:half_batch", program_numbers(ctx)))
    finally:
        loops.make_train_step = made
    batches = ts.batches(ctx)
    w = weights.to(weights.build(ctx.config, ctx.seed, ctx.device), "cpu")
    before, ref = check.train_reference(ctx.config, ctx.mix["optimizer"], w,
                                        ctx.device, batches)
    _, low = check.train_reference(ctx.config, ctx.mix["optimizer"], w,
                                   ctx.device, batches, ops=jmt.Fp8Ops())
    n = check.train_numbers(before, ref, low["losses"], low["outputs"],
                            low["first_buffers"], low["params"])
    out.append(("control:fp8", {k: v for k, v in n.items() if k in keys}))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--controls", default="")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from bench_h100.run import Context, cache_dirs
    cache_dirs(ROOT)
    import torch
    from bench_h100.lib import tree
    bench = tree.Bench(ROOT)
    cell = bench.cell(args.workload)
    controls = {int(s) for s in args.controls.split(",") if s}
    seeds = [int(s) for s in args.seeds.split(",") if s]
    for seed in seeds + sorted(controls - set(seeds)):
        ctx = Context(cell=cell, config=bench.config(cell["config"]),
                      mix=bench.mix(cell["traffic"]), seed=seed, seconds=0,
                      trace=False, device=torch.device("cuda"),
                      t0=time.perf_counter())
        fn = train_readings if ctx.mix["driver"] == "train_steps" \
            else serve_readings
        for what, numbers in fn(ctx, seed in controls):
            print(json.dumps({"cell": args.workload, "seed": seed,
                              "what": what, **numbers,
                              "s": time.perf_counter() - ctx.t0}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
