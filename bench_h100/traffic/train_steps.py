"""Train steps: the trainer's frozen-backbone step, back to back.

Mix parameters: ``batch`` (windows a step), ``distinct`` (batches drawn
from the seed on the card, with their labels and colour factors, cycled
in order), ``optimizer`` (SGD's lr, momentum, dampening, weight decay,
Nesterov: the trainer's defaults). Set-up builds the train state and the
step once, and drives it through its first three steps on batches 0-2,
keeping their losses, the momentum buffers after the first and the
trainable tensors after the third for the check; the window runs the
same step on the same state from step 4 on, reading each step's loss on
the host as the trainer does. End-to-end metric ``train_clips_per_s``:
every clip of every step completed in the window over the window.
"""
from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from bench_h100.lib import check, inputs, program, trace, weights
from bench_h100.lib.serving import free, warm_profiler
from bench_h100.reference import jmt

BATCHES, EXTRAS = 10, 30
STEP_KEYS = ("clips", "audio", "wavlm", "labels_v", "labels_a",
             "row_weight")
CHECKED_STEPS = 3
# the numbers a run compares (``check.train_numbers``), and those it reads
NUMBERS = ("va_gap", "update_gap")
READ = ("loss_gap", "grad_gap", "grad_gap_worst", "update_gap_worst",
        "worst", "leaves_compared")


def batches(ctx) -> List[Dict]:
    """The run's distinct batches on the device, with their labels, row
    weights and colour factors."""
    inp, b, dev = ctx.config["input"], ctx.mix["batch"], ctx.device
    return [dict(inputs.windows(b, inp, ctx.seed, BATCHES + i, dev),
                 **inputs.train_extras(b, inp["seq"], ctx.seed, EXTRAS + i,
                                       dev))
            for i in range(ctx.mix["distinct"])]


def prepare(ctx) -> Dict:
    """The batches, the state and its step, driven through the checked
    steps; ``one(i)`` runs step i (batch i, cycled) and reads its loss."""
    cfg, dev = ctx.config, ctx.device
    feed = batches(ctx)
    t = time.perf_counter()
    w = weights.build(cfg, ctx.seed, dev)
    weights_s = time.perf_counter() - t
    state, step = program.build_train(cfg, ctx.mix["optimizer"], w, dev)
    w = weights.to(w, "cpu")
    want = sorted(n for n, _, _ in jmt.layout(cfg["model"])
                  if jmt.trainable(n))
    got = sorted(state.trainable)
    if got != want:
        raise RuntimeError(f"the program trains other tensors than the "
                           f"reference: {sorted(set(got) ^ set(want))[:5]}")

    outputs = []

    def one(i):
        bt = feed[i % len(feed)]
        with trace.span("step"):
            loss, v, a = step(state, {k: bt[k] for k in STEP_KEYS},
                              color_factors=(bt["brightness"],
                                             bt["contrast"]))
            if i < CHECKED_STEPS:
                outputs.append((v.float().clone(), a.float().clone()))
            return float(loss)

    losses = [one(0)]
    first_buffers = program.momentum_buffers(state)
    losses += [one(i) for i in range(1, CHECKED_STEPS)]
    after = {n: t.detach().clone()
             for n, t in program.trainable_tensors(state).items()}
    return {"state": state, "step": step, "one": one, "batches": feed,
            "weights": w, "weights_s": weights_s, "outputs": outputs,
            "losses": losses, "first_buffers": first_buffers,
            "after": after}


def gaps(ctx, got: Dict) -> Dict:
    """The run's train numbers against the reference, and its losses."""
    before, ref = check.train_reference(ctx.config, ctx.mix["optimizer"],
                                        got["weights"], ctx.device,
                                        got["batches"], CHECKED_STEPS)
    return dict(check.train_numbers(before, ref, got["losses"],
                                    got["outputs"], got["first_buffers"],
                                    got["after"]),
                ref_losses=ref["losses"])


def run(ctx):
    dev, b, seq = ctx.device, ctx.mix["batch"], ctx.config["input"]["seq"]
    got = prepare(ctx)
    one = got["one"]
    if ctx.trace:
        warm_profiler(lambda: one(CHECKED_STEPS))
    if dev.type == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - ctx.t0
    seconds = min(ctx.seconds, ctx.cell["trace_seconds"]) if ctx.trace \
        else ctx.seconds

    step_s = []

    def loop():
        start = time.perf_counter()
        deadline, done, i = start + seconds, start, CHECKED_STEPS
        while time.perf_counter() < deadline:
            one(i)
            now = time.perf_counter()
            step_s.append(now - done)
            done = now
            i += 1
        return i - CHECKED_STEPS, done - start

    records = {}
    if ctx.trace:
        (steps, elapsed), records = trace.traced(loop)
    else:
        steps, elapsed = loop()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    records.update(kind="train", units=steps)
    del got["state"], got["step"], got["one"], one
    free(dev)
    g = gaps(ctx, got)
    return {"setup_s": setup_s,
            "metrics": {"train_clips_per_s": steps * b * seq / elapsed},
            "records": records, "memory_peak_bytes": peak,
            "attempted": steps, "failed": 0,
            "numbers": {k: g[k] for k in NUMBERS},
            "notes": {"step_ms_p50": float(np.percentile(step_s, 50)) * 1e3,
                      "weights_s": got["weights_s"],
                      "losses": got["losses"], "ref_losses": g["ref_losses"],
                      **{k: g[k] for k in READ}}}
