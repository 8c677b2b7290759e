"""On the card: each cell's control, and the train cell's faults, fail
its limits while the program passes them, at the cell's own sizes but
8 windows of distinct requests, on one seed, so that a test run holds
it.

    python -m pytest --noconftest -p no:cacheprovider \\
        bench_h100/tests/test_bench_cuda.py -q

Skips without a card (decided inside the test)."""
from __future__ import annotations

import json
import time

import pytest
import torch

from bench_h100 import control
from bench_h100.lib import tree
from bench_h100.run import ROOT, Context, cache_dirs

CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]


def _fails(numbers, limits) -> bool:
    return any(numbers[k] > v for k, v in limits.items())


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_program_passes(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    cache_dirs(ROOT)
    bench = tree.Bench(ROOT)
    c = bench.cell(cell)
    mix = bench.mix(c["traffic"])
    train = mix["driver"] == "train_steps"
    if not train:
        mix = dict(mix, distinct=8 // mix["windows"])
    ctx = Context(cell=c, config=bench.config(c["config"]), mix=mix,
                  seed=2 ** 31 + 99, seconds=0, trace=False,
                  device=torch.device("cuda"), t0=time.perf_counter())
    fn = control.train_readings if train else control.serve_readings
    readings = dict(fn(ctx, True))
    limits = c["limits"]
    assert not _fails(readings.pop("program"), limits)
    judged = {k: v for k, v in readings.items()
              if k.startswith(("control:", "fault:"))}
    assert judged
    for what, numbers in judged.items():
        assert _fails(numbers, limits), what
