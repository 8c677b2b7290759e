"""The harness on the CPU at a tiny size: every cell runs and is correct,
a new cell needs only data files, the checks catch the faults a cell can
have, a machine without a card gets no result, and BENCHMARK.json keeps
to its contract."""
from __future__ import annotations

import json
import math
import re

import numpy as np
import pytest

from bench_h100 import run
from bench_h100.lib import tree
from bench_h100.tests import tiny

SPEC = json.loads((tiny.ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]
SEED = 2 ** 31 + 5


@pytest.fixture
def bench(tmp_path):
    return tree.Bench(*tiny.tree(tmp_path))


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_runs_and_is_correct(bench, cell):
    out = run.run_cell(bench, cell, SEED, 1.0, False, "cpu")
    assert out["correct"], out["checks"]
    want = {m["name"] for m in SPEC["end_to_end"]
            if cell in m.get("workloads", [cell])}
    assert set(out["metric_values"]) == want
    assert all(v["value"] > 0 for v in out["metric_values"].values())
    line = run.result_line(out, "cpu", 1)
    assert list(line)[-1] == "checks"
    assert set(line["checks"]) == set(bench.cell(cell)["limits"])


def test_a_new_cell_needs_only_files(bench):
    """A throwaway cell in the data directory: a new traffic mix, the
    existing driver and configuration."""
    (bench.data / "traffic" / "closed-b1-extra.json").write_text(json.dumps(
        {"driver": "closed_serve", "bucket": 1, "windows": 1,
         "distinct": 3}))
    cell = {"config": "jmt-flagship-bf16", "traffic": "closed-b1-extra",
            "chips": 1, "why": "a throwaway cell", "trace_seconds": 1,
            "limits": {"va_gap_rel": 4.0}}
    (bench.data / "workloads" / "extra.json").write_text(json.dumps(cell))
    bench.spec["workloads"].append({"name": "extra", "config": cell["config"],
                                    "traffic": cell["traffic"], "chips": 1,
                                    "why": cell["why"]})
    out = run.run_cell(bench, "extra", SEED, 0.5, False, "cpu")
    assert out["correct"]
    assert set(out["metric_values"]) == {"setup_s"}
    assert out["attempted"] >= 1


def _altered_answer(monkeypatch):
    from jmt_tpu_torch.serve import InferenceServer
    real = InferenceServer.predict

    def predict(self, *a, **k):
        v, a_ = real(self, *a, **k)
        v = v.copy()
        v[0, 0] += 0.05
        return v, a_
    monkeypatch.setattr(InferenceServer, "predict", predict)


def _half_batch(monkeypatch):
    from jmt_tpu_torch.train import loops
    made = loops.make_train_step

    def make(model, *a, **k):
        step = made(model, *a, **k)

        def half(state, arrays, generator=None, color_factors=None, **kw):
            b, s = arrays["labels_v"].shape[0] // 2, arrays["labels_v"].shape[1]
            return step(state, {n: v[:b] for n, v in arrays.items()},
                        generator, tuple(f[:b * s] for f in color_factors),
                        **kw)
        return half
    monkeypatch.setattr(loops, "make_train_step", make)


def _unchanged_state(monkeypatch):
    import torch
    monkeypatch.setattr(torch.optim.SGD, "step", lambda self, closure=None:
                        None)


@pytest.mark.parametrize("cell,fault", [
    ("flagship-serve-b8", _altered_answer),
    ("flagship-serve-b1-open", _altered_answer),
    ("flagship-train-b8", _half_batch),
    ("flagship-train-b8", _unchanged_state),
])
def test_a_broken_timed_path_is_not_correct(bench, monkeypatch, cell, fault):
    fault(monkeypatch)
    out = run.run_cell(bench, cell, SEED, 0.5, False, "cpu")
    assert not out["correct"], out["checks"]


def test_no_card_no_result(capsys):
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    rc = run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1"])
    assert rc != 0
    assert capsys.readouterr().out == ""


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_benchmark_json_keeps_to_the_contract():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert 1 <= SPEC["run_seconds"] <= 51
    assert SPEC["paths"] == ["bench_h100"]
    names = [c["name"] for c in SPEC["configs"]]
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (tiny.ROOT / c["file"]).is_file() and c["reduced"] == []
        assert any(w["config"] == c["name"] for w in SPEC["workloads"])
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    for n in names + CELLS + [m["name"] for m in metrics]:
        assert NAME.match(n), n
    assert len(set(CELLS)) == len(CELLS)
    assert len({m["name"] for m in metrics}) == len(metrics)
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and w["config"] in names
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        cell = json.loads((tiny.CODE / "workloads" /
                           f"{w['name']}.json").read_text())
        mix = json.loads((tiny.CODE / "traffic" /
                          f"{w['traffic']}.json").read_text())
        assert (tiny.CODE / "traffic" / f"{mix['driver']}.py").is_file()
        assert all(cell[k] == w[k] for k in ("config", "traffic", "chips"))
        reported = [m for m in metrics if w["name"] in m.get("workloads",
                                                            [w["name"]])]
        e2e = {m["name"] for m in reported if "bound" in m}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any("layer" in m for m in reported)
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25 and math.isfinite(m["bound"])
    e2e_names = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e_names
        assert (tiny.CODE / "metrics" / f"{m['name']}.py").is_file()
        moved = next(e for e in SPEC["end_to_end"] if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads", CELLS))
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    assert len(json.dumps(SPEC).encode()) <= 64 * 1024


def test_percentile_of_the_open_loop_is_over_every_request():
    from bench_h100.traffic import open_serve
    due = open_serve.schedule(19.0, 20.0, 18)
    assert np.all(np.diff(due) > 0) and due[-1] < 20.0
    assert 300 < len(due) < 460     # about 19 a second
    assert np.array_equal(due, open_serve.schedule(19.0, 20.0, 18))
