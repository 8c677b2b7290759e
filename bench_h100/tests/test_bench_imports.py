"""Nothing the benchmark runs loads JAX or the JAX package; the reference
and the counts load nothing of the port either. Top-level module names
are compared whole: ``jmt_tpu_torch`` begins with ``jmt_tpu``."""
from __future__ import annotations

import json
import subprocess
import sys
import textwrap

from bench_h100 import run
from bench_h100.tests.tiny import ROOT

JAX = {"jax", "jaxlib", "flax", "jmt_tpu"}


def _top_level(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(code)], cwd=ROOT,
        capture_output=True, text=True, check=True, timeout=600)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_reference_and_counts_load_neither_jax_nor_the_port():
    names = _top_level(f"""
        import json, sys
        sys.path.insert(0, {str(ROOT)!r})
        import bench_h100.run, bench_h100.counts, bench_h100.control
        import bench_h100.reference.jmt, bench_h100.reference.train
        print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
        """)
    assert not names & (JAX | {"jmt_tpu_torch"})


def test_a_whole_run_loads_the_port_and_no_jax(tmp_path):
    names = _top_level(f"""
        import json, sys
        sys.path.insert(0, {str(ROOT)!r})
        from pathlib import Path
        from bench_h100 import run
        from bench_h100.lib.tree import Bench
        from bench_h100.tests import tiny
        root, data = tiny.tree(Path({str(tmp_path)!r}))
        out = run.run_cell(Bench(root, data), "flagship-serve-b8", 7, 0.5,
                           False, "cpu")
        assert out["correct"], out["checks"]
        print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
        """)
    assert "jmt_tpu_torch" in names
    assert not names & JAX


def test_banned_modules_compares_whole_names(monkeypatch):
    before = set(run.banned_modules())
    monkeypatch.setitem(sys.modules, "jmt_tpu_torch_extra", sys)
    assert set(run.banned_modules()) == before
    monkeypatch.setitem(sys.modules, "jmt_tpu.models", sys)
    assert "jmt_tpu" in run.banned_modules()
