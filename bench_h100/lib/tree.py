"""Find a cell's files by name.

``BENCHMARK.json`` at the root names the cells, configurations and
metrics. Everything else is found by name under the data directory
(``bench_h100/`` of the checkout, or another directory that holds the
same folders):

* ``workloads/<cell>.json``: the cell (configuration, traffic mix, chips,
  why, the seconds of its traced window, its correctness limits);
* ``configs/<config>.json`` (the file ``BENCHMARK.json`` gives): the
  model's constructor arguments, precision, inputs and source;
* ``traffic/<mix>.json``: the mix's parameters and the driver that
  generates it, ``traffic/<driver>.py`` (code, beside this package);
* ``metrics/<metric>.py``: each per-layer metric's reader (code).
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List

CODE = Path(__file__).resolve().parents[1]


def _load(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def module(kind: str, name: str) -> ModuleType:
    """``bench_h100/<kind>/<name>.py`` as a module (names may hold
    dots)."""
    path = CODE / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} code {path}")
    spec = importlib.util.spec_from_file_location(
        f"bench_h100.{kind}.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Bench:
    """One benchmark: ``root`` holds BENCHMARK.json, ``data`` the cell,
    configuration and traffic files (``root/bench_h100`` by default)."""

    def __init__(self, root: Path, data: Path = None):
        self.root = Path(root)
        self.data = Path(data) if data is not None else self.root / CODE.name
        self.spec = _load(self.root / "BENCHMARK.json")

    def _entry(self, key: str, name: str) -> Dict:
        for e in self.spec[key]:
            if e["name"] == name:
                return e
        raise KeyError(f"BENCHMARK.json has no {key} entry {name!r}")

    def cell(self, name: str) -> Dict:
        """The cell's file, checked against its BENCHMARK.json entry."""
        entry = self._entry("workloads", name)
        cell = _load(self.data / "workloads" / f"{name}.json")
        for k in ("config", "traffic", "chips"):
            if cell[k] != entry[k]:
                raise ValueError(f"cell {name}: {k} is {cell[k]!r} in its "
                                 f"file, {entry[k]!r} in BENCHMARK.json")
        return dict(cell, name=name)

    def config(self, name: str) -> Dict:
        return dict(_load(self.root / self._entry("configs", name)["file"]),
                    name=name)

    def mix(self, name: str) -> Dict:
        return dict(_load(self.data / "traffic" / f"{name}.json"), name=name)

    def metrics(self, kind: str, cell: str) -> List[Dict]:
        """The ``end_to_end`` or ``per_layer`` metrics the cell reports."""
        return [m for m in self.spec[kind]
                if cell in m.get("workloads", [cell])]
