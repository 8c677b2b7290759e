"""A benchmark tree at a size the CPU runs in seconds: the repo's
BENCHMARK.json and cell files, with the configurations cut to 32 px
clips (I3D at 64, so the stem fold still applies), 2 timesteps and
float32, and each mix to one window a request or two a batch."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
CODE = ROOT / "bench_h100"


def model(**kw) -> dict:
    """The flagship's constructor arguments at the tiny size."""
    cfg = json.loads((CODE / "configs" / "jmt-flagship-bf16.json")
                     .read_text())
    return dict(cfg["model"], **dict({"i3d_input_size": 64}, **kw))


def tree(tmp: Path, dtype: str = "float32"):
    """(root, data) of a tiny copy of the benchmark under ``tmp``."""
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    data = tmp / "data"
    for d in ("workloads", "configs", "traffic"):
        (data / d).mkdir(parents=True, exist_ok=True)
    for c in spec["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        cfg["model"]["i3d_input_size"] = 64
        cfg["input"].update(seq=2, size=32)
        cfg["compute_dtype"] = dtype
        c["file"] = str(data / "configs" / f"{c['name']}.json")
        Path(c["file"]).write_text(json.dumps(cfg))
    for w in spec["workloads"]:
        shutil.copy(CODE / "workloads" / f"{w['name']}.json",
                    data / "workloads")
        mix = json.loads((CODE / "traffic" / f"{w['traffic']}.json")
                         .read_text())
        if mix["driver"] == "train_steps":
            mix.update(batch=2, distinct=4)
        else:
            mix.update(bucket=1, windows=1, distinct=2)
        if "rate_per_s" in mix:
            mix["rate_per_s"] = 3.0
        (data / "traffic" / f"{w['traffic']}.json").write_text(
            json.dumps(mix))
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec))
    return tmp, data
