"""The port stands alone: no JAX and nothing of ``jmt_tpu`` at run time.

Also: ``chip_smoke.py`` refuses to run without a card or outside the
repository, printing no result.
"""
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "jmt_tpu_torch"


def test_importing_every_port_module_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import jmt_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "jmt_tpu_torch.__path__, 'jmt_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = [m for m in ('jax', 'jmt_tpu') if m in sys.modules]\n"
        "print(len(names), bad)\n"
        "sys.exit(1 if bad or len(names) < 18 else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_port_sources_name_no_jax_and_no_jmt_tpu_module():
    pattern = re.compile(r"^\s*(import|from)\s+jax\b|\bjmt_tpu\.",
                         re.MULTILINE)
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 18
    hits = [f"{f.relative_to(ROOT)}: {m.group(0)!r}" for f in files
            for m in pattern.finditer(f.read_text())]
    assert not hits, hits


def test_kernel_sources_exist_for_every_kernel_module():
    from jmt_tpu_torch.ops.kernels import build
    for name in build.SOURCES:
        assert (build.CSRC / f"{name}.cu").is_file()
        assert build.library_path(name).parent == build.BUILD_DIR


def test_chip_smoke_fails_alone_and_without_a_card(tmp_path):
    """Without the repository beside it (or here, without a card) the
    script exits non-zero and prints no result line."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
