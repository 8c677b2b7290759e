"""The port stands alone: no JAX and nothing of ``jmt_tpu`` at run time.

Also: every port module imports, the CLI trains a tiny epoch on the
CPU and the server serves a trained experiment (raw audio through a WavLM
checkpoint), with the packages the card's machine lacks blocked; the
serving entry points default to the card and raise without one;
``chip_smoke.py`` refuses to run without a card or outside the repository,
printing no result.
"""
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "jmt_tpu_torch"


# the train and eval slice's modules and the trainer entry point's, which
# the walk must reach
TRAIN_SLICE_MODULES = tuple(f"jmt_tpu_torch.{m}" for m in (
    "ops.ccc", "ops.smoothing", "core.config", "train.optim", "train.state",
    "train.loops", "eval.stitch", "core.logging", "core.rng",
    "core.preempt", "core.checkpoint", "data.windowing", "data.audio_io",
    "data.datasets", "data.synthetic", "data.loader", "train.runner",
    "cli", "models.wavlm", "data.wavlm_extract", "serve"))
# what the card's machine does not install
ABSENT_THERE = ("yaml", "pandas", "PIL", "flax", "msgpack", "matplotlib",
                "transformers")


def test_importing_every_port_module_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import jmt_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "jmt_tpu_torch.__path__, 'jmt_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = [m for m in ('jax', 'jmt_tpu', 'transformers', 'flax') "
        "if m in sys.modules]\n"
        "missing = [m for m in %r if m not in names]\n"
        "print(len(names), bad, missing)\n"
        "sys.exit(1 if bad or missing or len(names) < 18 else 0)\n"
        % (TRAIN_SLICE_MODULES,))
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_port_sources_name_no_jax_and_no_jmt_tpu_module():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|transformers|flax)\b"
                         r"|\bjmt_tpu\.", re.MULTILINE)
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


def test_port_runs_without_the_packages_the_card_machine_lacks(tmp_path):
    """Every module imports and ``cli.main`` trains one tiny CPU epoch and
    evaluates it with yaml, pandas, PIL, flax, msgpack and matplotlib
    blocked (``sys.modules[name] = None``)."""
    code = (
        "import importlib, json, pkgutil, sys\n"
        "for name in %r: sys.modules[name] = None\n"
        "import jmt_tpu_torch\n"
        "for m in pkgutil.walk_packages(jmt_tpu_torch.__path__, "
        "'jmt_tpu_torch.'): importlib.import_module(m.name)\n"
        "from jmt_tpu_torch import cli\n"
        "common = ['--synthetic', '1:481:16', '--device', 'cpu']\n"
        "assert cli.main(['--config', 'config.json', '--l_audio_backbones',"
        " 'wavLM', '--joint_modalities', 'FC', '--compute_dtype', 'float32',"
        " '--train_params__batch_size', '2', '--val_params__batch_size', "
        "'2', '--train_params__stride', '480', '--max_epochs', '1', "
        "'--verbose', 'False', '--outd', %r] + common) == 0\n"
        "assert cli.main(['--mode', 'Eval', '--exp-dir', %r] + common) == 0\n"
        "bad = [m for m in ('jax', 'jmt_tpu') if m in sys.modules]\n"
        "sys.exit(1 if bad else 0)\n"
        % (ABSENT_THERE, str(tmp_path), str(tmp_path / "id_exp")))
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert (tmp_path / "id_exp" / "passed.txt").is_file()
    assert '"valid_ccc_v"' in proc.stdout


def test_server_runs_without_the_packages_the_card_machine_lacks(tmp_path):
    """With the same packages blocked: a tiny wavLM-only experiment
    trained by the CLI, then the serve command line on the CPU serving it
    raw audio through a WavLM checkpoint (hidden 768, narrow convs, one
    layer)."""
    wavlm_pt = str(tmp_path / "wavlm.pt")
    code = (
        "import sys, torch\n"
        "for name in %r: sys.modules[name] = None\n"
        "from jmt_tpu_torch import cli, serve\n"
        "from jmt_tpu_torch.models import wavlm\n"
        "assert cli.main(['--config', 'config.json', '--synthetic', "
        "'1:481:16', '--l_vision_backbones', 'None', '--l_audio_backbones', "
        "'wavLM', '--goal', 'PRETRAINING', '--compute_dtype', 'float32', "
        "'--train_params__batch_size', '2', '--val_params__batch_size', "
        "'2', '--train_params__stride', '480', '--val_params__stride', "
        "'480', '--max_epochs', '1', '--verbose', 'False', '--device', "
        "'cpu', '--outd', %r]) == 0\n"
        "cfg = wavlm.WavLMConfig(conv_dim=(16,) * 7, num_hidden_layers=1, "
        "intermediate_size=32)\n"
        "m = wavlm.init_parameters(wavlm.WavLMModel(cfg), "
        "torch.Generator().manual_seed(0))\n"
        "torch.save(m.state_dict(), %r)\n"
        "assert serve.main(['--exp-dir', %r, '--buckets', '1', "
        "'--wavlm-checkpoint', %r, '--device', 'cpu']) == 0\n"
        "bad = [m for m in ('jax', 'jmt_tpu') if m in sys.modules]\n"
        "sys.exit(1 if bad else 0)\n"
        % (ABSENT_THERE, str(tmp_path), wavlm_pt, str(tmp_path / "id_exp"),
           wavlm_pt))
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    stats = json.loads(proc.stdout.strip().splitlines()[-1])
    assert stats["buckets"]["1"]["relay"]["p50_ms"] > 0


def test_serving_entry_points_default_to_the_card(tmp_path, monkeypatch):
    import torch
    from jmt_tpu_torch import cli, serve
    from jmt_tpu_torch.data.wavlm_extract import WavLMExtractor
    from jmt_tpu_torch.models.wavlm import WavLMConfig, WavLMModel
    cfg = cli.build_config(cli.parse_args(["--config",
                                           str(ROOT / "config.json")]))
    cfg.save_yaml(str(tmp_path / "final_config.yml"))
    wavlm = WavLMModel(WavLMConfig(conv_dim=(8,) * 7, hidden_size=16,
                                   num_hidden_layers=1, num_attention_heads=2,
                                   intermediate_size=8))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: serve.WavLMFrontend(wavlm),
                 lambda: WavLMExtractor(wavlm),
                 lambda: serve.InferenceServer.from_experiment(str(tmp_path)),
                 lambda: serve.main(["--exp-dir", str(tmp_path)]),
                 lambda: serve.main(["--buckets", "1"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
