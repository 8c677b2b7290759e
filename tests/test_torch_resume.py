"""The port's trainer entry point on the CPU: checkpoints, preemption,
resume and the CLI's Training and Eval modes.

* ``train_state.pt`` round-trips the weights, the optimizer's momentum,
  the epoch and the runner's tracking, the plateau schedule included;
* a run preempted in the middle of its second epoch and resumed ends
  bit for bit where an uninterrupted 2-epoch ``fit`` ends: weights,
  momentum, tracker curves, best epoch and SavedWeights;
* ``cli.main`` trains with ``--device cpu`` and writes the experiment
  directory; a second run is a no-op; Eval reproduces the best epoch's
  valid CCC from the components and the last epoch's from the state,
  and writes the challenge files; without ``--device cpu`` on a host
  without a card it raises.

The configurations are small: R(2+1)D-18 at 16 px with wavLM features
and the FeatureConcatFC fusion (dropout 0.3, so the resumed steps must
also draw the same dropout masks), or ResNet-18 alone for the state
round trip.
"""
import json
import os

import pytest
import torch

from jmt_tpu_torch import cli
from jmt_tpu_torch.core import checkpoint as ckpt
from jmt_tpu_torch.core import preempt
from jmt_tpu_torch.train.runner import Runner

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SYNTHETIC = "3:481:16"


def _argv(outd, *extra):
    return ["--config", os.path.join(ROOT, "config.json"),
            "--l_audio_backbones", "wavLM", "--joint_modalities", "FC",
            "--v_dropout", "0.3", "--compute_dtype", "float32",
            "--train_params__batch_size", "2",
            "--val_params__batch_size", "2",
            "--test_params__batch_size", "2",
            "--train_params__stride", "480", "--opt__lr", "0.01",
            "--max_epochs", "2", "--verbose", "False",
            "--outd", str(outd), *extra]


def _runner(argv):
    cfg = cli.build_config(cli.parse_args(argv))
    train, val, test, store = cli.make_datasets(cfg, SYNTHETIC)
    return Runner(cfg, train, val, wavlm_store=store, test_ds=test,
                  device="cpu")


def _same_state(a, b):
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    oa, ob = a.state.optimizer.state_dict(), b.state.optimizer.state_dict()
    assert oa["param_groups"] == ob["param_groups"]
    assert oa["state"].keys() == ob["state"].keys() and oa["state"]
    for i in oa["state"]:
        assert torch.equal(oa["state"][i]["momentum_buffer"],
                           ob["state"][i]["momentum_buffer"]), i


def test_train_state_round_trip_with_plateau(tmp_path):
    argv = ["--l_vision_backbones", "None", "--l_audio_backbones",
            "ResNet18", "--goal", "PRETRAINING", "--compute_dtype",
            "float32", "--train_params__batch_size", "2",
            "--freeze_audio_ResNet18", "False", "--train_params__stride",
            "480", "--opt__name_lr_scheduler", "reduce_on_plateau",
            "--verbose", "False", "--outd", str(tmp_path)]
    a = _runner(argv)
    a.initialize()
    a.train_epoch(0)
    a.plateau.step(5.0)
    a.plateau.step(6.0)
    a.best = {"avg": 0.25, "epoch": 0, "valid_v": 0.5, "valid_a": 0.0}
    a.tracker["valid_v"].append(0.5)
    a.snapshot_best()
    a.state.epoch = 1
    a._save_state()
    b = _runner(argv)
    assert b.resume() and b.state.epoch == 1
    _same_state(a, b)
    assert (b.plateau.lr, b.plateau.num_bad, b.plateau.best) == \
        (a.plateau.lr, a.plateau.num_bad, a.plateau.best)
    assert a.plateau.num_bad == 2 and a.plateau.best < 5.0  # epoch loss
    assert b.best == a.best and b.tracker == a.tracker
    assert all(torch.equal(b._best_snapshot[k], v)
               for k, v in a._best_snapshot.items())
    assert b.cfg.model_params.start_epoch == 1


def test_profile_dir_gets_a_trace_of_steps_2_to_4(tmp_path):
    argv = ["--l_vision_backbones", "None", "--l_audio_backbones",
            "ResNet18", "--goal", "PRETRAINING", "--compute_dtype",
            "float32", "--train_params__batch_size", "1",
            "--train_params__stride", "480", "--profile_dir",
            str(tmp_path / "trace"), "--verbose", "False",
            "--outd", str(tmp_path)]
    r = _runner(argv)
    r.initialize()
    r.train_epoch(0)                              # 3 steps: 2 is traced
    trace = tmp_path / "trace" / "train_epoch0_steps2-4.json"
    assert json.loads(trace.read_text())["traceEvents"]
    assert r.last_timing["steps"] == 3


def test_mid_epoch_preemption_resumes_bit_for_bit(tmp_path):
    whole = _runner(_argv(tmp_path / "whole"))
    perfs = whole.fit()
    assert not perfs["preempted"] and whole.exp.already_done()

    argv = _argv(tmp_path / "cut", "--preempt_save_steps", "1")
    cut = _runner(argv)
    step = cut.train_step
    taken = []

    def preempting_step(*args, **kw):
        out = step(*args, **kw)
        taken.append(1)
        if len(taken) == 3:            # epoch 1, after its first step
            preempt.request()
        return out

    cut.train_step = preempting_step
    try:
        assert cut.fit()["preempted"]
    finally:
        preempt.clear()
    assert os.path.isfile(cut.exp.preempted_marker)
    assert not cut.exp.already_done()
    assert len(taken) == 3 and cut.state.epoch == 1

    resumed = _runner(argv)
    assert resumed.resume() and resumed._mid_epoch["step"] == 1
    perfs_resumed = resumed.fit()
    assert resumed.exp.already_done()
    assert not os.path.exists(resumed.exp.preempted_marker)
    _same_state(whole, resumed)
    assert perfs_resumed["best"] == perfs["best"]
    assert perfs_resumed["tracker"] == perfs["tracker"]
    for name in os.listdir(whole.exp.weights_dir):
        got = torch.load(os.path.join(resumed.exp.weights_dir, name),
                         weights_only=True)
        want = torch.load(os.path.join(whole.exp.weights_dir, name),
                          weights_only=True)
        if name == ckpt.STATE_FILE:
            got, want = got["model"], want["model"]
        assert all(torch.equal(got[k], want[k]) for k in want), name


def test_cli_trains_then_evaluates_on_the_cpu(tmp_path, capsys):
    argv = _argv(tmp_path) + ["--device", "cpu", "--synthetic", SYNTHETIC]
    assert cli.main(argv) == 0
    best = json.loads(capsys.readouterr().out.strip().splitlines()[-1])[
        "best"]
    exp = tmp_path / "id_exp"
    files = set(os.listdir(exp))
    assert {"config.yml", "final_config.yml", "perfs.yml", "passed.txt",
            "cmd.sh", "log.json", "log.txt", "SavedWeights"} <= files
    assert sorted(os.listdir(exp / "SavedWeights")) == [
        "all_backbones.pt", "fc_layer_for_audio_concat.pt", "fusion_w.pt",
        "train_state.pt", "vision_r2d1.pt"]
    perfs = json.loads((exp / "perfs.yml").read_text())
    assert perfs["best"] == best

    before = (exp / "SavedWeights" / "train_state.pt").stat().st_mtime_ns
    assert cli.main(argv) == 0                   # passed.txt: a no-op
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == \
        {"best": {}}
    assert (exp / "SavedWeights" / "train_state.pt").stat().st_mtime_ns \
        == before

    def evaluate(*extra):
        assert cli.main(["--mode", "Eval", "--exp-dir", str(exp),
                         "--synthetic", SYNTHETIC, "--device", "cpu",
                         *extra]) == 0
        return json.loads(capsys.readouterr().out.strip().splitlines()[-1])

    comp = evaluate("--eval-weights", "components")
    assert (comp["valid_ccc_v"], comp["valid_ccc_a"]) == \
        (best["valid_v"], best["valid_a"])
    state = evaluate("--eval-weights", "state")
    tracker = perfs["tracker"]
    assert (state["valid_ccc_v"], state["valid_ccc_a"]) == \
        (tracker["valid_v"][-1], tracker["valid_a"][-1])
    out = evaluate("--eval-split", "test")
    txts = sorted(os.listdir(out["test_predictions_dir"]))
    assert txts == ["synth000.txt", "synth001.txt", "synth002.txt"]
    lines = (exp / "test_predictions" / txts[0]).read_text().splitlines()
    assert lines[0] == "image_location,valence,arousal" and len(lines) == 482


def test_cli_raises_without_a_card_unless_asked_for_the_cpu(tmp_path,
                                                            monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(_argv(tmp_path) + ["--synthetic", SYNTHETIC])


def test_a_jax_trained_directory_names_the_converter(tmp_path):
    """A SavedWeights directory of the JAX package's .msgpack files raises
    with the conversion command, for components and for the state."""
    (tmp_path / "fusion_w.msgpack").write_bytes(b"\x80")
    (tmp_path / "train_state.msgpack").write_bytes(b"\x80")
    model = torch.nn.Linear(2, 2)
    with pytest.raises(FileNotFoundError, match="--export-pt"):
        ckpt.assemble_from_components(str(tmp_path), model)
    with pytest.raises(FileNotFoundError, match="--export-pt"):
        ckpt.restore_train_state(str(tmp_path), None)
