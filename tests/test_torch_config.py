"""The port's config system against the JAX package's.

``Config.to_dict()`` is equal on both sides for the repo's
``config.json``, a reference-style dict with legacy ``opt__*`` keys, the
reference README's fusion-training command line parsed verbatim by both
CLIs, the passthrough forms and ``apply_overrides`` in its prefix forms.
Invalid lattices are rejected on both sides (JAX asserts, the port raises
``ValueError``). ``ExperimentDir`` has the same lifecycle. The ``.yml``
files the port writes are JSON text that ``yaml.safe_load`` and the JAX
``Config.from_file`` read, and the port reads a JAX-written
``final_config.yml``.
"""
import json
import os
import sys
import warnings
from pathlib import Path

import pytest
import yaml

from jmt_tpu import cli as jcli
from jmt_tpu.core import config as jconfig
from jmt_tpu_torch import cli
from jmt_tpu_torch.core import config

ROOT = Path(__file__).resolve().parents[1]


def reference_style_dict():
    # the shape of the reference's config_file.json, legacy opt__ keys
    return {
        "exp_id": "t1",
        "outd": "exps",
        "dataset_rootpath": "/data/frames",
        "train_params": {"labelpath": "/data/train", "take_n_videos": -1,
                         "seq_length": 512, "subseq_length": 32,
                         "stride": 1, "dilation": 4,
                         "loader_params": {"batch_size": 8, "shuffle": False,
                                           "num_workers": 2,
                                           "pin_memory": False}},
        "val_params": {"labelpath": "/data/val", "seq_length": 256,
                       "subseq_length": 32, "stride": 1, "dilation": 4},
        "test_params": {"labelpath": "/data/test"},
        "model_params": {
            "intra_modal_fusion": "None",
            "output_format": "SELF_ATTEN",
            "joint_modalities": "TRANSFORMER",
            "l_vision_backbones": "R2D1",
            "l_audio_backbones": "ResNet18",
            "R2D1_ft_dim_reduce": "FLATTEN",
            "num_layers": 1, "num_heads": 1,
            "opt__name_optimizer": "sgd",
            "opt__lr": 1e-4,
            "opt__name_lr_scheduler": "mystep",
            "opt__step_size": 100, "opt__gamma": 0.1,
            "opt__nesterov": "True",
        },
        "Mode": "Training", "SEED": 0, "goal": "TRAINING",
    }


# the reference README's fusion-training command (README.MD:75-115)
README_ARGV = [
    "--opt__name_optimizer", "sgd",
    "--opt__lr", "0.0001",
    "--opt__weight_decay", "0.0",
    "--opt__name_lr_scheduler", "mystep",
    "--opt__step_size", "100",
    "--opt__gamma", "0.1",
    "--v_dropout", "0.0",
    "--a_dropout", "0.0",
    "--num_heads", "1",
    "--num_layers", "1",
    "--freeze_vision_R2D1", "True",
    "--freeze_vision_I3D", "True",
    "--freeze_audio_ResNet18", "True",
    "--split", "DEFAULT",
    "--l_vision_backbones", "R2D1",
    "--l_audio_backbones", "wavLM+ResNet18",
    "--init_w_R2D1", "RANDOM",
    "--init_w_I3D", "RANDOM",
    "--init_w_ResNet18", "RANDOM",
    "--goal", "TRAINING",
    "--train_params__take_n_videos", "2",
    "--val_params__take_n_videos", "2",
    "--R2D1_ft_dim_reduce", "MAX",
    "--joint_modalities", "TRANSFORMER",
    "--dump_best_model_every_time", "True",
    "--output_format", "SELF_ATTEN",
    "--intra_modal_fusion", "encoder_plus_self_attention",
    "--max_epochs", "1",
    "--train_params__seq_length", "512",
    "--train_params__subseq_length", "32",
    "--train_params__stride", "1",
    "--train_params__dilation", "4",
    "--train_params__batch_size", "32",
    "--train_params__num_workers", "16",
    "--train_params__pin_memory", "True",
    "--train_params__shuffle", "True",
    "--train_params__use_more_vision_data_augm", "False",
    "--train_params__use_more_audio_data_augm", "False",
    "--val_params__num_workers", "8",
    "--SEED", "0",
    "--Mode", "Training",
    "--exp_id", "03_09_2024_10_20_28_318104__2676163",
]

ARGVS = {
    "config_json": ["--config", str(ROOT / "config.json")],
    "readme": README_ARGV,
    "readme_on_config_json": ["--config", str(ROOT / "config.json")]
    + README_ARGV,
    "passthrough": ["--num_heads=2", "--opt__lr=0.01", "--set", "SEED=3",
                    "--set", "model_params.opt.momentum=0.5"],
    "flagship": ["--config", str(ROOT / "config.json"),
                 "--l_vision_backbones", "R2D1+I3D",
                 "--l_audio_backbones", "ResNet18+wavLM",
                 "--intra_modal_fusion", "encoder_plus_self_attention",
                 "--output_format", "SELF_ATTEN",
                 "--i3d_fused_inception", "True",
                 "--train_params__batch_size", "8",
                 "--val_params__batch_size", "8", "--max_epochs", "2",
                 "--preempt_save_steps", "3", "--outd", "build/x"],
}


@pytest.mark.parametrize("name", sorted(ARGVS))
def test_command_lines_give_the_jax_config(name):
    argv = ARGVS[name]
    want = jcli.build_config(jcli.parse_args(argv)).to_dict()
    got = cli.build_config(cli.parse_args(argv)).to_dict()
    assert got == want


def test_from_dict_and_overrides_give_the_jax_config():
    d = reference_style_dict()
    assert (config.Config.from_dict(d).to_dict()
            == jconfig.Config.from_dict(d).to_dict())
    overrides = {
        "opt__lr": 5e-3,
        "train_params__loader_params__batch_size": 4,
        "model_params.num_heads": 4,
        "num_layers": 2,
        "freeze_vision_R2D1": False,
        "l_audio_backbones": "wavLM,ResNet18",
        "init_w_ResNet18": "IMAGENET",
        "intra_modal_fusion": "encoder_plus_self_attention",
        "train_params__batch_size": 6,
        "train_params__num_workers": 2,
        "val_params__shuffle": False,
        "train_params__take_n_videos": 3,
        "goal": "TRAINING",
        "SEED": 7,
    }
    d2 = config.apply_overrides(d, overrides)
    assert d2 == jconfig.apply_overrides(d, overrides)
    cfg = config.Config.from_dict(d2)
    assert cfg.to_dict() == jconfig.Config.from_dict(d2).to_dict()
    assert cfg.model_params.l_audio_backbones == ["wavLM", "ResNet18"]
    assert cfg.train_params.loader_params.batch_size == 6
    assert cfg.val_params.seq_length == 512       # synced to train's


@pytest.mark.parametrize("change", [
    {"joint_modalities": "NONE", "output_format": "SELF_ATTEN"},
    {"l_vision_backbones": "R2D1,I3D", "intra_modal_fusion": "None"},
    {"l_audio_backbones": "None"},
    {"l_vision_backbones": "C3D"},
    {"compute_dtype": "float16"},
    {"v_dropout": 1.0},
    {"opt__name_optimizer": "rmsprop"},
])
def test_invalid_configs_are_rejected_on_both_sides(change):
    d = reference_style_dict()
    d["model_params"].update(change)
    with pytest.raises(AssertionError):
        jconfig.Config.from_dict(d)
    with pytest.raises(ValueError):
        config.Config.from_dict(d)


def test_unknown_keys_warn_on_both_sides():
    d = dict(reference_style_dict(), cudaid=0, typo_key=1)
    for side in (jconfig, config):
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            side.Config.from_dict(d)
        msgs = [str(x.message) for x in w]
        assert any("typo_key" in m for m in msgs), msgs
        assert not any("cudaid" in m for m in msgs), msgs


def test_experiment_dir_lifecycle(tmp_path):
    """The same files on both sides; the port's are JSON text that YAML
    and the JAX package read back."""
    d = dict(reference_style_dict(), outd=str(tmp_path / "port"))
    exps = {"port": config.ExperimentDir(config.Config.from_dict(d)),
            "jax": jconfig.ExperimentDir(jconfig.Config.from_dict(
                dict(d, outd=str(tmp_path / "jax"))))}
    perfs = {"best": {"avg": 0.25, "epoch": 1}, "tracker": {"v": [0.5]}}
    for exp in exps.values():
        assert not exp.already_done()
        exp.create(argv=["python", "main.py"])
        assert os.path.isdir(exp.weights_dir)
        with open(exp.preempted_marker, "w") as f:
            f.write("x\n")
        exp.finalize(perfs)
        assert exp.already_done() and not os.path.exists(
            exp.preempted_marker)
    names = {k: sorted(os.listdir(e.path)) for k, e in exps.items()}
    assert names["port"] == names["jax"]
    port = Path(exps["port"].path)
    for name in ("config.yml", "final_config.yml", "perfs.yml"):
        text = (port / name).read_text()
        assert yaml.safe_load(text) == json.loads(text)
    assert json.loads((port / "perfs.yml").read_text()) == perfs
    assert (port / "cmd.sh").read_text() == \
        (Path(exps["jax"].path) / "cmd.sh").read_text()
    final = str(port / "final_config.yml")
    assert (jconfig.Config.from_file(final).to_dict()
            == config.Config.from_file(final).to_dict()
            == config.Config.from_dict(d).to_dict())


def test_port_reads_a_jax_written_final_config(tmp_path):
    d = reference_style_dict()
    d["model_params"]["l_audio_backbones"] = "wavLM+ResNet18"
    d["model_params"]["intra_modal_fusion"] = "feat_concat_fc"
    jcfg = jconfig.Config.from_dict(d)
    path = str(tmp_path / "final_config.yml")
    jcfg.save_yaml(path)
    with pytest.raises(json.JSONDecodeError):
        json.loads(Path(path).read_text())        # real YAML, not JSON
    assert config.Config.from_file(path).to_dict() == jcfg.to_dict()


def test_yaml_file_without_pyyaml_names_the_file(tmp_path, monkeypatch):
    path = tmp_path / "c.yml"
    path.write_text("exp_id: a\nSEED: 3\n")
    assert config.read_yaml_or_json(str(path)) == {"exp_id": "a", "SEED": 3}
    monkeypatch.setitem(sys.modules, "yaml", None)
    with pytest.raises(ImportError, match="c.yml"):
        config.read_yaml_or_json(str(path))
    (tmp_path / "j.yml").write_text('{"exp_id": "b"}')
    assert config.read_yaml_or_json(str(tmp_path / "j.yml")) == {
        "exp_id": "b"}


def test_auto_set_label_paths_matches_jax(tmp_path):
    for fold in ("fold2", ""):
        for sub in ("Train_Set", "Val_Set", "Test_Set"):
            os.makedirs(tmp_path / "ann" / fold / sub, exist_ok=True)
    d = reference_style_dict()
    for split in ("train_params", "val_params", "test_params"):
        d[split]["labelpath"] = ""
    for extra in ({"split": "DEFAULT",
                   "dataset_annotations": str(tmp_path / "ann")},
                  {"split": "ROUND2",
                   "dataset_annotations_5folds": str(tmp_path / "ann")}):
        cfgs = [side.Config.from_dict(dict(d, **extra))
                for side in (jconfig, config)]
        for cfg in cfgs:
            cfg.auto_set_label_paths()
        assert cfgs[0].to_dict() == cfgs[1].to_dict()
        assert cfgs[1].val_params.labelpath.endswith("Val_Set")


def test_cli_flags_and_errors():
    args = cli.parse_args(["--num_heads=2", "--device", "cpu",
                           "--mode", "Eval", "--fd_exp", "e",
                           "--eval_set", "test"])
    assert args.device == "cpu" and args.exp_dir == "e"
    assert args.eval_split == "test" and "num_heads=2" in args.set
    for bad in (["--num_heads"], ["stray"]):
        with pytest.raises(SystemExit):
            cli.parse_args(bad)
    with pytest.raises(SystemExit, match="no dataset configured"):
        cli.make_datasets(config.Config(), synthetic=None)
    with pytest.raises(SystemExit, match="JAX package's command line"):
        cli.main(["--export-pt", "somewhere"])
