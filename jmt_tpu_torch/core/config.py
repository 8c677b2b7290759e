"""Config system: typed dataclasses mirroring the reference's config schema.

Counterpart of ``jmt_tpu/core/config.py``, with the same field names,
defaults, coercions and validation: ``LoaderParams``, ``SplitParams``,
``OptimParams`` (the reference's ``opt__*`` keys), ``ModelParams``,
``Config`` with ``validate_lattice`` (the reference's combination
asserts), ``auto_set_label_paths`` (its 5-fold split convention),
``from_dict`` / ``from_file`` / ``save_yaml``, ``apply_overrides`` (dotted
paths and the reference's prefix forms: ``opt__lr``,
``train_params__batch_size``, bare model-param flags) and
``ExperimentDir`` (``exps/id_<exp_id>``, ``passed.txt`` guard,
``preempted.txt`` marker, ``config.yml`` / ``final_config.yml`` /
``perfs.yml`` / ``cmd.sh``).

Invalid values raise ``ValueError`` (the JAX package asserts). The
``.yml`` files are written as JSON text, which is valid YAML, so the JAX
package and the reference read them with ``yaml.safe_load``; reading
tries JSON first and imports ``yaml`` only for a file that is not JSON.

Keys that only the XLA build reads (``xla_scoped_vmem_kib``,
``compilation_cache_dir``, ``mesh_dcn``) are accepted, so JAX and
reference configs load verbatim; they have no effect on CUDA.
"""
from __future__ import annotations

import dataclasses
import json
import os
import sys
import warnings
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

VISION_BACKBONES = ("R2D1", "I3D")
AUDIO_BACKBONES = ("ResNet18", "wavLM")
INTRA_MODAL_FUSIONS = ("None", "feat_concat_fc", "encoder_plus_self_attention")
JOINT_MODALITIES = ("NONE", "TRANSFORMER", "FC")
OUTPUT_FORMATS = ("FC", "SELF_ATTEN")
GOALS = ("TRAINING", "PRETRAINING")
MODES = ("Training", "Eval")
R2D1_REDUCES = ("MAX", "AVG", "FLATTEN")
INITS_R2D1 = ("RANDOM", "KINETICS400", "AFFWILD2", "OUR_AFFWILD2")
INITS_RESNET18 = ("RANDOM", "IMAGENET", "AFFWILD2", "OUR_AFFWILD2")
INITS_I3D = ("RANDOM", "KINETICS400", "AFFWILD2", "OUR_AFFWILD2")
SPLITS = ("DEFAULT", "ROUND1", "ROUND2", "ROUND3", "ROUND4", "ROUND5")
OPTIMIZERS = ("sgd", "adam")
SCHEDULERS = ("step", "cosine", "mystep", "mycosine", "multistep",
              "reduce_on_plateau")


def _as_bool(v: Any) -> bool:
    """The reference stores booleans as strings like "True" in JSON."""
    if isinstance(v, bool):
        return v
    if isinstance(v, str):
        return v.strip().lower() in ("true", "1", "yes")
    return bool(v)


def _check(ok: bool, what: Any) -> None:
    if not ok:
        raise ValueError(f"invalid config value: {what}")


def _backbone_list(v):
    """The reference's "wavLM+ResNet18" form, ours with ",", or a list."""
    if isinstance(v, str):
        return [] if v in ("", "None") else v.replace("+", ",").split(",")
    return v


@dataclass
class LoaderParams:
    batch_size: int = 64
    shuffle: bool = False
    num_workers: int = 4
    pin_memory: bool = False
    # host prefetch depth of the loader thread
    prefetch: int = 2

    def __post_init__(self):
        self.shuffle = _as_bool(self.shuffle)
        self.pin_memory = _as_bool(self.pin_memory)


@dataclass
class SplitParams:
    """Per-split dataset geometry (config_file.json train/val/test)."""
    labelpath: str = ""
    take_n_videos: int = -1
    seq_length: int = 512
    subseq_length: int = 32
    stride: int = 1
    dilation: int = 4
    use_more_vision_data_augm: bool = False
    use_more_audio_data_augm: bool = False
    loader_params: LoaderParams = field(default_factory=LoaderParams)

    def __post_init__(self):
        if isinstance(self.loader_params, dict):
            self.loader_params = LoaderParams(**self.loader_params)
        self.use_more_vision_data_augm = _as_bool(
            self.use_more_vision_data_augm)
        self.use_more_audio_data_augm = _as_bool(
            self.use_more_audio_data_augm)
        _check(self.seq_length > 0 and self.subseq_length > 0,
               (self.seq_length, self.subseq_length))
        _check(self.seq_length % self.subseq_length == 0,
               (self.seq_length, self.subseq_length))
        _check(self.stride > 0 and self.dilation > 0,
               (self.stride, self.dilation))
        _check(self.take_n_videos == -1 or self.take_n_videos > 0,
               self.take_n_videos)


@dataclass
class OptimParams:
    """Optimizer and learning-rate schedule hyper-parameters."""
    name_optimizer: str = "sgd"
    lr: float = 1e-4
    momentum: float = 0.9
    dampening: float = 0.0
    weight_decay: float = 1e-4
    nesterov: bool = True
    beta1: float = 0.9
    beta2: float = 0.999
    eps_adam: float = 1e-8
    amsgrad: bool = False
    lr_scheduler: bool = True
    name_lr_scheduler: str = "mystep"
    step_size: int = 40
    gamma: float = 0.1
    last_epoch: int = -1
    min_lr: float = 1e-7
    t_max: int = 100
    coef: float = 0.5
    milestones: List[int] = field(default_factory=lambda: [30, 60])
    mode: str = "min"
    factor: float = 0.5
    patience: int = 10
    # mirrored from model_params.max_epochs (the reference's optimizer
    # factory reads both from one dict)
    max_epochs: int = 20

    def __post_init__(self):
        self.nesterov = _as_bool(self.nesterov)
        self.amsgrad = _as_bool(self.amsgrad)
        self.lr_scheduler = _as_bool(self.lr_scheduler)
        _check(self.name_optimizer in OPTIMIZERS,
               f"name_optimizer={self.name_optimizer!r}")
        if self.lr_scheduler:
            _check(self.name_lr_scheduler in SCHEDULERS,
                   f"name_lr_scheduler={self.name_lr_scheduler!r}")


@dataclass
class ModelParams:
    intra_modal_fusion: str = "None"
    output_format: str = "FC"
    joint_modalities: str = "TRANSFORMER"
    l_vision_backbones: List[str] = field(default_factory=lambda: ["R2D1"])
    l_audio_backbones: List[str] = field(default_factory=lambda: ["ResNet18"])
    init_w_R2D1: str = "RANDOM"
    init_w_ResNet18: str = "RANDOM"
    init_w_I3D: str = "RANDOM"
    R2D1_ft_dim_reduce: str = "MAX"
    freeze_vision_R2D1: bool = True
    freeze_vision_I3D: bool = True
    freeze_audio_ResNet18: bool = True
    num_layers: int = 1
    num_heads: int = 1
    v_dropout: float = 0.0
    a_dropout: float = 0.0
    start_epoch: int = 0
    max_epochs: int = 20
    opt: OptimParams = field(default_factory=OptimParams)
    # compute dtype of the backbones and the fusion ("bfloat16" |
    # "float32"); parameters stay float32
    compute_dtype: str = "bfloat16"
    # rematerialize the finetuned backbones in the backward: each whole
    # ("backbone") or by residual block / inception module ("stage")
    remat_backbones: bool = False
    remat_granularity: str = "backbone"
    # I3D input resolution: 224 = the reference's 112 -> 224 upsample
    # (folded into the stem); 112 = native resolution (not parity)
    i3d_input_size: int = 224
    # the nine inception modules as kernel K3: True | False | "auto"
    # ("auto" resolves to False, as in the JAX package)
    i3d_fused_inception: object = "auto"
    # run the I3D trunk over chunks of this many clips (0 = off)
    i3d_chunk: int = 0
    # BN of the finetuned backbones: "batch" = train-mode batch statistics
    # (the reference); "frozen" = running statistics while their
    # parameters train
    finetune_bn: str = "batch"

    def __post_init__(self):
        self.l_vision_backbones = _backbone_list(self.l_vision_backbones)
        self.l_audio_backbones = _backbone_list(self.l_audio_backbones)
        if isinstance(self.opt, dict):
            self.opt = OptimParams(**self.opt)
        self.opt.max_epochs = self.max_epochs
        self.freeze_vision_R2D1 = _as_bool(self.freeze_vision_R2D1)
        self.freeze_vision_I3D = _as_bool(self.freeze_vision_I3D)
        self.freeze_audio_ResNet18 = _as_bool(self.freeze_audio_ResNet18)
        for value, allowed in (
                (self.intra_modal_fusion, INTRA_MODAL_FUSIONS),
                (self.output_format, OUTPUT_FORMATS),
                (self.joint_modalities, JOINT_MODALITIES),
                (self.R2D1_ft_dim_reduce, R2D1_REDUCES),
                (self.init_w_R2D1, INITS_R2D1),
                (self.init_w_ResNet18, INITS_RESNET18),
                (self.init_w_I3D, INITS_I3D),
                (self.compute_dtype, ("bfloat16", "float32")),
                (self.remat_granularity, ("backbone", "stage")),
                (self.finetune_bn, ("batch", "frozen"))):
            _check(value in allowed, f"{value!r} not in {allowed}")
        bad = [b for b in self.l_vision_backbones
               if b not in VISION_BACKBONES] + \
              [b for b in self.l_audio_backbones if b not in AUDIO_BACKBONES]
        _check(not bad, f"unknown backbones {bad}")
        _check(self.num_layers > 0 and self.num_heads > 0,
               (self.num_layers, self.num_heads))
        _check(0.0 <= self.v_dropout < 1.0 and 0.0 <= self.a_dropout < 1.0,
               f"dropouts {self.v_dropout}, {self.a_dropout} must lie in "
               "[0, 1)")
        _check(self.i3d_input_size in (112, 224), self.i3d_input_size)
        self.i3d_chunk = int(self.i3d_chunk)
        _check(self.i3d_chunk >= 0, self.i3d_chunk)
        if self.i3d_fused_inception != "auto":
            self.i3d_fused_inception = _as_bool(self.i3d_fused_inception)

    def finetune(self) -> tuple:
        """The backbones in use that are not frozen, in the order R2D1,
        I3D, ResNet18: ``JMTModel``'s ``finetune``."""
        flags = (("R2D1", self.freeze_vision_R2D1, self.l_vision_backbones),
                 ("I3D", self.freeze_vision_I3D, self.l_vision_backbones),
                 ("ResNet18", self.freeze_audio_ResNet18,
                  self.l_audio_backbones))
        return tuple(name for name, frozen, used in flags
                     if not frozen and name in used)


@dataclass
class Config:
    """Top-level experiment config (config_file.json)."""
    exp_id: str = "exp"
    outd: str = "exps"
    verbose: bool = True
    dataset_rootpath: str = ""
    dataset_wavspath: str = ""
    dataset_realtimestamps: str = ""
    wavlm_features: str = ""
    # root of the pretrained backbone checkpoints (init_w_*,
    # models/pretrained.py)
    pretrained_weights_dir: str = ""
    # annotation roots of the split -> labelpath convention
    dataset_annotations: str = ""
    dataset_annotations_5folds: str = ""
    # static per-wav sample count (left-zero-padded, long wavs keep their
    # tail)
    audio_samples: int = 45599
    train_params: SplitParams = field(default_factory=SplitParams)
    val_params: SplitParams = field(default_factory=SplitParams)
    test_params: SplitParams = field(default_factory=SplitParams)
    model_params: ModelParams = field(default_factory=ModelParams)
    Mode: str = "Training"
    SEED: int = 0
    split: str = "DEFAULT"
    dump_best_model_every_time: bool = True
    goal: str = "TRAINING"
    # data-parallel devices (-1 = all); the port trains on one
    mesh_data_parallel: int = -1
    # XLA only: no effect on CUDA
    mesh_dcn: int = 1
    xla_scoped_vmem_kib: int = 0
    compilation_cache_dir: str = ""
    # write epoch-end checkpoints on a background thread
    async_checkpoint: bool = True
    # SIGTERM -> save the state at the next boundary and exit without
    # passed.txt, so re-launching the same command resumes
    graceful_preemption: bool = True
    # also poll for preemption every N train steps and checkpoint
    # mid-epoch (0 = epoch boundaries only)
    preempt_save_steps: int = 0
    # torch.profiler trace of train steps 2-4 of profile_epoch
    profile_dir: str = ""
    profile_epoch: int = 0
    # log step timing every N train steps (0 = off)
    log_every_steps: int = 50

    def __post_init__(self):
        for name in ("train_params", "val_params", "test_params"):
            v = getattr(self, name)
            if isinstance(v, dict):
                setattr(self, name, SplitParams(**v))
        if isinstance(self.model_params, dict):
            self.model_params = ModelParams(**self.model_params)
        self.verbose = _as_bool(self.verbose)
        self.dump_best_model_every_time = _as_bool(
            self.dump_best_model_every_time)
        self.async_checkpoint = _as_bool(self.async_checkpoint)
        self.graceful_preemption = _as_bool(self.graceful_preemption)
        self.preempt_save_steps = int(self.preempt_save_steps)
        self.xla_scoped_vmem_kib = int(self.xla_scoped_vmem_kib)
        _check(self.xla_scoped_vmem_kib >= 0, self.xla_scoped_vmem_kib)
        _check(self.Mode in MODES, f"Mode={self.Mode!r}")
        _check(self.goal in GOALS, f"goal={self.goal!r}")
        _check(self.split in SPLITS, f"split={self.split!r}")
        self.validate_lattice()

    def auto_set_label_paths(self, must_exist: bool = True) -> None:
        """The reference's 5-fold split convention: DEFAULT ->
        ``dataset_annotations``, ROUND<k> ->
        ``dataset_annotations_5folds``/fold<k>, each suffixed Train_Set /
        Val_Set / Test_Set. Fills only empty labelpaths."""
        if self.split == "DEFAULT":
            base = self.dataset_annotations
        else:
            _check(bool(self.dataset_annotations_5folds),
                   f"split={self.split} requires dataset_annotations_5folds")
            base = os.path.join(self.dataset_annotations_5folds,
                                "fold" + self.split[len("ROUND"):])
        if not base:
            return
        for params, sub in ((self.train_params, "Train_Set"),
                            (self.val_params, "Val_Set"),
                            (self.test_params, "Test_Set")):
            if not params.labelpath:
                params.labelpath = os.path.join(base, sub)
                if must_exist and not os.path.isdir(params.labelpath):
                    raise FileNotFoundError(params.labelpath)

    def validate_lattice(self) -> None:
        """The reference's config-combination checks; val/test geometry is
        set to train's."""
        mp = self.model_params
        if self.goal == "PRETRAINING":
            n = len(mp.l_vision_backbones) + len(mp.l_audio_backbones)
            _check(n == 1, f"PRETRAINING requires exactly one backbone, "
                           f"got {n}")
        else:
            _check(len(mp.l_vision_backbones) >= 1, mp.l_vision_backbones)
            _check(len(mp.l_audio_backbones) >= 1, mp.l_audio_backbones)
        if len(mp.l_vision_backbones) == 2 or len(mp.l_audio_backbones) == 2:
            _check(mp.intra_modal_fusion != "None",
                   "two backbones in one modality require an intra-modal "
                   "fusion")
        if mp.joint_modalities == "NONE":
            _check(mp.output_format == "FC",
                   "joint_modalities NONE requires output_format FC")
        for split in (self.val_params, self.test_params):
            split.seq_length = self.train_params.seq_length
            split.subseq_length = self.train_params.subseq_length
            split.stride = self.train_params.stride
            split.dilation = self.train_params.dilation

    # -- (de)serialization ------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Config":
        d = dict(d)
        known = {f.name for f in dataclasses.fields(cls)}
        mp = d.get("model_params")
        if isinstance(mp, dict):
            mp = dict(mp)
            # the legacy opt__* keys go into the nested OptimParams
            opt_d = dict(mp.pop("opt", {}) or {})
            for k in list(mp):
                if k.startswith("opt__"):
                    opt_d[k[len("opt__"):]] = mp.pop(k)
            mp["opt"] = opt_d
            d["model_params"] = mp
        # reference-only keys with no meaning here are dropped silently;
        # any other unknown key is warned about
        silent = {"cudaid", "t0", "tend", "myseed", "debug_subset"}
        for k in d:
            if k not in known and k not in silent:
                warnings.warn(f"ignoring unknown config key {k!r}",
                              stacklevel=2)
        return cls(**{k: v for k, v in d.items() if k in known})

    @classmethod
    def from_file(cls, path: str) -> "Config":
        return cls.from_dict(read_yaml_or_json(path))

    def save_yaml(self, path: str) -> None:
        write_json_yaml(path, self.to_dict())


def read_yaml_or_json(path: str) -> Any:
    """A ``.json`` or ``.yml`` file: JSON first (what the port writes);
    ``yaml`` is imported only for a file that is not JSON."""
    with open(path) as f:
        text = f.read()
    try:
        return json.loads(text)
    except json.JSONDecodeError:
        pass
    try:
        import yaml
    except ImportError as e:
        raise ImportError(f"{path} is YAML, not JSON, and PyYAML is not "
                          "installed to read it") from e
    return yaml.safe_load(text)


def _json_text(x: Any, indent: str = "") -> str:
    """JSON text that YAML 1.1 reads as the same data: a float always has
    a point before its exponent (YAML reads ``1e-08`` as a string)."""
    if isinstance(x, dict) and x:
        inner = indent + "  "
        return "{\n" + ",\n".join(
            f"{inner}{json.dumps(str(k))}: {_json_text(v, inner)}"
            for k, v in x.items()) + f"\n{indent}}}"
    if isinstance(x, (list, tuple)):
        return "[" + ", ".join(_json_text(v, indent) for v in x) + "]"
    if isinstance(x, float) and x == x and abs(x) != float("inf"):
        mantissa, e, exponent = repr(x).partition("e")
        if e and "." not in mantissa:
            mantissa += ".0"
        return mantissa + e + exponent
    return json.dumps(x)


def write_json_yaml(path: str, data: Any) -> None:
    """Write ``data`` as JSON text, which ``yaml.safe_load`` reads too."""
    with open(path, "w") as f:
        f.write(_json_text(data) + "\n")


def apply_overrides(cfg_dict: Dict[str, Any],
                    overrides: Dict[str, Any]) -> Dict[str, Any]:
    """Apply override keys onto a raw config dict:

    * ``a.b.c`` -> the dotted path;
    * ``opt__<k>`` -> model_params.opt.<k>;
    * ``<split>_params__<loader-key>`` -> <split>_params.loader_params.<k>
      (the reference flattens loader params onto the split prefix);
    * ``<section>__<k>`` -> <section>.<k>;
    * bare model-param keys (``num_heads``, ``freeze_vision_R2D1``, ...)
      -> model_params.<k> (top-level flags in the reference);
    * other plain keys -> the top level.
    """
    out = json.loads(json.dumps(cfg_dict))  # deep copy, JSON-typed
    mp_keys = {f.name for f in dataclasses.fields(ModelParams)} - {"opt"}
    loader_keys = {f.name for f in dataclasses.fields(LoaderParams)}

    def set_path(d: Dict[str, Any], path: List[str], value: Any) -> None:
        for p in path[:-1]:
            d = d.setdefault(p, {})
        d[path[-1]] = value

    for key, value in overrides.items():
        if "." in key:
            set_path(out, key.split("."), value)
        elif key.startswith("opt__"):
            set_path(out, ["model_params", key], value)
        elif "__" in key:
            path = key.split("__")
            if (len(path) == 2 and path[0].endswith("_params")
                    and path[1] in loader_keys):
                path = [path[0], "loader_params", path[1]]
            set_path(out, path, value)
        elif key in mp_keys:
            set_path(out, ["model_params", key], value)
        else:
            out[key] = value
    return out


class ExperimentDir:
    """``<outd>/id_<exp_id>`` with the ``passed.txt`` already-done guard."""

    def __init__(self, cfg: Config):
        self.cfg = cfg
        self.path = os.path.join(cfg.outd, f"id_{cfg.exp_id}")
        self.weights_dir = os.path.join(self.path, "SavedWeights")

    @property
    def passed_marker(self) -> str:
        return os.path.join(self.path, "passed.txt")

    @property
    def preempted_marker(self) -> str:
        """Written only by a graceful preemption exit; the CLI resumes on
        its own only where it exists (an ordinary crash needs
        ``--resume``)."""
        return os.path.join(self.path, "preempted.txt")

    def already_done(self) -> bool:
        return os.path.isfile(self.passed_marker)

    def create(self, argv: Optional[List[str]] = None) -> str:
        os.makedirs(self.weights_dir, exist_ok=True)
        self.cfg.save_yaml(os.path.join(self.path, "config.yml"))
        argv = argv if argv is not None else sys.argv
        with open(os.path.join(self.path, "cmd.sh"), "w") as f:
            f.write("#!/usr/bin/env bash\n")
            f.write(" ".join(argv) + "\n")
        return self.path

    def finalize(self, perfs: Dict[str, Any]) -> None:
        self.cfg.save_yaml(os.path.join(self.path, "final_config.yml"))
        write_json_yaml(os.path.join(self.path, "perfs.yml"), perfs)
        with open(self.passed_marker, "w") as f:
            f.write("done\n")
        if os.path.isfile(self.preempted_marker):
            os.remove(self.preempted_marker)
