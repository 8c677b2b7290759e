"""The configuration fields the train and eval slice reads.

Counterpart of part of ``jmt_tpu/core/config.py``: ``OptimParams`` whole
(the reference's ``opt__*`` keys), and of ``ModelParams`` the backbone
lists, the freeze flags, the regressor dropouts, ``max_epochs``, ``opt``
and ``finetune_bn``, with the same names, defaults and validation.
``Config`` holds ``model_params`` only; its other sections (data paths,
loader and split parameters, the experiment directory) and the parsing of
the reference's JSON and command-line forms ("True" strings,
"wavLM+ResNet18") come with the orchestration.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

VISION_BACKBONES = ("R2D1", "I3D")
AUDIO_BACKBONES = ("ResNet18", "wavLM")
OPTIMIZERS = ("sgd", "adam")
SCHEDULERS = ("step", "cosine", "mystep", "mycosine", "multistep",
              "reduce_on_plateau")


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
        if self.name_optimizer not in OPTIMIZERS:
            raise ValueError(f"name_optimizer={self.name_optimizer!r}")
        if self.lr_scheduler and self.name_lr_scheduler not in SCHEDULERS:
            raise ValueError(f"name_lr_scheduler={self.name_lr_scheduler!r}")


@dataclass
class ModelParams:
    l_vision_backbones: List[str] = field(default_factory=lambda: ["R2D1"])
    l_audio_backbones: List[str] = field(
        default_factory=lambda: ["ResNet18"])
    freeze_vision_R2D1: bool = True
    freeze_vision_I3D: bool = True
    freeze_audio_ResNet18: bool = True
    v_dropout: float = 0.0
    a_dropout: float = 0.0
    max_epochs: int = 20
    opt: OptimParams = field(default_factory=OptimParams)
    # BN of the finetuned backbones: "batch" = train-mode batch statistics
    # (the reference); "frozen" = running statistics while their
    # parameters train
    finetune_bn: str = "batch"

    def __post_init__(self):
        self.opt.max_epochs = self.max_epochs
        bad = [b for b in self.l_vision_backbones
               if b not in VISION_BACKBONES] + \
              [b for b in self.l_audio_backbones if b not in AUDIO_BACKBONES]
        if bad:
            raise ValueError(f"unknown backbones {bad}")
        if not (0.0 <= self.v_dropout < 1.0 and 0.0 <= self.a_dropout < 1.0):
            raise ValueError(f"dropouts {self.v_dropout}, {self.a_dropout} "
                             "must lie in [0, 1)")
        if self.finetune_bn not in ("batch", "frozen"):
            raise ValueError(f"finetune_bn={self.finetune_bn!r}")

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
    model_params: ModelParams = field(default_factory=ModelParams)
