"""Train state: the model, its trainable/frozen partition, the optimizer.

Counterpart of ``jmt_tpu/train/state.py``. The reference freezes backbones
with ``requires_grad=False`` and hands only the trainable parameters to
the optimizer; so does the port (the JAX package splits its parameter tree
instead). A frozen backbone also runs in eval mode in training
(``JMTModel.train``), so its BN statistics stay as they are.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import torch

Prefix = Tuple[str, ...]


def frozen_prefixes(cfg) -> List[Prefix]:
    """Parameter-name prefixes frozen by ``cfg.model_params``' freeze
    flags. ``vision_r2d1_fc`` (the FLATTEN reduce's Linear) freezes with
    R2D1, as in the reference."""
    mp = cfg.model_params
    out: List[Prefix] = []
    if mp.freeze_vision_R2D1 and "R2D1" in mp.l_vision_backbones:
        out.append(("backbones", "vision_r2d1"))
        out.append(("backbones", "vision_r2d1_fc"))
    if mp.freeze_vision_I3D and "I3D" in mp.l_vision_backbones:
        out.append(("backbones", "vision_i3d"))
    if mp.freeze_audio_ResNet18 and "ResNet18" in mp.l_audio_backbones:
        out.append(("backbones", "audio_resnet18"))
    return out


def partition_params(model: torch.nn.Module, prefixes: Sequence[Prefix]
                     ) -> Tuple[List[str], List[str]]:
    """Set ``requires_grad=False`` on the parameters under ``prefixes``
    (and True on the others); returns the (trainable, frozen) names."""
    trainable, frozen = [], []
    for name, p in model.named_parameters():
        path = tuple(name.split("."))
        is_frozen = any(path[:len(pre)] == tuple(pre) for pre in prefixes)
        p.requires_grad_(not is_frozen)
        (frozen if is_frozen else trainable).append(name)
    return trainable, frozen


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    trainable: List[str]
    frozen: List[str]
    epoch: int = 0


def param_count(model: torch.nn.Module, names=None) -> int:
    """Elements of the named parameters (all of them by default)."""
    params = dict(model.named_parameters())
    return sum(params[n].numel() for n in (params if names is None
                                           else names))
