"""Checkpoints: the full train state for resume, and per-component weights.

Counterpart of ``jmt_tpu/core/checkpoint.py``:

* ``save_train_state`` / ``restore_train_state_with_extra`` —
  ``train_state.pt``: the model's and the optimizer's state dicts, the
  epoch and the runner's ``extra`` (best-epoch tracking, the plateau
  schedule, a mid-epoch position), read back with
  ``torch.load(weights_only=True)``;
* ``export_components`` — one reference-layout ``{name}.pt`` per
  component present (``fusion_w``, ``all_backbones``, ``audio_resnet18``,
  ... as the reference's ``SavedWeights/``): the port's keys are the
  reference's, so a component is the model's state dict under its prefix
  plus the reference modules' forward-dead keys
  (``convert.synthesize_dead_keys``); the JAX package's
  ``export_reference_pt`` writes the same files;
* ``assemble_from_components`` — load a model from such files, ours or
  the reference's (``module.`` prefixes stripped);
* ``AsyncCheckpointer`` — the writes on a background thread.

Every write is atomic and durable: a temporary file, fsync, rename, fsync
of the directory. torch's state dicts alias the live parameters and
momentum buffers, which the next optimizer step overwrites in place, so
every save takes a CPU copy on the calling thread (``host_copy``); the
background thread only serializes and writes. A directory of the JAX
package's ``.msgpack`` files raises with the command that converts it.
"""
from __future__ import annotations

import os
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from jmt_tpu_torch.models.convert import synthesize_dead_keys

STATE_FILE = "train_state.pt"

# component name -> the prefix of its keys in the model's state dict
COMPONENTS = {
    "fusion_w": "fusion_model.",
    "backbone_pretrainer_w": "backbone_pretrainer.",
    "all_backbones": "backbones.",
    "audio_resnet18": "backbones.audio_resnet18.",
    "vision_r2d1": "backbones.vision_r2d1.",
    "vision_r2d1_fc": "backbones.vision_r2d1_fc.",
    "vision_i3d": "backbones.vision_i3d.",
    "fc_layer_for_audio_concat": "fc_layer_for_audio_concat.",
    "transformer_audio_modality_fusion":
        "transformer_audio_modality_fusion.",
    "fc_layer_for_video_concat": "fc_layer_for_video_concat.",
    "transformer_visio_modality_fusion":
        "transformer_visio_modality_fusion.",
}


def host_copy(tree):
    """A copy of ``tree`` (nested dicts, lists, tuples) with every tensor
    copied to the CPU and numpy arrays turned into tensors."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(np.array(tree, copy=True))
    if isinstance(tree, dict):
        return {k: host_copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(host_copy(v) for v in tree)
    return tree


def _atomic_write(path: str, write: Callable) -> None:
    """``write(f)`` into ``path`` through a temporary file, fsynced before
    the rename, and the directory fsynced after it: a crash leaves the
    last complete file."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        write(f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    dfd = os.open(os.path.dirname(os.path.abspath(path)), os.O_RDONLY)
    try:
        os.fsync(dfd)
    finally:
        os.close(dfd)


def _save(path: str, obj) -> str:
    _atomic_write(path, lambda f: torch.save(obj, f))
    return path


def _refuse_msgpack(directory: str, what: str) -> None:
    raise FileNotFoundError(
        f"{directory} holds the JAX package's .msgpack files and no {what}: "
        f"convert them with `--export-pt {directory}` of the JAX package's "
        f"command line (the cli module of the jmt_tpu package)")


def state_payload(state, extra: Optional[dict] = None) -> dict:
    """The CPU copy that ``train_state.pt`` holds."""
    return {"model": host_copy(state.model.state_dict()),
            "optimizer": host_copy(state.optimizer.state_dict()),
            "epoch": int(state.epoch),
            "extra": host_copy(extra) if extra is not None else None}


def save_train_state(directory: str, state, extra: Optional[dict] = None,
                     payload: Optional[dict] = None) -> str:
    """Write ``train_state.pt`` (``payload``: a ``state_payload`` taken
    earlier; by default one is taken now)."""
    os.makedirs(directory, exist_ok=True)
    if payload is None:
        payload = state_payload(state, extra)
    return _save(os.path.join(directory, STATE_FILE), payload)


def restore_train_state_with_extra(directory: str, state):
    """Load ``train_state.pt`` into ``state`` (model, optimizer, epoch) in
    place; returns ``(state, extra)``."""
    path = os.path.join(directory, STATE_FILE)
    if not os.path.isfile(path) and os.path.isfile(
            os.path.join(directory, "train_state.msgpack")):
        _refuse_msgpack(directory, STATE_FILE)
    payload = torch.load(path, map_location="cpu", weights_only=True)
    state.model.load_state_dict(payload["model"])
    state.optimizer.load_state_dict(payload["optimizer"])
    state.epoch = int(payload["epoch"])
    return state, payload.get("extra")


def restore_train_state(directory: str, state):
    return restore_train_state_with_extra(directory, state)[0]


def component_state_dicts(sd: Dict[str, torch.Tensor]
                          ) -> Dict[str, Dict[str, Any]]:
    """The reference-layout state dict of each component present in the
    model state dict ``sd``, forward-dead keys included."""
    out = {}
    for name, prefix in COMPONENTS.items():
        piece = {k[len(prefix):]: v for k, v in sd.items()
                 if k.startswith(prefix)}
        if piece:
            out[name] = {k: v if isinstance(v, torch.Tensor)
                         else torch.from_numpy(np.array(v, copy=True))
                         for k, v in synthesize_dead_keys(name, piece
                                                          ).items()}
    return out


def export_components(directory: str, sd: Dict[str, torch.Tensor]
                      ) -> Dict[str, str]:
    """Write ``{name}.pt`` for each component of the CPU state dict
    ``sd``; returns {component: path}."""
    os.makedirs(directory, exist_ok=True)
    return {name: _save(os.path.join(directory, f"{name}.pt"), piece)
            for name, piece in component_state_dicts(sd).items()}


def assemble_from_components(directory: str, model: torch.nn.Module
                             ) -> Dict[str, str]:
    """Load ``model`` from the ``{name}.pt`` components in ``directory``,
    the port's or the reference's, in the order of ``COMPONENTS`` (a
    single backbone's file after ``all_backbones`` overrides it). Each
    file must hold every key of its component at its shape, and nothing
    else but the forward-dead keys. Returns {component: path}."""
    model_sd = model.state_dict()
    loaded: Dict[str, str] = {}
    new: Dict[str, torch.Tensor] = {}
    for name, prefix in COMPONENTS.items():
        want = {k[len(prefix):]: v for k, v in model_sd.items()
                if k.startswith(prefix)}
        path = os.path.join(directory, f"{name}.pt")
        if not want or not os.path.isfile(path):
            continue
        sd = torch.load(path, map_location="cpu", weights_only=True)
        sd = {k[len("module."):] if k.startswith("module.") else k: v
              for k, v in sd.items()}
        missing = [k for k in want if k not in sd]
        shapes = [k for k in want if k in sd
                  and tuple(sd[k].shape) != tuple(want[k].shape)]
        extra = set(sd) - set(synthesize_dead_keys(name, want))
        if missing or shapes or extra:
            raise ValueError(
                f"{path}: missing {missing[:5]}, wrong shapes {shapes[:5]}, "
                f"unexpected {sorted(extra)[:5]}")
        new.update({prefix + k: sd[k] for k in want})
        loaded[name] = path
    if not loaded:
        if any(f.endswith(".msgpack") for f in os.listdir(directory)):
            _refuse_msgpack(directory, "component .pt files")
        raise FileNotFoundError(f"no component .pt files for this model "
                                f"in {directory}")
    model.load_state_dict(new, strict=False)
    return loaded


class AsyncCheckpointer:
    """Checkpoint writes on one background thread.

    The CPU copy is taken on the calling thread (``state_payload``,
    ``host_copy``), so the next optimizer step cannot change what is
    written. One write is in flight: a new one first ``wait``s for the
    last, which re-raises its exception, so a failed write fails the next
    save, ``wait`` or ``close``."""

    def __init__(self) -> None:
        self._executor = ThreadPoolExecutor(max_workers=1,
                                            thread_name_prefix="jmt-ckpt")
        self._pending: Optional[Future] = None

    def _submit(self, fn, *args) -> None:
        self.wait()
        self._pending = self._executor.submit(fn, *args)

    def save_train_state(self, directory: str, state,
                         extra: Optional[dict] = None) -> None:
        self._submit(save_train_state, directory, None, None,
                     state_payload(state, extra))

    def export_components(self, directory: str,
                          sd: Dict[str, torch.Tensor]) -> None:
        self._submit(export_components, directory, host_copy(sd))

    def wait(self) -> None:
        """Block until the write in flight ended; re-raise its error."""
        if self._pending is not None:
            pending, self._pending = self._pending, None
            pending.result()

    def close(self) -> None:
        try:
            self.wait()
        finally:
            self._executor.shutdown(wait=True)

    def __enter__(self) -> "AsyncCheckpointer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
