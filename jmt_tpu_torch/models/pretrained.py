"""Pretrained backbone init (``init_w_R2D1`` / ``init_w_ResNet18`` /
``init_w_I3D``).

Counterpart of ``jmt_tpu/models/pretrained.py``: the flagship recipe of
record trains its heads over frozen, *pretrained* backbones. The files and
their laundering are the reference's (main.py:218-302, tsav.py:35-116):

* R2D1     KINETICS400 -> torchvision's r2plus1d_18 Kinetics state dict;
           AFFWILD2 -> ``vision_TSAV_Sub4_544k.pt``, a VideoModel state
           dict (``r2plus1d.`` prefix) with a 4-channel stem, sliced to its
           first 3 input channels; OUR_AFFWILD2 -> a PRETRAINING run's
           ``vision_r2d1.pt`` (trained with MAX reduce: asserted).
* ResNet18 IMAGENET -> torchvision's resnet18, ``conv1`` replaced by its
           mean over the RGB input channels; AFFWILD2 ->
           ``audio_TSAV_Sub4_544k.pt`` (AudioModel, ``resnet.`` prefix);
           OUR_AFFWILD2 -> ``audio_resnet18.pt``.
* I3D      KINETICS400 -> ``rgb_imagenet.pt``, a raw InceptionI3d state
           dict, into the I3D trunk only (the TCN stays random, the
           400-class ``logits`` head is dropped); AFFWILD2 ->
           ``Val_model_valence_cnn_lstm_mil_64_new.t7``, ``{'net': sd}``
           with DataParallel ``module.`` prefixes over the whole I3D_WSDDA
           (trunk and TCN); OUR_AFFWILD2 -> ``vision_i3d.pt``.

The port's backbones keep the reference's state-dict keys, so a file
loads straight into its module: no flax tree. ``graft`` is the shape-
checked copy that takes the place of JAX's ``graft_subtree``. It drops
exactly what the JAX converters (``jmt_tpu/models/torch_io.py``) never
read: everything outside the layout's prefix (``r2plus1d.``, ``resnet.``,
``i3d_WSDDA.`` / ``temporal.``), torchvision's ``fc`` head, the I3D's
``logits`` head and BN's ``num_batches_tracked``; the I3D_WSDDA's
``logits`` too, which JAX refuses (``i3d_sd``). Every other
key the module lacks, and every shape mismatch, is collected into one
``ValueError`` worded as JAX's; a key the module needs and the file lacks
raises ``KeyError``, as JAX's converters do. Files load with
``torch.load(weights_only=True)``. A ``.msgpack`` component (JAX's own
PRETRAINING export) raises, naming the JAX package's converter.
"""
from __future__ import annotations

import os
from typing import Dict, Iterable, List, Tuple

import numpy as np
import torch
import torch.nn as nn

from jmt_tpu_torch.core.checkpoint import strip_module_prefix

# candidate file names per (backbone, source), relative to
# cfg.pretrained_weights_dir: the first that exists wins
_FILES = {
    ("R2D1", "KINETICS400"): ["r2plus1d_18-91a641e6.pth",
                              "r2plus1d_18_kinetics400.pt",
                              "r2plus1d_18.pt"],
    ("R2D1", "AFFWILD2"): ["vision_TSAV_Sub4_544k.pt"],
    ("ResNet18", "IMAGENET"): ["resnet18-f37072fd.pth",
                               "resnet18_imagenet.pt", "resnet18.pt"],
    ("ResNet18", "AFFWILD2"): ["audio_TSAV_Sub4_544k.pt"],
    ("I3D", "KINETICS400"): ["rgb_imagenet.pt"],
    ("I3D", "AFFWILD2"): ["Val_model_valence_cnn_lstm_mil_64_new.t7"],
}

_COMPONENT_OF = {"R2D1": "vision_r2d1", "ResNet18": "audio_resnet18",
                 "I3D": "vision_i3d"}


def _our_affwild2_candidates(backbone: str) -> List[str]:
    """OUR_AFFWILD2: a PRETRAINING run's component, under a weights root
    of ``{Backbone}_OUR_AffWild2`` experiment directories (the reference's
    convention) or the experiment directory itself; JAX's ``.msgpack``
    export first, as JAX looks for it, then the ``.pt`` layout."""
    comp = _COMPONENT_OF[backbone]
    exp = f"{backbone}_OUR_AffWild2"
    return [os.path.join(exp, "SavedWeights", comp + ".msgpack"),
            os.path.join(exp, "SavedWeights", comp + ".pt"),
            os.path.join("SavedWeights", comp + ".msgpack"),
            os.path.join("SavedWeights", comp + ".pt"),
            comp + ".msgpack", comp + ".pt"]


for _bb in _COMPONENT_OF:
    _FILES[(_bb, "OUR_AFFWILD2")] = _our_affwild2_candidates(_bb)


def resolve_path(root: str, backbone: str, source: str) -> str:
    cands = _FILES[(backbone, source)]
    for c in cands:
        p = os.path.join(root, c)
        if os.path.isfile(p):
            return p
    raise FileNotFoundError(
        f"pretrained weights for {backbone}/{source}: none of "
        f"{cands} found under {root!r} (set pretrained_weights_dir to the "
        f"reference's PretrainedWeights/ analog)")


def _load_sd(path: str) -> Dict[str, torch.Tensor]:
    """``torch.load(weights_only=True)`` and the reference's laundering:
    a ``{'net': sd}`` payload unwrapped (tsav.py:104-114) and
    DataParallel ``module.`` prefixes stripped (main.py:54-70)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and isinstance(sd.get("net"), dict):
        sd = sd["net"]
    return strip_module_prefix(sd)


def _strip_prefix(sd: Dict[str, torch.Tensor], prefix: str
                  ) -> Dict[str, torch.Tensor]:
    """The keys under ``prefix``, stripped, when there are any (a
    VideoModel / AudioModel file); else the state dict as it is (a raw
    torchvision file)."""
    if any(k.startswith(prefix) for k in sd):
        return {k[len(prefix):]: v for k, v in sd.items()
                if k.startswith(prefix)}
    return sd


def _drop(sd: Dict[str, torch.Tensor], heads: Iterable[str] = ()
          ) -> Dict[str, torch.Tensor]:
    """Without BN's ``num_batches_tracked`` and the keys under ``heads``:
    what the JAX converters never read."""
    return {k: v for k, v in sd.items()
            if not k.endswith("num_batches_tracked")
            and not any(k.startswith(h) for h in heads)}


def r2d1_sd(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """VideoModel (``r2plus1d.`` prefix) or raw torchvision state dict ->
    the keys of the port's ``VideoModel.r2plus1d``, the 4-channel stem
    sliced to its first 3 input channels (main.py:257-268)."""
    sd = _drop(_strip_prefix(sd, "r2plus1d."), ("fc.",))
    stem = sd.get("stem.0.weight")
    if stem is not None and stem.shape[1] == 4:  # (45, in, 1, 7, 7)
        sd["stem.0.weight"] = stem[:, :3].contiguous()
    return sd


def resnet18_sd(sd: Dict[str, torch.Tensor], source: str
                ) -> Dict[str, torch.Tensor]:
    """AudioModel (``resnet.`` prefix) or raw torchvision state dict ->
    the keys of the port's ``AudioModel.resnet``; IMAGENET's ``conv1``
    becomes its mean over the RGB input channels (tsav.py:78-85), in
    numpy float32 as the JAX package takes it."""
    sd = _drop(_strip_prefix(sd, "resnet."), ("fc.",))
    if source == "IMAGENET":
        w = sd["conv1.weight"]
        assert w.shape[1] == 3, tuple(w.shape)
        sd["conv1.weight"] = torch.from_numpy(np.ascontiguousarray(
            w.numpy().mean(axis=1, keepdims=True)))
    return sd


def i3d_sd(sd: Dict[str, torch.Tensor], source: str
           ) -> Tuple[Dict[str, torch.Tensor], str]:
    """Returns (state dict, submodule of the port's ``I3DTCN``):
    KINETICS400 loads the raw InceptionI3d into the trunk ``i3d_WSDDA``
    only (tsav.py:99-102); AFFWILD2 and OUR_AFFWILD2 the whole I3D_WSDDA
    (trunk and TCN), weight-norm keys in torch's parametrize layout
    renamed to ``weight_g`` / ``weight_v``. The trunk's 400-class
    ``logits`` head is dropped from every source: the feature path never
    runs it. (JAX drops it from KINETICS400 only, and refuses an I3D_WSDDA
    file that carries it, as the reference's does: ``ROADMAP.md`` §C.4.)"""
    if source == "KINETICS400":
        return _drop(sd, ("logits.",)), "i3d_WSDDA"
    sd = _drop({k: v for k, v in sd.items()
                if k.startswith(("i3d_WSDDA.", "temporal."))},
               ("i3d_WSDDA.logits.",))
    renames = {"parametrizations.weight.original0": "weight_g",
               "parametrizations.weight.original1": "weight_v"}
    out = {}
    for k, v in sd.items():
        for old, new in renames.items():
            if k.endswith(old):
                k = k[:-len(old)] + new
        out[k] = v
    return out, ""


def graft(module: nn.Module, sd: Dict[str, torch.Tensor],
          errors: List[str], where: str) -> None:
    """Copy ``sd`` into ``module``'s parameters and buffers of the same
    keys (in their dtype), shape-checked: a key the module lacks or a
    shape mismatch is appended to ``errors`` and nothing is copied; a key
    the module needs (but BN's ``num_batches_tracked``) that ``sd`` lacks
    raises ``KeyError``."""
    own = module.state_dict()
    missing = [k for k in own
               if k not in sd and not k.endswith("num_batches_tracked")]
    if missing:
        raise KeyError(f"{where}: the checkpoint lacks {missing}")
    bad = False
    for k, v in sd.items():
        if k not in own:
            errors.append(f"{where}: unexpected key {k}")
            bad = True
        elif tuple(own[k].shape) != tuple(v.shape):
            errors.append(f"{where}: shape mismatch at {k}: init "
                          f"{tuple(own[k].shape)} vs checkpoint "
                          f"{tuple(v.shape)}")
            bad = True
    if bad:
        return
    with torch.no_grad():
        for k, v in sd.items():
            own[k].copy_(v)


def apply_pretrained(cfg, model: nn.Module) -> Dict[str, str]:
    """Load the pretrained backbones of the config's ``init_w_*`` policy
    into ``model`` (a ``JMTModel``), in place. Returns {component: file}.
    A no-op when every backbone is RANDOM."""
    mp = cfg.model_params
    todo = []  # (backbone, source, component)
    if "R2D1" in mp.l_vision_backbones and mp.init_w_R2D1 != "RANDOM":
        todo.append(("R2D1", mp.init_w_R2D1, "vision_r2d1"))
    if "ResNet18" in mp.l_audio_backbones and mp.init_w_ResNet18 != "RANDOM":
        todo.append(("ResNet18", mp.init_w_ResNet18, "audio_resnet18"))
    if "I3D" in mp.l_vision_backbones and mp.init_w_I3D != "RANDOM":
        todo.append(("I3D", mp.init_w_I3D, "vision_i3d"))
    if not todo:
        return {}
    root = cfg.pretrained_weights_dir
    if not root:
        raise ValueError(
            "init_w_* != RANDOM requires pretrained_weights_dir "
            f"(requested: {[(b, s) for b, s, _ in todo]})")
    if ("R2D1", "OUR_AFFWILD2", "vision_r2d1") in todo:
        # that model was pretrained with MAX pooling (main.py:281)
        assert mp.R2D1_ft_dim_reduce == "MAX", mp.R2D1_ft_dim_reduce

    report: Dict[str, str] = {}
    errors: List[str] = []
    for backbone, source, comp in todo:
        path = resolve_path(root, backbone, source)
        if path.endswith(".msgpack"):
            raise ValueError(
                f"{path} is the JAX package's .msgpack component: convert "
                f"its experiment with `--export-pt {os.path.dirname(path)}` "
                f"of the JAX package's command line (the cli module of the "
                f"jmt_tpu package) and point pretrained_weights_dir at the "
                f".pt files")
        target = getattr(model.backbones, comp)
        if backbone == "R2D1":
            sd, sub = r2d1_sd(_load_sd(path)), "r2plus1d"
        elif backbone == "ResNet18":
            sd, sub = resnet18_sd(_load_sd(path), source), "resnet"
        else:
            sd, sub = i3d_sd(_load_sd(path), source)
        graft(target.get_submodule(sub), sd, errors, f"{comp}[{source}]")
        report[comp] = path
    if errors:
        raise ValueError("pretrained grafting failed:\n  "
                         + "\n  ".join(errors))
    return report
