"""Carry weights from the JAX package's flax trees into the port's modules.

The port's modules use the reference's torch state-dict key layout, so the
conversion is the flax -> torch inverse the JAX package already defines
(``jmt_tpu/models/torch_export.py``, the ``inv_*`` functions). This module
keeps its own copy of the inverses the slice needs: the port imports
nothing of ``jmt_tpu``. Pure numpy on the tree side: leaves may be numpy
arrays or anything ``np.asarray`` accepts.

``load_jax_variables(module, variables)`` takes the flax
``{"params", "batch_stats"}`` tree of the module's JAX counterpart and
loads it with ``strict=True``.
"""
from __future__ import annotations

import math
import re
from typing import Any, Dict, Mapping

import numpy as np
import torch

Array = np.ndarray
SD = Dict[str, Array]


def _np(x) -> Array:
    return np.asarray(x)


def _key(prefix: str, name: str) -> str:
    return f"{prefix}.{name}" if prefix else name


def _merge(*sds: SD) -> SD:
    out: SD = {}
    for sd in sds:
        out.update(sd)
    return out


def _prefixed(prefix: str, sd: SD) -> SD:
    return {f"{prefix}.{k}": v for k, v in sd.items()}


# ---------------------------------------------------------------------------
# fusion stack
# ---------------------------------------------------------------------------
def inv_linear(tree: Mapping[str, Any], prefix: str) -> SD:
    out = {_key(prefix, "weight"): _np(tree["kernel"]).T}
    if "bias" in tree:
        out[_key(prefix, "bias")] = _np(tree["bias"])
    return out


def inv_layernorm(tree, prefix: str) -> SD:
    return {_key(prefix, "weight"): _np(tree["scale"]),
            _key(prefix, "bias"): _np(tree["bias"])}


def inv_mha(tree, prefix: str) -> SD:
    return {
        _key(prefix, "in_proj_weight"): _np(tree["in_proj_kernel"]).T,
        _key(prefix, "in_proj_bias"): _np(tree["in_proj_bias"]),
        _key(prefix, "out_proj.weight"): _np(tree["out_proj_kernel"]).T,
        _key(prefix, "out_proj.bias"): _np(tree["out_proj_bias"]),
    }


def inv_encoder_layer(tree, prefix: str) -> SD:
    return _merge(
        inv_mha(tree["attention"], _key(prefix, "attention")),
        inv_linear(tree["ff1"], _key(prefix, "feed_forward.0")),
        inv_linear(tree["ff2"], _key(prefix, "feed_forward.2")),
        inv_layernorm(tree["layer_norm1"], _key(prefix, "layer_norm1")),
        inv_layernorm(tree["layer_norm2"], _key(prefix, "layer_norm2")))


def inv_encoder_block(tree, prefix: str) -> SD:
    # natural sort: flax names are 'layer{i}'; lexicographic order would
    # put layer10 before layer2
    def _idx(k):
        m = re.search(r"(\d+)$", k)
        return (int(m.group(1)) if m else -1, k)

    return _merge(*[inv_encoder_layer(tree[k], _key(prefix, f"layers.{i}"))
                    for i, k in enumerate(sorted(tree, key=_idx))])


def inv_regressor(tree, prefix: str) -> SD:
    return _merge(inv_linear(tree["fc1"], _key(prefix, "0")),
                  inv_linear(tree["fc2"], _key(prefix, "3")))


def inv_jmt_w_jr(tree, prefix: str = "") -> SD:
    """JointMultimodalTransformer (SELF_ATTEN head) params."""
    p = prefix
    return _merge(
        inv_encoder_block(tree["visual_encoder"], _key(p, "visual_encoder")),
        inv_encoder_block(tree["audio_encoder"],
                          _key(p, "physiological_encoder")),
        inv_encoder_block(tree["joint_encoder"],
                          _key(p, "joint_representation_encoder")),
        inv_mha(tree["cross_attention_v"], _key(p, "cross_attention_v")),
        inv_mha(tree["cross_attention_p"], _key(p, "cross_attention_p")),
        inv_mha(tree["cross_attention_pv"], _key(p, "cross_attention_pv")),
        inv_linear(tree["out_layer_pv"], _key(p, "out_layer_pv")),
        inv_encoder_block(tree["final_encoder"],
                          _key(p, "final_visual_encoder")),
        inv_mha(tree["final_self_attention"],
                _key(p, "final_self_attention")))


def inv_two_transformers(tree) -> SD:
    return _merge(inv_jmt_w_jr(tree["mm_transformer"], "mm_transformer"),
                  inv_regressor(tree["vregressor"], "vregressor"),
                  inv_regressor(tree["aregressor"], "aregressor"))


def inv_intra_modal_fusion(tree) -> SD:
    return _merge(
        inv_encoder_block(tree["encoder"], "final_visual_encoder"),
        inv_mha(tree["self_attention"], "final_self_attention"),
        inv_linear(tree["fc"], "fc"))


def inv_fc_layer(tree) -> SD:
    return inv_linear(tree["fc_layer"], "fc_layer")


# ---------------------------------------------------------------------------
# conv/BN backbones
# ---------------------------------------------------------------------------
def inv_conv(tree, prefix: str) -> SD:
    """flax kernel (*k, I, O) -> torch conv weight (O, I, *k)."""
    return {_key(prefix, "weight"):
            np.moveaxis(_np(tree["kernel"]), (-1, -2), (0, 1))}


def inv_bn(params, stats, prefix: str) -> SD:
    return {
        _key(prefix, "weight"): _np(params["scale"]),
        _key(prefix, "bias"): _np(params["bias"]),
        _key(prefix, "running_mean"): _np(stats["mean"]),
        _key(prefix, "running_var"): _np(stats["var"]),
        _key(prefix, "num_batches_tracked"): np.zeros((), np.int64),
    }


class _Inv:
    """Walk a {params, batch_stats} tree emitting torch keys."""

    def __init__(self, tree):
        self.params = tree["params"]
        self.stats = tree.get("batch_stats") or {}
        self.sd: SD = {}

    @staticmethod
    def _get(tree, path):
        for p in path:
            tree = tree[p]
        return tree

    def conv(self, torch_prefix: str, *path):
        self.sd.update(inv_conv(self._get(self.params, path), torch_prefix))

    def bn(self, torch_prefix: str, *path):
        self.sd.update(inv_bn(self._get(self.params, path),
                              self._get(self.stats, path), torch_prefix))

    def has(self, *path) -> bool:
        try:
            self._get(self.params, path)
            return True
        except KeyError:
            return False


def inv_resnet18(tree, prefix: str = "") -> SD:
    t = _Inv(tree)
    t.conv(f"{prefix}conv1", "conv1")
    t.bn(f"{prefix}bn1", "bn1")
    for li in range(1, 5):
        for bi in range(2):
            tp, fp = f"{prefix}layer{li}.{bi}", f"layer{li}_{bi}"
            t.conv(f"{tp}.conv1", fp, "conv1")
            t.bn(f"{tp}.bn1", fp, "bn1")
            t.conv(f"{tp}.conv2", fp, "conv2")
            t.bn(f"{tp}.bn2", fp, "bn2")
            if t.has(fp, "downsample_conv"):
                t.conv(f"{tp}.downsample.0", fp, "downsample_conv")
                t.bn(f"{tp}.downsample.1", fp, "downsample_bn")
    return t.sd


def inv_video_resnet(tree, prefix: str = "") -> SD:
    """R(2+1)D-18 (arch 'r2plus1d') variables."""
    t = _Inv(tree)

    def conv_2plus1d(torch_prefix: str, *path):
        t.conv(f"{torch_prefix}.0", *path, "spatial_conv")
        t.bn(f"{torch_prefix}.1", *path, "spatial_bn")
        t.conv(f"{torch_prefix}.3", *path, "temporal_conv")

    t.conv(f"{prefix}stem.0", "stem", "spatial_conv")
    t.bn(f"{prefix}stem.1", "stem", "spatial_bn")
    t.conv(f"{prefix}stem.3", "stem", "temporal_conv")
    t.bn(f"{prefix}stem.4", "stem", "temporal_bn")
    for li in range(1, 5):
        for bi in range(2):
            tp, fp = f"{prefix}layer{li}.{bi}", f"layer{li}_{bi}"
            conv_2plus1d(f"{tp}.conv1.0", fp, "conv1")
            t.bn(f"{tp}.conv1.1", fp, "bn1")
            conv_2plus1d(f"{tp}.conv2.0", fp, "conv2")
            t.bn(f"{tp}.conv2.1", fp, "bn2")
            if t.has(fp, "downsample_conv"):
                t.conv(f"{tp}.downsample.0", fp, "downsample_conv")
                t.bn(f"{tp}.downsample.1", fp, "downsample_bn")
    return t.sd


def inv_r2d1_flatten_fc(tree, prefix: str = "") -> SD:
    """FLATTEN reduce Linear: the JAX kernel's rows are in (T', H', W', C)
    order, the reference's columns in (C, T', H', W'). 8-frame clips give
    T' = 1 and square maps give H' = W'."""
    wk = _np(tree["kernel"]).T              # (O, t*h*w*c)
    c, tt = 512, 1
    h = w = math.isqrt(wk.shape[1] // (c * tt))
    wk = wk.reshape(-1, tt, h, w, c).transpose(0, 4, 1, 2, 3).reshape(
        wk.shape[0], -1)                    # (O, c*t*h*w)
    return {_key(prefix, "weight"): wk,
            _key(prefix, "bias"): _np(tree["bias"])}


def inv_tsav(tree) -> SD:
    """TwoStreamBackbones variables -> the reference container's keys."""
    params, stats = tree["params"], tree.get("batch_stats") or {}
    out: SD = {}
    if "audio_resnet18" in params:
        out.update(inv_resnet18(
            {"params": params["audio_resnet18"],
             "batch_stats": stats["audio_resnet18"]},
            prefix="audio_resnet18.resnet."))
    if "vision_r2d1" in params:
        out.update(inv_video_resnet(
            {"params": params["vision_r2d1"],
             "batch_stats": stats["vision_r2d1"]},
            prefix="vision_r2d1.r2plus1d."))
    if "vision_r2d1_fc" in params:
        out.update(inv_r2d1_flatten_fc(params["vision_r2d1_fc"],
                                       prefix="vision_r2d1_fc"))
    return out


def inv_jmt_model(tree) -> SD:
    """JMTModel variables -> the port's JMTModel state dict."""
    params, stats = tree["params"], tree.get("batch_stats") or {}
    sd = _prefixed("backbones", inv_tsav(
        {"params": params["backbones"],
         "batch_stats": stats.get("backbones", {})}))
    if "transformer_audio_modality_fusion" in params:
        sd.update(_prefixed("transformer_audio_modality_fusion",
                            inv_intra_modal_fusion(
                                params["transformer_audio_modality_fusion"])))
    if "fc_layer_for_audio_concat" in params:
        sd.update(_prefixed("fc_layer_for_audio_concat", inv_fc_layer(
            params["fc_layer_for_audio_concat"])))
    sd.update(_prefixed("fusion_model",
                        inv_two_transformers(params["fusion_model"])))
    return sd


def _converters():
    from jmt_tpu_torch.models import (encoder, fusion, intra_modal, jmt,
                                      jmt_model, resnet18, tsav,
                                      video_resnet)
    from jmt_tpu_torch.ops.attention import MultiheadAttention
    return {
        jmt_model.JMTModel: inv_jmt_model,
        tsav.TwoStreamBackbones: inv_tsav,
        resnet18.ResNet18: inv_resnet18,
        video_resnet.VideoResNet: inv_video_resnet,
        fusion.TwoTransformers: lambda t: inv_two_transformers(t["params"]),
        jmt.JointMultimodalTransformer:
            lambda t: inv_jmt_w_jr(t["params"]),
        intra_modal.IntraModalTransformerFusion:
            lambda t: inv_intra_modal_fusion(t["params"]),
        intra_modal.FcLayer: lambda t: inv_fc_layer(t["params"]),
        encoder.TransformerEncoderBlock:
            lambda t: inv_encoder_block(t["params"], ""),
        MultiheadAttention: lambda t: inv_mha(t["params"], ""),
    }


def state_dict_from_jax(module: torch.nn.Module, variables) -> SD:
    """The torch state dict (numpy values) of ``module`` from the flax
    variables of its JAX counterpart."""
    conv = _converters().get(type(module))
    if conv is None:
        raise TypeError(f"no JAX weight converter for {type(module).__name__}")
    return conv(variables)


def load_jax_variables(module: torch.nn.Module, variables) -> torch.nn.Module:
    """Load flax ``{"params", "batch_stats"}`` into ``module`` with
    ``strict=True``; returns the module."""
    sd = state_dict_from_jax(module, variables)
    module.load_state_dict(
        {k: torch.from_numpy(np.array(v, copy=True)) for k, v in sd.items()},
        strict=True)
    return module
