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
    """JointMultimodalTransformer params, either head: ``out_layer1`` in
    the tree is the FC head, ``final_encoder`` the SELF_ATTEN one."""
    p = prefix
    out = _merge(
        inv_encoder_block(tree["visual_encoder"], _key(p, "visual_encoder")),
        inv_encoder_block(tree["audio_encoder"],
                          _key(p, "physiological_encoder")),
        inv_encoder_block(tree["joint_encoder"],
                          _key(p, "joint_representation_encoder")),
        inv_mha(tree["cross_attention_v"], _key(p, "cross_attention_v")),
        inv_mha(tree["cross_attention_p"], _key(p, "cross_attention_p")),
        inv_mha(tree["cross_attention_pv"], _key(p, "cross_attention_pv")),
        inv_linear(tree["out_layer_pv"], _key(p, "out_layer_pv")))
    if "out_layer1" in tree:
        out.update(inv_linear(tree["out_layer1"], _key(p, "out_layer1")))
    else:
        out.update(inv_encoder_block(tree["final_encoder"],
                                     _key(p, "final_visual_encoder")))
        out.update(inv_mha(tree["final_self_attention"],
                           _key(p, "final_self_attention")))
    return out


def inv_jmt_wo_jr(tree, prefix: str = "") -> SD:
    """MultimodalTransformerNoJR params."""
    p = prefix
    return _merge(
        inv_encoder_block(tree["visual_encoder"], _key(p, "visual_encoder")),
        inv_encoder_block(tree["audio_encoder"],
                          _key(p, "physiological_encoder")),
        inv_mha(tree["cross_attention_v"], _key(p, "cross_attention_v")),
        inv_mha(tree["cross_attention_p"], _key(p, "cross_attention_p")),
        inv_linear(tree["final_layer"], _key(p, "final_layer")))


def inv_feature_concat_fc(tree, prefix: str = "") -> SD:
    return inv_linear(tree["fc"], _key(prefix, "fc"))


def inv_mm_transformer(tree, prefix: str = "") -> SD:
    """The fusion variant from the tree: ``joint_encoder`` => w_JR,
    ``final_layer`` => wo_JR, a bare ``fc`` => FeatureConcatFC."""
    if "joint_encoder" in tree:
        return inv_jmt_w_jr(tree, prefix)
    if "final_layer" in tree:
        return inv_jmt_wo_jr(tree, prefix)
    return inv_feature_concat_fc(tree, prefix)


def inv_two_transformers(tree) -> SD:
    return _merge(inv_mm_transformer(tree["mm_transformer"],
                                     "mm_transformer"),
                  inv_regressor(tree["vregressor"], "vregressor"),
                  inv_regressor(tree["aregressor"], "aregressor"))


def inv_pretrainer(tree) -> SD:
    return inv_regressor(tree["regressor"], "regressor")


def inv_intra_modal_fusion(tree) -> SD:
    """The JAX module creates its 768 -> 512 ``fc`` only when an input is
    768-d (wavLM); the reference module always owns it. Over two 512-d
    streams (the vision pair) it never runs, and its keys get zeros."""
    fc = (inv_linear(tree["fc"], "fc") if "fc" in tree else
          {"fc.weight": np.zeros((512, 768), np.float32),
           "fc.bias": np.zeros((512,), np.float32)})
    return _merge(
        inv_encoder_block(tree["encoder"], "final_visual_encoder"),
        inv_mha(tree["self_attention"], "final_self_attention"), fc)


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


def video_arch(tree) -> str:
    """The key layout of a JAX VideoResNet's variables: "r2plus1d" (a
    factorized stem) or "r3d" (one stem conv; MC3's layout too)."""
    return "r2plus1d" if "spatial_conv" in tree["params"]["stem"] else "r3d"


def inv_video_resnet(tree, prefix: str = "", arch: str = "r2plus1d") -> SD:
    """R(2+1)D-18, R3D-18 or MC3-18 (``arch``) variables, torchvision's
    key layout: R(2+1)D's stem ``stem.{0,1,3,4}`` and block convs
    ``conv{1,2}.0.{0,1,3}``; R3D's and MC3's stem ``stem.{0,1}`` and
    block convs ``conv{1,2}.0``, one conv each."""
    t = _Inv(tree)

    def block_conv(torch_prefix: str, *path):
        if arch == "r2plus1d":
            t.conv(f"{torch_prefix}.0", *path, "spatial_conv")
            t.bn(f"{torch_prefix}.1", *path, "spatial_bn")
            t.conv(f"{torch_prefix}.3", *path, "temporal_conv")
        else:
            t.conv(torch_prefix, *path, "conv")

    if arch == "r2plus1d":
        t.conv(f"{prefix}stem.0", "stem", "spatial_conv")
        t.bn(f"{prefix}stem.1", "stem", "spatial_bn")
        t.conv(f"{prefix}stem.3", "stem", "temporal_conv")
        t.bn(f"{prefix}stem.4", "stem", "temporal_bn")
    else:
        t.conv(f"{prefix}stem.0", "stem", "conv")
        t.bn(f"{prefix}stem.1", "stem", "bn")
    for li in range(1, 5):
        for bi in range(2):
            tp, fp = f"{prefix}layer{li}.{bi}", f"layer{li}_{bi}"
            block_conv(f"{tp}.conv1.0", fp, "conv1")
            t.bn(f"{tp}.conv1.1", fp, "bn1")
            block_conv(f"{tp}.conv2.0", fp, "conv2")
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


def inv_weight_norm_conv1d(tree, prefix: str) -> SD:
    """{g (O,), v (k, I, O), bias} -> weight_g (O, 1, 1) + weight_v
    (O, I, k) + bias, the torch <= 2.0 weight_norm keys."""
    return {
        _key(prefix, "weight_g"): _np(tree["g"]).reshape(-1, 1, 1),
        _key(prefix, "weight_v"): np.transpose(_np(tree["v"]), (2, 1, 0)),
        _key(prefix, "bias"): _np(tree["bias"]),
    }


def inv_tcn(tree, prefix: str = "") -> SD:
    """TemporalConvNet params; conv1 and conv2 also under their reference
    aliases ``net.0`` and ``net.4``."""
    out: SD = {}
    for i in range(len(tree)):
        block = tree[f"block{i}"]
        tp = f"{prefix}network.{i}"
        for name, alias in (("conv1", "net.0"), ("conv2", "net.4")):
            sd = inv_weight_norm_conv1d(block[name], f"{tp}.{name}")
            out.update(sd)
            out.update({k.replace(f"{tp}.{name}.", f"{tp}.{alias}."): v
                        for k, v in sd.items()})
        if "downsample_kernel" in block:
            out[f"{tp}.downsample.weight"] = np.transpose(
                _np(block["downsample_kernel"]), (2, 1, 0))
            out[f"{tp}.downsample.bias"] = _np(block["downsample_bias"])
    return out


def _unit3d(t: "_Inv", torch_prefix: str, *path) -> None:
    t.conv(f"{torch_prefix}.conv3d", *path)
    t.bn(f"{torch_prefix}.bn", *path, "bn")


INCEPTION_BRANCHES = ("b0", "b1a", "b1b", "b2a", "b2b", "b3b")
MIXED = ("Mixed_3b", "Mixed_3c", "Mixed_4b", "Mixed_4c", "Mixed_4d",
         "Mixed_4e", "Mixed_4f", "Mixed_5b", "Mixed_5c")


def inv_inception_module(tree, prefix: str = "") -> SD:
    t = _Inv(tree)
    for branch in INCEPTION_BRANCHES:
        _unit3d(t, f"{prefix}{branch}", branch)
    return t.sd


def inv_i3d(tree, prefix: str = "") -> SD:
    """InceptionI3d feature path (no logits head)."""
    t = _Inv(tree)
    for unit in ("Conv3d_1a_7x7", "Conv3d_2b_1x1", "Conv3d_2c_3x3"):
        _unit3d(t, f"{prefix}{unit}", unit)
    for mixed in MIXED:
        for branch in INCEPTION_BRANCHES:
            _unit3d(t, f"{prefix}{mixed}.{branch}", mixed, branch)
    return t.sd


def inv_i3d_tcn(tree) -> SD:
    i3d = {"params": tree["params"]["i3d"],
           "batch_stats": tree["batch_stats"]["i3d"]}
    return _merge(inv_i3d(i3d, prefix="i3d_WSDDA."),
                  inv_tcn(tree["params"]["temporal"], prefix="temporal."))


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
        r2d1 = {"params": params["vision_r2d1"],
                "batch_stats": stats["vision_r2d1"]}
        out.update(inv_video_resnet(r2d1, prefix="vision_r2d1.r2plus1d.",
                                    arch=video_arch(r2d1)))
    if "vision_r2d1_fc" in params:
        out.update(inv_r2d1_flatten_fc(params["vision_r2d1_fc"],
                                       prefix="vision_r2d1_fc"))
    if "vision_i3d" in params:
        out.update(_prefixed("vision_i3d", inv_i3d_tcn(
            {"params": params["vision_i3d"],
             "batch_stats": stats["vision_i3d"]})))
    return out


def inv_jmt_model(tree) -> SD:
    """JMTModel variables -> the port's JMTModel state dict."""
    params, stats = tree["params"], tree.get("batch_stats") or {}
    sd = _prefixed("backbones", inv_tsav(
        {"params": params["backbones"],
         "batch_stats": stats.get("backbones", {})}))
    for name in ("transformer_visio_modality_fusion",
                 "transformer_audio_modality_fusion"):
        if name in params:
            sd.update(_prefixed(name, inv_intra_modal_fusion(params[name])))
    for name in ("fc_layer_for_video_concat", "fc_layer_for_audio_concat"):
        if name in params:
            sd.update(_prefixed(name, inv_fc_layer(params[name])))
    if "fusion_model" in params:
        sd.update(_prefixed("fusion_model",
                            inv_two_transformers(params["fusion_model"])))
    else:
        sd.update(_prefixed("backbone_pretrainer",
                            inv_pretrainer(params["backbone_pretrainer"])))
    return sd


def _converters():
    from jmt_tpu_torch.models import (encoder, fusion, i3d, intra_modal,
                                      jmt, jmt_model, resnet18, tcn, tsav,
                                      video_resnet)
    from jmt_tpu_torch.ops.attention import MultiheadAttention
    return {
        jmt_model.JMTModel: inv_jmt_model,
        tsav.TwoStreamBackbones: inv_tsav,
        i3d.I3DTCN: inv_i3d_tcn,
        i3d.InceptionI3d: inv_i3d,
        i3d.InceptionModule: inv_inception_module,
        tcn.TemporalConvNet: lambda t: inv_tcn(t["params"]),
        resnet18.ResNet18: inv_resnet18,
        video_resnet.VideoResNet:
            lambda t: inv_video_resnet(t, arch=video_arch(t)),
        fusion.TwoTransformers: lambda t: inv_two_transformers(t["params"]),
        fusion.SingleBackbonePretrainer: lambda t: inv_pretrainer(t["params"]),
        jmt.JointMultimodalTransformer:
            lambda t: inv_jmt_w_jr(t["params"]),
        jmt.MultimodalTransformerNoJR: lambda t: inv_jmt_wo_jr(t["params"]),
        jmt.FeatureConcatFC: lambda t: inv_feature_concat_fc(t["params"]),
        intra_modal.IntraModalTransformerFusion:
            lambda t: inv_intra_modal_fusion(t["params"]),
        intra_modal.FcLayer: lambda t: inv_fc_layer(t["params"]),
        encoder.TransformerEncoderBlock:
            lambda t: inv_encoder_block(t["params"], ""),
        MultiheadAttention: lambda t: inv_mha(t["params"], ""),
    }


# ---------------------------------------------------------------------------
# the reference modules' forward-dead keys, for reference-layout exports
# ---------------------------------------------------------------------------
def _dead_encoder_layer(dim: int, hidden: int, prefix: str) -> SD:
    z = np.zeros
    return {
        f"{prefix}.attention.in_proj_weight": z((3 * dim, dim), np.float32),
        f"{prefix}.attention.in_proj_bias": z((3 * dim,), np.float32),
        f"{prefix}.attention.out_proj.weight": z((dim, dim), np.float32),
        f"{prefix}.attention.out_proj.bias": z((dim,), np.float32),
        f"{prefix}.feed_forward.0.weight": z((hidden, dim), np.float32),
        f"{prefix}.feed_forward.0.bias": z((hidden,), np.float32),
        f"{prefix}.feed_forward.2.weight": z((dim, hidden), np.float32),
        f"{prefix}.feed_forward.2.bias": z((dim,), np.float32),
        f"{prefix}.layer_norm1.weight": np.ones((dim,), np.float32),
        f"{prefix}.layer_norm1.bias": z((dim,), np.float32),
        f"{prefix}.layer_norm2.weight": np.ones((dim,), np.float32),
        f"{prefix}.layer_norm2.bias": z((dim,), np.float32),
    }


def _dead_i3d_heads(prefix: str = "") -> SD:
    """I3D_WSDDA's heads that the feature path never runs: the
    InceptionI3d ``logits`` Unit3D, ``predictions`` and the
    ``vregressor``/``aregressor`` with their BN."""
    z = np.zeros
    out: SD = {
        f"{prefix}i3d_WSDDA.logits.conv3d.weight":
            z((400, 1024, 1, 1, 1), np.float32),
        f"{prefix}i3d_WSDDA.logits.conv3d.bias": z((400,), np.float32),
        f"{prefix}predictions.0.conv3d.weight":
            z((512, 1024, 1, 1, 1), np.float32),
        f"{prefix}predictions.0.conv3d.bias": z((512,), np.float32),
        f"{prefix}predictions.1.conv3d.weight":
            z((1, 512, 1, 1, 1), np.float32),
        f"{prefix}predictions.1.conv3d.bias": z((1,), np.float32),
    }
    for reg in ("vregressor", "aregressor"):
        out.update({
            f"{prefix}{reg}.0.weight": z((128, 512), np.float32),
            f"{prefix}{reg}.0.bias": z((128,), np.float32),
            f"{prefix}{reg}.1.weight": np.ones((128,), np.float32),
            f"{prefix}{reg}.1.bias": z((128,), np.float32),
            f"{prefix}{reg}.1.running_mean": z((128,), np.float32),
            f"{prefix}{reg}.1.running_var": np.ones((128,), np.float32),
            f"{prefix}{reg}.1.num_batches_tracked": np.zeros((), np.int64),
            f"{prefix}{reg}.2.weight": z((1, 128), np.float32),
            f"{prefix}{reg}.2.bias": z((1,), np.float32),
        })
    return out


def synthesize_dead_keys(name: str, sd: SD) -> SD:
    """Add to the state dict of SavedWeights component ``name`` the keys
    of the reference submodules that never run (zeros, identity norms), so
    the file strict-loads into the reference module: w_JR's
    ``mm_transformer.final_encoder`` (3072-d, one layer per live encoder
    layer), I3D_WSDDA's heads, R(2+1)D's 17-way ``fc``. The JAX package's
    ``export_reference_pt`` writes the same keys."""
    out = dict(sd)
    fe = "mm_transformer.final_encoder."
    vis = "mm_transformer.visual_encoder.layers."
    if any(k.startswith("mm_transformer.joint_representation_encoder.")
           for k in sd) and not any(k.startswith(fe) for k in sd):
        n_layers = 1 + max(int(k[len(vis):].split(".")[0])
                           for k in sd if k.startswith(vis))
        hidden = sd[f"{vis}0.feed_forward.0.weight"].shape[0]
        for i in range(n_layers):
            out.update(_dead_encoder_layer(3072, hidden, f"{fe}layers.{i}"))
    if name == "vision_i3d":
        out.update(_dead_i3d_heads())
    if name == "all_backbones" and any(k.startswith("vision_i3d.")
                                       for k in sd):
        out.update(_dead_i3d_heads(prefix="vision_i3d."))
    for pfx in ("", "vision_r2d1."):
        if name in ("vision_r2d1", "all_backbones") and any(
                k.startswith(f"{pfx}r2plus1d.stem") for k in sd):
            out[f"{pfx}r2plus1d.fc.1.weight"] = np.zeros((17, 512),
                                                         np.float32)
            out[f"{pfx}r2plus1d.fc.1.bias"] = np.zeros((17,), np.float32)
    return out


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
