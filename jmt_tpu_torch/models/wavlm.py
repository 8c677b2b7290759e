"""WavLM feature encoder: wav -> per-frame hidden states.

Counterpart of ``jmt_tpu/models/wavlm.py`` (``wavlm_apply``): the serving
frontend (``serve.WavLMFrontend``) and the offline extractor
(``data/wavlm_extract.py``) compute the wavLM features from raw audio with
it. Inference only: no masking, dropout or layerdrop.

  wav (B, L)
  -> feature encoder: conv1d stack (512 ch; k 10,3,3,3,3,2,2; s 5,2,2,2,2,
     2,2), layer 0 followed by a per-channel GroupNorm, exact GELU after
     each
  -> feature projection: LayerNorm -> Linear 512 -> 768
  -> encoder (post-LN): positional conv (k 128, 16 groups, SAME padding
     with the trailing column dropped for an even k, GELU), residual add,
     LayerNorm; then per layer self-attention with the gated relative
     position bias (a bucketed bias table computed once and shared by
     every layer, scaled per (batch, head, query) by a sigmoid gate from
     the layer's input), LayerNorm, MLP 768 -> 3072 -> 768, LayerNorm.

The module's ``state_dict`` keys are those of Hugging Face's
``WavLMModel``, so its checkpoints load with ``strict=True`` (a ``wavlm.``
prefix is stripped, the training-only ``masked_spec_embed`` dropped). The
weight-normed positional conv loads from ``parametrizations.weight.
original0/1``, ``weight_g/weight_v`` or a plain ``weight``, folded into
one kernel ``g * v / ||v||`` (norm over the dims other than 2); the
module keeps and saves the folded ``weight``.

WavLM has no Pallas kernel in the JAX package (``wavlm_apply`` is plain
XLA), so this is plain PyTorch on the card.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class WavLMConfig:
    """The geometry of the inference path; defaults are wavlm-base and
    base-plus."""
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    conv_dim: Sequence[int] = (512,) * 7
    conv_stride: Sequence[int] = (5, 2, 2, 2, 2, 2, 2)
    conv_kernel: Sequence[int] = (10, 3, 3, 3, 3, 2, 2)
    conv_bias: bool = False
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    num_buckets: int = 320
    max_bucket_distance: int = 800
    layer_norm_eps: float = 1e-5

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def frame_stride(self) -> int:
        """Input samples per output frame (320 for the base configs)."""
        out = 1
        for s in self.conv_stride:
            out *= s
        return out

    @property
    def receptive_field(self) -> int:
        """Input samples seen by one output frame (400 for base)."""
        r = 1
        for k, s in zip(reversed(self.conv_kernel),
                        reversed(self.conv_stride)):
            r = (r - 1) * s + k
        return r

    def n_frames(self, n_samples: int) -> int:
        """Output frames for an input of n_samples (VALID convs)."""
        t = n_samples
        for k, s in zip(self.conv_kernel, self.conv_stride):
            t = (t - k) // s + 1
        return t

    @classmethod
    def from_hf(cls, hf_cfg) -> "WavLMConfig":
        """From a Hugging Face ``WavLMConfig`` (read by attribute)."""
        if getattr(hf_cfg, "do_stable_layer_norm", False):
            raise ValueError("the stable-LN (large) variant is not "
                             "implemented")
        if hf_cfg.feat_extract_norm != "group":
            raise ValueError(f"feat_extract_norm {hf_cfg.feat_extract_norm!r}"
                             f" is not implemented (only 'group')")
        return cls(
            hidden_size=hf_cfg.hidden_size,
            num_hidden_layers=hf_cfg.num_hidden_layers,
            num_attention_heads=hf_cfg.num_attention_heads,
            intermediate_size=hf_cfg.intermediate_size,
            conv_dim=tuple(hf_cfg.conv_dim),
            conv_stride=tuple(hf_cfg.conv_stride),
            conv_kernel=tuple(hf_cfg.conv_kernel),
            conv_bias=bool(hf_cfg.conv_bias),
            num_conv_pos_embeddings=hf_cfg.num_conv_pos_embeddings,
            num_conv_pos_embedding_groups=(
                hf_cfg.num_conv_pos_embedding_groups),
            num_buckets=hf_cfg.num_buckets,
            max_bucket_distance=hf_cfg.max_bucket_distance,
            layer_norm_eps=hf_cfg.layer_norm_eps)


def relative_position_buckets(T: int, num_buckets: int,
                              max_distance: int) -> np.ndarray:
    """T5-style bidirectional bucket matrix (T, T), on the host (int64)."""
    ctx = np.arange(T)[:, None]
    mem = np.arange(T)[None, :]
    rel = mem - ctx
    nb = num_buckets // 2
    buckets = (rel > 0).astype(np.int64) * nb
    rel = np.abs(rel)
    max_exact = nb // 2
    is_small = rel < max_exact
    large = max_exact + (
        np.log(np.maximum(rel, 1).astype(np.float64) / max_exact)
        / math.log(max_distance / max_exact) * (nb - max_exact)
    ).astype(np.int64)
    large = np.minimum(large, nb - 1)
    buckets += np.where(is_small, rel, large)
    return buckets


@functools.lru_cache(maxsize=16)
def _bucket_index(T: int, num_buckets: int, max_distance: int,
                  device: torch.device) -> torch.Tensor:
    """The bucket matrix on ``device``, copied there once per length."""
    with torch.inference_mode(False):
        return torch.from_numpy(relative_position_buckets(
            T, num_buckets, max_distance)).to(device)


def _fold_weight_norm(module, state_dict, prefix, *_) -> None:
    """Load-time: a weight-normed conv's (g, v) -> one ``weight``."""
    layouts = (("parametrizations.weight.original0",
                "parametrizations.weight.original1"),
               ("weight_g", "weight_v"))
    for g_key, v_key in layouts:
        if prefix + g_key in state_dict:
            g = state_dict.pop(prefix + g_key).float()
            v = state_dict.pop(prefix + v_key).float()
            norm = torch.sqrt((v ** 2).sum(dim=(0, 1), keepdim=True))
            state_dict[prefix + "weight"] = g * v / norm
            return


def _hf_layout(module, state_dict, prefix, *_) -> None:
    """Load-time: strip a ``wavlm.`` prefix and drop ``masked_spec_embed``
    (the training-time mask embedding, unused at inference)."""
    head = prefix + "wavlm."
    for key in [k for k in state_dict if k.startswith(head)]:
        state_dict[prefix + key[len(head):]] = state_dict.pop(key)
    state_dict.pop(prefix + "masked_spec_embed", None)


class _ConvLayer(nn.Module):
    def __init__(self, cin: int, cout: int, kernel: int, stride: int,
                 bias: bool, group_norm: bool):
        super().__init__()
        self.conv = nn.Conv1d(cin, cout, kernel, stride=stride, bias=bias)
        if group_norm:  # groups == channels: each channel over time
            self.layer_norm = nn.GroupNorm(cout, cout, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        if hasattr(self, "layer_norm"):
            x = self.layer_norm(x)
        return F.gelu(x)


class _FeatureEncoder(nn.Module):
    def __init__(self, cfg: WavLMConfig):
        super().__init__()
        dims = (1,) + tuple(cfg.conv_dim)
        self.conv_layers = nn.ModuleList(
            _ConvLayer(dims[i], dims[i + 1], cfg.conv_kernel[i],
                       cfg.conv_stride[i], cfg.conv_bias, i == 0)
            for i in range(len(cfg.conv_dim)))

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        x = wav[:, None, :]
        for layer in self.conv_layers:
            x = layer(x)
        return x  # (B, C, T)


class _FeatureProjection(nn.Module):
    def __init__(self, cfg: WavLMConfig):
        super().__init__()
        self.layer_norm = nn.LayerNorm(cfg.conv_dim[-1],
                                       eps=cfg.layer_norm_eps)
        self.projection = nn.Linear(cfg.conv_dim[-1], cfg.hidden_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.projection(self.layer_norm(x))


class _PositionalConv(nn.Module):
    def __init__(self, cfg: WavLMConfig):
        super().__init__()
        k = cfg.num_conv_pos_embeddings
        self.conv = nn.Conv1d(cfg.hidden_size, cfg.hidden_size, k,
                              padding=k // 2,
                              groups=cfg.num_conv_pos_embedding_groups)
        self.conv.register_load_state_dict_pre_hook(_fold_weight_norm)
        self.drop_last = k % 2 == 0

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, T, E) -> the positional embedding (B, T, E)."""
        pos = self.conv(x.transpose(1, 2))
        if self.drop_last:
            pos = pos[:, :, :-1]
        return F.gelu(pos).transpose(1, 2)


class _Attention(nn.Module):
    def __init__(self, cfg: WavLMConfig, bias_table: bool):
        super().__init__()
        e, h = cfg.hidden_size, cfg.num_attention_heads
        self.heads, self.head_dim = h, cfg.head_dim
        self.k_proj = nn.Linear(e, e)
        self.v_proj = nn.Linear(e, e)
        self.q_proj = nn.Linear(e, e)
        self.out_proj = nn.Linear(e, e)
        self.gru_rel_pos_const = nn.Parameter(torch.ones(1, h, 1, 1))
        self.gru_rel_pos_linear = nn.Linear(cfg.head_dim, 8)
        if bias_table:  # layer 0 holds the table every layer shares
            self.rel_attn_embed = nn.Embedding(cfg.num_buckets, h)

    def forward(self, x: torch.Tensor,
                position_bias: torch.Tensor) -> torch.Tensor:
        """x (B, T, E); position_bias (H, T, T)."""
        b, t, e = x.shape
        h, dh = self.heads, self.head_dim
        # the gate, from the PRE-attention hidden states: (B, T, H)
        g = self.gru_rel_pos_linear(x.reshape(b, t, h, dh))
        g = torch.sigmoid(g.reshape(b, t, h, 2, 4).sum(-1))
        gate = g[..., 0] * (g[..., 1] * self.gru_rel_pos_const.reshape(h)
                            - 1.0) + 2.0
        bias = gate.transpose(1, 2)[..., None] * position_bias  # (B,H,T,T)

        def heads(y):
            return y.reshape(b, t, h, dh).transpose(1, 2)

        q, k, v = (heads(p(x)) for p in (self.q_proj, self.k_proj,
                                         self.v_proj))
        logits = (q @ k.transpose(-1, -2)) / math.sqrt(dh)
        probs = torch.softmax(logits + bias, dim=-1)
        o = (probs @ v).transpose(1, 2).reshape(b, t, e)
        return self.out_proj(o)


class _FeedForward(nn.Module):
    def __init__(self, cfg: WavLMConfig):
        super().__init__()
        self.intermediate_dense = nn.Linear(cfg.hidden_size,
                                            cfg.intermediate_size)
        self.output_dense = nn.Linear(cfg.intermediate_size,
                                      cfg.hidden_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.output_dense(F.gelu(self.intermediate_dense(x)))


class _Layer(nn.Module):
    def __init__(self, cfg: WavLMConfig, bias_table: bool):
        super().__init__()
        eps = cfg.layer_norm_eps
        self.attention = _Attention(cfg, bias_table)
        self.layer_norm = nn.LayerNorm(cfg.hidden_size, eps=eps)
        self.feed_forward = _FeedForward(cfg)
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size, eps=eps)

    def forward(self, x: torch.Tensor,
                position_bias: torch.Tensor) -> torch.Tensor:
        x = self.layer_norm(x + self.attention(x, position_bias))
        return self.final_layer_norm(x + self.feed_forward(x))


class _Encoder(nn.Module):
    def __init__(self, cfg: WavLMConfig):
        super().__init__()
        self.pos_conv_embed = _PositionalConv(cfg)
        self.layer_norm = nn.LayerNorm(cfg.hidden_size,
                                       eps=cfg.layer_norm_eps)
        self.layers = nn.ModuleList(_Layer(cfg, i == 0)
                                    for i in range(cfg.num_hidden_layers))


class WavLMModel(nn.Module):
    """wav (B, L) float32, zero-mean / unit-variance per sequence (the
    caller normalizes) -> (B, T, hidden) features."""

    def __init__(self, cfg: WavLMConfig = WavLMConfig()):
        super().__init__()
        self.cfg = cfg
        self.feature_extractor = _FeatureEncoder(cfg)
        self.feature_projection = _FeatureProjection(cfg)
        self.encoder = _Encoder(cfg)
        self.register_load_state_dict_pre_hook(_hf_layout)

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = self.feature_extractor(wav).transpose(1, 2)  # (B, T, C)
        x = self.feature_projection(x)
        enc = self.encoder
        x = enc.layer_norm(x + enc.pos_conv_embed(x))
        t = x.shape[1]
        buckets = _bucket_index(t, cfg.num_buckets, cfg.max_bucket_distance,
                                x.device)
        table = enc.layers[0].attention.rel_attn_embed.weight
        position_bias = table[buckets].permute(2, 0, 1)  # (H, T, T)
        for layer in enc.layers:
            x = layer(x, position_bias)
        return x


def init_parameters(model: WavLMModel,
                    generator: torch.Generator) -> WavLMModel:
    """Random weights drawn from ``generator`` by Hugging Face's WavLM
    initializers (``_init_weights``): convs kaiming-normal (bias
    U(+-sqrt(groups / fan_in))), the positional conv N(0, 2 / sqrt(k E))
    with zero bias, the feature projection U(+-1/sqrt(fan_in)), the other
    Linears N(0, 0.02) with zero bias, norms ones / zeros, the bias table
    N(0, 1), the gate constants ones."""
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, _PositionalConv):
                c = mod.conv
                c.weight.normal_(0.0, 2 * math.sqrt(
                    1 / (c.kernel_size[0] * c.in_channels)),
                    generator=generator)
                c.bias.zero_()
            elif isinstance(mod, _FeatureProjection):
                k = 1 / math.sqrt(mod.projection.in_features)
                mod.projection.weight.uniform_(-k, k, generator=generator)
                mod.projection.bias.uniform_(-k, k, generator=generator)
            elif isinstance(mod, _ConvLayer):
                c = mod.conv
                nn.init.kaiming_normal_(c.weight, generator=generator)
                if c.bias is not None:
                    k = math.sqrt(c.groups / (c.in_channels
                                              * c.kernel_size[0]))
                    c.bias.uniform_(-k, k, generator=generator)
            elif isinstance(mod, (_Attention, _FeedForward)):
                for lin in mod.children():
                    if isinstance(lin, nn.Linear):
                        lin.weight.normal_(0.0, 0.02, generator=generator)
                        lin.bias.zero_()
                if isinstance(mod, _Attention):
                    mod.gru_rel_pos_const.fill_(1.0)
                    if hasattr(mod, "rel_attn_embed"):
                        mod.rel_attn_embed.weight.normal_(
                            generator=generator)
            elif isinstance(mod, (nn.LayerNorm, nn.GroupNorm)):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
    return model
