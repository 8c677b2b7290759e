"""Joint multimodal transformer fusion stacks.

Counterpart of ``jmt_tpu/models/jmt.py``:

* ``JointMultimodalTransformer`` (w_JR, E = 512): joint representation via
  Linear(1024 -> 512), three encoder stacks, and SIX cross-attentions
  sharing three parameter sets (``cross_attention_v`` for v<-a and
  v<-joint, ``cross_attention_p`` for a<-v and a<-joint,
  ``cross_attention_pv`` for joint<-v and joint<-a). The two problems of
  each set are stacked on the batch axis, so each set runs one projection
  chain and one attention-kernel launch. Two heads over the 6 outputs:
  SELF_ATTEN mixes them as tokens over (B*L, 6, E) and keeps token -1
  (``final_visual_encoder``, ``final_self_attention``); FC concatenates
  them and projects Linear(3072 -> 1024) (``out_layer1``).
  ``fc_transpose_quirk`` returns the FC head's output seq-first (L, B,
  1024), the reference's layout leak that pairs predictions with the wrong
  labels when B > 1; off by default, as in JAX.
* ``MultimodalTransformerNoJR`` (wo_JR): two encoders, two
  cross-attentions, concat, Linear(1024 -> 512) (``final_layer``). Under
  ``encode_batch_axis_quirk`` (on by default, as in JAX) the encoders
  attend over the BATCH axis, as the reference's seq-first encoders do on
  batch-first tensors: the attention length is the number of batch rows,
  pad rows included, and pad rows change the real rows' outputs. The
  attention kernel takes any number of rows (past 128 on its long path),
  as JAX's ``_core_xla`` does.
* ``FeatureConcatFC``: concat both modalities, Linear(1024 -> 512)
  (``fc``).

Keys follow the reference (``visual_encoder``, ``physiological_encoder``,
``joint_representation_encoder``, ``cross_attention_{v,p,pv}``,
``out_layer_pv``, ...). The reference's forward-dead submodules (w_JR's
``final_encoder``, the head a format does not use) are not constructed;
``convert.synthesize_dead_keys`` adds their keys to an exported state
dict.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from jmt_tpu_torch.models.common import Linear
from jmt_tpu_torch.models.encoder import TransformerEncoderBlock
from jmt_tpu_torch.ops.attention import MultiheadAttention

E = 512  # model width of every stream, and the encoders' FF hidden size
OUTPUT_FORMATS = ("FC", "SELF_ATTEN")


def _block(num_heads, num_layers, dtype):
    return TransformerEncoderBlock(E, num_heads, E, num_layers, dtype=dtype)


class JointMultimodalTransformer(nn.Module):
    def __init__(self, num_heads: int = 1, num_layers: int = 1,
                 output_format: str = "SELF_ATTEN",
                 fc_transpose_quirk: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        if output_format not in OUTPUT_FORMATS:
            raise ValueError(f"output_format={output_format!r}")
        self.output_format = output_format
        self.fc_transpose_quirk = fc_transpose_quirk

        def mha():
            return MultiheadAttention(E, num_heads, dtype=dtype)

        self.visual_encoder = _block(num_heads, num_layers, dtype)
        self.physiological_encoder = _block(num_heads, num_layers, dtype)
        self.joint_representation_encoder = _block(num_heads, num_layers,
                                                   dtype)
        self.cross_attention_v = mha()
        self.cross_attention_p = mha()
        self.cross_attention_pv = mha()
        self.out_layer_pv = Linear(2 * E, E, dtype=dtype)
        if output_format == "FC":
            self.out_layer1 = Linear(6 * E, 2 * E, dtype=dtype)
        else:
            self.final_visual_encoder = _block(num_heads, num_layers, dtype)
            self.final_self_attention = mha()

    @property
    def out_dim(self) -> int:
        return 2 * E if self.output_format == "FC" else E

    def forward(self, visual: torch.Tensor,
                audio: torch.Tensor) -> torch.Tensor:
        """visual, audio: (B, L, 512) -> (B, L, 512) for SELF_ATTEN,
        (B, L, 1024) for FC ((L, B, 1024) under the quirk)."""
        joint = self.out_layer_pv(torch.cat([visual, audio], dim=-1))
        v_enc = self.visual_encoder(visual)
        a_enc = self.physiological_encoder(audio)
        j_enc = self.joint_representation_encoder(joint)

        b = v_enc.shape[0]

        def paired(attn, q1, kv1, q2, kv2):
            kv = torch.cat([kv1, kv2], dim=0)
            out = attn(torch.cat([q1, q2], dim=0), kv, kv)
            return out[:b], out[b:]

        v_p, v_pv = paired(self.cross_attention_v, v_enc, a_enc, v_enc, j_enc)
        p_v, p_pv = paired(self.cross_attention_p, a_enc, v_enc, a_enc, j_enc)
        pv_v, pv_p = paired(self.cross_attention_pv, j_enc, v_enc, j_enc,
                            a_enc)

        # reference stacking order (mm_multi_transformers.py:173-178)
        outs = (v_p, p_v, pv_v, v_pv, pv_p, p_pv)
        if self.output_format == "FC":
            out = self.out_layer1(torch.cat(outs, dim=-1))
            return out.transpose(0, 1) if self.fc_transpose_quirk else out
        stack = torch.stack(outs, dim=2)
        bb, ll, kk, ee = stack.shape
        enc = self.final_visual_encoder(stack.reshape(bb * ll, kk, ee))
        attn = self.final_self_attention(enc, enc, enc)
        return attn.reshape(bb, ll, kk, ee)[:, :, -1, :]


class MultimodalTransformerNoJR(nn.Module):
    out_dim = E

    def __init__(self, num_heads: int = 1, num_layers: int = 1,
                 encode_batch_axis_quirk: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.encode_batch_axis_quirk = encode_batch_axis_quirk
        self.visual_encoder = _block(num_heads, num_layers, dtype)
        self.physiological_encoder = _block(num_heads, num_layers, dtype)
        self.cross_attention_v = MultiheadAttention(E, num_heads, dtype=dtype)
        self.cross_attention_p = MultiheadAttention(E, num_heads, dtype=dtype)
        self.final_layer = Linear(2 * E, E, dtype=dtype)

    def forward(self, visual: torch.Tensor,
                audio: torch.Tensor) -> torch.Tensor:
        """visual, audio: (B, L, 512) -> (B, L, 512)."""
        if self.encode_batch_axis_quirk:
            v_enc = self.visual_encoder(visual.transpose(0, 1)
                                        ).transpose(0, 1)
            a_enc = self.physiological_encoder(audio.transpose(0, 1)
                                               ).transpose(0, 1)
        else:
            v_enc = self.visual_encoder(visual)
            a_enc = self.physiological_encoder(audio)
        v_out = self.cross_attention_v(v_enc, a_enc, a_enc)
        p_out = self.cross_attention_p(a_enc, v_enc, v_enc)
        return self.final_layer(torch.cat([v_out, p_out], dim=-1))


class FeatureConcatFC(nn.Module):
    out_dim = E

    def __init__(self, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.fc = Linear(2 * E, E, dtype=dtype)

    def forward(self, visual: torch.Tensor,
                audio: torch.Tensor) -> torch.Tensor:
        return self.fc(torch.cat([visual, audio], dim=-1))
