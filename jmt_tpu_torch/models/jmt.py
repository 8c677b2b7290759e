"""Joint multimodal transformer with joint representation (w_JR).

Counterpart of ``jmt_tpu/models/jmt.py`` ``JointMultimodalTransformer``
(E = 512) with the SELF_ATTEN head: joint representation via Linear(1024 -> 512),
three encoder stacks, and SIX cross-attentions sharing three parameter sets
(``cross_attention_v`` for v<-a and v<-joint, ``cross_attention_p`` for
a<-v and a<-joint, ``cross_attention_pv`` for joint<-v and joint<-a). The
two problems of each set are stacked on the batch axis, so each set runs
one projection chain and one attention-kernel launch. The SELF_ATTEN head
mixes the 6 outputs as tokens over (B*L, 6, E) and keeps token -1.

Keys follow the reference (``visual_encoder``, ``physiological_encoder``,
``joint_representation_encoder``, ``cross_attention_{v,p,pv}``,
``out_layer_pv``, ``final_visual_encoder``, ``final_self_attention``). The
reference's forward-dead ``final_encoder`` is not constructed. The FC head,
``MultimodalTransformerNoJR`` and ``FeatureConcatFC`` are not ported yet.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from jmt_tpu_torch.models.common import Linear
from jmt_tpu_torch.models.encoder import TransformerEncoderBlock
from jmt_tpu_torch.ops.attention import MultiheadAttention

E = 512  # model width of every stream, and the encoders' FF hidden size


class JointMultimodalTransformer(nn.Module):
    def __init__(self, num_heads: int = 1, num_layers: int = 1,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()

        def block():
            return TransformerEncoderBlock(E, num_heads, E, num_layers,
                                           dtype=dtype)

        def mha():
            return MultiheadAttention(E, num_heads, dtype=dtype)

        self.visual_encoder = block()
        self.physiological_encoder = block()
        self.joint_representation_encoder = block()
        self.cross_attention_v = mha()
        self.cross_attention_p = mha()
        self.cross_attention_pv = mha()
        self.out_layer_pv = Linear(2 * E, E, dtype=dtype)
        self.final_visual_encoder = block()
        self.final_self_attention = mha()

    def forward(self, visual: torch.Tensor,
                audio: torch.Tensor) -> torch.Tensor:
        """visual, audio: (B, L, 512) -> (B, L, 512)."""
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
        stack = torch.stack((v_p, p_v, pv_v, v_pv, pv_p, p_pv), dim=2)
        bb, ll, kk, ee = stack.shape
        enc = self.final_visual_encoder(stack.reshape(bb * ll, kk, ee))
        attn = self.final_self_attention(enc, enc, enc)
        return attn.reshape(bb, ll, kk, ee)[:, :, -1, :]
