"""Device-side preprocessing shared by the eval forward and serving.

Counterpart of ``jmt_tpu/train/loops.py`` ``_preprocess`` (non-augmented
branch): raw uint8 clips and raw audio in, backbone inputs out, in the
model's compute dtype. The train and eval steps come with the training
slice.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from jmt_tpu_torch.data.transforms import preprocess_clips
from jmt_tpu_torch.ops.mel import log_mel


def preprocess(model, arrays: Dict[str, torch.Tensor]
               ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """arrays: ``clips`` uint8 (B,S,8,H,W,3), ``audio`` f32 (B,S,L).

    Returns ``(spec, clips)``: the normalized log-mel (B,S,64,1+L//441) when
    the model has the ResNet18 audio branch (one log-mel kernel launch for
    all B*S wavs on the card), and the normalized clips (B,S,8,H,W,3); each
    in the model's compute dtype, or None when the model does not use it.
    """
    out_dtype = model.dtype or torch.float32
    clips = spec = None
    if len(model.vision_backbones) > 0:
        clips = preprocess_clips(arrays["clips"]).to(out_dtype)
    if "ResNet18" in model.audio_backbones:
        spec = log_mel(arrays["audio"], batch_dims=2).to(out_dtype)
    return spec, clips
