"""Serving: fixed-bucket batched inference on the card.

Counterpart of ``jmt_tpu/serve.py`` ``InferenceServer``. A request is padded
UP to the smallest batch bucket, and a request larger than the top bucket
is split into top-bucket chunks, so the forward only ever sees the bucket
shapes. The forward is device preprocessing (one log-mel kernel launch for
all B*S wavs) + backbones (with I3D and ``i3d_fused_inception=True``, one
inception-kernel call per module) + fusion (attention-kernel launches), run
eagerly under ``torch.inference_mode()``.

Usage::

    model = JMTModel(..., dtype=torch.bfloat16)
    init_parameters(model, torch.Generator().manual_seed(0))  # or convert
    server = InferenceServer(model, buckets=(1, 8))           # on cuda
    v, a = server.predict(clips_u8, audio_f32, wavlm)         # (B,S) each
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from jmt_tpu_torch.device import resolve_device
from jmt_tpu_torch.ops.mel import AUDIO_SAMPLES
from jmt_tpu_torch.train.loops import eval_forward


class InferenceServer:
    """Fixed-bucket batched inference on one model."""

    def __init__(self, model, seq: int = 16, buckets: Sequence[int] = (1, 8),
                 img_size: int = 112, use_wavlm: Optional[bool] = None,
                 device=None):
        """device: None = the card (raises when there is none); pass
        ``"cpu"`` to run the plain PyTorch path."""
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.seq = seq
        self.img = img_size
        self.use_wavlm = model.use_wavlm if use_wavlm is None else use_wavlm
        self.wavlm_dim = 768
        self.buckets = sorted(set(int(b) for b in buckets))

    def forward(self, arrays: Dict[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One bucket-shaped batch of device tensors -> (vouts, aouts)."""
        return eval_forward(self.model, arrays)

    def _check(self, clips: np.ndarray, audio: np.ndarray,
               wavlm: Optional[np.ndarray]) -> None:
        n = clips.shape[0]
        want = {"clips": (clips, (n, self.seq, 8, self.img, self.img, 3)),
                "audio": (audio, (n, self.seq, AUDIO_SAMPLES))}
        if self.use_wavlm:
            if wavlm is None:
                raise ValueError("the model has a wavLM path: pass wavlm")
            want["wavlm"] = (wavlm, (n, self.seq, self.wavlm_dim))
        for name, (x, shape) in want.items():
            if tuple(x.shape) != shape:
                raise ValueError(f"{name}: expected shape {shape}, got "
                                 f"{tuple(x.shape)}")

    def predict(self, clips: np.ndarray, audio: np.ndarray,
                wavlm: Optional[np.ndarray] = None
                ) -> Tuple[np.ndarray, np.ndarray]:
        """clips (B,S,8,H,W,3) uint8, audio (B,S,A) f32, wavlm (B,S,768).
        Pads B up to the smallest bucket; splits oversize requests into
        top-bucket chunks. Returns (vouts, aouts) as (B,S) float32."""
        clips = np.asarray(clips, np.uint8)
        audio = np.asarray(audio, np.float32)
        wavlm = None if wavlm is None else np.asarray(wavlm, np.float32)
        self._check(clips, audio, wavlm)
        n = clips.shape[0]
        top = self.buckets[-1]
        if n > top:
            parts = [self.predict(clips[i:i + top], audio[i:i + top],
                                  None if wavlm is None
                                  else wavlm[i:i + top])
                     for i in range(0, n, top)]
            return (np.concatenate([p[0] for p in parts]),
                    np.concatenate([p[1] for p in parts]))
        b = next(x for x in self.buckets if x >= n)

        def to_device(x):
            if x.shape[0] != b:
                x = np.concatenate(
                    [x, np.zeros((b - x.shape[0],) + x.shape[1:], x.dtype)])
            return torch.from_numpy(x).to(self.device)

        arrays = {"clips": to_device(clips), "audio": to_device(audio)}
        if self.use_wavlm:
            arrays["wavlm"] = to_device(wavlm)
        v, a = self.forward(arrays)
        return (v.float().cpu().numpy()[:n], a.float().cpu().numpy()[:n])
