"""Offline WavLM feature extraction on the card.

Counterpart of ``jmt_tpu/data/wavlm_extract.py``: per-video wav ->
resample to 16 kHz (``scipy.signal.resample_poly`` on the host) ->
normalized over the whole track -> WavLM (``models/wavlm.py``) over
fixed-size overlapping windows, ``batch`` windows a forward -> one (dim,)
``.npy`` per video frame, ``{dest}/{video}/{frame_idx}.npy`` from frame 1:
the layout the wavLM store of ``data/datasets`` reads.

WavLM emits one frame every 320 input samples (20 ms at 16 kHz); video
frame i at time (i + 0.5) / fps takes the WavLM frame whose receptive
field is centred nearest. Windows overlap by ``overlap_s`` on each side
and only their interior is kept, so every emitted frame has at least
``overlap_s`` of real left context.

    python -m jmt_tpu_torch.data.wavlm_extract --checkpoint wavlm.pt \\
        --wav-dir /data/audio --dest /data/wavlm_feats --fps 30 [--device cpu]

The checkpoint is a ``torch.save``d state dict of a Hugging Face
``WavLMModel`` (optionally ``wavlm.``-prefixed), read with
``weights_only=True``: a file that pickles a whole module is refused
(save its ``state_dict()`` instead). The run is on the card unless
``--device cpu`` says otherwise.
"""
from __future__ import annotations

import argparse
import os
import pickle
import wave
from typing import Optional, Tuple

import numpy as np
import torch

from jmt_tpu_torch.data.audio_io import load_wav
from jmt_tpu_torch.device import resolve_device
from jmt_tpu_torch.models.wavlm import WavLMConfig, WavLMModel

WAVLM_SR = 16000  # WavLM operates on 16 kHz input
_PARTS = ("feature_extractor.", "feature_projection.", "encoder.")


def load_wav_any_sr(path: str) -> Optional[Tuple[np.ndarray, int]]:
    """float32 mono (L,) in [-1, 1] plus its sample rate."""
    data = load_wav(path)
    if data is None:
        return None
    with wave.open(path, "rb") as w:
        sr = w.getframerate()
    return data, sr


def resample_to_16k(data: np.ndarray, sr: int) -> np.ndarray:
    if sr == WAVLM_SR:
        return data
    from math import gcd
    from scipy.signal import resample_poly
    g = gcd(sr, WAVLM_SR)
    return resample_poly(data, WAVLM_SR // g, sr // g).astype(np.float32)


class WavLMExtractor:
    """Full-track WavLM features by overlapping fixed-size windows."""

    def __init__(self, model: WavLMModel, window_s: float = 20.0,
                 overlap_s: float = 2.0, batch: int = 4, device=None):
        """device: None = the card (raises when there is none); ``"cpu"``
        runs on the CPU."""
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        cfg = self.cfg = model.cfg
        self.stride = cfg.frame_stride          # 320 for base configs
        self.receptive = cfg.receptive_field    # 400 for base configs
        # the window, a whole number of WavLM frames
        self.win_frames = int(window_s * WAVLM_SR) // self.stride
        self.ov_frames = max(1, int(overlap_s * WAVLM_SR) // self.stride)
        if self.win_frames <= 2 * self.ov_frames:
            raise ValueError(f"window_s {window_s} must exceed twice "
                             f"overlap_s {overlap_s}")
        self.win_samples = (self.win_frames - 1) * self.stride \
            + self.receptive
        self.batch = max(1, int(batch))  # windows per forward

    def features(self, wav16k: np.ndarray) -> np.ndarray:
        """(T, hidden) for a float32 (L,) track at 16 kHz, not normalized:
        zero-mean / unit-variance is applied once over the whole track
        (as Hugging Face's feature extractor normalizes a sequence), then
        the track is windowed and each window's interior kept."""
        wav16k = np.asarray(wav16k, np.float32)
        wav16k = (wav16k - wav16k.mean()) / (wav16k.std() + 1e-7)
        n = len(wav16k)
        total = max(1, (max(0, n - self.receptive) // self.stride) + 1)
        hop = self.win_frames - 2 * self.ov_frames
        # window placements (w0, lo, hi): frames [lo, hi) of the window
        # starting at frame w0 are kept; the window reaches ov_frames left
        # of the frames it keeps, clamped at the track's ends
        plans = []
        start_f = 0
        while start_f < total:
            w0 = max(0, start_f - self.ov_frames)
            w0 = min(w0, max(0, total - self.win_frames))
            lo = start_f - w0
            hi = min(lo + hop, total - w0, self.win_frames)
            plans.append((w0, lo, hi))
            start_f = w0 + hi

        out = np.zeros((total, self.cfg.hidden_size), np.float32)
        for i in range(0, len(plans), self.batch):
            part = plans[i:i + self.batch]
            chunks = np.zeros((self.batch, self.win_samples), np.float32)
            for j, (w0, _, _) in enumerate(part):
                s0 = w0 * self.stride
                c = wav16k[s0:s0 + self.win_samples]
                chunks[j, :len(c)] = c
            with torch.inference_mode():
                feats = self.model(torch.from_numpy(chunks).to(
                    self.device)).float().cpu().numpy()
            for j, (w0, lo, hi) in enumerate(part):
                out[w0 + lo:w0 + hi] = feats[j, lo:hi]
        return out

    def per_frame(self, wav16k: np.ndarray, n_frames: int,
                  fps: float) -> np.ndarray:
        """(n_frames, hidden): per video frame, the WavLM frame whose
        receptive field [k*stride, k*stride + receptive) is centred
        nearest to the frame's time."""
        feats = self.features(wav16k)
        t = (np.arange(n_frames) + 0.5) / fps
        idx = np.clip(np.round(
            (t * WAVLM_SR - self.receptive / 2) / self.stride).astype(int),
            0, len(feats) - 1)
        return feats[idx]


def load_torch_checkpoint(path: str, cfg: Optional[WavLMConfig] = None
                          ) -> Tuple[WavLMModel, WavLMConfig]:
    """A state-dict file -> (WavLMModel on the CPU, its config).

    Without ``cfg`` the geometry (dims, kernels, layer and head counts,
    buckets, conv bias) is read from the state dict; conv strides are not
    recoverable from weights, so the base schedule is assumed and a stack
    of another depth raises: pass ``cfg`` for other geometries."""
    try:
        sd = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError as e:
        raise ValueError(
            f"{path}: not a plain state dict (the file pickles objects, "
            f"perhaps a whole module); save the model's state_dict() and "
            f"load that") from e
    if "state_dict" in sd and isinstance(sd["state_dict"], dict):
        sd = sd["state_dict"]
    sd = {k[len("wavlm."):] if k.startswith("wavlm.") else k: v
          for k, v in sd.items()}
    # heads of a wrapping model (projector, classifier) are not WavLM's
    sd = {k: v for k, v in sd.items() if k.startswith(_PARTS)}
    if cfg is None:
        n_conv = 1 + max(int(k.split(".")[2]) for k in sd
                         if k.startswith("feature_extractor.conv_layers."))
        n_layers = 1 + max(int(k.split(".")[2]) for k in sd
                           if k.startswith("encoder.layers."))
        defaults = WavLMConfig()
        if n_conv != len(defaults.conv_stride):
            raise ValueError(f"{path}: a stack of {n_conv} convs is not the "
                             f"base geometry; pass an explicit cfg")
        dims, kernels = [], []
        for i in range(n_conv):
            w = sd[f"feature_extractor.conv_layers.{i}.conv.weight"]
            dims.append(w.shape[0])
            kernels.append(w.shape[2])
        cfg = WavLMConfig(
            hidden_size=sd["feature_projection.projection.bias"].shape[0],
            num_hidden_layers=n_layers,
            num_attention_heads=sd["encoder.layers.0.attention"
                                   ".gru_rel_pos_const"].numel(),
            intermediate_size=sd["encoder.layers.0.feed_forward"
                                 ".intermediate_dense.bias"].shape[0],
            conv_dim=tuple(dims), conv_stride=defaults.conv_stride,
            conv_kernel=tuple(kernels),
            conv_bias="feature_extractor.conv_layers.0.conv.bias" in sd,
            num_buckets=sd["encoder.layers.0.attention.rel_attn_embed"
                           ".weight"].shape[0])
    model = WavLMModel(cfg)
    model.load_state_dict(sd, strict=True)
    return model.eval(), cfg


def extract_tree(checkpoint: str, wav_dir: str, dest: str, fps: float,
                 window_s: float = 20.0, overlap_s: float = 2.0,
                 n_frames_for=None, verbose: bool = True,
                 cfg: Optional[WavLMConfig] = None, device=None) -> int:
    """Every {wav_dir}/{video}.wav -> {dest}/{video}/{n}.npy per frame;
    returns the frames written.

    n_frames_for(video, duration_s) -> frame count; default
    round(duration * fps) (pass the annotation row count for exact
    Affwild2 alignment)."""
    model, cfg = load_torch_checkpoint(checkpoint, cfg)
    ex = WavLMExtractor(model, window_s, overlap_s, device=device)
    written = 0
    for fname in sorted(os.listdir(wav_dir)):
        if not fname.endswith(".wav"):
            continue
        video = os.path.splitext(fname)[0]
        loaded = load_wav_any_sr(os.path.join(wav_dir, fname))
        if loaded is None:
            continue
        data, sr = loaded
        wav16 = resample_to_16k(data, sr)
        dur = len(data) / sr
        n_frames = (n_frames_for(video, dur) if n_frames_for
                    else int(round(dur * fps)))
        feats = ex.per_frame(wav16, n_frames, fps)
        out_dir = os.path.join(dest, video)
        os.makedirs(out_dir, exist_ok=True)
        for i in range(n_frames):
            np.save(os.path.join(out_dir, f"{i + 1}.npy"), feats[i])
        written += n_frames
        if verbose:
            print(f"{video}: {n_frames} frames", flush=True)
    return written


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="per-frame WavLM features of every wav in a directory")
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--wav-dir", required=True)
    ap.add_argument("--dest", required=True)
    ap.add_argument("--fps", type=float, default=30.0)
    ap.add_argument("--window-s", type=float, default=20.0)
    ap.add_argument("--overlap-s", type=float, default=2.0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs on "
                         "the CPU)")
    args = ap.parse_args(argv)
    n = extract_tree(args.checkpoint, args.wav_dir, args.dest, args.fps,
                     args.window_s, args.overlap_s, device=args.device)
    print(f"wrote {n} per-frame features under {args.dest}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
