"""Synthetic data source: deterministic in-memory videos and audio.

Counterpart of ``jmt_tpu/data/synthetic.py``, the same generators, so a
path gives the same frame, wav and wavLM feature bit for bit on both
sides. Each is derived from an md5 of the path string, so samples are
reproducible across processes:

* ``synthetic_*``: the smoke source of ``--synthetic N:LEN[:IMG]``
  (mid-gray frames with low-frequency structure, a one-second sine plus
  noise per wav, a 768-d feature per anchor);
* ``learnable_*``: labels encoded in the frames as colour tilts, so a
  trained model must reach a high stitched CCC;
* ``mm_*``: valence in the frames, arousal only in the audio and the
  wavLM features, which a fusion model has to route through.
"""
from __future__ import annotations

import hashlib
from typing import List, Optional

import numpy as np

from jmt_tpu_torch.data.datasets import (IMG_SIZE, VideoRecord,
                                         WavlmFeatureStore, WindowedDataset)
from jmt_tpu_torch.ops.mel import SAMPLE_RATE


def _seed_from(path: str) -> int:
    return int.from_bytes(hashlib.md5(path.encode()).digest()[:4], "little")


def synthetic_frame_loader(path: str) -> Optional[np.ndarray]:
    rng = np.random.default_rng(_seed_from(path))
    # plausible face-crop statistics: mid-gray with low-freq structure
    base = rng.integers(60, 190, size=(IMG_SIZE // 8, IMG_SIZE // 8, 3),
                        dtype=np.uint8)
    img = np.repeat(np.repeat(base, 8, axis=0), 8, axis=1)
    noise = rng.integers(0, 25, size=img.shape, dtype=np.uint8)
    return (img + noise).astype(np.uint8)


def synthetic_audio_loader(path: str) -> Optional[np.ndarray]:
    rng = np.random.default_rng(_seed_from(path))
    n = SAMPLE_RATE  # one second
    t = np.arange(n) / SAMPLE_RATE
    f0 = float(rng.uniform(120, 300))
    x = (0.25 * np.sin(2 * np.pi * f0 * t)
         + 0.05 * rng.normal(size=n))
    return x.astype(np.float32)


def synthetic_wavlm_loader(path: str) -> Optional[np.ndarray]:
    """Deterministic 768-d 'WavLM' feature derived from the path string —
    stands in for the precomputed per-frame ``{video}/{n}.npy`` files
    (train.py:150-171 surface) so the FULL flagship config (incl. the
    wavLM audio backbone) smoke-drives with ``--synthetic``."""
    rng = np.random.default_rng(_seed_from(path))
    return rng.normal(scale=0.1, size=768).astype(np.float32)


def synthetic_wavlm_store():
    return WavlmFeatureStore("/synthetic/wavlm",
                             loader=synthetic_wavlm_loader)


def synthetic_records(n_videos: int = 2, length: int = 481,
                      missing_every: int = 0, seed: int = 0
                      ) -> List[VideoRecord]:
    """Videos with frame ids 1..length (optionally dropping every k-th frame
    to exercise the decimation/placeholder paths) and smooth V/A traces."""
    records = []
    for vi in range(n_videos):
        rng = np.random.default_rng(seed + vi)
        ids = np.arange(1, length + 1)
        if missing_every > 1:
            ids = ids[ids % missing_every != 0]
        t = ids / 30.0
        phase = rng.uniform(0, np.pi)
        v = 0.7 * np.sin(2 * np.pi * t / 20 + phase)
        a = 0.6 * np.sin(2 * np.pi * t / 31 + phase * 0.5)
        records.append(VideoRecord(
            name=f"synth{vi:03d}",
            image_paths=[f"synth{vi:03d}/{i:05d}.jpg" for i in ids],
            labels_v=v.astype(np.float32),
            labels_a=a.astype(np.float32),
            frame_ids=ids.astype(np.int64),
            length=length,
            wav_dir=f"/synthetic/audio/synth{vi:03d}",
        ))
    return records


def synthetic_dataset(split: str, n_videos: int = 2, length: int = 481,
                      missing_every: int = 0, stride: int = 1,
                      img_size: int = IMG_SIZE,
                      check_coverage: bool = True) -> WindowedDataset:
    return WindowedDataset(
        synthetic_records(n_videos, length, missing_every), split=split,
        stride=stride,
        frame_loader=synthetic_frame_loader,
        audio_loader=synthetic_audio_loader,
        img_size=img_size, check_coverage=check_coverage)


# ---------------------------------------------------------------------------
# LEARNABLE synthetic data: labels are a deterministic function of frame
# CONTENT (not independent traces), so an end-to-end training run must
# reach high stitched CCC — a whole-system learnability check that catches
# cross-module wiring bugs (feature/label misalignment through windowing /
# decimation / stitching) that per-module parity tests cannot.
# ---------------------------------------------------------------------------
def learnable_frame_loader(path: str) -> Optional[np.ndarray]:
    """Frame pixels encode the labels as COLOR TILTS around a fixed base
    brightness: red-blue tilt ~ valence, green-vs-mean tilt ~ arousal
    (values parsed from the frame filename, which learnable_records bakes
    them into).

    Tilt encoding (not raw brightness) on purpose: the train path applies
    the reference's per-clip brightness/contrast jitter ~U(0.8, 1.2)
    (transforms.preprocess_clips, intensity.py:259-317), which multiplies
    pixel values — a brightness-encoded label would be corrupted beyond
    learnability, while channel DIFFERENCES only scale by the factor
    (sign + ratio preserved, CCC ceiling ~0.99)."""
    stem = path.rsplit("/", 1)[-1].rsplit(".", 1)[0]
    _, v_s, a_s = stem.split("_")
    v, a = float(v_s), float(a_s)
    rng = np.random.default_rng(_seed_from(path))
    img = np.empty((IMG_SIZE, IMG_SIZE, 3), np.float32)
    img[..., 0] = 128.0 + 52.0 * v
    img[..., 1] = 128.0 + 52.0 * a
    img[..., 2] = 128.0 - 52.0 * v
    img += rng.normal(0, 6.0, size=img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def learnable_records(n_videos: int = 3, length: int = 961,
                      seed: int = 0) -> List[VideoRecord]:
    """Slow label traces (period ~8 s = 240 frames, >> the 32-frame
    subsequence span) so every frame of a clip carries its anchor label."""
    records = []
    for vi in range(n_videos):
        rng = np.random.default_rng(seed + 100 + vi)
        ids = np.arange(1, length + 1)
        t = ids / 30.0
        pv, pa = rng.uniform(0, 2 * np.pi, size=2)
        v = 0.8 * np.sin(2 * np.pi * t / 8.0 + pv)
        a = 0.7 * np.sin(2 * np.pi * t / 11.0 + pa)
        records.append(VideoRecord(
            name=f"learn{vi:03d}",
            image_paths=[f"learn{vi:03d}/{i:05d}_{v[k]:+.4f}_{a[k]:+.4f}.jpg"
                         for k, i in enumerate(ids)],
            labels_v=v.astype(np.float32),
            labels_a=a.astype(np.float32),
            frame_ids=ids.astype(np.int64),
            length=length,
            wav_dir=f"/synthetic/audio/learn{vi:03d}",
        ))
    return records


def learnable_dataset(split: str, n_videos: int = 3, length: int = 961,
                      stride: int = 32, img_size: int = 32, seed: int = 0,
                      records=None, audio_loader=None) -> WindowedDataset:
    """Anchor coverage note: window anchors are always ≡ 1 (mod 32) unless
    stride makes window ends sweep all residues — with stride=1 every frame
    1..length receives a prediction (the reference's shipped setting);
    any other stride leaves stitch gaps, so the coverage check is enabled
    exactly for the stride-1 eval geometry."""
    return WindowedDataset(
        records if records is not None
        else learnable_records(n_videos, length, seed), split=split,
        stride=stride,
        frame_loader=learnable_frame_loader,
        audio_loader=audio_loader or synthetic_audio_loader,
        img_size=img_size,
        check_coverage=(stride == 1 and split != "train"))


# ---------------------------------------------------------------------------
# MULTIMODAL learnable data: VALENCE lives ONLY in the frames (red-blue
# tilt), AROUSAL lives ONLY in the audio (tone frequency) and the wavLM
# features — so a full-fusion model must route the audio signal through
# intra-modal fusion and the JMT cross-attention stack to score on the
# arousal axis, while a vision-only model provably cannot. Every generator below is a pure
# function of (seed, video index, frame id), so the frame/audio/wavLM
# loaders recompute the SAME traces from the path strings alone.
# ---------------------------------------------------------------------------
def _mm_trace(seed: int, vi: int, frame_ids: np.ndarray):
    rng = np.random.default_rng(seed + 500 + vi)
    pv, pa = rng.uniform(0, 2 * np.pi, size=2)
    t = frame_ids / 30.0
    v = 0.8 * np.sin(2 * np.pi * t / 8.0 + pv)
    a = 0.7 * np.sin(2 * np.pi * t / 11.0 + pa)
    return v.astype(np.float32), a.astype(np.float32)


def _mm_parse(path: str):
    """.../learnmm{seed:03d}{vi:03d}/{frame}.{ext} -> (seed, vi, frame).

    The seed rides IN the video name (not just a parent dir) because the
    WavlmFeatureStore joins by video name alone ({root}/{vid}/{n}.npy):
    with bare names, train (seed 0) and val (seed 7) videos would collide
    and the store would serve a val video a train video's features."""
    parts = path.split("/")
    stem = parts[-1].rsplit(".", 1)[0]
    digits = parts[-2][len("learnmm"):]
    return int(digits[:-3]), int(digits[-3:]), int(stem)


def mm_frame_loader(path: str) -> Optional[np.ndarray]:
    """Valence as a red-blue tilt (jitter-robust, see learnable_frame_loader
    note); the green channel is NEUTRAL — no arousal information."""
    seed, vi, fid = _mm_parse(path)
    v, _ = _mm_trace(seed, vi, np.asarray([fid], np.float64))
    rng = np.random.default_rng(_seed_from(path))
    img = np.empty((IMG_SIZE, IMG_SIZE, 3), np.float32)
    img[..., 0] = 128.0 + 52.0 * v[0]
    img[..., 1] = 128.0
    img[..., 2] = 128.0 - 52.0 * v[0]
    img += rng.normal(0, 6.0, size=img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def mm_audio_loader(path: str) -> Optional[np.ndarray]:
    """Arousal as tone FREQUENCY: f = 450 + 350*a Hz (100..800 Hz spans many
    mel bins; frequency, unlike amplitude, survives gain-style transforms).
    The wav at anchor n encodes a(n) exactly — per-clip alignment with the
    anchor labels the windower emits."""
    seed, vi, fid = _mm_parse(path)
    _, a = _mm_trace(seed, vi, np.asarray([fid], np.float64))
    rng = np.random.default_rng(_seed_from(path))
    n = SAMPLE_RATE
    t = np.arange(n) / SAMPLE_RATE
    f0 = 450.0 + 350.0 * float(a[0])
    x = 0.3 * np.sin(2 * np.pi * f0 * t) + 0.02 * rng.normal(size=n)
    return x.astype(np.float32)


def mm_blind_audio_loader(path: str) -> Optional[np.ndarray]:
    """Control for the fusion learnability e2e: audio with NO arousal
    coding (fixed 450 Hz tone + noise). A model trained on this cannot
    recover the audio-coded axis unless a leak exists elsewhere."""
    rng = np.random.default_rng(_seed_from(path))
    n = SAMPLE_RATE
    t = np.arange(n) / SAMPLE_RATE
    x = 0.3 * np.sin(2 * np.pi * 450.0 * t) + 0.02 * rng.normal(size=n)
    return x.astype(np.float32)


def mm_wavlm_loader(path: str) -> Optional[np.ndarray]:
    """'WavLM' features carrying arousal linearly in the first dims — joins
    through WavlmFeatureStore ({root}/{vid}/{anchor}.npy), so a wavlm
    misjoin (wrong video/frame) destroys the signal and fails the e2e."""
    seed, vi, fid = _mm_parse(path)
    _, a = _mm_trace(seed, vi, np.asarray([fid], np.float64))
    rng = np.random.default_rng(_seed_from(path))
    feat = rng.normal(scale=0.05, size=768).astype(np.float32)
    feat[:16] += a[0]
    return feat


def mm_records(n_videos: int = 3, length: int = 961,
               seed: int = 0) -> List[VideoRecord]:
    records = []
    for vi in range(n_videos):
        ids = np.arange(1, length + 1)
        v, a = _mm_trace(seed, vi, ids.astype(np.float64))
        # seed-unique video names — see _mm_parse for why this is load-
        # bearing (the wavlm store joins by name alone)
        name = f"learnmm{seed:03d}{vi:03d}"
        records.append(VideoRecord(
            name=name,
            image_paths=[f"{seed}/{name}/{i:05d}.jpg" for i in ids],
            labels_v=v,
            labels_a=a,
            frame_ids=ids.astype(np.int64),
            length=length,
            wav_dir=f"/synthetic/mmaudio/{seed}/{name}",
        ))
    return records


def mm_learnable_dataset(split: str, n_videos: int = 3, length: int = 961,
                         stride: int = 32, img_size: int = 32,
                         seed: int = 0,
                         audio_informative: bool = True) -> WindowedDataset:
    """audio_informative=False swaps in the blind audio loader (fixed
    tone, no arousal coding) — the negative control for the fusion e2e:
    the config lattice (reference parity) requires an audio backbone, so
    'the model cannot see arousal' is expressed through the DATA."""
    return WindowedDataset(
        mm_records(n_videos, length, seed), split=split, stride=stride,
        frame_loader=mm_frame_loader,
        audio_loader=(mm_audio_loader if audio_informative
                      else mm_blind_audio_loader),
        img_size=img_size,
        check_coverage=(stride == 1 and split != "train"))


def mm_wavlm_store(seed: int = 0):
    return WavlmFeatureStore(f"/synthetic/mmwavlm/{seed}",
                             loader=mm_wavlm_loader)
