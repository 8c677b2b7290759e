"""Offline preprocessing tools for an Affwild2-layout tree.

Counterpart of ``jmt_tpu/data/preprocessing.py``, with the ``csv`` module
and numpy where JAX's uses pandas (the card machine has no pandas); the
files written are JAX's byte for byte:

* ``convert_va_annotations``: Affwild2 ``VA_Set`` txt annotations -> one
  CSV per video, ``,img,V,A,frame_id`` with pandas' index column, ``-5``
  rows dropped (the reference's datasets/preprocessing.py:31-75);
* ``explode_wavlm_features``: per-video WavLM CSVs -> per-frame
  ``{n}.npy`` (create_wavlm_audio_feat.py:7-33), 768 features by default
  (what training consumes);
* ``write_realtimestamps``: a ``{video}_video_ts.txt`` in the reference's
  format, one timestamp line per frame.
"""
from __future__ import annotations

import csv
import os
from typing import List, Optional

import numpy as np


def frame_name(i: int) -> str:
    """1-based zero-padded frame file stem (preprocessing.py:17-29)."""
    return f"{i:05d}"


def convert_va_annotations(anno_dir: str, out_dir: str) -> List[str]:
    """Each ``{video}.txt`` (a header line, then 'V,A' per frame) ->
    ``{video}.csv`` with columns img,V,A,frame_id after pandas' index
    column; rows with a -5 dropped. Floats are written as pandas writes
    them (the shortest repr that round-trips)."""
    os.makedirs(out_dir, exist_ok=True)
    written = []
    for fname in sorted(os.listdir(anno_dir)):
        if not fname.endswith(".txt"):
            continue
        video = os.path.splitext(fname)[0]
        with open(os.path.join(anno_dir, fname)) as f:
            lines = f.readlines()[1:]  # skip the 'valence,arousal' header
        rows = []
        for i, line in enumerate(lines):
            parts = line.strip().split(",")
            if len(parts) < 2 or parts[0] == "-5" or parts[1] == "-5":
                continue
            rows.append((f"{video}/{frame_name(i + 1)}.jpg",
                         repr(float(parts[0])), repr(float(parts[1])),
                         frame_name(i + 1)))
        out = os.path.join(out_dir, f"{video}.csv")
        with open(out, "w", newline="") as f:
            w = csv.writer(f, lineterminator="\n")
            w.writerow(["", "img", "V", "A", "frame_id"])
            w.writerows([j, *row] for j, row in enumerate(rows))
        written.append(out)
    return written


def _read_feature_csv(path: str) -> np.ndarray:
    """A feature CSV's rows under its header line, every column as
    float64."""
    with open(path, newline="") as f:
        header, *rows = csv.reader(f)
    return np.array([[float(x) for x in row] for row in rows if row],
                    dtype=np.float64).reshape(-1, len(header))


def explode_wavlm_features(source_dir: str, dest_dir: str,
                           feature_dim: Optional[int] = 768) -> int:
    """Per-video WavLM CSVs (rows = frames) -> {dest}/{video}/{n}.npy,
    float32, n starting at 1. Returns the number of .npy files written."""
    count = 0
    for fname in sorted(os.listdir(source_dir)):
        path = os.path.join(source_dir, fname)
        if not os.path.isfile(path):
            continue
        video = os.path.splitext(fname)[0]
        out_dir = os.path.join(dest_dir, video)
        os.makedirs(out_dir, exist_ok=True)
        feats = _read_feature_csv(path).astype(np.float32)
        if feature_dim is not None:
            feats = feats[:, :feature_dim]
        for i in range(feats.shape[0]):
            np.save(os.path.join(out_dir, f"{i + 1}.npy"), feats[i])
            count += 1
    return count


def write_realtimestamps(out_dir: str, video: str, n_frames: int,
                         fps: float = 30.0) -> str:
    """``{video}_video_ts.txt`` in the reference's format: a header line
    and one timestamp line per frame."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{video}_video_ts.txt")
    with open(path, "w") as f:
        f.write("timestamp\n")
        for i in range(n_frames):
            f.write(f"{i / fps:.6f}\n")
    return path
