"""Sliding-window and subsequence geometry of the reference's sequence
readers, as pure index computations (numpy).

Counterpart of ``jmt_tpu/data/windowing.py``, the same code:

* label windows of ``win_length`` (512) frames ending at ``end``, from
  end = 481; after every 32 windows the end jumps +480+stride, otherwise
  +stride. Train loops while ``end < length + 481``, val/test while
  ``end < length + 482`` (one window more, the reference's asymmetry);
* each window is 16 subsequences; subsequence i covers frame ids
  (start+32i, start+32(i+1)] and is anchored at its upper bound
  ``ub = end - (15-i)*32``; its wav is ``{wavdir}/{ub}.wav``;
* the frames present in that range are decimated to exactly 8 by a
  stride of 1/2/3/4 taken from the END, or the last frame repeated
  (``decimate_subsequence``);
* train drops a window with an empty subsequence or an anchor past the
  video's length; val/test keep every window, with placeholder clips
  (no rows, labels -5), so predictions stitch per video;
* with stride 1 the anchors cover every frame id (``coverage_check``).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

# corrupt videos excluded from training (dataset_new.py:45-47)
TRAIN_SKIP_VIDS = ('313.csv', '212.csv', '303.csv', '171.csv',
                   '40-30-1280x720.csv', '286.csv', '270.csv', '234.csv',
                   '239.csv', '266.csv')

SUBSEQS_PER_WINDOW = 16
FRAMES_PER_SUBSEQ = 32
CLIP_LEN = 8


def decimate_subsequence(sub_indices: np.ndarray) -> Optional[np.ndarray]:
    """Reduce the csv-row indices of one subsequence to exactly 8.

    Exact transcription of the branch ladder in dataset_new.py:116-138:
    n in [8,16): last 8; [16,24): every 2nd from the end then last 8;
    [24,32): every 3rd from the end then last 8; ==32: every 4th from the
    end; (0,8): repeat the last index; 0: missing (None).
    """
    n = len(sub_indices)
    if n == 0:
        return None
    if 8 <= n < 16:
        return sub_indices[-8:]
    if 16 <= n < 24:
        return np.flip(np.flip(sub_indices)[::2])[-8:]
    if 24 <= n < 32:
        return np.flip(np.flip(sub_indices)[::3])[-8:]
    if n == 32:
        return np.flip(np.flip(sub_indices)[::4])
    if n < 8:
        pad = np.full(8 - n, sub_indices[-1], dtype=sub_indices.dtype)
        return np.concatenate([sub_indices, pad])
    raise AssertionError(f"subsequence larger than 32 frames: {n}")


@dataclasses.dataclass
class Clip:
    """One 8-frame decimated subsequence.

    rows: indices into the video's annotation rows (None = placeholder);
    anchor: the upper-bound frame id — prediction target frame AND wav stem.
    """
    rows: Optional[np.ndarray]
    anchor: int


@dataclasses.dataclass
class WindowSample:
    clips: List[Clip]  # length 16


def _window_anchors(end: int) -> List[Tuple[int, int]]:
    """[(lower_bound, anchor/ub)] for the 16 subsequences of one window."""
    start = end - FRAMES_PER_SUBSEQ * SUBSEQS_PER_WINDOW  # == end - 512
    return [(start + i * FRAMES_PER_SUBSEQ + 1,
             end - (15 - i) * FRAMES_PER_SUBSEQ)
            for i in range(SUBSEQS_PER_WINDOW)]


def _iter_window_ends(length: int, stride: int, extra: int):
    """Yield window 'end' values: 32 consecutive strides then a +480 jump
    (dataset_new.py:145-154). extra=481 train, 482 val/test."""
    end = 481
    counter = 0
    while end < length + extra:
        yield end
        counter += 1
        if counter > 31:
            end = end + 480 + stride
            counter = 0
        else:
            end = end + stride


def train_windows(frame_ids: np.ndarray, length: int,
                  win_length: int = 512, stride: int = 1
                  ) -> Tuple[List[WindowSample], List[int]]:
    """Train geometry. Returns (samples, emitted_anchors).

    A window is kept only if all 16 subsequences are non-empty AND their
    anchors are within the video (dataset_new.py:115-143).
    """
    assert win_length == SUBSEQS_PER_WINDOW * FRAMES_PER_SUBSEQ, win_length
    frame_ids = np.asarray(frame_ids, dtype=np.int64)
    samples: List[WindowSample] = []
    emitted: List[int] = []
    for end in _iter_window_ends(length, stride, extra=481):
        clips: List[Clip] = []
        for lb, ub in _window_anchors(end):
            if ub > length:
                continue
            emitted.append(ub)
            idx = np.where((frame_ids >= lb) & (frame_ids <= ub))[0]
            rows = decimate_subsequence(idx)
            if rows is not None:
                clips.append(Clip(rows=rows, anchor=ub))
        if len(clips) == SUBSEQS_PER_WINDOW:
            samples.append(WindowSample(clips=clips))
    return samples, emitted


def eval_windows(frame_ids: np.ndarray, length: int,
                 win_length: int = 512, stride: int = 1
                 ) -> Tuple[List[WindowSample], List[int]]:
    """Val/test geometry: EVERY window is emitted; missing subsequences
    become placeholders (rows=None) so per-video stitching sees a
    prediction slot for every anchor (dataset_val.py:95-143)."""
    assert win_length == SUBSEQS_PER_WINDOW * FRAMES_PER_SUBSEQ, win_length
    frame_ids = np.asarray(frame_ids, dtype=np.int64)
    samples: List[WindowSample] = []
    emitted: List[int] = []
    for end in _iter_window_ends(length, stride, extra=482):
        clips: List[Clip] = []
        for lb, ub in _window_anchors(end):
            if ub <= length:
                emitted.append(ub)
            idx = np.where((frame_ids >= lb) & (frame_ids <= ub))[0]
            rows = decimate_subsequence(idx)
            clips.append(Clip(rows=rows, anchor=ub))
        samples.append(WindowSample(clips=clips))
    return samples, emitted


def coverage_check(emitted: Sequence[int], length: int) -> bool:
    """The reference's windowing invariant: the distinct anchors must cover
    every frame id 1..length (dataset_new.py:156-162)."""
    return len(set(emitted)) == length


def sort_files_by_basename(files: Sequence[str]) -> List[str]:
    """Deterministic video ordering (dataset_new.py:29-36)."""
    import os
    return [f for _, f in sorted((os.path.basename(p), p) for p in files)]
