"""Per-video prediction stitching, smoothing, CCC and challenge files.

Counterpart of ``jmt_tpu/eval/stitch.py`` and of the stitch tail of the
JAX ``Runner.validate`` / ``Runner.test`` (``jmt_tpu/train/runner.py``):

* each window's per-timestep predictions land in per-video traces at index
  anchor - 1; anchors past the video's length are dropped; a frame whose
  label is -5.0 keeps prediction 0 AND label 0, and still enters the CCC
  (the reference does the same);
* per video: clip to [-1, 1], then the moving average (valence 20,
  arousal 50, zero fill); then ONE CCC (``ccc_metric``) over all videos
  concatenated;
* test mode writes ``{vid}.txt`` in the challenge format
  (``image_location,valence,arousal``, %.5f values); both modes can dump
  the traces to a pickle in the reference's layout.

Host side: numpy, with the port's own smoothing and ``ccc_metric``.
``validate`` and ``test`` drive an eval step over ordered windows.
"""
from __future__ import annotations

import os
import pickle
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from jmt_tpu_torch.ops.ccc import ccc_metric
from jmt_tpu_torch.ops.smoothing import uniform_filter1d


class Stitcher:
    """Accumulates per-window predictions into per-video traces."""

    def __init__(self, with_labels: bool = True):
        self.with_labels = with_labels
        self.pred_v: Dict[str, np.ndarray] = {}
        self.pred_a: Dict[str, np.ndarray] = {}
        self.label_v: Dict[str, np.ndarray] = {}
        self.label_a: Dict[str, np.ndarray] = {}
        # a video's windows must arrive in order: overlapping windows
        # overwrite (last write wins), so the order changes the result
        self._last_anchor: Dict[str, int] = {}
        # the eval windows cover every frame 1..length, so a video is
        # complete once its highest in-range anchor reaches its length
        self.lengths: Dict[str, int] = {}
        self._max_anchor: Dict[str, int] = {}

    def add_batch(self, vouts: np.ndarray, aouts: np.ndarray,
                  anchors: np.ndarray, videos: Sequence[str],
                  lengths: Sequence[int],
                  labels_v: Optional[np.ndarray] = None,
                  labels_a: Optional[np.ndarray] = None,
                  n_real: Optional[int] = None) -> None:
        """vouts, aouts, anchors: (B, S); videos, lengths: per row.
        n_real: the rows that are not static-batch padding."""
        b = len(videos) if n_real is None else n_real
        for i in range(b):
            vid, length = videos[i], int(lengths[i])
            first = int(anchors[i][0])
            if vid not in self.pred_v:
                # the reference stops unless a video's first frame seen
                # is frame 1
                if first > 1:
                    raise ValueError(
                        f"out-of-order windows for {vid}: first anchor "
                        f"{first} != 1")
                for traces in (self.pred_v, self.pred_a, self.label_v,
                               self.label_a):
                    traces[vid] = np.zeros(length)
                self.lengths[vid] = length
                self._max_anchor[vid] = 0
            elif first < self._last_anchor.get(vid, 0):
                raise ValueError(
                    f"non-sequential windows for {vid}: anchor {first} "
                    f"after {self._last_anchor[vid]}; eval batches must "
                    f"arrive in dataset order")
            self._last_anchor[vid] = first
            for j in range(vouts.shape[1]):
                fid = int(anchors[i][j])
                if fid > length:
                    continue
                self._max_anchor[vid] = max(self._max_anchor[vid], fid)
                if self.with_labels:
                    lv, la = float(labels_v[i][j]), float(labels_a[i][j])
                    if lv == -5.0 or la == -5.0:
                        continue    # stays (0, 0), and in the CCC
                    self.label_v[vid][fid - 1] = lv
                    self.label_a[vid][fid - 1] = la
                self.pred_v[vid][fid - 1] = float(vouts[i][j])
                self.pred_a[vid][fid - 1] = float(aouts[i][j])

    def is_complete(self, vid: str) -> bool:
        """True once every frame of ``vid`` was written; a video never fed
        is not complete."""
        if vid not in self.lengths:
            return False
        return self._max_anchor.get(vid, 0) >= self.lengths[vid]

    def smoothed(self, v_size: int = 20, a_size: int = 50
                 ) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
        """Per video, the clipped and smoothed V and A traces (float32)."""
        def smooth(trace, size):
            x = torch.from_numpy(np.clip(trace, -1.0, 1.0))
            return uniform_filter1d(x, size).numpy()

        return ({vid: smooth(self.pred_v[vid], v_size)
                 for vid in self.pred_v},
                {vid: smooth(self.pred_a[vid], a_size)
                 for vid in self.pred_v})

    def scores(self) -> Tuple[float, float]:
        """(ccc_v, ccc_a) over all videos concatenated."""
        sv, sa = self.smoothed()

        def cat(traces):
            return torch.from_numpy(np.concatenate(
                [traces[k] for k in self.pred_v]).astype(np.float32))

        return (float(ccc_metric(cat(sv), cat(self.label_v))),
                float(ccc_metric(cat(sa), cat(self.label_a))))

    def dump_pkl(self, path: str) -> None:
        """The reference's eval pickle: ``{"trg": {"vl", "ar"}, "pred":
        {"vl", "ar"}}``, each a dict of per-video traces."""
        sv, sa = self.smoothed()
        data = {"trg": ({"vl": self.label_v, "ar": self.label_a}
                        if self.with_labels else {"vl": None, "ar": None}),
                "pred": {"vl": sv, "ar": sa}}
        with open(path, "wb") as f:
            pickle.dump(data, f, protocol=pickle.HIGHEST_PROTOCOL)


def write_challenge_txt(stitcher: Stitcher, dir_out: str) -> List[str]:
    """One ``{vid}.txt`` per video in the challenge format; returns the
    paths."""
    os.makedirs(dir_out, exist_ok=True)
    sv, sa = stitcher.smoothed()
    written = []
    for vid in sv:
        path = os.path.join(dir_out, vid + ".txt")
        with open(path, "w") as f:
            f.write("image_location,valence,arousal\n")
            for i in range(len(sv[vid])):
                f.write(f"{vid}/{i + 1:05d}.jpg,{sv[vid][i]:.5f},"
                        f"{sa[vid][i]:.5f}\n")
        written.append(path)
    return written


def _stitch(eval_step: Callable, state, batches: Iterable,
            with_labels: bool) -> Stitcher:
    """Run ``eval_step`` over ordered host batches (attributes clips,
    audio, optional wavlm, anchors, videos, lengths, labels_v, labels_a,
    optional n_real) and stitch its outputs."""
    from jmt_tpu_torch.train.loops import device_batch
    stitcher = Stitcher(with_labels=with_labels)
    for batch in batches:
        vouts, aouts = eval_step(state, device_batch(batch))
        labels = ((batch.labels_v, batch.labels_a) if with_labels
                  else (None, None))
        stitcher.add_batch(vouts.float().cpu().numpy(),
                           aouts.float().cpu().numpy(), batch.anchors,
                           batch.videos, batch.lengths, *labels,
                           n_real=getattr(batch, "n_real", None))
    return stitcher


def validate(eval_step: Callable, state, batches: Iterable,
             store_pkl: str = "") -> Tuple[float, float]:
    """The stitched, smoothed validation CCC (V, A); the pickle too when
    ``store_pkl`` names a path."""
    stitcher = _stitch(eval_step, state, batches, with_labels=True)
    if store_pkl:
        stitcher.dump_pkl(store_pkl)
    return stitcher.scores()


def test(eval_step: Callable, state, batches: Iterable, dir_out: str,
         store_pkl: str = "") -> List[str]:
    """Challenge inference: stitch, write the ``{vid}.txt`` files (and the
    pickle when ``store_pkl`` names a path); returns the txt paths."""
    stitcher = _stitch(eval_step, state, batches, with_labels=False)
    written = write_challenge_txt(stitcher, dir_out)
    if store_pkl:
        stitcher.dump_pkl(store_pkl)
    return written
