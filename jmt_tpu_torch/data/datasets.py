"""Datasets: windowed audio-visual samples with pluggable IO.

Counterpart of ``jmt_tpu/data/datasets.py``: the label CSVs and
realtimestamps of a split become ``VideoRecord``s; ``WindowedDataset``
windows them at construction (``data/windowing.py``) and materializes one
sample at a time: 16 clips x 8 frames (uint8, a missing frame is zeros,
the reference's bare-except) and 16 one-second wavs (left-zero-padded to
``audio_samples``, long wavs keep their tail; a missing wav is zeros).
The dataset returns RAW uint8 frames and RAW audio: the colour
augmentation, the normalization and the log-mel front end run on the
device (``train/loops.preprocess``).

The port reads the CSVs with ``csv``. Frames and wavs are decoded by the
native library (``data/native.py``: libjpeg on a thread pool) when
``use_native`` resolves on, as JAX resolves it: the default loaders, at
least two cores available to the process and a library that builds on
this host; asked for explicitly, a library that does not build raises.
On a host where only the library's WAV half builds, the wavs are still
decoded natively. Otherwise the loaders run one file at a time: PIL is imported only
inside ``default_frame_loader``, where an
unreadable file is a black frame (the reference's behaviour) but a
missing PIL raises: a silent fallback would train on an all-black
dataset. The loaders are pluggable, so the same dataset serves Affwild2
trees, test fixtures and the synthetic source (``data/synthetic.py``).
"""
from __future__ import annotations

import csv
import dataclasses
import os
from typing import Callable, List, Optional, Sequence

import numpy as np

from jmt_tpu_torch.data import native
from jmt_tpu_torch.data import windowing as W
from jmt_tpu_torch.data.audio_io import load_wav
from jmt_tpu_torch.ops.mel import AUDIO_SAMPLES

FrameLoader = Callable[[str], Optional[np.ndarray]]
AudioLoader = Callable[[str], Optional[np.ndarray]]

IMG_SIZE = 112


@dataclasses.dataclass
class VideoRecord:
    """One annotated video: rows are (image path, V, A, frame_id)."""
    name: str                 # csv stem, may end in _left/_right
    image_paths: List[str]
    labels_v: np.ndarray      # (n,)
    labels_a: np.ndarray      # (n,)
    frame_ids: np.ndarray     # (n,) int
    length: int               # realtimestamps line count
    wav_dir: str              # {wavs_root}/{vidname}; wavs are {anchor}.wav

    @property
    def vidname(self) -> str:
        # _left/_right share one audio track
        for suf in ("_left", "_right"):
            if self.name.endswith(suf):
                return self.name[: -len(suf)]
        return self.name


def _read_label_csv(path: str):
    """(img paths, V or None, A or None, frame ids) of one label CSV."""
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    cols = rows[0].keys() if rows else ()

    def floats(name):
        if name not in cols:
            return None
        return np.array([float(r[name]) for r in rows]).astype(np.float32)

    return ([r["img"] for r in rows], floats("V"), floats("A"),
            np.array([int(r["frame_id"]) for r in rows], np.int64))


def load_video_records(labeldir: str, wavs_root: str, timestamps_dir: str,
                       skip: Sequence[str] = (), take_n_videos: int = -1
                       ) -> List[VideoRecord]:
    """Per-video CSVs (img,V,A,frame_id) and realtimestamps line counts,
    sorted by basename; an optional skip list and take-n truncation."""
    csvs = [f for f in os.listdir(labeldir)
            if f.endswith(".csv") and not f.startswith(".")
            and f not in skip]
    csvs = W.sort_files_by_basename(csvs)
    if take_n_videos > 0:
        csvs = csvs[:take_n_videos]
    records = []
    for csv_name in csvs:
        paths, lv, la, ids = _read_label_csv(os.path.join(labeldir,
                                                          csv_name))
        # the challenge test split has no V/A labels: the ignore value
        n = len(paths)
        rec = VideoRecord(
            name=os.path.splitext(csv_name)[0], image_paths=paths,
            labels_v=lv if lv is not None else np.full(n, -5.0, np.float32),
            labels_a=la if la is not None else np.full(n, -5.0, np.float32),
            frame_ids=ids, length=0, wav_dir="")
        ts = os.path.join(timestamps_dir, rec.vidname + "_video_ts.txt")
        with open(ts) as f:
            rec.length = len(f.readlines()[1:])
        rec.wav_dir = os.path.join(wavs_root, rec.vidname)
        records.append(rec)
    return records


def default_frame_loader(path: str) -> Optional[np.ndarray]:
    """A JPEG frame as uint8 (H, W, C); None (a black frame) when the file
    is missing or unreadable. Raises ImportError when PIL is absent."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("reading JPEG frames needs Pillow (PIL), which "
                          "is not installed") from e
    try:
        with Image.open(path) as img:
            return np.asarray(img)
    except (OSError, ValueError, SyntaxError, EOFError):
        return None


def _fit_audio(wav: Optional[np.ndarray],
               length: int = AUDIO_SAMPLES) -> np.ndarray:
    """Left-zero-pad to ``length`` samples; a longer wav keeps its TAIL."""
    out = np.zeros(length, np.float32)
    if wav is None or len(wav) == 0:
        return out
    if len(wav) >= length:
        return wav[-length:].astype(np.float32)
    out[-len(wav):] = wav
    return out


@dataclasses.dataclass
class Sample:
    """One window, at static shapes."""
    clips: np.ndarray      # (16, 8, 112, 112, 3) uint8
    audio: np.ndarray      # (16, audio_samples) float32
    labels_v: np.ndarray   # (16,) float32 (-5.0 for placeholders)
    labels_a: np.ndarray   # (16,)
    anchors: np.ndarray    # (16,) int64 frame ids (eval stitching)
    video: str
    length: int
    wav_paths: List[str]   # for the wavLM feature lookup


class WindowedDataset:
    """Train or eval windowed dataset over VideoRecords."""

    def __init__(self, records: Sequence[VideoRecord], split: str,
                 stride: int = 1, win_length: int = 512,
                 frame_loader: FrameLoader = default_frame_loader,
                 audio_loader: AudioLoader = load_wav,
                 check_coverage: bool = True, img_size: int = IMG_SIZE,
                 use_native: Optional[bool] = None,
                 audio_samples: int = AUDIO_SAMPLES):
        """use_native: True decodes with ``data/native.py`` (built now,
        or raising with the compiler's output); None resolves as JAX
        does: on with the default loaders, at least two cores available
        (the decode pool loses to the one-file loaders on a single core)
        and a library that builds here. Where only the library's WAV
        half builds (no libjpeg), None still decodes the wavs natively
        (``native_wavs``) and the frames with ``frame_loader``; JAX's
        resolution reads both with its Python loaders then."""
        if split not in ("train", "val", "test"):
            raise ValueError(f"split={split!r}")
        self.split = split
        self.img_size = img_size
        self.audio_samples = int(audio_samples)
        if use_native is None:
            try:
                cores = len(os.sched_getaffinity(0))
            except (AttributeError, OSError):
                cores = os.cpu_count() or 1
            default = (frame_loader is default_frame_loader
                       and audio_loader is load_wav and cores >= 2)
            use_native = default and native.available()
            native_wavs = default and native.available(jpeg=False)
        else:
            if use_native:
                native.load()
            native_wavs = use_native
        self.use_native = bool(use_native)
        self.native_wavs = bool(native_wavs)
        self.records = list(records)
        self.frame_loader = frame_loader
        self.audio_loader = audio_loader
        self.index: List = []  # (record index, WindowSample)
        windower = W.train_windows if split == "train" else W.eval_windows
        for ri, rec in enumerate(self.records):
            samples, emitted = windower(rec.frame_ids, rec.length,
                                        win_length=win_length, stride=stride)
            if check_coverage and not W.coverage_check(emitted, rec.length):
                raise ValueError(
                    f"windowing coverage broken for video {rec.name}: "
                    f"{len(set(emitted))} anchors != length {rec.length}")
            self.index.extend((ri, s) for s in samples)

    def __len__(self) -> int:
        return len(self.index)

    def __getitem__(self, i: int) -> Sample:
        ri, win = self.index[i]
        rec = self.records[ri]
        n, sz = W.SUBSEQS_PER_WINDOW, self.img_size
        clips = np.zeros((n, W.CLIP_LEN, sz, sz, 3), np.uint8)
        audio = np.zeros((n, self.audio_samples), np.float32)
        labels_v = np.full((n,), -5.0, np.float32)
        labels_a = np.full((n,), -5.0, np.float32)
        anchors = np.zeros((n,), np.int64)
        wav_paths: List[str] = []
        frame_slots: List = []  # (clip, frame, path)
        audio_slots: List[int] = []
        for ci, clip in enumerate(win.clips):
            anchors[ci] = clip.anchor
            wav_paths.append(os.path.join(rec.wav_dir, f"{clip.anchor}.wav"))
            if clip.rows is None:
                continue  # placeholder: zero frames and audio, -5 labels
            for fi, row in enumerate(clip.rows):
                frame_slots.append((ci, fi, rec.image_paths[row]))
                # the last row's labels win
                labels_v[ci] = rec.labels_v[row]
                labels_a[ci] = rec.labels_a[row]
            audio_slots.append(ci)
        if self.use_native and frame_slots:
            imgs = native.decode_jpeg_batch([p for _, _, p in frame_slots],
                                            sz, sz)
            for k, (ci, fi, _) in enumerate(frame_slots):
                clips[ci, fi] = imgs[k]
        else:
            for ci, fi, path in frame_slots:
                img = self.frame_loader(path)
                if img is not None:
                    clips[ci, fi, :, :, :3] = img[:sz, :sz]
        if self.native_wavs and frame_slots:
            wavs = native.decode_wav_batch(
                [wav_paths[ci] for ci in audio_slots], self.audio_samples)
            for k, ci in enumerate(audio_slots):
                audio[ci] = wavs[k]
        else:
            for ci in audio_slots:
                audio[ci] = _fit_audio(self.audio_loader(wav_paths[ci]),
                                       self.audio_samples)
        if self.split == "test":
            # the test split reuses the previous clip's audio for a
            # near-empty wav (<= 100 samples, so under 1 KB on disk)
            for k, ci in enumerate(audio_slots):
                p = wav_paths[ci]
                try:
                    tiny = os.path.getsize(p) < 1024
                except OSError:
                    tiny = False
                if tiny and k > 0:
                    raw = self.audio_loader(p)
                    if raw is not None and 0 < len(raw) <= 100:
                        audio[ci] = audio[audio_slots[k - 1]]
        return Sample(clips=clips, audio=audio, labels_v=labels_v,
                      labels_a=labels_a, anchors=anchors, video=rec.name,
                      length=rec.length, wav_paths=wav_paths)


@dataclasses.dataclass
class Batch:
    """Stacked samples at static shapes."""
    clips: np.ndarray      # (B, 16, 8, 112, 112, 3) uint8
    audio: np.ndarray      # (B, 16, audio_samples) float32
    labels_v: np.ndarray   # (B, 16)
    labels_a: np.ndarray   # (B, 16)
    anchors: np.ndarray    # (B, 16)
    videos: List[str]
    lengths: List[int]
    wav_paths: List[List[str]]
    wavlm: Optional[np.ndarray] = None  # (B, 16, 768) with wavLM
    # a host-sharded loader's lockstep filler: rows past n_valid are
    # weight-0 padding (None: every row is real)
    n_valid: Optional[int] = None


def collate(samples: Sequence[Sample]) -> Batch:
    """Stack samples; every shape is static, so nothing is padded."""
    return Batch(
        clips=np.stack([s.clips for s in samples]),
        audio=np.stack([s.audio for s in samples]),
        labels_v=np.stack([s.labels_v for s in samples]),
        labels_a=np.stack([s.labels_a for s in samples]),
        anchors=np.stack([s.anchors for s in samples]),
        videos=[s.video for s in samples],
        lengths=[s.length for s in samples],
        wav_paths=[s.wav_paths for s in samples],
    )


class WavlmFeatureStore:
    """Precomputed WavLM features: {root}/{vidname}/{anchor}.npy -> (768,);
    a missing feature is zeros."""

    def __init__(self, root: str, dim: int = 768,
                 loader: Optional[Callable[[str], Optional[np.ndarray]]]
                 = None):
        self.root = root
        self.dim = dim
        self._loader = loader or self._np_loader

    @staticmethod
    def _np_loader(path: str) -> Optional[np.ndarray]:
        if os.path.exists(path):
            return np.load(path)
        return None

    def lookup_batch(self, wav_paths: List[List[str]]) -> np.ndarray:
        out = np.zeros((len(wav_paths), len(wav_paths[0]), self.dim),
                       np.float32)
        for i, row in enumerate(wav_paths):
            for j, wav in enumerate(row):
                stem = os.path.splitext(os.path.basename(wav))[0]
                vid = os.path.basename(os.path.dirname(wav))
                feat = self._loader(os.path.join(self.root, vid,
                                                 f"{stem}.npy"))
                if feat is not None:
                    out[i, j] = feat[:self.dim]
        return out
