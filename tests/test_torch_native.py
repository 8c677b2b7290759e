"""The native data-IO binding (``data/native.py``) against the JAX
package's (``jmt_tpu/data/native.py``), on the same files, bitwise.

* JPEGs at and off 112 px (cropped at the top left or zero padded), a
  greyscale one, a corrupt and a missing file, on one and four threads;
* wavs shorter and longer than 45,599 samples, PCM 8/16/32, IEEE float,
  stereo, a missing and a corrupt file;
* the library builds from ``native/jmt_dataio.cc`` into ``build/`` and
  ``native/`` is left as it was (listing and mtimes); a broken compiler
  raises, also through ``WindowedDataset(use_native=True)``;
* a failed build is remembered (no second compile in the process); the
  wav functions use the whole library where it builds and the WAV half
  only where it does not;
* ``WindowedDataset`` samples with ``use_native`` on equal JAX's for the
  train, val and test splits, the test split's tiny-wav quirk included,
  and ``use_native`` resolves as JAX's does; where only the WAV half
  builds (libjpeg's link made to fail), the default dataset decodes its
  wavs natively and its samples equal JAX's Python loaders';
* the committed JPEG fixtures decode as JAX's binding decodes them.
"""
import os
import struct
import wave

import numpy as np
import pytest
from PIL import Image

from jmt_tpu.data import datasets as jdatasets
from jmt_tpu.data import native as jnative
from jmt_tpu_torch.data import datasets
from jmt_tpu_torch.data import native
from jmt_tpu_torch.tools import jpeg_fixtures
from test_torch_data import _same_sample, tree  # noqa: F401 (fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jpegs(d):
    rng = np.random.default_rng(0)
    paths = []
    for name, (h, w) in (("square", (112, 112)), ("narrow", (100, 130)),
                         ("tall", (150, 90)), ("small", (40, 60))):
        p = os.path.join(d, f"{name}.jpg")
        Image.fromarray(rng.integers(0, 255, (h, w, 3), np.uint8)).save(
            p, quality=85)
        paths.append(p)
    p = os.path.join(d, "grey.jpg")
    Image.fromarray(rng.integers(0, 255, (112, 112), np.uint8)).save(p)
    paths.append(p)
    p = os.path.join(d, "corrupt.jpg")
    with open(p, "wb") as f:
        f.write(b"\xff\xd8\xff\xe0 not really a jpeg")
    paths += [p, os.path.join(d, "missing.jpg")]
    return paths


@pytest.mark.parametrize("threads", [1, 4])
def test_decode_jpeg_batch_matches_jax(tmp_path, threads):
    paths = _jpegs(str(tmp_path))
    for h, w in ((112, 112), (64, 128)):
        got = native.decode_jpeg_batch(paths, h, w, threads=threads)
        want = jnative.decode_jpeg_batch(paths, h, w, threads=threads)
        assert got.shape == (len(paths), h, w, 3) and got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
        assert got[0].any() and not got[-1].any() and not got[-2].any()


def _pcm_wav(path, data, width, channels=1):
    with wave.open(path, "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(width)
        w.setframerate(44100)
        w.writeframes(data.tobytes())


def _float_wav(path, x):
    """IEEE float32 (format 3), which ``wave`` cannot write."""
    data = x.astype("<f4").tobytes()
    fmt = struct.pack("<HHIIHH", 3, 1, 44100, 44100 * 4, 4, 32)
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 4 + 8 + 16 + 8 + len(data))
                + b"WAVE" + b"fmt " + struct.pack("<I", 16) + fmt
                + b"data" + struct.pack("<I", len(data)) + data)


def _wavs(d):
    rng = np.random.default_rng(1)
    paths = []
    for n, width in ((100, 2), (45599, 2), (50000, 2), (30000, 4),
                     (20000, 1)):
        p = os.path.join(d, f"pcm{width * 8}_{n}.wav")
        x = rng.normal(size=n)
        data = {2: (x * 3000).astype("<i2"),
                4: (x * 2e8).astype("<i4"),
                1: (128 + x * 30).clip(0, 255).astype(np.uint8)}[width]
        _pcm_wav(p, data, width)
        paths.append(p)
    p = os.path.join(d, "stereo.wav")
    _pcm_wav(p, (rng.normal(size=(47040, 2)) * 3000).astype("<i2"), 2, 2)
    paths.append(p)
    p = os.path.join(d, "float.wav")
    _float_wav(p, rng.normal(size=46000) * 0.1)
    paths.append(p)
    p = os.path.join(d, "corrupt.wav")
    with open(p, "wb") as f:
        f.write(b"RIFX....WAVE")
    return paths + [p, os.path.join(d, "missing.wav")]


def test_decode_wav_matches_jax(tmp_path):
    paths = _wavs(str(tmp_path))
    for n in (45599, 1000):
        got = native.decode_wav_batch(paths, n)
        np.testing.assert_array_equal(got,
                                      jnative.decode_wav_batch(paths, n))
        assert got.dtype == np.float32 and got[:-2].any(axis=1).all()
        assert not got[-2:].any()
        for p in paths:
            one, want = native.decode_wav(p, n), jnative.decode_wav(p, n)
            assert (one is None) == (want is None), p
            if one is not None:
                np.testing.assert_array_equal(one, want)


def _listing(d):
    return sorted((f, os.stat(os.path.join(d, f)).st_mtime_ns)
                  for f in os.listdir(d))


def test_builds_into_build_and_leaves_native_alone(monkeypatch):
    """A fresh build (its own flag, so its own library file) goes into
    ``build/jmt_tpu_torch/native/``; ``native/`` keeps its files and
    mtimes, and the committed ``libjmtdataio.so`` is not loaded."""
    native_dir = os.path.join(ROOT, "native")
    before = _listing(native_dir)
    monkeypatch.setattr(native, "CXXFLAGS",
                        native.CXXFLAGS + ("-DJMT_DATAIO_TEST_BUILD",))
    monkeypatch.setattr(native, "_libs", {})
    monkeypatch.setattr(native, "_failed", {})
    path = native.library_path()
    assert str(path.parent) == os.path.join(ROOT, "build", "jmt_tpu_torch",
                                            "native")
    assert native.build() == path and path.exists()
    assert native.load()._name == str(path)
    # the WAV half: the same source without libjpeg
    wav = native.build(jpeg=False)
    assert wav.parent == path.parent and wav != path
    text = native._wav_half(native.SOURCE.read_text())
    assert "#include <jpeglib.h>" not in text
    assert "jmt_decode_jpeg" not in text
    assert native.load(jpeg=False)._name == str(wav)
    assert _listing(native_dir) == before


@pytest.mark.parametrize("cxx", ["false", "no-such-compiler-anywhere"])
def test_a_broken_compiler_raises(cxx, tree, monkeypatch):  # noqa: F811
    monkeypatch.setattr(native, "CXX", cxx)
    monkeypatch.setattr(native, "_libs", {})
    monkeypatch.setattr(native, "_failed", {})
    with pytest.raises(RuntimeError, match=cxx):
        native.load()
    assert not native.available() and not native.available(jpeg=False)
    recs = datasets.load_video_records(tree["labels"], tree["wavs"],
                                       tree["ts"])
    with pytest.raises(RuntimeError, match=cxx):
        datasets.WindowedDataset(recs, "val", check_coverage=False,
                                 use_native=True)


def test_a_failed_build_is_remembered(monkeypatch):
    monkeypatch.setattr(native, "CXX", "false")
    monkeypatch.setattr(native, "_libs", {})
    monkeypatch.setattr(native, "_failed", {})
    runs = []
    run = native.subprocess.run
    monkeypatch.setattr(native.subprocess, "run",
                        lambda *a, **k: runs.append(a) or run(*a, **k))
    for _ in range(3):
        with pytest.raises(RuntimeError, match="false failed"):
            native.load()
        assert not native.available()
    assert len(runs) == 1


def test_wavs_use_the_whole_library_where_it_builds(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "_libs", {})
    monkeypatch.setattr(native, "_failed", {})
    paths = _wavs(str(tmp_path))
    np.testing.assert_array_equal(native.decode_wav_batch(paths, 45599),
                                  jnative.decode_wav_batch(paths, 45599))
    assert set(native._libs) == {True}


def _no_libjpeg(monkeypatch):
    """The whole library's link fails, as on a host without libjpeg."""
    monkeypatch.setattr(native, "LDLIBS", ("-ljmt_no_such_jpeg",
                                           "-lpthread"))
    monkeypatch.setattr(native, "_libs", {})
    monkeypatch.setattr(native, "_failed", {})


@pytest.mark.parametrize("split", ["train", "val", "test"])
def test_without_libjpeg_wavs_decode_natively(tree, split,  # noqa: F811
                                              monkeypatch):
    """Only the WAV half builds: ``use_native`` None decodes the wavs with
    it and the frames with PIL, and the samples equal JAX's (whose
    resolution reads both with its Python loaders here); ``use_native``
    True raises with the linker's message."""
    _no_libjpeg(monkeypatch)
    monkeypatch.setattr(os, "sched_getaffinity", lambda _: set(range(8)))
    labels = tree["test_labels" if split == "test" else "labels"]
    recs = datasets.load_video_records(labels, tree["wavs"], tree["ts"])
    got = datasets.WindowedDataset(recs, split, check_coverage=False)
    want = jdatasets.WindowedDataset(
        jdatasets.load_video_records(labels, tree["wavs"], tree["ts"]),
        split, check_coverage=False, use_native=False)
    assert not got.use_native and got.native_wavs
    assert len(got) == len(want) > 0
    for i in range(len(want)):
        _same_sample(got[i], want[i])
    assert set(native._libs) == {False}
    with pytest.raises(RuntimeError, match="jmt_no_such_jpeg"):
        datasets.WindowedDataset(recs, split, check_coverage=False,
                                 use_native=True)


@pytest.mark.parametrize("split", ["train", "val", "test"])
def test_windowed_dataset_native_matches_jax(tree, split):  # noqa: F811
    """With ``use_native`` on both sides: every sample of a window that
    reads the corrupt and the missing frame, and of the test split's
    window whose wav at anchor 97 is tiny (<= 100 samples: the previous
    clip's audio is reused)."""
    labels = tree["test_labels" if split == "test" else "labels"]
    got = datasets.WindowedDataset(
        datasets.load_video_records(labels, tree["wavs"], tree["ts"]),
        split, check_coverage=False, use_native=True)
    want = jdatasets.WindowedDataset(
        jdatasets.load_video_records(labels, tree["wavs"], tree["ts"]),
        split, check_coverage=False, use_native=True)
    assert got.use_native and want.use_native
    assert len(got) == len(want) > 0
    for i in sorted({0, min(1, len(want) - 1), len(want) // 2,
                     len(want) - 1}):
        _same_sample(got[i], want[i])
    if split == "test":
        quirk = [s for s in (got[i] for i in range(len(got)))
                 if 97 in s.anchors]
        assert quirk
        for s in quirk:
            ci = list(s.anchors).index(97)
            np.testing.assert_array_equal(s.audio[ci], s.audio[ci - 1])


def test_use_native_resolves_as_jax(tree, monkeypatch):  # noqa: F811
    recs = datasets.load_video_records(tree["labels"], tree["wavs"],
                                       tree["ts"])
    jrecs = jdatasets.load_video_records(tree["labels"], tree["wavs"],
                                         tree["ts"])
    for cores in (8, 2, 1):
        monkeypatch.setattr(os, "sched_getaffinity",
                            lambda _, n=cores: set(range(n)))
        for kw in ({}, {"frame_loader": lambda p: None}):
            got = datasets.WindowedDataset(recs, "val", check_coverage=False,
                                           **kw)
            want = jdatasets.WindowedDataset(jrecs, "val",
                                             check_coverage=False, **kw)
            assert got.use_native == want.use_native == (
                cores >= 2 and not kw), (cores, kw)
            assert got.native_wavs == got.use_native


def test_committed_fixtures_decode_as_jax_decodes_them():
    paths = jpeg_fixtures.paths()
    assert len(paths) == jpeg_fixtures.COUNT == 8
    assert all(os.path.getsize(p) < 16384 for p in paths)
    got = native.decode_jpeg_batch(paths, 112, 112)
    np.testing.assert_array_equal(got,
                                  jnative.decode_jpeg_batch(paths, 112, 112))
    # close to the seeded images they were encoded from (quality 90)
    for i, img in enumerate(got):
        err = np.abs(img.astype(int) - jpeg_fixtures.image(i)).mean()
        assert err < 8, (i, err)
