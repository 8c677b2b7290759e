"""The port's host data path against the JAX package's, bit for bit.

Windows for lengths 481, 482, 530 and 961 and for gappy videos; the
synthetic, learnable and multimodal sources' samples (clips, audio,
labels, anchors, wav paths); ``collate``, the wavLM lookup and the
``PrefetchLoader`` order under one seed; a CSV/JPEG/wav tree the test writes
read by both sides (train, val and the test split's tiny-wav quirk).
A missing or corrupt frame is a black frame; a blocked PIL raises.
"""
import os
import sys
import wave

import numpy as np
import pytest

from jmt_tpu.data import datasets as jdatasets
from jmt_tpu.data import loader as jloader
from jmt_tpu.data import synthetic as jsynthetic
from jmt_tpu.data import windowing as jwindowing
from jmt_tpu_torch.data import audio_io, datasets, loader, synthetic
from jmt_tpu_torch.data import windowing


def _same_windows(got, want):
    (gs, ge), (ws, we) = got, want
    assert ge == we and len(gs) == len(ws)
    for g, w in zip(gs, ws):
        assert [c.anchor for c in g.clips] == [c.anchor for c in w.clips]
        for gc, wc in zip(g.clips, w.clips):
            assert (gc.rows is None) == (wc.rows is None)
            if gc.rows is not None:
                np.testing.assert_array_equal(gc.rows, wc.rows)


@pytest.mark.parametrize("length", [481, 482, 530, 961])
@pytest.mark.parametrize("missing_every", [0, 3, 7])
@pytest.mark.parametrize("stride", [1, 32])
def test_windows_are_the_jax_windows(length, missing_every, stride):
    ids = np.arange(1, length + 1)
    if missing_every:
        ids = ids[ids % missing_every != 0]
    ids = ids[(ids < 100) | (ids > 140)]    # and one empty subsequence
    for name in ("train_windows", "eval_windows"):
        got = getattr(windowing, name)(ids, length, stride=stride)
        want = getattr(jwindowing, name)(ids, length, stride=stride)
        _same_windows(got, want)
        assert windowing.coverage_check(got[1], length) == \
            jwindowing.coverage_check(want[1], length)


def test_decimation_ladder_is_the_jax_one():
    for n in range(0, 33):
        idx = np.arange(100, 100 + n)
        got, want = (m.decimate_subsequence(idx)
                     for m in (windowing, jwindowing))
        if want is None:
            assert got is None
        else:
            np.testing.assert_array_equal(got, want)


def _same_sample(got, want):
    for field in ("clips", "audio", "labels_v", "labels_a", "anchors"):
        g, w = getattr(got, field), getattr(want, field)
        assert g.dtype == w.dtype, field
        np.testing.assert_array_equal(g, w, err_msg=field)
    assert (got.video, got.length, got.wav_paths) == \
        (want.video, want.length, want.wav_paths)


@pytest.mark.parametrize("split", ["train", "val"])
def test_synthetic_samples_are_the_jax_samples(split):
    kw = dict(n_videos=2, length=530, missing_every=5, img_size=32,
              check_coverage=False)
    got = synthetic.synthetic_dataset(split, **kw)
    want = jsynthetic.synthetic_dataset(split, **kw)
    assert len(got) == len(want) > 0
    for i in sorted({0, len(want) // 2, len(want) - 1}):
        _same_sample(got[i], want[i])


def test_learnable_and_multimodal_sources_are_the_jax_ones():
    pairs = [(synthetic.learnable_dataset("val", n_videos=1, length=481),
              jsynthetic.learnable_dataset("val", n_videos=1, length=481)),
             (synthetic.mm_learnable_dataset("train", n_videos=1,
                                             length=481, seed=7),
              jsynthetic.mm_learnable_dataset("train", n_videos=1,
                                              length=481, seed=7))]
    for got, want in pairs:
        assert len(got) == len(want) > 0
        _same_sample(got[0], want[0])
    paths = [["/synthetic/mmaudio/7/learnmm007000/33.wav"] * 2]
    np.testing.assert_array_equal(
        synthetic.mm_wavlm_store(7).lookup_batch(paths),
        jsynthetic.mm_wavlm_store(7).lookup_batch(paths))


def test_loader_order_collate_and_wavlm_lookup_are_the_jax_ones():
    kw = dict(n_videos=1, length=530, img_size=16, check_coverage=False)
    got_ds = synthetic.synthetic_dataset("train", **kw)
    want_ds = jsynthetic.synthetic_dataset("train", **kw)
    got = list(loader.PrefetchLoader(
        got_ds, 5, shuffle=True, rng=np.random.default_rng(11),
        wavlm_store=synthetic.synthetic_wavlm_store()))
    want = list(jloader.PrefetchLoader(
        want_ds, 5, shuffle=True, rng=np.random.default_rng(11),
        wavlm_store=jsynthetic.synthetic_wavlm_store()))
    assert len(got) == len(want) == 7            # 32 windows, the last 2
    for g, w in zip(got, want):
        for field in ("clips", "audio", "labels_v", "labels_a", "anchors",
                      "wavlm"):
            np.testing.assert_array_equal(getattr(g, field),
                                          getattr(w, field), err_msg=field)
        assert (g.videos, g.lengths, g.wav_paths) == \
            (w.videos, w.lengths, w.wav_paths)
    assert np.abs(got[0].wavlm).max() > 0


def test_loader_reraises_the_producer_error_and_refuses_host_shard():
    class Broken:
        def __len__(self):
            return 4

        def __getitem__(self, i):
            raise RuntimeError(f"bad sample {i}")

    with pytest.raises(RuntimeError, match="bad sample 0"):
        list(loader.PrefetchLoader(Broken(), 2))
    with pytest.raises(NotImplementedError, match="host_shard"):
        loader.PrefetchLoader(Broken(), 2, host_shard=(0, 2))


# ---------------------------------------------------------------------------
# a CSV / JPEG / wav tree on disk
# ---------------------------------------------------------------------------
LENGTH = 481


def _write_wav(path, n, rng):
    pcm = (rng.normal(size=n) * 3000).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(44100)
        w.writeframes(pcm.tobytes())


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """One annotated video (frames 1..481 but 200-209, frame 50's JPEG
    missing, frame 51's corrupt, no wav at anchor 65) and the same video
    as a test split without labels, its wav at anchor 97 near-empty."""
    from PIL import Image
    root = tmp_path_factory.mktemp("tree")
    rng = np.random.default_rng(0)
    dirs = {k: root / k for k in ("labels", "test_labels", "ts", "wavs",
                                  "frames")}
    for d in dirs.values():
        os.makedirs(d)
    os.makedirs(dirs["frames"] / "001")
    os.makedirs(dirs["wavs"] / "001")
    rows, test_rows = ["img,V,A,frame_id"], ["img,frame_id"]
    for f in range(1, LENGTH + 1):
        if 200 <= f < 210:
            continue
        path = dirs["frames"] / "001" / f"{f:05d}.jpg"
        if f == 51:
            path.write_bytes(b"not a jpeg")
        elif f != 50:
            base = rng.integers(0, 255, (14, 14, 3), np.uint8)
            Image.fromarray(base).resize((112, 112)).save(path, quality=90)
        v, a = rng.uniform(-1, 1, 2)
        rows.append(f"{path},{v:.4f},{a:.4f},{f}")
        test_rows.append(f"{path},{f}")
        if f % 32 == 1 and f != 65:
            _write_wav(str(dirs["wavs"] / "001" / f"{f}.wav"),
                       40 if f == 97 else 47040, rng)
    (dirs["labels"] / "001.csv").write_text("\n".join(rows) + "\n")
    (dirs["test_labels"] / "001.csv").write_text(
        "\n".join(test_rows) + "\n")
    (dirs["ts"] / "001_video_ts.txt").write_text(
        "header\n" + "\n".join(f"{i / 30:.4f}" for i in range(LENGTH))
        + "\n")
    return {k: str(v) for k, v in dirs.items()}


@pytest.mark.parametrize("split", ["train", "val", "test"])
def test_file_tree_reads_as_in_jax(tree, split):
    labels = tree["test_labels" if split == "test" else "labels"]
    got_recs = datasets.load_video_records(labels, tree["wavs"], tree["ts"])
    want_recs = jdatasets.load_video_records(labels, tree["wavs"],
                                             tree["ts"])
    for g, w in zip(got_recs, want_recs):
        assert (g.name, g.image_paths, g.length, g.wav_dir) == \
            (w.name, w.image_paths, w.length, w.wav_dir)
        for field in ("labels_v", "labels_a", "frame_ids"):
            np.testing.assert_array_equal(getattr(g, field),
                                          getattr(w, field))
    got = datasets.WindowedDataset(got_recs, split, check_coverage=False,
                                   use_native=False)
    want = jdatasets.WindowedDataset(want_recs, split, check_coverage=False,
                                     use_native=False)
    assert len(got) == len(want) > 0
    for i in sorted({0, len(want) - 1}):
        _same_sample(got[i], want[i])
    sample = got[0]
    assert sample.clips[1, 5].any() and sample.audio[0].any()
    if split == "test":
        assert (sample.labels_v[sample.anchors <= LENGTH] == -5.0).all()


def test_unreadable_frames_are_black_but_a_missing_pil_raises(
        tree, monkeypatch):
    frames = os.path.join(os.path.dirname(tree["labels"]), "frames", "001")
    assert datasets.default_frame_loader(
        os.path.join(frames, "00050.jpg")) is None            # missing
    assert datasets.default_frame_loader(
        os.path.join(frames, "00051.jpg")) is None            # corrupt
    img = datasets.default_frame_loader(os.path.join(frames, "00052.jpg"))
    assert img.shape == (112, 112, 3) and img.dtype == np.uint8
    recs = datasets.load_video_records(tree["labels"], tree["wavs"],
                                       tree["ts"])
    ds = datasets.WindowedDataset(recs, "val", check_coverage=False,
                                  use_native=False)
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="Pillow"):
        datasets.default_frame_loader(os.path.join(frames, "00052.jpg"))
    with pytest.raises(ImportError, match="Pillow"):
        ds[0]


def test_audio_io_is_the_jax_one(tmp_path):
    from jmt_tpu.data import audio_io as jaudio_io
    x = np.sin(np.arange(1000) / 7.0).astype(np.float32)
    path = str(tmp_path / "a" / "x.wav")
    audio_io.write_wav(path, x)
    np.testing.assert_array_equal(audio_io.load_wav(path),
                                  jaudio_io.load_wav(path))
    assert audio_io.load_wav(str(tmp_path / "none.wav")) is None
    for n in (0, 100, 45599, 50000):
        wav = x[:n] if n <= 1000 else np.resize(x, n)
        np.testing.assert_array_equal(datasets._fit_audio(wav),
                                      jdatasets._fit_audio(wav))
