"""The port's stitched evaluation against the JAX package's ``Stitcher``.

Both stitchers take the same per-window numpy outputs of two videos of
unequal length (481 and 530 frames) in windows of S = 16 timesteps, in
order, batches of 4 windows with the last one padded: the last window of
each video runs past its end, and some labels are -5. Per-video smoothed
traces and ``scores()`` atol 1e-6 (the traces are equal bit for bit),
the two ``ValueError``s on both sides, ``write_challenge_txt`` byte for
byte, ``dump_pkl`` array for array, and ``validate`` / ``test`` driving an
eval step over the ordered batches.
"""
import pickle
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from jmt_tpu.eval import stitch as jstitch
from jmt_tpu_torch.eval import stitch

S, BATCH = 16, 4
VIDEOS = (("vid_a", 481), ("vid_b", 530))


def _windows(seed=0):
    """Per-window rows in dataset order: (video, length, anchors (S,),
    labels_v, labels_a, vouts, aouts)."""
    rng = np.random.default_rng(seed)
    rows = []
    for vid, length in VIDEOS:
        t = np.arange(1, length + S + 1)
        lv = np.clip(np.sin(t / 40.0) + 0.2 * rng.normal(size=t.size), -1, 1)
        la = np.clip(np.cos(t / 55.0) + 0.2 * rng.normal(size=t.size), -1, 1)
        lv[rng.random(t.size) < 0.05] = -5.0
        la[rng.random(t.size) < 0.05] = -5.0
        for w in range(-(-length // S)):
            anchors = np.arange(w * S + 1, w * S + S + 1)
            sl = anchors - 1
            vo = 0.7 * np.sin(anchors / 40.0) + 0.3 * rng.normal(size=S)
            ao = 1.3 * np.cos(anchors / 55.0) + 0.3 * rng.normal(size=S)
            rows.append((vid, length, anchors, lv[sl].astype(np.float32),
                         la[sl].astype(np.float32), vo.astype(np.float32),
                         ao.astype(np.float32)))
    return rows


def _batches(rows):
    """Batches of BATCH windows; the last padded with copies of its first
    row and ``n_real`` set."""
    out = []
    for i in range(0, len(rows), BATCH):
        part = rows[i:i + BATCH]
        n_real = len(part)
        part = part + [part[0]] * (BATCH - n_real)
        cols = list(zip(*part))
        out.append(SimpleNamespace(
            videos=list(cols[0]), lengths=list(cols[1]),
            anchors=np.stack(cols[2]), labels_v=np.stack(cols[3]),
            labels_a=np.stack(cols[4]), vouts=np.stack(cols[5]),
            aouts=np.stack(cols[6]), n_real=n_real))
    return out


def _fed(module, with_labels=True, seed=0):
    st = module.Stitcher(with_labels=with_labels)
    for b in _batches(_windows(seed)):
        labels = (b.labels_v, b.labels_a) if with_labels else (None, None)
        st.add_batch(b.vouts, b.aouts, b.anchors, b.videos, b.lengths,
                     *labels, n_real=b.n_real)
    return st


@pytest.fixture(scope="module")
def pair():
    return _fed(stitch), _fed(jstitch)


def test_smoothed_traces_and_scores_match_jax(pair):
    got, want = pair
    assert [got.lengths[v] for v, _ in VIDEOS] == [481, 530]
    for a, b in zip(got.smoothed(), want.smoothed()):
        assert list(a) == list(b) == [v for v, _ in VIDEOS]
        for vid in a:
            np.testing.assert_allclose(a[vid], b[vid], rtol=0, atol=1e-6)
            np.testing.assert_array_equal(a[vid], b[vid])
    for vid, _ in VIDEOS:
        np.testing.assert_array_equal(got.label_v[vid], want.label_v[vid])
        np.testing.assert_array_equal(got.pred_a[vid], want.pred_a[vid])
        assert got.is_complete(vid) and want.is_complete(vid)
    # -5 slots stay (0, 0) in the traces and in the CCC
    assert (got.label_v["vid_a"] == 0).sum() > 10
    sv, sa = got.scores()
    wv, wa = want.scores()
    assert 0.2 < sv < 1 and 0.2 < sa < 1
    assert abs(sv - wv) <= 1e-6 and abs(sa - wa) <= 1e-6


def test_incomplete_and_unknown_videos():
    st = stitch.Stitcher()
    rows = _windows()[:3]
    b = _batches(rows)[0]
    st.add_batch(b.vouts, b.aouts, b.anchors, b.videos, b.lengths,
                 b.labels_v, b.labels_a, n_real=b.n_real)
    assert not st.is_complete("vid_a") and not st.is_complete("vid_c")


@pytest.mark.parametrize("module", [stitch, jstitch],
                         ids=["port", "jax"])
def test_order_errors_raise_on_both_sides(module):
    rows = _windows()
    b = _batches(rows[2:6])[0]
    with pytest.raises(ValueError, match="out-of-order"):
        module.Stitcher().add_batch(b.vouts, b.aouts, b.anchors, b.videos,
                                    b.lengths, b.labels_v, b.labels_a)
    st = module.Stitcher()
    first, again = _batches(rows[0:4])[0], _batches(rows[1:2])[0]
    st.add_batch(first.vouts, first.aouts, first.anchors, first.videos,
                 first.lengths, first.labels_v, first.labels_a)
    with pytest.raises(ValueError, match="non-sequential"):
        st.add_batch(again.vouts, again.aouts, again.anchors, again.videos,
                     again.lengths, again.labels_v, again.labels_a,
                     n_real=again.n_real)


def test_challenge_files_are_byte_identical(tmp_path):
    got = stitch.write_challenge_txt(_fed(stitch, with_labels=False),
                                     str(tmp_path / "port"))
    want = jstitch.write_challenge_txt(_fed(jstitch, with_labels=False),
                                       str(tmp_path / "jax"))
    assert [p.split("/")[-1] for p in got] == ["vid_a.txt", "vid_b.txt"]
    for a, b in zip(got, want):
        data = open(a, "rb").read()
        assert data == open(b, "rb").read()
        lines = data.decode().splitlines()
        assert lines[0] == "image_location,valence,arousal"
        assert lines[1].startswith(a.split("/")[-1][:-4] + "/00001.jpg,")
    assert len(open(got[1]).read().splitlines()) == 531


@pytest.mark.parametrize("with_labels", [True, False])
def test_dump_pkl_matches_jax(tmp_path, with_labels):
    paths = []
    for name, module in (("port", stitch), ("jax", jstitch)):
        paths.append(str(tmp_path / f"{name}.pkl"))
        _fed(module, with_labels).dump_pkl(paths[-1])
    got, want = (pickle.load(open(p, "rb")) for p in paths)
    assert got.keys() == want.keys() == {"trg", "pred"}
    for part in ("trg", "pred"):
        for key in ("vl", "ar"):
            a, b = got[part][key], want[part][key]
            if b is None:
                assert a is None and part == "trg" and not with_labels
                continue
            assert list(a) == list(b)
            for vid in b:
                assert a[vid].dtype == b[vid].dtype
                np.testing.assert_array_equal(a[vid], b[vid])


def _eval_step(batches):
    """An eval step that answers each batch with its stored outputs."""
    outs = iter([(b.vouts, b.aouts) for b in batches])

    def eval_step(state, arrays):
        assert state == "state" and arrays["clips"].shape[0] == BATCH
        v, a = next(outs)
        return torch.from_numpy(v), torch.from_numpy(a)

    return eval_step


def _with_inputs(batches):
    for b in batches:
        b.clips = np.zeros((BATCH, S, 1), np.uint8)
        b.audio = np.zeros((BATCH, S, 1), np.float32)
    return batches


def test_validate_and_test_drive_an_eval_step(tmp_path):
    batches = _with_inputs(_batches(_windows()))
    scores = stitch.validate(_eval_step(batches), "state", batches,
                             store_pkl=str(tmp_path / "val.pkl"))
    assert scores == _fed(stitch).scores() == pytest.approx(
        _fed(jstitch).scores(), abs=1e-6)
    assert pickle.load(open(tmp_path / "val.pkl", "rb"))["trg"]["vl"]
    written = stitch.test(_eval_step(batches), "state", batches,
                          str(tmp_path / "txt"),
                          store_pkl=str(tmp_path / "test.pkl"))
    want = jstitch.write_challenge_txt(_fed(jstitch, with_labels=False),
                                       str(tmp_path / "jax"))
    assert [open(p, "rb").read() for p in written] == \
        [open(p, "rb").read() for p in want]
    assert pickle.load(open(tmp_path / "test.pkl", "rb"))["trg"]["vl"] \
        is None
