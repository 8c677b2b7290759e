"""The port's preprocessing tools against the JAX package's: the files
each writes are the same bytes (JAX's use pandas, the port's ``csv`` and
numpy)."""
import os

import numpy as np
import pytest

from jmt_tpu.data import preprocessing as jprep
from jmt_tpu_torch.data import preprocessing as prep


def _tree_bytes(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            out[os.path.relpath(p, root)] = open(p, "rb").read()
    return out


def _annotations(root, rng):
    """Three videos of VA txt annotations: values written in several
    formats, -5 rows in either column, a video with no kept row, a
    non-txt file to skip."""
    os.makedirs(root)
    fmts = ("{:.3f}", "{:.6f}", "{}", "{:.1f}", "{:g}")
    for v, n in (("10-60-1280x720", 40), ("video2_left", 25),
                 ("all_dropped", 3)):
        lines = ["valence,arousal"]
        for i in range(n):
            x, y = rng.uniform(-1, 1, 2)
            if v == "all_dropped" or i % 7 == 3:
                x = -5
            if i % 11 == 5:
                y = -5
            if i == 0:
                x, y = 0.0, 1.0
            if i == 1:
                x, y = 1e-05, -0.0
            f = fmts[i % len(fmts)]
            lines.append(",".join(
                "-5" if z == -5 else f.format(z) for z in (x, y)))
        with open(os.path.join(root, f"{v}.txt"), "w") as fh:
            fh.write("\n".join(lines) + "\n")
    with open(os.path.join(root, "README.md"), "w") as fh:
        fh.write("not an annotation\n")


def test_frame_name_is_jax_s():
    for i in (1, 42, 99999):
        assert prep.frame_name(i) == jprep.frame_name(i)


def test_convert_va_annotations_writes_jax_s_bytes(tmp_path):
    _annotations(str(tmp_path / "anno"), np.random.default_rng(0))
    got = prep.convert_va_annotations(str(tmp_path / "anno"),
                                      str(tmp_path / "port"))
    want = jprep.convert_va_annotations(str(tmp_path / "anno"),
                                        str(tmp_path / "jax"))
    assert [os.path.basename(p) for p in got] == \
        [os.path.basename(p) for p in want] and len(got) == 3
    assert _tree_bytes(tmp_path / "port") == _tree_bytes(tmp_path / "jax")


@pytest.mark.parametrize("feature_dim", [768, 512, None])
def test_explode_wavlm_features_writes_jax_s_bytes(tmp_path, feature_dim):
    rng = np.random.default_rng(1)
    src = tmp_path / "csv"
    os.makedirs(src / "a_subdir")  # not a file: skipped
    for video, frames in (("v1", 5), ("v2_right", 3)):
        feats = rng.normal(size=(frames, 770))
        lines = [",".join(str(j) for j in range(770))]
        lines += [",".join(repr(float(x)) if j % 2 else f"{x:.7f}"
                           for j, x in enumerate(row)) for row in feats]
        (src / f"{video}.csv").write_text("\n".join(lines) + "\n")
    n = prep.explode_wavlm_features(str(src), str(tmp_path / "port"),
                                    feature_dim)
    m = jprep.explode_wavlm_features(str(src), str(tmp_path / "jax"),
                                     feature_dim)
    assert n == m == 8
    assert _tree_bytes(tmp_path / "port") == _tree_bytes(tmp_path / "jax")


def test_write_realtimestamps_writes_jax_s_bytes(tmp_path):
    for n, fps in ((481, 30.0), (7, 25.0), (0, 30.0)):
        got = prep.write_realtimestamps(str(tmp_path / "port"), "vid", n,
                                        fps)
        want = jprep.write_realtimestamps(str(tmp_path / "jax"), "vid", n,
                                          fps)
        assert os.path.basename(got) == os.path.basename(want)
        assert open(got, "rb").read() == open(want, "rb").read()
