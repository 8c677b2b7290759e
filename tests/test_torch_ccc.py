"""The port's CCC and smoothing against the JAX package (and scipy).

Every CCC function on the same float32 arrays as ``jmt_tpu``'s, atol 1e-6:
a -5-padded row (the loss keeps it, the masked loss drops it), a weight
mask with a zero row, a constant prediction (loss 1.0, metric NaN on both
sides) and the digitized loss with 5 bins. ``uniform_filter1d`` against
the JAX package (bit for bit: the same float32 summation order) and
against scipy's float64 ``uniform_filter1d(mode="constant")``, atol 1e-6
up to 120 frames (2e-5 at 530), at sizes 1, 2, 20 and 50 and lengths
shorter and longer than the size.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from scipy import ndimage

from jmt_tpu.ops import ccc as jccc
from jmt_tpu.ops import smoothing as jsm
from jmt_tpu_torch.ops import ccc
from jmt_tpu_torch.ops import smoothing


def _va(seed=0, b=4, s=16):
    """Predictions and labels (B, S); row 1 padded with -5 labels from
    timestep 10 on."""
    rng = np.random.default_rng(seed)
    pred = rng.uniform(-0.8, 0.8, (b, s)).astype(np.float32)
    label = np.clip(pred + 0.3 * rng.normal(size=(b, s)), -1, 1
                    ).astype(np.float32)
    label[1, 10:] = -5.0
    return pred, label


def _both(fn_t, fn_j, *arrays, weight=None, **kw):
    """fn on both sides; ``weight`` (an array) goes as a keyword."""
    tw = {} if weight is None else {"weight": torch.from_numpy(weight)}
    jw = {} if weight is None else {"weight": jnp.asarray(weight)}
    got = fn_t(*map(torch.from_numpy, arrays), **tw, **kw).numpy()
    want = np.asarray(fn_j(*map(jnp.asarray, arrays), **jw, **kw))
    return got, want


@pytest.mark.parametrize("name", ["ccc_loss", "ccc_metric",
                                  "ccc_loss_masked"])
def test_ccc_functions_match_jax(name):
    pred, label = _va()
    got, want = _both(getattr(ccc, name), getattr(jccc, name), pred, label)
    assert np.isfinite(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_ccc_loss_counts_the_padding_labels_and_masked_does_not():
    pred, label = _va()
    loss = float(ccc.ccc_loss(torch.from_numpy(pred),
                              torch.from_numpy(label)))
    masked = float(ccc.ccc_loss_masked(torch.from_numpy(pred),
                                       torch.from_numpy(label)))
    keep = label != -5.0
    clean = float(ccc.ccc_loss(torch.from_numpy(pred[keep]),
                               torch.from_numpy(label[keep])))
    assert abs(masked - clean) < 1e-6 and abs(loss - clean) > 1e-2


def test_ccc_loss_weight_mask_with_a_zero_row_matches_jax():
    pred, label = _va(seed=1)
    w = np.broadcast_to(np.array([1, 1, 0, 1], np.float32)[:, None],
                        pred.shape).copy()
    got, want = _both(ccc.ccc_loss, jccc.ccc_loss, pred, label, weight=w)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # the zero row is out: the same as the loss of the other rows
    rows = [0, 1, 3]
    alone = ccc.ccc_loss(torch.from_numpy(pred[rows]),
                         torch.from_numpy(label[rows])).numpy()
    np.testing.assert_allclose(got, alone, rtol=0, atol=1e-6)


def test_constant_prediction_loss_one_metric_nan_on_both_sides():
    _, label = _va(seed=2)
    pred = np.full_like(label, 0.25)
    got, want = _both(ccc.ccc_loss, jccc.ccc_loss, pred, label)
    assert float(got) == pytest.approx(1.0, abs=1e-6)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    got, want = _both(ccc.ccc_metric, jccc.ccc_metric, pred, label)
    assert np.isnan(got) and np.isnan(want)


def test_ccc_loss_digitized_five_bins_matches_jax():
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(4, 16, 5)).astype(np.float32)
    label = rng.uniform(-1, 1, (4, 16)).astype(np.float32)
    got, want = _both(ccc.ccc_loss_digitized, jccc.ccc_loss_digitized,
                      logits, label, num_bins=5)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    got, want = _both(ccc.digitized_expectation, jccc.digitized_expectation,
                      logits, num_bins=5)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("size", [1, 2, 20, 50])
@pytest.mark.parametrize("n", [7, 30, 120, 530])
def test_uniform_filter1d_matches_jax_and_scipy(size, n):
    rng = np.random.default_rng(n * 100 + size)
    x = rng.uniform(-1, 1, n)           # clipped predictions, float64
    got = smoothing.uniform_filter1d(torch.from_numpy(x), size).numpy()
    want_jax = np.asarray(jsm.uniform_filter1d(jnp.asarray(x), size))
    want_scipy = ndimage.uniform_filter1d(x.astype(np.float32).astype(
        np.float64), size, mode="constant")
    assert got.shape == (n,)
    np.testing.assert_array_equal(got, want_jax)
    # the float32 prefix sum is off by about an ulp of the running sum:
    # 2.8e-6 at size 1 over 530 frames, where the JAX package's own test
    # holds it to scipy at 2e-5 (tests/test_smoothing.py)
    atol = 1e-6 if n <= 120 else 2e-5
    np.testing.assert_allclose(got, want_scipy, rtol=0, atol=atol)


def test_clip_and_smooth_matches_jax():
    rng = np.random.default_rng(4)
    v = (2 * rng.normal(size=481)).astype(np.float32)
    a = (2 * rng.normal(size=481)).astype(np.float32)
    got = smoothing.clip_and_smooth(torch.from_numpy(v), torch.from_numpy(a))
    want = jsm.clip_and_smooth(jnp.asarray(v), jnp.asarray(a))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-6)
