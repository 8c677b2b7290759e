"""Port backbones and clip preprocessing against the JAX package, fp32.

Tolerances: preprocess_clips 1e-6; ResNet18 on log-mel and R(2+1)D-18
features 3e-4 (the JAX package's backbone parity bound), and tighter where
the measured deviation allows (stated per test).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from jmt_tpu.data.transforms import preprocess_clips as jpre
from jmt_tpu.models.resnet18 import ResNet18 as JResNet18
from jmt_tpu.models.tsav import TwoStreamBackbones as JBackbones
from jmt_tpu.models.video_resnet import r2plus1d_18 as jr2plus1d_18
from jmt_tpu_torch.data.transforms import preprocess_clips
from jmt_tpu_torch.models.convert import load_jax_variables
from jmt_tpu_torch.models.resnet18 import ResNet18
from jmt_tpu_torch.models.tsav import TwoStreamBackbones
from jmt_tpu_torch.models.video_resnet import r2plus1d_18

torch.set_num_threads(2)


def _np_tree(variables):
    return jax.tree.map(np.asarray, variables)


def _clips(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 256, shape,
                                                dtype=np.uint8)


@pytest.fixture(scope="module")
def clips_f32():
    c = _clips((2, 8, 32, 32, 3))
    return c, np.array(jpre(jnp.asarray(c)))


def test_preprocess_clips(clips_f32):
    c, want = clips_f32
    got = preprocess_clips(torch.from_numpy(c))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    with pytest.raises(TypeError):
        preprocess_clips(torch.zeros(2, 3))


def test_resnet18_on_log_mel():
    """(N, 64, 104) log-mel. Measured deviation ~1e-6; held at 1e-5."""
    spec = np.random.default_rng(1).normal(size=(3, 64, 104)).astype(
        np.float32)
    jm = JResNet18(in_channels=1)
    variables = jax.jit(jm.init)(jax.random.PRNGKey(0), spec[..., None])
    want = np.asarray(jax.jit(jm.apply)(variables, spec[..., None]))
    pm = load_jax_variables(ResNet18(), _np_tree(variables))
    with torch.inference_mode():
        got = pm(torch.from_numpy(spec)[:, None])
    assert got.shape == (3, 512)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_r2plus1d_features_max_reduce(clips_f32):
    """32 px clips: layer4 map (N, 512, 1, 2, 2), MAX over it. Measured
    deviation ~1e-6; held at 1e-5."""
    _, x = clips_f32
    jm = jr2plus1d_18()
    variables = jax.jit(jm.init)(jax.random.PRNGKey(0), x)
    fmap = np.asarray(jax.jit(jm.apply)(variables, x))   # (N, T, H, W, C)
    pm = load_jax_variables(r2plus1d_18(), _np_tree(variables))
    with torch.inference_mode():
        got = pm(torch.from_numpy(x).permute(0, 4, 1, 2, 3).contiguous())
    assert got.shape == (2, 512, 1, 2, 2)
    np.testing.assert_allclose(got.permute(0, 2, 3, 4, 1).numpy(), fmap,
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(torch.amax(got, dim=(2, 3, 4)).numpy(),
                               fmap.reshape(2, -1, 512).max(axis=1),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("reduce", ["AVG", "FLATTEN"])
def test_two_stream_backbones_reduce(reduce):
    """Container keys (``vision_r2d1.r2plus1d``) and the AVG / FLATTEN
    reduces; FLATTEN carries the (T', H', W', C) -> (C, T', H', W') column
    permutation of its Linear. Held at 3e-4."""
    clips = np.array(jpre(jnp.asarray(_clips((1, 2, 8, 32, 32, 3)))))
    jm = JBackbones(vision_backbones=("R2D1",), audio_backbones=(),
                    r2d1_reduce=reduce)
    variables = jax.jit(jm.init)(jax.random.PRNGKey(0), None, clips)
    want = jax.jit(jm.apply)(variables, None, clips)["vision_r2d1"]
    pm = TwoStreamBackbones(vision_backbones=("R2D1",), audio_backbones=(),
                            r2d1_reduce=reduce, flatten_dim=512 * 2 * 2)
    load_jax_variables(pm, _np_tree(variables))
    with torch.inference_mode():
        got = pm(None, torch.from_numpy(clips))["vision_r2d1"]
    assert got.shape == (1, 2, 512)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=3e-4)


def test_i3d_names_the_next_slice():
    with pytest.raises(NotImplementedError, match="next slice"):
        TwoStreamBackbones(vision_backbones=("R2D1", "I3D"))
