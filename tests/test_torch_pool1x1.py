"""Kernel K4's plain version and its experiment entry point against the
JAX package's TPU experiment, fp32 on CPU.

The TPU tool ``tools/pallas_pool1x1_experiment.py`` runs ``main()`` when it
is imported; it is loaded from its file with ``sys.argv`` holding no mode
word, so that ``main()`` does nothing, and its kernel runs as its own
``check`` runs it: ``interpret=True``. Inputs are N(0, 1) of both signs,
made with numpy; atol 1e-5 covers f32 summation order.
"""
import importlib.util
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jmt_tpu_torch.models.i3d import I3D_STAGES
from jmt_tpu_torch.ops.pool1x1 import pool3_1x1_plain
from jmt_tpu_torch.tools import pool1x1_experiment as pe

torch.set_num_threads(2)

TOOL = Path(__file__).resolve().parents[1] / "tools" / \
    "pallas_pool1x1_experiment.py"


@pytest.fixture(scope="module")
def tool():
    saved = sys.argv
    sys.argv = [str(TOOL)]
    try:
        spec = importlib.util.spec_from_file_location(
            "pallas_pool1x1_experiment", TOOL)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.argv = saved
    return mod


@pytest.mark.parametrize("shape,co", pe.CHECK_SHAPES)
def test_plain_matches_tool_kernel_and_xla_ref(tool, shape, co):
    """The tool's check shapes: ``pool3_1x1_plain`` against the TPU kernel
    (interpret mode) and the tool's ``xla_ref`` (reduce_window max pool,
    then a 1x1 conv), atol 1e-5."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=shape).astype(np.float32)
    k = (0.1 * rng.normal(size=(shape[-1], co))).astype(np.float32)
    got = pool3_1x1_plain(torch.from_numpy(x).permute(0, 4, 1, 2, 3),
                          torch.from_numpy(k))
    got = got.permute(0, 2, 3, 4, 1).numpy()
    for want in (tool.pool3_1x1(jnp.asarray(x), jnp.asarray(k),
                                interpret=True),
                 tool.xla_ref(jnp.asarray(x), jnp.asarray(k))):
        want = np.asarray(want)
        assert got.shape == want.shape == shape[:4] + (co,)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_experiment_shapes_are_the_tools():
    """The entry point's check, timed and chain shapes are the TPU tool's
    (``tools/pallas_pool1x1_experiment.py:176, 187-193, 162``)."""
    assert pe.CHECK_SHAPES == (((2, 4, 6, 6, 16), 8), ((1, 8, 14, 14, 32), 16))
    assert [c for mode in ("time", "time2") for c in pe.TIME_SHAPES[mode]] \
        == [((128, 8, 14, 14, 512), 64), ((128, 4, 7, 7, 832), 128),
            ((128, 8, 28, 28, 256), 64), ((128, 8, 14, 14, 480), 64),
            ((128, 8, 14, 14, 528), 128), ((128, 8, 28, 28, 192), 32)]
    assert pe.CHAIN_INPUT == (128, 8, 14, 14, 480)
    mixed_4 = [spec for name, spec in I3D_STAGES if name.startswith("Mixed_4")]
    assert len(mixed_4) == 5


def test_chain_k4_matches_cudnn_path_on_cpu(monkeypatch):
    """Mixed_4b..4f at a small map on the CPU: b3 through K4's dispatcher
    (4 calls: C = 480, 512, 512, 512) against the port's unfused modules
    (b3 through max_pool_same and the b3b conv), the same weights; bf16,
    2e-2 of max |ref|."""
    calls = []

    def spy(x, k):
        calls.append(x.shape[1])
        return real(x, k)

    real = pe.pool3_1x1
    monkeypatch.setattr(pe, "pool3_1x1", spy)
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(1, 2, 3, 3, 480)).astype(np.float32)).to(torch.bfloat16)
    x = x.permute(0, 4, 1, 2, 3)
    with torch.inference_mode():
        got = pe.build_chain(True)(x).float()
        assert calls == [480, 512, 512, 512]
        want = pe.build_chain(False)(x).float()
    assert got.shape == want.shape == (1, 832, 2, 3, 3)
    assert (got - want).abs().max() <= 2e-2 * want.abs().max()


def test_entry_point_needs_a_mode_and_a_card():
    """Without a mode word it prints its usage (2); on this CPU-only host
    every mode refuses to run (1) rather than fall back to the CPU."""
    assert pe.main([]) == 2
    assert pe.main(["bogus"]) == 2
    if not torch.cuda.is_available():
        for mode in ("check", "time", "time2", "chain"):
            assert pe.main([mode]) == 1
