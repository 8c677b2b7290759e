"""The port's InferenceServer on the CPU against the JAX model.

Bucket padding and splitting must not change any row: ``predict`` at batch
3 with buckets (2, 4) pads to 4, and at batch 5 with top bucket 4 splits
into 4 + 1 (padded to 2); every returned row is held to the JAX model run
on exactly the requested rows, atol 2e-5 (fp32, slice configuration,
S=4, 32 px).
"""
import numpy as np
import pytest
import torch

import jax

from jmt_tpu.models.jmt_model import JMTModel as JJMTModel
from jmt_tpu.train.loops import _preprocess
from jmt_tpu_torch import resolve_device
from jmt_tpu_torch.models.convert import load_jax_variables
from jmt_tpu_torch.models.jmt_model import JMTModel
from jmt_tpu_torch.serve import InferenceServer

torch.set_num_threads(2)

CFG = dict(vision_backbones=("R2D1",), audio_backbones=("ResNet18", "wavLM"),
           intra_modal_fusion="encoder_plus_self_attention")
S, PX = 4, 32


def _request(n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (n, S, 8, PX, PX, 3), dtype=np.uint8),
            (0.1 * rng.normal(size=(n, S, 45599))).astype(np.float32),
            rng.normal(size=(n, S, 768)).astype(np.float32))


@pytest.fixture(scope="module")
def jax_model():
    jm = JJMTModel(**CFG)
    clips, audio, wavlm = _request(1)
    spec, c = _preprocess(jm, {"clips": clips, "audio": audio}, None,
                          augment=False)
    variables = jax.jit(jm.init)(jax.random.PRNGKey(0), spec, c, wavlm)
    apply = jax.jit(jm.apply)

    def run(clips, audio, wavlm):
        spec, c = _preprocess(jm, {"clips": clips, "audio": audio}, None,
                              augment=False)
        v, a = apply(variables, spec, c, wavlm)
        return np.asarray(v), np.asarray(a)

    return run, jax.tree.map(np.asarray, variables)


@pytest.mark.parametrize("n,buckets", [(3, (2, 4)), (5, (2, 4))])
def test_predict_pads_and_splits_like_jax(jax_model, n, buckets):
    run, variables = jax_model
    model = load_jax_variables(JMTModel(**CFG), variables)
    server = InferenceServer(model, seq=S, buckets=buckets, img_size=PX,
                             device="cpu")
    req = _request(n, seed=n)
    v, a = server.predict(*req)
    assert v.shape == a.shape == (n, S) and v.dtype == np.float32
    want_v, want_a = run(*req)
    np.testing.assert_allclose(v, want_v, rtol=0, atol=2e-5)
    np.testing.assert_allclose(a, want_a, rtol=0, atol=2e-5)


def test_predict_rejects_wrong_shapes():
    server = InferenceServer(JMTModel(**CFG), seq=S, buckets=(2,),
                             img_size=PX, device="cpu")
    clips, audio, wavlm = _request(1)
    with pytest.raises(ValueError, match="wavlm"):
        server.predict(clips, audio)
    with pytest.raises(ValueError, match="clips"):
        server.predict(clips[:, :2], audio, wavlm)


def test_default_device_is_the_card_and_raises_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        InferenceServer(JMTModel(**CFG))
    assert resolve_device("cpu") == torch.device("cpu")
