"""Tensor-parallel serving: sharded equals unsharded, on the CPU.

Counterpart of ``tests/test_tensor_parallel.py`` for
``jmt_tpu_torch.parallel.tp``. One process drives every shard: a conv or
dense weight whose output-channel axis (dim 0) is at least 128 and
divisible by the mesh computes its slices on the mesh's devices, here
``["cpu"] * 4``, gathered on the lead device. The real graph of
JAX's test (R2D1 vision, ResNet-18 and wavLM audio, intra-modal and JMT
fusion, f32, one 2-step window at 32 px):

* the rule on parameters (JAX's: the output-channel axis, >= 128,
  divisible; 1-D leaves stay whole here, BN running on the lead);
* the TP forward against JAX's unsharded forward (``jax.jit``), 2e-5,
  with layers actually split (``sharded_calls``) and at least one
  parameter sharded four ways;
* the TP ``InferenceServer`` against the plain one, 2e-5, and the serve
  command line with ``--tp 1`` and ``--tp 2`` on the CPU.
"""
import functools
import json

import numpy as np
import pytest
import torch

import jax

from jmt_tpu.models.jmt_model import JMTModel as JJMTModel
from jmt_tpu.train.loops import _preprocess
from jmt_tpu_torch import serve
from jmt_tpu_torch.models import convert
from jmt_tpu_torch.models.common import ConvNd, Linear
from jmt_tpu_torch.models.jmt_model import JMTModel
from jmt_tpu_torch.parallel import tp
from jmt_tpu_torch.train.loops import eval_forward

torch.set_num_threads(2)

CFG = dict(vision_backbones=("R2D1",), audio_backbones=("ResNet18", "wavLM"),
           intra_modal_fusion="encoder_plus_self_attention",
           joint_modalities="TRANSFORMER", output_format="SELF_ATTEN",
           num_heads=1, num_layers=1)


def _arrays():
    rng = np.random.default_rng(0)
    return {"clips": rng.integers(0, 255, size=(1, 2, 8, 32, 32, 3),
                                  dtype=np.uint8),
            "audio": (0.1 * rng.normal(size=(1, 2, 45599))).astype(
                np.float32),
            "wavlm": rng.normal(size=(1, 2, 768)).astype(np.float32)}


@pytest.fixture(scope="module")
def pair():
    """JAX's unsharded V/A and the port model with the JAX weights."""
    jm = JJMTModel(**CFG)
    arrays = _arrays()
    spec, clips = _preprocess(jm, arrays, None, augment=False)
    variables = jax.jit(jm.init)(jax.random.PRNGKey(0), spec, clips,
                                 arrays["wavlm"])
    v, a = jax.jit(jm.apply)(variables, spec, clips, arrays["wavlm"])
    model = convert.load_jax_variables(
        JMTModel(**CFG), jax.tree.map(np.asarray, variables))
    return (np.asarray(v), np.asarray(a)), model


def test_tp_spec_rules():
    mesh = tp.make_model_mesh(2, ["cpu", "cpu"])
    m = torch.nn.Module()
    m.conv = ConvNd(64, 512, (3, 3, 3))
    m.head = Linear(128, 2)
    m.odd = Linear(16, 129)
    m.norm = torch.nn.LayerNorm(512)
    rules = tp.tp_shardings(m, mesh)
    assert rules == {"conv.weight": 2, "head.weight": 1, "head.bias": 1,
                     "odd.weight": 1, "odd.bias": 1, "norm.weight": 1,
                     "norm.bias": 1}
    assert tp.tp_shardings(m, mesh[:1])["conv.weight"] == 1
    assert tp.make_model_mesh(-1, ["cpu"] * 3) == [torch.device("cpu")] * 3
    with pytest.raises(ValueError, match="model mesh of 4"):
        tp.make_model_mesh(4, ["cpu"] * 3)


def test_tp_flagship_matches_single_device(pair):
    (want_v, want_a), model = pair
    mesh = tp.make_model_mesh(4, ["cpu"] * 4)
    rules = tp.shard_params(model, mesh)
    assert max(rules.values()) == 4
    arrays = tp.replicate(_arrays(), mesh)
    calls = tp.sharded_calls()
    with tp.tensor_parallel(mesh):
        v, a = eval_forward(model, arrays)
    assert tp.sharded_calls() - calls >= 1
    np.testing.assert_allclose(v.numpy(), want_v, rtol=0, atol=2e-5)
    np.testing.assert_allclose(a.numpy(), want_a, rtol=0, atol=2e-5)


def test_tp_inference_server_matches_plain(pair):
    _, model = pair
    kw = dict(seq=2, buckets=(1,), img_size=32, device="cpu")
    plain = serve.InferenceServer(model, **kw)
    tps = serve.InferenceServer(model, model_mesh=["cpu"] * 4, **kw)
    assert tps.graphs == {} and sum(
        n > 1 for n in tps.tp_shardings.values()) >= 1
    x = _arrays()
    v0, a0 = plain.predict(x["clips"], x["audio"], x["wavlm"])
    v1, a1 = tps.predict(x["clips"], x["audio"], x["wavlm"])
    np.testing.assert_allclose(v1, v0, rtol=0, atol=2e-5)
    np.testing.assert_allclose(a1, a0, rtol=0, atol=2e-5)
    with pytest.raises(ValueError, match="lead"):
        serve.InferenceServer(model, model_mesh=["cpu"], seq=2,
                              buckets=(1,), img_size=32, device="meta")


@pytest.mark.parametrize("n", [1, 2])
def test_serve_command_line_tp_on_the_cpu(n, capsys, monkeypatch):
    """``serve --tp N --device cpu``: the seed-0 self-test model served
    by N shards on the CPU (one timed request per mode)."""
    monkeypatch.setattr(serve, "measure_latency", functools.partial(
        serve.measure_latency, iters=1, warmup=0))
    built = []
    init = serve.InferenceServer.__init__

    def spy(self, *args, **kw):
        init(self, *args, **kw)
        built.append(self)

    monkeypatch.setattr(serve.InferenceServer, "__init__", spy)
    assert serve.main(["--tp", str(n), "--device", "cpu", "--buckets",
                       "1"]) == 0
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert stats["buckets"]["1"]["relay"]["bucket"] == 1
    (server,) = built
    assert server.model_mesh == [torch.device("cpu")] * n
    assert (max(server.tp_shardings.values()) == n) and not server.graphs
