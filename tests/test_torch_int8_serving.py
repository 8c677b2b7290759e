"""int8 serving wherever JAX serves it, on the CPU: under I3D chunk
streaming, under a model mesh, and with the I3D at its native input size.

Weights: the JAX model's variable shapes from ``jax.eval_shape`` (no init
compile), values drawn from a numpy seed, moved into the port with
``models/convert.py``. The model: I3D (16 px clips, ``i3d_input_size``
32, the stem fold) + ResNet-18, JMT SELF_ATTEN, one head, one layer, f32;
a request of B = 1, S = 4, so that ``i3d_chunk=2`` streams its 4 clips in
2 chunks.

* Chunk streaming (``ops/quant.stream_chunks``): the flagship's int8
  server builds and serves a chunked bucket; each chunk's I3D features
  equal the unchunked trunk run on that chunk alone, bitwise; the eval
  step against JAX's ``make_eval_step(int8=True)`` (its ``nn.scan``)
  within ``INT8_VA_TOL`` and ``DRIFT_SHARE``; static int8 and
  calibration refuse a chunked batch in the port, and fail in JAX.
* Tensor parallelism: the int8 server over ``["cpu"] * 2`` and ``* 4``,
  dynamic and static, against the one-device int8 server: the split int8
  convs' slices are the whole conv's columns bit for bit, so the gap is
  the split dense layers' (none on the CPU: bitwise); it splits as
  many layers as the float TP forward, prepares one weight per device
  slice once and none in a forward; against JAX's int8 server on a
  2-device model mesh within ``INT8_VA_TOL`` and ``DRIFT_SHARE``.
* Native input size: the port's I3D at ``i3d_input_size`` equal to the
  clip size (the plain 7 x 7 x 7 stem, no resize) against JAX's at 2e-4;
  the native stem's int8 conv is ``INT8_FAMILIES["i3d_stem_native"]``
  (``tests/test_torch_quant.py``, bitwise against JAX's).
"""
import numpy as np
import pytest
import torch

import jax

from jmt_tpu.models.jmt_model import JMTModel as JJMTModel
from jmt_tpu.models.tsav import TwoStreamBackbones as JBackbones
from jmt_tpu.parallel.tp import make_model_mesh as jax_model_mesh
from jmt_tpu.serve import InferenceServer as JInferenceServer
from jmt_tpu.train import loops as jloops
from jmt_tpu.train.state import TrainState as JTrainState
from jmt_tpu_torch import serve
from jmt_tpu_torch.models import convert
from jmt_tpu_torch.models.common import init_parameters
from jmt_tpu_torch.models.jmt_model import JMTModel
from jmt_tpu_torch.models.tsav import TwoStreamBackbones
from jmt_tpu_torch.ops import quant
from jmt_tpu_torch.ops.conv import conv_nd
from jmt_tpu_torch.ops.kernels import int8_conv as k5
from jmt_tpu_torch.parallel import tp
from jmt_tpu_torch.train import loops
from jmt_tpu_torch.train.state import TrainState
from test_torch_quant import DRIFT_SHARE, INT8_VA_TOL, _drift_share

torch.set_num_threads(2)

CFG = dict(vision_backbones=("I3D",), audio_backbones=("ResNet18",),
           joint_modalities="TRANSFORMER", output_format="SELF_ATTEN",
           num_heads=1, num_layers=1, i3d_input_size=32)
B, S, PX, CHUNK = 1, 4, 16, 2


def _arrays(b=B, s=S, px=PX, seed=0):
    rng = np.random.default_rng(seed)
    return {"clips": rng.integers(0, 256, (b, s, 8, px, px, 3),
                                  dtype=np.uint8),
            "audio": (0.1 * rng.normal(size=(b, s, 45599))).astype(
                np.float32)}


def _seeded(shapes, seed=0):
    """Values for a variable tree of ``jax.eval_shape`` shapes: kernels
    N(0, 1 / fan-in), norm scales and weight-norm gains near 1, biases
    and running means near 0, running variances near 1."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        n = rng.normal(size=s.shape).astype(np.float32)
        if name.endswith("kernel") or name == "v":
            return n / np.sqrt(max(1, int(np.prod(s.shape[:-1]))))
        if name in ("scale", "g"):
            return 1 + 0.1 * n
        if name == "var":
            return 1 + 0.1 * np.abs(n)
        return 0.1 * n

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _jax_model(module, *inputs):
    """``module``'s seeded variables (shapes from ``jax.eval_shape``)."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *inputs)
    return _seeded(shapes)


@pytest.fixture(scope="module")
def run():
    """JAX: the dynamic int8 eval V/A on the chunked batch and the int8
    V/A of its server on a 2-device model mesh (unchunked model); the
    port model (chunked), its unchunked twin with the same weights, and
    its f32 eval V/A, the base of the drift shares (one JAX compile less;
    the f32 paths agree to ~1e-7, ``tests/test_torch_quant.py``)."""
    arrays = _arrays()
    jm = JJMTModel(**CFG, i3d_chunk=CHUNK)
    spec, clips = jloops._preprocess(jm, arrays, None, augment=False)
    variables = _jax_model(jm, spec, clips, None)
    jstate = JTrainState(trainable=variables["params"], frozen={},
                         batch_stats=variables["batch_stats"],
                         opt_state=None)
    out = {"arrays": arrays, "jm": jm, "jstate": jstate}
    out["int8"] = np.stack([np.asarray(t) for t in jloops.make_eval_step(
        jm, int8=True)(jstate, arrays)])
    jserver = JInferenceServer(
        JJMTModel(**CFG), variables["params"], variables["batch_stats"],
        seq=S, buckets=(B,), img_size=PX, use_wavlm=False,
        model_mesh=jax_model_mesh(2), int8=True)
    out["int8_tp"] = np.stack(jserver.predict(arrays["clips"],
                                              arrays["audio"]))
    np_vars = jax.tree.map(np.asarray, variables)
    out["model"] = convert.load_jax_variables(
        JMTModel(**CFG, i3d_chunk=CHUNK), np_vars)
    out["model0"] = convert.load_jax_variables(JMTModel(**CFG), np_vars)
    out["f32"] = torch.stack(loops.make_eval_step(out["model"], device="cpu")(
        _state(out["model"]), arrays)).numpy()
    return out


def _state(model):
    return TrainState(model=model, optimizer=None, trainable=[], frozen=[])


def _server(model, **kw):
    return serve.InferenceServer(model, seq=S, buckets=(B,), img_size=PX,
                                 use_wavlm=False, device="cpu", **kw)


def _predict(server, arrays):
    return np.stack(server.predict(arrays["clips"], arrays["audio"]))


# ---------------------------------------------------------------------------
# I3D chunk streaming
# ---------------------------------------------------------------------------
FLAGSHIP = dict(vision_backbones=("R2D1", "I3D"),
                audio_backbones=("ResNet18", "wavLM"),
                intra_modal_fusion="encoder_plus_self_attention",
                num_heads=1, num_layers=1, i3d_input_size=64)


def _flagship_request(b):
    rng = np.random.default_rng(1)
    return (rng.integers(0, 256, (b, 2, 8, 32, 32, 3), dtype=np.uint8),
            (0.1 * rng.normal(size=(b, 2, 45599))).astype(np.float32),
            rng.normal(size=(b, 2, 768)).astype(np.float32))


def test_int8_server_serves_a_chunked_bucket():
    """The flagship's backbones at 32 px (the stem folded), seq 2,
    ``i3d_chunk=2``, buckets (1, 2): bucket 2's 4 clips stream in 2
    chunks. The dynamic int8 server builds (its 110 weights prepared on
    bucket 1), serves bucket 2 preparing no weight, and gives finite
    V/A; a server whose smallest bucket is chunked prepares 110 too."""
    model = init_parameters(JMTModel(**FLAGSHIP, i3d_chunk=2),
                            torch.Generator().manual_seed(0))
    assert model.backbones.i3d_chunks(4) == 2
    assert model.backbones.i3d_chunks(2) == 1
    for buckets in ((1, 2), (2,)):
        server = serve.InferenceServer(model, seq=2, buckets=buckets,
                                       img_size=32, device="cpu", int8=True)
        assert len(server.int8_weights) == 110
        before = k5.prepare_weight.calls
        v, a = server.predict(*_flagship_request(2))
        assert k5.prepare_weight.calls == before
        assert v.shape == a.shape == (2, 2)
        assert np.isfinite(v).all() and np.isfinite(a).all()


@pytest.mark.parametrize("weights", ["per_call", "prepared"])
def test_chunked_int8_equals_each_chunk_alone(run, weights):
    """Dynamic int8: each chunk's I3D features equal the unchunked trunk's
    on that chunk alone, bit for bit (each chunk's K6 takes its own max),
    with the weights prepared in the forward or taken from a list made by
    a chunked forward (as long as one chunk's)."""
    spec, clips = loops.preprocess(run["model"], {
        k: torch.from_numpy(x) for k, x in run["arrays"].items()})
    chunked, whole = run["model"].backbones, run["model0"].backbones
    prepared = None
    if weights == "prepared":
        prepared = quant.collect_int8_weights(
            lambda: _i3d(chunked, spec, clips, True))
        alone = quant.collect_int8_weights(
            lambda: _i3d(whole, spec[:, :CHUNK], clips[:, :CHUNK], True))
        assert len(prepared) == len(alone) > 0
    got = _i3d(chunked, spec, clips, True, prepared)
    want = torch.cat([_i3d(whole, spec[:, i:i + CHUNK],
                           clips[:, i:i + CHUNK], True)
                      for i in range(0, S, CHUNK)], dim=1)
    assert torch.equal(got, want)
    # one scale over all 4 clips gives another forward; in f32 the
    # chunks are the whole batch's
    assert not torch.equal(got, _i3d(whole, spec, clips, True))
    assert torch.equal(_i3d(chunked, spec, clips, False),
                       _i3d(whole, spec, clips, False))


def _i3d(backbones: TwoStreamBackbones, spec, clips, int8, weights=None):
    with torch.inference_mode(), quant.int8_inference(int8,
                                                      weights=weights):
        return backbones(spec, clips)["vision_i3d"]


def test_chunked_dynamic_int8_matches_jax(run):
    """The port's int8 eval step on the chunked batch against JAX's
    (``nn.scan`` over the chunks): within ``INT8_VA_TOL`` and a share of
    the int8 drift from f32 under ``DRIFT_SHARE``."""
    got = torch.stack(loops.make_eval_step(
        run["model"], device="cpu", int8=True)(_state(run["model"]),
                                               run["arrays"])).numpy()
    np.testing.assert_allclose(got, run["int8"], rtol=0,
                               atol=INT8_VA_TOL["dynamic"])
    assert _drift_share(got, run["int8"], run["f32"]) < DRIFT_SHARE


@pytest.mark.parametrize("where", ["construct", "calibrate", "eval_step"])
def test_static_int8_refuses_a_chunked_batch(run, where):
    """Static scales are one per conv call of a forward that is not
    streamed: the port raises naming ``i3d_chunk`` (the server at
    construction or ``calibrate``, before any request); JAX's static eval
    step on the same batch fails with 'act_scales exhausted'."""
    model, arrays = run["model"], run["arrays"]
    scales = quant.act_scales_from_maxes(loops.make_calibration_step(
        run["model0"], device="cpu")(_state(run["model0"]), arrays))
    with pytest.raises(RuntimeError, match="i3d_chunk"):
        if where == "construct":
            _server(model, int8="static", int8_scales=scales)
        elif where == "calibrate":
            server = _server(model, int8=True)
            server.calibrate(arrays["clips"][:, :1], arrays["audio"][:, :1])
        else:
            loops.make_eval_step(model, device="cpu", int8=True,
                                 act_scales=scales)(_state(model), arrays)
    if where == "eval_step":
        with pytest.raises(RuntimeError, match="act_scales exhausted"):
            jloops.make_eval_step(run["jm"], int8=True, act_scales=scales)(
                run["jstate"], arrays)


def test_calibration_refuses_a_chunked_batch(run):
    """JAX's calibration step on a chunked batch gives no maxes (the scan
    body's recorded maxima escape their trace); the port's raises, naming
    ``i3d_chunk``, instead of returning chunks x the conv count."""
    with pytest.raises(RuntimeError, match="i3d_chunk"):
        loops.make_calibration_step(run["model"], device="cpu")(
            _state(run["model"]), run["arrays"])
    with pytest.raises(jax.errors.UnexpectedTracerError):
        jloops.make_calibration_step(run["jm"])(run["jstate"], run["arrays"])


def test_chunks_running_other_convs_raise():
    """``stream_chunks`` holds every chunk to the first chunk's count of
    eligible convs: fewer raise at the chunk's end, more when the first
    chunk's weights run out."""
    gen = torch.Generator().manual_seed(0)
    w = torch.randn(32, 32, 3, generator=gen)

    def run_chunk(x):
        y = conv_nd(x, w, pads=((1, 1),))
        if x[0, 0, 0] > 100:  # a planted chunk runs a second conv
            y = conv_nd(y, w, pads=((1, 1),))
        return y

    for planted, match in ((None, None), (0, "i3d_chunk: chunk 1 ran 1"),
                           (1, "exhausted")):
        x = torch.randn(2, 32, 5, generator=gen)
        if planted is not None:
            x[planted, 0, 0] = 1000.0
        with torch.inference_mode(), quant.int8_inference(True):
            if match is None:
                assert len(quant.stream_chunks(run_chunk,
                                               x.split(1))) == 2
                continue
            with pytest.raises(RuntimeError, match=match):
                quant.stream_chunks(run_chunk, x.split(1))


# ---------------------------------------------------------------------------
# tensor parallelism
# ---------------------------------------------------------------------------
def _tp_forward_calls(server, arrays):
    calls = tp.sharded_calls()
    out = _predict(server, arrays)
    return out, tp.sharded_calls() - calls


@pytest.mark.parametrize("mode", ["dynamic", "static"])
@pytest.mark.parametrize("n", [2, 4])
def test_tp_int8_server_matches_one_device(run, n, mode):
    """The TP int8 server (``model_mesh=["cpu"] * n``) against the
    one-device int8 server on the unchunked model: bitwise (the split int8
    convs' slices are the whole conv's columns; the split dense layers
    round alike on the CPU). It splits as many layers a forward as the
    float TP server (its int8 convs among them), prepares one weight per
    device slice of each split conv once, and none in a forward. Static:
    calibrated under the mesh, the same scales as on one device."""
    model, arrays = run["model0"], run["arrays"]
    one = _server(model, int8=True)
    tps = _server(model, int8=True, model_mesh=["cpu"] * n)
    if mode == "static":
        scales = one.calibrate(arrays["clips"], arrays["audio"])
        assert tps.calibrate(arrays["clips"], arrays["audio"]) == scales
    split = [w for w in tps.int8_weights if isinstance(w, tuple)]
    assert len(tps.int8_weights) == len(one.int8_weights)
    assert split and all(len(w) == n for w in split)
    for w in split:
        assert {p.shape[0] for p in w} == {w[0].shape[0]}
    want = _predict(one, arrays)
    before = k5.prepare_weight.calls
    got, int8_calls = _tp_forward_calls(tps, arrays)
    assert k5.prepare_weight.calls == before
    _, float_calls = _tp_forward_calls(
        _server(model, model_mesh=["cpu"] * n), arrays)
    assert int8_calls == float_calls > len(split)
    np.testing.assert_array_equal(got, want)


def test_tp_int8_matches_jax_sharded(run):
    """The port's TP int8 server against JAX's int8 server on a 2-device
    model mesh (GSPMD over sharded parameters): within ``INT8_VA_TOL``
    and a share of the int8 drift from f32 under ``DRIFT_SHARE``."""
    got = _predict(_server(run["model0"], int8=True, model_mesh=["cpu"] * 2),
                   run["arrays"])
    np.testing.assert_allclose(got, run["int8_tp"], rtol=0,
                               atol=INT8_VA_TOL["dynamic"])
    assert _drift_share(got, run["int8_tp"], run["f32"]) < DRIFT_SHARE


def test_tp_prepared_weights_refuse_another_mesh(run):
    """Weights prepared for one mesh are refused under another (or
    none): a split conv's entry is one weight per device slice."""
    model, arrays = run["model0"], run["arrays"]
    tps = _server(model, int8=True, model_mesh=["cpu"] * 2)
    on = {k: torch.from_numpy(x) for k, x in arrays.items()}
    for mesh in (None, ["cpu"] * 4):
        with tp.tensor_parallel(mesh), \
                pytest.raises(RuntimeError, match="model mesh"):
            loops.eval_forward(model, on, True, None, tps.int8_weights)


def test_calibration_scales_split_under_a_mesh(run):
    """``serve.calibration_scales(model_mesh=...)`` (what ``serve --tp N
    --int8-static`` runs) splits calibration's float convs over the mesh
    and gives the one-device scales."""
    model, arrays = run["model0"], run["arrays"]
    kw = dict(device="cpu", use_wavlm=False)
    want = serve.calibration_scales(model, arrays["clips"], arrays["audio"],
                                    **kw)
    calls = tp.sharded_calls()
    got = serve.calibration_scales(model, arrays["clips"], arrays["audio"],
                                   model_mesh=["cpu"] * 2, **kw)
    assert tp.sharded_calls() > calls
    assert got == want


# ---------------------------------------------------------------------------
# the I3D at its native input size
# ---------------------------------------------------------------------------
def test_i3d_native_input_size_matches_jax():
    """``i3d_input_size`` equal to the clip size (the native-112 geometry
    at 32 px): the plain 7 x 7 x 7 stride-(1, 2, 2) stem, no resize, the
    pool before Mixed_5b on an odd map; port against JAX, 2e-4."""
    rng = np.random.default_rng(4)
    clips = rng.normal(size=(1, 2, 8, 32, 32, 3)).astype(np.float32)
    kw = dict(vision_backbones=("I3D",), audio_backbones=(),
              i3d_input_size=32)
    jm = JBackbones(**kw)
    variables = _jax_model(jm, None, clips)
    want = np.asarray(jax.jit(jm.apply)(variables, None,
                                        clips)["vision_i3d"])
    pm = convert.load_jax_variables(TwoStreamBackbones(**kw),
                                    jax.tree.map(np.asarray, variables))
    with torch.inference_mode():
        got = pm(None, torch.from_numpy(clips))["vision_i3d"]
    assert got.shape == want.shape == (1, 2, 512)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-4)
