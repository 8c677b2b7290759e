"""The port's serving module on the CPU against the JAX package's.

Bucket padding and splitting must not change any row: ``predict`` at batch
3 with buckets (2, 4) pads to 4, and at batch 5 with top bucket 4 splits
into 4 + 1 (padded to 2); every returned row is held to the JAX model run
on exactly the requested rows, atol 2e-5 (fp32, slice configuration,
S=4, 32 px).

Raw audio: ``WavLMFrontend.features`` against JAX's (tiny WavLM, the same
weights), atol 1e-5; a raw-audio ``predict`` equals one given those
features, padded rows do not leak into real rows, a non-default
``audio_samples`` works. ``from_experiment`` on a directory the port's
CLI wrote (f32; the audio ResNet-18 finetuned under the PRETRAINING
head, so that a CPU forward at the served 16 x 112 px is cheap) against JAX's
``from_experiment(weights="components")`` on the same directory, atol
1e-6 (measured 2.7e-7 on V/A of up to 8e-3: far inside the backbones'
3e-4), and bit for bit the port Runner's eval forward, for both weight
modes (whose V differ by 0.026 here).
``StreamingSession`` fed the same server outputs as JAX's: the same traces
bit for bit, the same errors and challenge files, and the traces of
``eval/stitch``. ``measure_latency`` returns JAX's keys; the command line
serves the directory, in int8 too (``--int8``, ``--int8-static``), and
refuses a ``--tp`` mesh larger than the host's cards. int8 on the CPU:
the server equals ``make_eval_step(int8=True)``, and ``calibrate`` returns
``make_calibration_step``'s scales and switches to static.
"""
import json
import os

import numpy as np
import pytest
import torch

import jax

from jmt_tpu import serve as jserve
from jmt_tpu.models import wavlm as jwavlm
from jmt_tpu.models.jmt_model import JMTModel as JJMTModel
from jmt_tpu.train.loops import _preprocess
from jmt_tpu_torch import cli, resolve_device
from jmt_tpu_torch import serve
from jmt_tpu_torch.core.checkpoint import restore_train_state
from jmt_tpu_torch.core.config import Config
from jmt_tpu_torch.eval.stitch import Stitcher
from jmt_tpu_torch.models.convert import load_jax_variables
from jmt_tpu_torch.models.jmt_model import JMTModel
from jmt_tpu_torch.serve import InferenceServer
from jmt_tpu_torch.train.runner import Runner
from test_torch_runner import _init_from
from test_torch_wavlm import TINY, jax_cfg, model as wavlm_model

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


# ---------------------------------------------------------------------------
# raw audio: the WavLM frontend
# ---------------------------------------------------------------------------
class WavlmStub(torch.nn.Module):
    """A model of the wavLM path alone (the server's contract: attributes
    vision_backbones, audio_backbones, use_wavlm, dtype)."""
    vision_backbones, audio_backbones = (), ("wavLM",)
    use_wavlm, dtype = True, None

    def __init__(self, dim):
        super().__init__()
        torch.manual_seed(0)
        self.a, self.b = torch.nn.Linear(dim, 8), torch.nn.Linear(8, 2)

    def forward(self, spec, clips, wavlm):
        out = self.b(torch.tanh(self.a(wavlm)))
        return out[..., 0], out[..., 1]


@pytest.fixture(scope="module")
def frontends():
    m = wavlm_model(TINY, 3)
    params = jwavlm.wavlm_params_from_torch(m.state_dict(), jax_cfg(TINY))
    return (serve.WavLMFrontend(m, audio_samples=4410, device="cpu"),
            jserve.WavLMFrontend(params, jax_cfg(TINY), audio_samples=4410))


def _chunks(b, seq=3, a_len=4410, seed=5):
    rng = np.random.default_rng(seed)
    return rng.normal(0, 0.1, (b, seq, a_len)).astype(np.float32)


def test_frontend_features_match_jax(frontends):
    port, jax_frontend = frontends
    audio = _chunks(2)
    got = port.features(audio)
    assert got.shape == (2, 3, TINY.hidden_size) and got.dtype == np.float32
    np.testing.assert_allclose(got, jax_frontend.features(audio), rtol=0,
                               atol=1e-5)
    with pytest.raises(ValueError, match="4410"):
        port.features(_chunks(1, a_len=4000))


def test_raw_audio_predict_equals_predict_with_its_features(frontends):
    frontend = frontends[0]
    server = InferenceServer(WavlmStub(TINY.hidden_size), seq=3,
                             buckets=(2,), img_size=8, audio_samples=4410,
                             wavlm_frontend=frontend, device="cpu")
    assert server.wavlm_dim == TINY.hidden_size
    rng = np.random.default_rng(5)
    clips = rng.integers(0, 255, (2, 3, 8, 8, 8, 3), dtype=np.uint8)
    audio = _chunks(2)
    v_raw, a_raw = server.predict(clips, audio)
    feats = frontend.features(audio)
    v, a = server.predict(clips, audio, feats)
    np.testing.assert_array_equal(v_raw, v)
    np.testing.assert_array_equal(a_raw, a)
    # per-chunk features: the padded row of a batch-1 request does not
    # reach the real row
    v1, a1 = server.predict(clips[:1], audio[:1])
    np.testing.assert_allclose(v1, v_raw[:1], rtol=0, atol=1e-6)
    np.testing.assert_allclose(a1, a_raw[:1], rtol=0, atol=1e-6)
    bare = InferenceServer(WavlmStub(768), seq=3, buckets=(2,), img_size=8,
                           audio_samples=4410, device="cpu")
    with pytest.raises(ValueError, match="WavLMFrontend"):
        bare.predict(clips, audio)


# ---------------------------------------------------------------------------
# from_experiment, the latency meter and the command line
# ---------------------------------------------------------------------------
EXP_ARGV = ["--synthetic", "2:481:16", "--l_vision_backbones", "None",
            "--l_audio_backbones", "ResNet18", "--freeze_audio_ResNet18",
            "False", "--goal", "PRETRAINING", "--compute_dtype", "float32",
            "--train_params__batch_size", "2", "--val_params__batch_size",
            "2", "--train_params__stride", "480", "--val_params__stride",
            "480", "--opt__lr", "0.01", "--verbose", "False"]
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def train_experiment(outd, epochs=2) -> str:
    """The port's CLI on the CPU: a tiny experiment; returns its dir."""
    assert cli.main(["--config", os.path.join(ROOT, "config.json"),
                     *EXP_ARGV, "--max_epochs", str(epochs), "--device",
                     "cpu", "--outd", str(outd)]) == 0
    return os.path.join(str(outd), "id_exp")


@pytest.fixture(scope="module")
def experiment(tmp_path_factory):
    exp = train_experiment(tmp_path_factory.mktemp("serve_exp"))
    wdir = os.path.join(exp, "SavedWeights")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr("jmt_tpu.train.runner.init_state", _init_from(wdir))
        jax_server = jserve.InferenceServer.from_experiment(
            exp, buckets=(2,), weights="components")
    return exp, jax_server


def _audio_request(n, seed):
    rng = np.random.default_rng(seed)
    return (np.zeros((n, 16, 8, 112, 112, 3), np.uint8),
            (0.1 * rng.normal(size=(n, 16, 45599))).astype(np.float32),
            rng.normal(size=(n, 16, 768)).astype(np.float32))


def _runner_forward(exp, weights, req):
    """The port Runner's eval forward in Eval mode, as the CLI loads it."""
    cfg = Config.from_file(os.path.join(exp, "final_config.yml"))
    cfg.Mode = "Eval"
    runner = Runner(cfg, None, None, device="cpu")
    runner.initialize()
    wdir = os.path.join(exp, "SavedWeights")
    if weights == "components":
        runner.load_components(wdir)
    else:
        restore_train_state(wdir, runner.state)
    v, a = runner.eval_step(runner.state, dict(zip(("clips", "audio",
                                                    "wavlm"), req)))
    return v.numpy(), a.numpy()


def test_from_experiment_matches_jax_and_the_runner(experiment):
    exp, jax_server = experiment
    server = InferenceServer.from_experiment(exp, buckets=(2,),
                                             device="cpu")
    for n in (1, 2, 3):
        req = _audio_request(n, seed=n)
        v, a = server.predict(*req)
        want_v, want_a = jax_server.predict(*req)
        assert v.shape == (n, 16) and np.std(v) > 0
        np.testing.assert_allclose(v, want_v, rtol=0, atol=1e-6)
        np.testing.assert_allclose(a, want_a, rtol=0, atol=1e-6)
    req = _audio_request(2, seed=7)
    for weights in ("components", "state"):
        got = InferenceServer.from_experiment(
            exp, buckets=(2,), weights=weights, device="cpu").predict(*req)
        want = _runner_forward(exp, weights, req)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    auto = server.predict(*req)
    np.testing.assert_array_equal(auto[0], _runner_forward(
        exp, "components", req)[0])
    with pytest.raises(ValueError, match="weights"):
        InferenceServer.from_experiment(exp, weights="best", device="cpu")


def test_measure_latency_returns_the_jax_keys(experiment):
    exp, jax_server = experiment
    server = InferenceServer.from_experiment(exp, buckets=(2,),
                                             device="cpu")
    want = jserve.measure_latency(jax_server, 2, iters=1, warmup=0)
    for device_input in (False, True):
        got = serve.measure_latency(server, 2, iters=2, warmup=0,
                                    device_input=device_input)
        assert set(got) == set(want)
        assert got["bucket"] == 2 and got["device_input"] is device_input
        assert 0 < got["p50_ms"] <= got["p90_ms"]
        assert got["clips_per_s"] == pytest.approx(
            2 * 16 / (got["p50_ms"] / 1e3))


def test_command_line_serves_the_experiment(experiment, capsys):
    exp, _ = experiment
    assert serve.main(["--exp-dir", exp, "--buckets", "1", "--device",
                       "cpu", "--compilation-cache", "/nowhere"]) == 0
    out, err = capsys.readouterr()
    stats = json.loads(out.strip().splitlines()[-1])
    assert set(stats["buckets"]["1"]) == {"relay", "device_resident"}
    assert stats["buckets"]["1"]["relay"]["bucket"] == 1
    assert "--compilation-cache is ignored" in err


@pytest.mark.parametrize("flag", [["--tp", "2"]])
def test_command_line_refuses_what_is_not_ported(flag):
    """``--tp`` is ported (``tests/test_torch_tp.py``): a model mesh of
    more cards than the host has (2 on a host without cards) is
    refused."""
    n = max(int(flag[1]), torch.cuda.device_count() + 1)
    with pytest.raises(ValueError, match=f"model mesh of {n}"):
        serve.main([flag[0], str(n)])


@pytest.mark.parametrize("flag", ["--int8", "--int8-static"])
def test_command_line_serves_int8(experiment, flag, capsys, monkeypatch):
    """The experiment served in int8: dynamic, or static with scales
    calibrated on JAX's synthetic request before the server is built (so
    each bucket is captured once)."""
    built, capture = [], serve.InferenceServer._capture

    def spy(self):
        built.append((self.int8, self.int8_scales))
        capture(self)

    monkeypatch.setattr(serve.InferenceServer, "_capture", spy)
    exp, _ = experiment
    assert serve.main(["--exp-dir", exp, "--buckets", "1", "--device",
                       "cpu", flag]) == 0
    stats = json.loads(capsys.readouterr()[0].strip().splitlines()[-1])
    assert stats["buckets"]["1"]["relay"]["p50_ms"] > 0
    assert stats["buckets"]["1"]["device_resident"]["p50_ms"] > 0
    mode, scales = built[0]
    assert len(built) == 1
    if flag == "--int8":
        assert mode is True and scales is None
    else:
        model = serve.experiment_model(exp, device="cpu")
        req = serve._calibration_request(16, 112, 45599, None)
        assert mode == "static"
        assert scales == serve.calibration_scales(model, *req, device="cpu")
        assert len(scales) == 19  # the audio ResNet-18's eligible convs


# ---------------------------------------------------------------------------
# int8 serving
# ---------------------------------------------------------------------------
def test_int8_server_matches_int8_eval_step_and_calibrates(jax_model):
    """On the CPU: ``InferenceServer(int8=True)`` equals
    ``make_eval_step(int8=True)``; ``calibrate`` returns
    ``make_calibration_step``'s scales, switches to static and changes
    what ``predict`` returns, which then equals the static eval step."""
    from jmt_tpu_torch.ops import quant
    from jmt_tpu_torch.train import loops
    from jmt_tpu_torch.train.state import TrainState
    _, variables = jax_model
    model = load_jax_variables(JMTModel(**CFG), variables)
    state = TrainState(model=model, optimizer=None, trainable=[], frozen=[])
    server = InferenceServer(model, seq=S, buckets=(2,), img_size=PX,
                             device="cpu", int8=True)
    req = _request(2, seed=3)
    arrays = dict(zip(("clips", "audio", "wavlm"), req))
    dyn = server.predict(*req)
    want = loops.make_eval_step(model, device="cpu", int8=True)(state, arrays)
    for got, w in zip(dyn, want):
        np.testing.assert_array_equal(got, w.numpy())
    calib = loops.make_calibration_step(model, device="cpu")(state, arrays)
    scales = server.calibrate(*req)
    assert scales == quant.act_scales_from_maxes(calib)
    assert server.int8 == "static" and server.int8_scales == scales
    stat = server.predict(*req)
    assert not np.array_equal(stat[0], dyn[0])
    want = loops.make_eval_step(model, device="cpu", int8=True,
                                act_scales=scales)(state, arrays)
    for got, w in zip(stat, want):
        np.testing.assert_array_equal(got, w.numpy())
    with pytest.raises(ValueError, match="'static'"):
        InferenceServer(model, seq=S, buckets=(2,), img_size=PX,
                        device="cpu", int8="dynamic")


# ---------------------------------------------------------------------------
# StreamingSession
# ---------------------------------------------------------------------------
class FixedServer:
    """Hands out precomputed (V, A) batches in order."""

    def __init__(self, outs):
        self.outs = iter(outs)

    def predict(self, clips, audio, wavlm):
        return next(self.outs)


# two videos of 37 and 21 frames in ordered windows of S = 8, three
# windows a batch (the second batch spans both videos)
S_STREAM, VIDEOS = 8, (("A", 37), ("B", 21))


def _stream_batches(seed=11):
    rows = [(vid, length, w) for vid, length in VIDEOS
            for w in range(-(-length // S_STREAM))]
    rng = np.random.default_rng(seed)
    out = []
    for i in range(0, len(rows), 3):
        part = rows[i:i + 3]
        anchors = np.stack([np.arange(w * S_STREAM + 1, (w + 1) * S_STREAM
                                      + 1) for _, _, w in part])
        outs = tuple(rng.uniform(-1.5, 1.5, anchors.shape)
                     .astype(np.float32) for _ in range(2))
        out.append((anchors, [p[0] for p in part], [p[1] for p in part],
                    outs))
    return out


def test_streaming_session_matches_jax_and_the_stitcher(tmp_path):
    batches = _stream_batches()
    outs = [b[3] for b in batches]
    port = serve.StreamingSession(FixedServer(outs), v_smooth=3, a_smooth=5)
    jax_sess = jserve.StreamingSession(FixedServer(outs), v_smooth=3,
                                       a_smooth=5)
    stitcher = Stitcher(with_labels=False)
    for anchors, videos, lengths, (v, a) in batches:
        for sess in (port, jax_sess):
            sess.feed(None, None, None, anchors, videos, lengths)
        stitcher.add_batch(v, a, anchors, videos, lengths)
    got, want = port.finish_all(), jax_sess.finish_all()
    sv, sa = stitcher.smoothed(3, 5)
    assert sorted(got) == sorted(want) == ["A", "B"]
    for vid, length in VIDEOS:
        assert got[vid][0].shape == (length,)
        for i, smoothed in ((0, sv), (1, sa)):
            np.testing.assert_array_equal(got[vid][i], want[vid][i])
            np.testing.assert_array_equal(got[vid][i], smoothed[vid])
    files = port.write_challenge(str(tmp_path / "port"))
    jfiles = jax_sess.write_challenge(str(tmp_path / "jax"))
    assert [os.path.basename(f) for f in files] == \
        [os.path.basename(f) for f in jfiles] == ["A.txt", "B.txt"]
    for f, jf in zip(files, jfiles):
        assert open(f).read() == open(jf).read()


def test_streaming_session_refuses_unknown_and_incomplete_videos():
    batches = _stream_batches()[:1]   # video A's first three windows
    outs = [b[3] for b in batches]
    port = serve.StreamingSession(FixedServer(outs))
    jax_sess = jserve.StreamingSession(FixedServer(outs))
    anchors, videos, lengths, _ = batches[0]
    for sess in (port, jax_sess):
        sess.feed(None, None, None, anchors, videos, lengths)
    for vid, error in (("Z", KeyError), ("A", ValueError)):
        with pytest.raises(error) as got:
            port.finish_video(vid)
        with pytest.raises(error) as want:
            jax_sess.finish_video(vid)
        assert str(got.value) == str(want.value)
