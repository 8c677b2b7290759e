"""int8 inference on the CPU: the port's ``ops/quant.py`` and its plain
kernels against ``jmt_tpu.ops.quant``.

Inputs come from numpy seeds; weights move with ``models/convert.py``.

* The quantizers, bitwise for f32 and bf16 inputs, with exact ties
  (x / s = k + 0.5) that round-half-to-even decides.
* One int8 conv per shape family of the flagship (R(2+1)D's (1, 3, 3),
  (3, 1, 1) and strided 1 x 1 x 1, I3D's TF-SAME 3 x 3 x 3 and merged
  1 x 1, the stem fold's 7 x 5 x 5 and its (7, 5) corrections on Cin = 3,
  ResNet-18's strided 3 x 3 and 1 x 1, the TCN's dilated causal k = 5 and
  its 1 x 1) through the port's ``conv_nd`` and JAX's, dynamic and
  static: bitwise in f32.
* The R(2+1)D stem: the port's plain int8 conv against JAX's
  space-to-depth one, bitwise.
* The eligible convs of the flagship (stem fold included; i3d at 2 x the
  clip size), inception unfused: the port's count against JAX's from
  ``jax.eval_shape`` of ``make_calibration_step`` (no XLA compile).
* ``make_calibration_step`` and ``make_eval_step(int8=...)`` on the model
  of ``tests/test_quant.py:121-160`` (R2D1 + ResNet18, JMT SELF_ATTEN,
  f32, 48 px): maxes per index rtol 1e-5; each side's int8 V/A within
  ``FLAGSHIP_VA_ABS_BOUND`` of its own f32. Port against JAX: the
  activation scales of the dynamic forwards per index; the port run
  static on JAX's dynamic scales against JAX's dynamic V/A, and both
  static on JAX's calibrated scales, each off by under a quarter of the
  int8 drift (``_drift_share``: int8 against f32, RMS over V/A); planted
  faults (int8 off, scales shifted, rolled or swapped) exceed it. The
  dynamic V/A alone are only held within ``INT8_VA_TOL``: last-ulp
  differences of the f32 backbones move a few values across a
  quantization step, and dynamic scales amplify that.
* Static against dynamic: bitwise per conv on its calibration input (as
  JAX's test); through the whole model, bitwise given the scales the
  dynamic forward used (read by wrapping K6's dispatcher), while the
  calibrated scales give another forward, in JAX as in the port.
* The guards.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from jmt_tpu.models.jmt_model import JMTModel as JJMTModel
from jmt_tpu.models.video_resnet import Conv3d as JConv3d
from jmt_tpu.ops import conv as jconv
from jmt_tpu.ops import quant as jquant
from jmt_tpu.train import loops as jloops
from jmt_tpu.train.state import TrainState as JTrainState
from jmt_tpu.train.state import merge_params
from jmt_tpu_torch.models import convert
from jmt_tpu_torch.models.common import ConvNd, init_parameters
from jmt_tpu_torch.models.jmt_model import JMTModel
from jmt_tpu_torch.ops import quant
from jmt_tpu_torch.ops.conv import conv_nd
from jmt_tpu_torch.ops.kernels import int8_conv as k5
from jmt_tpu_torch.train import loops
from jmt_tpu_torch.train.state import TrainState
from test_torch_kernels import INT8_FAMILIES

torch.set_num_threads(2)

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _to_jax_layout(x: np.ndarray) -> np.ndarray:
    """(N, C, *spatial) -> (N, *spatial, C)."""
    return np.moveaxis(x, 1, -1)


def _w_to_jax(w: np.ndarray) -> np.ndarray:
    """(O, I, *k) -> (*k, I, O)."""
    return np.transpose(w, tuple(range(2, w.ndim)) + (1, 0))


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


# ---------------------------------------------------------------------------
# quantizers
# ---------------------------------------------------------------------------
def _tie_weights(rng) -> np.ndarray:
    """(6, 4, 3, 3) with channel 0 holding exact ties: max 127 makes
    s_w = 1, so 0.5, 1.5, -2.5 round to 0, 2, -2."""
    w = rng.normal(size=(6, 4, 3, 3)).astype(np.float32)
    w[0] = 0.0
    w[0, 0, 0, :] = (127.0, 0.5, 1.5)
    w[0, 1, 0, :] = (-2.5, 2.5, -0.5)
    return w


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_quantize_weight_per_channel_matches_jax(dtype):
    tdt, jdt = DTYPES[dtype]
    w = _tie_weights(np.random.default_rng(0))
    wt = torch.from_numpy(w).to(tdt)
    q, s = quant.quantize_weight_per_channel(wt)
    jq, js = jquant.quantize_weight_per_channel(
        jnp.asarray(_w_to_jax(w)).astype(jdt))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq).transpose(
        3, 2, 0, 1))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert q[0, 0, 0].tolist() == [127, 0, 2]
    assert q[0, 1, 0].tolist() == [-2, 2, 0]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_quantize_tensor_matches_jax(dtype):
    """Dynamic: ``quantize_tensor`` and K6's plain version against JAX's
    ``quantize_tensor``; static: K6's plain version against JAX's static
    quantize (``quant.py:156-157``). Ties: max |x| = 127 gives s = 1."""
    tdt, jdt = DTYPES[dtype]
    x = np.random.default_rng(1).normal(size=(2, 5, 3, 4, 4)).astype(
        np.float32) * 20
    x[0, 0, 0, 0, :4] = (127.0, 0.5, -1.5, 2.5)
    xt = torch.from_numpy(x).to(tdt)
    jx = jnp.asarray(x).astype(jdt)
    jq, js = jquant.quantize_tensor(jx)
    q, s = quant.quantize_tensor(xt)
    q2, s2 = k5.quantize_act_plain(xt)
    for got, scale in ((q, s), (q2, s2)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(jq))
        assert scale.item() == float(js) == 1.0
    assert q[0, 0, 0, 0, :4].tolist() == [127, 0, -2, 2]
    static = 0.3
    want = jnp.clip(jnp.round(jx.astype(jnp.float32) / static), -127, 127)
    q3, s3 = k5.quantize_act_plain(xt, static)
    assert s3 == static
    np.testing.assert_array_equal(q3.numpy(), np.asarray(want).astype(
        np.int8))


# ---------------------------------------------------------------------------
# one int8 conv per shape family
# ---------------------------------------------------------------------------
FAMILIES = INT8_FAMILIES


def _family_inputs(name, seed=0):
    xs, ws, stride, pads, dil = FAMILIES[name]
    rng = np.random.default_rng(seed)
    x = rng.normal(size=xs).astype(np.float32)
    x = np.maximum(x, 0) if name.startswith(("i3d", "r2p1d")) else x
    w = (rng.normal(size=ws) / np.sqrt(np.prod(ws[1:]))).astype(np.float32)
    return x, w, stride, pads, dil


def _jax_conv(x, w, stride, pads, dil, act_scales=None):
    nd = x.ndim - 2
    st = (stride,) * nd if isinstance(stride, int) else stride
    pd = ((0, 0),) * nd if pads is None else pads
    with jquant.int8_inference(act_scales=act_scales):
        y = jconv.conv_nd(jnp.asarray(_to_jax_layout(x)),
                          jnp.asarray(_w_to_jax(w)), st, pd,
                          dilation=(dil,) * nd)
    return np.moveaxis(np.asarray(y), -1, 1)


def _port_conv(x, w, stride, pads, dil, act_scales=None):
    with torch.inference_mode(), quant.int8_inference(act_scales=act_scales):
        return conv_nd(torch.from_numpy(x), torch.from_numpy(w), stride,
                       pads, dil)


@pytest.mark.parametrize("mode", ["dynamic", "static"])
@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_int8_conv_matches_jax(name, mode):
    x, w, stride, pads, dil = _family_inputs(name)
    # static: a scale 10% under the range, so that the top values clip
    scales = None if mode == "dynamic" else [
        0.9 * float(np.abs(x).max()) / 127.0]
    want = _jax_conv(x, w, stride, pads, dil, scales)
    got = _port_conv(x, w, stride, pads, dil, scales)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_int8_conv_plain_accumulates_exactly():
    """The s32 sums past 2^24 (where f32 is no longer exact) are exact."""
    x_q = torch.full((1, 512, 3, 3, 3), 127, dtype=torch.int8)
    w_q = torch.full((2, 512, 3, 3, 3), -127, dtype=torch.int8)
    w_q[1, 0, 0, 0, 0] = -126
    acc = k5.int8_acc_plain(x_q, w_q, 1, 1, None)
    full = -127 * 127 * 512 * 27
    assert acc.flatten().tolist() == [full, full + 127]
    assert abs(full) > 2 ** 24


def test_r2p1d_stem_matches_jax_space_to_depth():
    """JAX runs the R(2+1)D stem through ``conv3d_s2d_hw``: the same
    integers as the port's plain conv, so the outputs are bitwise equal."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 3, 2, 16, 16)).astype(np.float32)
    jm = JConv3d(45, (1, 7, 7), (1, 2, 2), (0, 3, 3), s2d_hw=True)
    jx = jnp.asarray(_to_jax_layout(x))
    params = jm.init(jax.random.PRNGKey(0), jx)
    port = ConvNd(3, 45, (1, 7, 7), (1, 2, 2), (0, 3, 3))
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(np.transpose(
            np.array(params["params"]["kernel"]), (4, 3, 0, 1, 2))))
    for scales in (None, [0.02]):
        with jquant.int8_inference(act_scales=scales):
            want = np.moveaxis(np.asarray(jm.apply(params, jx)), -1, 1)
        with torch.inference_mode(), quant.int8_inference(
                act_scales=scales):
            got = port(torch.from_numpy(x))
        np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------
FLAGSHIP = dict(vision_backbones=("R2D1", "I3D"),
                audio_backbones=("ResNet18", "wavLM"),
                intra_modal_fusion="encoder_plus_self_attention")


def _arrays(b, s, px, seed=0, wavlm=True):
    rng = np.random.default_rng(seed)
    out = {"clips": rng.integers(0, 256, (b, s, 8, px, px, 3),
                                 dtype=np.uint8),
           "audio": (0.1 * rng.normal(size=(b, s, 45599))).astype(
               np.float32)}
    if wavlm:
        out["wavlm"] = rng.normal(size=(b, s, 768)).astype(np.float32)
    return out


def test_flagship_eligible_conv_count_matches_jax():
    """Inception unfused, the I3D stem folded (input size 2 x the clip's):
    JAX's calibration step traced abstractly, the port's run at 32 px;
    STATUS.md records 110 scales for the flagship."""
    arrays = _arrays(1, 1, 32)
    jm = JJMTModel(**FLAGSHIP, i3d_input_size=64)
    spec, clips = jloops._preprocess(jm, arrays, None, augment=False)
    variables = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), spec, clips, arrays["wavlm"]))
    jstate = JTrainState(trainable=variables["params"], frozen={},
                         batch_stats=variables["batch_stats"],
                         opt_state=None)
    want = jax.eval_shape(jloops.make_calibration_step(jm), jstate, arrays)
    model = init_parameters(JMTModel(**FLAGSHIP, i3d_input_size=64),
                            torch.Generator().manual_seed(0))
    state = TrainState(model=model, optimizer=None, trainable=[], frozen=[])
    maxes = loops.make_calibration_step(model, device="cpu")(state, arrays)
    assert want.shape == tuple(maxes.shape) == (110,)
    assert bool((maxes > 0).all())


# the model of tests/test_quant.py:121-160 at B=2, S=4, 48 px
LIGHT = dict(vision_backbones=("R2D1",), audio_backbones=("ResNet18",),
             joint_modalities="TRANSFORMER", output_format="SELF_ATTEN",
             num_heads=1, num_layers=1)
B, S, PX = 2, 4, 48
# port int8 V/A against JAX int8 V/A (f32 models, the same weights; the
# f32 paths are 5.6e-8 apart). Each conv is bitwise equal given equal
# inputs (test_int8_conv_matches_jax), but the backbones' f32 roundings
# differ in the last ulp, and that moves a few activations across a
# quantization step; dynamic scales amplify it, since a flipped element
# that sets a later tensor's max changes that tensor's whole scale by up
# to 1/127. Measured: dynamic 8.7e-4, static with the same (JAX's)
# scales 2.3e-4, against an int8 drift from f32 of 1.1e-3 (dynamic). These
# absolute limits cannot tell a port without int8 from one with it; the
# drift shares below can.
INT8_VA_TOL = {"dynamic": 2e-3, "static": 1e-3}
# the largest share of the int8 drift that port-vs-JAX may reach
# (_drift_share). Measured: 0.055 static on JAX's dynamic scales against
# JAX's dynamic forward, 0.174 both static on JAX's calibrated scales.
# The planted faults against JAX's dynamic forward: int8 off 1.0, scales
# shifted by one conv 7.1, rolled by one 0.88, two neighbours swapped 0.73
DRIFT_SHARE = 0.25
# the port's dynamic activation scales against JAX's, per conv: ulp-level
# (2e-7) through the first convs, then growing along the chain as the f32
# differences above flip quanta (measured max 2.2e-2, the last convs)
DYN_SCALE_RTOL = 5e-2


def _drift_share(got, want, base) -> float:
    """RMS(got - want) / RMS(want - base): port-vs-JAX int8 as a share of
    JAX's int8 drift from its f32 (``base``)."""
    return float(np.sqrt(np.mean((got - want) ** 2)
                         / np.mean((want - base) ** 2)))


def _jax_dynamic(jm, jstate, arrays):
    """JAX's int8 eval forward (``make_eval_step(int8=True)``'s body) and
    the activation scale each conv used, read by wrapping
    ``quantize_tensor`` while jit traces."""
    @jax.jit
    def step(state, arrays):
        used, original = [], jquant.quantize_tensor

        def spy(x):
            q, s_x = original(x)
            used.append(s_x)
            return q, s_x

        jquant.quantize_tensor = spy
        try:
            with jquant.int8_inference(True):
                spec, clips = jloops._preprocess(jm, arrays, None,
                                                 augment=False)
                params = merge_params(state.trainable, state.frozen)
                out = jm.apply({"params": params,
                                "batch_stats": state.batch_stats},
                               spec, clips, arrays.get("wavlm"),
                               train=False)
        finally:
            jquant.quantize_tensor = original
        return out, jnp.stack(used)

    out, used = step(jstate, arrays)
    return np.stack([np.asarray(t) for t in out]), np.asarray(used)


def _perturbed(arrays):
    """JAX test's second batch: clips rolled 3 rows, audio x 1.2."""
    out = dict(arrays)
    out["clips"] = np.roll(arrays["clips"], 3, axis=3)
    out["audio"] = arrays["audio"] * 1.2
    return out


@pytest.fixture(scope="module")
def light_run():
    """JAX's calibration maxes and eval V/A (f32, int8 dynamic, int8
    static on the perturbed batch), the scales of its dynamic forward, and
    the port model with the same weights."""
    arrays = _arrays(B, S, PX, wavlm=False)
    jm = JJMTModel(**LIGHT)
    spec, clips = jloops._preprocess(jm, arrays, None, augment=False)
    variables = jax.jit(jm.init)(jax.random.PRNGKey(0), spec, clips, None)
    jstate = JTrainState(trainable=variables["params"], frozen={},
                         batch_stats=variables["batch_stats"],
                         opt_state=None)
    maxes = np.asarray(jloops.make_calibration_step(jm)(jstate, arrays))
    scales = jquant.act_scales_from_maxes(maxes)
    arrays2 = _perturbed(arrays)
    out = {"arrays": arrays, "arrays2": arrays2, "maxes": maxes,
           "scales": scales}
    out["int8_"], out["int8_scales"] = _jax_dynamic(jm, jstate, arrays)
    for name, step, arr in (
            ("f32", jloops.make_eval_step(jm), arrays),
            ("int8", jloops.make_eval_step(jm, int8=True), arrays),
            ("static", jloops.make_eval_step(jm, int8=True,
                                             act_scales=scales), arrays),
            ("f32_2", jloops.make_eval_step(jm), arrays2),
            ("static_2", jloops.make_eval_step(jm, int8=True,
                                               act_scales=scales), arrays2)):
        out[name] = np.stack([np.asarray(t) for t in step(jstate, arr)])
    model = convert.load_jax_variables(
        JMTModel(**LIGHT), jax.tree.map(np.asarray, variables))
    out["state"] = TrainState(model=model, optimizer=None, trainable=[],
                              frozen=[])
    return out


def _eval(run, arrays, **kw):
    step = loops.make_eval_step(run["state"].model, device="cpu", **kw)
    return torch.stack(step(run["state"], arrays)).numpy()


def _dynamic_with_scales(run, arrays):
    """The port's int8 eval V/A and the activation scale each conv used,
    read by wrapping K6's dispatcher."""
    used, original = [], k5.quantize_act

    def spy(x, scale=None):
        q, s_x = original(x, scale)
        used.append(s_x)
        return q, s_x

    k5.quantize_act = spy
    try:
        out = _eval(run, arrays, int8=True)
    finally:
        k5.quantize_act = original
    return out, [float(s) for s in used]


def test_calibration_maxes_match_jax(light_run):
    run = light_run
    calib = loops.make_calibration_step(run["state"].model, device="cpu")
    maxes = calib(run["state"], run["arrays"])
    assert maxes.dtype == torch.float32 and maxes.device.type == "cpu"
    assert maxes.shape == run["maxes"].shape and run["maxes"].size > 30
    np.testing.assert_allclose(maxes.numpy(), run["maxes"], rtol=1e-5,
                               atol=0)
    scales = quant.act_scales_from_maxes(maxes)
    np.testing.assert_allclose(scales, run["scales"], rtol=1e-5, atol=0)


def test_int8_eval_step_matches_jax(light_run):
    """Each side's int8 stays within the flagship bound of its own f32 (as
    ``tests/test_quant.py`` holds JAX's), dynamic on the calibration
    batch and static (JAX's scales on both sides) on the perturbed one.
    Port against JAX: the dynamic forwards' scales per conv; static on
    JAX's dynamic scales against JAX's dynamic V/A, and static on JAX's
    calibrated scales, each under DRIFT_SHARE of the int8 drift; the V/A
    within INT8_VA_TOL."""
    run = light_run
    bound = quant.FLAGSHIP_VA_ABS_BOUND
    f32 = _eval(run, run["arrays"])
    int8, used = _dynamic_with_scales(run, run["arrays"])
    f32_2 = _eval(run, run["arrays2"])
    static_2 = _eval(run, run["arrays2"], int8=True,
                     act_scales=run["scales"])
    for a, b in ((int8, f32), (static_2, f32_2),
                 (run["int8"], run["f32"]), (run["static_2"], run["f32_2"])):
        assert np.abs(a - b).max() < bound
    assert np.abs(int8 - f32).max() > 0  # the int8 path ran
    np.testing.assert_array_equal(run["int8_"], run["int8"])
    assert len(used) == run["int8_scales"].size == run["maxes"].size
    np.testing.assert_allclose(used, run["int8_scales"], rtol=DYN_SCALE_RTOL,
                               atol=0)
    on_jax_scales = _eval(run, run["arrays"], int8=True,
                          act_scales=run["int8_scales"].tolist())
    assert _drift_share(on_jax_scales, run["int8"], run["f32"]) < DRIFT_SHARE
    assert _drift_share(static_2, run["static_2"], run["f32_2"]) < DRIFT_SHARE
    np.testing.assert_allclose(f32, run["f32"], rtol=0, atol=2e-5)
    np.testing.assert_allclose(int8, run["int8"], rtol=0,
                               atol=INT8_VA_TOL["dynamic"])
    np.testing.assert_allclose(static_2, run["static_2"], rtol=0,
                               atol=INT8_VA_TOL["static"])


def _planted(run, fault: str):
    """A port at fault, run on the calibration batch against JAX's dynamic
    forward: int8 off, or JAX's dynamic scales shifted by one conv,
    rolled by one, or with two neighbours swapped."""
    sc = run["int8_scales"].tolist()
    if fault == "int8_off":
        return _eval(run, run["arrays"])
    planted = {"shifted": sc[:1] + sc[:-1], "rolled": sc[1:] + sc[:1],
               "swapped": sc[:3] + [sc[4], sc[3]] + sc[5:]}[fault]
    return _eval(run, run["arrays"], int8=True, act_scales=planted)


@pytest.mark.parametrize("fault", ["int8_off", "shifted", "rolled",
                                   "swapped"])
def test_drift_share_catches_a_planted_fault(light_run, fault):
    """The whole-model comparison of test_int8_eval_step_matches_jax fails
    a port whose int8 is off or whose scales land on the wrong convs."""
    run = light_run
    share = _drift_share(_planted(run, fault), run["int8"], run["f32"])
    assert share > DRIFT_SHARE, share


def test_static_equals_dynamic_given_its_scales(light_run):
    """Whole model: the scales a dynamic forward used, given back as
    static scales, reproduce it bit for bit; the first equals the
    calibration's (the first conv sees the same input either way)."""
    run = light_run
    dyn, scales = _dynamic_with_scales(run, run["arrays"])
    calibrated = quant.act_scales_from_maxes(loops.make_calibration_step(
        run["state"].model, device="cpu")(run["state"], run["arrays"]))
    assert len(scales) == len(calibrated) == run["maxes"].size
    assert scales[0] == np.float32(calibrated[0])
    assert scales != [float(np.float32(v)) for v in calibrated]
    stat = _eval(run, run["arrays"], int8=True, act_scales=scales)
    np.testing.assert_array_equal(stat, dyn)


def test_calibrated_static_is_not_dynamic_through_the_model(light_run):
    """Through a whole model the calibrated static forward is not the
    dynamic one on the calibration batch, in JAX as in the port:
    calibration runs the float forward, so from the second conv on its
    maxes are not those the int8 forward meets. (Measured: JAX 6.6e-4,
    the port 8.2e-4 on V/A.)"""
    run = light_run
    scales = quant.act_scales_from_maxes(loops.make_calibration_step(
        run["state"].model, device="cpu")(run["state"], run["arrays"]))
    port = (_eval(run, run["arrays"], int8=True, act_scales=scales)
            - _eval(run, run["arrays"], int8=True))
    jax_ = run["static"] - run["int8"]
    for delta in (port, jax_):
        assert 0 < np.abs(delta).max() < quant.FLAGSHIP_VA_ABS_BOUND


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_static_equals_dynamic_per_conv_on_its_calibration_input(dtype):
    """JAX's property (``tests/test_quant.py``): one conv calibrated on x,
    then static on x, equals dynamic on x, bitwise."""
    x, w, stride, pads, dil = _family_inputs("i3d_3x3x3_same", seed=4)
    tdt = DTYPES[dtype][0]
    xt, wt = torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt)
    coll: list = []
    with torch.inference_mode(), quant.int8_calibration(coll):
        plain = conv_nd(xt, wt, stride, pads, dil)
    assert torch.equal(plain, conv_nd(xt, wt, stride, pads, dil))
    scales = quant.act_scales_from_maxes(quant.stack_maxes(coll))
    with torch.inference_mode(), quant.int8_inference():
        dyn = conv_nd(xt, wt, stride, pads, dil)
    with torch.inference_mode(), quant.int8_inference(act_scales=scales):
        stat = conv_nd(xt, wt, stride, pads, dil)
    assert stat.dtype == tdt
    np.testing.assert_array_equal(_bits(stat), _bits(dyn))


# ---------------------------------------------------------------------------
# guards
# ---------------------------------------------------------------------------
def _conv_twice(act_scales):
    x, w, stride, pads, dil = _family_inputs("i3d_merged_1x1")
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    with torch.inference_mode(), quant.int8_inference(act_scales=act_scales):
        for _ in range(2):
            conv_nd(xt, wt, stride, pads, dil)


def test_too_few_scales_raise():
    with pytest.raises(RuntimeError, match="exhausted.*calibrate with the "
                                           "same model/config"):
        _conv_twice([0.1])


def test_surplus_scales_raise():
    _conv_twice([0.1, 0.1])
    with pytest.raises(RuntimeError, match="left over.*calibrate with the "
                                           "same model/config"):
        _conv_twice([0.1, 0.1, 0.1])


def test_static_server_without_scales_raises():
    from jmt_tpu_torch.serve import InferenceServer
    with pytest.raises(ValueError, match="int8_scales"):
        InferenceServer(JMTModel(**LIGHT), int8="static", device="cpu")


def test_empty_collector_gives_zeros():
    maxes = quant.stack_maxes([])
    assert maxes.shape == (0,) and maxes.dtype == torch.float32
    assert quant.act_scales_from_maxes(maxes) == []


def test_ineligible_stems_and_wavlm_stay_in_their_dtype():
    """The ResNet-18 audio stem (49 taps), the stem fold's corners (21) and
    WavLM's convs (direct ``F.conv1d``) record nothing and compute as
    without a context; the R(2+1)D stem (147) is eligible."""
    from jmt_tpu_torch.models import wavlm
    gen = torch.Generator().manual_seed(0)
    stem = init_parameters(ConvNd(1, 64, (7, 7), 2, 3), gen)
    corner = torch.randn(16, 3, 7, generator=gen)
    # conv 2 (32 x 3) and the positional conv (8 x 16 a group) would be
    # eligible if they went through conv_nd
    cfg = wavlm.WavLMConfig(
        hidden_size=32, num_hidden_layers=1, num_attention_heads=4,
        intermediate_size=48, conv_dim=(32, 32), conv_stride=(5, 2),
        conv_kernel=(10, 3), num_conv_pos_embeddings=16,
        num_conv_pos_embedding_groups=4, num_buckets=14,
        max_bucket_distance=50)
    wm = wavlm.init_parameters(wavlm.WavLMModel(cfg), gen).eval()
    cases = ((stem, torch.randn(2, 1, 20, 16, generator=gen)),
             (lambda x: conv_nd(x, corner), torch.randn(2, 3, 9,
                                                         generator=gen)),
             (wm, torch.randn(2, 400, generator=gen)))
    for fn, x in cases:
        with torch.inference_mode():
            want = fn(x)
            coll: list = []
            with quant.int8_calibration(coll):
                cal = fn(x)
            with quant.int8_inference():
                got = fn(x)
        assert coll == [] and torch.equal(cal, want)
        assert torch.equal(got, want)
    assert quant.eligible((45, 3, 1, 7, 7)) and not quant.eligible(
        (64, 1, 7, 7)) and not quant.eligible((64, 3, 7))


def test_a_nan_activation_stays_nan_as_in_jax():
    """Dynamic int8 of an x holding one NaN: the scale is NaN on both
    sides (max |x| propagates it), and so is the whole conv output."""
    x, w, stride, pads, dil = _family_inputs("i3d_3x3x3_same")
    x = x.copy()
    x[1, 3, 2, 4, 5] = np.nan
    _, s = quant.quantize_tensor(torch.from_numpy(x))
    _, js = jquant.quantize_tensor(jnp.asarray(x))
    assert torch.isnan(s) and bool(jnp.isnan(js))
    with torch.inference_mode(), quant.int8_inference():
        got = conv_nd(torch.from_numpy(x), torch.from_numpy(w), stride,
                      pads, dil)
    assert torch.isnan(got).all()
    assert np.isnan(np.asarray(_jax_conv(x, w, stride, pads, dil))).all()


def test_int8_under_autograd_raises():
    x, w, stride, pads, dil = _family_inputs("i3d_merged_1x1")
    wt = torch.from_numpy(w).requires_grad_()
    with quant.int8_inference():
        with pytest.raises(RuntimeError, match="no backward"):
            conv_nd(torch.from_numpy(x), wt, stride, pads, dil)
        with torch.no_grad():
            conv_nd(torch.from_numpy(x), wt, stride, pads, dil)


# ---------------------------------------------------------------------------
# prepared weights and padded channels
# ---------------------------------------------------------------------------
def _light_forward(run, mode, weights=None):
    """The light model's eval forward on the calibration batch, int8
    dynamic or static (JAX's calibrated scales), its weights prepared per
    call or taken from ``weights``."""
    arrays = {k: torch.from_numpy(v) for k, v in run["arrays"].items()}
    scales = run["scales"] if mode == "static" else None
    out = loops.eval_forward(run["state"].model, arrays,
                             "static" if mode == "static" else True, scales,
                             weights)
    return torch.stack(out).numpy()


@pytest.mark.parametrize("mode", ["dynamic", "static"])
def test_prepared_weights_give_the_per_call_bits(light_run, mode):
    """The list of prepared weights made by one eager int8 forward gives
    bitwise the V/A of quantizing each weight per call, and the forward
    that consumes it prepares none."""
    run = light_run
    want = _light_forward(run, mode)
    weights = quant.collect_int8_weights(lambda: _light_forward(run, mode))
    assert len(weights) == run["maxes"].size
    assert all(isinstance(w, k5.Int8Weight) for w in weights)
    before = k5.prepare_weight.calls
    got = _light_forward(run, mode, weights)
    assert k5.prepare_weight.calls == before
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("fault", ["exhausted", "left_over", "misplaced"])
def test_prepared_weights_raise_when_they_do_not_fit(light_run, fault):
    """Too few prepared weights raise when they run out, too many when the
    forward leaves, and a list in the wrong order at the first conv whose
    weight shape differs; each names the remedy."""
    run = light_run
    weights = quant.collect_int8_weights(
        lambda: _light_forward(run, "dynamic"))
    bad = {"exhausted": weights[:-1], "left_over": weights + weights[:1],
           "misplaced": weights[::-1]}[fault]
    match = {"exhausted": "exhausted", "left_over": "left over",
             "misplaced": "prepared weight 0"}[fault]
    with pytest.raises(RuntimeError, match=match + ".*calibrate with the "
                                               "same model/config"):
        _light_forward(run, "dynamic", bad)


def _inline_relayout(w_q: torch.Tensor, cpt: int) -> torch.Tensor:
    """The first design's per-launch re-layout (``F.pad(w.permute(0, 2, 3,
    4, 1).reshape(co, k), (0, kp - k))``, kp a multiple of 32), on w with
    its channels zero-padded to ``cpt``; Kp here a multiple of 16."""
    w3 = w_q.reshape(w_q.shape[:2] + (1,) * (5 - w_q.ndim) + w_q.shape[2:])
    w3 = torch.nn.functional.pad(w3, (0, 0, 0, 0, 0, 0, 0, cpt - w3.shape[1]))
    co = w3.shape[0]
    k = int(np.prod(w3.shape[1:]))
    kp = -(-k // 32) * 32
    old = torch.nn.functional.pad(w3.permute(0, 2, 3, 4, 1).reshape(co, k),
                                  (0, kp - k))
    return old[:, :-(-k // 16) * 16]


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_relayout_matches_the_inline_formula(name):
    """K5's B (``relayout``) is the old per-launch formula on the weight
    with its channels padded to ``channel_pitch``; where Cin is a multiple
    of 16 that is the old formula itself."""
    _, ws, *_ = FAMILIES[name]
    gen = torch.Generator().manual_seed(5)
    w_q = torch.randint(-127, 128, ws, generator=gen, dtype=torch.int8)
    cpt = k5.channel_pitch(ws[1])
    got = k5.relayout(w_q)
    assert got.dtype == torch.int8 and got.is_contiguous()
    assert got.shape[1] % 16 == 0 and got.shape[1] >= cpt * np.prod(ws[2:])
    assert torch.equal(got, _inline_relayout(w_q, cpt))
    if ws[1] % 16 == 0:
        assert cpt == ws[1]


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_padded_channels_keep_the_sums(name):
    """x and w with their channels padded by zeros to ``channel_pitch`` (as
    K6 writes x and ``relayout`` lays out w) give the plain version's s32
    sums of the unpadded operands; the K6-layout view (``as_rows``) is the
    unpadded x."""
    xs, ws, stride, pads, dil = FAMILIES[name]
    gen = torch.Generator().manual_seed(6)
    x_q = torch.randint(-127, 128, xs, generator=gen, dtype=torch.int8)
    w_q = torch.randint(-127, 128, ws, generator=gen, dtype=torch.int8)
    pad = k5.channel_pitch(xs[1]) - xs[1]
    assert 0 <= pad < 16 and (pad == 0) == (xs[1] % 16 == 0)
    zeros = (0, 0) * (len(xs) - 2)
    xp = torch.nn.functional.pad(x_q, zeros + (0, pad))
    wp = torch.nn.functional.pad(w_q, zeros + (0, pad))
    want = k5.int8_acc_plain(x_q, w_q, stride, dil, pads)
    assert torch.equal(k5.int8_acc_plain(xp, wp, stride, dil, pads), want)
    rows = k5.as_rows(x_q)
    assert torch.equal(rows, x_q)
    assert torch.equal(k5.int8_acc_plain(rows, w_q, stride, dil, pads), want)


@pytest.mark.parametrize("c,pitch", [(3, 16), (8, 16), (15, 16), (16, 16),
                                     (21, 32), (24, 32), (45, 48),
                                     (230, 240), (460, 464), (921, 928),
                                     (1152, 1152)])
def test_channel_pitch(c, pitch):
    assert k5.channel_pitch(c) == pitch


@pytest.mark.parametrize("stale", [False, True])
def test_int8_server_prepares_its_weights_and_refuses_stale_ones(light_run,
                                                                 stale):
    """On the CPU: an int8 server prepares each eligible weight once, at
    construction, and serves bitwise what quantizing per call gives; an
    in-place change of a parameter after that makes ``predict`` raise
    instead of serving the stale int8 weights."""
    from jmt_tpu_torch.serve import InferenceServer
    run = light_run
    model = run["state"].model
    server = InferenceServer(model, seq=S, buckets=(B,), img_size=PX,
                             device="cpu", int8=True, use_wavlm=False)
    assert len(server.int8_weights) == run["maxes"].size
    req = (run["arrays"]["clips"], run["arrays"]["audio"])
    before = k5.prepare_weight.calls
    got = np.stack(server.predict(*req))
    assert k5.prepare_weight.calls == before
    np.testing.assert_array_equal(got, _light_forward(run, "dynamic"))
    if stale:
        saved = next(model.parameters()).detach().clone()
        with torch.no_grad():
            next(model.parameters()).mul_(1.0)
        try:
            with pytest.raises(RuntimeError, match="changed in place"):
                server.predict(*req)
        finally:
            with torch.no_grad():
                next(model.parameters()).copy_(saved)


@pytest.mark.parametrize("name", [n for n in sorted(FAMILIES)
                                  if k5.unfolds(FAMILIES[n][1])])
def test_stem_unfold_keeps_the_sums(name):
    """A stem's x with the last kernel axis's taps unfolded into channels
    (``unfold_plain``, what K6 writes for K5 on the card) and its weight
    unfolded the same way (``unfold_weight``) give the plain version's
    sums under the unfolded geometry; K6's plain version unfolds the
    same q."""
    xs, ws, stride, pads, dil = FAMILIES[name]
    gen = torch.Generator().manual_seed(7)
    x_q = torch.randint(-127, 128, xs, generator=gen, dtype=torch.int8)
    w_q = torch.randint(-127, 128, ws, generator=gen, dtype=torch.int8)
    u = k5.unfold_geometry(ws, xs, stride, dil, pads)
    assert u is not None and u.k == ws[-1]
    want = k5.int8_acc_plain(x_q, w_q, stride, dil, pads)
    got = k5.int8_acc_plain(k5.unfold_plain(x_q, u), k5.unfold_weight(w_q),
                            u.stride, u.dilation, u.pads)
    assert torch.equal(got, want)
    x = torch.randn(xs, generator=gen)
    q, s = k5.quantize_act_plain(x, None)
    qu, su = k5.quantize_act_plain(x, None, u)
    assert torch.equal(su, s) and torch.equal(qu, k5.unfold_plain(q, u))
    w = k5.prepare_weight(w_q, torch.ones(ws[0]), unfold=True)
    assert w.unfold and w.shape == ws
    assert torch.equal(w.w_q, k5.unfold_weight(w_q))
