"""The plain reference against the port's CPU path, at a tiny size, on
the same seeded weights (the benchmark's own generator)."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from bench_h100.lib import inputs, weights
from bench_h100.reference import jmt
from bench_h100.reference import train as ref_train
from bench_h100.tests import tiny

INP = {"seq": 2, "frames": 8, "size": 32, "audio_samples": 45599,
       "wavlm_dim": 768}
SEED = 2 ** 31 + 11


def _port_model(cfg, dtype=None, device="cpu"):
    from jmt_tpu_torch.models.jmt_model import JMTModel
    kw = {k: tuple(v) if isinstance(v, list) else v for k, v in cfg.items()}
    with torch.device(device):
        return JMTModel(**kw, dtype=dtype)


@pytest.fixture(scope="module")
def port():
    cfg = tiny.model()
    model = _port_model(cfg)
    w = weights.make(jmt.layout(cfg), SEED, "cpu")
    weights.load_into(model, w)
    return cfg, model.eval(), w


@pytest.fixture(scope="module")
def request_():
    return inputs.windows(1, INP, SEED, 1, "cpu")


def test_layout_names_every_tensor_of_the_port():
    cfg = tiny.model(i3d_input_size=224)
    model = _port_model(cfg, device="meta")
    own = dict(model.named_parameters())
    own.update(model.named_buffers())
    own = {n: tuple(t.shape) for n, t in own.items()
           if not n.endswith("num_batches_tracked")}
    assert own == {n: s for n, s, _ in jmt.layout(cfg)}


def test_weights_repeat_from_the_seed_and_differ_across_seeds():
    lay = jmt.layout(tiny.model())
    a, b = weights.make(lay, SEED, "cpu"), weights.make(lay, SEED, "cpu")
    c = weights.make(lay, SEED + 1, "cpu")
    assert all(torch.equal(a[n], b[n]) for n in a)
    assert not torch.equal(a[lay[0][0]], c[lay[0][0]])
    assert all((a[n] > 0).all() for n, _, k in lay if k == "var")


@pytest.mark.parametrize("fold", [False, True])
def test_forward_matches_the_ports_cpu_path(port, request_, fold):
    from jmt_tpu_torch.serve import InferenceServer
    cfg, model, w = port
    server = InferenceServer(model, seq=2, buckets=(1,), img_size=32,
                             device="cpu")
    h = inputs.to_host(request_)
    v, a = server.predict(h["clips"], h["audio"], h["wavlm"])
    with torch.no_grad():
        rv, ra = jmt.forward(jmt.Ops(), w, cfg, request_["clips"],
                             request_["audio"], request_["wavlm"], fold=fold)
    assert np.abs(rv.numpy() - v).max() < 1e-5
    assert np.abs(ra.numpy() - a).max() < 1e-5


def test_train_steps_match_the_ports_cpu_path():
    from jmt_tpu_torch.core.config import Config, ModelParams, OptimParams
    from jmt_tpu_torch.train import loops
    cfg = tiny.model()
    model = _port_model(cfg)
    w = weights.make(jmt.layout(cfg), SEED, "cpu")
    weights.load_into(model, w)
    opt = {"lr": 0.01, "momentum": 0.9, "dampening": 0.0,
           "weight_decay": 1e-4, "nesterov": True}
    state = loops.init_state(model, Config(model_params=ModelParams(
        l_vision_backbones=cfg["vision_backbones"],
        l_audio_backbones=cfg["audio_backbones"],
        intra_modal_fusion=cfg["intra_modal_fusion"],
        opt=OptimParams(**opt))), None, device="cpu")
    step = loops.make_train_step(model, device="cpu")
    batches = [dict(inputs.windows(2, INP, SEED, 10 + i, "cpu"),
                    **inputs.train_extras(2, 2, SEED, 30 + i, "cpu"))
               for i in range(2)]
    losses = [float(step(state, {k: b[k] for k in (
        "clips", "audio", "wavlm", "labels_v", "labels_a", "row_weight")},
        color_factors=(b["brightness"], b["contrast"]))[0])
        for b in batches]
    ref = ref_train.follow(jmt.Ops(), w, cfg, opt, batches)
    assert np.allclose(losses, ref["losses"], atol=1e-5)
    params = dict(model.named_parameters())
    for n, p in ref["params"].items():
        moved = (p - w[n]).norm()
        assert (params[n].detach() - p).norm() <= 1e-3 * moved + 1e-7, n


@pytest.mark.parametrize("shapes", [
    ((2, 3, 8, 32, 32), (45, 3, 1, 7, 7), (1, 2, 2), ((0, 0), (3, 3), (3, 3))),
    ((2, 45, 8, 16, 16), (64, 45, 3, 1, 1), (1, 1, 1), ((1, 1), (0, 0), (0, 0))),
    ((2, 64, 8, 16, 16), (144, 64, 1, 3, 3), (1, 2, 2), ((0, 0), (1, 1), (1, 1))),
    ((2, 512, 7), (512, 512, 5), 1, ((4, 0),)),
])
def test_int8_conv_is_the_ports_bit_for_bit(shapes):
    from jmt_tpu_torch.ops import quant
    from jmt_tpu_torch.ops.conv import conv_nd
    xs, ws, stride, pads = shapes
    g = torch.Generator().manual_seed(3)
    x, w = torch.randn(xs, generator=g), 0.1 * torch.randn(ws, generator=g)
    s = float(x.abs().max()) / 127
    with torch.inference_mode(), quant.int8_inference(True, act_scales=[s]):
        want = conv_nd(x, w, stride, pads)
    got = jmt.QuantOps(127, [s]).conv(x, w, stride, pads)
    assert torch.equal(got, want)


def test_static_int8_calibration_and_forward_follow_the_port(port, request_):
    from jmt_tpu_torch.serve import InferenceServer, calibration_scales
    cfg, model, w = port
    cal = inputs.windows(1, INP, SEED, 2, "cpu")
    h = inputs.to_host(cal)
    scales = calibration_scales(model, h["clips"], h["audio"], h["wavlm"],
                                device="cpu")
    ops = jmt.QuantOps(127)
    with torch.no_grad():
        jmt.forward(ops, w, cfg, cal["clips"], cal["audio"], cal["wavlm"],
                    fold=True)
    mine = ops.scales_from_maxes()
    assert len(mine) == len(scales) == 74
    assert np.allclose(mine, scales, rtol=1e-5)
    server = InferenceServer(model, seq=2, buckets=(1,), img_size=32,
                             device="cpu", int8="static", int8_scales=scales)
    r = inputs.to_host(request_)
    v, a = server.predict(r["clips"], r["audio"], r["wavlm"])
    with torch.no_grad():
        out = {lv: jmt.forward(jmt.QuantOps(lv, jmt_scales), w, cfg,
                               request_["clips"], request_["audio"],
                               request_["wavlm"], fold=True)
               for lv, jmt_scales in ((127, mine),
                                      (7, [s * 127 / 7 for s in mine]))}
    gap = max(np.abs(out[127][0].numpy() - v).max(),
              np.abs(out[127][1].numpy() - a).max())
    int4 = max(float((out[7][0] - out[127][0]).abs().max()),
               float((out[7][1] - out[127][1]).abs().max()))
    # int8 rounding flips make the two int8 paths drift apart, by far less
    # than a lower precision moves
    assert gap < 0.25 * int4


def test_bf16_ops_round_operands_and_outputs():
    g = torch.Generator().manual_seed(3)
    x, w, b = (torch.randn(*s, generator=g) for s in ((4, 16), (8, 16), (8,)))

    def r(t):
        return t.to(torch.bfloat16).float()

    y = jmt.Bf16Ops().linear(x, w, b)
    assert torch.equal(y, r(torch.nn.functional.linear(r(x), r(w), r(b))))
    assert not torch.equal(y, torch.nn.functional.linear(x, w, b))
    z = jmt.Fp8Ops().act(x)
    s = x.abs().amax() / 448.0
    assert torch.equal(z, (x / s).to(torch.float8_e4m3fn).float() * s)


@pytest.mark.parametrize("dtype,int8,want,control", [
    ("bfloat16", False, jmt.Bf16Ops, jmt.Fp8Ops),
    ("bfloat16", "static", jmt.Bf16QuantOps, jmt.Int4Ops),
    ("float32", False, jmt.Ops, jmt.Bf16Ops),
    ("float32", "static", jmt.QuantOps, jmt.Int4Ops),
])
def test_the_reference_computes_at_the_stated_precision(dtype, int8, want,
                                                        control):
    from bench_h100.lib import check
    cfg = {"compute_dtype": dtype, "int8": int8}
    assert type(check.stated_ops(cfg)) is want
    assert type(check.stated_ops(cfg, control=True)) is control
