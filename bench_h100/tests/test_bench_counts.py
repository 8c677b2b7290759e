"""The counts behind the rooflines and the mfu, against hand counts."""
from __future__ import annotations

import pytest
import torch

from bench_h100 import counts
from bench_h100.reference import jmt
from bench_h100.tests import tiny

META = torch.device("meta")
FLAGSHIP = {"model": tiny.model(i3d_input_size=224),
            "input": {"seq": 16, "frames": 8, "size": 112,
                      "audio_samples": 45599, "wavlm_dim": 768}}


def test_one_conv():
    ops = counts.CountOps()
    x = torch.empty(2, 3, 8, 16, 16, device=META)
    w = torch.empty(4, 3, 3, 3, 3, device=META)
    out = ops.conv(x, w, 1, jmt.sym((1, 1, 1)))
    assert tuple(out.shape) == (2, 4, 8, 16, 16)
    (c,) = ops.convs
    assert c["flops"] == 2 * (2 * 4 * 8 * 16 * 16) * (3 * 27)
    assert (c["x"], c["w"], c["out"]) == (2 * 3 * 8 * 16 * 16, 4 * 81,
                                          2 * 4 * 8 * 16 * 16)
    assert c["int8"]                     # a contraction of 3 x 27 >= 64
    with ops.region("inception"):
        ops.conv(x, w, 1, jmt.sym((1, 1, 1)))
    assert not ops.convs[-1]["int8"]     # K3 runs it in bf16


def test_one_attention():
    ops = counts.CountOps()
    b, l, e, heads = 3, 5, 8, 2
    w = {"a.in_proj_weight": torch.empty(3 * e, e, device=META),
         "a.in_proj_bias": torch.empty(3 * e, device=META),
         "a.out_proj.weight": torch.empty(e, e, device=META),
         "a.out_proj.bias": torch.empty(e, device=META)}
    x = torch.empty(b, l, e, device=META)
    jmt.mha(ops, w, "a", x, x, x, heads)
    projections = 4 * 2 * (b * l) * e * e
    products = 2 * 2 * b * heads * l * l * (e // heads)
    assert ops.other_flops == projections + products


@pytest.fixture(scope="module")
def census():
    return counts.census(FLAGSHIP, windows=8)


def test_k3_is_the_nine_modules_by_hand(census):
    n, t = 128, 8
    cin, flops = 192, 0
    sizes = {"Mixed_3": 28, "Mixed_4": 14, "Mixed_5": 7}
    for name, o, _ in jmt.I3D_MODULES:
        hw = sizes[name[:7]] ** 2
        flops += 2 * n * t * hw * (cin * (o[0] + o[1] + o[3]) + 27 * o[1] * o[2]
                                   + 27 * o[3] * o[4] + cin * o[5])
        cin = o[0] + o[2] + o[4] + o[5]
    assert census.k3_flops == flops
    # the nine modules are bound by their operations at 128 clips
    assert census.k3_bound_s == pytest.approx(flops / counts.BF16_PEAK,
                                              rel=1e-12)


def test_int8_convs_are_the_74_the_server_runs():
    ops = counts.CountOps()
    w = {n: torch.empty(s, device=META)
         for n, s, _ in jmt.layout(FLAGSHIP["model"])}
    inp = FLAGSHIP["input"]
    jmt.forward(ops, w, FLAGSHIP["model"],
                torch.empty(1, 1, 8, 112, 112, 3, dtype=torch.uint8,
                            device=META),
                torch.empty(1, 1, inp["audio_samples"], device=META),
                torch.empty(1, 1, 768, device=META), fold=True)
    assert sum(c["int8"] for c in ops.convs) == 74
    assert len(ops.modules) == 9


def test_least_times_order(census):
    assert census.least_time_s(True) < census.least_time_s(False)
    assert census.train_least_time_s() > census.least_time_s(False)
    assert 0 < census.k5_bound_s < census.least_time_s(True)
