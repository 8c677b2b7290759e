"""Channel alignment of the backbones' convs (``ops/conv.py``'s note), on
the CPU in float32.

The reference is the same module with alignment off (``ops/conv.ALIGN``
set to 1, so no count is padded): every unit whose channels are padded
gives the unpadded computation's outputs to f32 rounding, and its
parameters' gradients; state dicts keep their keys and shapes and load;
train-mode BN keeps every shape and updates the same running
statistics; an int8 context hands the int8 path and every float
conv the shapes they had. The counter pins the flagship's bucket-8
forward: 39 aligned convs of 84, 57.89% of their operations.
"""
import copy
import io

import pytest
import torch

from jmt_tpu_torch import serve
from jmt_tpu_torch.models.common import init_parameters
from jmt_tpu_torch.models.i3d import InceptionI3d, Unit3D
from jmt_tpu_torch.models.jmt_model import JMTModel
from jmt_tpu_torch.models.resnet18 import ResNet18
from jmt_tpu_torch.models.video_resnet import Conv2Plus1D, VideoResNet
from jmt_tpu_torch.ops import conv, quant
from jmt_tpu_torch.ops.norm import TorchBatchNorm

torch.set_num_threads(2)


class StemFold(torch.nn.Module):
    """The I3D stem on a half-size clip: the upsample folded in."""

    def __init__(self):
        super().__init__()
        self.unit = Unit3D(3, 64, (7, 7, 7), (1, 2, 2))

    def forward(self, x):
        return self.unit.upsampled2x(x)


# name: (module maker, input shape, aligned convs in one forward)
UNITS = {
    "r2plus1d_trunk": (lambda: VideoResNet("r2plus1d"), (2, 3, 8, 32, 32),
                       22),
    "conv2plus1d": (lambda: Conv2Plus1D(64, 128, 230, stride=2),
                    (2, 64, 4, 8, 8), 2),
    "i3d_stem_fold": (StemFold, (2, 3, 6, 12, 12), 16),
    "i3d_trunk_native": (InceptionI3d, (1, 3, 8, 32, 32), 1),
    "r3d_basic_stem": (lambda: VideoResNet("r3d").stem, (2, 3, 4, 16, 16),
                       1),
    "resnet18": (ResNet18, (2, 1, 64, 40), 1),
}


def _unit(name):
    """The unit, seeded, with BN away from its identity."""
    make, shape, _ = UNITS[name]
    module = make()
    gen = torch.Generator().manual_seed(0)
    init_parameters(module, gen)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, TorchBatchNorm):
                m.weight.normal_(1.0, 0.1, generator=gen)
                m.bias.normal_(0.0, 0.1, generator=gen)
                m.running_mean.normal_(0.0, 0.1, generator=gen)
                m.running_var.uniform_(0.5, 1.5, generator=gen)
    x = torch.randn(shape, generator=gen)
    return module, x


def _run(module, x, align):
    """(output, aligned convs) with alignment on or off."""
    saved = conv.ALIGN
    conv.ALIGN = conv.ALIGN if align else 1
    try:
        before = conv.conv_counts()
        y = module(x)
        return y, conv.aligned_share(before, conv.conv_counts())[0]
    finally:
        conv.ALIGN = saved


@pytest.mark.parametrize("name", sorted(UNITS))
def test_aligned_equals_unpadded(name):
    module, x = _unit(name)
    with torch.inference_mode():
        got, n_aligned = _run(module, x, True)
        want, n_plain = _run(module, x, False)
    assert (n_aligned, n_plain) == (UNITS[name][2], 0)
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", sorted(UNITS))
def test_gradients_of_the_real_parameters(name):
    """Eval-mode BN (the aligned path) with every parameter training: the
    same gradients reach the unpadded parameters."""
    module, x = _unit(name)
    grads = []
    for align in (True, False):
        module.zero_grad()
        y, _ = _run(module, x, align)
        (y * torch.linspace(-1, 1, y.numel()).view(y.shape)).sum().backward()
        grads.append({k: p.grad.clone()
                      for k, p in module.named_parameters()})
    assert set(grads[0]) == set(grads[1])
    for k, want in grads[1].items():   # f32 rounding of the largest
        torch.testing.assert_close(grads[0][k], want, rtol=0,
                                   atol=1e-5 * want.abs().max().item())


@pytest.mark.parametrize("name", sorted(UNITS))
def test_state_dict_keys_shapes_and_load(name):
    module, x = _unit(name)
    fresh, _ = _unit(name)
    shapes = {k: tuple(v.shape) for k, v in fresh.state_dict().items()}
    with torch.inference_mode():
        want, _ = _run(module, x, True)
    assert {k: tuple(v.shape) for k, v in module.state_dict().items()} \
        == shapes
    buf = io.BytesIO()
    torch.save(module.state_dict(), buf)
    buf.seek(0)
    loaded = UNITS[name][0]()
    loaded.load_state_dict(torch.load(buf), strict=True)
    with torch.inference_mode():
        got, _ = _run(loaded, x, True)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_r2plus1d_keeps_its_published_shapes():
    sd = VideoResNet("r2plus1d").state_dict()
    assert sd["stem.0.weight"].shape == (45, 3, 1, 7, 7)
    assert sd["stem.1.running_var"].shape == (45,)
    assert sd["stem.3.weight"].shape == (64, 45, 3, 1, 1)
    for layer, mid, cin, cout in ((2, 230, 64, 128), (3, 460, 128, 256),
                                  (4, 921, 256, 512)):
        pre = f"layer{layer}.0.conv1.0"
        assert sd[f"{pre}.0.weight"].shape == (mid, cin, 1, 3, 3)
        assert sd[f"{pre}.1.weight"].shape == (mid,)
        assert sd[f"{pre}.3.weight"].shape == (cout, mid, 3, 1, 1)


@pytest.mark.parametrize("name", sorted(UNITS))
def test_train_mode_bn_keeps_every_shape(name):
    """Batch-statistics BN: no conv aligned, the same outputs and the
    same running-statistics updates, bit for bit."""
    module, x = _unit(name)
    module.train()
    plain = copy.deepcopy(module)
    got, n_aligned = _run(module, x, True)
    want, _ = _run(plain, x, False)
    assert n_aligned == 0
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    bufs = dict(plain.named_buffers())
    for k, b in module.named_buffers():
        torch.testing.assert_close(b, bufs[k], rtol=0, atol=0, msg=k)


def test_train_mode_bn_refuses_aligned_channels():
    bn = TorchBatchNorm(45).train()
    with pytest.raises(ValueError, match="train mode got 48"):
        bn(torch.zeros(2, 48, 3))
    y = TorchBatchNorm(45)(torch.ones(2, 48, 3))
    assert y.shape == (2, 48, 3) and not y[:, 45:].any()


@pytest.mark.parametrize("mode", ["dynamic", "calibration"])
@pytest.mark.parametrize("name", ["r2plus1d_trunk", "i3d_stem_fold"])
def test_int8_context_keeps_the_shapes(name, mode, monkeypatch):
    """Under an int8 context the int8 path and the float convs get the
    weight shapes they get with alignment off."""
    module, x = _unit(name)
    seen = []
    int8_conv = quant.int8_conv

    def spy_int8(x, weight, *args):
        seen.append(("int8", tuple(weight.shape)))
        return int8_conv(x, weight, *args)

    monkeypatch.setattr(quant, "int8_conv", spy_int8)
    for dim, fn in list(conv._CONV.items()):
        def spy(x, weight, *args, fn=fn):
            seen.append(("float", tuple(weight.shape)))
            return fn(x, weight, *args)
        monkeypatch.setitem(conv._CONV, dim, spy)
    runs = []
    for align in (True, False):
        seen.clear()
        ctx = (quant.int8_inference() if mode == "dynamic"
               else quant.int8_calibration([]))
        with torch.inference_mode(), ctx:
            y, n_aligned = _run(module, x, align)
        assert n_aligned == 0
        runs.append((list(seen), y))
    assert runs[0][0] == runs[1][0] and any(k == "int8"
                                            for k, _ in runs[0][0])
    torch.testing.assert_close(runs[0][1], runs[1][1], rtol=0, atol=0)


def test_flagship_bucket8_counter():
    """The flagship's bucket-8 forward as the server captures it (its
    eager forward, on the meta device): 39 convs aligned (R(2+1)D's 22,
    the folded I3D stem's 16, ResNet-18's conv1) of 84, 57.89% of the
    convs' operations by the unpadded shapes."""
    with torch.device("meta"):
        model = JMTModel(
            vision_backbones=("R2D1", "I3D"),
            audio_backbones=("ResNet18", "wavLM"),
            intra_modal_fusion="encoder_plus_self_attention",
            i3d_fused_inception=True, dtype=torch.bfloat16)
    server = serve.InferenceServer(model, buckets=(8,), device="meta")
    before = conv.conv_counts()
    server.forward(server._example(8))
    after = conv.conv_counts()
    n, share = conv.aligned_share(before, after)
    assert after["convs"] - before["convs"] == 84
    assert n == 39
    assert share == pytest.approx(0.578910, abs=1e-6)
