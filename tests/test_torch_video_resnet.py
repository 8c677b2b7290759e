"""The R2D1 backbone's other archs, R3D-18 and MC3-18, against the JAX
package, fp32 on CPU.

Weights carried over with ``convert.inv_video_resnet(arch=...)`` (strict
loads in torchvision's key layout); 8-frame clips at 32 px. Features atol
3e-4 (the JAX package's backbone parity bound) in eval mode and with
train-mode BN, whose new running statistics are held at atol 2e-6
(measured 1.3e-6 in R3D's layer4, whose batch statistics are taken over
8 values a channel; ~1e-7 elsewhere); a
``JMTModel(r2d1_arch="mc3")`` eval forward's V/A at atol 2e-5, the bound
of ``test_torch_model.py``.
"""
import numpy as np
import pytest
import torch

import jax

from jmt_tpu.models.jmt_model import JMTModel as JJMTModel
from jmt_tpu.models.video_resnet import VideoResNet as JVideoResNet
from jmt_tpu.train.loops import _preprocess
from jmt_tpu_torch.models import convert
from jmt_tpu_torch.models.jmt_model import JMTModel
from jmt_tpu_torch.models.video_resnet import VideoResNet, mc3_18, r3d_18
from jmt_tpu_torch.train.loops import preprocess

torch.set_num_threads(2)

MAKERS = {"r3d": r3d_18, "mc3": mc3_18}


def _np_tree(tree):
    return jax.tree.map(lambda x: np.array(x, copy=True), tree)


@pytest.fixture(scope="module", params=sorted(MAKERS))
def pair(request):
    """(arch, input (N, T, H, W, 3), JAX module, its variables)."""
    arch = request.param
    x = np.random.default_rng(1).normal(size=(2, 8, 32, 32, 3)).astype(
        np.float32)
    jm = JVideoResNet(arch=arch)
    variables = _np_tree(jax.jit(jm.init)(jax.random.PRNGKey(0), x))
    return arch, x, jm, variables


def test_keys_follow_torchvision_and_load_strict(pair):
    arch, _, _, variables = pair
    pm = MAKERS[arch]()
    assert pm.arch == arch
    sd = convert.inv_video_resnet(variables, arch=arch)
    assert set(sd) == set(pm.state_dict())
    assert {"stem.0.weight", "stem.1.running_var", "layer1.0.conv1.0.weight",
            "layer2.0.conv2.0.weight", "layer2.0.downsample.0.weight"} <= \
        set(sd)
    assert not any(k.startswith("stem.3") or ".conv1.0.3." in k for k in sd)
    want = (3, 3, 3) if arch == "r3d" else (1, 3, 3)
    assert sd["layer1.0.conv1.0.weight"].shape[2:] == (3, 3, 3)
    assert sd["layer2.0.conv1.0.weight"].shape[2:] == want
    assert sd["stem.0.weight"].shape == (64, 3, 3, 7, 7)
    convert.load_jax_variables(pm, variables)


@pytest.mark.parametrize("train", [False, True])
def test_features_match_jax(pair, train):
    arch, x, jm, variables = pair
    pm = convert.load_jax_variables(VideoResNet(arch), variables)
    xt = torch.from_numpy(x).permute(0, 4, 1, 2, 3)
    if train:
        want, upd = jax.jit(lambda v, x: jm.apply(
            v, x, False, True, mutable=["batch_stats"]))(variables, x)
        pm.train()
        got = pm(xt).detach()
    else:
        want = jax.jit(jm.apply)(variables, x)
        with torch.inference_mode():
            got = pm(xt)
    # layer4 (N, 512, T', 2, 2) at 32 px: MC3 keeps the 8 frames, R3D
    # strides them
    t_out = 8 if arch == "mc3" else 1
    assert got.shape == (2, 512, t_out, 2, 2)
    want = np.asarray(want)
    assert float(np.abs(want).max()) > 1e-2
    np.testing.assert_allclose(got.permute(0, 2, 3, 4, 1).numpy(), want,
                               rtol=0, atol=3e-4)
    if train:
        sd = convert.inv_video_resnet(
            {"params": variables["params"],
             "batch_stats": _np_tree(upd["batch_stats"])}, arch=arch)
        stats = [k for k in sd if k.endswith(("running_mean",
                                              "running_var"))]
        assert len(stats) == 2 * 20
        for k in stats:
            np.testing.assert_allclose(pm.state_dict()[k].numpy(), sd[k],
                                       rtol=0, atol=2e-6, err_msg=k)


def test_jmt_model_with_mc3_matches_jax():
    cfg = dict(vision_backbones=("R2D1",), audio_backbones=("ResNet18",),
               r2d1_arch="mc3")
    rng = np.random.default_rng(0)
    b, s = 2, 2
    arrays = {"clips": rng.integers(0, 256, (b, s, 8, 32, 32, 3),
                                    dtype=np.uint8),
              "audio": (0.1 * rng.normal(size=(b, s, 45599))).astype(
                  np.float32)}
    jm = JJMTModel(**cfg)
    spec, clips = _preprocess(jm, arrays, None, augment=False)
    variables = jax.jit(jm.init)(jax.random.PRNGKey(0), spec, clips)
    want_v, want_a = jax.jit(jm.apply)(variables, spec, clips)
    model = convert.load_jax_variables(JMTModel(**cfg),
                                       _np_tree(variables))
    assert model.backbones.vision_r2d1.r2plus1d.arch == "mc3"
    with torch.inference_mode():
        v, a = model(*preprocess(model, {k: torch.from_numpy(x)
                                         for k, x in arrays.items()}))
    assert float(np.std(np.asarray(want_v))) > 1e-5
    np.testing.assert_allclose(v.numpy(), np.asarray(want_v), rtol=0,
                               atol=2e-5)
    np.testing.assert_allclose(a.numpy(), np.asarray(want_a), rtol=0,
                               atol=2e-5)
    with pytest.raises(ValueError, match="r2d1_arch"):
        JMTModel(**dict(cfg, r2d1_arch="r2d"))
