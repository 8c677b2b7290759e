"""The heavy augmentations (``use_more_vision_data_augm`` /
``use_more_audio_data_augm``) against the JAX package, fp32 on CPU.

The port splits each augmentation into a sampler (a ``torch.Generator``)
and an apply function of the parameters; the apply functions are held to
JAX's jitted ones on the exact parameters JAX's key yields, re-derived
here with ``jax.random`` in JAX's split order
(``jmt_tpu/ops/audio_augment.py:110-122``, ``jmt_tpu/data/transforms.py:
143-168``). Tolerances, each stated against what was measured:

* ``phase_vocoder`` at rates 1.0, 1.2 and 0.9: ``valid_len`` equal; the
  magnitudes within 1e-5 of max |JAX| (measured 2.9e-6); the complex
  output within 1e-2 of it (measured 1.1e-3, 1.8e-3, 4.8e-3), fewer
  than 0.5% of its values beyond 1e-3 (measured 0.18% at most). The
  phase of the high bins accumulates to ~1.8e5 rad, where float32's
  spacing is 0.016 rad: one ulp apart in any step's phase, or in the
  range reduction of sin and cos, moves a value by ~1.6% of its
  magnitude (both packages are ~2% of max from a float64 vocoder);
* the complex STFT within 2e-6 of max |JAX| (measured 1.9e-7);
* ``more_audio_augment``: within 1e-5 of max |JAX| (measured 1.2e-6);
  it takes the vocoder's interpolated magnitude without its phase;
* ``more_vision_augment``: atol 2e-5 in normalized units (measured
  3.7e-6);
* the samplers: each probability within 5 standard errors of JAX's over
  20,000 draws, each range JAX's;
* one ``light`` train step (R2D1 + ResNet-18, backbones frozen) with both
  flags against JAX's ``make_train_step`` with the same key: the bounds
  of ``test_torch_train.BOUNDS["light"]``.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from jmt_tpu.data import transforms as jtransforms
from jmt_tpu.models.jmt_model import JMTModel as JJMTModel
from jmt_tpu.ops import audio_augment as jaudio
from jmt_tpu.train import loops as jloops
from jmt_tpu.train import optim as jopt
from jmt_tpu.train import state as jstate
from jmt_tpu_torch.data.transforms import (VisionAugment, more_vision_augment,
                                           sample_vision_augment)
from jmt_tpu_torch.models import convert
from jmt_tpu_torch.models.jmt_model import JMTModel
from jmt_tpu_torch.ops import audio_augment
from jmt_tpu_torch.ops.audio_augment import (AudioAugment,
                                             more_audio_augment,
                                             sample_audio_augment)
from jmt_tpu_torch.train import loops

from test_torch_train import BOUNDS, CONFIGS, _arrays, _configs, _np_tree

torch.set_num_threads(2)


def _t(x, dtype=None):
    t = torch.from_numpy(np.array(x))
    return t if dtype is None else t.to(dtype)


def jax_audio_params(key, n) -> AudioAugment:
    """What JAX's ``more_audio_augment`` draws from ``key``."""
    ks = jax.random.split(key, 4)
    do = jax.random.bernoulli(ks[0], 0.6, (n,))
    fast = jax.random.bernoulli(ks[1], 0.5, (n,))
    rate = jnp.where(do, jnp.where(fast, 1.2, 0.9), 1.0)
    masks = []
    for k, dim in ((ks[2], jaudio.AUG_FRAMES), (ks[3], jaudio.N_MELS)):
        k1, k2, k3 = jax.random.split(k, 3)
        width = jnp.minimum(jax.random.uniform(k1, (n,)) * 80,
                            dim).astype(jnp.int32)
        start = (jax.random.uniform(k2, (n,))
                 * (dim - width + 1)).astype(jnp.int32)
        masks += [_t(width, torch.long), _t(start, torch.long),
                  _t(jax.random.bernoulli(k3, 0.6, (n,)))]
    return AudioAugment(_t(rate, torch.float32), *masks)


def jax_vision_params(key, nf) -> VisionAugment:
    """What JAX's ``more_vision_augment`` draws from ``key`` for nf
    frames."""
    ks = jax.random.split(key, 10)
    u = jax.random.uniform
    angle = u(ks[0], (nf,), minval=-6.0, maxval=6.0) * (np.pi / 180.0)
    side = jnp.sqrt(u(ks[1], (nf,), minval=0.8, maxval=1.0))
    tx = u(ks[2], (nf,), minval=-1.0, maxval=1.0) * (1.0 - side)
    ty = u(ks[3], (nf,), minval=-1.0, maxval=1.0) * (1.0 - side)
    flip = jax.random.bernoulli(ks[4], 0.5, (nf, 1, 1, 1))
    gray = jax.random.bernoulli(ks[5], 0.2, (nf, 1, 1, 1))
    jit = jax.random.bernoulli(ks[6], 0.8, (nf, 1, 1, 1)).astype(
        jnp.float32)
    shape = dict(minval=0.6, maxval=1.4)
    bf = u(ks[7], (nf, 1, 1, 1), **shape)
    cf = u(ks[8], (nf, 1, 1, 1), **shape)
    kk = jax.random.split(ks[9], 2)
    sf = u(kk[0], (nf, 1, 1, 1), **shape)
    hf = u(kk[1], (nf,), minval=-0.1, maxval=0.1)
    flat = [angle, side, tx, ty, flip, gray, 1 + (bf - 1) * jit,
            1 + (cf - 1) * jit, 1 + (sf - 1) * jit, hf * jit[:, 0, 0, 0]]
    return VisionAugment(*(_t(x).reshape(nf) for x in flat))


def _audio(n, seed=0):
    a = (0.1 * np.random.default_rng(seed).normal(size=(n, 45599))).astype(
        np.float32)
    a[-1] = 0.0  # an all-zero wav
    return a


@pytest.mark.parametrize("rate", [1.0, 1.2, 0.9])
def test_phase_vocoder_matches_jax(rate):
    audio = _audio(2, seed=1)
    spec = jaudio._complex_stft(jnp.asarray(audio))
    rates = np.full(2, rate, np.float32)
    want, want_len = jax.jit(jaudio.phase_vocoder)(spec, jnp.asarray(rates))
    got, got_len = audio_augment.phase_vocoder(
        torch.from_numpy(np.array(spec)), torch.from_numpy(rates))
    assert got.dtype == torch.complex64 and got.shape == (
        2, jaudio.AUG_FRAMES, jaudio.N_FREQS)
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    assert int(got_len[0]) == int(np.ceil(104 / np.float32(rate)))
    want, got = np.asarray(want), got.numpy()
    top = np.abs(want).max()
    assert np.abs(np.abs(got) - np.abs(want)).max() <= 1e-5 * top
    err = np.abs(got - want)
    assert err.max() <= 1e-2 * top, (err.max(), top)
    assert np.mean(err > 1e-3 * top) < 5e-3


def test_complex_stft_matches_jax():
    audio = _audio(2, seed=2)
    want = np.asarray(jaudio._complex_stft(jnp.asarray(audio)))
    got = audio_augment.complex_stft(torch.from_numpy(audio)).numpy()
    assert got.shape == want.shape == (2, 104, 513)
    assert np.abs(got - want).max() <= 2e-6 * np.abs(want).max()


def test_more_audio_augment_matches_jax():
    n, key = 12, jax.random.PRNGKey(5)
    audio = _audio(n, seed=3)
    params = jax_audio_params(key, n)
    # the draw covers every stretch and both masks on and off
    assert set(params.rate.tolist()) == {1.0, np.float32(1.2).item(),
                                         np.float32(0.9).item()}
    assert 0 < int(params.time_on.sum()) < n
    assert 0 < int(params.freq_on.sum()) < n
    want = np.asarray(jaudio.more_audio_augment(jnp.asarray(audio), key))
    got = more_audio_augment(torch.from_numpy(audio), params).numpy()
    assert got.shape == want.shape == (n, 64, jaudio.AUG_FRAMES)
    err = np.abs(got - want).max()
    assert err <= 1e-5 * np.abs(want).max(), (err, np.abs(want).max())
    # right-aligned content after zeros
    lens = np.ceil(104 / params.rate.numpy()).astype(int)
    for i, valid in enumerate(lens):
        assert not got[i, :, :jaudio.AUG_FRAMES - valid].any()


def test_more_vision_augment_matches_jax():
    clips = np.random.default_rng(4).integers(0, 256, (3, 4, 14, 10, 3),
                                              dtype=np.uint8)
    key = jax.random.PRNGKey(6)
    params = jax_vision_params(key, 12)
    for flag in (params.flip, params.gray, params.brightness != 1):
        assert 0 < int(flag.sum()) < 12
    want = np.asarray(jtransforms.more_vision_augment(jnp.asarray(clips),
                                                      key))
    got = more_vision_augment(torch.from_numpy(clips), params).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.abs(got - want).max() <= 2e-5, np.abs(got - want).max()


def test_samplers_draw_jax_distributions():
    n, gen = 20000, torch.Generator().manual_seed(0)

    def share(x, p):
        se = np.sqrt(p * (1 - p) / n)
        assert abs(float(x.float().mean()) - p) <= 5 * se, (
            float(x.float().mean()), p)

    a = sample_audio_augment(gen, n)
    assert a.time_width.dtype == a.freq_start.dtype == torch.long
    share(a.rate != 1.0, 0.6)
    share(a.rate[a.rate != 1.0] > 1.0, 0.5)
    assert set(torch.unique(a.rate).tolist()) == {
        1.0, np.float32(1.2).item(), np.float32(0.9).item()}
    share(a.time_on, 0.6)
    share(a.freq_on, 0.6)
    for width, start, dim in ((a.time_width, a.time_start, 128),
                              (a.freq_width, a.freq_start, 64)):
        assert int(width.min()) == 0 and int(width.max()) == min(79, dim)
        assert int(start.min()) == 0 and int((start + width).max()) <= dim
    v = sample_vision_augment(gen, n)
    share(v.flip, 0.5)
    share(v.gray, 0.2)
    share(v.brightness != 1.0, 0.8)
    assert torch.equal(v.brightness != 1.0, v.hue != 0.0)
    deg = v.angle * 180 / np.pi
    assert -6.0 <= float(deg.min()) < -5.9 and 5.9 < float(deg.max()) <= 6.0
    area = v.scale ** 2
    assert 0.8 - 1e-6 <= float(area.min()) and float(area.max()) <= 1.0
    assert bool((v.tx.abs() <= 1 - v.scale + 1e-7).all())
    for f in (v.brightness, v.contrast, v.saturation):
        on = f[f != 1.0]
        assert 0.6 <= float(on.min()) < 0.61 and 1.39 < float(on.max()) <= 1.4
    assert -0.1 <= float(v.hue.min()) < -0.099
    on_gpu_like = sample_audio_augment(None, 4, device="cpu")
    assert on_gpu_like.rate.shape == (4,)


def test_light_train_step_with_heavy_augmentations_matches_jax():
    """The train step with both flags: JAX draws from the step's key
    (pre_key -> kv for vision, ka for audio); the port gets the same
    parameters. Backbones frozen, so the heavy augmentations reach the
    loss through the fusion."""
    cfg, finetune = CONFIGS["light"]
    jm = JJMTModel(**cfg, finetune=finetune)
    jcfg, pcfg = _configs(cfg, finetune)
    arrays = _arrays(wavlm=False)
    b, s = arrays["labels_v"].shape
    tx = jopt.build_optimizer(jcfg.model_params.opt)
    # jloops.init_state's steps, with the init jitted (eager, it is slow)
    spec, clips = jloops._preprocess(jm, arrays, None, augment=False)
    before = _np_tree(dict(jax.jit(jm.init)(jax.random.PRNGKey(0), spec,
                                            clips)))
    trainable, frozen = jstate.partition_params(
        before["params"], jstate.frozen_prefixes(jcfg))
    state = jstate.TrainState(trainable=trainable, frozen=frozen,
                              batch_stats=before["batch_stats"],
                              opt_state=tx.init(trainable), epoch=0)
    key = jax.random.PRNGKey(13)
    step = jloops.make_train_step(jm, tx, more_vision_augm=True,
                                  more_audio_augm=True)
    state, jloss, _, _ = step(state, arrays, key)
    after = _np_tree({"params": state.params(),
                      "batch_stats": state.batch_stats})
    pre_key, _ = jax.random.split(key)
    kv, ka, _ = jax.random.split(pre_key, 3)

    model = JMTModel(**cfg, finetune=finetune)
    pstate = loops.init_state(
        model, pcfg, device="cpu",
        variables_hook=lambda m: convert.load_jax_variables(m, before))
    spec, _ = loops.preprocess(
        model, {k: torch.from_numpy(x) for k, x in arrays.items()},
        more_audio_augm=True,
        audio_augment=jax_audio_params(ka, b * s))
    assert spec.shape == (b, s, 64, jaudio.AUG_FRAMES)
    sd0 = {k: v.clone() for k, v in model.state_dict().items()}
    loss, _, _ = loops.make_train_step(
        model, more_vision_augm=True, more_audio_augm=True, device="cpu")(
        pstate, arrays, vision_augment=jax_vision_params(kv, b * s * 8),
        audio_augment=jax_audio_params(ka, b * s))
    loss_tol, upd_tol, _ = BOUNDS["light"][0]
    assert abs(float(loss) - float(jloss)) <= loss_tol, (float(loss),
                                                          float(jloss))
    want = convert.state_dict_from_jax(model, after)
    old = convert.state_dict_from_jax(model, before)
    sd = model.state_dict()
    upds = {n: ((sd[n] - sd0[n]).numpy(), want[n] - old[n])
            for n in pstate.trainable}
    scale = max(np.abs(w).max() for _, w in upds.values())
    assert scale > 0
    for name, (upd, upd_want) in upds.items():
        err = np.maximum(np.abs(upd - upd_want)
                         - np.spacing(np.abs(want[name])), 0).max()
        assert err <= upd_tol * scale, (name, err, scale)
