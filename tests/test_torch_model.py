"""The port's whole serving forward against the JAX package, fp32 on CPU.

``JMTModel`` in the slice configuration (R2D1 MAX + ResNet18 & wavLM with
encoder_plus_self_attention, JMT SELF_ATTEN) and the light configuration
(R2D1 + ResNet18) at B=2, S=4, 32 px: raw uint8 clips and raw audio go
through each package's preprocessing and model. V/A are held at atol 2e-5;
at random init the slice's V/A spread across rows is ~4e-3 (the light
configuration's V only ~2e-4); the measured deviation is ~1e-7.
"""
import numpy as np
import pytest
import torch

import jax

from jmt_tpu.models.jmt_model import JMTModel as JJMTModel
from jmt_tpu.train.loops import _preprocess
from jmt_tpu_torch.models import convert
from jmt_tpu_torch.models.jmt_model import JMTModel
from jmt_tpu_torch.train.loops import preprocess

torch.set_num_threads(2)

CONFIGS = {
    "slice": dict(vision_backbones=("R2D1",),
                  audio_backbones=("ResNet18", "wavLM"),
                  intra_modal_fusion="encoder_plus_self_attention"),
    "light": dict(vision_backbones=("R2D1",),
                  audio_backbones=("ResNet18",)),
}
B, S, PX = 2, 4, 32


def _arrays(seed=0):
    rng = np.random.default_rng(seed)
    audio = (0.1 * rng.normal(size=(B, S, 45599))).astype(np.float32)
    audio[1, 2] = 0.0  # an all-zero wav
    return {"clips": rng.integers(0, 256, (B, S, 8, PX, PX, 3),
                                  dtype=np.uint8),
            "audio": audio,
            "wavlm": rng.normal(size=(B, S, 768)).astype(np.float32)}


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def pair(request):
    """(config name, JAX outputs, port model with the JAX weights)."""
    cfg = CONFIGS[request.param]
    jm = JJMTModel(**cfg)
    arrays = _arrays()
    spec, clips = _preprocess(jm, arrays, None, augment=False)
    wavlm = arrays["wavlm"] if "wavLM" in cfg["audio_backbones"] else None
    variables = jax.jit(jm.init)(jax.random.PRNGKey(0), spec, clips, wavlm)
    v, a = jax.jit(jm.apply)(variables, spec, clips, wavlm)
    variables = jax.tree.map(np.asarray, variables)
    model = convert.load_jax_variables(JMTModel(**cfg), variables)
    return request.param, (np.asarray(v), np.asarray(a)), model, variables


def test_jmt_model_matches_jax(pair):
    name, (want_v, want_a), model, _ = pair
    arrays = {k: torch.from_numpy(x) for k, x in _arrays().items()}
    if not model.use_wavlm:
        arrays.pop("wavlm")
    with torch.inference_mode():
        spec, clips = preprocess(model, arrays)
        assert spec.shape == (B, S, 64, 104) and spec.dtype == torch.float32
        assert clips.shape == (B, S, 8, PX, PX, 3)
        v, a = model(spec, clips, arrays.get("wavlm"))
    assert v.shape == a.shape == (B, S)
    assert float(np.std(want_v)) > 1e-4  # the outputs are not degenerate
    np.testing.assert_allclose(v.numpy(), want_v, rtol=0, atol=2e-5)
    np.testing.assert_allclose(a.numpy(), want_a, rtol=0, atol=2e-5)


def test_state_dict_uses_reference_keys_and_loads_strict(pair):
    name, _, model, variables = pair
    keys = set(model.state_dict())
    assert keys == set(convert.state_dict_from_jax(model, variables))
    prefixes = {"backbones.audio_resnet18.resnet.conv1.weight",
                "backbones.vision_r2d1.r2plus1d.stem.0.weight",
                "backbones.vision_r2d1.r2plus1d.stem.4.running_var",
                "backbones.vision_r2d1.r2plus1d.layer2.0.conv1.0.3.weight",
                "backbones.vision_r2d1.r2plus1d.layer2.0.conv1.1.weight",
                "fusion_model.mm_transformer.final_visual_encoder.layers.0"
                ".attention.in_proj_weight",
                "fusion_model.vregressor.3.weight",
                "fusion_model.aregressor.0.bias"}
    if name == "slice":
        prefixes |= {"transformer_audio_modality_fusion.fc.weight",
                     "transformer_audio_modality_fusion.final_self_attention"
                     ".out_proj.weight"}
    assert prefixes <= keys
    # no forward-dead modules: the reference's final_encoder and R2D1 fc
    assert not any(".final_encoder." in k or "r2plus1d.fc" in k
                   for k in keys)
    sd = convert.state_dict_from_jax(model, variables)
    sd.pop(sorted(sd)[0])
    with pytest.raises(RuntimeError, match="Missing key"):
        model.load_state_dict({k: torch.from_numpy(np.array(v))
                               for k, v in sd.items()}, strict=True)


def test_attention_launch_pattern_of_one_forward(pair, monkeypatch):
    """Ten attention-core calls per forward at num_layers=1, at the shapes
    chip_smoke.py times (there at B=8, S=16)."""
    from jmt_tpu_torch.ops import attention
    name, _, model, _ = pair
    shapes = []
    real = attention.fused_attention

    def spy(q, k, v):
        shapes.append((q.shape[0], q.shape[1], k.shape[1], q.shape[2]))
        return real(q, k, v)

    monkeypatch.setattr(attention, "fused_attention", spy)
    arrays = {k: torch.from_numpy(x) for k, x in _arrays().items()}
    with torch.inference_mode():
        spec, clips = preprocess(model, arrays)
        model(spec, clips, arrays["wavlm"] if model.use_wavlm else None)
    jmt = [(B, S, S, 512)] * 3 + [(2 * B, S, S, 512)] * 3 + \
          [(B * S, 6, 6, 512)] * 2
    intra = [(B * S, 2, 2, 512)] * 2 if name == "slice" else []
    assert shapes == intra + jmt
