"""The rest of the fusion lattice against the JAX package, fp32 on CPU.

Forwards at atol 1e-5 (the bound of ``test_torch_fusion.py``), weights
carried over with ``convert.load_jax_variables`` (strict load): the joint
multimodal transformer's FC head with ``fc_transpose_quirk`` off and on,
``MultimodalTransformerNoJR`` with its batch-axis quirk, ``FeatureConcatFC``,
``SingleBackbonePretrainer``, ``TwoTransformers`` at every
(joint_modalities, output_format) pair, and a composed PRETRAINING model.

``model_from_config`` builds every combination that ``validate_lattice``
admits, each with the JAX model's parameter count (``jax.eval_shape`` of
its parts: backbones, intra-modal modules, heads; two whole JAX models
pin the sum), less nothing but the visual intra-modal fusion's unused
768 -> 512 ``fc``, which the port keeps as the reference does. The keys
the port leaves out raise.
"""
import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jmt_tpu.models import fusion as jfus
from jmt_tpu.models import jmt as jjmt
from jmt_tpu.models.jmt_model import JMTModel as JJMTModel
from jmt_tpu.train.loops import _preprocess
from jmt_tpu_torch.core.config import Config
from jmt_tpu_torch.models import fusion, jmt
from jmt_tpu_torch.models.convert import load_jax_variables
from jmt_tpu_torch.models.jmt_model import JMTModel, model_from_config
from jmt_tpu_torch.train.loops import preprocess
from jmt_tpu_torch.train.state import param_count

torch.set_num_threads(2)
ATOL = 1e-5

VISION = (("R2D1",), ("I3D",), ("R2D1", "I3D"))
AUDIO = (("ResNet18",), ("wavLM",), ("ResNet18", "wavLM"))
INTRA = ("None", "feat_concat_fc", "encoder_plus_self_attention")
HEADS = (("NONE", "FC"), ("TRANSFORMER", "FC"),
         ("TRANSFORMER", "SELF_ATTEN"), ("FC", "FC"), ("FC", "SELF_ATTEN"))
SINGLE = (("R2D1",), ("I3D",), ("ResNet18",), ("wavLM",))


def _x(*shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _check(jax_module, port_module, *inputs, seed=0):
    # eager: op by op, these small modules run faster than they compile
    variables = jax_module.init(jax.random.PRNGKey(seed), *inputs)
    want = jax_module.apply(variables, *inputs)
    load_jax_variables(port_module, jax.tree.map(np.asarray, variables))
    with torch.inference_mode():
        got = port_module(*map(torch.from_numpy, inputs))
    got, want = ((got, want) if isinstance(got, tuple)
                 else ((got,), (want,)))
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        assert float(np.std(np.asarray(w))) > 1e-4  # not degenerate
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=ATOL)


@pytest.mark.parametrize("quirk", [False, True])
def test_jmt_fc_head(quirk):
    v, a = _x(2, 4, 512), _x(2, 4, 512, seed=1)
    port = jmt.JointMultimodalTransformer(output_format="FC",
                                          fc_transpose_quirk=quirk)
    _check(jjmt.JointMultimodalTransformer(output_format="FC",
                                           fc_transpose_quirk=quirk),
           port, v, a)
    assert not hasattr(port, "final_visual_encoder")
    with torch.inference_mode():
        out = port(torch.from_numpy(v), torch.from_numpy(a))
    assert tuple(out.shape) == ((4, 2, 1024) if quirk else (2, 4, 1024))


def test_no_jr_attends_over_the_batch_axis():
    """Under the quirk a row's output depends on the other rows: a zero
    pad row changes the real rows, in JAX and in the port alike."""
    v, a = _x(3, 4, 512), _x(3, 4, 512, seed=1)
    port = jmt.MultimodalTransformerNoJR()
    _check(jjmt.MultimodalTransformerNoJR(), port, v, a)
    with torch.inference_mode():
        full = port(torch.from_numpy(v), torch.from_numpy(a))
        padded = port(*(torch.from_numpy(np.concatenate(
            [x, np.zeros((1, 4, 512), np.float32)])) for x in (v, a)))
    assert float((padded[:3] - full).abs().max()) > 1e-3
    _check(jjmt.MultimodalTransformerNoJR(encode_batch_axis_quirk=False),
           jmt.MultimodalTransformerNoJR(encode_batch_axis_quirk=False),
           v, a)


@pytest.mark.parametrize("rows", [129, 200])
def test_no_jr_over_more_than_128_rows(rows):
    """Past 128 batch rows the quirk's attention is longer than the TPU
    kernel's gate: JAX runs ``_core_xla``, the port K2's plain version on
    the CPU (its long path on the card); the fusion agrees at ATOL."""
    _check(jjmt.MultimodalTransformerNoJR(), jmt.MultimodalTransformerNoJR(),
           _x(rows, 2, 512, seed=2), _x(rows, 2, 512, seed=3))


def test_feature_concat_fc():
    _check(jjmt.FeatureConcatFC(), jmt.FeatureConcatFC(), _x(2, 4, 512),
           _x(2, 4, 512, seed=1))


def test_single_backbone_pretrainer():
    _check(jfus.SingleBackbonePretrainer(), fusion.SingleBackbonePretrainer(),
           3.0 * _x(2, 4, 512))


@pytest.mark.parametrize("joint,output", HEADS)
def test_two_transformers(joint, output):
    _check(jfus.TwoTransformers(joint_modalities=joint, output_format=output),
           fusion.TwoTransformers(joint_modalities=joint,
                                  output_format=output),
           3.0 * _x(2, 4, 512), _x(2, 4, 512, seed=1))


def test_pretraining_model_matches_jax():
    """A composed PRETRAINING model (ResNet-18 alone, no vision)."""
    cfg = dict(vision_backbones=(), audio_backbones=("ResNet18",),
               goal="PRETRAINING")
    rng = np.random.default_rng(3)
    arrays = {"audio": (0.1 * rng.normal(size=(2, 3, 45599))).astype(
        np.float32)}
    jm = JJMTModel(**cfg)
    spec, clips = _preprocess(jm, arrays, None, augment=False)
    variables = jax.jit(jm.init)(jax.random.PRNGKey(0), spec, clips)
    want = jax.jit(jm.apply)(variables, spec, clips)
    model = load_jax_variables(JMTModel(**cfg),
                               jax.tree.map(np.asarray, variables))
    assert model.fusion_model is None
    with torch.inference_mode():
        got = model(*preprocess(model, {"audio": torch.from_numpy(
            arrays["audio"])}))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=2e-5)


# ---------------------------------------------------------------------------
# model_from_config over the whole lattice
# ---------------------------------------------------------------------------
def _admitted():
    """Every (vision, audio, intra, joint, output) that validate_lattice
    admits for goal TRAINING."""
    for v, a, intra in itertools.product(VISION, AUDIO, INTRA):
        if intra == "None" and (len(v) == 2 or len(a) == 2):
            continue
        for joint, output in HEADS:
            yield v, a, intra, joint, output


def _jax_count(module, *inputs) -> int:
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *inputs)
    return sum(int(np.prod(x.shape)) for x in jax.tree.leaves(
        shapes["params"]))


_SPEC = jax.ShapeDtypeStruct((1, 1, 64, 104, 1), jnp.float32)
_CLIPS = jax.ShapeDtypeStruct((1, 1, 8, 32, 32, 3), jnp.float32)
_WAVLM = jax.ShapeDtypeStruct((1, 1, 768), jnp.float32)
_FEATS = jax.ShapeDtypeStruct((1, 1, 512), jnp.float32)


@pytest.fixture(scope="module")
def jax_counts():
    """The JAX parameter count of every admitted combination, from those
    of its parts: each backbone, each intra-modal module at its input
    widths, each TwoTransformers head, the pretraining head. Two whole
    JAX models pin that sum to the JAX assembly."""
    from jmt_tpu.models import intra_modal as jintra
    from jmt_tpu.models.tsav import TwoStreamBackbones as JTSAV
    backbone = {b: _jax_count(JTSAV(vision_backbones=(b,) if b in (
        "R2D1", "I3D") else (), audio_backbones=(b,) if b == "ResNet18"
        else ()), _SPEC, _CLIPS) for b in ("R2D1", "I3D", "ResNet18")}
    backbone["wavLM"] = 0

    def fc(width):
        return _jax_count(jintra.FcLayer(512),
                          jax.ShapeDtypeStruct((1, 1, width), jnp.float32))

    encoder = {w: _jax_count(jintra.IntraModalTransformerFusion(), _FEATS,
                             jax.ShapeDtypeStruct((1, 1, w), jnp.float32))
               for w in (512, 768)}
    fusions = {h: _jax_count(jfus.TwoTransformers(joint_modalities=h[0],
                                                  output_format=h[1]),
                             _FEATS, _FEATS) for h in HEADS}

    def trunk(v, a, intra):
        n = sum(backbone[b] for b in v + a)
        if len(v) == 2:
            n += fc(1024) if intra == "feat_concat_fc" else encoder[512]
        if len(a) == 2:
            n += fc(1280) if intra == "feat_concat_fc" else encoder[768]
        elif a == ("wavLM",):
            n += fc(768)
        return n

    counts = {c: trunk(*c[:3]) + fusions[c[3:]] for c in _admitted()}
    head = _jax_count(jfus.SingleBackbonePretrainer(), _FEATS)
    for b in SINGLE:
        counts[b] = backbone[b[0]] + head + (fc(768) if b == ("wavLM",)
                                              else 0)
    for c in ((("R2D1", "I3D"), ("ResNet18", "wavLM"),
               "encoder_plus_self_attention", "TRANSFORMER", "SELF_ATTEN"),
              (("R2D1", "I3D"), ("ResNet18", "wavLM"), "feat_concat_fc",
               "NONE", "FC")):
        whole = JJMTModel(vision_backbones=c[0], audio_backbones=c[1],
                          intra_modal_fusion=c[2], joint_modalities=c[3],
                          output_format=c[4])
        assert _jax_count(whole, _SPEC, _CLIPS, _WAVLM) == counts[c], c
    return counts


def _config(v, a, intra="None", joint="TRANSFORMER", output="FC",
            goal="TRAINING", **extra):
    mp = dict(l_vision_backbones=list(v), l_audio_backbones=list(a),
              intra_modal_fusion=intra, joint_modalities=joint,
              output_format=output, compute_dtype="float32")
    mp.update(extra.pop("mp", {}))
    return Config.from_dict(dict(model_params=mp, goal=goal, **extra))


def test_model_from_config_builds_the_whole_lattice(jax_counts):
    combos = list(_admitted())
    assert len(combos) == 110
    for v, a, intra, joint, output in combos:
        model = model_from_config(_config(v, a, intra, joint, output))
        key = (v, a, intra, joint, output)
        assert model.fusion_model.mm_transformer.__class__.__name__ == {
            "NONE": "MultimodalTransformerNoJR", "FC": "FeatureConcatFC",
            "TRANSFORMER": "JointMultimodalTransformer"}[joint], key
        # the reference's visual fusion owns a 768 -> 512 fc that never
        # runs over two 512-d streams; the port keeps it (its keys are
        # the reference's), JAX creates it only for a 768-d input
        unused_fc = 768 * 512 + 512 if (
            len(v) == 2 and intra == "encoder_plus_self_attention") else 0
        assert param_count(model) == jax_counts[key] + unused_fc, key
    for b in SINGLE:
        vis = [x for x in b if x in ("R2D1", "I3D")]
        aud = [x for x in b if x not in vis]
        model = model_from_config(_config(vis, aud, goal="PRETRAINING"))
        assert model.fusion_model is None and model.backbone_pretrainer
        assert param_count(model) == jax_counts[b], b


@pytest.mark.parametrize("bad", [
    dict(goal="PRETRAINING"),                                  # 2 backbones
    dict(v=("R2D1", "I3D")),                                   # no intra
    dict(a=("ResNet18", "wavLM")),                             # no intra
    dict(joint="NONE", output="SELF_ATTEN"),
    dict(v=()),
])
def test_invalid_lattices_are_rejected_on_both_sides(bad):
    from jmt_tpu.core.config import Config as JConfig
    kw = dict(dict(v=("R2D1",), a=("ResNet18",)), **bad)
    with pytest.raises(ValueError):
        _config(kw.pop("v"), kw.pop("a"), **kw)
    kw = dict(dict(v=("R2D1",), a=("ResNet18",)), **bad)
    mp = dict(l_vision_backbones=list(kw.pop("v")),
              l_audio_backbones=list(kw.pop("a")),
              joint_modalities=kw.pop("joint", "TRANSFORMER"),
              output_format=kw.pop("output", "FC"))
    with pytest.raises(AssertionError):
        JConfig.from_dict(dict(model_params=mp, **kw))


@pytest.mark.parametrize("key,value", [
    ("init_w_R2D1", "KINETICS400"), ("init_w_ResNet18", "IMAGENET"),
    ("init_w_I3D", "AFFWILD2"), ("remat_backbones", True),
    ("mesh_data_parallel", 2),
    ("train_params.use_more_vision_data_augm", True),
    ("val_params.use_more_audio_data_augm", True)])
def test_unported_keys_raise(key, value):
    """Keys ported after they raised. ``mesh_data_parallel`` 2: the model
    builds, and the runner's data mesh (``parallel/mesh.make_mesh``)
    raises naming the launch it needs, one process per card, in a run of
    one process. ``init_w_*`` is ported
    (``models/pretrained.py``): the model builds with random backbones,
    and loading the pretrained ones raises without a weights directory,
    as in JAX. ``remat_backbones`` and the heavy augmentations are ported:
    the model builds and takes a train step made as the Runner makes it
    (the flags of ``train_params``; those of ``val_params`` have no
    effect, as in JAX)."""
    extra = {}
    if key.startswith(("train_params", "val_params")):
        split, k = key.split(".")
        extra[split] = {k: value}
    elif key == "mesh_data_parallel":
        extra[key] = value
    else:
        extra["mp"] = {key: value}
    if key == "remat_backbones":
        extra["mp"]["freeze_vision_R2D1"] = False
    vision = ("I3D",) if key == "init_w_I3D" else ("R2D1",)
    cfg = _config(vision, ("ResNet18",), **extra)
    if key.startswith("init_w_"):
        from jmt_tpu_torch.models.pretrained import apply_pretrained
        model = model_from_config(cfg)
        with pytest.raises(ValueError, match="pretrained_weights_dir"):
            apply_pretrained(cfg, model)
        return
    if key == "mesh_data_parallel":
        from jmt_tpu_torch.parallel.mesh import make_mesh
        model_from_config(cfg)
        with pytest.raises(ValueError, match="torch.distributed.run"):
            make_mesh(cfg.mesh_data_parallel, n_dcn=cfg.mesh_dcn)
        return
    _train_step_as_the_runner(cfg, key)


def _train_step_as_the_runner(cfg, key):
    from jmt_tpu_torch.train import loops
    model = model_from_config(cfg)
    if key == "remat_backbones":
        assert model.backbones.remat_whole == ("R2D1", "I3D", "ResNet18")
        stage = model_from_config(dataclasses.replace(
            cfg, model_params=dataclasses.replace(
                cfg.model_params, remat_granularity="stage"))).backbones
        assert stage.remat_whole == ("ResNet18",)
        assert stage.vision_r2d1.r2plus1d.remat_blocks
    tp = cfg.train_params
    flags = dict(more_vision_augm=tp.use_more_vision_data_augm,
                 more_audio_augm=tp.use_more_audio_data_augm)
    assert flags["more_vision_augm"] == (key == "train_params."
                                         "use_more_vision_data_augm")
    assert not flags["more_audio_augm"]
    state = loops.init_state(model, cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    assert ("backbones.vision_r2d1.r2plus1d.stem.0.weight"
            in state.trainable) == (key == "remat_backbones")
    rng = np.random.default_rng(0)
    arrays = {"clips": rng.integers(0, 256, (1, 2, 8, 16, 16, 3),
                                    dtype=np.uint8),
              "audio": (0.1 * rng.normal(size=(1, 2, 45599))).astype(
                  np.float32),
              "labels_v": rng.uniform(-1, 1, (1, 2)).astype(np.float32),
              "labels_a": rng.uniform(-1, 1, (1, 2)).astype(np.float32)}
    gen = torch.Generator().manual_seed(1)
    spec, _ = loops.preprocess(model, {k: torch.from_numpy(x) for k, x in
                                       arrays.items()}, generator=gen,
                               **flags)
    assert spec.shape == (1, 2, 64, 104)   # log-mel: no audio augmentation
    before = {k: v.clone() for k, v in model.state_dict().items()}
    loss, v, a = loops.make_train_step(model, device="cpu", **flags)(
        state, arrays, gen)
    assert torch.isfinite(loss) and v.shape == a.shape == (1, 2)
    after = model.state_dict()
    assert not all(torch.equal(after[n], before[n]) for n in state.trainable)
