"""Port fusion modules against the JAX package, fp32, atol 1e-5.

Each JAX module is initialised from a seed, its variables are carried into
the port module with ``convert.load_jax_variables`` (strict load), and both
run on the same numpy inputs.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from jmt_tpu.models import encoder as jenc
from jmt_tpu.models import fusion as jfus
from jmt_tpu.models import intra_modal as jintra
from jmt_tpu.models import jmt as jjmt
from jmt_tpu.ops import attention as jattn
from jmt_tpu_torch.models import encoder, fusion, intra_modal, jmt
from jmt_tpu_torch.models.common import l2_normalize
from jmt_tpu_torch.models.convert import load_jax_variables
from jmt_tpu_torch.ops import attention

torch.set_num_threads(2)
ATOL = 1e-5


def _x(*shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _check(jax_module, port_module, *inputs, seed=0):
    variables = jax.jit(jax_module.init)(jax.random.PRNGKey(seed), *inputs)
    want = jax.jit(jax_module.apply)(variables, *inputs)
    load_jax_variables(port_module, jax.tree.map(np.asarray, variables))
    with torch.inference_mode():
        got = port_module(*map(torch.from_numpy, inputs))
    for g, w in zip(*((got, want) if isinstance(got, tuple)
                      else ((got,), (want,)))):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=ATOL)


@pytest.mark.parametrize("heads", [1, 4])
def test_multihead_attention(heads):
    q, kv = _x(2, 5, 512), _x(2, 7, 512, seed=1)
    _check(jattn.MultiheadAttention(512, heads),
           attention.MultiheadAttention(512, heads), q, kv, kv)


def test_encoder_block_two_layers():
    _check(jenc.TransformerEncoderBlock(512, 1, 512, 2),
           encoder.TransformerEncoderBlock(512, 1, 512, 2), _x(3, 6, 512))


@pytest.mark.parametrize("dims", [(512, 768), (512, 512)])
def test_intra_modal_fusion(dims):
    a, b = _x(2, 4, dims[0]), _x(2, 4, dims[1], seed=1)
    jm = jintra.IntraModalTransformerFusion()
    pm = intra_modal.IntraModalTransformerFusion()
    if dims[1] == 512:  # the 768 -> 512 reducer is created but unused
        variables = jax.jit(jm.init)(jax.random.PRNGKey(0), a, _x(2, 4, 768))
        load_jax_variables(pm, jax.tree.map(np.asarray, variables))
        want = jm.apply(variables, a, b)
        with torch.inference_mode():
            got = pm(torch.from_numpy(a), torch.from_numpy(b))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=ATOL)
    else:
        _check(jm, pm, a, b)


def test_fc_layer():
    _check(jintra.FcLayer(512), intra_modal.FcLayer(768),
           _x(2, 4, 768))


def test_joint_multimodal_transformer_self_atten():
    _check(jjmt.JointMultimodalTransformer(output_format="SELF_ATTEN"),
           jmt.JointMultimodalTransformer(),
           _x(2, 4, 512), _x(2, 4, 512, seed=1))


def test_two_transformers():
    _check(jfus.TwoTransformers(joint_modalities="TRANSFORMER",
                                output_format="SELF_ATTEN"),
           fusion.TwoTransformers(), 3.0 * _x(2, 4, 512),
           _x(2, 4, 512, seed=1))


def test_l2_normalize_matches_jax():
    from jmt_tpu.models.common import l2_normalize as jl2
    x = _x(3, 4, 512)
    x[0, 0] = 0.0  # the eps branch
    np.testing.assert_allclose(l2_normalize(torch.from_numpy(x)).numpy(),
                               np.asarray(jl2(jnp.asarray(x))), rtol=0,
                               atol=1e-7)

