"""The ssm / hybrid family against the JAX package's: the causal conv and
the Mamba2 block (prefill carrying a state through two chunks, and the
single-token decode step), then serving parity of the mamba2-130m and
zamba2-2.7b smoke models under the xla and pallas_rasa (wls) engines, with
the reference's weights carried over through params_from_jax.

Tolerances: layers as tests/test_torch_layers.py (rel_err < 1e-5 in f32,
< 2e-2 in bf16); models as tests/test_torch_serving.py (f32 logits
rel_err < 1e-5 and identical greedy tokens; bf16 logits within the
reference's decode-vs-prefill tolerance, rtol = atol = 0.15).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import ssm as jssm
from repro_torch.configs import get_config as t_get_config
from repro_torch.models import ssm as tssm

from _torch_parity import (DTYPES, TOL, engines, normal, port_model, port_outputs,
                           reference, rel_err, to_np, to_torch)

ARCHS = ["mamba2-130m", "zamba2-2.7b"]
F32_TOL = 1e-5
BF16_TOL = 0.15
#: the two engines the family is held under: (name, kind, schedule)
SSM_ENGINES = [("xla", "xla", "wls"), ("wls", "pallas_rasa", "wls")]

j_mamba2_block = jax.jit(jssm.mamba2_block, static_argnums=(2, 3))


def cfgs(dtype, chunk=8):
    """(reference, port) ModelConfig of mamba2 smoke in ``dtype``, with a
    chunk of 8 so that a 16-token prefill runs two chunks."""
    out = []
    for get in (j_get_config, t_get_config):
        m = get("mamba2-130m", smoke=True).model
        out.append(dataclasses.replace(m, dtype=dtype,
                                       ssm=dataclasses.replace(m.ssm, chunk=chunk)))
    return out


def block_params(rng, m, dtype):
    d = m.d_model
    d_inner, n_heads, conv_ch = jssm.ssm_dims(m)
    proj = 2 * d_inner + 2 * m.ssm.n_groups * m.ssm.d_state + n_heads
    return {"in_proj": normal(rng, (d, proj), dtype, d ** -0.5),
            "conv_w": normal(rng, (m.ssm.d_conv, conv_ch), dtype, 0.5),
            "conv_b": normal(rng, (conv_ch,), dtype, 0.1),
            "dt_bias": np.log(np.expm1(np.linspace(0.001, 0.1, n_heads))).astype(np.float32),
            "A_log": np.log(np.arange(1, n_heads + 1)).astype(np.float32),
            "D_skip": normal(rng, (n_heads,), "float32", 1.0),
            "ssm_norm": normal(rng, (d_inner,), dtype, 0.1),
            "out_proj": normal(rng, (d_inner, d), dtype, d_inner ** -0.5)}


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_causal_conv(dtype, with_state):
    rng = np.random.default_rng(1)
    x = normal(rng, (2, 5, 12), dtype)
    w = normal(rng, (4, 12), dtype, 0.5)
    b = normal(rng, (12,), dtype, 0.1)
    st = normal(rng, (2, 3, 12), dtype) if with_state else None
    want, want_st = jssm._causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                      None if st is None else jnp.asarray(st))
    got, got_st = tssm._causal_conv(to_torch(x), to_torch(w), to_torch(b),
                                    None if st is None else to_torch(st))
    assert rel_err(to_np(got), want) < TOL[dtype]
    np.testing.assert_array_equal(to_np(got_st), np.asarray(want_st, np.float32))


@pytest.mark.parametrize("kind", ["xla", "pallas_rasa"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_mamba2_block_prefill_then_decode(dtype, kind):
    """No state (the training form); prefill of 16 tokens (two chunks) from
    a nonzero state; then one decode step from the prefill's state: outputs
    and both parts of the state against the reference."""
    m, tm = cfgs(dtype)
    je, te = engines(kind)
    rng = np.random.default_rng(2)
    p = block_params(rng, m, dtype)
    jp = {n: jnp.asarray(a) for n, a in p.items()}
    tp = {n: to_torch(a) for n, a in p.items()}
    b, s = 2, 16
    x = normal(rng, (b, s + 1, m.d_model), dtype)
    _, n_heads, conv_ch = jssm.ssm_dims(m)
    conv0 = normal(rng, (b, m.ssm.d_conv - 1, conv_ch), dtype)
    ssm0 = normal(rng, (b, n_heads, m.ssm.head_dim, m.ssm.d_state), "float32", 0.1)

    want0, none = j_mamba2_block(jp, jnp.asarray(x[:, :s]), m, je)
    got0, tnone = tssm.mamba2_block(tp, to_torch(x[:, :s]), tm, te)
    assert none is None and tnone is None
    assert rel_err(to_np(got0), want0) < TOL[dtype]

    jst = jssm.SSMState(jnp.asarray(conv0), jnp.asarray(ssm0))
    tst = tssm.SSMState(to_torch(conv0), to_torch(ssm0))
    want1, jst = j_mamba2_block(jp, jnp.asarray(x[:, :s]), m, je, jst)
    got1, tst = tssm.mamba2_block(tp, to_torch(x[:, :s]), tm, te, tst)
    assert rel_err(to_np(got1), want1) < TOL[dtype]
    np.testing.assert_array_equal(to_np(tst.conv), np.asarray(jst.conv, np.float32))
    assert rel_err(to_np(tst.ssm), jst.ssm) < TOL[dtype]

    want2, jst = j_mamba2_block(jp, jnp.asarray(x[:, s:]), m, je, jst)
    got2, tst = tssm.mamba2_block(tp, to_torch(x[:, s:]), tm, te, tst)
    assert rel_err(to_np(got2), want2) < TOL[dtype]
    np.testing.assert_array_equal(to_np(tst.conv), np.asarray(jst.conv, np.float32))
    assert tst.ssm.dtype == torch.float32
    assert rel_err(to_np(tst.ssm), jst.ssm) < TOL[dtype]


# --------------------------------------------------------------- serving

_refs, _outputs = {}, {}


def ref_of(arch, dtype):
    """The reference's weights and outputs, computed once per module."""
    if (arch, dtype) not in _refs:
        _refs[arch, dtype] = reference(arch, dtype)
    return _refs[arch, dtype]


def outputs(arch, dtype, kind, schedule):
    """The port's outputs under one engine, computed once per module."""
    key = (arch, dtype, kind, schedule)
    if key not in _outputs:
        ref = ref_of(arch, dtype)
        _outputs[key] = port_outputs(port_model(arch, dtype, ref["tree"], kind, schedule),
                                     ref["tokens_in"])
    return _outputs[key]


@pytest.mark.parametrize("name,kind,schedule", SSM_ENGINES)
@pytest.mark.parametrize("arch", ARCHS)
def test_f32_prefill_and_decode_logits(arch, name, kind, schedule):
    ref = ref_of(arch, "float32")
    out = outputs(arch, "float32", kind, schedule)
    assert rel_err(out["prefill"], ref["prefill"]) < F32_TOL
    for got, want in zip(out["decode"], ref["decode"]):
        assert rel_err(got, want) < F32_TOL


@pytest.mark.parametrize("name,kind,schedule", SSM_ENGINES)
@pytest.mark.parametrize("arch", ARCHS)
def test_f32_greedy_tokens(arch, name, kind, schedule):
    ref = ref_of(arch, "float32")
    out = outputs(arch, "float32", kind, schedule)
    np.testing.assert_array_equal(out["tokens"], ref["generate"]["xla"])
    np.testing.assert_array_equal(out["tokens"], ref["generate"]["pallas_rasa"])


@pytest.mark.parametrize("name,kind,schedule", SSM_ENGINES)
@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_logits(arch, name, kind, schedule):
    ref = ref_of(arch, "bfloat16")
    out = outputs(arch, "bfloat16", kind, schedule)
    np.testing.assert_allclose(out["prefill"], ref["prefill"], rtol=BF16_TOL,
                               atol=BF16_TOL)
    for got, want in zip(out["decode"], ref["decode"]):
        np.testing.assert_allclose(got, want, rtol=BF16_TOL, atol=BF16_TOL)
    # the port's own decode path reproduces its prefill (state correctness)
    np.testing.assert_allclose(out["decode"][-1], out["prefill"], rtol=BF16_TOL,
                               atol=BF16_TOL)


def test_params_from_jax_keeps_dtypes():
    """Stacked layer leaves are unstacked per layer, the shared block stays
    one dict, f32 leaves stay f32 and bf16 leaves are copied bit for bit."""
    ref = ref_of("zamba2-2.7b", "bfloat16")
    model = port_model("zamba2-2.7b", "bfloat16", ref["tree"], "xla", "wls")
    tree = ref["tree"]
    assert len(model.layers) == tree["layers"]["in_proj"].shape[0]
    for name in ("dt_bias", "A_log", "D_skip"):
        assert model.layers[1][name].dtype == torch.float32
        np.testing.assert_array_equal(model.layers[1][name].numpy(), tree["layers"][name][1])
    np.testing.assert_array_equal(
        model.layers[1]["in_proj"].view(torch.int16).numpy(),
        tree["layers"]["in_proj"][1].view(np.int16))
    np.testing.assert_array_equal(model.shared_attn["wq"].view(torch.int16).numpy(),
                                  tree["shared_attn"]["wq"].view(np.int16))
