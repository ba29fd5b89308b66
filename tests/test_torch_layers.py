"""The port's layers against the JAX package's, on the same numpy inputs.

Tolerances (rel_err = max abs difference over max abs reference):
- f32: 1e-5.  Both sides compute in fp32; only the order of sums differs.
- bf16: 2e-2.  Activations round to bf16 at other places in the two
  frameworks; one bf16 ulp is 2**-8 = 3.9e-3 relative, and a layer rounds a
  few times (the reference's own bf16 tolerance, tests/test_kernels.py:112).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.models import layers as jl
from repro_torch.models import layers as tl

from _torch_parity import (DTYPES, TOL, engines, model_cfg, normal, rel_err,
                           to_np, to_torch)

@pytest.mark.parametrize("dtype", DTYPES)
def test_rms_norm(dtype):
    rng = np.random.default_rng(0)
    x = normal(rng, (2, 5, 64), dtype, 3.0)
    scale = normal(rng, (64,), dtype, 0.1)
    want = jl.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-6)
    got = tl.rms_norm(to_torch(x), to_torch(scale), 1e-6)
    assert got.dtype == getattr(torch, dtype)
    assert rel_err(to_np(got), want) < TOL[dtype]


@pytest.mark.parametrize("theta", [1e4, 1e6])
@pytest.mark.parametrize("dtype", DTYPES)
def test_rope(dtype, theta):
    rng = np.random.default_rng(1)
    pos = np.broadcast_to(np.arange(7)[None] + 3, (2, 7)).astype(np.int32)
    sin_j, cos_j = jl.rope_angles(jnp.asarray(pos), 32, theta)
    sin_t, cos_t = tl.rope_angles(torch.from_numpy(pos.copy()), 32, theta)
    assert rel_err(to_np(sin_t), sin_j) < 1e-5
    assert rel_err(to_np(cos_t), cos_j) < 1e-5
    x = normal(rng, (2, 7, 4, 32), dtype)
    want = jl.apply_rope(jnp.asarray(x), sin_j, cos_j)
    got = tl.apply_rope(to_torch(x), sin_t, cos_t)
    assert rel_err(to_np(got), want) < TOL[dtype]


@pytest.mark.parametrize("head_dim,theta", [(16, 1e4), (128, 1e6)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_mrope_three_streams(dtype, head_dim, theta):
    """M-RoPE with temporal, height and width positions that differ (an
    image grid's; serving passes t = h = w), split by mrope_sections."""
    from repro.models.transformer import mrope_sections as j_sections
    from repro_torch.models.transformer import mrope_sections
    sections = mrope_sections(head_dim)
    assert sections == j_sections(head_dim)
    rng = np.random.default_rng(5)
    pos = np.stack([np.broadcast_to(np.arange(7) + 3, (2, 7)),
                    rng.integers(0, 16, (2, 7)), rng.integers(0, 16, (2, 7))]).astype(np.int32)
    sin_j, cos_j = jl.rope_angles(jnp.asarray(pos), head_dim, theta, sections)
    sin_t, cos_t = tl.rope_angles(torch.from_numpy(pos), head_dim, theta, sections)
    assert sin_t.shape == (2, 7, head_dim // 2)
    assert rel_err(to_np(sin_t), sin_j) < 1e-5
    assert rel_err(to_np(cos_t), cos_j) < 1e-5
    x = normal(rng, (2, 7, 4, head_dim), dtype)
    want = jl.apply_rope(jnp.asarray(x), sin_j, cos_j)
    got = tl.apply_rope(to_torch(x), sin_t, cos_t)
    assert rel_err(to_np(got), want) < TOL[dtype]


@pytest.mark.parametrize("softcap", [0.0, 5.0])
@pytest.mark.parametrize("chunks", [(16, 32), (64, 64)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_chunked_causal_attention(dtype, chunks, softcap):
    rng = np.random.default_rng(2)
    q, k, v = (normal(rng, (2, 4, 64, 16), dtype) for _ in range(3))
    kw = dict(scale=16 ** -0.5, q_chunk=chunks[0], kv_chunk=chunks[1],
              logit_softcap=softcap)
    want = jl.chunked_causal_attention(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), **kw)
    got = tl.chunked_causal_attention(to_torch(q), to_torch(k), to_torch(v), **kw)
    assert rel_err(to_np(got), want) < TOL[dtype]


@pytest.mark.parametrize("kind", ["xla", "pallas_rasa"])
@pytest.mark.parametrize("act,fused", [("swiglu", False), ("swiglu", True),
                                       ("geglu", False), ("geglu", True),
                                       ("relu2", False), ("gelu", False)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_mlp_block(dtype, act, fused, kind):
    m, tm = model_cfg("qwen3-1.7b", dtype, act=act, fuse_gate_up=fused)
    je, te = engines(kind)
    rng = np.random.default_rng(4)
    d, f = m.d_model, m.d_ff
    p = {"w_down": normal(rng, (f, d), dtype, f ** -0.5)}
    if fused:
        p["w_gate_up"] = normal(rng, (d, 2, f), dtype, d ** -0.5)
    else:
        p["w_up"] = normal(rng, (d, f), dtype, d ** -0.5)
        if act in ("swiglu", "geglu"):
            p["w_gate"] = normal(rng, (d, f), dtype, d ** -0.5)
    x = normal(rng, (2, 5, d), dtype)
    want = jl.mlp_block({n: jnp.asarray(a) for n, a in p.items()},
                        jnp.asarray(x), m, je)
    got = tl.mlp_block({n: to_torch(a) for n, a in p.items()}, to_torch(x), tm, te)
    assert got.dtype == getattr(torch, dtype)
    assert rel_err(to_np(got), want) < TOL[dtype]


def test_gqa_expand():
    x = torch.arange(2 * 2 * 3).reshape(2, 2, 3)
    got = tl.gqa_expand(x, 4)
    want = jl.gqa_expand(jnp.asarray(x.numpy()), 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
