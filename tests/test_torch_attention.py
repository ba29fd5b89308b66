"""The port's attention block against the JAX package's: prefill (with
and without writing the cache) and one decode step, on the same numpy
inputs.  GQA (qwen3 smoke, qk-norm), MQA (gemma smoke) and a logit softcap.

Tolerances as in test_torch_layers.py: rel_err < 1e-5 in f32 (order of
sums), < 2e-2 in bf16 (rounding at other places).
"""

import jax
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.models import layers as jl
from repro_torch.models import layers as tl

from _torch_parity import (DTYPES, TOL, engines, model_cfg, normal, rel_err,
                           to_np, to_torch)

#: the reference's block, compiled once per (config, engine, shapes)
j_attention_block = jax.jit(jl.attention_block, static_argnums=(2, 3))


def attn_params(rng, m, dtype):
    d, hd = m.d_model, m.resolved_head_dim
    p = {"wq": normal(rng, (d, m.n_heads * hd), dtype, d ** -0.5),
         "wk": normal(rng, (d, m.n_kv_heads * hd), dtype, d ** -0.5),
         "wv": normal(rng, (d, m.n_kv_heads * hd), dtype, d ** -0.5),
         "wo": normal(rng, (m.n_heads * hd, d), dtype, (m.n_heads * hd) ** -0.5)}
    if m.qk_norm:
        p["q_norm"] = normal(rng, (hd,), dtype, 0.1)
        p["k_norm"] = normal(rng, (hd,), dtype, 0.1)
    return p


@pytest.mark.parametrize("kind", ["xla", "pallas_rasa"])
@pytest.mark.parametrize("arch,softcap", [("qwen3-1.7b", 0.0), ("gemma-2b", 0.0),
                                          ("qwen3-1.7b", 5.0)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_attention_block_prefill_then_decode(dtype, arch, softcap, kind):
    """Prefill of 6 positions (writing the cache from 0), then one decode
    step at position 6: outputs and cache contents against the reference."""
    m, tm = model_cfg(arch, dtype, softcap)
    je, te = engines(kind)
    rng = np.random.default_rng(3)
    p = attn_params(rng, m, dtype)
    jp = {n: jnp.asarray(a) for n, a in p.items()}
    tp = {n: to_torch(a) for n, a in p.items()}
    b, s, smax, hd = 2, 6, 16, m.resolved_head_dim
    x = normal(rng, (b, s + 1, m.d_model), dtype)

    pos = np.broadcast_to(np.arange(s + 1)[None], (b, s + 1)).astype(np.int32)
    sin_j, cos_j = jl.rope_angles(jnp.asarray(pos), hd, m.rope_theta)
    sin_t, cos_t = tl.rope_angles(torch.from_numpy(pos.copy()), hd, m.rope_theta)

    shape = (b, m.n_kv_heads, smax, hd)
    jcache = jl.KVCache(jnp.zeros(shape, jnp.dtype(dtype)),
                        jnp.zeros(shape, jnp.dtype(dtype)), jnp.asarray(0, jnp.int32))
    tcache = tl.KVCache(torch.zeros(shape, dtype=getattr(torch, dtype)),
                        torch.zeros(shape, dtype=getattr(torch, dtype)),
                        torch.zeros((), dtype=torch.int32))

    # prefill: without a cache (training form), and writing the cache
    want0, _ = j_attention_block(jp, jnp.asarray(x[:, :s]), m, je,
                                  sin_j[:, :s], cos_j[:, :s])
    got0, none = tl.attention_block(tp, to_torch(x[:, :s]), tm, te,
                                    sin_t[:, :s], cos_t[:, :s])
    assert none is None
    assert rel_err(to_np(got0), want0) < TOL[dtype]
    want1, jcache = j_attention_block(jp, jnp.asarray(x[:, :s]), m, je,
                                       sin_j[:, :s], cos_j[:, :s], jcache)
    got1, tcache = tl.attention_block(tp, to_torch(x[:, :s]), tm, te,
                                      sin_t[:, :s], cos_t[:, :s], tcache)
    assert rel_err(to_np(got1), want1) < TOL[dtype]
    assert tcache.length == int(jcache.length) == s

    # decode one token at position s
    want2, jcache = j_attention_block(jp, jnp.asarray(x[:, s:]), m, je,
                                       sin_j[:, s:], cos_j[:, s:], jcache)
    got2, tcache = tl.attention_block(tp, to_torch(x[:, s:]), tm, te,
                                      sin_t[:, s:], cos_t[:, s:], tcache)
    assert rel_err(to_np(got2), want2) < TOL[dtype]
    assert tcache.length == int(jcache.length) == s + 1
    assert rel_err(to_np(tcache.k), jcache.k) < TOL[dtype]
    assert rel_err(to_np(tcache.v), jcache.v) < TOL[dtype]
