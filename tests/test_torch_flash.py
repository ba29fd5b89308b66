"""The port's flash attention entry point against the JAX package's, on the
same numpy inputs.  On the CPU the port's ``flash_mha`` runs the kernel's
plain version (``flash_attention_plain``); the reference's runs its Pallas
kernel in interpret mode, as tests/test_kernels.py runs it.

Tolerances are the reference's (tests/test_kernels.py:112,121): rel_err
(max abs difference over max abs reference) < 2e-2 with bf16 inputs and
outputs (one bf16 ulp is 3.9e-3; the outputs round in two frameworks), and
< 1e-5 with f32 inputs (only the order of sums differs).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels import flash_mha as j_flash_mha
from repro.kernels.ref import ref_attention as j_ref_attention
from repro.kernels.ref import ref_decode_attention as j_ref_decode_attention
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_mha, ref

from _torch_parity import normal, rel_err, to_np, to_torch

BLOCKS = dict(block_q=128, block_kv=128)


def both(q, k, v, **kw):
    """(port, reference) outputs of flash_mha on the same numpy inputs."""
    got = flash_mha(to_torch(q), to_torch(k), to_torch(v), **kw)
    want = j_flash_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)
    assert got.dtype == to_torch(q).dtype
    return to_np(got), np.asarray(want, np.float32)


@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2), (8, 1)])
@pytest.mark.parametrize("sq", [128, 257, 384])
def test_flash_mha_causal_sweep_bf16(hq, hkv, sq):
    """The reference's own sweep (GQA, MQA, a ragged length padded to 512)."""
    rng = np.random.default_rng(sq * hq)
    q = normal(rng, (2, hq, sq, 64), "bfloat16")
    k = normal(rng, (2, hkv, sq, 64), "bfloat16")
    v = normal(rng, (2, hkv, sq, 64), "bfloat16")
    got, want = both(q, k, v, **BLOCKS)
    assert rel_err(got, want) < 2e-2


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("shape,kw", [
    ((1, 2, 256, 128, 2), BLOCKS),                        # f32 D=128, two blocks
    ((1, 2, 128, 64, 2), dict(scale=0.5, **BLOCKS)),      # a given scale
    ((2, 4, 257, 80, 4), {}),                             # zamba2's head dim, padded
    ((1, 4, 200, 80, 2), dict(block_q=64, block_kv=128)),  # q blocks < kv blocks
], ids=["d128", "scale", "d80", "uneven-blocks"])
def test_flash_mha_matches_reference(shape, kw, dtype, tol):
    b, hq, s, d, hkv = shape
    rng = np.random.default_rng(s + d)
    q = normal(rng, (b, hq, s, d), dtype)
    k = normal(rng, (b, hkv, s, d), dtype)
    v = normal(rng, (b, hkv, s, d), dtype)
    got, want = both(q, k, v, **kw)
    assert rel_err(got, want) < tol


def test_flash_mha_non_causal():
    """No padding needed: plain softmax attention; S below the block: both
    pad; with padding needed past that, both refuse, as the reference's
    assert does."""
    rng = np.random.default_rng(7)
    q, k, v = (normal(rng, (1, 2, 256, 32), "float32") for _ in range(3))
    got, want = both(q, k, v, causal=False, **BLOCKS)
    assert rel_err(got, want) < 1e-5
    np.testing.assert_allclose(
        got, np.asarray(j_ref_attention(q, k, v, causal=False)), rtol=1e-5, atol=1e-5)
    # the reference's assert lets S < block through and pads to 128: the
    # padded kv positions count as (unmasked) zero keys on both sides
    q, k, v = (normal(rng, (1, 2, 100, 32), "float32") for _ in range(3))
    got, want = both(q, k, v, causal=False, **BLOCKS)
    assert rel_err(got, want) < 1e-5
    q, k, v = (normal(rng, (1, 2, 257, 32), "float32") for _ in range(3))
    with pytest.raises(ValueError, match="causality"):
        flash_mha(to_torch(q), to_torch(k), to_torch(v), causal=False, **BLOCKS)
    with pytest.raises(AssertionError):
        j_flash_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=False,
                    **BLOCKS)


@pytest.mark.parametrize("d", [1, 33, 64, 80, 128, 256, 0, 257])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.float16])
def test_flash_route(dtype, d):
    """bf16 takes the tensor-core kernel at every head dim the kernels take,
    f32 the SIMT fp32 one; other types and head dims are refused."""
    if not 0 < d <= fa.MAX_HEAD_DIM:
        with pytest.raises(ValueError, match="head dim"):
            fa.flash_route(dtype, d)
    elif dtype == torch.float16:
        with pytest.raises(TypeError):
            fa.flash_route(dtype, d)
    else:
        assert fa.flash_route(dtype, d) == ("tc" if dtype == torch.bfloat16 else "simt")


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,skv", [(64, 64), (16, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ref_attention(dtype, sq, skv, causal):
    """The oracle, GQA 8/2, with its bottom-right aligned causal mask."""
    rng = np.random.default_rng(sq + skv)
    q = normal(rng, (2, 8, sq, 32), dtype)
    k = normal(rng, (2, 2, skv, 32), dtype)
    v = normal(rng, (2, 2, skv, 32), dtype)
    got = ref.ref_attention(to_torch(q), to_torch(k), to_torch(v), causal=causal)
    want = j_ref_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal)
    assert rel_err(to_np(got), want) < (1e-5 if dtype == "float32" else 2e-2)


@pytest.mark.parametrize("lengths", [None, [64, 17]])
def test_ref_decode_attention(lengths):
    rng = np.random.default_rng(5)
    q = normal(rng, (2, 8, 32), "float32")
    k = normal(rng, (2, 2, 64, 32), "float32")
    v = normal(rng, (2, 2, 64, 32), "float32")
    lt = None if lengths is None else torch.tensor(lengths)
    lj = None if lengths is None else jnp.asarray(lengths)
    got = ref.ref_decode_attention(to_torch(q), to_torch(k), to_torch(v), lt)
    want = j_ref_decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), lj)
    assert rel_err(to_np(got), want) < 1e-5
    # the decode oracle is the full oracle's last position (test_kernels.py:134)
    if lengths is None:
        full = ref.ref_attention(to_torch(q)[:, :, None], to_torch(k), to_torch(v),
                                 causal=False)
        np.testing.assert_allclose(to_np(full[:, :, 0]), to_np(got), rtol=1e-5, atol=1e-5)
