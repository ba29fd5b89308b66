"""The port's fused SSD entry point and chunked SSD against the JAX
package's, on the same numpy inputs.  On the CPU the port's
``ssd_chunk_fused`` runs the kernel's plain version; the reference's runs
its Pallas kernel in interpret mode, as tests/test_ssd_kernel.py runs it.

Tolerances: the fused scan at the reference's own, assert_allclose
rtol = atol = 2e-5 in f32 (tests/test_ssd_kernel.py:37) and rel_err < 3e-2
with bf16 inputs (:55); ``ssd_chunked`` at rel_err < 1e-5 in f32 (order of
sums) and < 2e-2 in bf16, where both round to bf16 at the same places but
sum in other orders (tests/test_torch_layers.py).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels import hbm_bytes_fused as j_hbm_bytes_fused
from repro.kernels import ssd_chunk_fused as j_ssd_chunk_fused
from repro.models.ssm import ssd_chunked as j_ssd_chunked
from repro_torch.kernels import hbm_bytes_fused, ssd_chunk_fused
from repro_torch.models.ssm import ssd_chunked

from _torch_parity import TOL, normal, rel_err, to_np, to_torch


def fused_inputs(rng, bh, s, p, n, dtype):
    x = normal(rng, (bh, s, p), dtype)
    dt = rng.uniform(0.01, 0.2, size=(bh, s)).astype(np.float32)
    a = (-rng.uniform(0.5, 2.0, size=(bh,))).astype(np.float32)
    b = normal(rng, (bh, s, n), dtype)
    c = normal(rng, (bh, s, n), dtype)
    return x, dt, a, b, c


@pytest.mark.parametrize("shape", [(2, 64, 8, 8), (3, 128, 16, 8), (1, 256, 32, 16)])
@pytest.mark.parametrize("chunk", [16, 32])
def test_fused_matches_reference_f32(shape, chunk):
    """The reference's shape x chunk sweep: y and the final state [BH, N, P]."""
    rng = np.random.default_rng(sum(shape) + chunk)
    args = fused_inputs(rng, *shape, "float32")
    y, fin = ssd_chunk_fused(*map(to_torch, args), chunk=chunk)
    want_y, want_fin = j_ssd_chunk_fused(*map(jnp.asarray, args), chunk=chunk,
                                         interpret=True)
    assert tuple(fin.shape) == (shape[0], shape[3], shape[2])
    np.testing.assert_allclose(to_np(y), np.asarray(want_y), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(to_np(fin), np.asarray(want_fin), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("dt_dtype", ["float32", "bfloat16"])
def test_fused_matches_reference_bf16(dt_dtype):
    rng = np.random.default_rng(0)
    x, dt, a, b, c = fused_inputs(rng, 2, 64, 16, 8, "bfloat16")
    dt = dt.astype(jnp.dtype(dt_dtype))
    y, fin = ssd_chunk_fused(*map(to_torch, (x, dt, a, b, c)), chunk=32)
    want_y, want_fin = j_ssd_chunk_fused(*map(jnp.asarray, (x, dt, a, b, c)), chunk=32,
                                         interpret=True)
    assert y.dtype == torch.bfloat16 and fin.dtype == torch.float32
    assert rel_err(to_np(y), want_y) < 3e-2
    assert rel_err(to_np(fin), want_fin) < 3e-2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,chunk", [((2, 512, 16, 8), 32), ((2, 96, 16, 8), 48)],
                         ids=["16-chunks", "chunk-48"])
def test_fused_edges_match_reference(shape, chunk, dtype):
    """The CUDA design's edges, on the plain version: sixteen chunks (the
    recurrence over the chunks runs long) and a chunk that is no multiple
    of the kernels' 64-row tiles, at the reference's tolerances."""
    rng = np.random.default_rng(shape[1] + chunk)
    args = fused_inputs(rng, *shape, dtype)
    y, fin = ssd_chunk_fused(*map(to_torch, args), chunk=chunk)
    want_y, want_fin = j_ssd_chunk_fused(*map(jnp.asarray, args), chunk=chunk,
                                         interpret=True)
    if dtype == "float32":
        np.testing.assert_allclose(to_np(y), np.asarray(want_y), rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(to_np(fin), np.asarray(want_fin), rtol=2e-5, atol=2e-5)
    else:
        assert rel_err(to_np(y), want_y) < 3e-2
        assert rel_err(to_np(fin), want_fin) < 3e-2


def test_fused_matches_chunked_oracle():
    """The fused scan against the port's own ssd_chunked run per head, as the
    reference's _oracle does (tests/test_ssd_kernel.py:12-21)."""
    rng = np.random.default_rng(3)
    x, dt, a, b, c = map(to_torch, fused_inputs(rng, 3, 128, 16, 8, "float32"))
    y, fin = ssd_chunk_fused(x, dt, a, b, c, chunk=32)
    # heads as the h axis of one batch row: no head sees another's inputs
    want_y, want_fin = ssd_chunked(x.transpose(0, 1)[None], dt.T[None], a,
                                   b.transpose(0, 1)[None], c.transpose(0, 1)[None],
                                   chunk=32)
    torch.testing.assert_close(y, want_y[0].transpose(0, 1), rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(fin, want_fin[0].transpose(1, 2), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("init", [False, True], ids=["zero-state", "init-state"])
@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_chunked_matches_reference(dtype, groups, init):
    """Three chunks, 4 heads over ``groups`` groups of B/C, optionally from a
    carried state: y and the final state [b, h, p, n]."""
    rng = np.random.default_rng(groups + 2 * init)
    b, s, h, p, n, chunk = 2, 48, 4, 8, 16, 16
    x = normal(rng, (b, s, h, p), dtype)
    dt = rng.uniform(0.01, 0.2, size=(b, s, h)).astype(np.float32)
    A = (-rng.uniform(0.5, 2.0, size=(h,))).astype(np.float32)
    B = normal(rng, (b, s, groups, n), dtype)
    C = normal(rng, (b, s, groups, n), dtype)
    st = normal(rng, (b, h, p, n), "float32") if init else None
    y, fin = ssd_chunked(*map(to_torch, (x, dt, A, B, C)), chunk,
                         None if st is None else to_torch(st))
    want_y, want_fin = j_ssd_chunked(*map(jnp.asarray, (x, dt, A, B, C)), chunk,
                                     None if st is None else jnp.asarray(st))
    assert y.dtype == to_torch(x).dtype and fin.dtype == torch.float32
    assert rel_err(to_np(y), want_y) < TOL[dtype]
    assert rel_err(to_np(fin), want_fin) < TOL[dtype]


@pytest.mark.parametrize("args", [(16 * 80, 4096, 64, 64, 2), (96, 512, 64, 128, 2),
                                  (3, 128, 16, 8, 4)])
def test_hbm_bytes_fused(args):
    assert hbm_bytes_fused(*args) == j_hbm_bytes_fused(*args)
