"""The port's RASA GEMM against the JAX package's.

On the CPU the port's ``rasa_matmul`` takes the plain PyTorch version; the
reference runs its Pallas kernel in interpret mode.  Same numpy inputs, the
reference's sweeps (tests/test_kernels.py) and its tolerance,
rel_err < 1e-5.  ``test_torch_cuda.py`` holds the CUDA kernels against the
plain version on the card.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels import GemmBlocks as JGemmBlocks
from repro.kernels import default_blocks as j_default_blocks
from repro.kernels import rasa_matmul as j_rasa_matmul
from repro.kernels import schedule_cost as j_schedule_cost
from repro_torch.kernels import (SCHEDULES, GemmBlocks, default_blocks,
                                 rasa_matmul, schedule_cost)
from repro_torch.kernels.rasa_gemm import rasa_gemm, rasa_gemm_plain
from repro_torch.kernels.ref import ref_matmul, ref_matmul_accum

SMALL = GemmBlocks(128, 128, 128)
J_SMALL = JGemmBlocks(128, 128, 128)


def rel_err(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-6)


def to_torch(x: np.ndarray) -> torch.Tensor:
    if x.dtype == jnp.bfloat16:
        return torch.from_numpy(x.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(x.copy())


def both(a, b, c=None, schedule="wls"):
    """(port, reference) results on the same numpy inputs, as f32 numpy."""
    got = rasa_matmul(to_torch(a), to_torch(b),
                      None if c is None else to_torch(c),
                      schedule=schedule, blocks=SMALL)
    want = j_rasa_matmul(a, b, c, schedule=schedule, blocks=J_SMALL)
    return got.numpy(), np.asarray(want, np.float32)


@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("shape", [(128, 128, 128), (256, 384, 256),
                                   (257, 130, 100), (64, 512, 64),
                                   (1, 256, 256)])
def test_gemm_shapes_match_reference(schedule, shape):
    m, k, n = shape
    rng = np.random.default_rng(m * 1000 + k * 10 + n)
    a = rng.normal(size=(m, k)).astype(jnp.bfloat16)
    b = rng.normal(size=(k, n)).astype(jnp.bfloat16)
    got, want = both(a, b, schedule=schedule)
    assert got.shape == (m, n)
    assert rel_err(got, want) < 1e-5


@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("dtype", [jnp.bfloat16, np.float32])
def test_gemm_dtypes_match_reference(schedule, dtype):
    rng = np.random.default_rng(7)
    a = rng.normal(size=(130, 260)).astype(dtype)
    b = rng.normal(size=(260, 140)).astype(dtype)
    got, want = both(a, b, schedule=schedule)
    assert got.dtype == np.float32
    assert rel_err(got, want) < 1e-5


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_gemm_accumulates_into_c_matches_reference(schedule):
    rng = np.random.default_rng(3)
    a = rng.normal(size=(128, 256)).astype(jnp.bfloat16)
    b = rng.normal(size=(256, 128)).astype(jnp.bfloat16)
    c = rng.normal(size=(128, 128)).astype(np.float32)
    got, want = both(a, b, c, schedule=schedule)
    assert rel_err(got, want) < 1e-5
    # the oracle too, and the caller's c is left alone
    tc = to_torch(c)
    out = rasa_matmul(to_torch(a), to_torch(b), tc, schedule=schedule, blocks=SMALL)
    assert rel_err(out, ref_matmul_accum(to_torch(a), to_torch(b), tc)) < 1e-5
    np.testing.assert_array_equal(tc.numpy(), c)


def test_gemm_schedules_bit_identical():
    rng = np.random.default_rng(11)
    a = to_torch(rng.normal(size=(256, 512)).astype(jnp.bfloat16))
    b = to_torch(rng.normal(size=(512, 256)).astype(jnp.bfloat16))
    outs = [rasa_matmul(a, b, schedule=s, blocks=SMALL) for s in SCHEDULES]
    for out in outs[1:]:
        assert torch.equal(outs[0], out)
    assert rel_err(outs[0], ref_matmul(a, b)) < 1e-5


def test_strided_b_and_out_dtype():
    """The tied head's B is embedding.T: a strided view, read in place."""
    rng = np.random.default_rng(5)
    a = to_torch(rng.normal(size=(4, 96)).astype(jnp.bfloat16))
    emb = to_torch(rng.normal(size=(300, 96)).astype(jnp.bfloat16))
    got = rasa_matmul(a, emb.T, blocks=SMALL, out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    want = rasa_matmul(a, emb.T.contiguous(), blocks=SMALL)
    assert torch.equal(got, want.to(torch.bfloat16))


# The decode path's shapes (M <= 4): bk deeper than K and than 1024, a
# ragged last chunk, a column slice of A, and B row-major or read in place
# as embedding.T (k-fast).  The CUDA kernels meet the same cases on the card
# (test_torch_cuda.py).
DECODE_CASES = [((4, 700, 300), 2048, False, 0), ((3, 2500, 515), 2048, True, 0),
                ((1, 1500, 1000), 1280, False, 0), ((2, 6144, 2048), 512, True, 3)]


@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("b_kfast", [False, True])
@pytest.mark.parametrize("shape,bk,with_c,a_offset", DECODE_CASES)
def test_decode_shapes_match_reference(shape, bk, with_c, a_offset, b_kfast, schedule):
    m, k, n = shape
    rng = np.random.default_rng(m + k + n)
    a = rng.normal(size=(m, k + a_offset)).astype(jnp.bfloat16)
    b = rng.normal(size=(n, k) if b_kfast else (k, n)).astype(jnp.bfloat16)
    c = rng.normal(size=(m, n)).astype(np.float32) if with_c else None
    tb = to_torch(b).T if b_kfast else to_torch(b)
    got = rasa_matmul(to_torch(a)[:, a_offset:], tb, None if c is None else to_torch(c),
                      schedule=schedule, blocks=GemmBlocks(128, bk, 128))
    want = j_rasa_matmul(a[:, a_offset:], b.T if b_kfast else b, c, schedule=schedule,
                         blocks=JGemmBlocks(128, bk, 512))
    assert got.shape == (m, n)
    assert rel_err(got.numpy(), want) < 1e-5


# f32 at M > 4 (the SIMT kernels' path on the card): chunks deeper than
# 1024, one ragged, embedding.T with A a column slice.  The CUDA kernels
# meet the same depths on the card (test_torch_cuda.py).
F32_DEEP_CASES = [((16, 1500, 200), 1280, False, True, 0),
                  ((20, 2500, 130), 2048, True, False, 3)]


@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("shape,bk,b_kfast,with_c,a_offset", F32_DEEP_CASES)
def test_f32_deep_chunks_match_reference(shape, bk, b_kfast, with_c, a_offset, schedule):
    m, k, n = shape
    rng = np.random.default_rng(m + k + n + bk)
    a = rng.normal(size=(m, k + a_offset)).astype(np.float32)
    b = rng.normal(size=(n, k) if b_kfast else (k, n)).astype(np.float32)
    c = rng.normal(size=(m, n)).astype(np.float32) if with_c else None
    tb = to_torch(b).T if b_kfast else to_torch(b)
    got = rasa_matmul(to_torch(a)[:, a_offset:], tb, None if c is None else to_torch(c),
                      schedule=schedule, blocks=GemmBlocks(128, bk, 128))
    want = j_rasa_matmul(a[:, a_offset:], b.T if b_kfast else b, c, schedule=schedule,
                         blocks=JGemmBlocks(128, bk, 128))
    assert got.shape == (m, n) and got.dtype == torch.float32
    assert rel_err(got.numpy(), want) < 1e-5


@pytest.mark.parametrize("shape", [(8192, 8192, 8192), (128, 128, 128),
                                   (100000, 64, 64), (4, 2048, 151936),
                                   (512, 6144, 2048)])
def test_default_blocks_match_reference(shape):
    got = default_blocks(*shape)
    want = j_default_blocks(*shape)
    assert (got.bm, got.bk, got.bn) == (want.bm, want.bk, want.bn)


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_schedule_cost_matches_reference(schedule):
    for m, k, n in [(8192, 4096, 4096), (512, 2048, 6144)]:
        got = schedule_cost(m, k, n, GemmBlocks(256, 512, 256), schedule)
        want = j_schedule_cost(m, k, n, JGemmBlocks(256, 512, 256), schedule)
        assert got == want


def test_kernel_wrapper_refuses_cpu_and_bad_input():
    a = torch.zeros(4, 8)
    with pytest.raises(ValueError, match="CUDA"):
        rasa_gemm(a, torch.zeros(8, 4))
    with pytest.raises(ValueError, match="schedule"):
        rasa_gemm_plain(a, torch.zeros(8, 4), schedule="nope")
    with pytest.raises(ValueError, match="shapes"):
        rasa_matmul(a, torch.zeros(7, 4))
