"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``; each test decides inside itself whether a CUDA device is
present and skips without one.  This file imports no jax, so it also runs
on a GPU host that has none:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

from repro_torch.kernels import SCHEDULES, GemmBlocks
from repro_torch.kernels import rasa_gemm as rk

SMALL = GemmBlocks(128, 128, 128)


def need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def rel_err(got, want):
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp_min(1e-6)).item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(1, 256, 256), (257, 130, 100),
                                   (130, 260, 140), (4, 2048, 1024)])
def test_cuda_gemm_matches_plain(shape, dtype):
    """Each schedule's kernel against the plain version, with C and a
    strided B: rel_err < 1e-5 (the reference's GEMM tolerance), and the
    three schedules bit-identical."""
    need_cuda()
    m, k, n = shape
    gen = torch.Generator(device="cuda").manual_seed(m + k + n)
    a = torch.randn(m, k, device="cuda", generator=gen).to(dtype)
    b = torch.randn(n, k, device="cuda", generator=gen).to(dtype).T
    c = torch.randn(m, n, device="cuda", generator=gen)
    want = rk.rasa_gemm_plain(a, b, c, blocks=SMALL)
    before = dict(rk.launches)
    outs = [rk.rasa_gemm(a, b, c, schedule=s, blocks=SMALL) for s in SCHEDULES]
    torch.cuda.synchronize()
    for out in outs:
        assert rel_err(out, want) < 1e-5
        assert torch.equal(out, outs[0])
    assert all(rk.launches[s] > before[s] for s in SCHEDULES)


@pytest.mark.cuda
def test_cuda_gemm_rejects_mixed_dtypes():
    need_cuda()
    a = torch.zeros(4, 8, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        rk.rasa_gemm(a, torch.zeros(8, 4, device="cuda"))
