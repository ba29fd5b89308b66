"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``; each test decides inside itself whether a CUDA device is
present and skips without one.  This file imports no jax, so it also runs
on a GPU host that has none:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

from repro_torch.kernels import SCHEDULES, GemmBlocks, flash_mha
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import rasa_gemm as rk
from repro_torch.kernels import ssd_chunk as sc

def need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def rel_err(got, want):
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp_min(1e-6)).item()


# (M, K, N), bk, B k-fast (embedding.T) or row-major, with C, A's column
# offset in a wider tensor (0: contiguous).  The first four are the decode
# and small-shape cases; the rest cover the bf16 M > 4 tensor-core path:
# M 5 to 2048, K and N not multiples of 8, a bk not a multiple of 16 and a
# bk larger than K, and A rows that are not 16-byte aligned.  The last case
# is a bk deeper than the bf16 wlbp block can hold, over a K that it can:
# the block is sized by the chunk's real depth.  The four after it are the
# decode path (M <= 4) at depths it once refused: bk 2048 over K 700 and
# K 2500 (embedding.T, a ragged second chunk), bk 1280, and the down
# projection's K 6144 with A a column slice.
GEMM_CASES = [
    ((1, 256, 256), 128, True, True, 0),
    ((257, 130, 100), 128, True, True, 0),
    ((130, 260, 140), 128, True, True, 0),
    ((4, 2048, 1024), 128, True, True, 0),
    ((5, 256, 256), 128, False, False, 0),
    ((64, 512, 384), 512, False, True, 0),
    ((512, 2048, 1024), 512, False, True, 0),
    ((2048, 768, 1000), 512, False, False, 0),
    ((512, 130, 100), 100, False, True, 0),
    ((257, 260, 140), 512, True, False, 0),
    ((130, 300, 200), 100, False, True, 3),
    ((512, 1000, 515), 512, True, True, 1),
    ((64, 700, 300), 2048, False, True, 0),
    ((4, 700, 300), 2048, False, False, 0),
    ((3, 2500, 515), 2048, True, True, 0),
    ((1, 1500, 1000), 1280, False, False, 0),
    ((2, 6144, 2048), 512, False, True, 3),
]


# f32 only, M > 4 (the SIMT kernels): wlbp chunks deeper than the bf16
# block holds, 2048 over K 2500 and 3072 (the deepest a cluster of 8 CTAs
# holds) over K 3200 with embedding.T; M 300, ragged across a wlbp cluster;
# M 2100, more M tiles than a cluster has CTAs, so each walks two; and
# embedding.T with A a column slice (rows not 16-byte aligned).
F32_GEMM_CASES = [
    ((64, 2500, 300), 2048, False, True, 0),
    ((64, 3200, 300), 3072, True, False, 0),
    ((300, 1000, 260), 512, False, True, 0),
    ((2100, 300, 130), 128, False, True, 0),
    ((300, 700, 515), 256, True, True, 1),
]


def gemm_check(shape, bk, b_kfast, with_c, a_offset, dtype):
    """Each schedule's kernel against the plain version: rel_err < 1e-5 (the
    reference's GEMM tolerance), and the three schedules bit-identical."""
    m, k, n = shape
    gen = torch.Generator(device="cuda").manual_seed(m + k + n)
    a = torch.randn(m, k + a_offset, device="cuda", generator=gen).to(dtype)[:, a_offset:]
    b = (torch.randn(n, k, device="cuda", generator=gen).to(dtype).T if b_kfast
         else torch.randn(k, n, device="cuda", generator=gen).to(dtype))
    c = torch.randn(m, n, device="cuda", generator=gen) if with_c else None
    blocks = GemmBlocks(128, bk, 128)
    want = rk.rasa_gemm_plain(a, b, c, blocks=blocks)
    before = dict(rk.launches)
    outs = [rk.rasa_gemm(a, b, c, schedule=s, blocks=blocks) for s in SCHEDULES]
    torch.cuda.synchronize()
    for out in outs:
        assert rel_err(out, want) < 1e-5
        assert torch.equal(out, outs[0])
    assert all(rk.launches[s] > before[s] for s in SCHEDULES)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape,bk,b_kfast,with_c,a_offset", GEMM_CASES)
def test_cuda_gemm_matches_plain(shape, bk, b_kfast, with_c, a_offset, dtype):
    need_cuda()
    gemm_check(shape, bk, b_kfast, with_c, a_offset, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,bk,b_kfast,with_c,a_offset", F32_GEMM_CASES)
def test_cuda_gemm_f32_matches_plain(shape, bk, b_kfast, with_c, a_offset):
    need_cuda()
    gemm_check(shape, bk, b_kfast, with_c, a_offset, torch.float32)


@pytest.mark.cuda
def test_cuda_gemm_f32_wlbp_depth_limit():
    """An f32 M > 4 wlbp chunk one slab deeper than a cluster of 8 CTAs
    holds raises; base and wls take it."""
    need_cuda()
    a = torch.randn(64, 3200, device="cuda")
    b = torch.randn(3200, 100, device="cuda")
    blocks = GemmBlocks(128, 3104, 128)
    with pytest.raises(ValueError, match="cluster of 8"):
        rk.rasa_gemm(a, b, schedule="wlbp", blocks=blocks)
    want = rk.rasa_gemm_plain(a, b, blocks=blocks)
    for s in ("base", "wls"):
        assert rel_err(rk.rasa_gemm(a, b, schedule=s, blocks=blocks), want) < 1e-5


GEMM_DEVICE_KERNELS = ("decode_kernel", "tile_kernel", "wlbp_kernel", "sgemm_tile",
                       "sgemm_wlbp")


@pytest.mark.cuda
@pytest.mark.parametrize("schedule,want", [("base", "sgemm_tile"), ("wlbp", "sgemm_wlbp"),
                                           ("wls", "sgemm_tile")])
def test_cuda_gemm_f32_device_kernels_ran(schedule, want):
    """An f32 M > 4 call records only its SIMT kernel in a profiler trace
    (a warm-up step first: the tracer can drop the first records)."""
    need_cuda()
    from torch.profiler import ProfilerActivity, profile, schedule as steps
    a = torch.randn(512, 1024, device="cuda")
    b = torch.randn(1024, 1024, device="cuda")
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=steps(wait=0, warmup=1, active=1, repeat=1)) as prof:
            for _ in range(2):
                rk.rasa_gemm(a, b, schedule=schedule, blocks=GemmBlocks(128, 512, 128))
                torch.cuda.synchronize()
                prof.step()
        names = {e.key for e in prof.key_averages()}
        ran = [d for d in GEMM_DEVICE_KERNELS if any(d in name for name in names)]
        if ran:
            break
    assert ran == [want]


@pytest.mark.cuda
def test_cuda_gemm_rejects_mixed_dtypes():
    need_cuda()
    a = torch.zeros(4, 8, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        rk.rasa_gemm(a, torch.zeros(8, 4, device="cuda"))


def flash_both(q, k, v, causal, block=128):
    """(kernel through flash_mha, plain version) on the same CUDA tensors;
    asserts that one launch of the dtype's route ran."""
    b, hq, s, d = q.shape
    route = "flash_" + fa.flash_route(q.dtype, d)
    before = dict(fa.launches)
    got = flash_mha(q, k, v, causal=causal, block_q=block, block_kv=block)
    torch.cuda.synchronize()
    assert fa.launches["flash"] == before["flash"] + 1
    assert fa.launches[route] == before[route] + 1
    want = fa.flash_attention_plain(
        q.reshape(b * hq, s, d), k.reshape(-1, s, d), v.reshape(-1, s, d),
        causal=causal, block_q=block, block_kv=block).reshape(b, hq, s, d)
    return got, want


# (q heads, kv heads, S, D, causal): groups 1, 2 and 8; D 32, 64, 80, 128
# and 256 (each head dim both kernels are built for), and D 33 and 100,
# which no 16-byte copy takes; S from 1 to 4096 (one key tile, one past it,
# ragged); grids large enough for the tensor-core kernel's 128-row CTAs
# (16/8 and 16/16 heads at 4096, 64/8 at 1024); non-causal inputs at S 100,
# which the reference pads with 28 zero keys.  The f32 kernel's tiles
# (F32_TILES below) change at D 32, 64, 80 and 128; at D <= 128 the
# 128-row tile takes grids of 2 BH ceil(S / 128) >= 3 SMs (16/8 and 16/16
# heads at 4096, 64/8 at 1024 here), the 64-row tile the rest.
FLASH_CASES = [
    (4, 4, 128, 64, True), (8, 2, 257, 128, True), (8, 1, 300, 256, True),
    (4, 4, 200, 80, True), (4, 2, 256, 80, False),
    (2, 2, 1, 64, True), (4, 2, 64, 80, True), (8, 1, 65, 128, True),
    (4, 4, 257, 256, True), (16, 8, 4096, 128, True), (8, 1, 4096, 256, True),
    (16, 16, 4096, 80, True), (64, 8, 1024, 128, False), (4, 2, 100, 64, False),
    (8, 1, 100, 256, False), (4, 4, 70, 33, True), (4, 2, 130, 100, True),
    (4, 2, 150, 32, True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2), (torch.float32, 1e-5)])
@pytest.mark.parametrize("hq,hkv,s,d,causal", FLASH_CASES)
def test_cuda_flash_matches_plain(hq, hkv, s, d, causal, dtype, tol):
    """The flash kernel of the dtype's route (bf16: tensor cores, f32: SIMT)
    through flash_mha against its plain version on the same CUDA tensors:
    the reference's tolerances (test_kernels.py:112,121)."""
    need_cuda()
    gen = torch.Generator(device="cuda").manual_seed(s + d)
    q = torch.randn(2, hq, s, d, device="cuda", generator=gen).to(dtype)
    k = torch.randn(2, hkv, s, d, device="cuda", generator=gen).to(dtype)
    v = torch.randn(2, hkv, s, d, device="cuda", generator=gen).to(dtype)
    got, want = flash_both(q, k, v, causal)
    assert got.dtype == dtype and rel_err(got, want) < tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2), (torch.float32, 1e-5)])
@pytest.mark.parametrize("hq,hkv,s,d", [(8, 2, 257, 128), (32, 8, 2048, 128),
                                         (32, 32, 1100, 80), (8, 1, 300, 256)])
def test_cuda_flash_large_logits(hq, hkv, s, d, dtype, tol):
    """q and k scaled by 30: logits in the thousands, so each new key tile
    can raise a row's running max far above the last, and the rescale of
    the accumulated sum and output must hold (bf16 on the tensor cores,
    f32 on the SIMT kernel, at the reference's tolerances)."""
    need_cuda()
    gen = torch.Generator(device="cuda").manual_seed(s * d)
    q = (30 * torch.randn(2, hq, s, d, device="cuda", generator=gen)).to(dtype)
    k = (30 * torch.randn(2, hkv, s, d, device="cuda", generator=gen)).to(dtype)
    v = torch.randn(2, hkv, s, d, device="cuda", generator=gen).to(dtype)
    got, want = flash_both(q, k, v, True)
    assert torch.isfinite(got.float()).all() and rel_err(got, want) < tol


@pytest.mark.cuda
@pytest.mark.parametrize("sq,skv,d,causal", [(70, 70, 128, False), (150, 70, 128, True),
                                              (90, 45, 80, True), (40, 40, 256, False)])
def test_cuda_flash_f32_padded_keys(sq, skv, d, causal):
    """skv not a multiple of the SIMT kernel's key tile, with a block_kv of
    96 that pads past it: the rows that see the positions in [skv, 96)
    (every row without the mask, rows from skv on under it) count them as
    zero keys with zero values, as the plain version does (1e-5)."""
    need_cuda()
    gen = torch.Generator(device="cuda").manual_seed(sq + skv + d)
    q = torch.randn(8, sq, d, device="cuda", generator=gen)
    k = torch.randn(2, skv, d, device="cuda", generator=gen)
    v = torch.randn(2, skv, d, device="cuda", generator=gen)
    before = fa.launches["flash_simt"]
    got = fa.flash_attention(q, k, v, causal=causal, block_kv=96)
    torch.cuda.synchronize()
    assert fa.launches["flash_simt"] == before + 1
    want = fa.flash_attention_plain(q, k, v, causal=causal, block_q=128, block_kv=96)
    assert torch.isfinite(got).all() and rel_err(got, want) < 1e-5


# The f32 kernel's CTA tile (query rows, keys, warps) per padded head dim,
# as csrc/flash_attention.cu chooses it; at D <= 128, grids of
# 2 BH ceil(S / 128) >= 3 SMs take LARGE_F32_TILE instead.
F32_TILES = {32: (128, 64, 4), 64: (128, 64, 4), 80: (128, 32, 4), 128: (64, 64, 4),
             256: (64, 64, 8)}
LARGE_F32_TILE = (128, 64, 8)


@pytest.mark.cuda
@pytest.mark.parametrize("d,s,side", [
    (32, 300, None), (40, 300, None), (64, 300, None), (80, 300, None), (96, 257, "below"),
    (128, 257, "below"), (128, 257, "above"), (128, 1000, "above"), (256, 300, None)])
def test_cuda_flash_f32_tiles(d, s, side):
    """Each tile the f32 kernel's dispatch can take, D below the padded
    head dim included, and the D 128 grids just below and just above the
    threshold of the 128-row tile: against the plain version at 1e-5."""
    need_cuda()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    tiles = -(-s // 128)
    bh = {None: 4, "below": (3 * sms - 1) // (2 * tiles), "above": -(-3 * sms // (2 * tiles))}[side]
    want_tile = LARGE_F32_TILE if side == "above" else F32_TILES[min(k for k in F32_TILES if k >= d)]
    assert fa.simt_tile(bh, s, d) == want_tile
    gen = torch.Generator(device="cuda").manual_seed(bh + s + d)
    q = torch.randn(bh, s, d, device="cuda", generator=gen)
    k = torch.randn(1, s, d, device="cuda", generator=gen)
    v = torch.randn(1, s, d, device="cuda", generator=gen)
    got = fa.flash_attention(q, k, v, block_kv=128)
    want = fa.flash_attention_plain(q, k, v, block_q=128, block_kv=128)
    assert rel_err(got, want) < 1e-5


@pytest.mark.cuda
def test_cuda_flash_rejects_bad_inputs():
    need_cuda()
    q = torch.zeros(2, 64, 32, device="cuda")
    with pytest.raises(TypeError):
        fa.flash_attention(q, q.to(torch.bfloat16), q)
    big = torch.zeros(2, 64, 320, device="cuda")
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(big, big, big)


def ssd_inputs(bh, s, p, n, dtype, dt_dtype=torch.float32, seed=0):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(bh, s, p, device="cuda", generator=gen).to(dtype)
    dt = (torch.rand(bh, s, device="cuda", generator=gen) * 0.19 + 0.01).to(dt_dtype)
    a = -(torch.rand(bh, device="cuda", generator=gen) * 1.5 + 0.5)
    b = torch.randn(bh, s, n, device="cuda", generator=gen).to(dtype)
    c = torch.randn(bh, s, n, device="cuda", generator=gen).to(dtype)
    return x, dt, a, b, c


def ssd_check(args, chunk):
    """The kernels against the plain version on the same CUDA tensors:
    rtol = atol = 2e-5 in f32 (test_ssd_kernel.py:37), rel_err < 3e-2 in
    bf16 (:55); one wrapper launch, one of each device kernel of the
    dtype's route."""
    x = args[0]
    before = dict(sc.launches)
    y, fin = sc.ssd_chunk_fused(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert sc.launches["ssd"] == before["ssd"] + 1
    for key in sc.ROUTES[x.dtype]:
        assert sc.launches[key] == before[key] + 1
    want_y, want_fin = sc.ssd_chunk_plain(*args, chunk=chunk)
    assert y.dtype == x.dtype and fin.dtype == torch.float32
    if x.dtype == torch.float32:
        torch.testing.assert_close(y, want_y, rtol=2e-5, atol=2e-5)
        torch.testing.assert_close(fin, want_fin, rtol=2e-5, atol=2e-5)
    else:
        assert rel_err(y, want_y) < 3e-2 and rel_err(fin, want_fin) < 3e-2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bh,s,p,n,chunk", [(3, 128, 16, 8, 32), (4, 512, 64, 128, 256),
                                            (8, 512, 64, 64, 256), (2, 96, 80, 100, 48)])
def test_cuda_ssd_matches_plain(bh, s, p, n, chunk, dtype):
    """The SSD kernels against their plain version on the same CUDA tensors."""
    need_cuda()
    ssd_check(ssd_inputs(bh, s, p, n, dtype, seed=s + n), chunk)


# The new design's edges: 16 chunks (the recurrence runs long); chunks that
# are not a multiple of the row tiles (48, 96); BH 1; the mamba2-130m and
# zamba2-2.7b layers' full shapes at S 1024 (batch 4); chunk 2048 (once
# refused: the chunk is no longer held in shared memory); P past 128 and
# P not a multiple of 64; N and P that no 16-byte copy takes (the kernels'
# element-load builds).  N past 128 (f32 only) is below.
SSD_EDGE_CASES = [
    (3, 2048, 64, 128, 128), (4, 192, 64, 64, 48), (4, 384, 64, 128, 96),
    (1, 512, 64, 128, 256), (96, 1024, 64, 128, 256), (320, 1024, 64, 64, 256),
    (2, 4096, 64, 128, 2048), (2, 256, 160, 64, 128), (2, 256, 200, 40, 64),
    (2, 128, 18, 13, 64),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bh,s,p,n,chunk", SSD_EDGE_CASES)
def test_cuda_ssd_edges_match_plain(bh, s, p, n, chunk, dtype):
    need_cuda()
    ssd_check(ssd_inputs(bh, s, p, n, dtype, seed=bh + s + p + n), chunk)


@pytest.mark.cuda
@pytest.mark.parametrize("bh,s,p,n,chunk", [(2, 256, 64, 200, 128), (3, 96, 16, 160, 32)])
def test_cuda_ssd_f32_takes_wide_state(bh, s, p, n, chunk):
    """N past 128: the f32 kernels stream C and B in k-chunks."""
    need_cuda()
    ssd_check(ssd_inputs(bh, s, p, n, torch.float32, seed=n), chunk)


@pytest.mark.cuda
@pytest.mark.parametrize("bh,s,p,n,chunk", [(4, 512, 64, 128, 256), (2, 96, 80, 100, 48)])
def test_cuda_ssd_bf16_dt(bh, s, p, n, chunk):
    """dt in bf16 beside bf16 x/b/c."""
    need_cuda()
    ssd_check(ssd_inputs(bh, s, p, n, torch.bfloat16, torch.bfloat16, seed=p), chunk)


@pytest.mark.cuda
def test_cuda_ssd_device_kernels_ran():
    """Every device kernel of KERNEL_NAMES shows in a profiler trace of one
    f32 and one bf16 call (a warm-up step first: the tracer can drop the
    first records of a trace)."""
    need_cuda()
    from torch.profiler import ProfilerActivity, profile, schedule
    calls = [ssd_inputs(4, 512, 64, 128, dtype) for dtype in (torch.float32, torch.bfloat16)]
    devices = [v for k, v in sc.KERNEL_NAMES.items() if k != "ssd"]
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            for _ in range(2):
                for args in calls:
                    sc.ssd_chunk_fused(*args, chunk=256)
                torch.cuda.synchronize()
                prof.step()
        names = {e.key for e in prof.key_averages()}
        ran = [d for d in devices if any(d in name for name in names)]
        if ran == devices:
            break
    assert ran == devices


@pytest.mark.cuda
def test_cuda_ssd_rejects_bad_inputs():
    need_cuda()
    x = torch.zeros(2, 64, 16, device="cuda")
    dt, a = torch.zeros(2, 64, device="cuda"), torch.zeros(2, device="cuda")
    with pytest.raises(TypeError):
        sc.ssd_chunk_cuda(x, dt, a, x.to(torch.bfloat16), x, chunk=32)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        sc.ssd_chunk_cuda(x, dt, a, x, x, chunk=48)
    wide = torch.zeros(2, 64, 160, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="N <= 128"):
        sc.ssd_chunk_cuda(x.to(torch.bfloat16), dt, a, wide, wide, chunk=32)


# ------------------------------------------------------------------ models


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4, 8192, 2048), (512, 2048, 6144)])
def test_cuda_xla_engine_accumulates_in_f32(shape):
    """The xla engine's bf16 product on the card (torch.mm's out_dtype
    overload, no f32 copies of the operands) against the product of the
    operands cast to f32: the GEMM tolerance, 1e-5.  A bf16 reduction would
    miss it by far (one bf16 ulp is 3.9e-3)."""
    need_cuda()
    from repro_torch.models.common import matmul
    m, k, n = shape
    gen = torch.Generator(device="cuda").manual_seed(k)
    x = torch.randn(m, k, device="cuda", generator=gen).to(torch.bfloat16)
    w = torch.randn(k, n, device="cuda", generator=gen).to(torch.bfloat16)
    got = matmul(x, w, out_dtype=torch.float32)
    want = torch.mm(x.float(), w.float())
    assert got.dtype == torch.float32
    assert rel_err(got, want) < 1e-5
    assert rel_err(matmul(x, w), want) < 2 ** -8          # one rounding to bf16


def moe_case(dtype, device):
    """granite smoke's router and experts at batch 4 x 64 with capacity
    factor 1.0 (tokens are dropped), weights and x from a seed on the CPU."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_layer_params
    m = get_config("granite-moe-3b-a800m", smoke=True).model
    m = dataclasses.replace(m, dtype="float32", n_layers=1,
                            moe=dataclasses.replace(m.moe, capacity_factor=1.0))
    gen = torch.Generator().manual_seed(0)
    p = init_layer_params(m, gen, torch.float32, "cpu")
    x = torch.randn(4, 64, m.d_model, generator=gen)
    p = {name: t.to(dtype).to(device) for name, t in p.items()}
    return p, x.to(dtype).to(device), m


@pytest.mark.cuda
def test_cuda_moe_dispatch_matches_cpu():
    """moe_block on the card keeps the CPU's slots (f32: the same top-k and
    the same kept entries), its output and loss within 1e-5 of the CPU's,
    and two bf16 calls give the same bits (no atomics in the combine)."""
    need_cuda()
    from repro_torch.models import moe
    p, x, m = moe_case(torch.float32, "cpu")
    want, want_r = moe.moe_forward(p, x, m)
    pc, xc, _ = moe_case(torch.float32, "cuda")
    got, got_r = moe.moe_forward(pc, xc, m)
    assert not want_r.keep.all()                        # tokens were dropped
    assert torch.equal(got_r.top_i.cpu(), want_r.top_i)
    assert torch.equal(got_r.keep.cpu(), want_r.keep)
    assert rel_err(got.cpu(), want) < 1e-5
    assert rel_err(moe.moe_block(pc, xc, m)[1].cpu(), moe.moe_block(p, x, m)[1]) < 1e-5
    pb, xb, _ = moe_case(torch.bfloat16, "cuda")
    first = moe.moe_forward(pb, xb, m)[0].clone()
    assert torch.equal(moe.moe_forward(pb, xb, m)[0], first)
