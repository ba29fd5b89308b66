"""Pure helpers of chip_smoke.py, on the CPU."""

import re
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402


@pytest.mark.parametrize("spans,want", [
    ([], 0.0),
    ([(0.0, 10.0)], 10.0),
    ([(0.0, 10.0), (20.0, 25.0)], 15.0),              # apart: the sum
    ([(0.0, 10.0), (5.0, 12.0), (20.0, 25.0)], 17.0),  # overlapping: counted once
    ([(5.0, 12.0), (0.0, 10.0)], 12.0),              # any order
    ([(0.0, 10.0), (2.0, 3.0)], 10.0),               # nested
])
def test_busy_us_is_the_union_of_intervals(spans, want):
    assert chip_smoke.busy_us(spans) == want


@pytest.mark.parametrize("records,want", [
    (set(), []),
    ({"void (anonymous namespace)::tc::flash_fwd_tc<128, 2>(...)"}, ["flash_fwd_tc"]),
    ({"void (anonymous namespace)::flash_fwd_kernel<8>(...)", "Memset (Device)"},
     ["flash_fwd_kernel"]),
    ({"flash_fwd_tc<64, 1>", "flash_fwd_kernel<4>"},
     ["flash_fwd_kernel", "flash_fwd_tc"]),
    # the f32 kernel's records name its tile, a Cfg of the simt namespace
    ({"void (anonymous namespace)::simt::flash_fwd_kernel<(anonymous namespace)::simt::"
      "Cfg<128, 16, 8, 64, 8> >(float const*, float const*, float const*, float*, int, int, "
      "int, int, int, float, int, int)", "Memset (Device)"}, ["flash_fwd_kernel"]),
])
def test_timed_kernels_reads_record_names(records, want):
    assert chip_smoke.timed_kernels(records, ("flash_fwd_tc", "flash_fwd_kernel")) == want


@pytest.mark.parametrize("record,want", [
    ("void at::native::(anonymous namespace)::softmax_warp_forward<float, float, float, 9, "
     "false, false>(float*, float const*, int, int, int, bool const*, int, bool)",
     "softmax_warp_forward"),
    ("fmha_cutlassF_f32_aligned_64x64_rf_sm80(PyTorchMemEffAttention::AttentionKernel<float, "
     "cutlass::arch::Sm80, true, 64, 64, 64, true, true>::Params)",
     "fmha_cutlassF_f32_aligned_64x64_rf_sm80"),
    ("sm90_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize128x128x8_kernel__5x_cublas",
     "sm90_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize128x128x8_kernel__5x_cublas"),
    ("Memcpy DtoD (Device -> Device)", "Memcpy DtoD"),
    ("void (anonymous namespace)::simt::flash_fwd_kernel<(anonymous namespace)::simt::"
     "Cfg<80, 4, 4, 32, 4> >(float const*, float const*, float const*, float*, int, int, int, "
     "int, int, float, int, int)", "flash_fwd_kernel"),
])
def test_kernel_name_strips_the_signature(record, want):
    assert chip_smoke.kernel_name(record) == want


def test_library_kernels_names_each_kernel_once():
    """SDPA's math path in f32: GEMMs and a softmax, each named once."""
    records = {"void at::native::(anonymous namespace)::softmax_warp_forward<float>(...)": 0.1,
               "sm90_xmma_gemm_f32f32_tilesize128x128_cublas": 0.2,
               "sm90_xmma_gemm_f32f32_tilesize64x64_cublas": 0.1,
               "void at::native::elementwise_kernel<128, 2>(int, ...)": 0.01,
               "void at::native::elementwise_kernel<128, 4>(int, ...)": 0.01}
    assert chip_smoke.library_kernels(records) == [
        "elementwise_kernel", "sm90_xmma_gemm_f32f32_tilesize128x128_cublas",
        "sm90_xmma_gemm_f32f32_tilesize64x64_cublas", "softmax_warp_forward"]
    assert chip_smoke.library_kernels({}) == []


GEMM = ("decode_kernel", "tile_kernel")


@pytest.mark.parametrize("records,calls,want", [
    ({}, 1, {"kernels": 0.0, "other": {}}),
    ({"void (anonymous namespace)::dec::decode_kernel<false, __nv_bfloat16>(...)": 0.6},
     3, {"kernels": 0.2, "other": {}}),
    # a wrapper's fill is its own record; two kernel names add up
    ({"decode_kernel<true, float>": 0.4, "tile_kernel<128>": 0.2,
      "void at::native::vectorized_elementwise_kernel<...>": 0.1},
     2, {"kernels": 0.3, "other": {"void at::native::vectorized_elementwise_kernel<...>": 0.05}}),
    # CUDA-event fallback: names without times
    ({"decode_kernel<false, float>": None, "Memset (Device)": None},
     1, {"kernels": None, "other": {"Memset (Device)": None}}),
])
def test_record_split_groups_kernel_and_other_records(records, calls, want):
    got = chip_smoke.record_split(records, GEMM, calls)
    assert got.keys() == want.keys() and got["other"].keys() == want["other"].keys()
    if want["kernels"] is None:
        assert got == want
    else:
        assert got["kernels"] == pytest.approx(want["kernels"])
        for k, v in want["other"].items():
            assert got["other"][k] == pytest.approx(v)


def test_gemm_records_are_the_global_kernel_names():
    """GEMM_RECORDS names every __global__ kernel of csrc/rasa_gemm.cu and
    nothing else, and no name is a part of another, so a renamed kernel
    cannot drop out of the record count, nor be counted as another."""
    src = (chip_smoke.ROOT / chip_smoke.SOURCES["gemm"]).read_text()
    names = re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(",
                       src)
    assert set(names) == set(chip_smoke.GEMM_RECORDS)
    assert not any(a != b and a in b for a in names for b in names)


@pytest.mark.parametrize("records,want", [
    ({"void (anonymous namespace)::simt::sgemm_tile<128, 4>(...)": 0.3}, ["sgemm_tile"]),
    ({"void (anonymous namespace)::simt::sgemm_wlbp<256, 8>(...)": 0.2,
      "Memset (Device)": 0.01}, ["sgemm_wlbp"]),
    ({"void (anonymous namespace)::tc::tile_kernel<128>(...)": 0.1,
      "void (anonymous namespace)::tc::wlbp_kernel<64>(...)": 0.1},
     ["tile_kernel", "wlbp_kernel"]),
    ({"void (anonymous namespace)::dec::decode_kernel<8, float>(...)": 0.1}, ["decode_kernel"]),
])
def test_timed_kernels_tells_the_gemm_kernels_apart(records, want):
    # the SIMT kernels are not counted as the tensor-core ones, nor the reverse
    assert chip_smoke.timed_kernels(records, chip_smoke.GEMM_RECORDS) == want


@pytest.mark.parametrize("byte_ms,ms,want", [(0.186, 0.186, 1.0), (0.186, 0.372, 0.5),
                                             (2.5e-3, 1e-2, 0.25)])
def test_hbm_share_is_bytes_time_over_time(byte_ms, ms, want):
    assert chip_smoke.hbm_share(byte_ms, ms) == pytest.approx(want)


SSD_NAMES = ("ssd_state_simt", "ssd_state_tc", "ssd_state_pass", "ssd_out_simt", "ssd_out_tc")
F32_RECORDS = {
    "void (anonymous namespace)::simt::ssd_state_simt<float, true>(...)": 0.126,
    "void (anonymous namespace)::ssd_state_pass(float*, float const*, float*, int, int, int)": 0.012,
    "void (anonymous namespace)::simt::ssd_out_simt<true>(...)": 0.42,
}
BF16_RECORDS = {
    "void (anonymous namespace)::tc::ssd_state_tc<float>(...)": 0.042,
    "void (anonymous namespace)::ssd_state_pass(float*, float const*, float*, int, int, int)": 0.012,
    "void (anonymous namespace)::tc::ssd_out_tc<128>(...)": 0.135,
    "Memset (Device)": 0.003,
}


def test_ssd_device_kernels_are_the_kernel_names():
    from repro_torch.kernels import ssd_chunk as sc
    assert chip_smoke.ssd_device_kernels(sc) == SSD_NAMES
    for route in sc.ROUTES.values():
        assert {sc.KERNEL_NAMES[k] for k in route} <= set(SSD_NAMES)


@pytest.mark.parametrize("records,want", [
    (F32_RECORDS, ["ssd_out_simt", "ssd_state_pass", "ssd_state_simt"]),
    (BF16_RECORDS, ["ssd_out_tc", "ssd_state_pass", "ssd_state_tc"]),
])
def test_timed_kernels_reads_ssd_record_names(records, want):
    # no name is a part of another: ssd_out_tc is not counted in ssd_out_simt
    assert chip_smoke.timed_kernels(records, SSD_NAMES) == want


@pytest.mark.parametrize("records,calls,want", [
    (F32_RECORDS, 3, {"ssd_state_simt": 0.042, "ssd_state_pass": 0.004, "ssd_out_simt": 0.14,
                      "other": {}}),
    (BF16_RECORDS, 3, {"ssd_state_tc": 0.014, "ssd_state_pass": 0.004, "ssd_out_tc": 0.045,
                       "other": {"Memset (Device)": 0.001}}),
])
def test_kernel_split_by_ssd_device_kernel(records, calls, want):
    names = [k for k in want if k != "other"]
    got = chip_smoke.kernel_split(records, names, calls)
    assert got.keys() == want.keys() and got["other"].keys() == want["other"].keys()
    for k in names:
        assert got[k] == pytest.approx(want[k])
    for k, v in want["other"].items():
        assert got["other"][k] == pytest.approx(v)


def test_kernel_split_without_times():
    """CUDA-event fallback: the records carry no times."""
    got = chip_smoke.kernel_split(dict.fromkeys(F32_RECORDS), ("ssd_state_simt", "ssd_out_simt"), 1)
    assert got == {"ssd_state_simt": None, "ssd_out_simt": None,
                   "other": {"void (anonymous namespace)::ssd_state_pass(float*, float const*, "
                             "float*, int, int, int)": None}}


@pytest.mark.parametrize("spans,want", [
    ([("a", 0.0, 10.0)], 0.0),
    ([("a", 0.0, 2.0), ("b", 8.0, 10.0)], 0.6),
    ([("a", 0.0, 6.0), ("b", 4.0, 10.0)], 0.0),          # overlap counted once
    ([("b", 5.0, 6.0), ("a", 0.0, 1.0), ("c", 9.0, 10.0)], 0.7),
])
def test_idle_share_is_the_idle_part_of_the_window(spans, want):
    assert chip_smoke.idle_share(spans) == pytest.approx(want)


ALL_ARCHS = ["qwen3-1.7b", "mamba2-130m", "zamba2-2.7b", "granite-moe-3b-a800m",
             "grok-1-314b", "qwen2-vl-72b", "musicgen-large"]


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_layer_shapes_are_the_rasa_products_of_a_forward(arch):
    """layer_shapes and the head (head_width) are the (K, N) of every product a
    prefill sends through the RASA engine (the MoE's router and experts do
    not go there), so gemm_launches_per_forward counts a forward's
    launches; smoke configs on the CPU."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model, common
    from repro_torch.models.transformer import head_width, prompt_shape
    cfg = get_config(arch, smoke=True)
    cfg = dataclasses.replace(cfg, engine=chip_smoke.engine_of(cfg, "wls"))
    model = build_model(cfg, device="cpu")
    m = model.model
    prompts = torch.zeros(prompt_shape(m, 2, 8), dtype=torch.int32)
    calls = chip_smoke.capture(common, "rasa_matmul", lambda: model.prefill(
        prompts, model.init_decode_state(2, 8)))
    got = sorted((a.shape[1], b.shape[1]) for (a, b), _, _ in calls)
    want = sorted([(k, n) for k, n, c in chip_smoke.layer_shapes(m) for _ in range(c)]
                  + [(m.d_model, head_width(m))])
    assert got == want
    assert chip_smoke.gemm_launches_per_forward(m, 512)["wls"] == len(calls)


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "musicgen-large", "qwen3-1.7b"])
def test_decode_floor_counts_the_weights_a_step_reads(arch):
    """Every parameter, less the embedding when the head is not tied to it."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    model = build_model(get_config(arch, smoke=True), device="cpu")
    total = sum(p.numel() * p.element_size() for p in model.parameters())
    emb = 0 if model.model.tie_embeddings else model.embedding.numel() * 2
    got, ms = chip_smoke.decode_floor_ms(model)
    assert got == total - emb
    assert ms == got / chip_smoke.HBM_BYTES_PER_S * 1e3


@pytest.mark.parametrize("record,want", [
    ("nvjet_hsh_64x8_64x16_2x1_v_bz_TNT", True),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize64x64x64_warpgroupsize1x1x1", True),
    ("void cutlass::Kernel2<cutlass_80_wmma_tensorop_bf16_s161616gemm_bf16_16x16_128x2_tn>"
     "(Params)", True),
    ("void (anonymous namespace)::dec::decode_kernel<64, __nv_bfloat16>(...)", False),
    ("void (anonymous namespace)::simt::sgemm_tile<8, 4>(...)", False),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<c10::"
     "BFloat16>>(int, ...)", False),
    ("void at_cuda_detail::cub::DeviceRadixSortOnesweepKernel<...>(...)", False),
])
def test_library_gemm_records(record, want):
    assert chip_smoke.is_library_gemm(record) == want


@pytest.mark.parametrize("arch,attn_layers", [("qwen3-1.7b", 28), ("mamba2-130m", 0),
                                              ("zamba2-2.7b", 9)])
def test_model_flops_counts_6nt_and_attention(arch, attn_layers):
    """Phase 10's model FLOPs: 6 N per token, plus 12 L H hd S per token
    over the layers that attend (none for mamba2, the shared block's 9
    applications for zamba2)."""
    from repro_torch.configs import get_config
    m = get_config(arch).model
    tokens, seq = 4096, chip_smoke.TRAIN["seq_len"]
    want = (6 * m.param_count()
            + 12 * attn_layers * m.n_heads * m.resolved_head_dim * seq) * tokens
    assert chip_smoke.model_flops(m, tokens) == want
    if arch == "qwen3-1.7b":
        assert 4.3e13 < want < 4.5e13


def test_sweep_schedule_is_core_zero_of_the_chip():
    """The bucket sweep's core: 64 bytes/cycle while all four cores draw,
    then 85.3 and 128 as the others stop (epochs 300, 600, 900), then the
    whole budget."""
    shares, tail = chip_smoke.sweep_schedule()
    assert len(shares) == max(chip_smoke.SWEEP_DRAINS) and tail == chip_smoke.CHIP["bw"]
    assert (shares[0], shares[299], shares[300], shares[600], shares[899]) == \
        (64.0, 64.0, 256.0 / 3, 128.0, 128.0)


def test_chip_schedule_gives_each_lane_its_share_and_tail():
    drains = chip_smoke.CORE_DRAINS
    for k, d in enumerate(drains):
        shares, tail = chip_smoke.chip_schedule(drains, k)
        assert len(shares) == d
        assert shares[0] == chip_smoke.CHIP["bw"] / len(drains)
        assert tail == chip_smoke.CHIP["bw"] / max(1, sum(x > d for x in drains))
    # the longest lane draws alone at its end, and its tail is the budget
    k = drains.index(max(drains))
    shares, tail = chip_smoke.chip_schedule(drains, k)
    assert shares[-1] == tail == chip_smoke.CHIP["bw"]


def test_require_equal_names_the_first_difference():
    chip_smoke.require_equal("same", [(1.0, 2)], [(1.0, 2)])
    with pytest.raises(RuntimeError, match="first at 1"):
        chip_smoke.require_equal("x", [1, 2, 3], [1, 5, 3])
    with pytest.raises(RuntimeError, match="length"):
        chip_smoke.require_equal("x", [1], [1, 2])


def test_mm_bound_counts_rows_and_the_longest_lane():
    import numpy as np
    code = np.zeros(10, np.int32)
    val = np.zeros((10, 6))
    lane_f = np.zeros((3, 6))
    rows = np.array([[0, 10], [0, 10], [0, 4]], np.int64)
    b = chip_smoke.mm_bound((code, val, lane_f, rows))
    assert b["lane_steps"] == 24
    assert b["serial_chain_ops"] == chip_smoke.CHAIN_OPS_PER_STEP * 10
    assert b["longest_chain_steps"] == 10
    row = chip_smoke.timed_row(2e-3, "events", b)      # the MM row's ns a row
    assert row["ns_per_step"] == pytest.approx(200.0)
    want_bytes = (40 + 480 + 144 + 48 + 48) / chip_smoke.HBM_BYTES_PER_S * 1e3
    assert b["bytes_ms"] == pytest.approx(want_bytes)
    assert b["operations_ms"] == pytest.approx(
        chip_smoke.MM_SCAN_OPS * 24 / chip_smoke.FP64_PEAK * 1e3)
    assert b["bound_ms"] == max(b["bytes_ms"], b["operations_ms"])


def test_random_trace_is_the_tests_stream():
    """chip_smoke's random streams are the parity tests' own (one copy,
    tests/_sim_streams.py), compiled from the port's classes."""
    import random

    import numpy as np
    from _sim_streams import random_stream
    from repro_torch import core
    from repro_torch.core.trace import compile_stream
    got = chip_smoke.random_trace(core, 3, 50)
    want = compile_stream(random_stream(random.Random(3), 50, core.isa))
    assert len(got) == 58
    for field in ("opcode", "r_dst", "r_a", "r_b", "tm", "nbytes", "reusable"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field))


def test_partial_run_names_its_phases_in_the_last_line():
    full = chip_smoke.result_line("H100", 1)
    assert full == {"ok": True, "device": {"platform": "gpu", "kind": "H100", "count": 1}}
    part = chip_smoke.result_line("H100", 1, chip_smoke.PARTIAL_PHASES)
    assert part == {**full, "phases": ["build", "simulate"]}


def test_batcher_run_names_its_phases():
    part = chip_smoke.result_line("H100", 1, chip_smoke.BATCHER_PHASES)
    assert part["phases"] == ["build", "batcher"] and part["ok"] is True


@pytest.mark.parametrize("variant", chip_smoke.BATCH_VARIANTS)
def test_batch_chip_is_the_phase_12_case(variant):
    from repro_torch.multicore import chip as chip_mod
    chip = chip_smoke.batch_chip(chip_mod, variant, "numpy")
    assert chip.n_cores == 4 and chip.bw_bytes_per_cycle == 32.0
    assert chip.epoch_cycles == 1024.0 and chip.backend == "numpy"
    if variant == "mixed":
        assert tuple(c.design for c in chip.core_specs) == chip_smoke.BATCH_MIXED
        assert chip.share_policy.name == "equal"
    else:
        assert chip.share_policy.name == "demand" and chip.homogeneous


def test_program_ops_counts_the_steps_at_the_trace_mix():
    """program_ops: lane blocks x 64 steps at the table's mean operations a
    step (SCAN_OPS, every TL and TS a grant)."""
    from repro_torch.core import GemmSpec
    from repro_torch.core.tiling import ALG1_POLICY
    from repro_torch.core.trace import gemm_trace
    t = gemm_trace(GemmSpec("g", 32, 128, 128), ALG1_POLICY)
    ops = chip_smoke.SCAN_OPS
    per = (ops["tl"] * t.n_tl + ops["ts"] * t.n_ts + ops["mm"] * t.n_mm
           + ops["grant"] * (t.n_tl + t.n_ts)) / len(t)
    assert chip_smoke.program_ops([t], 10) == pytest.approx(10 * 64 * per)
    assert chip_smoke.program_ops([t, t], 3) == pytest.approx(3 * 64 * per)


def test_program_bound_reads_the_stats():
    """program_bound: the inputs and outputs over the HBM rate, the steps'
    operations over the fp64 peak, and the chain of the longest lane."""
    import torch
    from repro_torch.core import GemmSpec
    from repro_torch.core.tiling import ALG1_POLICY
    from repro_torch.core.trace import gemm_trace
    t = gemm_trace(GemmSpec("g", 32, 128, 128), ALG1_POLICY)
    args = [torch.zeros(4, dtype=torch.float64)] * 8 + [torch.zeros((1, 16))] \
        + [torch.zeros(2, dtype=torch.int32)] * 3
    stats = torch.tensor([[5.0, 7.0, 30.0, 0.0, 40.0, 12.0]], dtype=torch.float64)
    b = chip_smoke.program_bound(args, stats, [t])
    nbytes = 8 * 32 + 16 * 4 + 3 * 8 + 2 * 8 * 16 + 8 * 6
    assert b["bytes_ms"] == pytest.approx(nbytes / chip_smoke.HBM_BYTES_PER_S * 1e3)
    assert b["operations_ms"] == pytest.approx(
        chip_smoke.program_ops([t], 40.0) / chip_smoke.FP64_PEAK * 1e3)
    assert b["serial_chain_ops"] == chip_smoke.CHAIN_OPS_PER_STEP * 64 * 12
    assert b["latency_bound_ms"] == pytest.approx(
        b["serial_chain_ops"] * chip_smoke.FP64_DEP_NS / 1e6)
    assert b["lane_steps"] == 40 * 64
    assert b["bound_ms"] == max(b["bytes_ms"], b["operations_ms"])


REPORT = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN43_GLOBAL__N__1c39dd99_10_fastsim_cu_4afe5d5419\
fastsim_scan_kernelILb1EEEvPKiPKdxS4_PKxS4_S6_iiPdS7_Pi' for 'sm_90a'
ptxas info    : Function properties for _ZN43_GLOBAL__N__1c39dd99_10_fastsim_cu_4afe5d5419\
fastsim_scan_kernelILb1EEEvPKiPKdxS4_PKxS4_S6_iiPdS7_Pi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 120 registers, used 1 barriers, 128 bytes smem
ptxas info    : Compiling entry function '_ZN41_GLOBAL__N__d005d734_9_jitarb_cu_af8ec1c1\
13jitarb_kernelENS_6ParamsE' for 'sm_90a'
ptxas info    : Function properties for _ZN41_GLOBAL__N__d005d734_9_jitarb_cu_af8ec1c1\
13jitarb_kernelENS_6ParamsE
    1776 bytes stack frame, 308 bytes spill stores, 792 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 1776 bytes cumulative stack size
"""


@pytest.mark.parametrize("mangled,want", [
    ("_ZN43_GLOBAL__N__026d5794_10_fastsim_cu_4afe5d5419fastsim_scan_kernelILb1ELb0EEEvPKi",
     "fastsim_scan_kernel<true, false>"),
    ("_ZN43_GLOBAL__N__1c39dd99_10_fastsim_cu_4afe5d5419fastsim_scan_kernelILb0EEEvPKiPKdx",
     "fastsim_scan_kernel<false>"),
    # a name whose length prefix follows a hex digit of the namespace hash
    ("_ZN41_GLOBAL__N__d005d734_9_jitarb_cu_af8ec1c113jitarb_kernelENS_6ParamsE",
     "jitarb_kernel"),
    ("_ZN43_GLOBAL__N__026d5794_10_fastsim_cu_4afe5d5417fastsim_mm_kernelEPKiPKdS3_PKxiPd",
     "fastsim_mm_kernel"),
    # the hash's digits "46" spell a longer name that also ends in the kernel's
    ("_ZN43_GLOBAL__N__19f46cba5_10_fastsim_cu_4afe5d5417fastsim_mm_kernelEPKiPKdxS3_PKxPd",
     "fastsim_mm_kernel"),
    ("_Z3foov", "_Z3foov"),
])
def test_ptxas_label_reads_the_kernel_and_its_template(mangled, want):
    assert chip_smoke.ptxas_label(mangled) == want


def test_ptxas_summary_reads_registers_and_spills():
    assert chip_smoke.ptxas_summary(REPORT) == {
        "fastsim_scan_kernel<true>": {"stack": 0, "spill_stores": 0, "spill_loads": 0,
                                      "registers": 120},
        "jitarb_kernel": {"stack": 1776, "spill_stores": 308, "spill_loads": 792,
                          "registers": 128}}


def test_path_counts_names_each_field():
    import collections
    paths = collections.Counter({(48, "shared", "all", "all"): 2, (8, "none", "all", "all"): 1})
    assert chip_smoke.path_counts(paths, chip_smoke.SCAN_PATH_FIELDS) == {
        "chains=48 shares=shared epoch_pow2=all issue_pow2=all": 2,
        "chains=8 shares=none epoch_pow2=all issue_pow2=all": 1}


def test_scan_bound_takes_the_longest_chain():
    """A packed lane's latency bound is its longest segment's chain, and a
    row's ns a step is its ms over that chain's steps."""
    import numpy as np
    from repro_torch.core import GemmSpec
    from repro_torch.core.tiling import ALG1_POLICY
    from repro_torch.core.trace import gemm_trace
    t = gemm_trace(GemmSpec("g", 32, 128, 128), ALG1_POLICY)
    out = np.zeros((2, 5))
    whole = chip_smoke.scan_bound([t], [t, t], out, True, 0)
    assert whole["longest_chain_steps"] == len(t)
    part = chip_smoke.scan_bound([t], [t, t], out, True, 0, longest=10)
    assert part["serial_chain_ops"] == chip_smoke.CHAIN_OPS_PER_STEP * 10
    assert part["bound_ms"] == whole["bound_ms"]
    row = chip_smoke.timed_row(2.0, "events", part)
    assert row["ns_per_step"] == pytest.approx(2.0 * 1e6 / 10)
