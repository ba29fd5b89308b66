"""The port's copies of the simulator's framework-free modules equal the JAX
package's: the designs, Table I and the batch sweep, the lowering (both
policies and more, instruction for instruction), the compiled traces array
for array, the reference PipelineSimulator under the three load models,
the area model, the ISA helpers, and the functional engine in torch (bit
for bit against the reference's numpy/ml_dtypes run)."""

import dataclasses
import random

import numpy as np
import pytest
import torch

from _torch_sim import MODELS, port_model, random_stream, ref_model, to_port
from repro.core import DESIGNS, TABLE_I, batch_sweep
from repro.core import area as r_area
from repro.core import engine as r_engine
from repro.core import isa as r_isa
from repro.core import tiling as r_tiling
from repro.core import timing as r_timing
from repro.core import trace as r_trace
from repro_torch.core import DESIGNS as T_DESIGNS
from repro_torch.core import TABLE_I as T_TABLE_I
from repro_torch.core import area as t_area
from repro_torch.core import batch_sweep as t_batch_sweep
from repro_torch.core import engine as t_engine
from repro_torch.core import isa as t_isa
from repro_torch.core import tiling as t_tiling
from repro_torch.core import timing as t_timing
from repro_torch.core import trace as t_trace

POLICIES = ("ALG1_POLICY", "MAX_REUSE_POLICY", "LOW_REUSE_POLICY")
SPECS = [(16, 32, 16), (48, 96, 64), (17, 33, 15), (100, 64, 40), (3, 2, 1)]


def instr_key(ins):
    return (ins.op.value, ins.dst, ins.src1, ins.src2, ins.addr, ins.tm, ins.tk, ins.tn)


def test_designs_equal():
    assert list(T_DESIGNS) == list(DESIGNS)
    for name, cfg in DESIGNS.items():
        got = T_DESIGNS[name]
        assert dataclasses.asdict(got) == dataclasses.asdict(cfg)
        assert (got.wl_cycles, got.fs_cycles, got.dr_cycles, got.peak_macs_per_cycle,
                got.serial_latency(16)) == (cfg.wl_cycles, cfg.fs_cycles, cfg.dr_cycles,
                                            cfg.peak_macs_per_cycle, cfg.serial_latency(16))
    with pytest.raises(ValueError, match="WLS requires"):
        dataclasses.replace(T_DESIGNS["BASE"], wls=True)


def test_table_i_and_batch_sweep_equal():
    assert {k: dataclasses.asdict(v) for k, v in T_TABLE_I.items()} == \
        {k: dataclasses.asdict(v) for k, v in TABLE_I.items()}
    assert {k: dataclasses.asdict(v) for k, v in t_batch_sweep().items()} == \
        {k: dataclasses.asdict(v) for k, v in batch_sweep().items()}
    assert [s.macs for s in T_TABLE_I.values()] == [s.macs for s in TABLE_I.values()]


@pytest.mark.parametrize("pad", [True, False], ids=["padded", "exact"])
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("shape", SPECS, ids=lambda s: "x".join(map(str, s)))
def test_lowering_equal(shape, policy, pad):
    rp = dataclasses.replace(getattr(r_tiling, policy), pad_tiles=pad)
    tp = dataclasses.replace(getattr(t_tiling, policy), pad_tiles=pad)
    assert dataclasses.asdict(tp) == dataclasses.asdict(rp)
    spec_r, spec_t = r_tiling.GemmSpec("g", *shape), t_tiling.GemmSpec("g", *shape)
    want = [instr_key(i) for i in r_tiling.lower_gemm(spec_r, rp)]
    got = [instr_key(i) for i in t_tiling.lower_gemm(spec_t, tp)]
    assert got == want
    assert t_tiling.stream_stats(spec_t, tp) == r_tiling.stream_stats(spec_r, rp)
    assert [instr_key(i) for i in t_tiling.lowered_stream(spec_t, tp)] == want


def test_lower_reduce_equal():
    for ways in (2, 3, 9):
        r = list(r_tiling.lower_reduce(r_tiling.ReduceSpec("r", 40, 50, ways)))
        t = list(t_tiling.lower_reduce(t_tiling.ReduceSpec("r", 40, 50, ways)))
        assert [instr_key(i) for i in t] == [instr_key(i) for i in r]
    with pytest.raises(ValueError):
        t_tiling.ReduceSpec("r", 4, 4, 1)


def trace_fields(tr):
    return {f.name: getattr(tr, f.name) for f in dataclasses.fields(tr)}


def assert_traces_equal(got, want):
    g, w = trace_fields(got), trace_fields(want)
    assert g.keys() == w.keys()
    for key in w:
        if isinstance(w[key], np.ndarray):
            assert g[key].dtype == w[key].dtype, key
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)
        else:
            assert g[key] == w[key], key


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compiled_traces_equal_random(seed):
    stream = random_stream(random.Random(seed), 150)
    want = r_trace.compile_stream(stream)
    got = t_trace.compile_stream(to_port(stream))
    assert_traces_equal(got, want)
    assert_traces_equal(got.padded(len(got) + 7), want.padded(len(want) + 7))
    for k in (0, 9, 60):
        assert_traces_equal(t_trace.slice_trace(got, k), r_trace.slice_trace(want, k))


@pytest.mark.parametrize("policy", POLICIES)
def test_gemm_traces_equal(policy):
    specs = [TABLE_I["DLRM-2"], r_tiling.GemmSpec("odd", 200, 96, 150)]
    for spec in specs:
        want = r_trace.gemm_trace(spec, getattr(r_tiling, policy))
        got = t_trace.gemm_trace(t_tiling.GemmSpec(spec.name, spec.M, spec.K, spec.N),
                                 getattr(t_tiling, policy))
        assert_traces_equal(got, want)


def schedule_key(res):
    return [dataclasses.astuple(s) for s in res.schedules]


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("seed", [0, 3])
def test_pipeline_simulator_equal(seed, model):
    """The oracle itself: every design, the sub-stage schedules and the
    load model's activity horizon equal, bit for bit."""
    stream = random_stream(random.Random(seed), 120)
    port_stream = to_port(stream)
    for name in DESIGNS:
        rm, tm = ref_model(model, 2), port_model(model, 2)
        want = r_timing.PipelineSimulator(DESIGNS[name], keep_schedules=True,
                                          load_model=rm).run(stream)
        got = t_timing.PipelineSimulator(T_DESIGNS[name], keep_schedules=True,
                                         load_model=tm).run(port_stream)
        assert schedule_key(got) == schedule_key(want), name
        assert dataclasses.astuple(dataclasses.replace(got, schedules=None)) == \
            dataclasses.astuple(dataclasses.replace(want, schedules=None)), name
        assert got.utilization == want.utilization
        assert tm.last_grant == rm.last_grant, name


def test_timing_helpers_equal():
    for rows, cols, tm in ((32, 16, 16), (16, 16, 1), (8, 4, 7)):
        assert t_timing.serial_mm_latency(rows, cols, tm) == \
            r_timing.serial_mm_latency(rows, cols, tm)
    for name in DESIGNS:
        for tm in (1, 16):
            for reused in (False, True):
                assert t_timing.steady_state_interval(T_DESIGNS[name], tm, reused) == \
                    r_timing.steady_state_interval(DESIGNS[name], tm, reused)


def test_isa_helpers_equal():
    stream = random_stream(random.Random(7), 80)
    port = to_port(stream)
    assert [t_isa.tile_bytes(i) for i in port if i.addr] == \
        [r_isa.tile_bytes(i) for i in stream if i.addr]
    assert t_isa.count_ops(port) == r_isa.count_ops(stream)
    assert len(list(t_isa.mm_instrs(port))) == len(list(r_isa.mm_instrs(stream)))
    t_isa.validate_stream(port)
    bad = [t_isa.Instr(t_isa.Op.MM, dst=0, src1=1, src2=2)]
    with pytest.raises(ValueError, match="used before defined"):
        t_isa.validate_stream(bad)
    rf = t_isa.TileRegisterFile()
    rf.write(3, ("B", 0, 0))
    assert not rf.mm_weight_reusable(3)
    rf.latch_weights(3)
    assert rf.mm_weight_reusable(3)
    rf.write(3, ("B", 0, 1))
    assert not rf.mm_weight_reusable(3)
    assert (t_isa.NUM_TREGS, t_isa.TILE_M, t_isa.TILE_K, t_isa.TILE_N) == \
        (r_isa.NUM_TREGS, r_isa.TILE_M, r_isa.TILE_K, r_isa.TILE_N) == (8, 16, 32, 16)


def test_area_equal():
    for name in DESIGNS:
        assert t_area.area_mm2(name) == r_area.area_mm2(name)
        assert t_area.data_opt_of(name) == r_area.data_opt_of(name)
        for speedup in (1.0, 2.5, 4.8):
            assert t_area.perf_per_area(name, speedup) == r_area.perf_per_area(name, speedup)
            assert t_area.energy_efficiency(name, speedup) == \
                r_area.energy_efficiency(name, speedup)
    for key in ("BASELINE_AREA_MM2", "SKYLAKE_GT2_4C_DIE_MM2", "AREA_OVERHEAD",
                "PAPER_RUNTIME_REDUCTION", "PAPER_ENERGY_EFFICIENCY",
                "PAPER_BEST_NORMALIZED_RUNTIME"):
        assert getattr(t_area, key) == getattr(r_area, key), key


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("shape", [(16, 32, 16), (48, 96, 64), (17, 33, 15), (3, 2, 1)],
                         ids=lambda s: "x".join(map(str, s)))
def test_run_gemm_bit_equal(shape, policy):
    """The functional engine in torch (bf16 by torch.bfloat16) against the
    reference's numpy engine (ml_dtypes.bfloat16): equal bits."""
    m, k, n = shape
    rng = np.random.default_rng(m * 10007 + k * 101 + n)
    a = rng.normal(size=(m, k)).astype(np.float32)
    b = rng.normal(size=(k, n)).astype(np.float32)
    c = rng.normal(size=(m, n)).astype(np.float32)
    want = r_engine.run_gemm(a, b, c, policy=getattr(r_tiling, policy))
    got = t_engine.run_gemm(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(c),
                            policy=getattr(t_tiling, policy))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().view(np.int32), want.view(np.int32))
    ref = t_engine.reference_gemm(torch.from_numpy(a), torch.from_numpy(b),
                                  torch.from_numpy(c))
    # the one-product reference sums K in the library's order: the
    # reference's own tolerance between the two (tests/test_tiling.py:39)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ref.numpy(), r_engine.reference_gemm(a, b, c),
                               rtol=1e-6, atol=1e-6)
