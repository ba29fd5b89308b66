"""The port's simulator lanes against the JAX package's numpy lane and the
reference PipelineSimulator, with ``==``: the port's ``"numpy"`` lane (a
copy) and its ``"torch"`` lane (the CUDA kernels' plain versions, on the
CPU) over the reference's random streams x all 8 designs x the "port",
"epoch" and "static" load models, in the sweep, cores and packed layouts
and on the MM-only path; the golden figure fixtures; and the dispatch:
``"cuda"``, and ``"fast"`` above its threshold, raise without a card."""

import dataclasses
import json
import math
import pathlib
import random

import numpy as np
import pytest
import torch

from _torch_sim import (MODELS, REL, port_model, port_params, random_stream, ref_model,
                        result_key, to_port)
from repro.core import DESIGNS, TABLE_I, GemmSpec
from repro.core import fastsim as r_fastsim
from repro.core import simulator as r_sim
from repro.core.tiling import ALG1_POLICY
from repro.core.timing import PipelineSimulator
from repro.core.trace import compile_stream, gemm_trace
from repro_torch import core as tcore
from repro_torch.core import fastsim as t_fastsim
from repro_torch.core import simulator as t_sim
from repro_torch.core import timing as t_timing
from repro_torch.core import trace as t_trace
from repro_torch.core import workloads as t_workloads
from repro_torch.kernels import fastsim_scan as fsk
from repro_torch.multicore import chip as t_chip

FIXTURES = pathlib.Path(__file__).parent / "fixtures"
NAMES = sorted(DESIGNS)
CPU = dict(backend="torch", device="cpu")


def ref_params(model, cfg):
    return r_fastsim.StreamModelParams.from_model(ref_model(model, cfg.load_ports))


def tcfg(cfg):
    return tcore.EngineConfig(**dataclasses.asdict(cfg))


def tspec(spec):
    return tcore.GemmSpec(spec.name, spec.M, spec.K, spec.N)


def traces_of(seeds, n=120):
    streams = [random_stream(random.Random(s), n) for s in seeds]
    return ([compile_stream(s) for s in streams],
            [t_trace.compile_stream(to_port(s)) for s in streams])


# ---------------------------------------------------------------- numpy lane
@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_numpy_lane_equals_reference(seed, model):
    """The copy of the numpy lane, over live models and inlined, equals the
    reference's numpy lane and its PipelineSimulator, for every design."""
    stream = random_stream(random.Random(seed), 120)
    rt, tt = compile_stream(stream), t_trace.compile_stream(to_port(stream))
    for name in NAMES:
        cfg = DESIGNS[name]
        rm = ref_model(model, cfg.load_ports)
        oracle = PipelineSimulator(cfg, load_model=rm).run(stream)
        want, lg = r_fastsim._run_numpy_params(rt, cfg, ref_params(model, cfg))
        assert result_key(want, lg) == result_key(oracle, rm.last_grant), name
        tm = port_model(model, cfg.load_ports)
        live = t_fastsim.run_trace_numpy(tt, tcfg(cfg), tm)
        assert result_key(live, tm.last_grant) == result_key(want, lg), name
        tp = t_fastsim.StreamModelParams.from_model(port_model(model, cfg.load_ports))
        got, glg = t_fastsim._run_numpy_params(tt, tcfg(cfg), tp)
        assert result_key(got, glg) == result_key(want, lg), name


def test_run_segment_resume_equals_reference():
    """The resumable loop: the same snapshots, and a resumed run equal to
    the whole run, as in the reference's test_run_segment_resume_parity."""
    stream = random_stream(random.Random(11), 900)
    rt, tt = compile_stream(stream), t_trace.compile_stream(to_port(stream))
    cfg = DESIGNS["RASA-WLBP"]
    shares = tuple([6.0, 9.0, 12.0, 18.0, 24.0, 32.0] * 4)
    rp = r_fastsim.StreamModelParams(cfg.load_ports, 1, shares, 2048.0, 64.0, 2048.0, True)
    tp = port_params(rp)
    rr, rlg, rsnaps = r_fastsim.run_segment(rt, cfg, rp, snap_stride=128)
    tr, tlg, tsnaps = t_fastsim.run_segment(tt, tcfg(cfg), tp, snap_stride=128)
    assert result_key(tr, tlg) == result_key(rr, rlg)
    assert [dataclasses.astuple(s) for s in tsnaps] == [dataclasses.astuple(s) for s in rsnaps]
    assert [s.horizon for s in tsnaps] == [s.horizon for s in rsnaps]
    for s in tsnaps[::3]:
        r2, lg2, _ = t_fastsim.run_segment(tt, tcfg(cfg), tp, carry=s)
        assert result_key(r2, lg2) == result_key(rr, rlg), s.i


def test_stream_params_from_and_to_models():
    cfg = tcore.DESIGNS["RASA-WLBP"]
    P = t_fastsim.StreamModelParams
    assert P.from_model(t_timing.LoadStreamModel(2, 1)) == P(2, 1)
    epoch = t_chip.EpochBandwidthLoadModel(2, (8.0, 16.0), 256.0, 64.0, 2048.0, 1, True)
    assert P.from_model(epoch) == P(2, 1, (8.0, 16.0), 256.0, 64.0, 2048.0, True)
    static = t_chip.SharedBandwidthLoadModel(2, 12.0, 1024.0, 1, True)
    assert P.from_model(static) == P(2, 1, (), math.inf, 12.0, 1024.0, True)
    assert P.from_model(t_chip.EpochBandwidthLoadModel(
        2, (), math.inf, 12.0, record_grants=True)) is None

    class Throttled(t_timing.LoadStreamModel):
        def acquire(self, t_request, n_bytes):
            start, stall = super().acquire(t_request, n_bytes)
            return start + 100.0, stall

    assert P.from_model(Throttled(2)) is None
    for p in (P(2), P(2, 1, (8.0,), 256.0, 64.0, 2048.0, True)):
        model = p.make_model()
        assert P.from_model(model) == p
    assert type(P(2).make_model()) is t_timing.LoadStreamModel
    assert P.for_config(cfg) == P(cfg.load_ports)
    with pytest.raises(ValueError):
        P(2, tail_share=0.0)
    spec = TABLE_I["DLRM-2"]
    ref = r_sim.simulate(spec, "RASA-WLBP")
    got = t_sim.simulate(tspec(spec), "RASA-WLBP", load_model=Throttled(2), backend="numpy")
    assert got.cycles > ref.cycles        # the custom model runs on the oracle


# ---------------------------------------------------------------- torch lane
def numpy_grid(rtraces, cfgs, params_of):
    return [[r_fastsim._run_numpy_params(t, c, params_of(c)) for c in cfgs] for t in rtraces]


@pytest.mark.parametrize("model", MODELS + ("port_stores",))
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_torch_lane_sweep_layout(seed, model):
    """One trace, the 8 designs as lanes.  "port" takes the MM-only path
    (stores free); "port_stores" the full scan's port template (stores
    serialized on their port, not charged)."""
    (rt,), (tt,) = traces_of([seed])
    cfgs = [DESIGNS[n] for n in NAMES]
    if model == "port":
        params, of = None, r_fastsim.StreamModelParams.for_config
    elif model == "port_stores":
        params = r_fastsim.StreamModelParams(2, 1)
        of = lambda c: params  # noqa: E731
    else:
        params = ref_params(model, cfgs[0])
        of = lambda c: params  # noqa: E731
    want = numpy_grid([rt], cfgs, of)[0]
    tparams = port_params(params) if params else None
    got = t_fastsim.sweep_trace(tt, [tcfg(c) for c in cfgs], tparams, **CPU)
    assert [result_key(g) for g in got] == [result_key(w) for w, _ in want]
    numpy = t_fastsim.sweep_trace(tt, [tcfg(c) for c in cfgs], tparams, backend="numpy")
    assert [result_key(g) for g in numpy] == [result_key(w) for w, _ in want]


@pytest.mark.parametrize("model", MODELS)
def test_torch_lane_cores_layout(model):
    """A trace per lane (different lengths), each lane its own share
    schedule and tail; results and last_grant equal the numpy lane's."""
    rtraces, ttraces = traces_of([0, 1, 2, 3], n=100)
    rtraces.append(compile_stream(random_stream(random.Random(9), 40)))
    ttraces.append(t_trace.compile_stream(to_port(random_stream(random.Random(9), 40))))
    cfg = DESIGNS["RASA-DMDB-WLS"]
    if model == "port":
        params = [r_fastsim.StreamModelParams(2, 1) for _ in rtraces]
    elif model == "epoch":
        params = [r_fastsim.StreamModelParams(2, 1, tuple(s * (k + 1) for s in (8.0, 4.0, 16.0)),
                                              256.0, 64.0 / (k + 1), 2048.0, True)
                  for k in range(len(rtraces))]
    else:
        params = [r_fastsim.StreamModelParams(2, 1, (), math.inf, 6.0 + 3 * k, 1024.0, True)
                  for k in range(len(rtraces))]
    want = [r_fastsim._run_numpy_params(t, cfg, p) for t, p in zip(rtraces, params)]
    got = t_fastsim.run_cores(ttraces, tcfg(cfg), [port_params(p) for p in params], **CPU)
    assert [result_key(r, lg) for r, lg in got] == [result_key(r, lg) for r, lg in want]


def test_torch_lane_cores_heterogeneous():
    """One design per core: the reference's lane groups, each its own
    launch of the cores layout."""
    rtraces, ttraces = traces_of([4, 5, 6, 7])
    names = ["BASE", "RASA-WLBP", "RASA-WLBP", "RASA-DM-PIPE"]
    params = [r_fastsim.StreamModelParams(2, 1, (8.0, 16.0), 256.0, 32.0 + k, 2048.0, True)
              for k in range(4)]
    want = [r_fastsim._run_numpy_params(t, DESIGNS[n], p)
            for t, n, p in zip(rtraces, names, params)]
    got = t_fastsim.run_cores(ttraces, [tcore.DESIGNS[n] for n in names],
                              [port_params(p) for p in params], **CPU)
    assert [result_key(r, lg) for r, lg in got] == [result_key(r, lg) for r, lg in want]


@pytest.mark.parametrize("model", MODELS + ("port_stores",))
def test_torch_lane_packed_layout(model):
    """Several traces x the 8 designs: the traces packed back to back with
    OP_END markers (bucket and port_stores), or the MM-only path's one
    launch of every (trace, design) lane (port)."""
    rtraces, ttraces = traces_of([0, 1, 2], n=90)
    cfgs = [DESIGNS[n] for n in NAMES]
    if model == "port":
        params, of = None, r_fastsim.StreamModelParams.for_config
    elif model == "port_stores":
        params = r_fastsim.StreamModelParams(2, 1)
        of = lambda c: params  # noqa: E731
    else:
        params = ref_params(model, cfgs[0])
        of = lambda c: params  # noqa: E731
    want = numpy_grid(rtraces, cfgs, of)
    got = t_fastsim.sweep_traces(ttraces, [tcfg(c) for c in cfgs],
                                 port_params(params) if params else None, **CPU)
    assert [[result_key(g) for g in row] for row in got] == \
        [[result_key(w) for w, _ in row] for row in want]


def test_packed_plain_rows_and_walks():
    """The packed layout's rows equal the lanes' results run one trace at a
    time, walk steps included (the kernel's fifth output)."""
    _, ttraces = traces_of([0, 1], n=80)
    cfgs = [tcore.DESIGNS[n] for n in NAMES]
    p = t_fastsim.StreamModelParams(2, 1, (8.0, 16.0, 48.0), 256.0, 64.0, 2048.0, True)
    packed, _, _ = t_fastsim._pack_lane(ttraces)
    _, seg = t_fastsim._scan([packed], [(0, c, p) for c in cfgs], "torch", "cpu",
                             n_seg=len(ttraces))
    for s, tt in enumerate(ttraces):
        out, _ = t_fastsim._scan([tt], [(0, c, p) for c in cfgs], "torch", "cpu")
        np.testing.assert_array_equal(seg[s], out)
    assert (seg[:, :, 4] > 0).all()          # the bucket walked


@pytest.mark.parametrize("layout", ["sweep", "packed"])
def test_mm_only_path_gemms(layout):
    """The paper's port model on real lowered GEMMs: sweep_designs and
    sweep_workload on the torch lane equal the reference's numpy lane."""
    specs = [GemmSpec("small", 128, 256, 256), TABLE_I["DLRM-2"],
             GemmSpec("odd", 200, 96, 150)]
    if layout == "sweep":
        for spec in specs:
            want = r_sim.sweep_designs(spec, backend="numpy")
            got = t_sim.sweep_designs(tspec(spec), **CPU)
            assert {k: dataclasses.astuple(v) for k, v in got.items()} == \
                {k: dataclasses.astuple(v) for k, v in want.items()}
    else:
        want = r_sim.sweep_workload(specs, backend="numpy")
        got = t_sim.sweep_workload([tspec(s) for s in specs], **CPU)
        assert [{k: dataclasses.astuple(v) for k, v in row.items()} for row in got] == \
            [{k: dataclasses.astuple(v) for k, v in row.items()} for row in want]


def test_mm_only_path_non_power_of_two_rates():
    """An issue rate of 12 a cycle and 3 load ports.  The MM-only path's
    closed-form TL grant times (a max-accumulate over t_issue - k/3, the
    reference's) round otherwise than the numpy lane's step-by-step
    start + 1/3, by an ulp, so here it is held to the reference's own
    bound between its lanes, REL = 1e-6 (tests/test_fastsim.py:30); at the
    paper's rates (16 a cycle, 2 ports: powers of two) both are exact and
    the other tests hold it with ==."""
    odd = [dataclasses.replace(DESIGNS[n], name=n, core_issue_width=3, load_ports=3)
           for n in NAMES]
    (rt,), (tt,) = traces_of([8], n=200)
    want = [r_fastsim._run_numpy_params(rt, c, r_fastsim.StreamModelParams.for_config(c))[0]
            for c in odd]
    got = t_fastsim.sweep_trace(tt, [tcfg(c) for c in odd], **CPU)
    for g, w in zip(got, want):
        assert g.cycles == pytest.approx(w.cycles, rel=REL)
        assert (g.wl_skips, g.n_mm, g.n_tl, g.n_ts) == (w.wl_skips, w.n_mm, w.n_tl, w.n_ts)
    t_tl = t_fastsim._mm_analysis(tt).tl_pos / 12.0
    drift = np.arange(len(t_tl), dtype=np.float64) * (1.0 / 3.0)
    closed = np.maximum.accumulate(t_tl - drift) + drift
    stepped, free = [], 0.0
    for t in t_tl.tolist():
        stepped.append(max(t, free))
        free = stepped[-1] + 1.0 / 3.0
    assert (closed != stepped).any() and np.abs(closed - stepped).max() < 1e-12


def test_simulator_facade_lanes():
    spec = GemmSpec("small", 128, 256, 256)
    for name in ("BASE", "RASA-DMDB-WLS"):
        ref = r_sim.simulate(spec, name)
        for kw in (dict(backend="numpy"), CPU, dict(backend="reference")):
            got = t_sim.simulate(tspec(spec), name, **kw)
            assert dataclasses.astuple(got) == dataclasses.astuple(ref), kw
        assert t_sim.normalized_runtime(tspec(spec), name, backend="numpy") == \
            r_sim.normalized_runtime(spec, name, backend="numpy")
    with pytest.raises(ValueError, match="unknown backend"):
        t_sim.simulate(tspec(spec), "BASE", backend="jax")


def test_floor_division_is_pythons():
    """The plain version's epoch index: torch.div(..., "floor") is Python's
    float //, the epoch length infinite included (where t // inf is 0)."""
    rng = np.random.default_rng(0)
    a = np.concatenate([rng.uniform(0, 1e7, 2000), np.arange(0, 8192.0, 0.5),
                        [0.0, 1024.0, 2048.0, 1e15, 3.0, 0.1 * 3]])
    for e in (1024.0, 256.0, 0.1, 3.0, 1e-3, math.inf, 7.25):
        got = torch.div(torch.tensor(a), torch.tensor(e, dtype=torch.float64),
                        rounding_mode="floor").numpy()
        want = np.array([x // e for x in a])
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("lane", ["numpy", "torch"])
def test_unreachable_grant_raises(lane):
    """A bucket that can never refill (tail share 0 past the schedule; the
    constructor refuses it, so it is forced here): the numpy lane raises,
    and so does the torch lane, with the same error (the kernel flags the
    lane and its wrapper raises it: tests/test_torch_cuda_sim.py)."""
    (rt,), (tt,) = traces_of([2], n=60)
    cfg = DESIGNS["RASA-WLBP"]
    rp = r_fastsim.StreamModelParams(2, 1, (8.0,), 64.0, 1.0, 512.0, True)
    object.__setattr__(rp, "tail_share", 0.0)
    with pytest.raises(RuntimeError, match="can never be granted"):
        r_fastsim._run_numpy_params(rt, cfg, rp)
    tp = port_params(r_fastsim.StreamModelParams(2, 1, (8.0,), 64.0, 1.0, 512.0, True))
    object.__setattr__(tp, "tail_share", 0.0)
    with pytest.raises(RuntimeError, match="can never be granted"):
        if lane == "numpy":
            t_fastsim._run_numpy_params(tt, tcfg(cfg), tp)
        else:
            t_fastsim.sweep_trace(tt, [tcfg(cfg), tcore.DESIGNS["BASE"]], tp, **CPU)


# ------------------------------------------------------------ golden figures
def test_fig7_fixture_on_both_lanes():
    """Fig. 7's batches to 256 (RASA-DMDB-WLS cycles) on the numpy lane,
    and to 64 on the torch lane, equal the fixture's raw cycles."""
    fixture = json.loads((FIXTURES / "fig7_batch.json").read_text())
    sweep = t_workloads.batch_sweep(batches=tuple(int(b) for b in fixture))
    for backend, kw, top in (("numpy", {}, 256), ("torch", dict(device="cpu"), 64)):
        batches = [b for b in sweep if b <= top]
        grid = t_sim.sweep_workload([sweep[b] for b in batches],
                                    designs=["BASE", "RASA-DMDB-WLS"], backend=backend, **kw)
        for b, row in zip(batches, grid):
            assert row["RASA-DMDB-WLS"].cycles == fixture[str(b)]["cycles"], (backend, b)
            assert row["RASA-DMDB-WLS"].cycles / row["BASE"].cycles == \
                fixture[str(b)]["normalized"], (backend, b)


def test_fig5_fixture_on_numpy_lane():
    fixture = json.loads((FIXTURES / "fig5_runtime.json").read_text())
    layers = sorted({k.split("/")[0] for k in fixture})
    grid = t_sim.sweep_workload([tspec(TABLE_I[k]) for k in layers], backend="numpy")
    for layer, row in zip(layers, grid):
        for design in NAMES:
            want = fixture[f"{layer}/{design}"]
            assert row[design].cycles == want["cycles"], (layer, design)
            assert row[design].cycles / row["BASE"].cycles == want["normalized"]


# ------------------------------------------------------------------ dispatch
def test_fast_resolves_by_size():
    assert t_fastsim.FAST_CUDA_MIN_INSTRS == r_fastsim.FAST_JAX_MIN_INSTRS == 32768
    assert t_fastsim.FAST_CUDA_MIN_CORES_INSTRS == r_fastsim.FAST_JAX_MIN_CORES_INSTRS
    assert t_fastsim.resolve_backend("fast", 32767) == "numpy"
    assert t_fastsim.resolve_backend("numpy", 10 ** 9) == "numpy"
    assert t_fastsim.resolve_backend("torch", 10 ** 9) == "torch"
    with pytest.raises(ValueError, match="unknown backend"):
        t_fastsim.resolve_backend("jax", 1)
    # below the threshold "fast" is the numpy lane
    (rt,), (tt,) = traces_of([1])
    cfgs = [tcore.DESIGNS[n] for n in NAMES]
    got = t_fastsim.sweep_trace(tt, cfgs, backend="fast")
    assert [result_key(g) for g in got] == \
        [result_key(g) for g in t_fastsim.sweep_trace(tt, cfgs, backend="numpy")]


def test_cuda_and_fast_raise_without_card():
    """No fallback: without a card "cuda", "fast" above its threshold and
    "torch" on the card (the default device) raise."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfgs = [tcore.DESIGNS[n] for n in NAMES]
    (_,), (tt,) = traces_of([0])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_fastsim.resolve_backend("fast", 32768)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_fastsim.sweep_trace(tt, cfgs, backend="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_fastsim.sweep_trace(tt, cfgs, backend="torch")
    big = t_trace.gemm_trace(tspec(TABLE_I["DLRM-2"]), ALG1_POLICY)
    assert len(big) * len(cfgs) >= t_fastsim.FAST_CUDA_MIN_INSTRS
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_sim.sweep_workload([tspec(TABLE_I["DLRM-2"])], backend="fast")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_fastsim.run_cores([tt, tt], cfgs[0], [t_fastsim.StreamModelParams(2, 1)] * 2,
                            backend="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_sim.simulate(tspec(TABLE_I["DLRM-2"]), "BASE", backend="cuda")


def test_entry_points_default_to_the_card():
    """Called with no backend, every entry point runs on the card: without
    one it raises, however small the work."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    spec = tspec(GemmSpec("small", 16, 32, 16))
    cfgs = [tcore.DESIGNS[n] for n in NAMES]
    (_,), (tt,) = traces_of([0])
    calls = {"simulate": lambda: t_sim.simulate(spec, "BASE"),
             "sweep_designs": lambda: t_sim.sweep_designs(spec),
             "sweep_workload": lambda: t_sim.sweep_workload([spec]),
             "normalized_runtime": lambda: t_sim.normalized_runtime(spec, "RASA-WLBP"),
             "sweep_trace": lambda: t_fastsim.sweep_trace(tt, cfgs[:1]),
             "sweep_traces": lambda: t_fastsim.sweep_traces([tt], cfgs[:1]),
             "run_cores": lambda: t_fastsim.run_cores([tt], cfgs[0],
                                                      [t_fastsim.StreamModelParams(2, 1)])}
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
            pytest.fail(f"{name} ran without a card")


def test_kernel_wrappers_refuse_cpu_tensors():
    """The kernels' own wrappers launch or raise: CPU tensors go to the
    plain versions only through the dispatching entry points."""
    code = torch.zeros(4, dtype=torch.int32)
    val = torch.zeros(4, dtype=torch.float64)
    lane_f = torch.zeros((1, len(fsk.LANE_FIELDS)), dtype=torch.float64)
    lane_i = torch.tensor([[0, 4, 0, 0]])
    with pytest.raises(ValueError, match="CUDA device"):
        fsk.fastsim_scan_cuda(code, val, lane_f, lane_i, torch.zeros(1, dtype=torch.float64),
                              bucket=False)
    with pytest.raises(ValueError, match="CUDA device"):
        fsk.fastsim_mm_scan_cuda(code, torch.zeros((4, 6), dtype=torch.float64),
                                 torch.zeros((1, 6), dtype=torch.float64),
                                 torch.tensor([[0, 4]]))
    with pytest.raises(ValueError, match="CUDA device"):
        fsk.fastsim_events_cuda(code, val, lane_f, lane_i, torch.zeros(1, dtype=torch.float64),
                                bucket=False)
    assert fsk.launches == {"scan": 0, "mm_scan": 0, "events": 0}
