"""The port's telemetry (``repro_torch.obs``) against the JAX package's
``repro.obs`` on the same inputs, made from seeds.

* **Replay** -- the port's Python copy of ``replay_events`` and the event
  replay's plain version (``fastsim_events_plain`` on the CPU, through
  ``replay_many``) equal the reference's ``replay_events`` column by
  column, under all 8 designs and the port and bucket models, on NOP-padded
  and random streams.
* **Timelines** -- closed, online and faulted telemetry on the port's
  ``reference``, ``numpy`` and ``torch`` (CPU) chips equal the reference's:
  every segment field, every bucket, the share and active traces, the
  marks; the buckets conserve as ``tests/test_obs.py`` checks.
* **Exporters** -- the Perfetto golden fixture (read, never rewritten), a
  well-formed trace, the stage-event cap, ``write_trace``,
  ``render_timeline``, and telemetry off by default.
* **Repairs** -- ``ChipReport.attribution`` and ``BatchReport.attribution``
  equal the reference's with telemetry off and on.
* ``configs/rasa_paper.py`` against the reference's.
"""

import dataclasses
import json
import pathlib
import random

import numpy as np
import pytest

from _sim_streams import random_stream
from _torch_chip import PORT, REF, chips, fields_key, to_port_requests
from repro.configs import rasa_paper as r_paper
from repro.core import isa as r_isa
from repro.core import trace as r_trace
from repro.core.designs import DESIGNS as R_DESIGNS
from repro.core.fastsim import StreamModelParams as RP
from repro.core.workloads import TABLE_I as R_TABLE
from repro.obs import record as r_record
from repro.obs import TelemetryConfig as RT
from repro_torch.configs import rasa_paper as t_paper
from repro_torch.core import isa as t_isa
from repro_torch.core import trace as t_trace
from repro_torch.core.designs import DESIGNS as T_DESIGNS
from repro_torch.core.fastsim import StreamModelParams as TP
from repro_torch.core.workloads import TABLE_I as T_TABLE
from repro_torch.obs import TelemetryConfig as TT
from repro_torch.obs import render_timeline, to_trace_events, write_trace
from repro_torch.obs import record as t_record
from repro_torch.obs.attribution import BUCKETS, simreport_attribution

FIXTURES = pathlib.Path(__file__).parent / "fixtures"
REL = 1e-6                       # tests/test_obs.py's tolerance of the golden fixture

#: tests/test_obs.py's throttling schedule
SHARES = tuple([4.0, 8.0, 16.0, 6.0] * 8)
EPOCH, TAIL, BURST = 512.0, 32.0, 2048.0
#: tests/test_obs.py's skewed 4-GEMM closed workload
CLOSED_WORKLOAD = ("DLRM-2", "BERT-1", "DLRM-2", "DLRM-2")
#: a closed workload small enough for the plain lanes on the CPU
SMALL = [(48, 128, 128), (16, 256, 128), (64, 128, 64), (8, 128, 256)]
STAGES = dict(enabled=True, stages=True)
EVENT_COLUMNS = ("tl_index", "tl_start", "tl_stall", "tl_bytes", "ts_index", "ts_start",
                 "ts_stall", "mm_index", "mm_skip", "mm_wl_start", "mm_ff_start",
                 "mm_ff_end", "mm_fs_end", "mm_dr_end")


# ------------------------------------------------------------ configs
def test_rasa_paper_copy():
    for name in ("ARRAY_ROWS", "ARRAY_COLS", "ENGINE_CLOCK_HZ", "CORE_CLOCK_HZ"):
        assert getattr(t_paper, name) == getattr(r_paper, name), name
    assert t_paper.__all__ == r_paper.__all__
    assert list(t_paper.TABLE_I) == list(r_paper.TABLE_I)
    for k in r_paper.TABLE_I:
        assert dataclasses.astuple(t_paper.TABLE_I[k]) == dataclasses.astuple(r_paper.TABLE_I[k])
    assert {k: dataclasses.astuple(v) for k, v in t_paper.DESIGNS.items()} == \
        {k: dataclasses.astuple(v) for k, v in r_paper.DESIGNS.items()}
    for pol in ("ALG1_POLICY", "LOW_REUSE_POLICY", "MAX_REUSE_POLICY"):
        assert dataclasses.astuple(getattr(t_paper, pol)) == \
            dataclasses.astuple(getattr(r_paper, pol)), pol
    assert dataclasses.astuple(t_paper.get_design("RASA-WLBP")) == \
        dataclasses.astuple(r_paper.get_design("RASA-WLBP"))


# ------------------------------------------------------------- replay
def _gemm_traces():
    """(reference trace, port trace) of tests/test_obs.py's stream."""
    return (r_trace.compile_stream(list(REF.lower_gemm(REF.GemmSpec("obs", 64, 256, 256),
                                                        REF.ALG1))),
            t_trace.compile_stream(list(PORT.lower_gemm(PORT.GemmSpec("obs", 64, 256, 256),
                                                         PORT.ALG1))))


def _random_traces(seed: int, n: int = 120):
    """(reference trace, port trace) of one random stream."""
    return (r_trace.compile_stream(random_stream(random.Random(seed), n, r_isa)),
            t_trace.compile_stream(random_stream(random.Random(seed), n, t_isa)))


def _with_nops(trace, every: int, tail: int):
    """``trace`` with a NOP after every ``every`` instructions and ``tail``
    NOPs at its end (the issue index counts NOP positions)."""
    pos = np.arange(every, len(trace), every)
    op = np.insert(trace.opcode, pos, 3)

    def ins(a):
        return np.insert(a, pos, np.zeros(len(pos), dtype=a.dtype))

    out = dataclasses.replace(trace, opcode=op, r_dst=ins(trace.r_dst), r_a=ins(trace.r_a),
                              r_b=ins(trace.r_b), nbytes=ins(trace.nbytes), tm=ins(trace.tm),
                              macs=ins(trace.macs), reusable=ins(trace.reusable))
    return out.padded(len(out) + tail)


def _params(model: str, cfg):
    """(reference, port) stream-model params: the port model (stores free),
    or tests/test_obs.py's throttling bucket with stores charged."""
    if model == "port":
        return RP(cfg.load_ports), TP(cfg.load_ports)
    args = (cfg.load_ports, cfg.store_ports, SHARES, EPOCH, TAIL, BURST, True)
    return RP(*args), TP(*args)


def assert_same_events(got, want):
    for col in EVENT_COLUMNS:
        g, w = getattr(got, col), getattr(want, col)
        assert g.dtype == w.dtype and g.shape == w.shape, col
        np.testing.assert_array_equal(g, w, err_msg=col)
    assert (got.cycles, got.bw_stall, got.wl_skips) == (want.cycles, want.bw_stall, want.wl_skips)


@pytest.mark.parametrize("model", ["port", "bucket"])
@pytest.mark.parametrize("design", sorted(R_DESIGNS))
def test_replay_parity(design, model):
    """The Python copy and the plain version equal the reference's replay
    exactly, on tests/test_obs.py's stream and on a NOP-padded random one."""
    rcfg, tcfg = R_DESIGNS[design], T_DESIGNS[design]
    rp, tp = _params(model, rcfg)
    (rg, tg), (rr, tr) = _gemm_traces(), _random_traces(sorted(R_DESIGNS).index(design))
    rr, tr = _with_nops(rr, 7, 3), _with_nops(tr, 7, 3)
    wants = [r_record.replay_events(t, rcfg, rp) for t in (rg, rr)]
    for t, want in zip((tg, tr), wants):
        assert_same_events(t_record.replay_events(t, tcfg, tp), want)
    for got, want in zip(t_record.replay_many([tg, tr], [tcfg] * 2, [tp] * 2,
                                              backend="torch", device="cpu"), wants):
        assert_same_events(got, want)


def test_replay_many_mixed_lanes():
    """One replay_many call over lanes of both load-model kinds, stores on
    their port and charged, an uncharged bucket, a non-power-of-two epoch
    and issue rate, repeated traces and an empty lane: the plain version on
    the CPU and the numpy lane against the reference, lane by lane."""
    rcfg = R_DESIGNS["RASA-DMDB-WLS"]
    slow = dict(core_clock_hz=1.5e9)        # an issue rate of 12 a cycle
    rcfgs = [rcfg, dataclasses.replace(rcfg, **slow), R_DESIGNS["RASA-WLBP"], rcfg, rcfg]
    tcfgs = [T_DESIGNS[c.name] if not i % 4 == 1 else
             dataclasses.replace(T_DESIGNS[c.name], **slow) for i, c in enumerate(rcfgs)]
    margs = [(2, 1), (2, 1, (9.0, 3.0, 20.0), 500.0, 7.0, 1024.0, True),
             (2, 1, SHARES, EPOCH, TAIL, BURST, False), (2, None), (2, 1, (), float("inf"),
                                                                    5.0, 512.0, True)]
    pairs = [_random_traces(s, n) for s, n in ((1, 90), (2, 150), (3, 40), (1, 90), (4, 0))]
    pairs[3] = pairs[0]                       # the same trace object twice
    want = [r_record.replay_events(r, c, RP(*a)) for (r, _), c, a in zip(pairs, rcfgs, margs)]
    for backend in ("torch", "numpy", "reference", "fast"):
        got = t_record.replay_many([t for _, t in pairs], tcfgs, [TP(*a) for a in margs],
                                   backend=backend, device="cpu")
        for g, w in zip(got, want):
            assert_same_events(g, w)


def test_replay_never_granted_raises():
    """A request a schedule without a tail share can never grant raises the
    reference's error on every CPU lane: the Python copy and the plain
    version (the schedule is made past its own check, as the card tests
    make it)."""
    params = []
    for cls in (RP, TP):
        p = cls(2, 1, (8.0,), 64.0, 1.0, 1024.0, True)
        object.__setattr__(p, "tail_share", 0.0)
        params.append(p)
    (rr, tr) = _random_traces(5, 300)
    with pytest.raises(RuntimeError, match="can never be granted"):
        r_record.replay_events(rr, R_DESIGNS["RASA-WLBP"], params[0])
    for backend in ("numpy", "torch"):
        with pytest.raises(RuntimeError, match="can never be granted"):
            t_record.replay_many([tr], [T_DESIGNS["RASA-WLBP"]], [params[1]],
                                 backend=backend, device="cpu")


def test_replay_many_refuses_the_card_without_one():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, tr = _random_traces(6, 20)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_record.replay_many([tr], [T_DESIGNS["BASE"]], [TP(1)], backend="cuda")


# ---------------------------------------------------------- timelines
def _assert_conserved(att, window, n_cores):
    assert att is not None and len(att.cores) == n_cores
    assert att.window == pytest.approx(window, rel=1e-9)
    for c in att.cores:
        for b in BUCKETS:
            assert getattr(c, b) >= -1e-6, (c.core, b)
        assert c.total == pytest.approx(window, rel=1e-9, abs=1e-6), c.core
    total = sum(att.total(b) for b in BUCKETS)
    assert total == pytest.approx(att.occupied_cycles, rel=1e-9, abs=1e-6)
    assert sum(att.fractions().values()) == pytest.approx(1.0, abs=1e-9)


def _attr_key(att):
    return (att.window, tuple(dataclasses.astuple(c) for c in att.cores))


def assert_same_telemetry(got, want):
    """Every field of two ChipTelemetry: the segments field by field (their
    events column by column), the buckets, traces, marks and config."""
    plain = ("kind", "design", "n_cores", "epoch_cycles", "window", "share_trace",
             "active_trace", "core_weights", "marks")
    for f in plain:
        assert getattr(got, f) == getattr(want, f), f
    assert dataclasses.astuple(got.config) == dataclasses.astuple(want.config)
    assert _attr_key(got.attribution) == _attr_key(want.attribution)
    assert len(got.segments) == len(want.segments)
    for g, w in zip(got.segments, want.segments):
        for f in dataclasses.fields(w):
            if f.name != "events":
                assert getattr(g, f.name) == getattr(w, f.name), (w.sid, f.name)
        assert (g.events is None) == (w.events is None), w.sid
        if w.events is not None:
            assert_same_events(g.events, w.events)
    assert got.attribution.table() == want.attribution.table()


def closed_pair(backend, workload, tcfg=STAGES, **chip_kw):
    kw = dict(n_cores=4, design="RASA-WLBP", bw_bytes_per_cycle=32.0, **chip_kw)
    rc, pc = chips(backend, **kw)
    if workload == "skewed":
        rw = [R_TABLE[k] for k in CLOSED_WORKLOAD]
        tw = [T_TABLE[k] for k in CLOSED_WORKLOAD]
    else:
        rw = [REF.GemmSpec(f"g{i}", *s) for i, s in enumerate(SMALL)]
        tw = [PORT.GemmSpec(f"g{i}", *s) for i, s in enumerate(SMALL)]
    want = REF.simulate_chip(rw, rc, scheduler="lpt", telemetry=RT(**tcfg))
    got = PORT.simulate_chip(tw, pc, scheduler="lpt", telemetry=TT(**tcfg))
    return want, got


@pytest.mark.parametrize("backend,workload", [("reference", "skewed"), ("numpy", "skewed"),
                                              ("reference", "small"), ("numpy", "small"),
                                              ("torch", "small")])
def test_closed_telemetry(backend, workload):
    """Closed-batch telemetry with stage events on each CPU backend against
    the reference's (its reference oracle for "reference", else its numpy
    lane); the buckets conserve and the report's attribution is the
    telemetry's."""
    want, got = closed_pair(backend, workload)
    assert fields_key(got) == fields_key(want)
    assert_same_telemetry(got.telemetry, want.telemetry)
    assert got.telemetry.kind == "closed"
    assert all(s.events is not None for s in got.telemetry.segments if s.n_mm)
    _assert_conserved(got.telemetry.attribution, got.cycles, 4)
    assert _attr_key(got.attribution) == _attr_key(want.attribution)


def test_closed_telemetry_static_arbitration():
    """Static equal shares: every lane a bucket with no schedule."""
    want, got = closed_pair("numpy", "small", arbitration="static")
    assert_same_telemetry(got.telemetry, want.telemetry)


def _skewed(pkg, **kw):
    return pkg.skewed_trace(**{**dict(d_model=256, heavy_prompt=256, n_light=6), **kw})


def online_pair(backend, requests_kw, policy="fixed", tcfg=STAGES, chip_kw=None, **kw):
    rc, pc = chips(backend, **(chip_kw or dict(n_cores=4, design="RASA-WLBP",
                                               bw_bytes_per_cycle=64.0)))
    reqs = _skewed(REF, **requests_kw)
    want = REF.run_batcher(reqs, rc, policy=policy, telemetry=RT(**tcfg), **kw)
    got = PORT.run_batcher(to_port_requests(reqs), pc, policy=policy, telemetry=TT(**tcfg),
                           **kw)
    return want, got


#: the online cases' traces: tests/test_obs.py's, and a smaller one for the plain lanes
ONLINE = {"obs": {}, "small": dict(d_model=128, heavy_prompt=128, light_prompt=16, n_heavy=2,
                                   n_light=4)}


@pytest.mark.parametrize("backend,trace", [("reference", "obs"), ("numpy", "obs"),
                                           ("torch", "small")])
def test_online_telemetry(backend, trace):
    """Serving telemetry with stage events against the reference's: request
    names, arrival/admission marks, queue-wait, every segment and bucket."""
    want, got = online_pair(backend, ONLINE[trace])
    assert fields_key(got) == fields_key(want)
    tele = got.telemetry
    assert tele.kind == "online" and len(tele.segments) == len(got.names)
    assert_same_telemetry(tele, want.telemetry)
    _assert_conserved(got.attribution, tele.window, 4)
    assert got.attribution.total("queue_wait") > 0.0
    assert _attr_key(got.attribution) == _attr_key(want.attribution)


def test_online_telemetry_occupancy_and_deadlines():
    """Occupancy admission with deadlines: retry marks, abandoned requests."""
    rc, pc = chips("numpy", n_cores=2, design="RASA-WLBP", bw_bytes_per_cycle=32.0)
    reqs = REF.synthetic_trace(10, seed=4, mean_gap=1, d_model=128, prompt_lens=(16, 32),
                               decode_steps=(1, 2), decode_batch=4)
    reqs = [dataclasses.replace(r, deadline=9000.0 if i % 3 else None)
            for i, r in enumerate(reqs)]
    want = REF.run_batcher(reqs, rc, policy="occupancy", telemetry=RT(**STAGES))
    got = PORT.run_batcher(to_port_requests(reqs), pc, policy="occupancy",
                           telemetry=TT(**STAGES))
    assert fields_key(got) == fields_key(want)
    assert_same_telemetry(got.telemetry, want.telemetry)


def test_online_chip_report_telemetry():
    """The closed-batch entry through the online machinery (a fault plan
    that needs it) with stage events."""
    plan_r = REF.FaultPlan((REF.slow_core(1, 0.5, 0, 8),))
    plan_t = PORT.FaultPlan((PORT.slow_core(1, 0.5, 0, 8),))
    kw = dict(n_cores=2, design="RASA-WLBP", bw_bytes_per_cycle=32.0)
    rc, pc = chips("numpy", **kw)
    rw = [REF.GemmSpec(f"g{i}", *s) for i, s in enumerate(SMALL)]
    tw = [PORT.GemmSpec(f"g{i}", *s) for i, s in enumerate(SMALL)]
    want = REF.simulate_chip(rw, dataclasses.replace(rc, fault_plan=plan_r), scheduler="lpt",
                             telemetry=RT(**STAGES))
    got = PORT.simulate_chip(tw, dataclasses.replace(pc, fault_plan=plan_t), scheduler="lpt",
                             telemetry=TT(**STAGES))
    assert fields_key(got) == fields_key(want)
    assert_same_telemetry(got.telemetry, want.telemetry)


# --------------------------------------------------------- fault_lost
CLOSED_FAULT_KW = dict(n_cores=2, design="RASA-WLBP", bw_bytes_per_cycle=32.0)
SERVE_FAULT_KW = dict(n_cores=4, design="RASA-WLBP", bw_bytes_per_cycle=64.0)


def _serve_plan(pkg):
    return pkg.FaultPlan((pkg.core_down(0, 3), pkg.core_up(0, 30), pkg.bw_derate(0.7, 5, 20)))


@pytest.mark.parametrize("backend", ["reference", "numpy"])
def test_closed_fault_lost(backend):
    """tests/test_faults.py's closed fault run: the fault_lost bucket and the
    rest of the telemetry equal the reference's."""
    rc, pc = chips(backend, **CLOSED_FAULT_KW)
    rc = dataclasses.replace(rc, fault_plan=REF.FaultPlan((REF.core_down(0, 2),
                                                           REF.core_up(0, 12))))
    pc = dataclasses.replace(pc, fault_plan=PORT.FaultPlan((PORT.core_down(0, 2),
                                                            PORT.core_up(0, 12))))
    want = REF.simulate_chip([R_TABLE[k] for k in CLOSED_WORKLOAD], rc, scheduler="lpt",
                             telemetry=RT(enabled=True))
    got = PORT.simulate_chip([T_TABLE[k] for k in CLOSED_WORKLOAD], pc, scheduler="lpt",
                             telemetry=TT(enabled=True))
    assert fields_key(got) == fields_key(want)
    att = got.telemetry.attribution
    _assert_conserved(att, got.cycles, 2)
    assert att.total("fault_lost") == pytest.approx(got.fault_lost_cycles, rel=REL)
    assert att.total("fault_lost") > 0.0
    assert_same_telemetry(got.telemetry, want.telemetry)
    assert _attr_key(got.attribution) == _attr_key(want.attribution)


@pytest.mark.parametrize("backend", ["reference", "numpy"])
def test_online_fault_lost(backend):
    """tests/test_faults.py's serving fault run: fault_lost, the fault
    marks and every bucket equal the reference's."""
    rc, pc = chips(backend, **SERVE_FAULT_KW)
    rc = dataclasses.replace(rc, fault_plan=_serve_plan(REF))
    pc = dataclasses.replace(pc, fault_plan=_serve_plan(PORT))
    reqs = _skewed(REF)
    want = REF.run_batcher(reqs, rc, policy="occupancy", snap_stride=512,
                           telemetry=RT(enabled=True))
    got = PORT.run_batcher(to_port_requests(reqs), pc, policy="occupancy", snap_stride=512,
                           telemetry=TT(enabled=True))
    assert fields_key(got) == fields_key(want)
    _assert_conserved(got.attribution, got.telemetry.window, 4)
    assert got.attribution.total("fault_lost") > 0.0
    labels = [m[1] for m in got.telemetry.marks]
    assert "core0 down" in labels and "core0 up" in labels
    assert_same_telemetry(got.telemetry, want.telemetry)


# ------------------------------------------------------ simreport
@pytest.mark.parametrize("layer,design", [("DLRM-2", "RASA-DMDB-WLS"), ("BERT-1", "BASE")])
def test_simreport_attribution(layer, design):
    from repro.core import simulate as r_simulate
    from repro.obs.attribution import simreport_attribution as r_simreport
    from repro_torch.core import simulate as t_simulate
    res = r_simulate(R_TABLE[layer], design)
    got = t_simulate(T_TABLE[layer], design, backend="numpy")
    assert got.cycles == res.cycles
    att = simreport_attribution([T_TABLE[layer]], PORT.ALG1, got.cycles, 12.5)
    want = r_simreport([R_TABLE[layer]], REF.ALG1, res.cycles, 12.5)
    assert _attr_key(att) == _attr_key(want)
    assert att.table() == want.table()
    _assert_conserved(simreport_attribution([T_TABLE[layer]], PORT.ALG1, got.cycles),
                      got.cycles, 1)


# ---------------------------------------------------------- exporters
def _golden(backend="numpy"):
    """tests/test_obs.py's golden run on the port."""
    reqs = PORT.skewed_trace(d_model=128, heavy_prompt=256, light_prompt=32, n_heavy=2,
                             n_light=4)
    chip = chips(backend, n_cores=4, design="RASA-WLBP", bw_bytes_per_cycle=32.0)[1]
    return PORT.run_batcher(reqs, chip, policy="occupancy",
                            telemetry=TT(enabled=True)).telemetry


def _assert_trace_close(fixture, fresh, path="trace"):
    assert type(fixture) is type(fresh) or (
        isinstance(fixture, (int, float)) and isinstance(fresh, (int, float))), path
    if isinstance(fixture, dict):
        assert fixture.keys() == fresh.keys(), path
        for k in fixture:
            _assert_trace_close(fixture[k], fresh[k], f"{path}/{k}")
    elif isinstance(fixture, list):
        assert len(fixture) == len(fresh), path
        for i, (a, b) in enumerate(zip(fixture, fresh)):
            _assert_trace_close(a, b, f"{path}[{i}]")
    elif isinstance(fixture, bool) or not isinstance(fixture, (int, float)):
        assert fixture == fresh, path
    else:
        assert fresh == pytest.approx(fixture, rel=REL, abs=1e-6), path


def test_perfetto_golden_fixture():
    """The port's export of tests/test_obs.py's golden run matches the
    fixture at its tolerance (the file is read, never rewritten)."""
    fixture = json.loads((FIXTURES / "perfetto_skewed4.json").read_text())
    _assert_trace_close(fixture, to_trace_events(_golden()))


def test_perfetto_equals_reference_export():
    """With stage events and counters, the port's trace_event document is
    the reference's, key for key and value for value."""
    from repro.obs import to_trace_events as r_to_trace
    want, got = online_pair("numpy", ONLINE["small"], policy="occupancy",
                            tcfg=dict(enabled=True, stages=True, max_stage_events=300))
    doc = to_trace_events(got.telemetry)
    assert json.dumps(doc, sort_keys=True) == json.dumps(r_to_trace(want.telemetry),
                                                         sort_keys=True)
    assert doc["otherData"]["stage_events_dropped"] > 0


def test_trace_events_well_formed_and_written(tmp_path):
    doc = to_trace_events(_golden())
    events = doc["traceEvents"]
    assert events and all(isinstance(e, dict) and "ph" in e for e in events)
    assert {"M", "X", "b", "e", "C", "i"} <= {e["ph"] for e in events}
    other = doc["otherData"]
    assert other["schema"] == "rasa-trace/1"
    assert sum(other["attribution"].values()) == pytest.approx(
        other["window_cycles"] * other["n_cores"], rel=1e-9, abs=1e-6)
    path = write_trace(_golden(), tmp_path / "sub" / "trace.json")
    assert json.loads(path.read_text()) == json.loads(json.dumps(doc))


@pytest.mark.parametrize("backend", ["numpy", "torch"])
def test_stage_event_cap(backend):
    """tests/test_obs.py's cap case: at most 16 stage events exported, the
    overflow counted in the metadata; the same document as the reference's."""
    from repro.obs import to_trace_events as r_to_trace
    tcfg = dict(enabled=True, stages=True, max_stage_events=16)
    kw = dict(n_cores=2, design="RASA-WLBP", bw_bytes_per_cycle=32.0)
    rc, pc = chips(backend, **kw)
    want = REF.simulate_chip(REF.GemmSpec("cap", 64, 256, 256), rc, telemetry=RT(**tcfg))
    got = PORT.simulate_chip(PORT.GemmSpec("cap", 64, 256, 256), pc, telemetry=TT(**tcfg))
    doc = to_trace_events(got.telemetry)
    staged = [e for e in doc["traceEvents"] if e.get("cat") in ("stage", "mem", "stall")]
    assert len(staged) <= 16
    assert doc["otherData"]["stage_events_dropped"] > 0
    assert json.dumps(doc, sort_keys=True) == json.dumps(r_to_trace(want.telemetry),
                                                         sort_keys=True)


def test_render_timeline():
    from repro.obs import render_timeline as r_render
    out = render_timeline(_golden(), width=60)
    lines = out.splitlines()
    bars = [ln for ln in lines if ln.startswith("core ")]
    assert len(bars) == 4 and all(len(ln) == len(bars[0]) for ln in bars)
    assert "#" in out and "compute" in out and "fill/drain" in out
    want = REF.run_batcher(
        REF.skewed_trace(d_model=128, heavy_prompt=256, light_prompt=32, n_heavy=2,
                         n_light=4),
        REF.ChipConfig(n_cores=4, design="RASA-WLBP", bw_bytes_per_cycle=32.0,
                       backend="numpy"),
        policy="occupancy", telemetry=RT(enabled=True)).telemetry
    assert out == r_render(want, width=60)


def test_telemetry_off_by_default():
    """Without opt-in, reports carry no telemetry (and the serving report's
    attribution is None)."""
    rep = PORT.simulate_chip([T_TABLE[k] for k in CLOSED_WORKLOAD],
                             PORT.ChipConfig(n_cores=2, design="RASA-WLBP", backend="numpy"),
                             scheduler="lpt")
    assert rep.telemetry is None
    brep = PORT.run_batcher(PORT.skewed_trace(d_model=128, heavy_prompt=128, n_light=2),
                            PORT.ChipConfig(n_cores=2, design="RASA-WLBP", backend="numpy"),
                            policy="occupancy")
    assert brep.telemetry is None and brep.attribution is None


# ------------------------------------------------------------ repairs
@pytest.mark.parametrize("backend", ["numpy", "reference"])
def test_chip_report_attribution_without_telemetry(backend):
    """ChipReport.attribution is computed from the report's own fields, as
    the reference computes it: closed runs (per-core fields) and the online
    machinery's (attribution_rows)."""
    kw = dict(n_cores=2, design="RASA-WLBP", bw_bytes_per_cycle=32.0)
    rc, pc = chips(backend, **kw)
    want = REF.simulate_chip([R_TABLE[k] for k in CLOSED_WORKLOAD], rc, scheduler="lpt")
    got = PORT.simulate_chip([T_TABLE[k] for k in CLOSED_WORKLOAD], pc, scheduler="lpt")
    assert got.telemetry is None and got.attribution is not None
    assert _attr_key(got.attribution) == _attr_key(want.attribution)
    _assert_conserved(got.attribution, got.cycles, 2)
    rc = dataclasses.replace(rc, fault_plan=REF.FaultPlan((REF.core_down(0, 2),
                                                           REF.core_up(0, 12))))
    pc = dataclasses.replace(pc, fault_plan=PORT.FaultPlan((PORT.core_down(0, 2),
                                                            PORT.core_up(0, 12))))
    want = REF.simulate_chip([R_TABLE[k] for k in CLOSED_WORKLOAD], rc, scheduler="lpt")
    got = PORT.simulate_chip([T_TABLE[k] for k in CLOSED_WORKLOAD], pc, scheduler="lpt")
    assert got.attribution_rows and got.telemetry is None
    assert _attr_key(got.attribution) == _attr_key(want.attribution)


def test_chip_report_attribution_of_old_reports():
    """A report without per-core compute fields has no attribution."""
    rc, pc = chips("numpy", n_cores=2, design="RASA-WLBP")
    want = REF.simulate_chip(REF.GemmSpec("o", 32, 64, 64), rc)
    got = PORT.simulate_chip(PORT.GemmSpec("o", 32, 64, 64), pc)
    for rep in (want, got):
        assert dataclasses.replace(rep, per_core_compute_cycles=(),
                                   attribution_rows=()).attribution is None


def test_batch_report_attribution():
    """BatchReport.attribution is the telemetry's (None without it), on
    closed-off and online-on runs alike."""
    want, got = online_pair("numpy", ONLINE["small"], policy="occupancy",
                            tcfg=dict(enabled=True))
    assert got.attribution is got.telemetry.attribution
    assert _attr_key(got.attribution) == _attr_key(want.attribution)
    off = PORT.run_batcher(to_port_requests(_skewed(REF, **ONLINE["small"])),
                           chips("numpy", n_cores=4, design="RASA-WLBP",
                                 bw_bytes_per_cycle=64.0)[1], policy="occupancy")
    assert off.attribution is None and fields_key(off) == fields_key(got)
