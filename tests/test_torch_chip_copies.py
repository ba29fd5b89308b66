"""The port's own copies of the chip model's pure layers against the JAX
package's: the telemetry knob, the partitioners, the workload compiler, the
span arbiter, the fault plans and the preemption cut, on the same inputs,
by exact equality."""

import dataclasses
import math
import random

import pytest

import _sim_streams
from _torch_chip import PORT, REF
from repro.configs import ARCH_NAMES as R_ARCHS
from repro.core import isa as r_isa
from repro.multicore import arbiter as r_arb
from repro.multicore import partition as r_part
from repro.obs import config as r_obs
from repro.workload import compile as r_comp
from repro_torch.configs import ARCH_NAMES as T_ARCHS
from repro_torch.core import isa as t_isa
from repro_torch.multicore import arbiter as t_arb
from repro_torch.multicore import partition as t_part
from repro_torch.obs import config as t_obs
from repro_torch.workload import compile as t_comp

SPECS = [(96, 256, 384), (1, 2048, 4096), (33, 100, 70), (512, 512, 128)]


def test_telemetry_config_copy():
    for kw in ({}, dict(enabled=True, stages=True, counters=False, max_stage_events=7)):
        assert dataclasses.astuple(t_obs.TelemetryConfig(**kw)) == \
            dataclasses.astuple(r_obs.TelemetryConfig(**kw))
    assert dataclasses.astuple(t_obs.OFF) == dataclasses.astuple(r_obs.OFF)
    for cfg in (t_obs, r_obs):
        with pytest.raises(ValueError):
            cfg.TelemetryConfig(max_stage_events=-1)
    # an enabled knob attaches the telemetry it asked for
    tcfg = t_obs.TelemetryConfig(enabled=True, stages=True)
    rep = PORT.simulate_chip(PORT.GemmSpec("t", 32, 64, 64),
                             PORT.ChipConfig(backend="numpy", n_cores=2), telemetry=tcfg)
    assert rep.telemetry.config is tcfg and rep.telemetry.kind == "closed"


@pytest.mark.parametrize("strategy", r_part.PARTITIONERS)
def test_partition_copy(strategy):
    assert t_part.PARTITIONERS == r_part.PARTITIONERS
    for m, k, n in SPECS:
        for cores in (1, 2, 3, 4, 8):
            want = r_part.partition_gemm(REF.GemmSpec("g", m, k, n), cores, strategy)
            got = t_part.partition_gemm(PORT.GemmSpec("g", m, k, n), cores, strategy)
            assert [[dataclasses.astuple(s) for s in sh] for sh in got] == \
                [[dataclasses.astuple(s) for s in sh] for sh in want]
            for ways in (1, 2, 3):
                if strategy == "k_split":       # both refuse a gang K-split
                    for mod, pkg in ((r_part, REF), (t_part, PORT)):
                        with pytest.raises(ValueError, match="k_split"):
                            mod.split_ways(pkg.GemmSpec("g", m, k, n), ways, strategy)
                    continue
                w = r_part.split_ways(REF.GemmSpec("g", m, k, n), ways, strategy)
                g = t_part.split_ways(PORT.GemmSpec("g", m, k, n), ways, strategy)
                key = (lambda xs: None if xs is None
                       else [dataclasses.astuple(s) for s in xs])
                assert key(g) == key(w)


def _workload_key(w) -> tuple:
    return (w.name, w.arch, w.phase, w.batch, w.seq, w.layers_modeled, w.n_layers,
            tuple((dataclasses.astuple(op.spec), op.layer, op.block, op.group)
                  for op in w.ops))


@pytest.mark.parametrize("arch", T_ARCHS)
def test_workload_compile_copy(arch):
    """Every config's compiled workload at batch 1/4, seq 32/128, both
    phases (and with the score GEMMs, the head and a dim cap) equals the
    reference's, spec for spec."""
    assert arch in R_ARCHS and t_comp.PHASES == r_comp.PHASES
    opts = [dict(), dict(attention_scores=True, include_head=True, dim_cap=512,
                         max_layers=2, max_experts=4)]
    for batch in (1, 4):
        for seq in (32, 128):
            for phase in t_comp.PHASES:
                for o in opts:
                    want = r_comp.compile_workload(arch, batch=batch, seq=seq, phase=phase,
                                                   options=r_comp.CompileOptions(**o))
                    got = t_comp.compile_workload(arch, batch=batch, seq=seq, phase=phase,
                                                  options=t_comp.CompileOptions(**o))
                    assert _workload_key(got) == _workload_key(want)
                    assert got.macs == want.macs


def _spans(pkg, spans):
    return [pkg.Span(start=s, end=e, demands=d, weight=w) for s, e, d, w in spans]


@pytest.mark.parametrize("policy", ["equal", "demand"])
@pytest.mark.parametrize("seed", range(6))
def test_arbiter_schedule_copy(policy, seed):
    """The span arbiter's schedule (shares, active counts, weight sums) over
    random spans equals the reference's, derated epochs included, and the
    weighted shares conserve the budget epoch by epoch."""
    rng = random.Random(seed)
    spans = []
    for _ in range(rng.randrange(1, 10)):
        s = rng.randrange(0, 12)
        spans.append((s, rng.choice([None, s + rng.randrange(0, 12)]), rng.random() < 0.9,
                      rng.uniform(1e-3, 100.0) if policy == "demand" else 1.0))
    budget = rng.choice([16.0, 32.0, 100.0])
    factors = tuple(rng.choice([1.0, 0.5, 0.25]) for _ in range(rng.randrange(0, 8)))
    out = []
    for arb_mod in (r_arb, t_arb):
        arb = arb_mod.SpanArbiter(budget, 256.0, policy, budget_factors=factors)
        sp = _spans(arb_mod, spans)
        arb._rebuild(sp, 0)
        out.append((arb.share_trace, arb.active_trace, list(arb._wsum), arb.settled_horizon))
    assert out[0] == out[1]
    if not factors:
        shares = out[1][0]
        for e in range(len(shares)):
            active = [x for x in spans if x[2] and x[0] <= e and (x[1] is None or e < x[1])]
            total = sum(shares[e] * x[3] for x in active)
            assert total <= budget * (1 + 1e-9)


def test_arbiter_policies_and_schedule_copy():
    assert t_arb.SHARE_POLICIES == r_arb.SHARE_POLICIES
    assert t_arb.MAX_ARBITER_ROUNDS == r_arb.MAX_ARBITER_ROUNDS
    for name in ("equal", "demand"):
        for d in (0.0, 1e-6, 3.5, 250.0):
            assert t_arb.get_share_policy(name).weight(d) == \
                r_arb.get_share_policy(name).weight(d)
    with pytest.raises(ValueError):
        t_arb.get_share_policy("fair")
    spans = [(0, 4), (0, None), (2, 9), (3, 3), (5, 7)]
    assert t_arb.build_share_schedule(spans, 24.0) == r_arb.build_share_schedule(spans, 24.0)


def test_arbiter_relax_copy():
    """A closed relaxation with a stand-in simulator: the same rounds, the
    same ends and the same skip counts."""
    def run(arb_mod):
        spans = [arb_mod.Span(start=s, end=None, demands=True, weight=w)
                 for s, w in ((0, 1.0), (0, 2.0), (1, 0.5), (3, 1.0))]
        work = [9000.0, 4000.0, 7000.0, 2000.0]

        def simulate(jobs):
            for i, prefix, tail in jobs:
                e, t = 0, 0.0
                rate = lambda k: prefix[k] if k < len(prefix) else tail
                left = work[i]
                while left > 0:
                    r = rate(e)
                    step = min(256.0, left / max(r, 1e-9) * 8.0)
                    left -= step * r / 8.0
                    t += step
                    e = int(t // 256.0)
                spans[i].last_grant = t
                spans[i].throttled = True
        arb = arb_mod.SpanArbiter(32.0, 256.0, "demand")
        tr = arb.relax(spans, simulate)
        return tr.rounds, tr.skipped, tr.shares, tr.n_active, [s.end for s in spans]
    assert run(t_arb) == run(r_arb)


def _plan_key(plan):
    return (tuple(dataclasses.astuple(e) for e in plan.events), plan.preemption)


@pytest.mark.parametrize("seed", range(4))
def test_fault_plans_copy(seed):
    kw = dict(horizon=64, n_core_faults=2, down_epochs=8, n_derates=1, derate_factor=0.5,
              derate_epochs=8)
    for pre in ("resume", "restart"):
        want = REF.random_plan(4, seed=seed, preemption=pre, **kw)
        got = PORT.random_plan(4, seed=seed, preemption=pre, **kw)
        assert _plan_key(got) == _plan_key(want)
        assert got.budget_factors() == want.budget_factors()
        assert got.needs_online == want.needs_online
        assert got.has_core_events == want.has_core_events
        assert [got.speed_factor(c, e) for c in range(4) for e in (0, 9, 40)] == \
            [want.speed_factor(c, e) for c in range(4) for e in (0, 9, 40)]
    hand = [("core_down", (1, 4)), ("core_up", (1, 9)), ("bw_derate", (0.5, 2, 6)),
            ("slow_core", (0, 0.5))]
    plans = [pkg.FaultPlan(tuple(getattr(pkg, name)(*a) for name, a in hand))
             for pkg in (REF, PORT)]
    assert _plan_key(plans[1]) == _plan_key(plans[0])
    for pkg in (REF, PORT):
        with pytest.raises(ValueError):
            pkg.core_down(-1, 3)


@pytest.mark.parametrize("model", ["port", "epoch", "static"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_completed_prefix_copy(model, seed):
    """The preemption cut of random streams at many limits, from the start
    and resumed from run_segment's snapshots, equals the reference's."""
    params = {"port": dict(load_ports=2),
              "epoch": dict(load_ports=2, store_ports=1, shares=(8.0, 16.0, 48.0),
                            epoch_cycles=256.0, tail_share=64.0, burst_bytes=2048.0,
                            charge_store_bytes=True),
              "static": dict(load_ports=1, store_ports=1, tail_share=12.0,
                             burst_bytes=1024.0, charge_store_bytes=True)}[model]
    rng = random.Random(seed)
    stream = _sim_streams.random_stream(rng, 400, r_isa)
    t_stream = _sim_streams.random_stream(random.Random(seed), 400, t_isa)
    r_tr, t_tr = REF.compile_stream(stream), PORT.compile_stream(t_stream)
    from repro.core.designs import DESIGNS as R_D
    from repro_torch.core.designs import DESIGNS as T_D
    for name in ("BASE", "RASA-WLBP", "RASA-DMDB-WLS"):
        rp = REF.fastsim.StreamModelParams(**params)
        tp = PORT.fastsim.StreamModelParams(**params)
        res, _, r_snaps = REF.fastsim.run_segment(r_tr, R_D[name], rp, snap_stride=64)
        _, _, t_snaps = PORT.fastsim.run_segment(t_tr, T_D[name], tp, snap_stride=64)
        for limit in (0.0, 10.0, res.cycles / 3, res.cycles / 2, res.cycles - 1.0,
                      res.cycles, math.inf):
            want = REF.fastsim.completed_prefix(r_tr, R_D[name], rp, limit)
            assert PORT.fastsim.completed_prefix(t_tr, T_D[name], tp, limit) == want
            for rc, tc in zip(r_snaps, t_snaps):
                if rc.t_end <= limit:
                    assert PORT.fastsim.completed_prefix(t_tr, T_D[name], tp, limit,
                                                         carry=tc) == want
    assert PORT.fastsim.SNAP_STRIDE == REF.fastsim.SNAP_STRIDE
    assert PORT.fastsim._pow2(100, lo=8) == REF.fastsim._pow2(100, lo=8)
