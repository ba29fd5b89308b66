"""The whole-trace program on a ``torch`` chip (third part of the reference's
domain table): real-model traces, the one-launch arrival-rate sweep, every
gate reason with the incremental client's fallback agreeing, and the
window's independence (doubling it moves no bit)."""

import dataclasses
import random

import pytest

from _hypothesis_compat import given, settings, st
from _torch_chip import PORT, REF, fields_key, to_port_requests
from _torch_program import (ALL_DESIGNS, REACTIVE, assert_program, chip_pair, in_domain,
                            traffic, trace)
from repro.workload import CompileOptions
from repro_torch.multicore import jitarb


@pytest.mark.parametrize("policy", ("fixed",) + REACTIVE)
def test_model_trace_bit_identical(policy):
    """A real-model request stream (compiled per-layer prefill and decode
    GEMM chains; one layer, dims capped at 128 to keep the plain version's
    CPU time small) stays in the domain and agrees exactly."""
    requests = REF.model_trace("gemma-2b", 3, seed=2, mean_gap=1, prompt_lens=(32,),
                               decode_steps=(1,),
                               options=CompileOptions(dim_cap=128, max_layers=1))
    ref, port = chip_pair(n_cores=2, bw_bytes_per_cycle=48.0)
    in_domain(requests, port, policy=policy)
    assert_program(requests, ref, port, policy=policy)


def test_sweep_matches_sequential():
    """plan_many's arrival-rate sweep, settled in one call (one CTA a
    variant on the card), equals per-variant numpy-client runs."""
    base = trace(8, seed=5, mean_gap=3)
    ref, port = chip_pair(n_cores=2)
    variants = [[dataclasses.replace(r, arrival_epoch=int(r.arrival_epoch * f)) for r in base]
                for f in (1.0, 0.5, 0.0)]
    port_variants = [to_port_requests(v) for v in variants]
    plans = jitarb.plan_many([traffic(v) for v in port_variants], port)
    assert plans is not None
    outs = jitarb.finish_times_many(plans)
    for v, pv, fin in zip(variants, port_variants, outs):
        want = REF.run_batcher(v, ref, policy="fixed", batch_size=1)
        got = PORT.report_from_finishes(pv, port, fin)
        assert fields_key(got) == fields_key(want)


def test_torch_chip_never_reaches_the_kernel(monkeypatch):
    """A ``torch`` chip runs the plain program whatever its device (the
    card's included) and a ``cuda`` chip the kernel's wrapper: the pick is
    by backend, not by the tensors' device."""
    from repro_torch.kernels import jitarb as kj
    ref, port = chip_pair()
    for device in ("cpu", "cuda"):
        assert jitarb._program(dataclasses.replace(port, device=device)) is kj.jitarb_plain
    assert jitarb._program(dataclasses.replace(port, backend="cuda")) is kj.jitarb

    def refuse(*args, **kw):
        raise AssertionError("a torch chip launched the kernel")

    monkeypatch.setattr(kj, "jitarb_cuda", refuse)
    monkeypatch.setattr(kj, "jitarb", refuse)
    assert_program(trace(4, seed=13), ref, port, policy="occupancy")


def test_gate_reasons_and_fallback():
    """Every gate reason these chips can reach is structured (the cores of
    one ChipConfig share their store accounting, and every GEMM loads
    tiles, so ``hetero_store_model`` and ``zero_traffic_segment`` cannot
    arise here); out-of-domain runs go to the incremental client (on the
    same backend) and agree with the reference, with the reason on the
    report."""
    requests = trace(5, seed=11)
    ref, port = chip_pair()
    pt = traffic(to_port_requests(requests))
    assert "no_jax" not in jitarb.GATE_REASONS
    assert jitarb.plan_ex(pt, dataclasses.replace(port, backend="numpy"))[1] == "backend"
    assert jitarb.plan_ex(pt, dataclasses.replace(port, epoch_cycles=1000.0))[1] == \
        "epoch_not_pow2"
    assert jitarb.plan_ex([], port)[1] == "no_requests"
    assert jitarb.plan_ex(pt, port, batch_size=0)[1] == "batch_size"
    assert jitarb.plan_ex(pt, port, policy="predicted", lookahead=-1)[1] == "lookahead"
    assert jitarb.plan_ex(pt, port, policy="occupancy", min_share=-1.0)[1] == \
        "min_share_out_of_range"
    assert jitarb.plan_ex(pt, port, policy="phase_aware")[1] == "admission_policy"
    assert jitarb.plan_ex(pt, dataclasses.replace(port, arbitration="static"))[1] == \
        "arbitration"
    assert jitarb.plan_ex(pt, dataclasses.replace(port, bw_bytes_per_cycle=float("inf"))
                          )[1] == "infinite_budget"
    many = traffic(to_port_requests(trace(70, seed=11)))
    assert jitarb.plan_ex(many, port, policy="occupancy", min_share=1e-3)[1] == \
        "admission_unroll"
    assert jitarb.plan(pt, dataclasses.replace(port, backend="numpy")) is None
    # phase_aware keeps its host-only implementation: the fallback agrees
    want = REF.run_batcher(requests, ref, policy="phase_aware", batch_size=1)
    got = PORT.run_batcher(to_port_requests(requests), port, policy="phase_aware",
                           batch_size=1)
    assert fields_key(got) == fields_key(want) and got.jit_gate == "admission_policy"


def test_gate_active_fault_plan_falls_back():
    def chips(pkg_plan):
        kw = dict(n_cores=2, design="RASA-WLBP", bw_bytes_per_cycle=32.0)
        return (REF.ChipConfig(backend="numpy", fault_plan=pkg_plan(REF), **kw),
                PORT.ChipConfig(backend="torch", device="cpu", fault_plan=pkg_plan(PORT),
                                **kw))
    requests = trace(4, seed=9)
    ref, port = chips(lambda pkg: pkg.FaultPlan((pkg.core_down(0, 2), pkg.core_up(0, 12))))
    assert jitarb.plan_ex(traffic(to_port_requests(requests)), port)[1] == "faults_active"
    want = REF.run_batcher(requests, ref)
    got = PORT.run_batcher(to_port_requests(requests), port)
    assert fields_key(got) == fields_key(want) and got.jit_gate == "faults_active"
    # the empty plan is a no-op and stays in the domain
    ref0, port0 = chips(lambda pkg: pkg.FaultPlan())
    assert_program(requests, ref0, port0)


@pytest.mark.parametrize("policy", ("fixed", "occupancy"))
def test_window_doubling_moves_no_bit(policy):
    _, port = chip_pair(n_cores=2)
    p = in_domain(trace(6, seed=21, mean_gap=1), port, policy=policy)
    fin0, adm0 = jitarb.finish_admit_times(p)
    fin1, adm1 = jitarb.finish_admit_times(dataclasses.replace(p, S=p.S * 2))
    assert (fin0 == fin1).all() and (adm0 == adm1).all()


@given(st.integers(0, 2 ** 16))
@settings(max_examples=3, deadline=None)
def test_random_traces_bit_identical(seed):
    """Random small traces across the domain: the program is bit-identical
    to the numpy client wherever plan_ex accepts."""
    rng = random.Random(seed)
    ref, port = chip_pair(n_cores=rng.choice((1, 2, 3)), design=rng.choice(ALL_DESIGNS),
                          bw_bytes_per_cycle=rng.choice((16.0, 32.0, 64.0)),
                          share_policy=rng.choice(("equal", "demand")))
    policy = rng.choice(("fixed",) + REACTIVE)
    batch_size = rng.choice((1, 2, 4)) if policy == "fixed" else 1
    requests = trace(rng.randrange(1, 6), seed=seed % 1024, mean_gap=rng.choice((0, 1, 3)))
    in_domain(requests, port, policy=policy, batch_size=batch_size)
    assert_program(requests, ref, port, policy=policy, batch_size=batch_size)
