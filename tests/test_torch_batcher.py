"""The port's online client and serving batcher on the numpy backend against
the JAX package's, every field of ``BatchReport``: the six admission
policies on synthetic and skewed traces, deadlines with retries and
abandonment, the rebuild-from-epoch-0 arbiter (``prefix_cache=False``), a
real-model trace, fault plans, and an ``OnlineChip`` checkpoint restored
mid-run."""

import pickle

import pytest

from _torch_chip import PORT, REF, assert_same_batch, chips, fields_key, to_port_requests
from repro.serving.simbatch import POLICIES

TRACE_KW = dict(d_model=128, prompt_lens=(16, 32, 64), decode_steps=(1, 2), decode_batch=8)


def synthetic(n=12, seed=3, mean_gap=1):
    return REF.synthetic_trace(n, seed=seed, mean_gap=mean_gap, **TRACE_KW)


def skewed():
    return REF.skewed_trace(d_model=128, heavy_prompt=256, n_light=6)


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("trace", ["synthetic", "skewed"])
def test_policies(trace, policy):
    requests = synthetic() if trace == "synthetic" else skewed()
    ref_chip, port_chip = chips(n_cores=4 if trace == "skewed" else 2, design="RASA-WLBP",
                                bw_bytes_per_cycle=32.0)
    for batch_size in (1, 3):
        want, got = assert_same_batch(requests, ref_chip, port_chip, policy=policy,
                                      batch_size=batch_size, snap_stride=128)
        assert got.jit_gate is None


@pytest.mark.parametrize("share", ["equal", "demand"])
def test_mixed_chip_and_shares(share):
    ref_chip, port_chip = chips(n_cores=None, design=None,
                                cores=("BASE", "RASA-WLBP", "RASA-DMDB-WLS"),
                                bw_bytes_per_cycle=24.0, share_policy=share)
    for policy in ("bandwidth", "predicted"):
        assert_same_batch(synthetic(10, seed=5), ref_chip, port_chip, policy=policy)


def test_deadlines_retry_and_abandon():
    """Requests with per-attempt deadlines retry with backoff and are
    abandoned after max_attempts, exactly as the reference counts them."""
    d = 256
    reqs = (REF.ServeRequest("big", 0, REF.GemmSpec("big.pf", 512, d, d)),
            REF.ServeRequest("small", 1, REF.GemmSpec("s.pf", 16, d, d), deadline=2048.0),
            REF.ServeRequest("late", 1, REF.GemmSpec("late.pf", 64, d, d), deadline=1.0),
            REF.ServeRequest("ok", 2, REF.GemmSpec("ok.pf", 8, d, d), deadline=1e9))
    ref_chip, port_chip = chips(n_cores=1, design="RASA-WLBP", bw_bytes_per_cycle=32.0)
    for policy in ("occupancy", "degraded", "phase_aware"):
        want, got = assert_same_batch(reqs, ref_chip, port_chip, policy=policy,
                                      max_attempts=2, backoff_epochs=1)
    assert got.retries >= 1 and got.abandoned >= 1
    many = tuple(REF.ServeRequest(r.name, r.arrival_epoch, r.prefill, r.decode,
                                  deadline=20000.0) for r in synthetic(10, seed=9, mean_gap=0))
    assert_same_batch(many, ref_chip, port_chip, policy="bandwidth", max_attempts=3,
                      backoff_epochs=2)


def test_prefix_cache_off():
    ref_chip, port_chip = chips(n_cores=3, design="RASA-DMDB-WLS", bw_bytes_per_cycle=48.0)
    for policy in ("fixed", "occupancy"):
        want, got = assert_same_batch(synthetic(10, seed=2), ref_chip, port_chip,
                                      policy=policy, prefix_cache=False)
        on = PORT.run_batcher(to_port_requests(synthetic(10, seed=2)), port_chip,
                              policy=policy)
        assert fields_key(on) == fields_key(got)


def test_model_trace():
    """A real-model request stream: the port's model_trace lowers the same
    GEMMs from its own configs, and the batcher settles it identically."""
    kw = dict(seed=2, mean_gap=1, prompt_lens=(32,), decode_steps=(1, 2))
    want_reqs = REF.model_trace("gemma-2b", 4, **kw)
    got_reqs = PORT.model_trace("gemma-2b", 4, **kw)
    assert [tuple((s.name, s.M, s.K, s.N) for s in r.specs) for r in got_reqs] == \
        [tuple((s.name, s.M, s.K, s.N) for s in r.specs) for r in want_reqs]
    ref_chip, port_chip = chips(n_cores=2, design="RASA-WLBP", bw_bytes_per_cycle=48.0)
    for policy in ("fixed", "predicted"):
        assert_same_batch(want_reqs, ref_chip, port_chip, policy=policy, batch_size=1)


@pytest.mark.parametrize("preemption", ["resume", "restart"])
def test_fault_plan_serving(preemption):
    def plan(pkg):
        return pkg.FaultPlan((pkg.core_down(0, 3), pkg.core_up(0, 20),
                              pkg.bw_derate(0.5, 5, 12)), preemption=preemption)
    kw = dict(n_cores=4, design="RASA-WLBP", bw_bytes_per_cycle=64.0)
    ref_chip = REF.ChipConfig(backend="numpy", fault_plan=plan(REF), **kw)
    port_chip = PORT.ChipConfig(backend="numpy", fault_plan=plan(PORT), **kw)
    for policy in ("occupancy", "degraded", "fixed"):
        assert_same_batch(skewed(), ref_chip, port_chip, policy=policy, snap_stride=256)


def test_online_snapshot_restored_mid_run():
    """Checkpoint an OnlineChip inside a core's outage, pickle it, restore
    it and drain: the restored run equals the uninterrupted one and the
    reference's."""
    def plan(pkg):
        return pkg.FaultPlan((pkg.core_down(0, 3), pkg.core_up(0, 30)))
    kw = dict(n_cores=4, design="RASA-WLBP", bw_bytes_per_cycle=64.0)
    ref_req = skewed()
    out = []
    for pkg, requests in ((REF, ref_req), (PORT, to_port_requests(ref_req))):
        chip = pkg.ChipConfig(backend="numpy", fault_plan=plan(pkg), **kw)

        def drive(sim):
            for i, r in enumerate(requests):
                if r.arrival_epoch > sim.epoch:
                    sim.advance_to(r.arrival_epoch)
                sim.submit(i % 4, r.specs)

        straight = pkg.OnlineChip(chip, snap_stride=512)
        drive(straight)
        straight.drain()
        sim = pkg.OnlineChip(chip, snap_stride=512)
        drive(sim)
        sim.advance_to(10)
        assert sim.n_preempted >= 1
        resumed = pkg.OnlineChip.restore(pickle.loads(pickle.dumps(sim.snapshot())))
        resumed.drain()
        row = (resumed.makespan, resumed.share_trace, resumed.active_trace,
               resumed.n_retired, resumed.n_preempted, resumed.fault_log)
        assert row == (straight.makespan, straight.share_trace, straight.active_trace,
                       straight.n_retired, straight.n_preempted, straight.fault_log)
        out.append(row)
    assert out[1] == out[0]


def test_batcher_validation_and_refusals():
    import torch
    from repro_torch.obs import TelemetryConfig
    requests = to_port_requests(synthetic(3))
    chip = PORT.ChipConfig(backend="numpy", n_cores=2)
    with pytest.raises(ValueError, match="unknown policy"):
        PORT.run_batcher(requests, chip, policy="greedy")
    with pytest.raises(NotImplementedError, match="item 16"):
        PORT.run_batcher(requests, chip, telemetry=TelemetryConfig(enabled=True))
    with pytest.raises(NotImplementedError, match="item 16"):
        PORT.OnlineChip(chip, telemetry=TelemetryConfig(enabled=True))
    assert PORT.ChipConfig().backend == "cuda"
    if not torch.cuda.is_available():
        for port_chip in (PORT.ChipConfig(n_cores=2),
                          PORT.ChipConfig(backend="torch", n_cores=2)):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                PORT.run_batcher(requests, port_chip)
            with pytest.raises(RuntimeError, match="no CUDA device"):
                PORT.OnlineChip(port_chip)
