"""The port's chip model (``simulate_chip``) against the JAX package's,
field for field of ``ChipReport``, on the port's CPU backends: ``numpy``,
``torch`` (the scan kernels' plain versions on the CPU) and ``reference``.

Homogeneous and mixed chips, every partitioner and scheduler, epoch and
static arbitration, equal and demand shares, and a fault plan with
``core_down``/``core_up`` under both preemption policies."""

import pytest

from _torch_chip import PORT, REF, chips, fields_key
from repro.multicore import partition as r_part
from repro.multicore import scheduler as r_sched

#: a small GEMM set: shards and lanes of a few hundred instructions
SPECS = [(48, 128, 128), (16, 256, 128), (64, 128, 64), (8, 128, 256)]
MIXED = ("BASE", "RASA-WLBP")


def specs(pkg, count=len(SPECS)):
    return [pkg.GemmSpec(f"g{i}", m, k, n) for i, (m, k, n) in enumerate(SPECS[:count])]


#: the plain lanes step the cores in lockstep through PyTorch calls (about
#: half a millisecond an instruction on the CPU): ``torch`` runs the smaller
#: workloads
def small(backend):
    return backend == "torch"


def same_report(backend, workload, chip_kw, **kw):
    ref_chip, port_chip = chips(backend, **chip_kw)
    want = REF.simulate_chip(workload(REF), ref_chip, **kw)
    got = PORT.simulate_chip(workload(PORT), port_chip, **kw)
    assert fields_key(got) == fields_key(want)
    return got


@pytest.mark.parametrize("backend", ["numpy", "torch", "reference"])
@pytest.mark.parametrize("cores", ["homogeneous", "mixed"])
def test_partitioned_and_scheduled(backend, cores):
    """One GEMM partitioned m_split, a GEMM list scheduled work_queue: both
    arbitrations, equal and demand shares."""
    kw = dict(n_cores=2, design="RASA-WLBP") if cores == "homogeneous" \
        else dict(n_cores=None, design=None, cores=MIXED)
    m = 32 if small(backend) else 96
    for arb, share in (("epoch", "equal"), ("epoch", "demand"), ("static", "equal")):
        chip_kw = dict(bw_bytes_per_cycle=24.0, arbitration=arb, share_policy=share, **kw)
        same_report(backend, lambda pkg: pkg.GemmSpec("one", m, 256, 128), chip_kw,
                    partition="m_split")
        if backend != "reference":
            same_report(backend, lambda pkg: specs(pkg, 2 if small(backend) else 4),
                        chip_kw, scheduler="work_queue")


@pytest.mark.parametrize("partition", r_part.PARTITIONERS)
def test_every_partitioner(partition):
    for share in ("equal", "demand"):
        same_report("numpy", lambda pkg: pkg.GemmSpec("p", 96, 256, 192),
                    dict(n_cores=3, design="RASA-DMDB-WLS", bw_bytes_per_cycle=32.0,
                         share_policy=share), partition=partition)


@pytest.mark.parametrize("scheduler", r_sched.SCHEDULERS)
def test_every_scheduler(scheduler):
    for kw in (dict(n_cores=3, design="RASA-PIPE"), dict(n_cores=None, design=None,
                                                          cores=MIXED)):
        same_report("numpy", specs, dict(bw_bytes_per_cycle=32.0, **kw),
                    scheduler=scheduler, partition="m_split")


@pytest.mark.parametrize("backend", ["numpy", "torch"])
@pytest.mark.parametrize("preemption", ["resume", "restart"])
def test_fault_plan(backend, preemption):
    """A core goes down mid-run and comes back: preemption, migration and
    the fault-lost accounting equal the reference's."""
    def chip_kw(pkg):
        plan = pkg.FaultPlan((pkg.core_down(0, 2), pkg.core_up(0, 7)), preemption=preemption)
        return dict(n_cores=2, design="RASA-WLBP", bw_bytes_per_cycle=16.0, fault_plan=plan)
    from _torch_chip import PORT_BACKENDS
    ref_chip = REF.ChipConfig(backend="numpy", **chip_kw(REF))
    port_chip = PORT.ChipConfig(**PORT_BACKENDS[backend], **chip_kw(PORT))
    works = (lambda pkg: pkg.GemmSpec("f", 128, 256, 256), specs)
    for work in works[:1] if small(backend) else works:
        want = REF.simulate_chip(work(REF), ref_chip)
        got = PORT.simulate_chip(work(PORT), port_chip)
        assert fields_key(got) == fields_key(want)
        assert got.n_preemptions == want.n_preemptions


def test_engine_reexports_simulate_chip():
    from repro_torch.core import engine
    chip_kw = dict(n_cores=2, design="RASA-WLBP", bw_bytes_per_cycle=24.0)
    got = engine.simulate_chip(PORT.GemmSpec("e", 64, 128, 128), chips("numpy", **chip_kw)[1])
    want = REF.simulate_chip(REF.GemmSpec("e", 64, 128, 128), chips("numpy", **chip_kw)[0])
    assert fields_key(got) == fields_key(want)


def test_single_core_reduces_to_simulate():
    """At one core the full budget exceeds one engine's demand: the chip's
    makespan is the single-core simulator's."""
    from repro_torch.core import simulate
    got = same_report("numpy", lambda pkg: pkg.GemmSpec("s", 64, 256, 256),
                      dict(n_cores=1, design="RASA-WLBP"))
    assert got.cycles == simulate(PORT.GemmSpec("s", 64, 256, 256), "RASA-WLBP",
                                  backend="numpy").cycles


def test_cuda_chip_and_telemetry_refuse_on_cpu():
    import torch
    from repro_torch.obs import TelemetryConfig
    chip = PORT.ChipConfig(backend="numpy", n_cores=2)
    with pytest.raises(NotImplementedError, match="item 16"):
        PORT.simulate_chip(PORT.GemmSpec("t", 32, 64, 64), chip,
                           telemetry=TelemetryConfig(enabled=True))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            PORT.simulate_chip(PORT.GemmSpec("t", 32, 64, 64), PORT.ChipConfig(n_cores=2))
