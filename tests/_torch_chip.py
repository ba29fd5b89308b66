"""Shared plumbing of the chip-model and batcher parity tests
(tests/test_torch_chip_*.py, tests/test_torch_batcher*.py): the two
packages' entry points side by side, and the keys their reports are
compared by.

Every test builds its inputs in both packages from the same plain
arguments (strings and numbers), runs the reference on the numpy client
and the port on the backend under test, and compares by exact equality:
the reference's own bar ("any ulp of drift is a bug").
"""

import dataclasses
from types import SimpleNamespace

from repro.core import fastsim as r_fastsim
from repro.core import tiling as r_tiling
from repro.core import trace as r_trace
from repro.multicore import chip as r_chip
from repro.multicore import faults as r_faults
from repro.multicore import online as r_online
from repro.serving import simbatch as r_sb
from repro_torch.core import fastsim as t_fastsim
from repro_torch.core import tiling as t_tiling
from repro_torch.core import trace as t_trace
from repro_torch.multicore import chip as t_chip
from repro_torch.multicore import faults as t_faults
from repro_torch.multicore import online as t_online
from repro_torch.serving import simbatch as t_sb


def _pkg(fastsim, tiling, trace, chip, faults, online, sb):
    return SimpleNamespace(
        fastsim=fastsim, GemmSpec=tiling.GemmSpec, ALG1=tiling.ALG1_POLICY,
        lower_gemm=tiling.lower_gemm, compile_stream=trace.compile_stream,
        ChipConfig=chip.ChipConfig, simulate_chip=chip.simulate_chip,
        stream_model_params=chip.stream_model_params, FaultPlan=faults.FaultPlan,
        core_down=faults.core_down, core_up=faults.core_up, bw_derate=faults.bw_derate,
        slow_core=faults.slow_core, random_plan=faults.random_plan,
        OnlineChip=online.OnlineChip, run_batcher=sb.run_batcher,
        synthetic_trace=sb.synthetic_trace, skewed_trace=sb.skewed_trace,
        model_trace=sb.model_trace, ServeRequest=sb.ServeRequest,
        report_from_finishes=sb.report_from_finishes)


REF = _pkg(r_fastsim, r_tiling, r_trace, r_chip, r_faults, r_online, r_sb)
PORT = _pkg(t_fastsim, t_tiling, t_trace, t_chip, t_faults, t_online, t_sb)

#: the port's CPU backends: (backend, ChipConfig keywords)
PORT_BACKENDS = {"numpy": dict(backend="numpy"),
                 "torch": dict(backend="torch", device="cpu"),
                 "reference": dict(backend="reference")}


def chips(backend: str = "numpy", **kw):
    """(reference chip, port chip) from the same keywords; the reference
    runs its numpy client (its reference oracle for ``backend="reference"``)."""
    ref = REF.ChipConfig(backend="reference" if backend == "reference" else "numpy", **kw)
    return ref, PORT.ChipConfig(**PORT_BACKENDS[backend], **kw)


def fields_key(report) -> tuple:
    """Every field of a report that takes part in its equality, by name."""
    return tuple((f.name, getattr(report, f.name)) for f in dataclasses.fields(report)
                 if f.compare and f.name != "telemetry")


def to_port_requests(requests) -> tuple:
    """The reference's ServeRequests as the port's (same fields)."""
    def spec(s):
        return PORT.GemmSpec(s.name, s.M, s.K, s.N)
    out = []
    for r in requests:
        pre = spec(r.prefill) if isinstance(r.prefill, REF.GemmSpec) \
            else tuple(spec(s) for s in r.prefill)
        out.append(PORT.ServeRequest(r.name, r.arrival_epoch, pre,
                                     tuple(spec(s) for s in r.decode), r.deadline))
    return tuple(out)


def batch_pair(ref_requests, ref_chip, port_chip, **kw):
    """(reference report, port report) of one batcher run, same requests."""
    want = REF.run_batcher(ref_requests, ref_chip, **kw)
    got = PORT.run_batcher(to_port_requests(ref_requests), port_chip, **kw)
    return want, got


def assert_same_batch(ref_requests, ref_chip, port_chip, **kw):
    want, got = batch_pair(ref_requests, ref_chip, port_chip, **kw)
    assert fields_key(got) == fields_key(want)
    return want, got
