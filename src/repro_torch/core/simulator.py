"""High-level driver: workload -> lowered stream -> timing, per design.

This is the reproduction of the paper's evaluation flow (LIBXSMM trace ->
MacSim), minus the parts we rebuild analytically (see DESIGN.md §3): the
GEMM is lowered by ``tiling.lower_gemm`` (the LIBXSMM-equivalent microkernel
generator) and timed by ``timing.PipelineSimulator`` (the MacSim-equivalent
matrix-engine model).

Every entry point takes a ``backend``:

``"cuda"`` (default)
    The hand-written scan kernels of
    :mod:`repro_torch.kernels.fastsim_scan`, on the card (it raises
    without one).
``"reference"``
    The pure-Python :class:`PipelineSimulator` -- the exactness oracle.
``"fast"``
    Trace-compiled (:mod:`repro_torch.core.trace`) and run by
    :mod:`repro_torch.core.fastsim`: the CUDA scan kernels when the batch
    is large enough to amortize a launch (and then it raises without a
    card), the bit-exact numpy SoA loop otherwise.
``"numpy"`` / ``"torch"``
    Force a host lane: the numpy loop, or the kernels' plain PyTorch
    versions on ``device`` (the card by default; ``device="cpu"`` on the
    CPU).  CPU callers pass one of these, or ``"reference"``.

A custom ``load_model`` whose parameters the fast backends cannot express
(see :meth:`repro_torch.core.fastsim.StreamModelParams.from_model`) runs on
the reference simulator, the only one that knows its semantics, as in the
JAX package.
"""

from __future__ import annotations

import dataclasses
import functools

from . import fastsim
from .designs import DESIGNS, EngineConfig, get_design
from .timing import LoadStreamModel, PipelineSimulator, TimingResult
from .tiling import ALG1_POLICY, GemmSpec, RegPolicy, lowered_stream
from .trace import gemm_trace

BACKENDS = ("reference", "fast", "numpy", "torch", "cuda")


@dataclasses.dataclass(frozen=True)
class SimReport:
    design: str
    workload: str
    cycles: float
    n_mm: int
    n_tl: int
    n_ts: int
    wl_skips: int
    utilization: float
    runtime_s: float
    macs: int
    #: see TimingResult.bw_stall_cycles -- arbiter delay, not end-to-end.
    bw_stall_cycles: float = 0.0

    @property
    def load_stall_cycles(self) -> float:
        """Deprecated alias of :attr:`bw_stall_cycles` (pre-PR-6 name)."""
        return self.bw_stall_cycles

    @property
    def macs_per_cycle(self) -> float:
        return self.macs / self.cycles if self.cycles else 0.0


def _to_report(spec: GemmSpec, cfg: EngineConfig,
               res: TimingResult) -> SimReport:
    return SimReport(
        design=cfg.name,
        workload=spec.name,
        cycles=res.cycles,
        n_mm=res.n_mm, n_tl=res.n_tl, n_ts=res.n_ts,
        wl_skips=res.wl_skips,
        utilization=res.utilization,
        runtime_s=res.cycles / cfg.engine_clock_hz,
        macs=spec.macs,
        bw_stall_cycles=res.bw_stall_cycles,
    )


def _fast_params(cfg: EngineConfig, load_model: LoadStreamModel | None
                 ) -> fastsim.StreamModelParams | None:
    if load_model is None:
        return fastsim.StreamModelParams.for_config(cfg)
    return fastsim.StreamModelParams.from_model(load_model)


def simulate(spec: GemmSpec, design: str | EngineConfig,
             policy: RegPolicy = ALG1_POLICY,
             load_model: LoadStreamModel | None = None,
             backend: str = "cuda", device="cuda") -> SimReport:
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; "
                         f"available: {BACKENDS}")
    cfg = get_design(design) if isinstance(design, str) else design
    if backend != "reference":
        params = _fast_params(cfg, load_model)
        if params is not None:
            trace = gemm_trace(spec, policy)
            res = fastsim.sweep_trace(trace, [cfg], params, backend,
                                      device)[0]
            return _to_report(spec, cfg, res)
        # an exotic load model: only the reference loop knows its semantics
    sim = PipelineSimulator(cfg, load_model=load_model)
    res: TimingResult = sim.run(lowered_stream(spec, policy))
    return _to_report(spec, cfg, res)


@functools.lru_cache(maxsize=4096)
def _simulate_cached(spec: GemmSpec, design: str | EngineConfig,
                     policy: RegPolicy, backend: str,
                     device: str) -> SimReport:
    """Memoized :func:`simulate`.

    ``design`` may be a name from :data:`DESIGNS` *or* any frozen custom
    :class:`EngineConfig` (hashable), so design-space searches probing
    perturbed configs hit the cache instead of re-simulating every probe.
    """
    return simulate(spec, design, policy, backend=backend, device=device)


def normalized_runtime(spec: GemmSpec, design: str | EngineConfig,
                       policy: RegPolicy = ALG1_POLICY,
                       baseline: str = "BASE",
                       backend: str = "cuda", device: str = "cuda") -> float:
    """Runtime normalized to the BASE design (paper Fig. 5 / Fig. 7 y-axis)."""
    base = _simulate_cached(spec, baseline, policy, backend, device)
    d = _simulate_cached(spec, design, policy, backend, device)
    return d.cycles / base.cycles


def _as_configs(designs) -> list[EngineConfig]:
    cfgs = [get_design(d) if isinstance(d, str) else d
            for d in (designs or list(DESIGNS))]
    names = [c.name for c in cfgs]
    if len(set(names)) != len(names):
        raise ValueError(f"design names must be unique, got {names}")
    return cfgs


def sweep_designs(spec: GemmSpec, designs: list | None = None,
                  policy: RegPolicy = ALG1_POLICY,
                  backend: str = "cuda",
                  device="cuda") -> dict[str, SimReport]:
    """Simulate one GEMM under many designs (names or custom configs).

    The fast backends compile the stream to a trace once and run all
    designs as the lanes of one scan.
    """
    cfgs = _as_configs(designs)
    if backend == "reference":
        entries = list(designs or list(DESIGNS))
        return {cfg.name: _simulate_cached(spec, entry, policy, backend, device)
                for entry, cfg in zip(entries, cfgs)}
    trace = gemm_trace(spec, policy)
    results = fastsim.sweep_trace(trace, cfgs, backend=backend, device=device)
    return {cfg.name: _to_report(spec, cfg, res)
            for cfg, res in zip(cfgs, results)}


def sweep_workload(specs: list[GemmSpec], designs: list | None = None,
                   policy: RegPolicy = ALG1_POLICY,
                   backend: str = "cuda",
                   device="cuda") -> list[dict[str, SimReport]]:
    """Simulate every (GEMM, design) pair of a workload.

    Returns one ``{design name: SimReport}`` dict per spec, in order.  The
    device lanes take the whole grid in one launch (a lane per pair).
    """
    cfgs = _as_configs(designs)
    if backend == "reference":
        return [sweep_designs(spec, designs, policy, backend) for spec in specs]
    traces = [gemm_trace(spec, policy) for spec in specs]
    grid = fastsim.sweep_traces(traces, cfgs, backend=backend, device=device)
    return [{cfg.name: _to_report(spec, cfg, res)
             for cfg, res in zip(cfgs, row)}
            for spec, row in zip(specs, grid)]
