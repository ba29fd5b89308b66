"""Chip-level composition: N per-core engines + a shared-memory model.

Counterpart of the JAX package's ``multicore/chip.py``.  Its simulation
backends (:data:`CHIP_BACKENDS`) are the port's: ``cuda`` (the default, the
scan kernels of :mod:`repro_torch.kernels.fastsim_scan` on the card; a
``cuda`` chip raises where there is no card), ``torch`` (their plain
versions on ``ChipConfig.device``), ``numpy``, ``reference`` and ``fast``.

A ``ChipConfig`` instantiates a :data:`repro_torch.core.designs.DESIGNS` engine
in every core -- one design replicated, or a mixed BASE/RASA vector of
:class:`CoreSpec` -- and throttles the cores' aggregate tile traffic
against a global bytes/cycle budget.  Two arbitration models are
available:

``arbitration="epoch"`` (default)
    Time is divided into scheduling epochs of ``epoch_cycles`` engine
    cycles.  Within each epoch every core still drawing on the memory
    system gets a share of ``bw_bytes_per_cycle`` (equal by default;
    ``share_policy="demand"`` weights shares by measured bytes/cycle
    demand); a core that drains its traffic early *returns its share*, so
    the survivors' shares grow epoch by epoch.  The per-core share
    schedule is found by the monotone fixed-point relaxation of
    :class:`repro_torch.multicore.arbiter.SpanArbiter` -- the **single**
    implementation shared with the open-arrival model
    (:mod:`repro_torch.multicore.online`); the closed batch is its "all spans
    start at epoch 0" special case -- and enforced per core by a
    token-bucket :class:`EpochBandwidthLoadModel`.  The resulting
    per-epoch share/active traces are reported on :class:`ChipReport`.

``arbitration="static"``
    The frozen-share model, kept as the comparison baseline: each active
    core gets ``bw_bytes_per_cycle / n_active`` for the entire run
    (:class:`SharedBandwidthLoadModel`, the same token bucket with a
    constant share).  This over-penalizes long-running cores on skewed
    workloads -- bandwidth freed by early finishers is never
    redistributed.  Always equal-share: it predates (and baselines) the
    share policies.

In both models bursts up to ``bw_burst_bytes`` ride the core's LSQ at full
port rate, the excess wait is accounted as bandwidth-stall cycles, and --
unless ``store_bytes_shared=False`` -- ``rasa_ts`` store traffic is charged
against the same budget and serialized on the engine's store port.  See
``docs/multicore.md`` for the assumptions and their rationale.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Sequence

from ..core.designs import EngineConfig, get_design
from ..core.fastsim import StreamModelParams, _require_card, run_cores
from ..core.isa import Instr, Op, tile_bytes
from ..core.tiling import (ALG1_POLICY, GemmSpec, RegPolicy, lowered_stream)
from ..core.timing import LoadStreamModel, PipelineSimulator, TimingResult
from ..core.trace import (OP_MM, OP_TL, OP_TS, CompiledTrace, compile_stream,
                          compiled_trace)
from ..obs.config import OFF, TelemetryConfig, require_off
from .arbiter import (ArbiterTrace, SharePolicy, Span, SpanArbiter,
                      get_share_policy)
from .faults import FaultPlan
from .partition import partition_gemm

ARBITRATIONS = ("epoch", "static")

#: chip-level simulation backends: the reference Python loop, or the
#: trace-compiled lanes of :mod:`repro_torch.core.fastsim` ("fast" picks
#: cuda for large batches and numpy below, as ``resolve_backend`` does;
#: "torch" runs the kernels' plain versions on ``ChipConfig.device``).
CHIP_BACKENDS = ("reference", "fast", "numpy", "torch", "cuda")


def stream_model_params(chip: "ChipConfig", engine: EngineConfig,
                        shares: Sequence[float] = (),
                        epoch_cycles: float = math.inf,
                        tail: float = math.inf) -> StreamModelParams:
    """The chip's arbiter as fast-backend parameters for one core's
    ``engine`` (default: the unthrottled port model).  Shared by the
    closed-batch cluster and the online model."""
    store_ports = engine.store_ports if chip.store_bytes_shared else None
    return StreamModelParams(
        engine.load_ports, store_ports, tuple(shares),
        epoch_cycles, tail, chip.bw_burst_bytes, chip.store_bytes_shared)


def demands_bandwidth(chip: "ChipConfig", stream: Sequence[Instr] | None,
                      trace: CompiledTrace | None = None) -> bool:
    """Does this stream put any traffic on the shared memory system?"""
    charge_stores = chip.store_bytes_shared
    if trace is not None:
        return trace.n_tl > 0 or (charge_stores and trace.n_ts > 0)
    return any(ins.op is Op.TL or (charge_stores and ins.op is Op.TS)
               for ins in stream)


def shared_traffic_bytes(chip: "ChipConfig",
                         stream: Sequence[Instr] | None,
                         trace: CompiledTrace | None = None) -> float:
    """Total bytes this stream puts on the shared memory system (tile
    loads, plus ``rasa_ts`` stores when they are charged) -- the numerator
    of the demand-weighted share policy's bytes/cycle measurement."""
    if trace is not None:
        total = float(trace.nbytes[trace.opcode == OP_TL].sum())
        if chip.store_bytes_shared:
            total += float(trace.nbytes[trace.opcode == OP_TS].sum())
        return total
    total = 0.0
    for ins in stream:
        if ins.op is Op.TL or (chip.store_bytes_shared and ins.op is Op.TS):
            total += tile_bytes(ins)
    return total


class EpochBandwidthLoadModel(LoadStreamModel):
    """Token-bucket arbiter under a piecewise-constant share schedule.

    ``shares[e]`` is this core's bytes/cycle allowance during epoch ``e``
    (the interval ``[e * epoch_cycles, (e+1) * epoch_cycles)``); epochs past
    the end of the schedule run at ``tail_share`` (the cluster passes the
    full chip budget there: by construction every other core has drained by
    then).  Unused allowance accumulates only up to ``burst_bytes`` -- a core
    cannot bank unbounded credit and replay it later -- which is what makes
    the per-epoch conservation property hold:

        bytes granted per epoch  <=  share * epoch_cycles + burst_bytes
                                     + one in-flight tile

    (the tile term covers the single grant that straddles the epoch edge;
    asserted by ``tests/test_multicore.py``).  A request larger than the
    bucket capacity is granted once the bucket is full and leaves the token
    count negative (debt repaid by subsequent refill), so any tile size
    works with any ``burst_bytes`` including 0.
    """

    def __init__(self, load_ports: int, shares: Sequence[float],
                 epoch_cycles: float, tail_share: float,
                 burst_bytes: float = 16384.0,
                 store_ports: int | None = None,
                 charge_store_bytes: bool = False,
                 record_grants: bool = False):
        if epoch_cycles <= 0:
            raise ValueError("epoch_cycles must be > 0")
        self.shares = tuple(shares)
        self.epoch_cycles = epoch_cycles
        self.tail_share = tail_share
        self._schedule_end = len(self.shares) * epoch_cycles if shares else 0.0
        self.burst_bytes = burst_bytes
        self.charge_store_bytes = charge_store_bytes
        self.record_grants = record_grants
        super().__init__(load_ports, store_ports)

    def reset(self) -> None:
        super().reset()
        self._tokens = self.burst_bytes
        self._t = 0.0           # bucket time: refills are settled up to here
        #: (start, n_bytes) of every granted access, when record_grants.
        self.grants: list[tuple[float, int]] = []

    def _share_at(self, t: float) -> float:
        e = int(t // self.epoch_cycles)
        return self.shares[e] if e < len(self.shares) else self.tail_share

    def _advance(self, t: float) -> None:
        """Settle refills from the bucket time up to ``t`` (capped)."""
        while self._t < t:
            rate = self._share_at(self._t)
            if self._t >= self._schedule_end:
                step_end = t        # constant tail rate: one jump
            else:
                e_end = ((int(self._t // self.epoch_cycles) + 1)
                         * self.epoch_cycles)
                step_end = min(t, e_end)
            if math.isinf(rate):
                self._tokens = self.burst_bytes
            else:
                self._tokens = min(self.burst_bytes,
                                   self._tokens + rate * (step_end - self._t))
            self._t = step_end

    def _grant(self, t_earliest: float, n_bytes: int) -> float:
        """Earliest start >= ``t_earliest`` at which ``n_bytes`` is granted,
        consuming the tokens.  Requests behind the bucket time (out-of-order
        stores, whose ready times are not monotone in issue order) are
        served from the current bucket state without rewinding it."""
        self._advance(t_earliest)
        need = min(float(n_bytes), self.burst_bytes)
        if self._tokens >= need:
            start = t_earliest
        else:
            t, tokens = self._t, self._tokens
            schedule_end = self._schedule_end
            while True:
                rate = self._share_at(t)
                if math.isinf(rate):
                    start = t
                    break
                if rate <= 0.0 and t >= schedule_end:
                    raise RuntimeError("tail share must be > 0: request can "
                                       "never be granted")
                e_end = (int(t // self.epoch_cycles) + 1) * self.epoch_cycles
                if rate > 0.0:
                    t_hit = t + (need - tokens) / rate
                    if t_hit <= e_end or t >= schedule_end:
                        start = t_hit
                        break
                    tokens += rate * (e_end - t)
                t = e_end
            start = max(start, t_earliest)
        self._advance(start)
        self._tokens -= n_bytes
        if self.record_grants:
            self.grants.append((start, n_bytes))
        return start

    def acquire(self, t_request: float, n_bytes: int) -> tuple[float, float]:
        port_start = max(t_request, self._next_free)
        start = self._grant(port_start, n_bytes)
        self._next_free = start + 1.0 / self.load_ports
        self.last_grant = max(self.last_grant, start)
        return start, start - port_start

    def acquire_store(self, t_request: float, n_bytes: int) -> tuple[float, float]:
        if self.store_ports is None:
            return t_request, 0.0
        port_start = max(t_request, self._store_next_free)
        if self.charge_store_bytes:
            start = self._grant(port_start, n_bytes)
        else:
            start = port_start
        self._store_next_free = start + 1.0 / self.store_ports
        self.last_grant = max(self.last_grant, start)
        return start, start - port_start


class SharedBandwidthLoadModel(EpochBandwidthLoadModel):
    """Constant-share token bucket: the ``arbitration="static"`` model.

    The frozen-share baseline: one share for the whole run, i.e. an
    :class:`EpochBandwidthLoadModel` with an empty schedule and
    ``tail_share=bytes_per_cycle``.  Sharing the exact bucket semantics with
    the epoch model matters: the dynamic schedule's shares dominate the
    static share pointwise in time, so with identical bucket mechanics the
    dynamic makespan provably never exceeds the static one.  A load of
    ``n_bytes`` requested at ``t`` may start once (i) a load port slot is
    free and (ii) ``n_bytes`` tokens are available (refill ``share`` per
    cycle, capped at ``burst_bytes``).  With ``share == inf`` this reduces
    exactly to the base port model.
    """

    def __init__(self, load_ports: int, bytes_per_cycle: float,
                 burst_bytes: float = 16384.0,
                 store_ports: int | None = None,
                 charge_store_bytes: bool = False):
        self.bytes_per_cycle = bytes_per_cycle
        super().__init__(load_ports, shares=(), epoch_cycles=math.inf,
                         tail_share=bytes_per_cycle, burst_bytes=burst_bytes,
                         store_ports=store_ports,
                         charge_store_bytes=charge_store_bytes)


@dataclasses.dataclass(frozen=True)
class CoreSpec:
    """One core's configuration in a (possibly mixed) chip.

    The unit of heterogeneity: a :class:`ChipConfig` carries one
    ``CoreSpec`` per core, so BASE and RASA(-DM/-WLBP/...) cores can share
    one chip and flow together through the partitioners, both arbiters,
    all simulation backends, and :class:`ChipReport`.
    """

    design: str
    policy: RegPolicy = ALG1_POLICY

    @property
    def engine(self) -> EngineConfig:
        return get_design(self.design)


@dataclasses.dataclass(frozen=True)
class ChipConfig:
    """A CMP of RASA-equipped cores sharing one memory system.

    By default all ``n_cores`` cores replicate ``design``/``policy``; pass
    ``cores`` -- a tuple of :class:`CoreSpec` (or design-name strings) --
    for a heterogeneous mix, in which case ``cores`` is authoritative:
    ``n_cores`` is derived from it (or must match it if given) and
    ``design``/``policy`` only serve as defaults for string entries.

    ``bw_bytes_per_cycle`` is the chip-wide tile-traffic budget in bytes per
    *engine* cycle; the default 256 B/cyc corresponds to 128 GB/s at the
    paper's 500 MHz engine clock -- ample for one core (so ``n_cores=1``
    reduces exactly to the single-core simulator) but binding for several
    aggressive engines.  Use ``math.inf`` for a contention-free chip.

    ``arbitration`` selects the contention model (``"epoch"`` dynamic
    time-sliced shares recomputed every ``epoch_cycles``; ``"static"`` the
    frozen equal-share baseline).  ``share_policy`` selects how the epoch
    arbiter splits each epoch's budget over the active cores (``"equal"``
    or ``"demand"``; see :mod:`repro_torch.multicore.arbiter`).
    ``store_bytes_shared=False`` recovers the PR-1 loads-only accounting
    where ``rasa_ts`` stores are free.
    """

    n_cores: int | None = None
    design: str = "RASA-DMDB-WLS"
    bw_bytes_per_cycle: float = 256.0
    bw_burst_bytes: float = 16384.0
    policy: RegPolicy = ALG1_POLICY
    arbitration: str = "epoch"
    epoch_cycles: float = 1024.0
    store_bytes_shared: bool = True
    #: simulation backend (see :data:`CHIP_BACKENDS`); "reference" keeps the
    #: per-core Python loop as the exactness oracle.  The default runs on
    #: the card and raises without one: CPU callers ask for "numpy",
    #: "reference", or "torch" with ``device="cpu"``.
    backend: str = "cuda"
    #: epoch-share policy (see :data:`repro_torch.multicore.arbiter.
    #: SHARE_POLICIES`); normalized to a SharePolicy instance.
    share_policy: str | SharePolicy = "equal"
    #: per-core design vector; ``None`` replicates ``design``/``policy``.
    cores: tuple | None = None
    #: deterministic fault-event schedule
    #: (:class:`repro_torch.multicore.faults.FaultPlan`); ``None`` -- the default
    #: and the common case -- is a pristine chip and costs nothing.
    fault_plan: FaultPlan | None = None
    #: where ``backend="torch"`` runs its plain lanes ("cpu" or "cuda")
    device: str = "cuda"

    def __post_init__(self):
        if self.backend not in CHIP_BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}; "
                             f"available: {CHIP_BACKENDS}")
        if not self.bw_bytes_per_cycle > 0:
            raise ValueError("bw_bytes_per_cycle must be > 0 (use math.inf "
                             "for a contention-free chip)")
        if self.bw_burst_bytes < 0:
            raise ValueError("bw_burst_bytes must be >= 0")
        if self.arbitration not in ARBITRATIONS:
            raise ValueError(f"unknown arbitration {self.arbitration!r}; "
                             f"available: {ARBITRATIONS}")
        if not self.epoch_cycles > 0:
            raise ValueError("epoch_cycles must be > 0")
        object.__setattr__(self, "share_policy",
                           get_share_policy(self.share_policy))
        if self.cores is None:
            # the field stays None so dataclasses.replace(design=...) or
            # replace(n_cores=...) re-derives the replicated vector; the
            # resolved form is the core_specs property
            n = 4 if self.n_cores is None else self.n_cores
        else:
            cores = tuple(CoreSpec(c, self.policy) if isinstance(c, str)
                          else c for c in self.cores)
            if not cores:
                raise ValueError("need at least one core")
            n = len(cores) if self.n_cores is None else self.n_cores
            if n != len(cores):
                raise ValueError(f"n_cores={n} does not match "
                                 f"len(cores)={len(cores)}")
            object.__setattr__(self, "cores", cores)
        if n < 1:
            raise ValueError("need at least one core")
        object.__setattr__(self, "n_cores", n)
        for spec in self.core_specs:
            spec.engine             # fail fast on unknown design names
        plan = self.fault_plan
        if plan is not None and plan.is_empty:
            object.__setattr__(self, "fault_plan", None)
            plan = None
        if plan is not None:
            if self.arbitration != "epoch":
                raise ValueError(
                    "fault_plan requires arbitration='epoch': the span "
                    "arbiter is where faults are injected")
            for e in plan.events:
                if e.core >= n:
                    raise ValueError(f"fault event {e.label!r} names "
                                     f"core {e.core} on a {n}-core chip")

    @property
    def core_specs(self) -> tuple[CoreSpec, ...]:
        """The resolved per-core vector: ``cores`` as given, or
        ``design``/``policy`` replicated ``n_cores`` times."""
        if self.cores is not None:
            return self.cores
        cached = self.__dict__.get("_core_specs")
        if cached is None:
            cached = (CoreSpec(self.design, self.policy),) * self.n_cores
            object.__setattr__(self, "_core_specs", cached)
        return cached

    @property
    def homogeneous(self) -> bool:
        specs = self.core_specs
        return all(spec == specs[0] for spec in specs)

    @property
    def engine(self) -> EngineConfig:
        """The chip's engine when every core shares one design.

        Heterogeneous chips have no single engine -- use
        :meth:`core_engine` there; raising here catches call sites that
        silently assumed homogeneity.
        """
        designs = {spec.design for spec in self.core_specs}
        if len(designs) > 1:
            raise ValueError("heterogeneous chip has no single engine; "
                             "use core_engine(core)")
        return self.core_specs[0].engine

    def core_engine(self, core: int) -> EngineConfig:
        return self.core_specs[core].engine

    @property
    def design_name(self) -> str:
        """Report label: the engine name, or a mix summary."""
        if len({spec.design for spec in self.core_specs}) == 1:
            return self.core_specs[0].engine.name
        runs: list[list] = []
        for spec in self.core_specs:
            if runs and runs[-1][0] == spec.design:
                runs[-1][1] += 1
            else:
                runs.append([spec.design, 1])
        return "mixed[" + "+".join(f"{d}x{k}" if k > 1 else d
                                   for d, k in runs) + "]"

    @property
    def store_ports(self) -> int | None:
        """Store-port count handed to the arbiter models (None = stores
        free, the loads-only accounting switch).  Homogeneous chips only;
        per-core form: :meth:`store_ports_for`."""
        return self.engine.store_ports if self.store_bytes_shared else None

    def store_ports_for(self, core: int) -> int | None:
        return self.core_specs[core].engine.store_ports \
            if self.store_bytes_shared else None

    def require_card(self) -> None:
        """Raise where this chip's simulations would need a card that is
        not there (``backend="cuda"``, or ``"torch"`` on a CUDA device):
        there is no fallback to the CPU."""
        if self.backend == "cuda" or (self.backend == "torch"
                                      and self.device.startswith("cuda")):
            _require_card(f"a ChipConfig with backend={self.backend!r}")

    def single_core(self, core: int = 0) -> "ChipConfig":
        """The one-core chip running this chip's ``core`` spec (the
        reference configuration speedups are measured against)."""
        spec = self.core_specs[core]
        # the reference is always a pristine core: faults measure *loss*
        # against the fault-free single-core run
        return dataclasses.replace(self, n_cores=1, cores=(spec,),
                                   design=spec.design, policy=spec.policy,
                                   fault_plan=None)


@dataclasses.dataclass(frozen=True)
class ChipReport:
    """Chip-level aggregate of one multi-core run (cf. core.SimReport)."""

    design: str
    workload: str
    strategy: str                       # partitioner or scheduler used
    n_cores: int
    cycles: float                       # makespan: max over per-core cycles
    single_core_cycles: float           # same work, one core, full bandwidth
    per_core_cycles: tuple[float, ...]
    per_core_utilization: tuple[float, ...]
    utilization: float                  # chip-wide incl. idle cores/tails
    #: cycles added by bandwidth contention, summed over cores: each core's
    #: throttled runtime minus the same stream run with infinite bandwidth.
    bw_stall_cycles: float
    n_mm: int
    wl_skips: int
    macs: int
    per_core_gemms: tuple[tuple[str, ...], ...] = ()
    #: contention model that produced this report ("epoch" or "static")
    arbitration: str = "static"
    #: scheduling-epoch length in engine cycles (0 for the static model)
    epoch_cycles: float = 0.0
    #: bytes/cycle granted per unit arbitration weight, per epoch (equal
    #: shares: exactly the bytes/cycle each active core receives; static:
    #: one entry covering the whole run).  Core *i* receives
    #: ``share_trace[e] * core_weights[i]``.
    share_trace: tuple[float, ...] = ()
    #: cores still drawing on the shared budget, per epoch
    active_trace: tuple[int, ...] = ()
    #: relaxation rounds the epoch arbiter needed (1 for static)
    arb_rounds: int = 1
    #: per relaxation round, cores skipped because their visible share
    #: schedule was unchanged (see :class:`repro_torch.multicore.arbiter.
    #: ArbiterTrace`)
    arb_skipped: tuple[int, ...] = ()
    #: per-core design names (the CoreSpec vector; all equal on a
    #: homogeneous chip)
    core_designs: tuple[str, ...] = ()
    #: epoch-share policy of the arbiter ("equal" or "demand")
    share_policy: str = "equal"
    #: per-core arbitration weights (all 1 under equal shares)
    core_weights: tuple[float, ...] = ()
    #: per-core FF feed cycles (sum of ``tm``) -- the compute-bucket
    #: numerator of the stall attribution
    per_core_compute_cycles: tuple[float, ...] = ()
    #: per-core end-to-end bandwidth-stall cycles (the summands of
    #: :attr:`bw_stall_cycles`)
    per_core_bw_stall_cycles: tuple[float, ...] = ()
    #: per-instance attribution rows (fault runs only): the exact
    #: ``(core, submit, start, finish, compute, bw_stall[, fault_lost])``
    #: tuples handed to :func:`repro_torch.obs.attribution.attribute_segments`.
    #: Empty on fault-free reports, where the per-core vectors above are
    #: the rows.
    attribution_rows: tuple = ()
    #: segments preempted at a core_down boundary
    n_preemptions: int = 0
    #: segments moved off their submitted core (queued or preempted)
    n_migrations: int = 0
    #: busy cycles discarded by preemption (work done but not kept --
    #: the ``fault_lost`` attribution bucket)
    fault_lost_cycles: float = 0.0
    #: fault instants of the run's plan, as ``(epoch, label)`` -- the
    #: Perfetto export renders them as instant markers
    fault_log: tuple[tuple[int, str], ...] = ()
    #: full timeline telemetry (:class:`repro_torch.obs.timeline.ChipTelemetry`);
    #: populated only when the run was made with
    #: ``TelemetryConfig(enabled=True)``.  Identity-compared: two
    #: telemetry-carrying reports never compare equal.
    telemetry: object | None = None
    #: inference phase of the workload ("prefill" / "decode" for compiled
    #: model workloads, "" for hand-written spec lists)
    phase: str = ""

    @property
    def attribution(self):
        """Stall-cycle bucket decomposition of the run
        (:class:`repro_torch.obs.attribution.StallAttribution`), or ``None``
        on reports that predate the per-core compute fields."""
        require_off("ChipReport.attribution")
        if self.attribution_rows:
            return attribute_segments(self.n_cores, self.cycles,
                                      self.attribution_rows)
        if not self.per_core_compute_cycles:
            return None
        rows = [(i, 0.0, 0.0, self.per_core_cycles[i],
                 self.per_core_compute_cycles[i],
                 self.per_core_bw_stall_cycles[i])
                for i in range(self.n_cores)]
        return attribute_segments(self.n_cores, self.cycles, rows)

    @property
    def speedup(self) -> float:
        return self.single_core_cycles / self.cycles if self.cycles else 0.0

    @property
    def efficiency(self) -> float:
        """Parallel efficiency vs. the single-core run (1.0 = linear)."""
        return self.speedup / self.n_cores

    @property
    def occupied_core_cycles(self) -> float:
        """Aggregate occupied core-cycles: makespan x cores that ran work.

        A core that drained early still *occupies* its slot until the chip
        finishes (nothing else can be placed on it within this run), so this
        -- not ``sum(per_core_cycles)`` -- is the denominator against which
        chip-level overheads are meaningfully normalized.
        """
        active = sum(1 for c in self.per_core_cycles if c > 0)
        return self.cycles * active

    @property
    def bw_stall_share(self) -> float:
        """Share of occupied core-cycles (makespan x active cores) lost
        waiting on shared bandwidth.

        Defined against :attr:`occupied_core_cycles` rather than
        ``sum(per_core_cycles)``: mixing drained-early cores' short runtimes
        into the denominator would inflate the apparent stall share on
        skewed workloads.
        """
        occupied = self.occupied_core_cycles
        return self.bw_stall_cycles / occupied if occupied else 0.0

    @property
    def wlbp_rate(self) -> float:
        return self.wl_skips / self.n_mm if self.n_mm else 0.0


class CoreCluster:
    """Runs one instruction stream per core under the shared-memory model.

    The epoch arbitration itself lives in
    :class:`repro_torch.multicore.arbiter.SpanArbiter`; this class is its
    closed-batch client -- it owns the per-core streams/traces, batches
    the arbiter's re-simulation requests through the fast backends, and
    measures contention stalls.
    """

    def __init__(self, chip: ChipConfig):
        chip.require_card()
        self.chip = chip
        plan = chip.fault_plan
        #: per-core speed factors (run-constant ``slow_core`` dilation;
        #: None -- no plan / no slow cores -- keeps every path untouched).
        #: The closed batch samples speeds at epoch 0 and holds them; plans
        #: with timed speed changes route through the online model
        #: (``FaultPlan.needs_online``).
        self._speed: tuple[float, ...] | None = None
        if plan is not None and plan.has_slow_cores:
            self._speed = tuple(plan.speed_factor(c, 0)
                                for c in range(chip.n_cores))
        self._budget_factors = plan.budget_factors() if plan is not None \
            else ()
        #: per-core arbitration weights of the last run (all 1 for equal)
        self.core_weights: tuple[float, ...] = ()
        # -- retained state of the last run_streams call; the telemetry
        # builders (repro_torch.obs.timeline) read these to replay the run.
        self.last_results: list[TimingResult] = []
        self.last_stalls: list[float] = []
        #: per-core stream-model parameters of each core's *final*
        #: simulation -- for the epoch arbiter, the exact visible schedule
        #: (``Span._vis``) the fixed point settled on, so a replay under
        #: them reproduces the run bit for bit.
        self.last_params: list[StreamModelParams] = []
        self.last_streams: Sequence[Sequence[Instr]] | None = None
        self.last_traces: Sequence[CompiledTrace] | None = None

    def run_streams(self, streams: Sequence[Sequence[Instr]] | None,
                    traces: Sequence[CompiledTrace] | None = None
                    ) -> tuple[list[TimingResult], list[float],
                               ArbiterTrace | None]:
        """Simulate every core's stream under the chip's arbitration model.

        Returns ``(results, contention_stalls, trace)`` where
        ``contention_stalls[i]`` is how many cycles core *i* lost to the
        shared-bandwidth throttle (its throttled runtime minus its
        unthrottled runtime -- 0 whenever the budget does not bind) and
        ``trace`` is the per-epoch :class:`ArbiterTrace` (None only when
        there is nothing to arbitrate).

        With a fast backend, ``traces`` (the compiled form) may be passed
        instead of / alongside ``streams``; entry points pass the cached
        traces so the per-round simulations never re-lower anything.
        """
        if self.chip.backend == "reference":
            if streams is None:
                raise ValueError("backend='reference' needs instruction "
                                 "streams")
            traces = None
        elif traces is None:
            if streams is None:
                raise ValueError("need streams or compiled traces")
            traces = [compile_stream(s) for s in streams]
        self.last_streams = streams
        self.last_traces = traces
        if self.chip.arbitration == "static":
            return self._run_static(streams, traces)
        return self._run_epoch(streams, traces)

    # -- shared helpers ----------------------------------------------------
    def _params(self, core: int, shares: Sequence[float] = (),
                epoch_cycles: float = math.inf,
                tail: float = math.inf) -> StreamModelParams:
        if self._speed is not None:
            f = self._speed[core]
            if f != 1.0:
                # dilate into the slow core's local time base: the local
                # clock ticks at f x the chip rate, so one local cycle
                # spans 1/f chip cycles (shares scale by 1/f) and an epoch
                # of E chip cycles holds E*f local cycles.  _sim_round
                # converts the local-time results back (divide by f).
                shares = tuple(s / f for s in shares)
                epoch_cycles = epoch_cycles * f
                tail = tail / f
        return stream_model_params(self.chip, self.chip.core_specs[core].engine,
                                   shares, epoch_cycles, tail)

    def _sim_round(self, idxs: Sequence[int], streams, traces,
                   params: Sequence[StreamModelParams]
                   ) -> list[tuple[TimingResult, float]]:
        """Simulate the given cores (by index) under their arbiter
        parameters, returning ``(TimingResult, last_grant)`` per core.

        ``streams``/``traces`` are parallel to ``idxs``.  Cores that share
        a compiled trace, an engine config *and* identical arbiter
        parameters (symmetric shards under equal shares) are simulated
        once and fan the result out -- results are deterministic in
        (trace, engine, params).
        """
        cfgs = [self.chip.core_specs[i].engine for i in idxs]
        if self.chip.backend == "reference":
            out = []
            for cfg, stream, p in zip(cfgs, streams, params):
                model = p.make_model()
                res = PipelineSimulator(cfg, load_model=model).run(stream)
                out.append((res, model.last_grant))
            return self._descale(idxs, out)
        slot: dict[tuple, int] = {}
        todo_t, todo_c, todo_p = [], [], []
        lanes = []
        for t, c, p in zip(traces, cfgs, params):
            # CompiledTrace is identity-hashed (eq=False), so this
            # deduplicates same-object traces; keying on the trace itself
            # (not id()) keeps a strong reference alive for the dict's
            # lifetime so a recycled id can never alias two traces.
            key = (t, c, p)
            if key not in slot:
                slot[key] = len(todo_t)
                todo_t.append(t)
                todo_c.append(c)
                todo_p.append(p)
            lanes.append(slot[key])
        uniq = run_cores(todo_t, todo_c, todo_p, backend=self.chip.backend,
                         device=self.chip.device)
        return self._descale(idxs, [uniq[k] for k in lanes])

    def _descale(self, idxs: Sequence[int],
                 outs: list[tuple[TimingResult, float]]
                 ) -> list[tuple[TimingResult, float]]:
        """Convert slow cores' local-time results back to chip time (see
        ``_params``); the identity whenever no core is slowed."""
        if self._speed is None:
            return outs
        scaled = []
        for i, (res, lg) in zip(idxs, outs):
            f = self._speed[i]
            if f != 1.0:
                res = dataclasses.replace(
                    res, cycles=res.cycles / f,
                    bw_stall_cycles=res.bw_stall_cycles / f)
                lg = lg / f
            scaled.append((res, lg))
        return scaled

    def _demands_bandwidth(self, stream: Sequence[Instr] | None,
                           trace: CompiledTrace | None = None) -> bool:
        """Does this core put any traffic on the shared memory system?"""
        return demands_bandwidth(self.chip, stream, trace)

    def _demand_vector(self, streams, traces) -> list[bool]:
        n = len(traces if traces is not None else streams)
        return [self._demands_bandwidth(streams[i] if streams else None,
                                        traces[i] if traces else None)
                for i in range(n)]

    def _demand_weights(self, streams, traces, demand,
                        unthrottled: dict[int, TimingResult]
                        ) -> list[float]:
        """Per-core arbitration weights for the chip's share policy.

        Equal shares weigh every core 1 with no extra work; the demand
        policy measures each demanding core's unthrottled bytes/cycle
        (one batched unthrottled round, reused as the contention-stall
        baseline via ``unthrottled``).
        """
        n = len(demand)
        policy = self.chip.share_policy
        if not policy.needs_demand:
            return [1.0] * n
        idxs = [i for i in range(n) if demand[i]]
        weights = [1.0] * n
        if not idxs:
            return weights
        outs = self._sim_round(
            idxs, [streams[i] for i in idxs] if streams else None,
            [traces[i] for i in idxs] if traces else None,
            [self._params(i) for i in idxs])
        for i, (res, _) in zip(idxs, outs):
            unthrottled[i] = res
            traffic = shared_traffic_bytes(
                self.chip, streams[i] if streams else None,
                traces[i] if traces else None)
            weights[i] = policy.weight(traffic / res.cycles
                                       if res.cycles else 0.0)
        return weights

    def _contention_stalls(self, streams, traces,
                           results: Sequence[TimingResult],
                           unthrottled: dict[int, TimingResult] | None = None
                           ) -> list[float]:
        """End-to-end cycles each core lost to the bandwidth throttle.

        Cores whose arbiter never delayed an access ran identically to an
        unthrottled core, so only the stalled subset is re-simulated --
        batched through the fast backend when one is selected, and reusing
        any ``unthrottled`` baselines already measured (demand weighing).
        """
        stalls = [0.0] * len(results)
        pre = unthrottled or {}
        for i, base in pre.items():
            if results[i].bw_stall_cycles != 0.0:
                stalls[i] = max(0.0, results[i].cycles - base.cycles)
        idxs = [i for i, r in enumerate(results)
                if r.bw_stall_cycles != 0.0 and i not in pre]
        if not idxs:
            return stalls
        outs = self._sim_round(
            idxs, [streams[i] for i in idxs] if streams else None,
            [traces[i] for i in idxs] if traces else None,
            [self._params(i) for i in idxs])
        for i, (res, _) in zip(idxs, outs):
            stalls[i] = max(0.0, results[i].cycles - res.cycles)
        return stalls

    # -- static equal shares (PR-1 baseline) -------------------------------
    def _run_static(self, streams, traces):
        chip = self.chip
        demand = self._demand_vector(streams, traces)
        n_active = sum(demand) or 1
        share = chip.bw_bytes_per_cycle / n_active
        idxs = list(range(len(demand)))
        params = [self._params(i, tail=share) for i in idxs]
        results = [r for r, _ in self._sim_round(idxs, streams, traces,
                                                 params)]
        stalls = self._contention_stalls(streams, traces, results)
        self.core_weights = (1.0,) * len(demand)
        self.last_results = results
        self.last_stalls = stalls
        self.last_params = params
        trace = ArbiterTrace(epoch_cycles=0.0, shares=(share,),
                             n_active=(n_active,), rounds=1)
        return results, stalls, trace

    # -- epoch-based dynamic arbitration -----------------------------------
    def _run_epoch(self, streams, traces):
        """The closed batch as the arbiter's "all spans start at 0" case.

        The relaxation itself -- schedule building, skip rules,
        convergence -- lives in :class:`SpanArbiter`; this method only
        owns the per-core inputs and batches the re-simulation requests.
        """
        chip = self.chip
        E = chip.epoch_cycles
        demand = self._demand_vector(streams, traces)
        n = len(demand)
        unthrottled: dict[int, TimingResult] = {}
        weights = self._demand_weights(streams, traces, demand, unthrottled)
        spans = [Span(start=0, end=None if d else 0, demands=d, weight=w)
                 for d, w in zip(demand, weights)]
        results: list[TimingResult | None] = [None] * n

        def simulate(jobs):
            idxs = [i for i, _, _ in jobs]
            params = [self._params(i, prefix, E, tail)
                      for i, prefix, tail in jobs]
            outs = self._sim_round(
                idxs, [streams[i] for i in idxs] if streams else None,
                [traces[i] for i in idxs] if traces else None, params)
            for (i, _, _), (res, lg) in zip(jobs, outs):
                results[i] = res
                spans[i].last_grant = lg
                spans[i].throttled = res.bw_stall_cycles != 0.0

        arb = SpanArbiter(chip.bw_bytes_per_cycle, E, chip.share_policy,
                          oracle=chip.backend == "reference",
                          budget_factors=self._budget_factors)
        trace = arb.relax(spans, simulate)
        self.core_weights = tuple(weights)
        stalls = self._contention_stalls(streams, traces, results,
                                         unthrottled)
        self.last_results = list(results)
        self.last_stalls = stalls
        self.last_params = [
            self._params(i, s._vis[0], E, s._vis[1])
            if s._vis is not None else self._params(i)
            for i, s in enumerate(spans)]
        return results, stalls, trace


def _lower_many(specs: Sequence[GemmSpec], policy: RegPolicy) -> list[Instr]:
    stream: list[Instr] = []
    for spec in specs:
        stream.extend(lowered_stream(spec, policy))
    return stream


def _streams_traces(chip: ChipConfig, shards: Sequence[Sequence[GemmSpec]]):
    """Per-core simulator inputs: instruction streams for the reference
    backend, cached compiled traces for the fast backends (which then never
    materialize ``Instr`` lists at all).

    Trace cache keys drop the spec names: lowering depends only on the
    dims, so the equal-dim shards a symmetric partitioner emits ("x@c0",
    "x@c1", ...) share one compiled trace -- and, downstream, one
    simulation per arbiter round (see ``CoreCluster._sim_round``).
    Lowering runs under each core's own register policy.
    """
    if chip.backend == "reference":
        return [_lower_many(shard, chip.core_specs[i].policy)
                for i, shard in enumerate(shards)], None
    return None, [
        compiled_trace(tuple(dataclasses.replace(s, name="")
                             for s in shard), chip.core_specs[i].policy)
        for i, shard in enumerate(shards)]


def _compute_cycles_vec(streams, traces,
                        n_cores: int) -> tuple[float, ...]:
    """Per-core FF feed cycles (sum of ``tm``) from whichever simulator
    input the run used -- a vectorized sum over the cached trace arrays,
    or one attribute pass over the already-lowered reference stream."""
    out = []
    for i in range(n_cores):
        if traces is not None:
            t = traces[i]
            out.append(float(t.tm[t.opcode == OP_MM].sum()))
        elif streams is not None:
            out.append(float(sum(ins.tm for ins in streams[i]
                                 if ins.op is Op.MM)))
        else:
            out.append(0.0)
    return tuple(out)


def _aggregate(chip: ChipConfig, workload_name: str, strategy: str,
               shards: Sequence[Sequence[GemmSpec]],
               results: Sequence[TimingResult], stalls: Sequence[float],
               single_core_cycles: float,
               trace: ArbiterTrace | None = None,
               core_weights: tuple[float, ...] = (), *,
               streams=None, traces=None, phase: str = "") -> ChipReport:
    compute = _compute_cycles_vec(streams, traces, chip.n_cores)
    plan = chip.fault_plan
    if plan is not None and plan.has_slow_cores:
        # a slowed core's FF feed cycles dilate with its clock, keeping
        # compute + stalls <= busy in chip time (attribution conservation)
        compute = tuple(c / plan.speed_factor(i, 0)
                        for i, c in enumerate(compute))
    cycles = max((r.cycles for r in results), default=0.0)
    peak = sum(spec.engine.peak_macs_per_cycle for spec in chip.core_specs)
    chip_util = (sum(r.useful_macs for r in results)
                 / (cycles * peak)) if cycles else 0.0
    return ChipReport(
        design=chip.design_name,
        workload=workload_name,
        strategy=strategy,
        n_cores=chip.n_cores,
        cycles=cycles,
        single_core_cycles=single_core_cycles,
        per_core_cycles=tuple(r.cycles for r in results),
        per_core_utilization=tuple(r.utilization for r in results),
        utilization=chip_util,
        bw_stall_cycles=sum(stalls),
        n_mm=sum(r.n_mm for r in results),
        wl_skips=sum(r.wl_skips for r in results),
        macs=sum(int(s.macs) for shard in shards for s in shard),
        per_core_gemms=tuple(tuple(s.name for s in shard) for shard in shards),
        arbitration=chip.arbitration,
        epoch_cycles=trace.epoch_cycles if trace else 0.0,
        share_trace=trace.shares if trace else (),
        active_trace=trace.n_active if trace else (),
        arb_rounds=trace.rounds if trace else 1,
        arb_skipped=trace.skipped if trace else (),
        core_designs=tuple(spec.design for spec in chip.core_specs),
        # static arbitration is the frozen *equal*-share baseline
        # regardless of the configured policy (see _run_static)
        share_policy=chip.share_policy.name
        if chip.arbitration == "epoch" else "equal",
        core_weights=tuple(core_weights),
        per_core_compute_cycles=compute,
        per_core_bw_stall_cycles=tuple(stalls),
        fault_log=tuple((e.epoch, e.label) for e in plan.events)
        if plan is not None else (),
        phase=phase,
    )


@functools.lru_cache(maxsize=1024)
def _single_core_cycles_cached(chip: ChipConfig,
                               specs: tuple[GemmSpec, ...]) -> float:
    spec0 = chip.core_specs[0]
    cfg = spec0.engine
    params = StreamModelParams(
        cfg.load_ports, chip.store_ports_for(0), (), math.inf,
        chip.bw_bytes_per_cycle, chip.bw_burst_bytes,
        chip.store_bytes_shared)
    if chip.backend == "reference":
        sim = PipelineSimulator(cfg, load_model=params.make_model())
        return sim.run(_lower_many(specs, spec0.policy)).cycles
    trace = compiled_trace(tuple(dataclasses.replace(s, name="")
                                 for s in specs), spec0.policy)
    return run_cores([trace], cfg, [params], backend=chip.backend,
                     device=chip.device)[0][0].cycles


def _single_core_cycles(chip: ChipConfig, specs: Sequence[GemmSpec]) -> float:
    """Reference: all work on one core with the full bandwidth budget.

    Mixed chips are referenced against their core-0 spec (document the
    mix you compare against by ordering ``cores`` accordingly).
    """
    return _single_core_cycles_cached(chip.single_core(), tuple(specs))


def _attach_telemetry(report: ChipReport, cluster: CoreCluster,
                      shards, telemetry: TelemetryConfig) -> ChipReport:
    require_off("chip telemetry", telemetry)
    return report


def _seg_compute_cycles(seg) -> float:
    """One online segment's FF feed cycles in chip time (preempted
    instances are credited with their kept prefix only)."""
    if seg.preempted_at is not None:
        return seg.kept_compute
    if seg.trace is not None:
        t = seg.trace
        return float(t.tm[t.opcode == OP_MM].sum()) / seg.speed
    if seg.stream is not None:
        return float(sum(ins.tm for ins in seg.stream
                         if ins.op is Op.MM)) / seg.speed
    return 0.0


def assemble_online_report(sim, chip: ChipConfig, workload_name: str,
                           strategy: str,
                           shards: Sequence[Sequence[GemmSpec]],
                           single_core_cycles: float,
                           telemetry: TelemetryConfig = OFF,
                           phase: str = "") -> ChipReport:
    """A :class:`ChipReport` from a drained :class:`OnlineChip` history.

    The closed-batch assembly path for fault plans that need the online
    machinery (:func:`repro_torch.multicore.faults.faulted_chip_report`).  The
    per-instance outcomes become :attr:`ChipReport.attribution_rows` --
    a preempted instance is busy from its start to the fault boundary,
    credited with its kept prefix's compute and charged the rest to the
    ``fault_lost`` bucket; its resumed remainder is a row of its own.
    Per-instance bandwidth stalls follow the closed cluster's end-to-end
    definition (throttled minus unthrottled makespan, clamped so
    fill/drain stays non-negative), measured with one unthrottled re-sim
    per distinct trace.
    """
    from ..core.fastsim import run_segment

    E = chip.epoch_cycles
    n = chip.n_cores
    segs = sim.history
    cycles = sim.makespan
    per_core = [0.0] * n
    per_stall = [0.0] * n
    per_compute = [0.0] * n
    per_macs = [0.0] * n
    unthrottled: dict[tuple, float] = {}
    rows = []
    for seg in segs:
        c = seg.core
        finish = seg.span.start * E + seg.result.cycles
        per_core[c] = max(per_core[c], finish)
        comp = _seg_compute_cycles(seg)
        per_compute[c] += comp
        per_macs[c] += seg.result.useful_macs
        if seg.preempted_at is not None:
            lost = max(0.0, seg.result.cycles - comp)
            bw = 0.0
        else:
            lost = 0.0
            bw = 0.0
            if seg.result.bw_stall_cycles != 0.0:
                engine = chip.core_specs[c].engine
                trace = seg.trace if seg.trace is not None \
                    else compile_stream(seg.stream)
                key = (trace, engine.name)
                base = unthrottled.get(key)
                if base is None:
                    base = run_segment(
                        trace, engine,
                        stream_model_params(chip, engine))[0].cycles
                    unthrottled[key] = base
                busy = seg.result.cycles
                bw = min(max(0.0, busy - base / seg.speed),
                         max(0.0, busy - comp))
        per_stall[c] += bw
        rows.append((c, seg.submit_epoch * E, seg.span.start * E, finish,
                     comp, bw, lost))
    peak = sum(spec.engine.peak_macs_per_cycle for spec in chip.core_specs)
    util = [per_macs[c] / (per_core[c]
                           * chip.core_specs[c].engine.peak_macs_per_cycle)
            if per_core[c] else 0.0 for c in range(n)]
    plan = chip.fault_plan
    report = ChipReport(
        design=chip.design_name,
        workload=workload_name,
        strategy=strategy,
        n_cores=n,
        cycles=cycles,
        single_core_cycles=single_core_cycles,
        per_core_cycles=tuple(per_core),
        per_core_utilization=tuple(util),
        utilization=sum(per_macs) / (cycles * peak) if cycles else 0.0,
        bw_stall_cycles=sum(per_stall),
        n_mm=sum(s.result.n_mm for s in segs),
        wl_skips=sum(s.result.wl_skips for s in segs),
        macs=sum(int(s.macs) for shard in shards for s in shard),
        per_core_gemms=tuple(tuple(s.name for s in shard)
                             for shard in shards),
        arbitration=chip.arbitration,
        epoch_cycles=E,
        share_trace=sim.share_trace,
        active_trace=sim.active_trace,
        arb_rounds=sim.stats["rounds"],
        core_designs=tuple(spec.design for spec in chip.core_specs),
        share_policy=chip.share_policy.name,
        per_core_compute_cycles=tuple(per_compute),
        per_core_bw_stall_cycles=tuple(per_stall),
        attribution_rows=tuple(rows),
        n_preemptions=sim.n_preempted,
        n_migrations=sim.n_migrated,
        fault_lost_cycles=sim.fault_lost_cycles,
        fault_log=tuple((e.epoch, e.label) for e in plan.events)
        if plan is not None else (),
        phase=phase,
    )
    require_off("online telemetry", telemetry)
    return report


def partitioned_chip_report(spec: GemmSpec, chip: ChipConfig,
                            strategy: str = "m_split",
                            telemetry: TelemetryConfig = OFF) -> ChipReport:
    """Shard one GEMM across the chip's cores and report scaling."""
    shards = partition_gemm(spec, chip.n_cores, strategy)
    if chip.fault_plan is not None and chip.fault_plan.needs_online:
        from .faults import faulted_chip_report
        return faulted_chip_report(shards, chip, spec.name, strategy,
                                   telemetry)
    streams, traces = _streams_traces(chip, shards)
    cluster = CoreCluster(chip)
    results, stalls, trace = cluster.run_streams(streams, traces)
    report = _aggregate(chip, spec.name, strategy, shards, results, stalls,
                        _single_core_cycles(chip, [spec]), trace,
                        cluster.core_weights, streams=streams, traces=traces)
    return _attach_telemetry(report, cluster, shards, telemetry)


def simulate_chip(workload, chip: ChipConfig | None = None, *,
                  partition: str = "m_split",
                  scheduler: str = "work_queue",
                  telemetry: TelemetryConfig = OFF,
                  **chip_kwargs) -> ChipReport:
    """Chip-level analogue of :func:`repro_torch.core.simulate`.

    ``workload`` is one :class:`GemmSpec` -- partitioned across cores with
    ``partition`` -- a compiled model :class:`repro_torch.workload.Workload` --
    scheduled with ``scheduler`` over its atomic placement units -- or a
    sequence of specs, scheduled with ``scheduler`` (see
    :mod:`repro_torch.multicore.scheduler`; the ``gang``/``gang_refine``
    schedulers also use ``partition`` to split dominant GEMMs across idle
    cores).  Extra keyword arguments construct the :class:`ChipConfig` when
    none is given.  ``telemetry=TelemetryConfig(enabled=True)`` raises
    :class:`NotImplementedError` until the rest of ``obs/`` is ported.
    """
    if chip is None:
        chip = ChipConfig(**chip_kwargs)
    elif chip_kwargs:
        raise TypeError(f"pass either a ChipConfig or config kwargs, not "
                        f"both: {sorted(chip_kwargs)}")
    require_off("simulate_chip", telemetry)
    chip.require_card()
    if isinstance(workload, GemmSpec):
        return partitioned_chip_report(workload, chip, partition, telemetry)
    from ..workload.compile import Workload
    if isinstance(workload, Workload):
        from .scheduler import scheduled_workload_report
        return scheduled_workload_report(workload, chip, scheduler,
                                         partition=partition,
                                         telemetry=telemetry)
    from .scheduler import scheduled_chip_report
    return scheduled_chip_report(list(workload), chip, scheduler,
                                 partition=partition, telemetry=telemetry)
