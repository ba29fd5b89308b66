"""Deterministic fault injection: core failures, thermal throttling and
slow cores, as timed events over the chip simulation.

A production chip loses utilization not only to the overheads the schedule
planned for (fill/drain, bandwidth contention) but to *events it did not*:
cores dropping offline, thermal bandwidth derating, DVFS-throttled cores.
This module is the single description of those events -- a seedable,
deterministic :class:`FaultPlan` attached to
:class:`~repro_torch.multicore.chip.ChipConfig` and honored by both arbitration
clients:

* ``bw_derate(factor, epoch, until)`` scales the shared token-bucket
  budget per epoch through the span arbiter's ``budget_factors`` (see
  :class:`~repro_torch.multicore.arbiter.SpanArbiter`): every active span's
  share in a derated epoch shrinks by the factor, and the dynamic
  arbitration re-balances around the window exactly as it does around
  arrivals and departures.
* ``slow_core(core, factor)`` dilates one core's time base: the core's
  engine retires work at ``factor`` times its nominal rate (DVFS throttle
  model).  Simulated exactly by rescaling the core's visible share
  schedule into its local time base and converting results back.
* ``core_down(core, epoch)`` / ``core_up(core, epoch)`` take a core
  offline at an epoch boundary and back.  In the open-arrival model
  (:class:`~repro_torch.multicore.online.OnlineChip`) a downed core's in-flight
  segment is **preempted at the boundary**: the deterministic
  :func:`repro_torch.core.fastsim.completed_prefix` replay counts how many of
  its instructions had fully retired, the kept prefix is rounded down to
  the ``SimCarry`` snapshot stride (``preemption="resume"``) or discarded
  entirely (``"restart"``), and the remainder is requeued on the
  best surviving core.  Queued work migrates immediately.  Closed-batch
  runs with core events are routed through the online model
  (:func:`faulted_chip_report`).

Every decision is a pure function of the plan and the settled schedule --
no wall clock, no hidden RNG -- so fault runs are bit-reproducible across
the reference/numpy/torch/cuda backends (the JAX package's
``tests/test_faults.py`` pins its own; ``tests/test_torch_chip_model.py``
holds the port's to it).
The empty plan is the common case and is zero-cost: every fault hook in
the simulators is gated on ``plan is None``/``plan.is_empty`` and leaves
the fault-free arithmetic untouched.

Work lost to preemption lands in the telemetry's sixth attribution bucket
``fault_lost`` (see :mod:`repro_torch.obs.attribution`); fault instants surface
as markers in the Perfetto export.  See ``docs/resilience.md``.
"""

from __future__ import annotations

import dataclasses
import functools
import random

FAULT_KINDS = ("core_down", "core_up", "bw_derate", "slow_core")

#: what happens to a preempted segment's progress: ``"resume"`` keeps the
#: completed prefix up to the latest ``SimCarry`` snapshot boundary,
#: ``"restart"`` discards it (checkpoint-less hardware).  Migration across
#: heterogeneous designs always restarts -- engine state cannot move
#: between different pipelines.
PREEMPTION_POLICIES = ("resume", "restart")


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One timed fault event (see the module constructors).

    ``epoch`` is the scheduling epoch at whose boundary the event takes
    effect (before any segment starts at that boundary).  ``until`` bounds
    windowed events (``bw_derate`` requires it; ``slow_core`` treats
    ``None`` as "for the rest of the run").  ``factor`` is the derate /
    speed multiplier in ``(0, 1]``.
    """

    kind: str
    epoch: int
    core: int = -1
    factor: float = 1.0
    until: int | None = None

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"available: {FAULT_KINDS}")
        if self.epoch < 0:
            raise ValueError("fault epoch must be >= 0")
        if self.kind in ("core_down", "core_up", "slow_core") \
                and self.core < 0:
            raise ValueError(f"{self.kind} needs a core index")
        if self.kind in ("bw_derate", "slow_core") \
                and not 0.0 < self.factor <= 1.0:
            raise ValueError(f"{self.kind} factor must be in (0, 1] "
                             f"(got {self.factor}): a zero budget or speed "
                             f"would never finish")
        if self.kind == "bw_derate" and self.until is None:
            raise ValueError("bw_derate needs an epoch range: pass until")
        if self.until is not None and self.until <= self.epoch:
            raise ValueError(f"until={self.until} must be > "
                             f"epoch={self.epoch}")

    @property
    def label(self) -> str:
        """Human-readable marker text (Perfetto fault-instant markers)."""
        if self.kind == "core_down":
            return f"core{self.core} down"
        if self.kind == "core_up":
            return f"core{self.core} up"
        if self.kind == "bw_derate":
            return f"bw x{self.factor:g} [{self.epoch},{self.until})"
        return f"core{self.core} x{self.factor:g}"


def core_down(core: int, epoch: int) -> FaultEvent:
    """Core ``core`` goes offline at epoch ``epoch``'s boundary."""
    return FaultEvent("core_down", epoch, core)


def core_up(core: int, epoch: int) -> FaultEvent:
    """Core ``core`` comes back online at epoch ``epoch``'s boundary."""
    return FaultEvent("core_up", epoch, core)


def bw_derate(factor: float, epoch: int, until: int) -> FaultEvent:
    """Thermal throttle: scale the shared budget by ``factor`` over the
    epoch window ``[epoch, until)``.  Overlapping windows compound."""
    return FaultEvent("bw_derate", epoch, factor=factor, until=until)


def slow_core(core: int, factor: float, epoch: int = 0,
              until: int | None = None) -> FaultEvent:
    """DVFS throttle: core ``core`` runs at ``factor`` of nominal speed
    from ``epoch`` on (``until=None``: for the rest of the run).  A
    segment samples its core's speed at its start boundary and holds it
    for its whole run (segment-granular DVFS)."""
    return FaultEvent("slow_core", epoch, core, factor, until)


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A deterministic, seedable schedule of fault events.

    Attach to :class:`~repro_torch.multicore.chip.ChipConfig` via its
    ``fault_plan`` field.  ``preemption`` selects what a downed core's
    in-flight segment keeps (see :data:`PREEMPTION_POLICIES`).  Frozen and
    hashable; the empty plan (``FaultPlan()``) is a no-op by construction
    -- every simulator hook is gated on :attr:`is_empty`.
    """

    events: tuple[FaultEvent, ...] = ()
    preemption: str = "resume"

    def __post_init__(self):
        object.__setattr__(self, "events", tuple(self.events))
        if self.preemption not in PREEMPTION_POLICIES:
            raise ValueError(f"unknown preemption policy "
                             f"{self.preemption!r}; available: "
                             f"{PREEMPTION_POLICIES}")

    @property
    def is_empty(self) -> bool:
        return not self.events

    @functools.cached_property
    def core_events(self) -> tuple[FaultEvent, ...]:
        """core_down/core_up events in epoch order (stable: same-epoch
        events apply in plan order)."""
        return tuple(sorted(
            (e for e in self.events if e.kind in ("core_down", "core_up")),
            key=lambda e: e.epoch))

    @property
    def has_core_events(self) -> bool:
        return bool(self.core_events)

    @functools.cached_property
    def _slow_events(self) -> tuple[FaultEvent, ...]:
        return tuple(e for e in self.events if e.kind == "slow_core")

    @property
    def has_slow_cores(self) -> bool:
        return bool(self._slow_events)

    @property
    def needs_online(self) -> bool:
        """Does this plan need the open-arrival machinery (preemption /
        migration / timed speed changes)?  Closed-batch runs support
        ``bw_derate`` windows and run-constant ``slow_core`` natively;
        anything event-driven mid-run routes through
        :func:`faulted_chip_report`."""
        return self.has_core_events or any(
            e.epoch > 0 or e.until is not None for e in self._slow_events)

    def budget_factors(self) -> tuple[float, ...]:
        """Per-epoch shared-budget multipliers from the ``bw_derate``
        windows (1.0 outside every window; overlaps compound)."""
        der = [e for e in self.events if e.kind == "bw_derate"]
        if not der:
            return ()
        fac = [1.0] * max(e.until for e in der)
        for e in der:
            for ep in range(e.epoch, e.until):
                fac[ep] *= e.factor
        return tuple(fac)

    def speed_factor(self, core: int, epoch: int) -> float:
        """Core ``core``'s speed multiplier at ``epoch`` (compounded over
        the active ``slow_core`` windows)."""
        f = 1.0
        for e in self._slow_events:
            if (e.core == core and e.epoch <= epoch
                    and (e.until is None or epoch < e.until)):
                f *= e.factor
        return f

    def core_available(self, core: int, epoch: int) -> bool:
        """Is ``core`` online at ``epoch`` (down/up events replayed)?"""
        up = True
        for e in self.core_events:
            if e.epoch > epoch:
                break
            if e.core == core:
                up = e.kind == "core_up"
        return up

    def next_core_event(self, after: int) -> int | None:
        """Earliest core_down/core_up epoch strictly after ``after``."""
        for e in self.core_events:
            if e.epoch > after:
                return e.epoch
        return None


#: the shared no-op plan (what ``ChipConfig.fault_plan=None`` means)
EMPTY_PLAN = FaultPlan()


def random_plan(n_cores: int, *, seed: int = 0, horizon: int = 64,
                n_core_faults: int = 1, down_epochs: int = 8,
                n_derates: int = 0, derate_factor: float = 0.5,
                derate_epochs: int = 8,
                preemption: str = "resume") -> FaultPlan:
    """Seedable random plan generator (the benchmark's fault-rate knob).

    Draws ``n_core_faults`` down/up pairs (each core offline for
    ``down_epochs``) and ``n_derates`` thermal windows uniformly over
    ``[1, horizon)``, all from ``random.Random(seed)`` -- same seed, same
    plan, on every backend and platform.
    """
    rng = random.Random(seed)
    events = []
    for _ in range(n_core_faults):
        c = rng.randrange(n_cores)
        d = rng.randrange(1, max(2, horizon - down_epochs))
        events.append(core_down(c, d))
        events.append(core_up(c, d + down_epochs))
    for _ in range(n_derates):
        s = rng.randrange(1, max(2, horizon - derate_epochs))
        events.append(bw_derate(derate_factor, s, s + derate_epochs))
    return FaultPlan(tuple(events), preemption=preemption)


def faulted_chip_report(shards, chip, workload_name: str, strategy: str,
                        telemetry=None, phase: str = ""):
    """Closed-batch entry point for plans with core events.

    The closed cluster's all-spans-start-at-0 fixed point cannot express
    preemption/migration, so a closed run whose plan ``needs_online`` is
    driven through :class:`~repro_torch.multicore.online.OnlineChip`: every
    shard is submitted to its core at epoch 0, the chip drains through the
    plan's events, and the outcome is assembled into a normal
    :class:`~repro_torch.multicore.chip.ChipReport` (with per-instance
    ``attribution_rows`` carrying the ``fault_lost`` bucket).
    """
    from ..obs.config import OFF
    from .chip import _single_core_cycles, assemble_online_report
    from .online import OnlineChip

    telemetry = telemetry if telemetry is not None else OFF
    sim = OnlineChip(chip, force_history=True)
    for core, shard in enumerate(shards):
        if shard:
            sim.submit(core, tuple(shard))
    sim.drain()
    specs = [s for shard in shards for s in shard]
    return assemble_online_report(
        sim, chip, workload_name, strategy, shards,
        _single_core_cycles(chip, specs), telemetry, phase=phase)
