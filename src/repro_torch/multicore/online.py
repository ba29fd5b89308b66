"""Open-arrival (online) chip simulation: work arrives and departs at
epoch boundaries while the chip is mid-run.

The closed-batch model (:class:`repro_torch.multicore.chip.CoreCluster`) fixes
every core's stream up front and relaxes one share schedule over it.  The
serving question -- how many concurrent requests does the shared memory
system sustain? -- needs the *open* form: requests are injected while other
cores are mid-flight, and a request that drains returns its bandwidth to
the survivors.  :class:`OnlineChip` provides exactly that, as a **thin
incremental client** of the unified span arbiter
(:class:`repro_torch.multicore.arbiter.SpanArbiter` -- the same fixed point the
closed batch uses, with staggered span starts):

* A **segment** (one or more :class:`~repro_torch.core.tiling.GemmSpec` lowered
  back to back -- e.g. one serving request's prefill GEMM plus its decode
  micro-GEMMs) is submitted to a core's FIFO queue at the current epoch.
* A core **starts** its next queued segment at the first epoch boundary at
  which it is free.  Engine and LSQ/bucket state are fresh per segment:
  the chip hands work to cores at scheduling-epoch granularity, and the
  engine synchronizes between requests (different requests share no tile
  registers).  On a heterogeneous chip each segment runs on its core's
  own :class:`~repro_torch.multicore.chip.CoreSpec` engine.
* **Bandwidth** is arbitrated by the span fixed point: epoch *e*'s share
  is recomputed over the segments active in *e* (weighted by the chip's
  ``share_policy``), so arrivals shrink the survivors' shares and
  departures return them.
* **Causality** makes the whole construction incremental: a segment's
  timing depends only on shares in epochs it overlaps, so an event at
  epoch *t* (arrival or start) can change shares only from *t* on --
  everything that finished before *t* is a settled fact.  Arrivals mark
  every in-flight segment dirty and the relaxation re-runs for the dirty
  set alone; the arbiter's **settled-prefix cache** keeps the share
  schedule below ``dirty_from`` verbatim, and segments whose span closed
  at or before the clock are *retired* -- pruned out of the relaxation
  set entirely, their contribution living on in the cached prefix.  This
  is what makes thousand-request serving traces tractable: per-settle
  work scales with the in-flight segments, not the whole history
  (``prefix_cache=False`` keeps the rebuild-from-epoch-0 baseline for
  ``benchmarks/online_scaling.py``).

Backends follow the chip model's contract: ``backend="reference"`` is the
oracle (each re-simulation replays the full stream through
:class:`~repro_torch.core.timing.PipelineSimulator`); ``backend="fast"`` /
``"numpy"`` run the trace-compiled numpy recurrence and *resume* each
re-simulation from the latest :class:`~repro_torch.core.fastsim.SimCarry`
snapshot taken before the first epoch whose share changed, instead of
replaying the prefix.  ``backend="cuda"`` (the default) and ``"torch"``
batch instead of resuming: each relaxation round hands *all* of its dirty
segments to one :func:`~repro_torch.core.fastsim.run_cores` call (grouped
by engine config and bucket shape, so heterogeneous chips and
``slow_core``-dilated lanes split into their own lanes automatically) --
one launch of the scan kernel per round (``cuda``), or its plain version
on ``ChipConfig.device`` (``torch``), in place of one Python token-bucket
replay per segment.  These are the JAX package's ``backend="jax"`` lane.
Results are backend-independent and bit-exact with numpy
(``tests/test_torch_batcher.py`` pins BatchReport equality end to end).

The serving batcher (:mod:`repro_torch.serving.simbatch`) drives this model:
admission policies query :meth:`OnlineChip.core_busy` /
:meth:`OnlineChip.live_share` / :meth:`OnlineChip.free_at_estimate` at
every decision epoch and inject admitted requests with
:meth:`OnlineChip.submit`.

:mod:`repro_torch.multicore.jitarb` mirrors this entire client -- event loop,
admission decisions, demand-weighted shares, heterogeneous lanes,
settled-prefix window -- as ONE kernel launch (``csrc/jitarb.cu``) on
fault-free chips, bit-identical on its domain (``Plan``-gated; the
incremental client here remains the oracle and the fallback).
"""

from __future__ import annotations

import copy
import dataclasses
import math
from collections import deque
from typing import Sequence

from ..core.fastsim import (SNAP_STRIDE, SimCarry, completed_prefix,
                            run_cores, run_segment)
from ..core.tiling import GemmSpec
from ..core.timing import PipelineSimulator, TimingResult
from ..core.trace import (OP_MM, OP_TL, OP_TS, CompiledTrace, compile_stream,
                          compiled_trace, slice_trace)
from ..obs.config import OFF, TelemetryConfig
from .arbiter import Span, SpanArbiter
from .chip import (ChipConfig, _lower_many, demands_bandwidth,
                   shared_traffic_bytes, stream_model_params)


@dataclasses.dataclass(eq=False)
class Segment:
    """One unit of scheduled work on one core (handle; identity-hashed).

    The segment's activity on the shared budget is its :attr:`span`
    (created when the core picks the segment up); :attr:`start` and
    :attr:`end` expose the span's absolute epochs -- the boundary at which
    the segment started, and the first epoch in which it no longer draws
    on the budget (``None`` while queued / unsettled).
    """

    sid: int
    core: int
    specs: tuple[GemmSpec, ...]
    submit_epoch: int
    demands: bool = True
    weight: float = 1.0
    span: Span | None = dataclasses.field(default=None, repr=False)
    # -- cached simulation state (managed by OnlineChip) --
    stream: tuple | None = dataclasses.field(default=None, repr=False)
    trace: CompiledTrace | None = dataclasses.field(default=None, repr=False)
    result: TimingResult | None = dataclasses.field(default=None, repr=False)
    _snaps: list[SimCarry] = dataclasses.field(default_factory=list,
                                               repr=False)
    # -- fault-injection state (see repro_torch.multicore.faults) --
    #: core speed factor sampled at the start boundary (slow_core events)
    speed: float = 1.0
    #: instruction offset of this instance within the originally submitted
    #: stream (> 0 for a resumed preemption remainder)
    resume_from: int = 0
    #: sid of the preempted instance this segment resumes, if any
    origin_sid: int | None = None
    #: absolute cycles at which this instance was preempted (core_down)
    preempted_at: float | None = None
    #: instructions whose progress survived the preemption (the remainder
    #: resumes after them; 0 under preemption="restart" / migration across
    #: heterogeneous designs)
    kept_instrs: int = 0
    #: chip-cycle FF compute / useful MACs of the kept prefix -- the
    #: telemetry attribution of the preempted instance (fault_lost bucket
    #: absorbs the rest of its busy interval)
    kept_compute: float = 0.0
    kept_macs: float = 0.0

    @property
    def start(self) -> int | None:
        return self.span.start if self.span is not None else None

    @property
    def end(self) -> int | None:
        return self.span.end if self.span is not None else None

    @property
    def macs(self) -> int:
        return sum(s.macs for s in self.specs)


def _first_change(old: tuple, new: tuple) -> int | None:
    """First local epoch at which two visible schedules differ.

    A visible schedule is ``(share_prefix, tail_share)``.  Returns None
    when they are effectively identical; otherwise the earliest epoch any
    arithmetic could diverge -- conservative about prefix-length changes
    (the scheduled-vs-tail code paths are mathematically equal but not
    bit-identical, so a length change dirties everything past the shorter
    prefix).
    """
    (s1, t1), (s2, t2) = old, new
    n = min(len(s1), len(s2))
    for k in range(n):
        if s1[k] != s2[k]:
            return k
    if len(s1) != len(s2) or t1 != t2:
        return n
    return None


class OnlineChip:
    """Event-driven open-arrival chip simulation (see module docs).

    The driver advances time explicitly: :meth:`submit` enqueues work at
    the current epoch, :meth:`advance_to` moves the clock (starting queued
    segments at every intermediate boundary where a core frees up), and
    :meth:`next_event` reports the next epoch at which the chip's state
    changes on its own.  All query methods settle the arbiter fixed point
    lazily first, so observed shares/finish times are always converged.
    """

    def __init__(self, chip: ChipConfig, snap_stride: int = SNAP_STRIDE,
                 prefix_cache: bool = True,
                 telemetry: TelemetryConfig = OFF,
                 force_history: bool = False):
        if chip.arbitration != "epoch":
            raise ValueError("the online model is the epoch arbiter's "
                             "open-arrival form; use arbitration='epoch'")
        chip.require_card()
        if snap_stride < 1:
            raise ValueError("snap_stride must be >= 1")
        self.chip = chip
        self.snap_stride = snap_stride
        #: observability opt-in; when enabled, started segments are kept in
        #: :attr:`history` with their lowered stream / compiled trace so the
        #: telemetry builders can replay them after the run.
        self.telemetry = telemetry
        #: keep :attr:`history` even without telemetry -- the closed-batch
        #: fault router (:func:`repro_torch.multicore.faults.faulted_chip_report`)
        #: assembles its report from the per-segment outcomes post-hoc
        self._keep_history = telemetry.enabled or force_history
        #: every started segment, in start order -- populated only when
        #: history is kept (retirement stays free-to-prune otherwise)
        self.history: list[Segment] = []
        self.epoch = 0
        self._E = chip.epoch_cycles
        self._budget = chip.bw_bytes_per_cycle
        self._ref = chip.backend == "reference"
        #: device lanes: settle rounds batch all dirty segments into one
        #: scan (``_simulate_batch``) instead of per-segment
        #: snapshot-resumed numpy replays.  Bit-exact with numpy.
        self._batched = chip.backend in ("cuda", "torch")
        #: the fault plan driving core_down/up preemption, budget derating
        #: and slow cores; ``None`` when faults are off (the common case:
        #: every fault hook below is gated on it, so an empty plan is
        #: arithmetic-identical to no plan at all)
        plan = chip.fault_plan
        self._plan = plan if plan is not None and not plan.is_empty else None
        self._fault_events = list(self._plan.core_events) if self._plan \
            else []
        self._next_fault = 0
        self._down = [False] * chip.n_cores
        #: (epoch, label) log of applied core events (telemetry markers)
        self.fault_log: list[tuple[int, str]] = []
        self.n_preempted = 0
        self.n_migrated = 0
        #: chip cycles of discarded progress across all preemptions
        self.fault_lost_cycles = 0.0
        #: preempted sid -> the instance that resumed it; holds retired
        #: resume instances strongly so :meth:`final_instance` works after
        #: pruning (empty on fault-free runs)
        self._resume_of: dict[int, Segment] = {}
        #: the unified relaxation engine; ``prefix_cache=False`` keeps the
        #: rebuild-from-epoch-0 baseline (and disables span pruning, which
        #: depends on the settled prefix carrying retired contributions)
        self._arb = SpanArbiter(self._budget, self._E, chip.share_policy,
                                unthrottled_skip=not self._ref,
                                prefix_cache=prefix_cache,
                                budget_factors=self._plan.budget_factors()
                                if self._plan else ())
        self._prune = prefix_cache
        self._queues: list[deque[Segment]] = [deque()
                                              for _ in range(chip.n_cores)]
        #: started, non-retired segments -- the arbiter's relaxation set
        self._active: list[Segment] = []
        #: aggregates over retired (pruned) segments
        self._retired_makespan = 0.0
        self._core_retired_epoch = [0] * chip.n_cores
        self._core_retired_cycles = [0.0] * chip.n_cores
        self.n_retired = 0
        self._next_sid = 0
        self._dirty = False
        self._dirty_from = math.inf     # earliest epoch whose share moved
        #: instrumentation: arbiter settles/rounds and how the fast path
        #: re-simulated (full replays vs. snapshot resumes vs. pure skips).
        self.stats = {"settles": 0, "rounds": 0, "sims_full": 0,
                      "sims_resumed": 0, "instrs_resumed_past": 0,
                      "preempt_replay_instrs": 0}

    # ------------------------------------------------------------ driver
    def submit(self, core: int, specs: Sequence[GemmSpec]) -> Segment:
        """Enqueue a segment on ``core`` at the current epoch.

        The segment starts at the first epoch boundary >= now at which the
        core is free (immediately, if it is free now).
        """
        seg = self._enqueue(core, specs)
        self._pump(self.epoch)
        return seg

    def submit_batch(self, assignments: Sequence[tuple[int, Sequence[GemmSpec]]]
                     ) -> list[Segment]:
        """Enqueue several segments at the current epoch, then start them
        together: one arbiter relaxation for the whole admission batch
        instead of one per :meth:`submit` (the batcher's hot path)."""
        segs = [self._enqueue(core, specs) for core, specs in assignments]
        self._pump(self.epoch)
        return segs

    def _enqueue(self, core: int, specs: Sequence[GemmSpec]) -> Segment:
        specs = tuple(specs)
        if not specs:
            raise ValueError("empty segment")
        if not 0 <= core < self.chip.n_cores:
            raise ValueError(f"core {core} out of range")
        if self._down[core]:
            # submissions blind to the fault state (e.g. a fixed
            # round-robin batcher) are rerouted to the best surviving core;
            # with every core down the work waits for a core_up
            self._settle()
            alt = self._pick_target()
            if alt is not None and alt != core:
                core = alt
                self.n_migrated += 1
        seg = Segment(self._next_sid, core, specs, self.epoch)
        self._next_sid += 1
        core_spec = self.chip.core_specs[core]
        if self._ref:
            seg.stream = tuple(_lower_many(specs, core_spec.policy))
        else:
            seg.trace = compiled_trace(
                tuple(dataclasses.replace(s, name="") for s in specs),
                core_spec.policy)
        seg.demands = demands_bandwidth(self.chip, seg.stream, seg.trace)
        if seg.demands and self.chip.share_policy.needs_demand:
            seg.weight = self.chip.share_policy.weight(self._demand_of(seg))
        self._queues[core].append(seg)
        return seg

    def _demand_of(self, seg: Segment) -> float:
        """Unthrottled bytes/cycle of a segment (the demand policy's
        weight input) -- one extra unthrottled probe per admission."""
        engine = self.chip.core_specs[seg.core].engine
        params = stream_model_params(self.chip, engine)
        if self._ref:
            res = PipelineSimulator(engine,
                                    load_model=params.make_model()) \
                .run(seg.stream)
        else:
            res, _, _ = run_segment(seg.trace, engine, params)
        traffic = shared_traffic_bytes(self.chip, seg.stream, seg.trace)
        return traffic / res.cycles if res.cycles else 0.0

    def advance_to(self, epoch: int) -> None:
        """Move the clock to ``epoch``, starting queued segments at every
        intermediate boundary where their core frees up (in causal order)."""
        if epoch < self.epoch:
            raise ValueError(f"cannot rewind from {self.epoch} to {epoch}")
        self._pump(epoch)
        self.epoch = epoch
        self._retire()

    def next_event(self) -> int | None:
        """Earliest epoch > now at which the chip changes on its own: a
        queued segment starts, or a busy core finishes its started work."""
        self._pump(self.epoch)
        self._settle()
        cands = []
        for c in range(self.chip.n_cores):
            if self._down[c]:
                # nothing can start here until a core_up (which is itself
                # a candidate below); queued work on a fully-down chip
                # must not busy-loop the driver
                continue
            f = self._core_free_epoch(c)
            if self._queues[c]:
                f = max(f, self._queues[c][0].submit_epoch)
            if f > self.epoch:
                cands.append(f)
        if self._next_fault < len(self._fault_events):
            # pending core events change the chip's state on their own
            # (preemption, migration, a downed queue waking up)
            cands.append(self._fault_events[self._next_fault].epoch)
        return min(cands, default=None)

    def drain(self) -> None:
        """Advance until every queue is empty and all work has retired."""
        while True:
            e = self.next_event()
            if e is None:
                return
            self.advance_to(e)

    # ----------------------------------------------- live chip state
    def core_busy(self) -> list[bool]:
        """Is each core occupied (running or queued work) right now?
        Downed cores read as busy -- they cannot take work."""
        self._settle()
        return [self._down[c] or self._core_free_epoch(c) > self.epoch
                or bool(self._queues[c]) for c in range(self.chip.n_cores)]

    def n_active(self) -> int:
        """Segments drawing on the shared budget in the current epoch."""
        self._settle()
        return sum(1 for s in self._active
                   if s.demands and s.start <= self.epoch
                   and (s.end is None or s.end > self.epoch))

    def live_share(self) -> float:
        """Bytes/cycle each active segment is granted in the current epoch
        (under equal shares; the weighted mean share otherwise)."""
        return self._budget / max(1, self.n_active())

    def free_at_estimate(self) -> list[float]:
        """Per-core busy-until estimate (absolute cycles): the settled
        finish of started work plus unthrottled cost estimates of queued
        segments -- the ``free_at`` vector incremental placement wants.
        Queued estimates are costed on each core's own design (mixed
        chips)."""
        from .scheduler import _estimate_cycles
        self._settle()
        now = self.epoch * self._E
        out = []
        for c in range(self.chip.n_cores):
            if self._down[c]:
                out.append(math.inf)
                continue
            t = max((self._finish(s) for s in self._active if s.core == c),
                    default=0.0)
            t = max(t, self._core_retired_cycles[c], now)
            for seg in self._queues[c]:
                t += sum(_estimate_cycles(s, self.chip, c)
                         for s in seg.specs)
            out.append(t)
        return out

    # ----------------------------------------------------- results
    def finish_time(self, seg: Segment) -> float:
        """Absolute retire time (cycles) of a started segment."""
        self._settle()
        if seg.span is None or seg.result is None:
            raise RuntimeError(f"segment {seg.sid} has not started")
        return self._finish(seg)

    def resume_of(self, seg: Segment) -> Segment | None:
        """The instance that resumed ``seg`` after its preemption (None
        for a segment that was never preempted)."""
        return self._resume_of.get(seg.sid)

    def final_instance(self, seg: Segment) -> Segment:
        """Follow preemption-resume chains to the instance that carries
        the logical work submitted as ``seg`` to completion.  Identity on
        fault-free runs; the serving batcher resolves request finish
        times through this."""
        while seg.preempted_at is not None:
            seg = self._resume_of[seg.sid]
        return seg

    @property
    def down_cores(self) -> tuple[bool, ...]:
        """Per-core offline flags under the fault plan (all False without
        one) -- the ``degraded`` admission policy's health signal."""
        return tuple(self._down)

    @property
    def makespan(self) -> float:
        """Latest settled retire time over all started segments."""
        self._settle()
        live = max((self._finish(s) for s in self._active), default=0.0)
        return max(live, self._retired_makespan)

    @property
    def share_trace(self) -> tuple[float, ...]:
        """Converged bytes/cycle per unit weight, per epoch (equal shares:
        the bytes/cycle each active segment receives)."""
        self._settle()
        return self._arb.share_trace

    @property
    def active_trace(self) -> tuple[int, ...]:
        self._settle()
        return self._arb.active_trace

    # --------------------------------------------------- internals
    def _finish(self, seg: Segment) -> float:
        return seg.span.start * self._E + seg.result.cycles

    def _core_free_epoch(self, c: int) -> int:
        """First epoch boundary at which core ``c``'s started work is done
        (requires settled state)."""
        e = self._core_retired_epoch[c]
        for s in self._active:
            if s.core == c:
                e = max(e, s.span.start,
                        math.ceil(self._finish(s) / self._E))
        return e

    def _pump(self, upto: int) -> None:
        """Start queued segments at every boundary <= ``upto`` where their
        core is free, earliest boundary first (ties by core index): a start
        at epoch *b* only changes shares in epochs >= *b*, so processing in
        nondecreasing *b* keeps every earlier decision a settled fact.

        All queue heads sharing the minimal boundary start in one pass
        before re-settling -- same-boundary starts are independent (no
        core's free epoch <= *b* can move on a share change at >= *b*),
        and one relaxation per boundary beats one per segment.
        """
        while True:
            self._settle()
            fault_at = None
            if self._next_fault < len(self._fault_events):
                e = self._fault_events[self._next_fault].epoch
                if e <= upto:
                    fault_at = e
            cands: list[tuple[int, int]] = []
            for c in range(self.chip.n_cores):
                if self._down[c] or not self._queues[c]:
                    continue
                b = max(self._core_free_epoch(c),
                        self._queues[c][0].submit_epoch)
                if b <= upto:
                    cands.append((b, c))
            if fault_at is not None and (
                    not cands or fault_at <= min(b for b, _ in cands)):
                # fault events apply at the boundary *before* any start
                # there: a core_down preempts first, a core_up makes the
                # core a start candidate on the next sweep
                self._process_faults(fault_at)
                continue
            if not cands:
                return
            b_min = min(b for b, _ in cands)
            for b, c in sorted(cands):
                if b != b_min:
                    continue
                seg = self._queues[c].popleft()
                if self._plan is not None:
                    seg.speed = self._plan.speed_factor(c, b_min)
                seg.span = Span(start=b_min,
                                end=None if seg.demands else b_min,
                                demands=seg.demands, weight=seg.weight)
                self._active.append(seg)
                if self._keep_history:
                    self.history.append(seg)
                if seg.demands:
                    self._mark_dirty(b_min)
                else:
                    # zero shared-memory traffic: shares cannot change,
                    # only the new segment itself needs simulating
                    self._dirty = True

    def _process_faults(self, epoch: int) -> None:
        """Apply every core_down/core_up event scheduled at ``epoch``
        (in plan order; the caller guarantees settled state)."""
        while (self._next_fault < len(self._fault_events)
               and self._fault_events[self._next_fault].epoch == epoch):
            ev = self._fault_events[self._next_fault]
            self._next_fault += 1
            self.fault_log.append((epoch, ev.label))
            if ev.kind == "core_down":
                self._core_down(ev.core, epoch)
            else:
                self._down[ev.core] = False

    def _core_down(self, core: int, epoch: int) -> None:
        """Take ``core`` offline: preempt its in-flight segment at this
        boundary and migrate its queue to the surviving cores."""
        self._down[core] = True
        T = epoch * self._E
        changed = False
        for seg in list(self._active):
            if (seg.core == core and seg.preempted_at is None
                    and self._finish(seg) > T):
                changed |= self._preempt(seg, epoch)
        q = self._queues[core]
        if q:
            moved = list(q)
            q.clear()
            for seg in moved:
                self._migrate_queued(seg)
        if changed:
            self._mark_dirty(epoch)

    def _pick_target(self) -> int | None:
        """The best surviving core for displaced work: earliest free, then
        shortest queue, then lowest index (deterministic).  None when every
        core is down."""
        best_key = best = None
        for c in range(self.chip.n_cores):
            if self._down[c]:
                continue
            key = (self._core_free_epoch(c), len(self._queues[c]), c)
            if best_key is None or key < best_key:
                best_key, best = key, c
        return best

    def _preempt(self, seg: Segment, epoch: int) -> bool:
        """Cut a running segment at the ``epoch`` boundary (its core went
        down) and requeue the remainder on the best surviving core.

        The cut is the deterministic :func:`completed_prefix` replay of
        the segment's settled visible schedule: instructions fully retired
        by the boundary survive, rounded down to the ``SimCarry`` snapshot
        stride under ``preemption="resume"`` (state is recovered from the
        latest checkpoint, not from the dying core's registers) or
        discarded entirely under ``"restart"``.  Migration to a different
        core design always restarts -- pipeline state cannot cross
        engines.  Returns True when the preempted span's activity shrank
        (the caller re-relaxes from ``epoch``).
        """
        span = seg.span
        engine = self.chip.core_specs[seg.core].engine
        T = epoch * self._E
        f = seg.speed
        prefix, tail = span._vis if span._vis is not None \
            else ((), math.inf)
        if f != 1.0:
            params = stream_model_params(self.chip, engine,
                                         tuple(s / f for s in prefix),
                                         self._E * f, tail / f)
        else:
            params = stream_model_params(self.chip, engine, prefix,
                                         self._E, tail)
        trace = seg.trace if seg.trace is not None \
            else compile_stream(seg.stream)
        limit = (T - span.start * self._E) * f
        # resume the cut replay from the segment's latest checkpoint whose
        # completions all land at or before the boundary (recorded under
        # the same settled schedule ``params`` was built from) -- repeated
        # preemptions then replay only the work past the last snapshot
        # instead of the whole segment history each time
        cut_carry = None
        for c in seg._snaps:
            if c.t_end <= limit and (cut_carry is None
                                     or c.i > cut_carry.i):
                cut_carry = c
        n_done = completed_prefix(trace, engine, params, limit,
                                  carry=cut_carry)
        self.stats["preempt_replay_instrs"] += \
            n_done - (cut_carry.i if cut_carry else 0)
        target = self._pick_target()
        if target is None:
            target = seg.core        # all cores down: wait for a core_up
        same_design = (self.chip.core_specs[target]
                       == self.chip.core_specs[seg.core])
        keep = 0
        if self._plan.preemption == "resume" and same_design:
            keep = (n_done // self.snap_stride) * self.snap_stride

        # the preempted instance: busy from its start to the boundary,
        # credited with the kept prefix's compute/MACs; the rest of its
        # busy interval is lost work (the fault_lost attribution bucket)
        op = trace.opcode[:keep]
        kept_macs = float(trace.macs[:keep].sum())
        kept_compute = float(trace.tm[:keep].sum()) / f
        busy = T - span.start * self._E
        seg.result = TimingResult(
            cycles=busy, n_mm=int((op == OP_MM).sum()),
            n_tl=int((op == OP_TL).sum()), n_ts=int((op == OP_TS).sum()),
            wl_skips=int(trace.reusable[:keep].sum()) if engine.wlbp else 0,
            useful_macs=kept_macs,
            peak_macs_per_cycle=engine.peak_macs_per_cycle,
            bw_stall_cycles=0.0, schedules=None)
        seg.preempted_at = T
        seg.kept_instrs = keep
        seg.kept_compute = kept_compute
        seg.kept_macs = kept_macs
        self.n_preempted += 1
        self.fault_lost_cycles += busy - kept_compute

        # the remainder: a fresh segment submitted at the fault boundary
        new = Segment(self._next_sid, target, seg.specs, epoch)
        self._next_sid += 1
        new.origin_sid = seg.sid
        new.resume_from = seg.resume_from + keep
        if same_design:
            if keep:
                if self._ref:
                    new.stream = seg.stream[keep:]
                else:
                    new.trace = slice_trace(seg.trace, keep)
            else:
                new.stream = seg.stream
                new.trace = seg.trace
        else:
            policy = self.chip.core_specs[target].policy
            if self._ref:
                new.stream = tuple(_lower_many(seg.specs, policy))
            else:
                new.trace = compiled_trace(
                    tuple(dataclasses.replace(s, name="")
                          for s in seg.specs), policy)
        new.demands = demands_bandwidth(self.chip, new.stream, new.trace)
        if new.demands and self.chip.share_policy.needs_demand:
            new.weight = self.chip.share_policy.weight(self._demand_of(new))
        self._queues[target].append(new)
        self._resume_of[seg.sid] = new
        if target != seg.core:
            self.n_migrated += 1

        # freeze the preempted span at the boundary.  last_grant is pinned
        # so the arbiter's convergence recompute (start + last_grant//E + 1)
        # lands exactly back on the truncated end -- the span is a settled
        # fact from here on and is never re-simulated.
        if span.end is None or span.end > epoch:
            span.end = epoch
            span.last_grant = max(0.0, (epoch - span.start - 1) * self._E)
            return seg.demands
        return False

    def _migrate_queued(self, seg: Segment) -> None:
        """Move a queued (not yet started) segment off a downed core."""
        target = self._pick_target()
        if target is None or target == seg.core:
            # every core down: leave it queued until a core_up
            self._queues[seg.core].append(seg)
            return
        if (self.chip.core_specs[target]
                != self.chip.core_specs[seg.core]):
            # different design: the queued lowering is invalid there
            policy = self.chip.core_specs[target].policy
            if self._ref:
                seg.stream = tuple(_lower_many(seg.specs, policy))
                seg.trace = None
            else:
                seg.trace = compiled_trace(
                    tuple(dataclasses.replace(s, name="")
                          for s in seg.specs), policy)
                seg.stream = None
            seg.core = target
            seg.demands = demands_bandwidth(self.chip, seg.stream,
                                            seg.trace)
            seg.weight = 1.0
            if seg.demands and self.chip.share_policy.needs_demand:
                seg.weight = self.chip.share_policy.weight(
                    self._demand_of(seg))
        else:
            seg.core = target
        self._queues[target].append(seg)
        self.n_migrated += 1

    def _retire(self) -> None:
        """Prune segments that are facts out of the relaxation set.

        Events only ever occur at epochs >= ``self.epoch`` (``_pump``
        processes intermediate boundaries before the clock moves), so a
        segment whose activity span closed at or before now can never be
        marked dirty again: its result stands, its contribution to the
        share schedule lives on in the arbiter's settled prefix, and its
        snapshots, lowered stream/trace reference and span bookkeeping are
        dead weight over a long serving run.  Per-core/chip maxima are
        folded into scalar aggregates so queries stay O(in-flight).

        With ``prefix_cache=False`` (the benchmark baseline) nothing is
        pruned: the rebuild-from-0 arbiter re-derives every epoch from the
        full span set, so every span must stay in it.
        """
        if not self._prune:
            return
        keep: list[Segment] = []
        for s in self._active:
            if s.end is None or s.end > self.epoch:
                keep.append(s)
                continue
            f = self._finish(s)
            c = s.core
            self._retired_makespan = max(self._retired_makespan, f)
            self._core_retired_cycles[c] = max(self._core_retired_cycles[c],
                                               f)
            self._core_retired_epoch[c] = max(
                self._core_retired_epoch[c], s.span.start,
                math.ceil(f / self._E))
            self.n_retired += 1
            s._snaps = []
            if not self._keep_history:
                # telemetry replays retired segments post-hoc, so the
                # lowered stream / compiled trace must survive retirement
                s.stream = s.trace = None
        self._active = keep

    def _mark_dirty(self, from_epoch: int) -> None:
        """An event at ``from_epoch`` invalidates every segment still
        active there: back to 'active indefinitely' for the relaxation."""
        self._dirty = True
        self._dirty_from = min(self._dirty_from, from_epoch)
        for s in self._active:
            if s.demands and (s.end is None or s.end > from_epoch):
                s.span.end = None

    def _settle(self) -> None:
        """Relax the share schedule to its fixed point (the thin client).

        All relaxation logic -- schedule building, skip rules, monotone
        convergence, the settled-prefix cache -- lives in
        :class:`SpanArbiter`; this method only maps spans back to segments
        and runs their (resumable) re-simulations.
        """
        if not self._dirty:
            return
        self.stats["settles"] += 1
        segs = self._active
        spans = [s.span for s in segs]
        if math.isinf(self._dirty_from):
            # no share moved (non-demanding starts only): keep the whole
            # settled schedule, just simulate the new segments
            dirty_from = self._arb.settled_horizon
        else:
            dirty_from = int(self._dirty_from)

        if self._batched:
            def simulate(jobs):
                self._simulate_batch(segs, jobs)
        else:
            def simulate(jobs):
                for i, prefix, tail in jobs:
                    self._simulate(segs[i], (prefix, tail))

        # The settle is transactional: if relax (or a simulate callback)
        # raises, the arbiter's rebuilt suffix and every span/segment it
        # touched are restored, and the dirty marker survives -- so a
        # retry sees exactly the pre-settle state instead of a half
        # rebuilt schedule disagreeing with a cleared marker.
        arb = self._arb
        d0 = dirty_from if arb.prefix_cache else 0
        saved_w, saved_n = arb._wsum[d0:], arb._nact[d0:]
        saved_stamp = arb._stamp
        saved = [(s.span.end, s.span.last_grant, s.span.throttled,
                  s.span._vis, s.span._stamp, s.result, s._snaps)
                 for s in segs]
        try:
            trace = arb.relax(spans, simulate, dirty_from=dirty_from,
                              collect_trace=False)
        except BaseException:
            del arb._wsum[d0:]
            arb._wsum.extend(saved_w)
            del arb._nact[d0:]
            arb._nact.extend(saved_n)
            arb._stamp = saved_stamp
            for s, (end, lg, th, vis, stamp, res, snaps) in zip(segs, saved):
                s.span.end = end
                s.span.last_grant = lg
                s.span.throttled = th
                s.span._vis = vis
                s.span._stamp = stamp
                s.result = res
                s._snaps = snaps
            raise
        self.stats["rounds"] += trace.rounds
        self._dirty = False
        self._dirty_from = math.inf

    def _simulate(self, seg: Segment, vis: tuple) -> None:
        """(Re-)simulate one segment under its visible schedule.

        The reference oracle replays the full stream; the fast path
        resumes from the latest snapshot whose horizon precedes the first
        changed epoch (snapshots before it stay valid, ones after it are
        discarded and re-recorded).  ``seg.span._vis`` still holds the
        *previous* visible schedule here -- the arbiter updates it only
        after the simulation batch returns.

        A slowed core (``slow_core`` fault) is simulated in its own
        dilated time base: chip epoch ``E`` spans ``E * speed`` local
        engine cycles, so the visible chip-cycle schedule maps to local
        shares ``s / speed`` over local epochs ``E * speed``, and the
        local results map back by ``1 / speed``.  Exact: the recurrence is
        positively homogeneous in the time unit.
        """
        if seg.preempted_at is not None:
            # a preempted instance's truncated result is a settled fact
            # (its span can never rejoin the relaxation)
            return
        prefix, tail = vis
        engine = self.chip.core_specs[seg.core].engine
        f = seg.speed
        if f != 1.0:
            params = stream_model_params(self.chip, engine,
                                         tuple(s / f for s in prefix),
                                         self._E * f, tail / f)
        else:
            params = stream_model_params(self.chip, engine, prefix,
                                         self._E, tail)
        if self._ref:
            model = params.make_model()
            res = PipelineSimulator(engine,
                                    load_model=model).run(seg.stream)
            last_grant = model.last_grant
            self.stats["sims_full"] += 1
        else:
            carry = None
            old_vis = seg.span._vis
            if old_vis is not None and seg._snaps:
                x = _first_change(old_vis, vis)
                if x is not None:
                    boundary = x * self._E * f if f != 1.0 else x * self._E
                    for c in seg._snaps:
                        if c.horizon <= boundary:
                            carry = c
                        else:
                            break
            res, last_grant, snaps = run_segment(
                seg.trace, engine, params, carry=carry,
                snap_stride=self.snap_stride)
            if carry is None:
                seg._snaps = snaps
                self.stats["sims_full"] += 1
            else:
                # snaps now leads with the carry-in itself (the boundary
                # snapshot), so keep strictly-earlier checkpoints only
                seg._snaps = [c for c in seg._snaps
                              if c.i < carry.i] + snaps
                self.stats["sims_resumed"] += 1
                self.stats["instrs_resumed_past"] += carry.i
        if f != 1.0:
            res = dataclasses.replace(
                res, cycles=res.cycles / f,
                bw_stall_cycles=res.bw_stall_cycles / f)
            last_grant = last_grant / f
        seg.result = res
        seg.span.last_grant = last_grant
        seg.span.throttled = res.bw_stall_cycles != 0.0

    def _simulate_batch(self, segs: list[Segment], jobs) -> None:
        """One relaxation round's re-simulations as a single batched call.

        The device lane of :meth:`_settle`: every dirty bucket-throttled
        segment in the round becomes one lane of a :func:`run_cores`
        scan.  ``run_cores`` groups lanes by engine config and bucket
        shape, so heterogeneous chips and slow-core dilated time bases
        (``E * speed`` epochs) land in their own launches without
        special-casing here.  Lanes whose visible schedule reduces to the
        unthrottled port model -- the non-demanding segments, each
        simulated exactly once -- keep the host path: they cannot amortize
        a separate launch.

        Snapshot checkpoints are not recorded on this path (the batch
        re-simulates from scratch every round, which is exactly what the
        scan is fast at); a later preemption of a device-simulated
        segment falls back to the full ``completed_prefix`` replay.
        """
        batch: list[tuple[Segment, object, object, float]] = []
        for i, prefix, tail in jobs:
            seg = segs[i]
            if seg.preempted_at is not None:
                # settled fact, same as the host path
                continue
            engine = self.chip.core_specs[seg.core].engine
            f = seg.speed
            if f != 1.0:
                params = stream_model_params(self.chip, engine,
                                             tuple(s / f for s in prefix),
                                             self._E * f, tail / f)
            else:
                params = stream_model_params(self.chip, engine, prefix,
                                             self._E, tail)
            if params.is_port_model:
                self._simulate(seg, (prefix, tail))
                continue
            batch.append((seg, engine, params, f))
        if not batch:
            return
        out = run_cores([seg.trace for seg, _, _, _ in batch],
                        [engine for _, engine, _, _ in batch],
                        [params for _, _, params, _ in batch],
                        backend=self.chip.backend, device=self.chip.device)
        for (seg, _, _, f), (res, last_grant) in zip(batch, out):
            if f != 1.0:
                res = dataclasses.replace(
                    res, cycles=res.cycles / f,
                    bw_stall_cycles=res.bw_stall_cycles / f)
                last_grant = last_grant / f
            seg.result = res
            seg.span.last_grant = last_grant
            seg.span.throttled = res.bw_stall_cycles != 0.0
            seg._snaps = []
            self.stats["sims_full"] += 1

    # ------------------------------------------------ checkpoint/resume
    def snapshot(self) -> "OnlineSnapshot":
        """Checkpoint the complete simulation state (see
        :class:`OnlineSnapshot`).

        The arbiter is settled first, so the captured state is a fixed
        point: dirty flags need not be stored, and a restored chip resumes
        with exactly the settled prefix, span ends, ``SimCarry`` snapshot
        lists and fault bookkeeping of the original -- continuing a
        restored run is bit-identical to never having checkpointed
        (pinned by ``tests/test_faults.py``).  The snapshot owns deep
        copies of all mutable state (further simulation on ``self`` cannot
        corrupt it) and shares the immutable heavyweights (compiled
        traces, lowered streams, results, carries).
        """
        self._pump(self.epoch)
        self._settle()
        state = dict(
            epoch=self.epoch,
            queues=[list(q) for q in self._queues],
            active=list(self._active),
            history=list(self.history),
            retired_makespan=self._retired_makespan,
            core_retired_epoch=list(self._core_retired_epoch),
            core_retired_cycles=list(self._core_retired_cycles),
            n_retired=self.n_retired,
            next_sid=self._next_sid,
            stats=dict(self.stats),
            wsum=list(self._arb._wsum),
            nact=list(self._arb._nact),
            stamp=self._arb._stamp,
            rounds_total=self._arb.rounds_total,
            next_fault=self._next_fault,
            resume_of=dict(self._resume_of),
            down=list(self._down),
            fault_log=list(self.fault_log),
            n_preempted=self.n_preempted,
            n_migrated=self.n_migrated,
            fault_lost_cycles=self.fault_lost_cycles,
        )
        return OnlineSnapshot(self.chip, self.snap_stride, self._prune,
                              self.telemetry, self._keep_history,
                              _copy_state(state))

    @classmethod
    def restore(cls, snap: "OnlineSnapshot") -> "OnlineChip":
        """Rebuild a chip from a checkpoint (the snapshot stays usable:
        restoring twice yields two independent simulations)."""
        sim = cls(snap.chip, snap.snap_stride, snap.prefix_cache,
                  snap.telemetry, force_history=snap.force_history)
        st = _copy_state(snap.state)
        sim.epoch = st["epoch"]
        sim._queues = [deque(q) for q in st["queues"]]
        sim._active = st["active"]
        sim.history = st["history"]
        sim._retired_makespan = st["retired_makespan"]
        sim._core_retired_epoch = st["core_retired_epoch"]
        sim._core_retired_cycles = st["core_retired_cycles"]
        sim.n_retired = st["n_retired"]
        sim._next_sid = st["next_sid"]
        sim.stats = st["stats"]
        sim._arb._wsum = st["wsum"]
        sim._arb._nact = st["nact"]
        sim._arb._stamp = st["stamp"]
        sim._arb.rounds_total = st["rounds_total"]
        sim._next_fault = st["next_fault"]
        sim._resume_of = st["resume_of"]
        sim._down = st["down"]
        sim.fault_log = st["fault_log"]
        sim.n_preempted = st["n_preempted"]
        sim.n_migrated = st["n_migrated"]
        sim.fault_lost_cycles = st["fault_lost_cycles"]
        return sim


@dataclasses.dataclass(frozen=True)
class OnlineSnapshot:
    """A picklable checkpoint of an :class:`OnlineChip` mid-run.

    Produced by :meth:`OnlineChip.snapshot`, consumed by
    :meth:`OnlineChip.restore`.  ``state`` holds deep copies of the
    mutable simulation state (segments, spans, queues, the arbiter's
    settled prefix, fault bookkeeping) with immutable members shared;
    everything inside is plain dataclasses / numpy arrays, so the whole
    object round-trips through ``pickle`` for on-disk checkpoints of
    long serving runs (``benchmarks/online_scaling.py --resume``).
    """

    chip: ChipConfig
    snap_stride: int
    prefix_cache: bool
    telemetry: TelemetryConfig
    force_history: bool
    state: dict


def _copy_state(state: dict) -> dict:
    """Deep-copy a snapshot state dict in one pass (preserving the
    aliasing between ``active``/``history``/queues and their spans) while
    sharing the immutable heavyweights: compiled traces, lowered streams,
    specs, results and ``SimCarry`` checkpoints are seeded into the memo
    so ``deepcopy`` reuses them instead of duplicating megabytes of
    arrays."""
    memo: dict = {}

    def pin(obj) -> None:
        if obj is not None:
            memo[id(obj)] = obj

    segs: set[Segment] = set(state["active"])
    segs.update(state["history"])
    segs.update(state["resume_of"].values())
    for q in state["queues"]:
        segs.update(q)
    for seg in segs:
        pin(seg.specs)
        pin(seg.stream)
        pin(seg.trace)
        pin(seg.result)
        for c in seg._snaps:
            pin(c)
    return copy.deepcopy(state, memo)
