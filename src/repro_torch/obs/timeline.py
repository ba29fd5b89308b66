"""Chip-level telemetry assembly.

Counterpart of the JAX package's ``obs/timeline.py``.  Builders take a
*finished* run -- the closed-batch
:class:`~repro_torch.multicore.chip.CoreCluster` or an
:class:`~repro_torch.multicore.online.OnlineChip` -- and assemble one
:class:`ChipTelemetry`: a :class:`SegmentTimeline` per (core, segment)
with start/finish on the shared chip clock, the bucket attribution, and
the arbiter's per-epoch share/occupancy traces.

Everything here is post-hoc.  The per-segment replay uses the exact
visible schedule each segment was last simulated under (the arbiter's
``Span._vis``, which the skip rules keep bit-faithful to the final
simulation), so stage events reproduce the run rather than a
re-derivation of it.  End-to-end bandwidth stalls are measured the way
``CoreCluster._contention_stalls`` defines them -- throttled makespan
minus unthrottled makespan -- and only segments whose arbiter actually
delayed an access are re-simulated.

Both run on the chip's backend, each in one batched call: the stage
replays of a run through :func:`repro_torch.obs.record.replay_many` (the
event-recording kernel on ``cuda``), the unthrottled counterfactuals of an
online run through :func:`repro_torch.core.fastsim.run_cores`.  Either gives
the numbers the reference's per-segment numpy replays give.

Imports from :mod:`repro_torch.multicore` stay inside functions: the chip
modules import :mod:`repro_torch.obs.config` at module level, so this
module must not import them back at module level.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Sequence

from ..core.trace import OP_MM, CompiledTrace, compile_stream
from .attribution import StallAttribution, attribute_segments
from .config import OFF, TelemetryConfig
from .record import StreamEvents, lane_backend, replay_many


@dataclasses.dataclass(frozen=True, eq=False)
class SegmentTimeline:
    """One scheduled unit of work, placed on the shared chip clock."""

    sid: int
    name: str
    core: int
    submit_time: float          # entered the queue (== start for closed)
    start_time: float           # core picked it up
    finish_time: float          # last event retired
    busy_cycles: float          # finish - start
    compute_cycles: float       # sum of FF feed rows (tm)
    #: end-to-end contention cost: throttled minus unthrottled makespan
    bw_stall_cycles: float
    #: raw arbiter grant delay (the pipeline may absorb it)
    arb_delay_cycles: float
    n_mm: int
    n_tl: int
    n_ts: int
    wl_skips: int
    #: per-instruction events (only with ``TelemetryConfig.stages``)
    events: StreamEvents | None = None
    #: busy cycles discarded by fault preemption -- nonzero only on the
    #: preempted instance of a segment cut by a ``core_down`` event
    fault_lost_cycles: float = 0.0

    @property
    def queue_cycles(self) -> float:
        return self.start_time - self.submit_time


@dataclasses.dataclass(frozen=True, eq=False)
class ChipTelemetry:
    """A finished run's full timeline (identity-hashed, not compared)."""

    kind: str                   # "closed" | "online"
    design: str
    n_cores: int
    epoch_cycles: float
    window: float               # run window on the chip clock
    segments: tuple[SegmentTimeline, ...]
    share_trace: tuple[float, ...]
    active_trace: tuple[int, ...]
    core_weights: tuple[float, ...]
    #: labeled instants (arrivals, admissions) for the exporters
    marks: tuple[tuple[float, str], ...]
    attribution: StallAttribution
    config: TelemetryConfig


def _trace_of(segment_trace: CompiledTrace | None,
              stream) -> CompiledTrace:
    if segment_trace is not None:
        return segment_trace
    if stream is None:
        raise ValueError("segment retained neither a compiled trace nor "
                         "an instruction stream -- was the run made with "
                         "telemetry enabled?")
    return compile_stream(stream)


def _compute_cycles(trace: CompiledTrace) -> float:
    return float(trace.tm[trace.opcode == OP_MM].sum())


def _check_replay(events: StreamEvents, cycles: float, what: str) -> None:
    if not math.isclose(events.cycles, cycles, rel_tol=1e-6, abs_tol=1e-6):
        raise RuntimeError(
            f"telemetry replay diverged from the run on {what}: "
            f"{events.cycles} != {cycles} -- the retained schedule does "
            f"not match the one the run used")


def _attribution_rows(segments: Sequence[SegmentTimeline]):
    return [(s.core, s.submit_time, s.start_time, s.finish_time,
             s.compute_cycles, s.bw_stall_cycles, s.fault_lost_cycles)
            for s in segments]


def build_chip_telemetry(cluster, shards, report,
                         tcfg: TelemetryConfig = OFF) -> ChipTelemetry:
    """Assemble telemetry for a finished closed-batch cluster run.

    ``cluster`` must have run (``CoreCluster.run_streams`` records the
    results, end-to-end stalls and the settled per-core stream-model
    parameters); ``shards``/``report`` are the partition and the
    aggregate the entry point already built.  With ``tcfg.stages`` every
    core's stage events come from one :func:`replay_many` call on the
    chip's backend.
    """
    chip = cluster.chip
    traces = []
    for i, res in enumerate(cluster.last_results):
        traces.append(_trace_of(
            cluster.last_traces[i] if cluster.last_traces else None,
            cluster.last_streams[i] if cluster.last_streams else None)
            if res.n_mm else None)
    staged = [i for i, t in enumerate(traces) if tcfg.stages and t is not None]
    replayed = dict(zip(staged, replay_many(
        [traces[i] for i in staged],
        [chip.core_specs[i].engine for i in staged],
        [cluster.last_params[i] for i in staged],
        backend=chip.backend, device=chip.device)))
    segments = []
    for i, res in enumerate(cluster.last_results):
        name = "+".join(report.per_core_gemms[i]) \
            if i < len(report.per_core_gemms) else f"core{i}"
        trace = traces[i]
        compute = _compute_cycles(trace) if trace is not None else 0.0
        events = replayed.get(i)
        if events is not None:
            _check_replay(events, res.cycles, f"core {i}")
        segments.append(SegmentTimeline(
            sid=i, name=name or f"core{i}", core=i,
            submit_time=0.0, start_time=0.0, finish_time=res.cycles,
            busy_cycles=res.cycles, compute_cycles=compute,
            bw_stall_cycles=cluster.last_stalls[i],
            arb_delay_cycles=res.bw_stall_cycles,
            n_mm=res.n_mm, n_tl=res.n_tl, n_ts=res.n_ts,
            wl_skips=res.wl_skips, events=events))
    segs = tuple(segments)
    return ChipTelemetry(
        kind="closed", design=report.design, n_cores=chip.n_cores,
        epoch_cycles=report.epoch_cycles, window=report.cycles,
        segments=segs, share_trace=report.share_trace,
        active_trace=report.active_trace,
        core_weights=report.core_weights, marks=(),
        attribution=attribute_segments(chip.n_cores, report.cycles,
                                       _attribution_rows(segs)),
        config=tcfg)


def build_online_telemetry(online, tcfg: TelemetryConfig = OFF,
                           names: Mapping[int, str] | None = None,
                           marks: Sequence[tuple[float, str]] = ()
                           ) -> ChipTelemetry:
    """Assemble telemetry for a finished :class:`OnlineChip` run.

    The chip must have been constructed with ``telemetry`` enabled (so
    retired segments keep their traces) and be drained.  ``names`` maps
    segment sid -> display name (the serving batcher passes request
    names); ``marks`` are labeled instants (cycles, label).  The
    unthrottled counterfactuals of the throttled segments are one
    :func:`run_cores` call and the stage replays one :func:`replay_many`
    call, both on the chip's backend.
    """
    from ..core.fastsim import run_cores
    from ..multicore.chip import stream_model_params

    chip = online.chip
    E = chip.epoch_cycles
    names = names or {}
    # keyed by the trace *object* (identity-hashed): keying by id() would
    # let a freed trace's address be reused by a later compile_stream and
    # alias two different segments onto one cache entry
    unthrottled: dict[tuple[CompiledTrace, str], int] = {}
    base_lanes: list[tuple[CompiledTrace, object]] = []
    stage_lanes: list[tuple[CompiledTrace, object, object]] = []
    rows = []       # (seg, name, trace or None, stage lane or None)
    for seg in online.history:
        if seg.result is None or seg.span is None:
            continue            # never started (undrained run)
        engine = chip.core_specs[seg.core].engine
        name = names.get(seg.sid, "+".join(s.name for s in seg.specs
                                           if s.name) or f"seg{seg.sid}")
        if seg.preempted_at is not None:
            # a preempted instance: no unthrottled counterfactual or stage
            # replay exists for the cut -- its remainder is a later
            # instance of its own
            rows.append((seg, name, None, None))
            continue
        trace = _trace_of(seg.trace, seg.stream)
        if seg.result.bw_stall_cycles != 0.0:
            key = (trace, engine.name)
            if key not in unthrottled:
                unthrottled[key] = len(base_lanes)
                base_lanes.append((trace, engine))
        lane = None
        if tcfg.stages and seg.speed == 1.0:
            # slowed cores run in a dilated local time base the replay
            # does not model; their timelines carry no stage events
            vis = seg.span._vis
            prefix, tail = vis if vis is not None else ((), math.inf)
            lane = len(stage_lanes)
            stage_lanes.append((trace, engine,
                                stream_model_params(chip, engine, prefix, E, tail)))
        rows.append((seg, name, trace, lane))
    base = [r.cycles for r, _ in run_cores(
        [t for t, _ in base_lanes], [e for _, e in base_lanes],
        [stream_model_params(chip, e) for _, e in base_lanes],
        backend=lane_backend(chip.backend), device=chip.device)]
    replayed = replay_many([t for t, _, _ in stage_lanes],
                           [e for _, e, _ in stage_lanes],
                           [p for _, _, p in stage_lanes],
                           backend=chip.backend, device=chip.device)
    segments = []
    for seg, name, trace, lane in rows:
        engine = chip.core_specs[seg.core].engine
        busy = seg.result.cycles
        start = seg.span.start * E
        if trace is None:
            # a preempted instance: busy to the fault boundary, credited
            # with its kept prefix; the rest of the interval is lost work
            segments.append(SegmentTimeline(
                sid=seg.sid, name=f"{name} (preempted)", core=seg.core,
                submit_time=seg.submit_epoch * E, start_time=start,
                finish_time=start + busy, busy_cycles=busy,
                compute_cycles=seg.kept_compute, bw_stall_cycles=0.0,
                arb_delay_cycles=0.0, n_mm=seg.result.n_mm,
                n_tl=seg.result.n_tl, n_ts=seg.result.n_ts,
                wl_skips=seg.result.wl_skips, events=None,
                fault_lost_cycles=max(0.0, busy - seg.kept_compute)))
            continue
        compute = _compute_cycles(trace) / seg.speed
        arb_delay = seg.result.bw_stall_cycles
        bw_stall = 0.0
        if arb_delay != 0.0:
            b = base[unthrottled[(trace, engine.name)]]
            # clamp: cross-backend rounding must not push fill/drain
            # negative (reference results vs. the numpy baseline)
            bw_stall = min(max(0.0, busy - b / seg.speed),
                           max(0.0, busy - compute))
        events = None
        if lane is not None:
            events = replayed[lane]
            _check_replay(events, busy, f"segment {seg.sid}")
        segments.append(SegmentTimeline(
            sid=seg.sid, name=name,
            core=seg.core, submit_time=seg.submit_epoch * E,
            start_time=start, finish_time=start + busy,
            busy_cycles=busy, compute_cycles=compute,
            bw_stall_cycles=bw_stall, arb_delay_cycles=arb_delay,
            n_mm=seg.result.n_mm, n_tl=seg.result.n_tl,
            n_ts=seg.result.n_ts, wl_skips=seg.result.wl_skips,
            events=events))
    segs = tuple(sorted(segments, key=lambda s: (s.core, s.start_time)))
    window = max((s.finish_time for s in segs), default=0.0)
    fault_marks = tuple((ep * E, label) for ep, label in online.fault_log)
    return ChipTelemetry(
        kind="online", design=chip.design_name, n_cores=chip.n_cores,
        epoch_cycles=E, window=window, segments=segs,
        share_trace=online.share_trace, active_trace=online.active_trace,
        core_weights=(1.0,) * chip.n_cores,
        marks=tuple(sorted(tuple(marks) + fault_marks)),
        attribution=attribute_segments(chip.n_cores, window,
                                       _attribution_rows(segs)),
        config=tcfg)
