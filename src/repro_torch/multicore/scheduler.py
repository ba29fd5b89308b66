"""Multi-GEMM workload scheduling across the chip's cores.

One model layer = one GEMM; a workload is the list of layer GEMMs (e.g.
``repro_torch.core.workloads.TABLE_I`` values or the per-layer traces derived from
``repro_torch.configs``).  The scheduler decides the GEMM -> core placement:

  round_robin -- static: GEMM ``i`` goes to core ``i % n_cores``, blind to
                 cost.  The baseline every dynamic policy must beat.
  work_queue  -- dynamic: GEMMs are pulled from a single queue by whichever
                 core *completes them* first (deterministic work-stealing
                 under the cost model).  Costs are estimated with the
                 unthrottled single-engine simulator (cached), then the
                 final placement is re-simulated under the shared-bandwidth
                 model.
  lpt         -- work_queue with GEMMs sorted longest-first (classic LPT
                 bound); better balance when the workload is skewed but
                 ignores submission order.
  gang        -- lpt that may *split* a GEMM instead of placing it whole:
                 for each GEMM (longest first) it considers every gang
                 width ``w`` in 1..n_cores, shards the GEMM ``w`` ways with
                 :func:`repro_torch.multicore.partition.split_ways`, places the
                 shards on the ``w`` soonest-free cores, and keeps the
                 width with the earliest estimated completion; the split
                 schedule is used only if it beats the whole-GEMM LPT
                 schedule's estimated makespan (splitting re-streams
                 operands, so it must pay for itself).  This is the
                 combined partition x schedule policy: a dominant GEMM
                 that would leave cores idle under whole-GEMM LPT gets
                 gang-split across them.
  gang_refine -- gang followed by malleable-width refinement: the greedy
                 width vector is hill-climbed (grow/shrink one GEMM's gang
                 by a core per round, keep the best improving move) until
                 the estimated makespan stops improving.  Greedy widths
                 are myopic -- chosen against the free-at state at
                 placement time -- so refinement wins when a later GEMM
                 strands an earlier width choice (the pinned skewed-
                 workload case in the tests).

Workload-level scheduling (:func:`scheduled_workload_report`) goes through
:func:`assign_units`: the items are a compiled model's *placement units*
(:meth:`repro_torch.workload.Workload.units`), so a MoE expert's GEMM pair lands
on one core atomically while distinct experts spread across cores --
expert parallelism as a scheduling consequence, not a special case.

All cost estimates are **per (GEMM, core)**: on a heterogeneous chip
(mixed :class:`~repro_torch.multicore.chip.CoreSpec` vector) each candidate
placement is costed on the target core's own design, so the dynamic
schedulers route reuse-friendly (WLBP-favoring) GEMMs to the RASA cores
that finish them first and leave BASE cores the work they are least bad
at.  On a homogeneous chip every estimate is core-independent and the
placements reduce exactly to the classic free-at rules (the tests pin
this).

The first three place each GEMM whole on a single core (layer-level
parallelism); only ``gang`` combines inter- and intra-GEMM parallelism.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

from ..core.simulator import _simulate_cached
from ..core.tiling import GemmSpec
from ..obs.config import OFF, TelemetryConfig
from .chip import (ChipConfig, ChipReport, CoreCluster, _aggregate,
                   _attach_telemetry, _single_core_cycles, _streams_traces)
from .partition import split_ways

SCHEDULERS = ("round_robin", "work_queue", "lpt", "gang", "gang_refine")


def _estimate_cycles(spec: GemmSpec, chip: ChipConfig, core: int = 0) -> float:
    # cost depends only on the dims, but the lru_cache key includes the
    # name -- canonicalize it so equal-dim shards ("x@c0", "x@c1", ...)
    # and repeated layers hit one cache entry instead of re-simulating.
    # Estimates run on the chip's backend: results are backend-independent
    # (see docs/performance.md), so gang's many split_ways probes get the
    # fast path too.  The estimate is per *core*: a mixed chip costs each
    # candidate placement on the target core's own design/policy.
    spec = dataclasses.replace(spec, name="")
    core_spec = chip.core_specs[core]
    return _simulate_cached(spec, core_spec.design, core_spec.policy,
                            chip.backend, chip.device).cycles


def _workload_cycles(spec: GemmSpec, chip: ChipConfig) -> float:
    """Core-independent size of a GEMM: its best-core estimate.

    The LPT/gang orderings need one scalar per GEMM; on a homogeneous chip
    this equals the (only) per-core estimate, on a mixed chip it is the
    cost on the core that runs the GEMM fastest.
    """
    return min(_estimate_cycles(spec, chip, c) for c in range(chip.n_cores))


def assign_round_robin(specs: list[GemmSpec], n_cores: int) -> list[list[GemmSpec]]:
    out: list[list[GemmSpec]] = [[] for _ in range(n_cores)]
    for i, spec in enumerate(specs):
        out[i % n_cores].append(spec)
    return out


def assign_work_queue(specs: list[GemmSpec], n_cores: int, chip: ChipConfig,
                      longest_first: bool = False) -> list[list[GemmSpec]]:
    order = specs
    if longest_first:
        order = sorted(specs, key=lambda s: -_workload_cycles(s, chip))
    out: list[list[GemmSpec]] = [[] for _ in range(n_cores)]
    free_at = [0.0] * n_cores
    for spec in order:
        # earliest *completion*, not earliest free slot: on a mixed chip a
        # busier RASA core can still finish a reuse-friendly GEMM first
        core = min(range(n_cores),
                   key=lambda c: free_at[c] + _estimate_cycles(spec, chip, c))
        out[core].append(spec)
        free_at[core] += _estimate_cycles(spec, chip, core)
    return out


def assign_gang(specs: list[GemmSpec], chip: ChipConfig,
                partition: str = "m_split") -> list[list[GemmSpec]]:
    """LPT with gang splitting: shard GEMMs across soon-free cores when the
    whole-GEMM schedule would leave cores idle under a dominant GEMM.

    Two candidate schedules are built deterministically and the one with
    the smaller estimated makespan wins (ties go to whole-GEMM placement,
    since splitting re-streams operands and so must pay for itself):

    * the plain whole-GEMM LPT schedule;
    * a greedy gang schedule: GEMMs longest-first, each placed at the gang
      width ``w`` in 1..n_cores whose sharded placement (longest shards on
      the soonest-free cores, each shard costed on its target core)
      completes earliest.

    On a balanced workload the greedy splitter serializes gangs and loses,
    so gang placement degenerates to LPT exactly; on a skewed one the
    dominant GEMM is split across the cores LPT would have idled.  With
    ``n_cores == 1`` this is the whole workload, in submission order, on
    core 0 -- the single-core reduction the tests pin down.
    """
    n_cores = chip.n_cores
    if n_cores == 1:
        return [list(specs)]
    est = lambda s, c: _estimate_cycles(s, chip, c)

    whole = assign_work_queue(specs, n_cores, chip, longest_first=True)
    whole_makespan = max(sum(est(s, c) for s in core)
                         for c, core in enumerate(whole))

    order = sorted(specs, key=lambda s: -_workload_cycles(s, chip))
    gang: list[list[GemmSpec]] = [[] for _ in range(n_cores)]
    free_at = [0.0] * n_cores
    for spec in order:
        best: tuple[float, int] | None = None
        best_placement: list[tuple[int, GemmSpec]] = []
        for w in range(1, n_cores + 1):
            shards = split_ways(spec, w, partition)
            if len(shards) < w:
                continue            # more gang slots than tiles at this width
            cores = sorted(range(n_cores), key=lambda c: free_at[c])[:w]
            shards = sorted(shards, key=lambda s: -_workload_cycles(s, chip))
            placement = list(zip(cores, shards))
            completion = max(free_at[c] + est(s, c) for c, s in placement)
            if best is None or (completion, w) < best:
                best = (completion, w)
                best_placement = placement
        for core, shard in best_placement:
            gang[core].append(shard)
            free_at[core] += est(shard, core)
    return gang if max(free_at) < whole_makespan else whole


def assign_incremental(items: Sequence, chip: ChipConfig,
                       free_at: Sequence[float]) -> list[list]:
    """Place *new* work onto already-loaded cores without reshuffling.

    The online form of ``work_queue``: ``free_at[c]`` is core *c*'s current
    busy-until estimate (e.g. :meth:`repro_torch.multicore.online.OnlineChip.
    free_at_estimate`); each item goes, in submission order, to the core
    that *completes* it soonest (its backlog plus the item's unthrottled
    cost on that core's design), and the estimate is advanced accordingly.
    An item is either one :class:`GemmSpec` or a sequence of them that must
    land on a single core as a unit (a serving request's prefill + decode
    chain); items are returned as given, so the caller can map them back.
    Only the per-core *additions* are returned -- the caller owns the
    existing placement.  With ``n_cores == 1`` (and any ``free_at``) this
    is all items, in submission order, on core 0 -- the single-core
    reduction the tests pin down.
    """
    if len(free_at) != chip.n_cores:
        raise ValueError(f"need one free_at entry per core, got "
                         f"{len(free_at)} for {chip.n_cores} cores")
    out: list[list] = [[] for _ in range(chip.n_cores)]
    free = list(free_at)
    for item in items:
        specs = (item,) if isinstance(item, GemmSpec) else tuple(item)
        cost = lambda c: sum(_estimate_cycles(s, chip, c) for s in specs)
        core = min(range(chip.n_cores), key=lambda c: free[c] + cost(c))
        out[core].append(item)
        free[core] += cost(core)
    return out


def _unit_cost(unit: tuple, chip: ChipConfig, core: int) -> float:
    """Cost of placing one atomic unit (a spec tuple) on ``core``."""
    return sum(_estimate_cycles(s, chip, core) for s in unit)


def _unit_size(unit: tuple, chip: ChipConfig) -> float:
    return min(_unit_cost(unit, chip, c) for c in range(chip.n_cores))


def _unit_shards(unit: tuple, w: int, partition: str) -> list[tuple] | None:
    """The gang shards of a unit at width ``w``, each itself a unit.

    Multi-spec units (MoE placement groups) are atomic: only width 1 is
    valid.  Returns ``None`` when the unit cannot occupy exactly ``w``
    cores at this width (more gang slots than tiles, or an atomic group).
    """
    if w == 1:
        return [unit]
    if len(unit) != 1:
        return None
    shards = split_ways(unit[0], w, partition)
    return [(s,) for s in shards] if len(shards) == w else None


def _gang_place(order: list[tuple], widths: list[int], chip: ChipConfig,
                partition: str) -> tuple[list[list[tuple]], list[float]] | None:
    """Replay the deterministic gang placement at fixed per-unit widths.

    Same placement rule as the greedy search (shards longest-first onto
    the soonest-free cores); ``None`` if any width is invalid for its
    unit.  This is the evaluation oracle the refinement hill-climb uses.
    """
    placed: list[list[tuple]] = [[] for _ in range(chip.n_cores)]
    free_at = [0.0] * chip.n_cores
    for unit, w in zip(order, widths):
        shards = _unit_shards(unit, w, partition)
        if shards is None:
            return None
        cores = sorted(range(chip.n_cores), key=lambda c: free_at[c])[:len(shards)]
        shards = sorted(shards, key=lambda u: -_unit_size(u, chip))
        for core, shard in zip(cores, shards):
            placed[core].append(shard)
            free_at[core] += _unit_cost(shard, chip, core)
    return placed, free_at


def _gang_greedy_widths(order: list[tuple], chip: ChipConfig,
                        partition: str) -> list[int]:
    """Per-unit gang widths chosen greedily (earliest estimated completion
    given the placements made so far) -- the width vector ``gang`` commits
    to and ``gang_refine`` starts from."""
    n_cores = chip.n_cores
    free_at = [0.0] * n_cores
    widths: list[int] = []
    for unit in order:
        best: tuple[float, int] | None = None
        best_placement: list[tuple[int, tuple]] = []
        for w in range(1, n_cores + 1):
            shards = _unit_shards(unit, w, partition)
            if shards is None:
                continue
            cores = sorted(range(n_cores), key=lambda c: free_at[c])[:w]
            shards = sorted(shards, key=lambda u: -_unit_size(u, chip))
            placement = list(zip(cores, shards))
            completion = max(free_at[c] + _unit_cost(u, chip, c)
                             for c, u in placement)
            if best is None or (completion, w) < best:
                best = (completion, w)
                best_placement = placement
        widths.append(best[1])
        for core, shard in best_placement:
            free_at[core] += _unit_cost(shard, chip, core)
    return widths


def assign_units(units: Sequence[tuple], chip: ChipConfig,
                 scheduler: str = "work_queue",
                 partition: str = "m_split",
                 refine_rounds: int = 64) -> list[list[GemmSpec]]:
    """Place atomic *units* (spec tuples) on cores; returns per-core specs.

    The unit-level generalization of :func:`assign`: a unit's specs always
    land on one core together (a :meth:`repro_torch.workload.Workload.units` MoE
    placement group, or a singleton GEMM).  The whole-unit schedulers are
    the classic rules on unit costs; ``gang`` may split *singleton* units
    across cores exactly as the flat scheduler does, and ``gang_refine``
    additionally revisits the greedy per-GEMM gang widths after placement:
    a hill-climb shrinks/grows one unit's width (+-1) per round, keeping
    the move that most improves the estimated makespan, until a fixpoint
    (malleable-width gangs; the greedy width choice is myopic -- made
    against the free-at state *at placement time* -- so a later, larger
    unit can strand the width committed for an earlier one).

    Both gang variants keep their schedule only if it beats the whole-unit
    LPT makespan, and fall back to LPT otherwise -- splitting re-streams
    operands, so it must pay for itself.
    """
    units = [tuple(u) for u in units]
    n_cores = chip.n_cores
    if scheduler == "round_robin":
        out: list[list[GemmSpec]] = [[] for _ in range(n_cores)]
        for i, unit in enumerate(units):
            out[i % n_cores].extend(unit)
        return out
    if scheduler in ("work_queue", "lpt"):
        order = units
        if scheduler == "lpt":
            order = sorted(units, key=lambda u: -_unit_size(u, chip))
        out = [[] for _ in range(n_cores)]
        free_at = [0.0] * n_cores
        for unit in order:
            core = min(range(n_cores),
                       key=lambda c: free_at[c] + _unit_cost(unit, chip, c))
            out[core].extend(unit)
            free_at[core] += _unit_cost(unit, chip, core)
        return out
    if scheduler not in ("gang", "gang_refine"):
        raise ValueError(f"unknown scheduler {scheduler!r}; "
                         f"available: {SCHEDULERS}")

    whole = assign_units(units, chip, "lpt")
    whole_makespan = max(
        (sum(_estimate_cycles(s, chip, c) for s in core_specs)
         for c, core_specs in enumerate(whole) if core_specs), default=0.0)
    if n_cores == 1:
        return [[s for u in units for s in u]]

    order = sorted(units, key=lambda u: -_unit_size(u, chip))
    widths = _gang_greedy_widths(order, chip, partition)
    placed, free_at = _gang_place(order, widths, chip, partition)

    if scheduler == "gang_refine":
        best_span = max(free_at)
        for _ in range(refine_rounds):
            move: tuple[float, int, int] | None = None
            for i, w in enumerate(widths):
                for cand in (w - 1, w + 1):
                    if not 1 <= cand <= n_cores:
                        continue
                    trial = widths[:i] + [cand] + widths[i + 1:]
                    res = _gang_place(order, trial, chip, partition)
                    if res is None:
                        continue
                    span = max(res[1])
                    if span < best_span and (move is None or span < move[0]):
                        move = (span, i, cand)
            if move is None:
                break
            best_span, i, cand = move
            widths[i] = cand
        placed, free_at = _gang_place(order, widths, chip, partition)

    if max(free_at) < whole_makespan:
        return [[s for unit in core_units for s in unit]
                for core_units in placed]
    return whole


def assign(specs: list[GemmSpec], chip: ChipConfig,
           scheduler: str = "work_queue",
           partition: str = "m_split") -> list[list[GemmSpec]]:
    if scheduler == "round_robin":
        return assign_round_robin(specs, chip.n_cores)
    if scheduler == "work_queue":
        return assign_work_queue(specs, chip.n_cores, chip)
    if scheduler == "lpt":
        return assign_work_queue(specs, chip.n_cores, chip, longest_first=True)
    if scheduler == "gang":
        return assign_gang(specs, chip, partition)
    if scheduler == "gang_refine":
        return assign_units([(s,) for s in specs], chip, "gang_refine",
                            partition)
    raise ValueError(f"unknown scheduler {scheduler!r}; available: {SCHEDULERS}")


def scheduled_chip_report(specs: list[GemmSpec], chip: ChipConfig,
                          scheduler: str = "work_queue",
                          partition: str = "m_split",
                          telemetry: TelemetryConfig = OFF) -> ChipReport:
    """Place ``specs`` on cores, simulate each core's concatenated stream
    under the shared-bandwidth model, and aggregate chip-level results.

    ``partition`` selects the sharding strategy the ``gang`` scheduler uses
    when it splits a GEMM (ignored by the whole-GEMM schedulers).
    """
    if not specs:
        raise ValueError("empty workload")
    shards = assign(specs, chip, scheduler, partition)
    name = f"{specs[0].name}+{len(specs) - 1}" if len(specs) > 1 else specs[0].name
    if chip.fault_plan is not None and chip.fault_plan.needs_online:
        from .faults import faulted_chip_report
        return faulted_chip_report(shards, chip, name, scheduler, telemetry)
    streams, traces = _streams_traces(chip, shards)
    cluster = CoreCluster(chip)
    results, stalls, trace = cluster.run_streams(streams, traces)
    report = _aggregate(chip, name, scheduler, shards, results, stalls,
                        _single_core_cycles(chip, specs), trace,
                        cluster.core_weights, streams=streams, traces=traces)
    return _attach_telemetry(report, cluster, shards, telemetry)


def scheduled_workload_report(workload, chip: ChipConfig,
                              scheduler: str = "work_queue",
                              partition: str = "m_split",
                              telemetry: TelemetryConfig = OFF) -> ChipReport:
    """Place a compiled :class:`repro_torch.workload.Workload` on the chip.

    Placement respects the workload's atomic units (MoE expert groups land
    whole); the report carries the workload's phase so downstream consumers
    can tell a prefill makespan from a decode one.
    """
    units = workload.units()
    if not units:
        raise ValueError("empty workload")
    shards = assign_units(units, chip, scheduler, partition)
    if chip.fault_plan is not None and chip.fault_plan.needs_online:
        from .faults import faulted_chip_report
        return faulted_chip_report(shards, chip, workload.name, scheduler,
                                   telemetry, phase=workload.phase)
    streams, traces = _streams_traces(chip, shards)
    cluster = CoreCluster(chip)
    results, stalls, trace = cluster.run_streams(streams, traces)
    report = _aggregate(chip, workload.name, scheduler, shards, results,
                        stalls, _single_core_cycles(chip, workload.specs),
                        trace, cluster.core_weights, streams=streams,
                        traces=traces, phase=workload.phase)
    return _attach_telemetry(report, cluster, shards, telemetry)
