"""Stall-cycle attribution: where did every core-cycle go?

Each core's share of the run window (``window`` cycles per core) is
decomposed into six disjoint buckets:

``compute``
    Cycles the systolic array was streaming useful feed rows: the sum of
    ``tm`` over the core's ``rasa_mm`` instructions.  FF windows of
    consecutive MMs never overlap (every design rule chains
    ``ff_start >= p_ff_end``), so this is a true cycle count.
``fill_drain``
    Pipeline overhead cycles: WL/FS/DR stages, load-latency and register
    dependency gaps -- everything a segment spends beyond compute that an
    *unthrottled* run would also spend.
``bw_stall``
    End-to-end cost of bandwidth contention: the segment's throttled
    makespan minus its unthrottled makespan (not the arbiter's raw grant
    delay, which the pipeline may absorb; see
    ``TimingResult.bw_stall_cycles``).
``fault_lost``
    Fault runs only: busy cycles whose progress a preemption discarded --
    the preempted instance's busy interval minus its kept prefix's
    compute credit (see :mod:`repro_torch.multicore.faults`).  Zero on every
    fault-free run.
``queue_wait``
    Online runs only: cycles the core sat idle while work addressed to it
    was waiting in its queue (submitted but not yet started).
``idle``
    The remainder -- the core had nothing to do.

Conservation is exact by construction (``idle`` is the residual) and
non-negativity of ``fill_drain`` is guaranteed: a segment's busy cycles
minus its bandwidth stall equals its unthrottled makespan, which is at
least its total FF feed time (a preempted instance charges everything
past its compute credit to ``fault_lost`` instead).

Counterpart of the JAX package's ``obs/attribution.py``;
``tests/test_torch_obs.py`` holds the two equal on the same runs.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

from ..core.tiling import GemmSpec, RegPolicy
from ..core.trace import OP_MM, compiled_trace


@dataclasses.dataclass(frozen=True)
class CoreAttribution:
    """One core's bucket decomposition; every field is engine cycles."""

    core: int
    compute: float
    fill_drain: float
    bw_stall: float
    queue_wait: float
    idle: float
    #: busy cycles discarded by fault preemption (0 on fault-free runs;
    #: defaulted last so fault-free construction sites stay unchanged)
    fault_lost: float = 0.0

    @property
    def busy(self) -> float:
        return (self.compute + self.fill_drain + self.bw_stall
                + self.fault_lost)

    @property
    def total(self) -> float:
        return self.busy + self.queue_wait + self.idle


#: bucket names in table/export order
BUCKETS = ("compute", "fill_drain", "bw_stall", "fault_lost",
           "queue_wait", "idle")


@dataclasses.dataclass(frozen=True)
class StallAttribution:
    """Chip-level rollup: per-core buckets over a shared window."""

    window: float
    cores: tuple[CoreAttribution, ...]

    def total(self, bucket: str) -> float:
        return sum(getattr(c, bucket) for c in self.cores)

    @property
    def occupied_cycles(self) -> float:
        """window x cores -- what the buckets must sum to."""
        return self.window * len(self.cores)

    def fractions(self) -> dict[str, float]:
        occ = self.occupied_cycles
        if occ <= 0:
            return {b: 0.0 for b in BUCKETS}
        return {b: self.total(b) / occ for b in BUCKETS}

    def table(self) -> str:
        """Plain-text summary table (one row per core + a chip total).

        The ``fault_lost`` column appears only when some core has a
        nonzero entry, keeping fault-free output byte-identical to the
        five-bucket format."""
        buckets = list(BUCKETS)
        if not any(c.fault_lost for c in self.cores):
            buckets.remove("fault_lost")
        labels = {"fill_drain": "fill/drain", "bw_stall": "bw-stall",
                  "queue_wait": "queue-wait", "fault_lost": "fault-lost"}
        head = f"{'core':>6} " + " ".join(
            f"{labels.get(b, b):>12}" for b in buckets)
        lines = [head, "-" * len(head)]
        for c in self.cores:
            lines.append(f"{c.core:>6} " + " ".join(
                f"{getattr(c, b):>12.0f}" for b in buckets))
        fr = self.fractions()
        lines.append(f"{'chip':>6} " + " ".join(
            f"{100 * fr[b]:>11.1f}%" for b in buckets))
        return "\n".join(lines)


def workload_compute_cycles(specs: Sequence[GemmSpec],
                            policy: RegPolicy) -> float:
    """Sum of FF feed cycles (``tm``) of the lowered workload."""
    tr = compiled_trace(tuple(specs), policy)
    return float(tr.tm[tr.opcode == OP_MM].sum())


def _merge(intervals: Iterable[tuple[float, float]]
           ) -> list[tuple[float, float]]:
    out: list[tuple[float, float]] = []
    for s, e in sorted(i for i in intervals if i[1] > i[0]):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def _measure_minus(wait: list[tuple[float, float]],
                   busy: list[tuple[float, float]]) -> float:
    """Total length of (union of wait) minus (union of busy)."""
    total = 0.0
    busy = _merge(busy)
    for s, e in _merge(wait):
        cut = s
        for bs, be in busy:
            if be <= cut:
                continue
            if bs >= e:
                break
            if bs > cut:
                total += bs - cut
            cut = max(cut, be)
            if cut >= e:
                break
        if cut < e:
            total += e - cut
    return total


def attribute_segments(
        n_cores: int, window: float,
        segments: Sequence[tuple],
) -> StallAttribution:
    """Fold per-segment facts into per-core buckets.

    ``segments`` rows are ``(core, submit, start, finish, compute,
    bw_stall)`` with an optional seventh ``fault_lost`` element -- times
    on the shared chip clock, ``compute``/``bw_stall``/``fault_lost`` in
    cycles.  ``queue_wait`` is the measure of the union of each core's
    ``[submit, start)`` intervals minus its busy intervals, so overlapping
    waiters are not double counted and waiting behind a running segment
    counts as that segment's busy time, not queue-wait.
    """
    per: list[list[tuple]] = [[] for _ in range(n_cores)]
    for row in segments:
        per[row[0]].append(row)
    cores = []
    for core in range(n_cores):
        rows = per[core]
        busy = sum(r[3] - r[2] for r in rows)
        compute = sum(r[4] for r in rows)
        bw = sum(r[5] for r in rows)
        lost = sum(r[6] for r in rows if len(r) > 6)
        fill_drain = busy - compute - bw - lost
        busy_iv = [(r[2], r[3]) for r in rows]
        wait_iv = [(r[1], min(r[2], window)) for r in rows]
        queue_wait = _measure_minus(wait_iv, busy_iv)
        idle = window - busy - queue_wait
        cores.append(CoreAttribution(core, compute, fill_drain, bw,
                                     queue_wait, idle, fault_lost=lost))
    return StallAttribution(window=window, cores=tuple(cores))


def simreport_attribution(specs: Sequence[GemmSpec], policy: RegPolicy,
                          cycles: float, bw_stall: float = 0.0
                          ) -> StallAttribution:
    """Single-engine decomposition of one simulated workload.

    The window is the run's own makespan, so ``idle`` is zero and the
    split is {compute, fill_drain, bw_stall} -- the form the design-search
    harness prints per candidate.
    """
    compute = workload_compute_cycles(specs, policy)
    return StallAttribution(
        window=cycles,
        cores=(CoreAttribution(0, compute, cycles - compute - bw_stall,
                               bw_stall, 0.0, 0.0),))
