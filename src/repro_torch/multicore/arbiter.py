"""Unified span-based bandwidth arbitration: one fixed-point core.

The chip-scale analogue of RASA's fill/drain overlap is the epoch
bandwidth arbiter: time is sliced into scheduling epochs, every consumer
still drawing on the shared budget gets a share, and a consumer that
drains early returns its share to the survivors.  Two clients need that
relaxation -- the closed-batch :class:`repro_torch.multicore.chip.CoreCluster`
(every core's stream fixed up front) and the open-arrival
:class:`repro_torch.multicore.online.OnlineChip` (work arrives and departs at
epoch boundaries mid-run) -- and both are expressed here as the *same*
monotone fixed point over generic activity **spans** ``[start_epoch,
end_epoch)``: the closed batch is the special case "all spans start at
epoch 0", the online model staggers the starts.  This module is the single
implementation; neither client carries its own relaxation loop.

How the fixed point works
-------------------------
Each :class:`Span` is one consumer of the shared budget.  A relaxation
round (:meth:`SpanArbiter.relax`) builds the per-epoch share schedule from
the current spans, asks the client to (re-)simulate every span whose
*visible* schedule changed, reads back the epoch of each span's last
granted access, and shrinks the span's end to it.  Shrinking spans only
ever *raise* later epochs' shares, shares pointwise-raised only move
grants earlier, so the ends decrease monotonically until the fixed point
(typically 2-4 rounds, capped at :data:`MAX_ARBITER_ROUNDS`).

Three skip rules keep the relaxation cheap.  The closed-batch client runs
its reference backend fully skip-free (``oracle=True``) to validate them;
the online client's reference backend disables only the unthrottled skip
(``unthrottled_skip=False``) and keeps the two deterministically-safe
rules -- its oracle property is instead pinned by the prefix-cache on/off
identity and closed-vs-online equivalence suites:

* **visible-schedule skip** -- a span only observes its share prefix plus
  its tail; results are deterministic in that visible schedule, so a span
  whose visible schedule did not change since its last simulation is not
  re-simulated (counted per round in :attr:`ArbiterTrace.skipped`).
* **unthrottled skip** -- a span the arbiter never delayed runs
  identically under any pointwise-larger schedule; within one relaxation
  rounds only raise shares, so its result is final.
* **settled-fact skip** -- events at epoch ``t`` move shares only in
  epochs ``>= t``, so a span that drained at or before ``dirty_from`` can
  never change again (the open-arrival client's causality argument).

Prefix caching
--------------
The arbiter keeps the per-epoch active-weight sums persistently.  A
relaxation with ``dirty_from = d`` recomputes the schedule only from
epoch ``d`` on -- everything below ``d`` is a settled fact (**invariant**:
no event at epoch ``>= d`` can move a share in an epoch ``< d``, and no
span's end ever shrinks below ``d`` during the relaxation, because shares
below ``d`` are exactly what they were when those grants settled).  This,
plus the clients pruning retired spans out of the span list, is what makes
thousand-request online traces tractable: per-settle work scales with the
*active* spans and the dirty suffix, not with the whole history.
``prefix_cache=False`` keeps the rebuild-from-epoch-0 behavior as the
benchmark baseline (``benchmarks/online_scaling.py``).

Share policies
--------------
Epoch shares are weighted: span *i* active in epoch *e* is granted
``budget * w_i / W(e)`` bytes/cycle, where ``W(e)`` sums the active spans'
weights -- so per-epoch grants always sum to exactly the budget
(conservation by construction).  The :class:`SharePolicy` maps a span's
measured demand to its weight:

* ``equal`` -- every span weighs 1: the classic ``budget / n_active(e)``
  equal split.
* ``demand`` -- weight proportional to the span's unthrottled bytes/cycle
  demand: bandwidth-hungry consumers get more, nearly-compute-bound ones
  stop hoarding share their token bucket would never spend.

Policies plug into :class:`~repro_torch.multicore.chip.ChipConfig` via
``share_policy`` and land once, here, for both clients.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Sequence

#: relaxation-round cap; the monotone iteration converges in a handful of
#: rounds, this only guards pathological streams.
MAX_ARBITER_ROUNDS = 32


# --------------------------------------------------------------------------
# share policies
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SharePolicy:
    """Maps a span's measured demand to its arbitration weight.

    Span *i*'s share in epoch *e* is ``budget * w_i / W(e)`` over the
    active spans' weight sum ``W(e)``; the weights are fixed per span for
    the whole relaxation (a weight that moved with the schedule would
    break the monotonicity argument).  The base class is the equal-share
    policy: every span weighs 1.
    """

    name: str = "equal"

    #: does this policy need the client to measure per-span demand
    #: (unthrottled bytes/cycle)?  Equal shares do not, so clients skip
    #: the extra unthrottled probe entirely.
    needs_demand: bool = False

    def weight(self, demand: float) -> float:
        return 1.0


@dataclasses.dataclass(frozen=True)
class DemandWeightedShare(SharePolicy):
    """Weights proportional to unthrottled bytes/cycle demand.

    ``floor`` keeps every active span schedulable (a zero weight would
    starve a span that still has traffic); demands below it are clamped.
    Because shares are normalized by the active weight sum, per-epoch
    grants still sum to exactly the budget -- the conservation property is
    policy-independent.
    """

    name: str = "demand"
    needs_demand: bool = True
    floor: float = 1e-3

    def weight(self, demand: float) -> float:
        return max(float(demand), self.floor)


SHARE_POLICIES = ("equal", "demand")


def get_share_policy(policy: "str | SharePolicy") -> SharePolicy:
    """Resolve a policy name (see :data:`SHARE_POLICIES`) or instance."""
    if isinstance(policy, SharePolicy):
        return policy
    if policy == "equal":
        return SharePolicy()
    if policy == "demand":
        return DemandWeightedShare()
    raise ValueError(f"unknown share policy {policy!r}; "
                     f"available: {SHARE_POLICIES}")


# --------------------------------------------------------------------------
# spans and the relaxation trace
# --------------------------------------------------------------------------

@dataclasses.dataclass(eq=False)
class Span:
    """One consumer's activity on the shared budget (identity-hashed).

    ``start``/``end`` are absolute epochs bounding the half-open interval
    during which the consumer draws on the budget; ``end=None`` means
    "active indefinitely" -- the relaxation's opening assumption for any
    span whose drain epoch is not yet known.  ``last_grant`` and
    ``throttled`` are written by the client's simulation callback:
    ``last_grant`` is the start time of the consumer's last granted
    access in cycles *local to its start boundary* (the closed batch
    starts at epoch 0, so local == absolute there).
    """

    start: int
    end: int | None = None
    demands: bool = True
    weight: float = 1.0
    last_grant: float = 0.0
    throttled: bool = True
    _vis: tuple | None = dataclasses.field(default=None, repr=False)
    _stamp: int = dataclasses.field(default=-1, repr=False)


@dataclasses.dataclass(frozen=True)
class ArbiterTrace:
    """Per-epoch outcome of one arbitration fixed point."""

    epoch_cycles: float
    #: bytes/cycle granted per unit weight, per epoch.  Under the equal
    #: policy every active consumer weighs 1, so this is exactly the
    #: bytes/cycle each active consumer receives (``budget / n_active``);
    #: under weighted policies consumer *i* receives ``shares[e] * w_i``.
    shares: tuple[float, ...]
    #: number of consumers still drawing on the budget, per epoch
    n_active: tuple[int, ...]
    #: relaxation rounds until the activity spans converged
    rounds: int
    #: per relaxation round, how many spans were *not* re-simulated
    #: because one of the skip rules applied (see module docs); the
    #: skip-free oracle records zeros.
    skipped: tuple[int, ...] = ()


#: the client's simulation callback: for each ``(span_index, share_prefix,
#: tail_share)`` job, simulate that span's consumer under the visible
#: schedule (``share_prefix`` is local to the span's start boundary) and
#: write ``spans[i].last_grant`` / ``spans[i].throttled``.
SimulateFn = Callable[[Sequence[tuple[int, tuple, float]]], None]


# --------------------------------------------------------------------------
# the engine
# --------------------------------------------------------------------------

class SpanArbiter:
    """The monotone fixed-point relaxation over activity spans.

    One instance per arbitration context: the closed-batch cluster builds
    a fresh one per ``run_streams`` call, the online chip keeps one for
    the lifetime of the run (its settled-prefix cache is the scalability
    mechanism).  ``oracle=True`` disables the visible-schedule and
    unthrottled skips so the reference backend stays a literal,
    skip-free oracle the fast paths are validated against.
    """

    def __init__(self, budget: float, epoch_cycles: float,
                 policy: "str | SharePolicy" = "equal", *,
                 oracle: bool = False, unthrottled_skip: bool = True,
                 prefix_cache: bool = True,
                 max_rounds: int = MAX_ARBITER_ROUNDS,
                 budget_factors: Sequence[float] = ()):
        if not budget > 0:
            raise ValueError("budget must be > 0")
        if not epoch_cycles > 0:
            raise ValueError("epoch_cycles must be > 0")
        self.budget = budget
        self.epoch_cycles = epoch_cycles
        self.policy = get_share_policy(policy)
        #: per-epoch budget multipliers (thermal/bandwidth derating);
        #: epoch ``e`` distributes ``budget * budget_factors[e]`` among its
        #: active spans, epochs beyond the array run at the full budget.
        #: Trailing 1.0s are trimmed so a no-op plan is exactly ().
        fac = tuple(float(f) for f in budget_factors)
        while fac and fac[-1] == 1.0:
            fac = fac[:-1]
        if any(not (0.0 < f <= 1.0) for f in fac):
            raise ValueError("budget_factors must all be in (0, 1]: a zero "
                             "or negative epoch budget would starve the "
                             "token bucket")
        self.budget_factors = fac
        self.oracle = oracle
        #: the unthrottled skip may be disabled on its own (the online
        #: reference backend keeps the always-safe visible-schedule skip
        #: but re-simulates throttled spans every round)
        self.unthrottled_skip = unthrottled_skip
        self.prefix_cache = prefix_cache
        self.max_rounds = max_rounds
        #: settled per-epoch active-weight sums / active counts (the
        #: prefix cache; epochs below the last relax's ``dirty_from``
        #: are never recomputed)
        self._wsum: list[float] = []
        self._nact: list[int] = []
        self._stamp = 0
        #: cumulative relaxation rounds across relax() calls
        self.rounds_total = 0

    # -- schedule state ----------------------------------------------------
    @property
    def share_trace(self) -> tuple[float, ...]:
        """Converged bytes/cycle per unit weight, per epoch.

        Epochs with no active demanding span report ``0.0``: nothing is
        flowing, so rendering the full budget there (as the pre-fix code
        did) painted fully-idle epochs as fully-shared in
        ``ChipReport.share_trace`` and the Perfetto counter tracks.
        """
        b = self.budget
        fac = self.budget_factors
        if not fac:
            return tuple(b / w if w else 0.0 for w in self._wsum)
        nf = len(fac)
        return tuple((b * fac[e] if e < nf else b) / w if w else 0.0
                     for e, w in enumerate(self._wsum))

    @property
    def active_trace(self) -> tuple[int, ...]:
        return tuple(self._nact)

    @property
    def settled_horizon(self) -> int:
        """Number of epochs the settled schedule covers.  Relaxing with
        ``dirty_from`` at this horizon keeps the whole cached prefix -- the
        no-share-moved case (e.g. a zero-traffic arrival)."""
        return len(self._wsum)

    def _rebuild(self, spans: Sequence[Span], d: int) -> None:
        """Recompute the weight/active arrays for epochs >= ``d``.

        Difference-array sweep over the spans overlapping ``[d, horizon)``;
        the prefix below ``d`` is kept verbatim (see module docs for why
        it can never change).  ``end=None`` spans fill through the horizon
        -- beyond it they run at their tail share.

        With ``prefix_cache=False`` this is instead the literal
        pre-refactor rebuild -- every epoch re-derived from every span,
        from epoch 0, every round -- kept as the measured baseline of
        ``benchmarks/online_scaling.py`` (same values, quadratically more
        work on long traces).

        Measured-weight policies (``needs_demand``) always use the fresh
        per-epoch fold, in span-list order, even with the prefix cache on:
        the difference-array running sum accumulates float weights in
        span-*event* order with ``+w``/``-w`` cancellations, which is not
        bit-reproducible by any fixed-order reduction (and therefore not
        by the whole-trace program, ``repro_torch.multicore.jitarb``).
        The fold keeps ``prefix_cache`` on/off and whole-trace/incremental
        all bit-identical; equal shares keep the O(spans + width) sweep (unit
        weights make the running sum exact in any order).
        """
        horizon = d
        for s in spans:
            if s.demands and s.end is not None and s.end > horizon:
                horizon = s.end

        def fold(lo: int, hi: int) -> None:
            for e in range(lo, hi):
                w, n = 0.0, 0
                for s in spans:
                    if s.demands and s.start <= e and (s.end is None
                                                       or s.end > e):
                        w += s.weight
                        n += 1
                self._wsum.append(w)
                self._nact.append(n)

        if not self.prefix_cache:
            self._wsum, self._nact = [], []
            fold(0, horizon)
            return
        if self.policy.needs_demand:
            del self._wsum[d:]
            del self._nact[d:]
            while len(self._wsum) < d:
                self._wsum.append(0.0)
                self._nact.append(0)
            fold(d, horizon)
            return
        width = horizon - d
        dw = [0.0] * (width + 1)
        dn = [0] * (width + 1)
        for s in spans:
            if not s.demands:
                continue
            lo = max(s.start, d)
            hi = horizon if s.end is None else s.end
            if hi <= lo:
                continue
            dw[lo - d] += s.weight
            dw[hi - d] -= s.weight
            dn[lo - d] += 1
            dn[hi - d] -= 1
        del self._wsum[d:]
        del self._nact[d:]
        while len(self._wsum) < d:
            # idle gap between the settled horizon and the first event
            # epoch: nothing was active there
            self._wsum.append(0.0)
            self._nact.append(0)
        w, n = 0.0, 0
        for k in range(width):
            w += dw[k]
            n += dn[k]
            self._wsum.append(w)
            self._nact.append(n)

    def _visible(self, s: Span, w_forever: float) -> tuple[tuple, float]:
        """A span's visible schedule: its local share prefix plus tail.

        Monotonicity keeps every grant inside the prefix, so this is all
        the simulation can observe.  For a still-open span the tail is its
        weighted split of the budget among the open spans (the opening
        round's everyone-active-forever assumption); for a closed span the
        tail is the full budget -- by construction every other span has
        drained beyond its horizon.

        With ``budget_factors`` (thermal derating) the per-epoch budget is
        ``b * f(e)``; an open span's prefix is extended through the whole
        derate window so every derated epoch carries its exact factor --
        the tails stay factor-free, which keeps the schedules pointwise
        rising across rounds (the derate window lives entirely inside the
        prefix, where monotonicity is argued epoch-by-epoch).
        """
        b = self.budget
        wsum = self._wsum
        fac = self.budget_factors
        if not fac:
            if s.end is None:
                prefix = tuple(b * s.weight / wsum[e] if wsum[e] else b
                               for e in range(s.start, len(wsum)))
                return prefix, b * s.weight / w_forever
            prefix = tuple(b * s.weight / wsum[e] if wsum[e] else b
                           for e in range(s.start, s.end))
            return prefix, b
        nf = len(fac)
        nw = len(wsum)

        def share(e: int) -> float:
            be = b * fac[e] if e < nf else b
            # beyond the built horizon only the still-open spans are
            # active: their weight sum is exactly w_forever
            w = wsum[e] if e < nw else w_forever
            return be * s.weight / w if w else be

        if s.end is None:
            hi = max(nw, nf)
            return (tuple(share(e) for e in range(s.start, hi)),
                    b * s.weight / w_forever)
        return tuple(share(e) for e in range(s.start, s.end)), b

    # -- the fixed point ---------------------------------------------------
    def relax(self, spans: Sequence[Span], simulate: SimulateFn,
              dirty_from: int = 0, collect_trace: bool = True
              ) -> ArbiterTrace:
        """Relax the share schedule over ``spans`` to its fixed point.

        ``spans`` are the consumers whose activity may still change --
        the closed batch passes every core, the online client only its
        non-retired segments (retired spans' contributions live on in the
        settled prefix).  Dirty spans must arrive with ``end=None``
        ("active indefinitely": pointwise-minimal shares, the monotone
        iteration's safe starting point).  ``dirty_from`` is the earliest
        epoch any share may move; the settled prefix below it is reused
        (unless ``prefix_cache=False``, which recomputes from epoch 0 --
        same values, linearly more work).

        ``simulate`` is called once per round with the batch of spans
        needing (re-)simulation; it must set each span's ``last_grant``
        and ``throttled``.  Returns the converged :class:`ArbiterTrace`
        covering the *full* schedule (settled prefix included) --
        ``collect_trace=False`` skips materializing the O(horizon) share/
        active tuples for callers that only need the round counts (the
        online client's per-settle hot path; its trace queries read the
        arbiter's properties on demand instead).
        """
        d = dirty_from if self.prefix_cache else 0
        self._stamp += 1
        stamp = self._stamp
        skipped: list[int] = []
        rounds = 0
        for rounds in range(1, self.max_rounds + 1):
            self._rebuild(spans, d)
            w_forever = sum(s.weight for s in spans
                            if s.demands and s.end is None)
            jobs: list[tuple[int, tuple, float]] = []
            for i, s in enumerate(spans):
                if not s.demands:
                    # schedule-independent: no shared traffic at all --
                    # one simulation under the plain port model suffices
                    # (the oracle re-runs it, staying literal)
                    if s._stamp < 0 or self.oracle:
                        jobs.append((i, (), math.inf))
                    continue
                if s.end is not None and s.end <= d and s._stamp >= 0:
                    continue            # settled fact
                vis = self._visible(s, w_forever)
                unthrottled = (self.unthrottled_skip and not self.oracle
                               and s._stamp == stamp and not s.throttled)
                if self.oracle or s._stamp < 0 or (s._vis != vis
                                                   and not unthrottled):
                    jobs.append((i, vis[0], vis[1]))
            skipped.append(len(spans) - len(jobs))
            if jobs:
                # the callback may diff a span's previous visible schedule
                # (``_vis``) against the new one -- e.g. to resume from a
                # snapshot below the first changed epoch -- so ``_vis`` is
                # updated only after the simulations ran.
                simulate(jobs)
                for i, prefix, tail in jobs:
                    spans[i]._vis = (prefix, tail)
                    spans[i]._stamp = stamp
            E = self.epoch_cycles
            converged = True
            for s in spans:
                if not s.demands:
                    e = s.start
                else:
                    e = s.start + int(s.last_grant // E) + 1
                    if s.end is not None and s.end < e:
                        e = s.end
                if e != s.end:
                    s.end = e
                    converged = False
            if converged:
                break
        self.rounds_total += rounds
        return ArbiterTrace(epoch_cycles=self.epoch_cycles,
                            shares=self.share_trace if collect_trace else (),
                            n_active=self.active_trace if collect_trace
                            else (),
                            rounds=rounds, skipped=tuple(skipped))


def build_share_schedule(spans: Sequence[tuple[int, int | None]],
                         budget: float) -> tuple[list[float], list[int]]:
    """Per-epoch ``(share, n_active)`` from equal-weight activity spans.

    The standalone (non-relaxing) form of the engine's schedule builder,
    kept for direct inspection and tests: ``spans[i]`` is the half-open
    epoch interval ``[start, end)`` during which consumer *i* draws on
    ``budget`` (``end=None`` = active indefinitely), and epoch *e*'s share
    is ``budget / n_active(e)`` up to the largest finite end.
    """
    horizon = max((e for _, e in spans if e is not None), default=0)
    shares, n_active = [], []
    for e in range(horizon):
        n = sum(1 for s, h in spans if s <= e and (h is None or h > e))
        shares.append(budget / n if n else budget)
        n_active.append(n)
    return shares, n_active
