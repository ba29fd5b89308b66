"""Contention-aware serving batcher over the online chip model.

``repro_torch.serving`` serves real tokens on real hardware; this module answers
the capacity-planning question next to it on the *simulated* RASA chip:
given a stream of serving requests -- each one prefill GEMM plus a chain of
decode micro-GEMMs, lowered through the same
:mod:`repro_torch.core.tiling` register-aware compiler as everything else -- how
should requests be admitted into the chip so the shared memory system
sustains them?  Per-engine throughput is flat for batch 1..16 (paper
Fig. 7); at chip scale the binding resource is bandwidth, so batch
formation must see *chip* state, not a fixed batch knob.

Requests flow through :class:`repro_torch.multicore.online.OnlineChip`: they
arrive at epoch boundaries, an **admission policy** decides at every
decision epoch (arrival or completion) which waiting requests enter the
chip and on which core, and admitted requests run to completion under the
epoch bandwidth arbiter.  Policies (:data:`POLICIES`):

``fixed``
    The classic static batcher and the baseline every aware policy must
    beat: admit requests in groups of ``batch_size`` the moment a full
    group is waiting (plus the final partial group once arrivals end),
    placed blind round-robin.  Sees neither occupancy nor bandwidth.
``bandwidth``
    Threshold admission: admit head-of-line requests only while the
    projected per-request bandwidth share ``budget / (n_active + k + 1)``
    stays at or above ``min_share``; placement on the soonest-free core
    (:func:`repro_torch.multicore.scheduler.assign_incremental`).
``occupancy``
    Occupancy-aware: admit at most one request per *idle* core (never
    queues behind a busy engine), subject to the same bandwidth headroom
    check as ``bandwidth``.  This is the policy that sees both live chip
    signals.
``predicted``
    Predicted-occupancy: like ``occupancy``, but instead of reacting to
    cores that are idle *now* it forecasts departures from the online
    chip's settled share-schedule prefix -- a core whose settled work (and
    queued backlog estimate) drains within ``lookahead`` epochs counts as
    available, and the admitted request is queued so it starts at the
    exact boundary the core frees up, instead of waiting for the next
    decision epoch.  Never admits more than one request per predicted-free
    core, and subject to the same bandwidth headroom check.
``phase_aware``
    ``occupancy`` plus a cap of ``max_prefills`` concurrently *running*
    prefill-heavy requests (prefill >= half the request's MACs): decode
    work is latency-bound and cheap per epoch, prefill is a bandwidth
    storm -- letting every idle core start a prefill at once starves the
    decodes behind them.  Decode-heavy requests are admitted past waiting
    prefills (no head-of-line blocking across phases).
``degraded``
    Graceful degradation: ``occupancy`` while the chip is healthy; when
    measured headroom collapses (zero bandwidth headroom for another
    request, or a core is down under a fault plan) it sheds load by
    admitting only decode-heavy requests -- prefill-heavy work waits (and
    may time out and retry) instead of piling onto a saturated or
    shrunken chip and collapsing the queue for everyone.

Deadlines, retry and abandonment: a :class:`ServeRequest` may carry a
``deadline`` (cycles, per attempt, measured from the attempt's arrival).
A request still *waiting* when its deadline lapses is retried with
exponential backoff (re-arrival after ``backoff_epochs * 2**(attempt-1)``
epochs), up to ``max_attempts`` attempts, then **abandoned** (infinite
latency, excluded from the makespan).  An *admitted* request always runs
to completion; finishing past its deadline counts as a deadline miss.
:class:`BatchReport` reports ``deadline_miss_rate``, ``retries``,
``abandoned`` and ``goodput_macs_per_cycle`` (MACs of requests served
within their deadline, per makespan cycle) -- the metric the
fault-tolerance benchmark ranks policies by.

Work conservation: whenever the chip is completely idle and a
threshold policy (``bandwidth``/``occupancy``) declines every waiting
request, the head request is admitted anyway (a share floor must never
deadlock an idle chip); the forced request goes to the soonest-free core.
The ``fixed`` policy is exempt -- idling until a full group has arrived is
its defining behavior, and it cannot deadlock (the partial tail group is
flushed once arrivals end).

:func:`run_batcher` returns a :class:`BatchReport` with per-request
latencies (p50/p99), the makespan, and the admission timeline.  Results
are backend-independent (``reference``/``fast``/``numpy``/``torch``/
``cuda``); the parity suites pin it.
"""

from __future__ import annotations

import dataclasses
import math
import random
from collections import deque
from typing import Sequence

import numpy as np

from ..core.fastsim import SNAP_STRIDE
from ..core.tiling import GemmSpec
from ..multicore.chip import ChipConfig
from ..multicore.online import OnlineChip
from ..multicore.scheduler import assign_incremental
from ..obs.config import OFF, TelemetryConfig

POLICIES = ("fixed", "bandwidth", "occupancy", "predicted", "phase_aware",
            "degraded")


@dataclasses.dataclass(frozen=True)
class ServeRequest:
    """One serving request: a prefill phase plus its decode micro-GEMMs.

    ``arrival_epoch`` is the scheduling epoch at whose boundary the request
    enters the arrival queue.  Lowered onto one core as a single segment:
    decode steps of one request are sequentially dependent.  ``prefill``
    is one GEMM (the synthetic single-layer traces) or a tuple of GEMMs (a
    compiled model's per-layer prefill stream -- see :func:`model_trace`);
    ``decode`` likewise holds one GEMM per step, or the model's per-step
    GEMM chain flattened across steps.
    """

    name: str
    arrival_epoch: int
    prefill: GemmSpec | tuple[GemmSpec, ...]
    decode: tuple[GemmSpec, ...] = ()
    #: per-attempt service deadline in cycles, measured from the attempt's
    #: (re-)arrival; ``None`` -- the default -- means best-effort (never
    #: retried, never abandoned, never counted as a miss)
    deadline: float | None = None

    @property
    def specs(self) -> tuple[GemmSpec, ...]:
        pf = (self.prefill,) if isinstance(self.prefill, GemmSpec) \
            else tuple(self.prefill)
        return (*pf, *self.decode)

    @property
    def macs(self) -> int:
        return sum(s.macs for s in self.specs)

    @property
    def prefill_macs(self) -> int:
        pf = (self.prefill,) if isinstance(self.prefill, GemmSpec) \
            else tuple(self.prefill)
        return sum(s.macs for s in pf)

    @property
    def prefill_heavy(self) -> bool:
        """Prefill is at least half this request's MACs -- the phase the
        ``phase_aware`` cap and ``degraded`` shedding gate on."""
        return 2 * self.prefill_macs >= self.macs


def arrival_process(n_requests: int, seed: int, mean_gap: int,
                    prompt_lens: Sequence[int], decode_steps: Sequence[int]
                    ) -> tuple[tuple[int, int, int, int], ...]:
    """The shared ``(i, arrival_epoch, prompt, steps)`` draw sequence.

    One RNG arrival loop serves both :func:`synthetic_trace` and
    :func:`model_trace`: inter-arrival gaps uniform on ``[0, 2*mean_gap]``
    epochs (``mean_gap`` is the offered-load knob; smaller = heavier
    load), prompt lengths and decode-chain lengths drawn from the given
    menus.  A seed therefore produces the *same* arrival pattern in both
    trace builders -- only the per-request GEMM lowering differs.
    """
    rng = random.Random(seed)
    draws, epoch = [], 0
    for i in range(n_requests):
        if i:
            epoch += rng.randrange(0, 2 * mean_gap + 1)
        prompt = rng.choice(tuple(prompt_lens))
        steps = rng.choice(tuple(decode_steps))
        draws.append((i, epoch, prompt, steps))
    return tuple(draws)


def synthetic_trace(n_requests: int = 16, *, seed: int = 0,
                    mean_gap: int = 2, d_model: int = 512,
                    prompt_lens: Sequence[int] = (32, 64, 128),
                    decode_steps: Sequence[int] = (2, 4, 8),
                    decode_batch: int = 8) -> tuple[ServeRequest, ...]:
    """Deterministic synthetic request trace.

    Arrivals and shape draws come from :func:`arrival_process`.  Each
    request is ``prefill[M=prompt, K=N=d_model]`` followed by
    ``decode[M=decode_batch, K=N=d_model]`` per step -- the Fig. 7 shapes,
    one layer GEMM standing in for the model's layer stack.
    """
    reqs = []
    for i, epoch, prompt, steps in arrival_process(
            n_requests, seed, mean_gap, prompt_lens, decode_steps):
        prefill = GemmSpec(f"r{i}.prefill", M=prompt, K=d_model, N=d_model)
        decode = tuple(GemmSpec(f"r{i}.d{j}", M=decode_batch, K=d_model,
                                N=d_model) for j in range(steps))
        reqs.append(ServeRequest(f"r{i}", epoch, prefill, decode))
    return tuple(reqs)


def skewed_trace(d_model: int = 512, *, heavy_prompt: int = 512,
                 light_prompt: int = 32, n_heavy: int = 2,
                 n_light: int = 10,
                 decode_batch: int = 8) -> tuple[ServeRequest, ...]:
    """The canonical skewed 4-core trace (acceptance scenario).

    ``n_heavy`` prefill-heavy requests arrive first, then bursts of light
    decode-dominated requests.  Blind round-robin placement piles light
    requests behind the heavy ones while other cores drain dry;
    occupancy-aware admission routes them to idle engines.  The keyword
    knobs scale the trace down for oracle-backend (reference) test runs.
    """
    heavy = [ServeRequest(
        f"h{i}", 0,
        GemmSpec(f"h{i}.prefill", M=heavy_prompt, K=d_model, N=d_model),
        tuple(GemmSpec(f"h{i}.d{j}", M=decode_batch, K=d_model, N=d_model)
              for j in range(4))) for i in range(n_heavy)]
    light = [ServeRequest(
        f"l{i}", i // 2,
        GemmSpec(f"l{i}.prefill", M=light_prompt, K=d_model, N=d_model),
        tuple(GemmSpec(f"l{i}.d{j}", M=decode_batch, K=d_model, N=d_model)
              for j in range(2))) for i in range(n_light)]
    return tuple(heavy + light)


def model_trace(arch, n_requests: int = 16, *, seed: int = 0,
                mean_gap: int = 2, prompt_lens: Sequence[int] = (32, 64, 128),
                decode_steps: Sequence[int] = (2, 4, 8),
                decode_batch: int = 1,
                options=None) -> tuple[ServeRequest, ...]:
    """Request trace whose GEMMs come from a compiled model, not synthetic
    shapes.

    The real-model analogue of :func:`synthetic_trace`: same arrival
    process and menu knobs, but each request's prefill is the model's
    compiled per-layer prefill stream at its prompt length, and each decode
    step is the compiled decode stream at ``decode_batch`` (one compile per
    distinct ``(prompt, steps)`` point -- decode steps share specs by
    construction, so the trace compiler lowers each distinct shape once no
    matter the request count).  ``arch`` is a ``repro_torch.configs`` name or a
    :class:`repro_torch.config.ModelConfig`; ``options`` defaults to the capped
    two-layer projection lowering that keeps oracle-backend runs feasible.
    """
    from ..workload.compile import CompileOptions, compile_workload
    if options is None:
        options = CompileOptions(dim_cap=1024, max_layers=2)
    name = arch if isinstance(arch, str) else arch.name
    reqs = []
    for i, epoch, prompt, steps in arrival_process(
            n_requests, seed, mean_gap, prompt_lens, decode_steps):
        prefill = compile_workload(arch, batch=1, seq=prompt,
                                   phase="prefill", options=options).specs
        step = compile_workload(arch, batch=decode_batch, seq=prompt,
                                phase="decode", options=options).specs
        reqs.append(ServeRequest(f"{name}.r{i}", epoch, prefill,
                                 step * steps))
    return tuple(reqs)


@dataclasses.dataclass(frozen=True)
class BatchReport:
    """Outcome of one batched-serving run (cf. ChipReport).

    Per-request arrays (``latencies``/``finish_times``/...) are in the
    caller's submission order, ``names[i]`` identifying request *i*.
    """

    policy: str
    design: str
    n_cores: int
    n_requests: int
    epoch_cycles: float
    makespan: float                     # cycles, first arrival to last retire
    names: tuple[str, ...]
    latencies: tuple[float, ...]        # finish - arrival, per request
    finish_times: tuple[float, ...]
    arrival_epochs: tuple[int, ...]
    admit_epochs: tuple[int, ...]       # when each request entered the chip
    macs: int
    #: (late-served + abandoned) / n_requests; 0.0 when no request carries
    #: a deadline
    deadline_miss_rate: float = 0.0
    #: waiting-timeout retries across all requests (each re-arrival after
    #: exponential backoff counts once)
    retries: int = 0
    #: requests that exhausted ``max_attempts`` without being admitted --
    #: their latency/finish is ``inf`` and they are excluded from the
    #: makespan
    abandoned: int = 0
    #: MACs of requests served within their deadline (all served MACs when
    #: no deadlines are set; abandoned requests never count)
    served_macs: int = 0
    #: :class:`repro_torch.obs.timeline.ChipTelemetry` when the run was made
    #: with ``telemetry=TelemetryConfig(enabled=True)``; excluded from
    #: equality (reports with and without telemetry compare by the numbers
    #: above)
    telemetry: object | None = dataclasses.field(default=None, compare=False)
    #: why a ``backend="cuda"``/``"torch"`` run fell back to the
    #: incremental client (one of
    #: ``repro_torch.multicore.jitarb.GATE_REASONS``) -- ``None`` when the
    #: run took the whole-trace program or never tried it;
    #: diagnostic only, excluded from equality like ``telemetry``
    jit_gate: str | None = dataclasses.field(default=None, compare=False)

    @property
    def attribution(self):
        """Per-core stall attribution (None without telemetry)."""
        return self.telemetry.attribution if self.telemetry else None

    def latency_percentile(self, q: float) -> float:
        """Linear-interpolated percentile of the request latencies."""
        if not self.latencies:
            return 0.0
        return float(np.percentile(self.latencies, q))

    @property
    def p50_latency(self) -> float:
        return self.latency_percentile(50.0)

    @property
    def p99_latency(self) -> float:
        return self.latency_percentile(99.0)

    @property
    def mean_latency(self) -> float:
        return sum(self.latencies) / len(self.latencies) \
            if self.latencies else 0.0

    @property
    def throughput_macs_per_cycle(self) -> float:
        return self.macs / self.makespan if self.makespan else 0.0

    @property
    def goodput_macs_per_cycle(self) -> float:
        """Within-deadline MACs per makespan cycle -- equals throughput on
        a deadline-free run, and the metric the fault-tolerance benchmark
        ranks admission policies by."""
        return self.served_macs / self.makespan if self.makespan else 0.0


class _Pending:
    """A logical request waiting for admission: its current attempt's
    (re-)arrival epoch and how many attempts it has made so far."""

    __slots__ = ("req", "arrival", "attempts")

    def __init__(self, req: ServeRequest, arrival: int,
                 attempts: int = 1):
        self.req = req
        self.arrival = arrival
        self.attempts = attempts


class _Batcher:
    """One admission-policy run over an arrival trace (driver state)."""

    def __init__(self, requests: Sequence[ServeRequest], chip: ChipConfig,
                 policy: str, batch_size: int, min_share: float,
                 snap_stride: int, lookahead: int = 1,
                 prefix_cache: bool = True,
                 telemetry: TelemetryConfig = OFF,
                 max_attempts: int = 3, backoff_epochs: int = 1,
                 max_prefills: int = 1):
        if policy not in POLICIES:
            raise ValueError(f"unknown policy {policy!r}; "
                             f"available: {POLICIES}")
        if batch_size < 1:
            raise ValueError("batch_size must be >= 1")
        if lookahead < 0:
            raise ValueError("lookahead must be >= 0")
        if max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        if backoff_epochs < 0:
            raise ValueError("backoff_epochs must be >= 0")
        if max_prefills < 1:
            raise ValueError("max_prefills must be >= 1")
        self.chip = chip
        self.policy = policy
        self.batch_size = batch_size
        self.min_share = min_share
        self.lookahead = lookahead
        self.telemetry = telemetry
        self.max_attempts = max_attempts
        self.backoff_epochs = backoff_epochs
        self.max_prefills = max_prefills
        self.submitted = list(requests)     # caller order, for the report
        self.requests = sorted(requests, key=lambda r: r.arrival_epoch)
        self.sim = OnlineChip(chip, snap_stride=snap_stride,
                              prefix_cache=prefix_cache,
                              telemetry=telemetry)
        self.waiting: deque[_Pending] = deque()
        self.next_arrival = 0               # index into self.requests
        self.segments: dict[str, object] = {}
        self.admit_epochs: dict[str, int] = {}
        self._rr = 0                        # fixed policy's blind pointer
        # -- deadline / retry state (all inert without deadlines) --
        self._deadlines = any(r.deadline is not None for r in requests)
        #: backoff re-arrivals not yet due, as (epoch, seq, record) --
        #: ``seq`` makes equal-epoch ordering deterministic
        self.retry: list[tuple[int, int, _Pending]] = []
        self._rseq = 0
        self.abandoned_names: set[str] = set()
        self.n_retries = 0
        #: (epoch, label) retry/abandon instants for the telemetry marks
        self.events: list[tuple[int, str]] = []
        #: arrival epoch of the attempt that was finally admitted (the
        #: point deadline misses of served requests are measured from)
        self.attempt_arrival: dict[str, int] = {}
        #: admitted prefill-heavy segments (phase_aware cap accounting)
        self._pf_segs: list = []

    # -- admission ---------------------------------------------------------
    def _headroom(self) -> int:
        """How many more requests fit before the projected per-request
        share drops below ``min_share`` (conservative: counts currently
        active segments plus the admissions of this decision epoch)."""
        if self.min_share <= 0:
            return len(self.waiting)
        n_act = self.sim.n_active()
        budget = self.chip.bw_bytes_per_cycle
        k = 0
        while (k < len(self.waiting)
               and budget / (n_act + k + 1) >= self.min_share):
            k += 1
        return k

    def _active_prefills(self) -> int:
        """Admitted prefill-heavy requests still running right now
        (following preemption-resume chains; queued resumes count as
        running)."""
        now = self.sim.epoch * self.chip.epoch_cycles
        alive = []
        for seg in self._pf_segs:
            seg = self.sim.final_instance(seg)
            if (seg.span is None or seg.result is None
                    or self.sim.finish_time(seg) > now):
                alive.append(seg)
        self._pf_segs = alive
        return len(alive)

    def _take_waiting(self, picks: Sequence[int],
                      free_cores: Sequence[int]
                      ) -> list[tuple[_Pending, int]]:
        """Remove the picked waiting records (by index) and place them on
        the free cores in order."""
        out = [(self.waiting[i], free_cores[j])
               for j, i in enumerate(picks)]
        for i in reversed(picks):
            del self.waiting[i]
        return out

    def _admit(self) -> list[tuple[_Pending, int]]:
        """The policy's admissions for the current epoch: (record, core)."""
        sim, waiting = self.sim, self.waiting
        n_cores = self.chip.n_cores
        if self.policy == "fixed":
            out = []
            drained = self.next_arrival >= len(self.requests)
            while (len(waiting) >= self.batch_size
                   or (drained and waiting)):
                for _ in range(min(self.batch_size, len(waiting))):
                    out.append((waiting.popleft(), self._rr % n_cores))
                    self._rr += 1
            return out
        take = min(len(waiting), self._headroom())
        if self.policy == "occupancy":
            free_cores = [c for c, busy in enumerate(sim.core_busy())
                          if not busy]
            take = min(take, len(free_cores))
            return [(waiting.popleft(), free_cores[i]) for i in range(take)]
        if self.policy == "phase_aware":
            free_cores = [c for c, busy in enumerate(sim.core_busy())
                          if not busy]
            limit = min(take, len(free_cores))
            pf_slots = self.max_prefills - self._active_prefills()
            picks: list[int] = []
            for i, rec in enumerate(waiting):
                if len(picks) >= limit:
                    break
                if rec.req.prefill_heavy:
                    if pf_slots <= 0:
                        continue    # decode work may pass the waiting prefill
                    pf_slots -= 1
                picks.append(i)
            return self._take_waiting(picks, free_cores)
        if self.policy == "degraded":
            free_cores = [c for c, busy in enumerate(sim.core_busy())
                          if not busy]
            shed = any(sim.down_cores) or self._headroom() == 0
            if not shed:
                take = min(take, len(free_cores))
                return [(waiting.popleft(), free_cores[i])
                        for i in range(take)]
            # headroom collapsed (or the chip shrank): decode-heavy only,
            # one per idle core, past the bandwidth floor -- decode traffic
            # is light and keeping it flowing is what preserves goodput
            picks = [i for i, rec in enumerate(waiting)
                     if not rec.req.prefill_heavy][:len(free_cores)]
            return self._take_waiting(picks, free_cores)
        if self.policy == "predicted":
            # forecast from the settled schedule: a core whose settled
            # work + queued backlog drains within the lookahead window is
            # available -- its admitted request starts at the exact
            # boundary it frees up, one decision epoch earlier than the
            # reactive occupancy policy can manage
            horizon = (sim.epoch + self.lookahead) * self.chip.epoch_cycles
            free_at = sim.free_at_estimate()
            soon = sorted((c for c in range(n_cores)
                           if free_at[c] <= horizon),
                          key=lambda c: free_at[c])
            take = min(take, len(soon))
            return [(waiting.popleft(), soon[i]) for i in range(take)]
        # bandwidth: headroom-gated, placed on the soonest-free core
        recs = [waiting.popleft() for _ in range(take)]
        return self._soonest_free(recs)

    def _soonest_free(self, recs: Sequence[_Pending]
                      ) -> list[tuple[_Pending, int]]:
        # one freshly-built list per request: items are distinct objects by
        # construction, so identity maps them back to their request even
        # when two requests have equal GEMM shapes
        items = [list(rec.req.specs) for rec in recs]
        by_item = {id(item): rec for item, rec in zip(items, recs)}
        placement = assign_incremental(items, self.chip,
                                       self.sim.free_at_estimate())
        out = []
        for core, placed in enumerate(placement):
            for item in placed:
                out.append((by_item[id(item)], core))
        return out

    # -- deadlines: waiting-expiry, backoff, abandonment -------------------
    def _expire(self, t: int) -> None:
        """Time out waiting attempts whose deadline lapsed: re-enqueue
        with exponential backoff, or abandon past ``max_attempts``."""
        E = self.chip.epoch_cycles
        kept: deque[_Pending] = deque()
        for rec in self.waiting:
            dl = rec.req.deadline
            if dl is None or (t - rec.arrival) * E <= dl:
                kept.append(rec)
            elif rec.attempts >= self.max_attempts:
                self.abandoned_names.add(rec.req.name)
                self.events.append((t, f"abandon {rec.req.name}"))
            else:
                delay = self.backoff_epochs * (2 ** (rec.attempts - 1))
                rec.attempts += 1
                rec.arrival = t + delay
                self.n_retries += 1
                self._rseq += 1
                self.retry.append((rec.arrival, self._rseq, rec))
                self.events.append((t, f"retry {rec.req.name}"))
        self.waiting = kept

    def _next_expiry(self) -> int | None:
        """First epoch at which some waiting attempt's deadline lapses
        (a decision-epoch candidate: expiry changes batcher state even
        when the chip does nothing)."""
        if not self._deadlines:
            return None
        E = self.chip.epoch_cycles
        out = None
        for rec in self.waiting:
            dl = rec.req.deadline
            if dl is None:
                continue
            e = math.floor((rec.arrival * E + dl) / E) + 1
            out = e if out is None else min(out, e)
        return out

    # -- driver ------------------------------------------------------------
    def run(self) -> BatchReport:
        sim = self.sim
        E = self.chip.epoch_cycles
        if self.requests:
            t = self.requests[0].arrival_epoch
            while (self.next_arrival < len(self.requests) or self.waiting
                   or self.retry):
                sim.advance_to(t)
                while (self.next_arrival < len(self.requests)
                       and self.requests[self.next_arrival].arrival_epoch
                       <= t):
                    r = self.requests[self.next_arrival]
                    self.waiting.append(_Pending(r, r.arrival_epoch))
                    self.next_arrival += 1
                if self.retry:
                    due = sorted(x for x in self.retry if x[0] <= t)
                    if due:
                        self.retry = [x for x in self.retry if x[0] > t]
                        for _, _, rec in due:
                            self.waiting.append(rec)
                if self._deadlines:
                    self._expire(t)
                admitted = self._admit()
                if (not admitted and self.waiting
                        and self.policy != "fixed"
                        and not any(sim.core_busy())):
                    # work conservation: a threshold policy must not
                    # starve a waiting request on an idle chip.  The
                    # fixed policy is exempt -- waiting for a full group
                    # is its defining (and deadlock-free) behavior.
                    admitted = self._soonest_free([self.waiting.popleft()])
                segs = sim.submit_batch([(core, rec.req.specs)
                                         for rec, core in admitted])
                for (rec, _), seg in zip(admitted, segs):
                    self.segments[rec.req.name] = seg
                    self.admit_epochs[rec.req.name] = t
                    self.attempt_arrival[rec.req.name] = rec.arrival
                    if (self.policy == "phase_aware"
                            and rec.req.prefill_heavy):
                        self._pf_segs.append(seg)
                cands = []
                if self.next_arrival < len(self.requests):
                    cands.append(
                        self.requests[self.next_arrival].arrival_epoch)
                if self.retry:
                    cands.append(min(x[0] for x in self.retry))
                if self.waiting:
                    nxt = sim.next_event()
                    if nxt is not None:
                        cands.append(nxt)
                    exp = self._next_expiry()
                    if exp is not None:
                        cands.append(exp)
                if not cands:
                    break
                t = min(cands)
            sim.drain()
        reqs = self.submitted
        finishes: list[float] = []
        latencies: list[float] = []
        missed = 0
        served_macs = 0
        for r in reqs:
            seg = self.segments.get(r.name)
            if seg is None:
                # abandoned without ever being admitted
                finishes.append(math.inf)
                latencies.append(math.inf)
                missed += 1
                continue
            f = sim.finish_time(sim.final_instance(seg))
            finishes.append(f)
            latencies.append(f - r.arrival_epoch * E)
            if (r.deadline is not None
                    and f - self.attempt_arrival[r.name] * E > r.deadline):
                missed += 1     # admitted, but retired past the deadline
            else:
                served_macs += r.macs
        first = min((r.arrival_epoch for r in reqs), default=0) * E
        finite = [f for f in finishes if not math.isinf(f)]
        tele = None
        if self.telemetry.enabled:
            from ..obs.timeline import build_online_telemetry
            names = {}
            for name, seg in self.segments.items():
                names[seg.sid] = name                # type: ignore[attr-defined]
                while seg.preempted_at is not None:  # type: ignore[attr-defined]
                    seg = sim.resume_of(seg)
                    names[seg.sid] = name
            marks = [(r.arrival_epoch * E, f"arrive {r.name}")
                     for r in reqs]
            marks += [(self.admit_epochs[r.name] * E, f"admit {r.name}")
                      for r in reqs if r.name in self.admit_epochs]
            marks += [(e * E, label) for e, label in self.events]
            tele = build_online_telemetry(sim, self.telemetry, names=names,
                                          marks=marks)
        return BatchReport(
            policy=self.policy,
            design=self.chip.design_name,
            n_cores=self.chip.n_cores,
            n_requests=len(reqs),
            epoch_cycles=E,
            makespan=max(finite, default=first) - first,
            names=tuple(r.name for r in reqs),
            latencies=tuple(latencies),
            finish_times=tuple(finishes),
            arrival_epochs=tuple(r.arrival_epoch for r in reqs),
            admit_epochs=tuple(self.admit_epochs.get(r.name, -1)
                               for r in reqs),
            macs=sum(r.macs for r in reqs),
            deadline_miss_rate=missed / len(reqs) if reqs else 0.0,
            retries=self.n_retries,
            abandoned=len(self.abandoned_names),
            served_macs=served_macs,
            telemetry=tele,
        )


def run_batcher(requests: Sequence[ServeRequest],
                chip: ChipConfig | None = None, *,
                policy: str = "occupancy", batch_size: int = 4,
                min_share: float | None = None,
                snap_stride: int = SNAP_STRIDE,
                lookahead: int = 1,
                prefix_cache: bool = True,
                telemetry: TelemetryConfig = OFF,
                max_attempts: int = 3,
                backoff_epochs: int = 1,
                max_prefills: int = 1,
                **chip_kwargs) -> BatchReport:
    """Serve an arrival trace through the online chip model.

    ``min_share`` (bytes/cycle) is the bandwidth-headroom floor of the
    threshold policies (``bandwidth``/``occupancy``/``predicted``); the
    default admits up to two concurrent requests per core before
    throttling admission.  ``lookahead`` (epochs) is the ``predicted``
    policy's departure-forecast window.  ``prefix_cache=False`` runs the
    online arbiter in its rebuild-from-epoch-0 baseline mode (identical
    results, linearly more work -- the ``benchmarks/online_scaling.py``
    comparison).  ``telemetry=TelemetryConfig(enabled=True)`` attaches a
    full :class:`repro_torch.obs.timeline.ChipTelemetry` to the report
    (and takes the incremental client: the whole-trace program keeps no
    segment history).  ``max_attempts``/``backoff_epochs`` bound
    the deadline retry loop and ``max_prefills`` is the ``phase_aware``
    concurrent-prefill cap (all three inert without deadlines or that
    policy; see ``docs/resilience.md``).  Extra keyword arguments
    construct the :class:`ChipConfig` when none is given (cf.
    :func:`repro_torch.multicore.simulate_chip`).
    """
    if chip is None:
        chip = ChipConfig(**chip_kwargs)
    elif chip_kwargs:
        raise TypeError(f"pass either a ChipConfig or config kwargs, not "
                        f"both: {sorted(chip_kwargs)}")
    if min_share is None:
        min_share = chip.bw_bytes_per_cycle / (2.0 * chip.n_cores)
    names = [r.name for r in requests]
    if len(set(names)) != len(names):
        raise ValueError("request names must be unique")
    chip.require_card()
    jit_gate = None
    if (prefix_cache and not telemetry.enabled and chip.backend in ("cuda", "torch")
            and requests and all(r.deadline is None for r in requests)):
        # whole-trace lane: one kernel launch (cuda) or its plain version
        # (torch) replays the full arbitration -- admission decisions
        # included (see repro_torch.multicore.jitarb; bit-identical to the
        # incremental client, pinned by tests/test_torch_batcher_program.py).
        # plan_ex gates and explains configurations it cannot replay.
        from ..multicore import jitarb
        plan, jit_gate = jitarb.plan_ex(
            [(r.arrival_epoch, r.specs) for r in requests], chip,
            policy=policy, batch_size=batch_size, min_share=min_share,
            lookahead=lookahead)
        if plan is not None:
            fins, adm = jitarb.finish_admit_times(plan)
            return report_from_finishes(requests, chip, fins,
                                        policy=policy, admit_epochs=adm)
    report = _Batcher(requests, chip, policy, batch_size, min_share,
                      snap_stride, lookahead, prefix_cache, telemetry,
                      max_attempts, backoff_epochs, max_prefills).run()
    if jit_gate is not None:
        report = dataclasses.replace(report, jit_gate=jit_gate)
    return report


def report_from_finishes(requests: Sequence[ServeRequest],
                         chip: ChipConfig,
                         finishes: Sequence[float], *,
                         policy: str = "fixed",
                         admit_epochs: Sequence[float] | None = None
                         ) -> BatchReport:
    """Assemble a :class:`BatchReport` from absolute finish cycles in
    caller order -- the whole-trace arbitration program
    (:mod:`repro_torch.multicore.jitarb`) returns finish cycles and admit
    epochs, and every other report field is a closed form of the inputs
    on its domain (no deadlines: every request is served within deadline
    by definition, and under ``fixed``@1 admission -- the default when
    ``admit_epochs`` is omitted -- each is admitted at its arrival)."""
    E = chip.epoch_cycles
    fins = tuple(float(f) for f in finishes)
    first = min((r.arrival_epoch for r in requests), default=0) * E
    macs = sum(r.macs for r in requests)
    if admit_epochs is None:
        admit_epochs = tuple(r.arrival_epoch for r in requests)
    else:
        admit_epochs = tuple(float(a) for a in admit_epochs)
    return BatchReport(
        policy=policy,
        design=chip.design_name,
        n_cores=chip.n_cores,
        n_requests=len(requests),
        epoch_cycles=E,
        makespan=max(fins, default=first) - first,
        names=tuple(r.name for r in requests),
        latencies=tuple(f - r.arrival_epoch * E
                        for r, f in zip(requests, fins)),
        finish_times=fins,
        arrival_epochs=tuple(r.arrival_epoch for r in requests),
        admit_epochs=tuple(admit_epochs),
        macs=macs,
        deadline_miss_rate=0.0,
        retries=0,
        abandoned=0,
        served_macs=macs,
        telemetry=None,
    )
