"""Whole-trace span arbitration: an online serving run settled by ONE
launch.

Counterpart of the JAX package's ``multicore/jitarb.py``: the host side
(planning, the domain gate) is its numpy, line for line; the program the
reference writes as one ``lax.while_loop`` is the hand-written kernel of
:mod:`repro_torch.kernels.jitarb` (``csrc/jitarb.cu``) on a ``cuda`` chip,
and its plain PyTorch version on a ``torch`` chip (on ``ChipConfig.device``).

The incremental client (:class:`repro_torch.multicore.online.OnlineChip`)
walks an arrival trace on the host: every start boundary marks the
in-flight spans dirty, relaxes the share fixed point, and re-simulates
dirty segments.  For long traces that host loop dominates.  The program
replays the *whole loop* in one launch:

* the arbiter's **settled-prefix cache is a carried array**: the per-epoch
  active-weight sums over a *sliding window* of ``2 * S`` epochs anchored
  at ``max(0, boundary - S)`` -- every read and write a settle can make
  lands within ``S`` epochs of its boundary (the span bound that sizes the
  share window), so settled epochs spill off the left edge as immutable
  facts and the carried state is O(S) regardless of trace length;
* **retired spans are masked, not pruned**: each core lane carries only its
  *current* segment (a replaced segment's end precedes every later
  boundary, so it is a settled fact);
* per-epoch weight sums are folded in the **host arbiter's span order**
  (start epoch, then core index -- the order ``_pump`` appends spans), so
  demand-weighted float weights accumulate in exactly the order
  ``SpanArbiter._rebuild``'s per-epoch fold uses and grants stay
  bit-identical (equal shares reduce to integer counts, exact in any order);
* the host client's **snapshot cache is carried too**: every relaxation
  re-sim records the timing carry at each ``BLOCK``-instruction boundary,
  and later rounds resume from the deepest snapshot whose ``last_grant``
  precedes the dirty boundary (exact: such a carry is fully determined by
  grants in the settled prefix), so each round costs the dirty *suffix*;
* **designs are per-lane data**, so heterogeneous core mixes run in the
  same launch;
* **admission runs inside the loop**: the batcher's reactive policies
  (``occupancy``/``bandwidth``/``predicted``) are replayed from carried
  scalars at the host driver's decision epochs, and the ``fixed`` policy's
  flush epochs are a closed form of the arrival order (its queues enter
  precomputed).

**Domain.**  ``fixed`` (any batch size), ``occupancy``, ``bandwidth`` and
``predicted`` admission, equal or demand-weighted shares (weights measured
per (request shape, core) on the host with the client's own unthrottled
probe), homogeneous or mixed fault-free chips, on a ``cuda`` or ``torch``
chip.  :func:`plan_ex` returns a structured gate reason outside it (see
``GATE_REASONS``) and callers fall back to the incremental client; inside
it, results are **bit-identical** to the numpy client (pinned by
``tests/test_torch_batcher_program.py``): the per-instruction step is the
scan kernels' step (``csrc/fastsim_step.cuh``), every share is the
expression numpy evaluates, weight sums fold in the host's span order, and
with power-of-two ``epoch_cycles`` all boundary arithmetic is exact.

Arrival traces of one request universe share one launch
(:func:`finish_times_many`: one CTA per variant).  Shapes are padded to
power-of-two grids (requests, trace rows, queue depth, share window), as
the reference pads them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np

import torch

from ..core.fastsim import _lane_row, _pow2, run_segment
from ..core.tiling import GemmSpec
from ..core.trace import OP_MM, OP_NOP, CompiledTrace, compiled_trace
from ..kernels import jitarb as kj
from ..kernels.fastsim_scan import pack_code
from .arbiter import MAX_ARBITER_ROUNDS
from .chip import ChipConfig, demands_bandwidth, shared_traffic_bytes, \
    stream_model_params

__all__ = ["plan", "plan_ex", "plan_many", "finish_times",
           "finish_admit_times", "finish_times_many", "Plan",
           "GATE_REASONS"]

#: snapshot granularity of the in-program resume cache (instructions per
#: simulated block); trace columns are padded to a multiple of this
_BLOCK = kj.BLOCK

#: admission policies the program replays in-loop (``fixed`` needs no
#: in-loop decisions; the reactive three do)
MODES = kj.MODES

#: cap on the statically-unrolled admissions per decision epoch (the
#: headroom bound ``floor(budget / min_share)``); configs beyond it gate
_KMAX_CAP = 64

#: every reason :func:`plan_ex` can return (the ``BatchReport.jit_gate``
#: vocabulary); ``None`` means the program settled the trace
GATE_REASONS = (
    "no_requests",          # empty trace: nothing to settle
    "backend",              # chip.backend is neither "cuda" nor "torch"
    "arbitration",          # only the epoch arbiter is lowered
    "faults_active",        # fault plans replay host-side only
    "admission_policy",     # policy outside MODES (phase_aware, ...)
    "batch_size",           # fixed admission needs batch_size >= 1
    "lookahead",            # predicted admission needs lookahead >= 0
    "epoch_not_pow2",       # exact t/E arithmetic needs 2**k epochs
    "infinite_budget",      # unthrottled chips have no share schedule
    "min_share_out_of_range",  # reactive headroom needs 0 < ms <= budget
    "admission_unroll",     # floor(budget/min_share) > _KMAX_CAP
    "hetero_store_model",   # cores disagree on store-byte charging
    "zero_traffic_segment",  # a request shape with no shared traffic
)


# --------------------------------------------------------------------------
# host-side planning
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class Plan:
    """Host-precomputed arrays for one (or many) kernel launches.

    Everything the kernel needs that depends only on the *chip and the
    request shapes* is shared; the per-trace arrays (arrivals, queue
    prefill, shape ids) are what an arrival-rate sweep maps over.  All
    shapes are padded to power-of-two grids, as the reference pads them.
    """

    chip: ChipConfig
    cols: tuple                 # 7 stacked trace columns, each [R, L]
    tr_len: np.ndarray          # [R] i32 true (unpadded) trace lengths
    t2l: np.ndarray             # [U, C] i32 trace row per (shape, core)
    wt: np.ndarray              # [U, C] f64 span weight per (shape, core)
    est: np.ndarray             # [U, C] f64 unthrottled cycle estimates
    arrival: np.ndarray         # [N] f64 arrival epochs (sorted; pads inf)
    qidx: np.ndarray            # [C, maxq] i32 queue prefill (fixed mode)
    qsub: np.ndarray            # [C, maxq] f64 submit epochs (fixed mode)
    qtail0: np.ndarray          # [C] i32 initial queue fill (fixed mode)
    tid_of: np.ndarray          # [N] i32 shape id per sorted rank (pads 0)
    order: np.ndarray           # [n_real] caller index per sorted rank
    adm_fixed: np.ndarray | None  # [n_real] fixed-mode admit epochs
    mode: str                   # one of MODES
    S: int                      # share-window epochs (>= max span length)
    maxq: int
    kmax: int                   # per-decision admission unroll
    min_share: float
    lookahead: int
    n_real: int                 # true request count (<= len(arrival))


def _stack_cols(traces: Sequence[CompiledTrace], length: int) -> tuple:
    padded = [t.padded(length) for t in traces]
    return tuple(
        np.stack([(tr.opcode, tr.r_dst, tr.r_a, tr.r_b, tr.nbytes, tr.tm,
                   tr.reusable)[f] for tr in padded])
        for f in range(7))


def _nop_rows(cols: tuple, tr_len: np.ndarray, rows: int
              ) -> tuple[tuple, np.ndarray]:
    """Pad the trace table to ``rows`` with zero-length NOP rows."""
    r, length = cols[0].shape
    if r >= rows:
        return cols, tr_len
    out = []
    for f, c in enumerate(cols):
        pad = np.full((rows - r, length), OP_NOP if f == 0 else 0,
                      dtype=c.dtype)
        out.append(np.concatenate([c, pad], axis=0))
    return tuple(out), np.concatenate(
        [tr_len, np.zeros(rows - r, dtype=np.int32)])


def plan(traffic: Sequence[tuple[int, Sequence[GemmSpec]]],
         chip: ChipConfig, *, policy: str = "fixed", batch_size: int = 1,
         min_share: float | None = None, lookahead: int = 1
         ) -> Plan | None:
    """:func:`plan_ex` without the gate reason (legacy call shape)."""
    return plan_ex(traffic, chip, policy=policy, batch_size=batch_size,
                   min_share=min_share, lookahead=lookahead)[0]


def plan_ex(traffic: Sequence[tuple[int, Sequence[GemmSpec]]],
            chip: ChipConfig, *, policy: str = "fixed",
            batch_size: int = 1, min_share: float | None = None,
            lookahead: int = 1) -> tuple[Plan | None, str | None]:
    """Precompute the kernel inputs for one arrival trace.

    ``traffic`` is ``(arrival_epoch, specs)`` per request, in caller
    order.  Returns ``(Plan, None)`` inside the program's domain
    and ``(None, reason)`` outside it -- the caller then uses the
    incremental client and can surface the reason (see ``GATE_REASONS``);
    raising here would turn a routing decision into an error.
    """
    if not traffic:
        return None, "no_requests"
    if chip.backend not in ("cuda", "torch"):
        return None, "backend"
    if chip.arbitration != "epoch":
        return None, "arbitration"
    if chip.fault_plan is not None and not chip.fault_plan.is_empty:
        return None, "faults_active"
    if policy not in MODES:
        return None, "admission_policy"
    if policy == "fixed" and batch_size < 1:
        return None, "batch_size"
    if policy == "predicted" and lookahead < 0:
        return None, "lookahead"
    E = chip.epoch_cycles
    if not (math.isfinite(E) and E > 0
            and math.log2(E).is_integer()):
        return None, "epoch_not_pow2"
    budget = chip.bw_bytes_per_cycle
    if not math.isfinite(budget):
        return None, "infinite_budget"

    C = chip.n_cores
    N = len(traffic)
    reactive = policy != "fixed"
    if min_share is None:
        min_share = budget / (2.0 * C)
    if reactive and not (0.0 < min_share <= budget):
        return None, "min_share_out_of_range"
    kmax_true = int(budget / min_share) if reactive else 1
    if reactive and min(N, kmax_true) > _KMAX_CAP:
        return None, "admission_unroll"
    params = [stream_model_params(chip, cs.engine)
              for cs in chip.core_specs]
    if len({pp.store_ports is None for pp in params}) != 1:
        # the chunk treats store-byte charging as static: a chip whose
        # engines disagree on it cannot share one program
        return None, "hetero_store_model"

    # trace rows are per (request shape, tiling policy): cores sharing a
    # policy share rows, a mixed chip gets one row per distinct policy
    pgroups: list = []
    pgroup_of = np.zeros(C, dtype=np.int32)
    for c, cs in enumerate(chip.core_specs):
        for gi, g in enumerate(pgroups):
            if g == cs.policy:
                pgroup_of[c] = gi
                break
        else:
            pgroup_of[c] = len(pgroups)
            pgroups.append(cs.policy)

    order_in = sorted(range(N), key=lambda i: traffic[i][0])
    keys: dict[tuple, int] = {}
    shapes: list[tuple] = []
    tid_of = np.zeros(N, dtype=np.int32)
    arrival = np.zeros(N, dtype=np.float64)
    for r, i in enumerate(order_in):
        ep, specs = traffic[i]
        key = tuple(dataclasses.replace(s, name="") for s in specs)
        u = keys.get(key)
        if u is None:
            u = keys[key] = len(shapes)
            shapes.append(key)
        tid_of[r] = u
        arrival[r] = float(ep)

    rows: dict[tuple[int, int], int] = {}
    traces: list[CompiledTrace] = []
    U = len(shapes)
    t2l = np.zeros((U, C), dtype=np.int32)
    for u, key in enumerate(shapes):
        for c in range(C):
            gi = int(pgroup_of[c])
            t = rows.get((u, gi))
            if t is None:
                t = rows[(u, gi)] = len(traces)
                traces.append(compiled_trace(key, pgroups[gi]))
            t2l[u, c] = t
    for tr in traces:
        if len(tr) == 0 or not demands_bandwidth(chip, None, tr):
            return None, "zero_traffic_segment"

    # span weights: the host client measures each admitted segment's
    # unthrottled demand on its core and maps it through the share
    # policy; weight is a pure function of (shape, core), so the probe
    # runs once per table cell and enters the kernel as data
    share_policy = chip.share_policy
    wt = np.ones((U, C), dtype=np.float64)
    if getattr(share_policy, "needs_demand", False):
        cache: dict[tuple, float] = {}
        for u in range(U):
            for c in range(C):
                engine = chip.core_specs[c].engine
                ck = (int(t2l[u, c]), engine)
                d = cache.get(ck)
                if d is None:
                    tr = traces[t2l[u, c]]
                    res, _, _ = run_segment(
                        tr, engine, stream_model_params(chip, engine))
                    traffic_b = shared_traffic_bytes(chip, None, tr)
                    d = cache[ck] = \
                        traffic_b / res.cycles if res.cycles else 0.0
                wt[u, c] = share_policy.weight(d)

    # queued-cost estimates (free_at placement): the host's own cached
    # per-(spec, core-design) estimator, summed per request shape
    est = np.zeros((U, C), dtype=np.float64)
    if reactive:
        from .scheduler import _estimate_cycles
        for u, key in enumerate(shapes):
            for c in range(C):
                est[u, c] = float(sum(_estimate_cycles(s, chip, c)
                                      for s in key))

    # sound per-segment span bound: at most one span per core is active,
    # each weighing at most its core's table max, so every relaxed share
    # is >= budget * w / wf_max -- a segment's epoch count under any
    # reachable schedule is bounded by its constant-floor-share run
    wf_max = float(np.sum(np.max(wt, axis=0)))
    l_max = 0
    lcache: dict[tuple, int] = {}
    for u in range(U):
        for c in range(C):
            engine = chip.core_specs[c].engine
            floor = budget * wt[u, c] / wf_max
            ck = (int(t2l[u, c]), engine, floor)
            n = lcache.get(ck)
            if n is None:
                res, _, _ = run_segment(
                    traces[t2l[u, c]], engine,
                    stream_model_params(chip, engine, (), E, floor))
                n = lcache[ck] = int(res.cycles // E) + 2
            l_max = max(l_max, n)

    # an open span's visible prefix can reach the horizon set by another
    # lane, at most ~2 span lengths past its own start (see module docs)
    S = _pow2(2 * l_max + 4, lo=8)

    # pad every dynamic extent to a power-of-two grid, as the reference
    # does (the result does not depend on the padding)
    Np = _pow2(N, lo=8)
    arrival_p = np.full(Np, np.inf, dtype=np.float64)
    arrival_p[:N] = arrival
    tid_p = np.zeros(Np, dtype=np.int32)
    tid_p[:N] = tid_of

    adm_fixed = None
    if reactive:
        maxq = Np
        qidx = np.zeros((C, maxq), dtype=np.int32)
        qsub = np.zeros((C, maxq), dtype=np.float64)
        qtail0 = np.zeros(C, dtype=np.int32)
        kmax = _pow2(max(1, min(N, kmax_true)), lo=4)
    else:
        # fixed admission is a closed form of the arrival order: rank r
        # goes to core r % C when group r // batch_size flushes -- at the
        # arrival of the group's last member (the drained partial group
        # flushes with the final arrival)
        qlen = np.zeros(C, dtype=np.int32)
        for r in range(N):
            qlen[r % C] += 1
        maxq = _pow2(int(qlen.max()), lo=1)
        qidx = np.zeros((C, maxq), dtype=np.int32)
        qsub = np.zeros((C, maxq), dtype=np.float64)
        qtail0 = qlen
        adm_fixed = np.zeros(N, dtype=np.float64)
        fill = np.zeros(C, dtype=np.int32)
        for r in range(N):
            g = r // batch_size
            adm_fixed[r] = arrival[min((g + 1) * batch_size - 1, N - 1)]
            c = r % C
            qidx[c, fill[c]] = r
            qsub[c, fill[c]] = adm_fixed[r]
            fill[c] += 1
        kmax = 1

    L = -(-max(len(t) for t in traces) // _BLOCK) * _BLOCK
    L = _pow2(L // _BLOCK, lo=1) * _BLOCK
    cols, tr_len = _nop_rows(
        _stack_cols(traces, L),
        np.asarray([len(t) for t in traces], dtype=np.int32),
        _pow2(len(traces), lo=1))
    Up = _pow2(U, lo=1)
    if Up > U:
        t2l = np.concatenate(
            [t2l, np.zeros((Up - U, C), dtype=np.int32)])
        wt = np.concatenate([wt, np.ones((Up - U, C))])
        est = np.concatenate([est, np.zeros((Up - U, C))])
    return Plan(chip=chip, cols=cols, tr_len=tr_len, t2l=t2l, wt=wt,
                est=est, arrival=arrival_p, qidx=qidx, qsub=qsub,
                qtail0=qtail0, tid_of=tid_p,
                order=np.asarray(order_in, dtype=np.int64),
                adm_fixed=adm_fixed, mode=policy, S=S, maxq=maxq,
                kmax=kmax, min_share=float(min_share),
                lookahead=int(lookahead), n_real=N), None


def _program(chip: ChipConfig):
    """The chip's program: the plain version on a ``torch`` chip (on
    ``chip.device``, the card included), else the wrapper, which launches
    the kernel on the card's tensors of a ``cuda`` chip."""
    return kj.jitarb_plain if chip.backend == "torch" else kj.jitarb


def _inputs(plans: Sequence[Plan]) -> tuple[tuple, dict]:
    """The program's positional tensors (:func:`repro_torch.kernels.jitarb.
    jitarb_cuda` and ``jitarb_plain``) for same-table plans, one variant
    each, on the chip's device, and its keyword scalars."""
    head = plans[0]
    chip = head.chip
    chip.require_card()
    dev = torch.device("cuda" if chip.backend == "cuda" else chip.device)
    op, r_dst, r_a, r_b, nbytes, tm, reus = head.cols
    E, budget = chip.epoch_cycles, chip.bw_bytes_per_cycle
    lane_f = [_lane_row(cs.engine,
                        stream_model_params(chip, cs.engine, (), E, budget))
              for cs in chip.core_specs]

    def put(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    i32, f64 = torch.int32, torch.float64
    args = (put(pack_code(op, r_dst, r_a, r_b, reus), i32),
            put(np.where(op == OP_MM, tm, nbytes), f64),
            put(head.tr_len, i32), put(head.t2l, i32), put(head.wt, f64),
            put(head.est, f64), put(lane_f, f64), put(head.qtail0, i32),
            put(np.stack([p.arrival for p in plans]), f64),
            put(np.stack([p.qidx for p in plans]), i32),
            put(np.stack([p.qsub for p in plans]), f64),
            put(np.stack([p.tid_of for p in plans]), i32))
    kw = dict(E=E, budget=budget, burst=chip.bw_burst_bytes,
              min_share=head.min_share, lookahead=head.lookahead,
              n_real=head.n_real, mode=head.mode, S=head.S, kmax=head.kmax,
              max_rounds=MAX_ARBITER_ROUNDS)
    return args, kw


def finish_admit_times(p: Plan, stats: dict | None = None
                       ) -> tuple[np.ndarray, np.ndarray]:
    """Run one planned trace; (finish cycles, admit epochs) in caller
    order.

    When ``stats`` is given, the program's relaxation-round and
    simulated-block counters are recorded into it (benchmark
    diagnostics).
    """
    args, kw = _inputs([p])
    fin, adm, st = _program(p.chip)(*args, **kw)
    fin = fin[0].cpu().numpy()
    adm = adm[0].cpu().numpy()
    st = st[0].tolist()
    if stats is not None:
        stats["rounds"] = int(st[1])
        stats["blocks"] = int(st[2])
        stats["lane_blocks"] = int(st[4])
    out = np.zeros(p.n_real, dtype=np.float64)
    out[p.order] = fin[:p.n_real]
    adm_out = np.zeros(p.n_real, dtype=np.float64)
    adm_out[p.order] = p.adm_fixed if p.mode == "fixed" \
        else adm[:p.n_real]
    return out, adm_out


def finish_times(p: Plan, stats: dict | None = None) -> np.ndarray:
    """Run one planned trace; absolute finish cycles in caller order."""
    return finish_admit_times(p, stats)[0]


def finish_times_many(plans: Sequence[Plan]) -> list[np.ndarray]:
    """Run a family of same-shape plans (e.g. an arrival-rate sweep) as
    one launch, one CTA per plan.  All plans must come from
    :func:`plan_many`."""
    args, kw = _inputs(plans)
    fin, _, _ = _program(plans[0].chip)(*args, **kw)
    fin = fin.cpu().numpy()
    outs = []
    for v, p in enumerate(plans):
        out = np.zeros(p.n_real, dtype=np.float64)
        out[p.order] = fin[v][:p.n_real]
        outs.append(out)
    return outs


def plan_many(traffics: Sequence[Sequence[tuple[int, Sequence[GemmSpec]]]],
              chip: ChipConfig) -> list[Plan] | None:
    """Plan several ``fixed``-admission arrival traces over the *same*
    request-shape universe so they share one launch (common trace table,
    window and queue bounds).  Returns ``None`` if any variant
    falls outside the domain or the variants disagree on request count."""
    plans = [plan(t, chip) for t in traffics]
    if any(p is None for p in plans) or not plans:
        return None
    if {len(p.arrival) for p in plans} != {len(plans[0].arrival)} \
            or {p.n_real for p in plans} != {plans[0].n_real} \
            or {p.qtail0.tobytes() for p in plans} \
            != {plans[0].qtail0.tobytes()}:
        return None
    C = chip.n_cores
    # unify trace rows by content, then request shapes by their per-core
    # row vector, so every variant indexes one shared table
    row_of: dict[bytes, int] = {}
    all_rows: list[tuple] = []
    all_len: list[int] = []
    L = max(p.cols[0].shape[1] for p in plans)
    shape_of: dict[tuple, int] = {}
    shape_rows: list[tuple] = []
    shape_wt: list[np.ndarray] = []
    shape_est: list[np.ndarray] = []
    remap_u: list[np.ndarray] = []
    for p in plans:
        row_ids = np.zeros(p.cols[0].shape[0], dtype=np.int32)
        for r in range(p.cols[0].shape[0]):
            pad = L - p.cols[0].shape[1]
            row = tuple(
                np.concatenate([c[r], np.full(pad, OP_NOP if f == 0
                                              else 0, dtype=c[r].dtype)])
                for f, c in enumerate(p.cols))
            sig = b"".join(np.ascontiguousarray(a).tobytes()
                           for a in row)
            t = row_of.get(sig)
            if t is None:
                t = row_of[sig] = len(all_rows)
                all_rows.append(row)
                all_len.append(int(p.tr_len[r]))
            row_ids[r] = t
        uids = np.zeros(p.t2l.shape[0], dtype=np.int32)
        for u in range(p.t2l.shape[0]):
            key = tuple(int(row_ids[p.t2l[u, c]]) for c in range(C))
            g = shape_of.get(key)
            if g is None:
                g = shape_of[key] = len(shape_rows)
                shape_rows.append(key)
                shape_wt.append(p.wt[u])
                shape_est.append(p.est[u])
            uids[u] = g
        remap_u.append(uids)
    cols = tuple(np.stack([rw[f] for rw in all_rows]) for f in range(7))
    cols, tr_len = _nop_rows(cols,
                             np.asarray(all_len, dtype=np.int32),
                             _pow2(len(all_rows), lo=1))
    U = _pow2(len(shape_rows), lo=1)
    t2l = np.zeros((U, C), dtype=np.int32)
    wt = np.ones((U, C), dtype=np.float64)
    est = np.zeros((U, C), dtype=np.float64)
    for g, key in enumerate(shape_rows):
        t2l[g] = key
        wt[g] = shape_wt[g]
        est[g] = shape_est[g]
    S = max(p.S for p in plans)
    maxq = max(p.maxq for p in plans)
    out = []
    for p, uids in zip(plans, remap_u):
        qidx = np.zeros((C, maxq), dtype=np.int32)
        qidx[:, :p.qidx.shape[1]] = p.qidx
        qsub = np.zeros((C, maxq), dtype=np.float64)
        qsub[:, :p.qsub.shape[1]] = p.qsub
        out.append(dataclasses.replace(
            p, cols=cols, tr_len=tr_len, t2l=t2l, wt=wt, est=est,
            tid_of=uids[p.tid_of], qidx=qidx, qsub=qsub, S=S, maxq=maxq))
    return out
