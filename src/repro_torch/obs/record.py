"""Post-hoc event replay over a compiled trace.

Counterpart of the JAX package's ``obs/record.py``.  :func:`replay_events`
re-runs the inlined scheduling recurrence of
:func:`repro_torch.core.fastsim.run_segment` -- same statement order, same
float arithmetic, same token-bucket walk -- but records what the
simulation lanes deliberately discard: every load/store grant time (and how
much of it was bandwidth throttling) and every ``rasa_mm``'s WL/FF/FS/DR
sub-stage window.  It is a statement-for-statement copy of the reference's
Python loop.

:func:`replay_many` replays many segments at once, one lane each, on the
backend of the chip that ran them, as
:func:`repro_torch.core.fastsim.run_cores` dispatches: ``cuda`` launches the
event-recording scan kernel (``fastsim_events_kernel``, csrc/fastsim.cu:
the shared step of csrc/fastsim_step.cuh with a recorder), ``torch`` runs
its plain version on the chip's device, and ``numpy``/``reference`` (and
``fast`` below its batch threshold) run :func:`replay_events` per segment.
Every path gives the same bits.

The replay consumes exactly the inputs a run already produced -- the
:class:`~repro_torch.core.trace.CompiledTrace` and the
:class:`~repro_torch.core.fastsim.StreamModelParams` holding the final
share schedule the arbiter settled on.  Replaying under the settled
schedule reproduces the run bit for bit (the same property the arbiter's
visible-schedule skip rule relies on).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np

from ..core import fastsim
from ..core.designs import EngineConfig
from ..core.fastsim import StreamModelParams
from ..core.isa import NUM_TREGS
from ..core.trace import OP_MM, OP_TL, OP_TS, CompiledTrace
from ..kernels import fastsim_scan as fsk


@dataclasses.dataclass(frozen=True, eq=False)
class StreamEvents:
    """Per-instruction timing events of one simulated segment.

    Arrays are parallel within each group; ``*_index`` holds the stream
    position (instruction index) of each event.  All times are engine
    cycles relative to the segment's own t=0 (callers offset by the
    segment's start time when placing events on a chip timeline).
    """

    # -- tile loads: grant start, bandwidth-throttle delay, bytes moved
    tl_index: np.ndarray        # int64
    tl_start: np.ndarray        # float64
    tl_stall: np.ndarray        # float64 (start - port_start; 0 unthrottled)
    tl_bytes: np.ndarray        # float64
    # -- tile stores (free stores have stall 0 and start = data-ready)
    ts_index: np.ndarray        # int64
    ts_start: np.ndarray        # float64
    ts_stall: np.ndarray        # float64
    # -- rasa_mm sub-stage windows (wl_start == ff-chain entry for skips)
    mm_index: np.ndarray        # int64
    mm_skip: np.ndarray         # bool (WLBP weight-reload skip)
    mm_wl_start: np.ndarray     # float64
    mm_ff_start: np.ndarray     # float64
    mm_ff_end: np.ndarray       # float64
    mm_fs_end: np.ndarray       # float64
    mm_dr_end: np.ndarray       # float64
    #: replayed makespan -- must agree with the run's TimingResult.cycles
    cycles: float
    bw_stall: float
    wl_skips: int

    def __len__(self) -> int:
        return (len(self.tl_index) + len(self.ts_index)
                + len(self.mm_index))


def replay_events(trace: CompiledTrace, cfg: EngineConfig,
                  params: StreamModelParams) -> StreamEvents:
    """Replay ``trace`` under ``params`` and record every event.

    Mirrors ``run_segment`` statement for statement (the one behavioral
    addition: event capture).  ``params`` must be the exact settled
    schedule the run used -- for closed-batch chips that is
    ``CoreCluster.last_params[i]``, for online segments the span's
    ``_vis`` visible schedule.  The ``numpy`` lane of :func:`replay_many`.
    """
    wl = cfg.wl_cycles
    fs = cfg.fs_cycles
    dr = cfg.dr_cycles
    issue_per_cycle = cfg.core_issue_width * (cfg.core_clock_hz
                                              / cfg.engine_clock_hz)
    load_lat = float(cfg.load_latency)
    wlbp, wls, pipe = cfg.wlbp, cfg.wls, cfg.pipe

    port = params.is_port_model
    inv_load = 1.0 / params.load_ports
    store_free = params.store_ports is None
    inv_store = 1.0 / params.store_ports if not store_free else 0.0
    charge = params.charge_store_bytes and not port
    shares = list(params.shares)
    n_sh = len(shares)
    E = params.epoch_cycles
    sched_end = params.schedule_end
    tail = params.tail_share
    burst = params.burst_bytes
    tokens = burst
    bt = 0.0

    def grant(tokens, bt, t_earliest, n_bytes):
        # == fastsim.run_segment's inlined EpochBandwidthLoadModel._grant
        while bt < t_earliest:
            rate = shares[int(bt // E)] if bt // E < n_sh else tail
            if bt >= sched_end:
                step_end = t_earliest
            else:
                e_end = (int(bt // E) + 1) * E
                step_end = t_earliest if t_earliest < e_end else e_end
            if math.isinf(rate):
                tokens = burst
            else:
                tokens = tokens + rate * (step_end - bt)
                if tokens > burst:
                    tokens = burst
            bt = step_end
        need = n_bytes if n_bytes < burst else burst
        if tokens >= need:
            start = t_earliest
        else:
            t, tk = bt, tokens
            while True:
                rate = shares[int(t // E)] if t // E < n_sh else tail
                if math.isinf(rate):
                    start = t
                    break
                if rate <= 0.0 and t >= sched_end:
                    raise RuntimeError("tail share must be > 0: request can "
                                       "never be granted")
                e_end = (int(t // E) + 1) * E
                if rate > 0.0:
                    t_hit = t + (need - tk) / rate
                    if t_hit <= e_end or t >= sched_end:
                        start = t_hit
                        break
                    tk += rate * (e_end - t)
                t = e_end
            if start < t_earliest:
                start = t_earliest
        while bt < start:
            rate = shares[int(bt // E)] if bt // E < n_sh else tail
            if bt >= sched_end:
                step_end = start
            else:
                e_end = (int(bt // E) + 1) * E
                step_end = start if start < e_end else e_end
            if math.isinf(rate):
                tokens = burst
            else:
                tokens = tokens + rate * (step_end - bt)
                if tokens > burst:
                    tokens = burst
            bt = step_end
        return start, tokens - n_bytes, bt

    op = trace.opcode.tolist()
    rd = trace.r_dst.tolist()
    ra = trace.r_a.tolist()
    rb = trace.r_b.tolist()
    nb = trace.nbytes.tolist()
    tms = trace.tm.tolist()
    reus = trace.reusable.tolist()

    reg_ready = [0.0] * NUM_TREGS
    p_ff_start = -1.0
    p_ff_end = p_fs_end = p_dr_end = 0.0
    have_prev = False
    wl_port_free = 0.0
    t_end = 0.0
    wl_skips = 0
    bw_stall = 0.0
    next_free = store_next = 0.0

    ev_tl: list[tuple[int, float, float, float]] = []
    ev_ts: list[tuple[int, float, float]] = []
    ev_mm: list[tuple[int, bool, float, float, float, float, float]] = []

    for i in range(len(op)):
        o = op[i]
        t_issue = i / issue_per_cycle

        if o == OP_TL:
            port_start = t_issue if t_issue > next_free else next_free
            if port:
                start = port_start
                stall = 0.0
            else:
                start, tokens, bt = grant(tokens, bt, port_start, nb[i])
                stall = start - port_start
                bw_stall += stall
            next_free = start + inv_load
            done = start + load_lat
            reg_ready[rd[i]] = done
            if done > t_end:
                t_end = done
            ev_tl.append((i, start, stall, nb[i]))
            continue

        if o == OP_TS:
            r = reg_ready[ra[i]]
            t_avail = t_issue if t_issue > r else r
            if store_free:
                start = t_avail
                stall = 0.0
                e = t_avail + 1.0
            else:
                port_start = t_avail if t_avail > store_next else store_next
                if charge:
                    start, tokens, bt = grant(tokens, bt, port_start, nb[i])
                    stall = start - port_start
                    bw_stall += stall
                else:
                    start = port_start
                    stall = 0.0
                store_next = start + inv_store
                e = start + 1.0
            if e > t_end:
                t_end = e
            ev_ts.append((i, start, stall))
            continue

        if o != OP_MM:          # OP_NOP padding
            continue

        c, a, b = rd[i], ra[i], rb[i]
        t_ready_ac = max(t_issue, reg_ready[a], reg_ready[c])
        t_ready_b = max(t_issue, reg_ready[b])
        reuse = wlbp and reus[i]

        if reuse:
            # reference reports wl_start = t_ready_b for a skipped WL
            wl_start = t_ready_b
            ff_start = max(t_ready_ac, p_ff_end if have_prev else 0.0)
            wl_skips += 1
        elif wls:
            wl_start = max(t_ready_b, p_ff_start if have_prev else 0.0,
                           wl_port_free)
            hidden = have_prev and wl_start <= p_fs_end
            weights_ready = (wl_start + 1.0) if hidden else (wl_start + wl)
            ff_start = max(t_ready_ac, p_ff_end if have_prev else 0.0,
                           weights_ready)
            wl_port_free = wl_start + wl
        elif pipe:
            wl_start = max(t_ready_b, p_fs_end if have_prev else 0.0,
                           wl_port_free)
            ff_start = max(t_ready_ac, wl_start + wl,
                           p_dr_end if have_prev else 0.0)
            wl_port_free = wl_start + wl
        else:  # BASE
            wl_start = max(t_ready_b, p_dr_end if have_prev else 0.0,
                           wl_port_free)
            ff_start = max(t_ready_ac, wl_start + wl)
            wl_port_free = wl_start + wl

        ff_end = ff_start + tms[i]
        fs_end = ff_end + fs
        dr_end = fs_end + dr
        reg_ready[c] = dr_end
        if dr_end > t_end:
            t_end = dr_end
        p_ff_start, p_ff_end, p_fs_end, p_dr_end = (ff_start, ff_end,
                                                    fs_end, dr_end)
        have_prev = True
        ev_mm.append((i, reuse, wl_start, ff_start, ff_end, fs_end, dr_end))

    def cols(rows, j, dtype=np.float64):
        return np.array([r[j] for r in rows], dtype=dtype)

    return StreamEvents(
        tl_index=cols(ev_tl, 0, np.int64), tl_start=cols(ev_tl, 1),
        tl_stall=cols(ev_tl, 2), tl_bytes=cols(ev_tl, 3),
        ts_index=cols(ev_ts, 0, np.int64), ts_start=cols(ev_ts, 1),
        ts_stall=cols(ev_ts, 2),
        mm_index=cols(ev_mm, 0, np.int64), mm_skip=cols(ev_mm, 1, bool),
        mm_wl_start=cols(ev_mm, 2), mm_ff_start=cols(ev_mm, 3),
        mm_ff_end=cols(ev_mm, 4), mm_fs_end=cols(ev_mm, 5),
        mm_dr_end=cols(ev_mm, 6),
        cycles=float(t_end), bw_stall=float(bw_stall), wl_skips=wl_skips)


def lane_backend(backend: str) -> str:
    """The simulation lane a chip's ``backend`` names for the trace-compiled
    helpers (:func:`replay_many`, :func:`repro_torch.core.fastsim.run_cores`):
    the reference oracle's traces replay on the numpy lane."""
    return "numpy" if backend == "reference" else backend


def _split(trace: CompiledTrace, cfg: EngineConfig, rows: np.ndarray,
           out: np.ndarray) -> StreamEvents:
    """One lane's :class:`StreamEvents` from the event kernel's rows of its
    trace (``rows`` [len(trace), 5]) and its results ``out`` (t_end,
    bw_stall, wl_skips)."""
    op = trace.opcode
    tl, ts, mm = (np.flatnonzero(op == k) for k in (OP_TL, OP_TS, OP_MM))
    r_mm = rows[mm]
    return StreamEvents(
        tl_index=tl.astype(np.int64), tl_start=rows[tl, 0].copy(),
        tl_stall=rows[tl, 1].copy(),
        tl_bytes=trace.nbytes[tl].astype(np.float64),
        ts_index=ts.astype(np.int64), ts_start=rows[ts, 0].copy(),
        ts_stall=rows[ts, 1].copy(),
        mm_index=mm.astype(np.int64),
        mm_skip=np.asarray(trace.reusable[mm], dtype=bool) & bool(cfg.wlbp),
        mm_wl_start=r_mm[:, 0].copy(), mm_ff_start=r_mm[:, 1].copy(),
        mm_ff_end=r_mm[:, 2].copy(), mm_fs_end=r_mm[:, 3].copy(),
        mm_dr_end=r_mm[:, 4].copy(),
        cycles=float(out[0]), bw_stall=float(out[1]), wl_skips=int(out[2]))


def lane_kinds(params: Sequence[StreamModelParams]) -> dict[bool, list[int]]:
    """The lanes of a replay by load-model kind (True: the token bucket),
    one kernel template a launch."""
    groups: dict[bool, list[int]] = {}
    for i, p in enumerate(params):
        groups.setdefault(not p.is_port_model, []).append(i)
    return groups


def event_inputs(traces: Sequence[CompiledTrace], cfgs: Sequence[EngineConfig],
                 params: Sequence[StreamModelParams], idxs: Sequence[int], device):
    """The event replay's tensors on ``device`` (``fsk.fastsim_events``'s
    positional arguments) for the lanes ``idxs`` of one kind, and the
    kind: a copy of the columns a lane, so that every lane writes the
    event rows of its own positions."""
    return fastsim.scan_inputs([traces[i] for i in idxs],
                               [(k, cfgs[i], params[i]) for k, i in enumerate(idxs)], device)


def replay_many(traces: Sequence[CompiledTrace],
                cfgs: Sequence[EngineConfig],
                params: Sequence[StreamModelParams],
                backend: str = "cuda", device="cuda") -> list[StreamEvents]:
    """:func:`replay_events` of every ``(traces[i], cfgs[i], params[i])``,
    one lane each, on a chip's ``backend`` and ``device``.

    The lanes are grouped by load-model kind (:func:`lane_kinds`) and each
    group is resolved as :func:`repro_torch.core.fastsim.run_cores`
    resolves its groups: ``cuda`` is one launch of
    ``fastsim_events_kernel``, ``torch`` its plain version on ``device``,
    ``numpy``/``reference`` (and ``fast`` below
    ``FAST_CUDA_MIN_CORES_INSTRS``) the Python copy.  A ``cuda`` lane
    raises without a card; nothing falls back to the CPU.
    """
    if not (len(traces) == len(cfgs) == len(params)):
        raise ValueError("need one EngineConfig and one StreamModelParams per trace")
    out: list[StreamEvents | None] = [None] * len(traces)
    for bucket, idxs in lane_kinds(params).items():
        total = sum(len(traces[i]) for i in idxs) if len(idxs) > 1 else 0
        concrete = fastsim.resolve_backend(
            lane_backend(backend),
            total if total >= fastsim.FAST_CUDA_MIN_CORES_INSTRS else 0)
        if concrete == "numpy":
            for i in idxs:
                out[i] = replay_events(traces[i], cfgs[i], params[i])
            continue
        args, _ = event_inputs(traces, cfgs, params, idxs,
                               fastsim._device(concrete, device))
        run = fsk.fastsim_events_plain if concrete == "torch" else fsk.fastsim_events
        rows, res = run(*args, bucket=bucket)
        rows, res = rows.cpu().numpy(), res.cpu().numpy()
        lo = args[3][:, 0].cpu().numpy()
        for k, i in enumerate(idxs):
            out[i] = _split(traces[i], cfgs[i], rows[lo[k]:lo[k] + len(traces[i])], res[k])
    return out  # type: ignore[return-value]
