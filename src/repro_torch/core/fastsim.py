"""Simulation lanes over :class:`repro_torch.core.trace.CompiledTrace`.

Counterpart of the JAX package's ``core/fastsim.py``.  The reference
:class:`repro_torch.core.timing.PipelineSimulator` is the exactness oracle:
a pure-Python per-instruction loop over ``Instr`` objects.  Its scheduling
recurrence is a small fixed-size carry -- eight register ready-times, the
previous instruction's four sub-stage times, the WL-port/LSQ-port free
times and the token-bucket state -- and this module runs it three ways:

``numpy``
    A Python loop over the compiled SoA trace, the same arithmetic in the
    same order as the reference simulator (a copy of the JAX package's
    numpy lane).  Bit-exact with the reference by construction.
``cuda``
    The hand-written kernels of :mod:`repro_torch.kernels.fastsim_scan`
    (``csrc/fastsim.cu``): each thread runs one lane's whole recurrence in
    float64, the carry in registers.  A lane is one (trace, design) pair
    (``sweep_trace``, ``sweep_traces``) or one core (``run_cores``); the
    paper's port model runs over the ``rasa_mm`` rows alone (the MM-only
    path below).  They take the places of the JAX package's ``lax.scan``
    lanes and equal the numpy lane bit for bit.
``torch``
    The kernels' plain PyTorch versions, float64 tensors over the lanes, on
    the device the caller names (the CPU, or the card).

``fast`` picks ``cuda`` for batches of at least ``FAST_CUDA_MIN_INSTRS``
lane instructions (``FAST_CUDA_MIN_CORES_INSTRS`` for per-core batches) and
``numpy`` below; above the threshold without a card it raises, as ``cuda``
does.  The entry points default to ``cuda``: a CPU caller asks for
``numpy``, or for ``torch`` with ``device="cpu"``.  The load/store
arbitration of both the paper's idealized port model and the chip-level
token buckets is expressed by one parameter set,
:class:`StreamModelParams`: an empty share schedule with an infinite tail
share reduces exactly to the unthrottled port model (the same reduction
``SharedBandwidthLoadModel`` documents).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np
import torch

from ..kernels import fastsim_scan as fsk
from .designs import EngineConfig
from .isa import NUM_TREGS
from .timing import LoadStreamModel, TimingResult
from .trace import OP_END, OP_MM, OP_TL, OP_TS, CompiledTrace

#: below this many lane instructions (lanes x length) a launch and the
#: host-side packing cost more than the numpy loop, and ``backend="fast"``
#: stays on numpy (the JAX package's ``FAST_JAX_MIN_INSTRS``).
FAST_CUDA_MIN_INSTRS = 32768

#: per-core batches (each lane its own trace) need far more work before
#: the device lane beats the numpy loop (``FAST_JAX_MIN_CORES_INSTRS``).
FAST_CUDA_MIN_CORES_INSTRS = 4_000_000

_BACKENDS = ("fast", "numpy", "torch", "cuda")


def _require_card(what: str) -> None:
    if not torch.cuda.is_available():
        raise RuntimeError(f"{what} needs the card, and there is no CUDA device; "
                           "on the CPU use backend='numpy' or backend='torch' "
                           "with device='cpu'")


def resolve_backend(backend: str, n_instrs: int) -> str:
    """Map a requested backend to a concrete one (``numpy``, ``torch`` or
    ``cuda``).

    ``fast`` auto-selects: ``cuda`` when the batch is large enough (>=
    ``FAST_CUDA_MIN_INSTRS`` lane instructions), ``numpy`` otherwise.
    ``cuda`` -- asked for, or picked by ``fast`` -- raises without a card.
    """
    if backend in ("numpy", "torch"):
        return backend
    if backend == "cuda":
        _require_card("backend='cuda'")
        return "cuda"
    if backend == "fast":
        if n_instrs >= FAST_CUDA_MIN_INSTRS:
            _require_card(f"backend='fast' at {n_instrs} lane instructions")
            return "cuda"
        return "numpy"
    raise ValueError(f"unknown backend {backend!r}; available: {_BACKENDS} "
                     f"(plus 'reference' at the simulator facade)")


def _device(backend: str, device) -> torch.device:
    """Where a device lane runs: ``cuda`` on the card, ``torch`` where the
    caller says (it raises for a card that is not there)."""
    dev = torch.device("cuda" if backend == "cuda" else device)
    if dev.type == "cuda":
        _require_card(f"backend={backend!r} on {dev}")
    return dev


# --------------------------------------------------------------------------
# load/store stream-model parameters
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class StreamModelParams:
    """Declarative form of a :class:`LoadStreamModel` for the fast backends.

    The defaults describe the paper's idealized LSQ (``load_ports`` loads
    per cycle, free stores, no bandwidth cap): an empty epoch schedule whose
    infinite ``tail_share`` never throttles.  Chip-level arbiters fill in
    the token-bucket fields (cf. ``repro_torch.multicore.chip``).
    """

    load_ports: int
    store_ports: int | None = None
    shares: tuple[float, ...] = ()
    epoch_cycles: float = math.inf
    tail_share: float = math.inf
    burst_bytes: float = 0.0
    charge_store_bytes: bool = False

    def __post_init__(self):
        if not self.epoch_cycles > 0:
            raise ValueError("epoch_cycles must be > 0")
        if not self.tail_share > 0:
            raise ValueError("tail_share must be > 0 (requests past the "
                             "schedule could never be granted)")

    @property
    def is_port_model(self) -> bool:
        return not self.shares and math.isinf(self.tail_share)

    @classmethod
    def for_config(cls, cfg: EngineConfig) -> "StreamModelParams":
        return cls(load_ports=cfg.load_ports)

    @classmethod
    def from_model(cls, model: LoadStreamModel) -> "StreamModelParams | None":
        """Extract parameters from a live model, or None when the model is a
        custom subclass whose semantics the fast backends cannot replicate
        (callers then fall back to the reference simulator)."""
        if type(model) is LoadStreamModel:
            return cls(model.load_ports, model.store_ports)
        try:
            from ..multicore.chip import EpochBandwidthLoadModel
        except ImportError:                              # pragma: no cover
            return None
        cls_ = type(model)
        untouched = all(
            getattr(cls_, m) is getattr(EpochBandwidthLoadModel, m)
            for m in ("acquire", "acquire_store", "reset", "_grant",
                      "_advance", "_share_at"))
        if (isinstance(model, EpochBandwidthLoadModel) and untouched
                and not model.record_grants):
            return cls(model.load_ports, model.store_ports,
                       tuple(model.shares), model.epoch_cycles,
                       model.tail_share, model.burst_bytes,
                       model.charge_store_bytes)
        return None

    def make_model(self) -> LoadStreamModel:
        """Instantiate the live model these parameters describe (the numpy
        backend runs the recurrence against real model objects so it stays
        bit-exact with the reference simulator)."""
        if self.is_port_model:
            return LoadStreamModel(self.load_ports, self.store_ports)
        from ..multicore.chip import EpochBandwidthLoadModel
        return EpochBandwidthLoadModel(
            self.load_ports, self.shares, self.epoch_cycles, self.tail_share,
            burst_bytes=self.burst_bytes, store_ports=self.store_ports,
            charge_store_bytes=self.charge_store_bytes)

    @property
    def schedule_end(self) -> float:
        return len(self.shares) * self.epoch_cycles if self.shares else 0.0


def _result(trace: CompiledTrace, cfg: EngineConfig, t_end: float,
            wl_skips: int, bw_stall: float) -> TimingResult:
    return TimingResult(
        cycles=float(t_end), n_mm=trace.n_mm, n_tl=trace.n_tl,
        n_ts=trace.n_ts, wl_skips=int(wl_skips),
        useful_macs=trace.useful_macs,
        peak_macs_per_cycle=cfg.peak_macs_per_cycle,
        bw_stall_cycles=float(bw_stall), schedules=None)


# --------------------------------------------------------------------------
# numpy backend: SoA loop against live LoadStreamModel objects
# --------------------------------------------------------------------------

def run_trace_numpy(trace: CompiledTrace, cfg: EngineConfig,
                    load_model: LoadStreamModel | None = None) -> TimingResult:
    """Run the scheduling recurrence over a compiled trace.

    Mirrors ``PipelineSimulator.run`` statement for statement (same
    arithmetic, same order, same model calls) -- the dirty-bit bookkeeping
    is the only thing replaced, by the trace's precompiled ``reusable``
    bits.  Bit-exact with the reference.
    """
    wl = cfg.wl_cycles
    fs = cfg.fs_cycles
    dr = cfg.dr_cycles
    issue_per_cycle = cfg.core_issue_width * (cfg.core_clock_hz
                                              / cfg.engine_clock_hz)
    load_lat = float(cfg.load_latency)
    model = load_model or LoadStreamModel(cfg.load_ports)
    model.reset()
    acquire = model.acquire
    acquire_store = model.acquire_store
    wlbp, wls, pipe = cfg.wlbp, cfg.wls, cfg.pipe

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

    for i in range(len(op)):
        o = op[i]
        t_issue = i / issue_per_cycle

        if o == OP_TL:
            start, stall = acquire(t_issue, nb[i])
            bw_stall += stall
            done = start + load_lat
            reg_ready[rd[i]] = done
            if done > t_end:
                t_end = done
            continue

        if o == OP_TS:
            r = reg_ready[ra[i]]
            t_avail = t_issue if t_issue > r else r
            start, stall = acquire_store(t_avail, nb[i])
            bw_stall += stall
            e = start + 1.0
            if e > t_end:
                t_end = e
            continue

        if o != OP_MM:          # OP_NOP padding
            continue

        c, a, b = rd[i], ra[i], rb[i]
        t_ready_ac = max(t_issue, reg_ready[a], reg_ready[c])
        t_ready_b = max(t_issue, reg_ready[b])
        reuse = wlbp and reus[i]

        if reuse:
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

    res = _result(trace, cfg, t_end, wl_skips, bw_stall)
    return res


@dataclasses.dataclass(frozen=True)
class SimCarry:
    """Resumable snapshot of the inlined numpy recurrence.

    Captures the complete per-core simulator state after the first ``i``
    instructions of a trace: register ready-times, the previous ``rasa_mm``
    sub-stage times, port/bucket state and the running aggregates.  The
    future of the recurrence depends on the past *only* through this state,
    so re-simulation may resume here instead of replaying the prefix --
    provided the arbiter's share schedule is unchanged on
    ``[0, self.horizon)``: every epoch the first ``i`` instructions could
    observe lies strictly below the horizon (grant walks never look past
    the epoch containing the granted start).

    The online chip model (the JAX package's ``multicore/online.py``)
    snapshots every few thousand instructions and, when an arrival changes
    the schedule from epoch ``x`` on, resumes each in-flight core from its
    latest snapshot with ``horizon <= x * epoch_cycles``.
    """

    i: int                          # instructions consumed (resume index)
    reg_ready: tuple[float, ...]
    p_ff_start: float
    p_ff_end: float
    p_fs_end: float
    p_dr_end: float
    have_prev: bool
    wl_port_free: float
    t_end: float
    wl_skips: int
    bw_stall: float
    next_free: float
    store_next: float
    last_grant: float
    tokens: float
    bt: float

    @property
    def horizon(self) -> float:
        """Latest point in time this state depends on (see class docs)."""
        return max(self.t_end, self.bt, self.next_free, self.store_next,
                   self.wl_port_free, self.last_grant, self.p_dr_end,
                   max(self.reg_ready))


#: snapshot cadence of :func:`run_segment` (instructions between carries);
#: power of two so the per-instruction check stays a single compare.
SNAP_STRIDE = 4096


def _run_numpy_params(trace: CompiledTrace, cfg: EngineConfig,
                      params: StreamModelParams
                      ) -> tuple[TimingResult, float]:
    """The numpy loop with the stream-model arithmetic inlined.

    Identical statement order and float operations as
    :func:`run_trace_numpy` driving a live ``LoadStreamModel`` /
    ``EpochBandwidthLoadModel`` (bit-exact; pinned by the parity suite),
    but without the per-access method-call chain -- the dominant cost of
    bandwidth-throttled runs.  Returns ``(result, last_grant)``.
    """
    res, lg, _ = run_segment(trace, cfg, params)
    return res, lg


def run_segment(trace: CompiledTrace, cfg: EngineConfig,
                params: StreamModelParams,
                carry: SimCarry | None = None,
                snap_stride: int | None = None
                ) -> tuple[TimingResult, float, list[SimCarry]]:
    """Resumable form of the inlined numpy loop.

    With ``carry`` given, simulation resumes at instruction ``carry.i``
    from the saved state instead of replaying the prefix -- exact whenever
    ``params``'s share schedule agrees with the schedule the carry was
    produced under on ``[0, carry.horizon)`` (see :class:`SimCarry`).
    With ``snap_stride`` set, a snapshot is recorded every that many
    instructions; the returned list is ordered by instruction index.
    Returns ``(result, last_grant, snapshots)``.
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
        # == EpochBandwidthLoadModel._grant (with _advance inlined)
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

    if carry is None:
        i0 = 0
        reg_ready = [0.0] * NUM_TREGS
        p_ff_start = -1.0
        p_ff_end = p_fs_end = p_dr_end = 0.0
        have_prev = False
        wl_port_free = 0.0
        t_end = 0.0
        wl_skips = 0
        bw_stall = 0.0
        next_free = store_next = 0.0
        last_grant = 0.0
    else:
        i0 = carry.i
        reg_ready = list(carry.reg_ready)
        p_ff_start = carry.p_ff_start
        p_ff_end = carry.p_ff_end
        p_fs_end = carry.p_fs_end
        p_dr_end = carry.p_dr_end
        have_prev = carry.have_prev
        wl_port_free = carry.wl_port_free
        t_end = carry.t_end
        wl_skips = carry.wl_skips
        bw_stall = carry.bw_stall
        next_free = carry.next_free
        store_next = carry.store_next
        last_grant = carry.last_grant
        tokens = carry.tokens
        bt = carry.bt

    snaps: list[SimCarry] = []
    next_snap = len(op) + 1
    if snap_stride is not None:
        next_snap = (i0 // snap_stride + 1) * snap_stride
        if carry is not None:
            # the boundary snapshot: a resumed run re-emits its carry-in,
            # so the returned list is self-contained -- the state at i0
            # is recorded even when resuming exactly on a stride boundary
            # (callers that re-seed from returned snaps would otherwise
            # lose the i0 checkpoint and replay up to a full stride)
            snaps.append(carry)

    for i in range(i0, len(op)):
        if i == next_snap:
            snaps.append(SimCarry(
                i, tuple(reg_ready), p_ff_start, p_ff_end, p_fs_end,
                p_dr_end, have_prev, wl_port_free, t_end, wl_skips,
                bw_stall, next_free, store_next, last_grant, tokens, bt))
            next_snap += snap_stride
        o = op[i]
        t_issue = i / issue_per_cycle

        if o == OP_TL:
            port_start = t_issue if t_issue > next_free else next_free
            if port:
                start = port_start
            else:
                start, tokens, bt = grant(tokens, bt, port_start, nb[i])
                bw_stall += start - port_start
            next_free = start + inv_load
            if start > last_grant:
                last_grant = start
            done = start + load_lat
            reg_ready[rd[i]] = done
            if done > t_end:
                t_end = done
            continue

        if o == OP_TS:
            r = reg_ready[ra[i]]
            t_avail = t_issue if t_issue > r else r
            if store_free:
                e = t_avail + 1.0
            else:
                port_start = t_avail if t_avail > store_next else store_next
                if charge:
                    start, tokens, bt = grant(tokens, bt, port_start, nb[i])
                    bw_stall += start - port_start
                else:
                    start = port_start
                store_next = start + inv_store
                if start > last_grant:
                    last_grant = start
                e = start + 1.0
            if e > t_end:
                t_end = e
            continue

        if o != OP_MM:          # OP_NOP padding
            continue

        c, a, b = rd[i], ra[i], rb[i]
        t_ready_ac = max(t_issue, reg_ready[a], reg_ready[c])
        t_ready_b = max(t_issue, reg_ready[b])
        reuse = wlbp and reus[i]

        if reuse:
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

    return _result(trace, cfg, t_end, wl_skips, bw_stall), last_grant, snaps


def completed_prefix(trace: CompiledTrace, cfg: EngineConfig,
                     params: StreamModelParams, limit: float,
                     carry: SimCarry | None = None) -> int:
    """How many leading instructions of ``trace`` have fully retired by
    time ``limit`` (engine-local cycles) under ``params``'s schedule.

    This is the deterministic preemption replay
    (:mod:`repro_torch.multicore.faults`): when a core goes down at an epoch
    boundary, the surviving prefix of its in-flight segment is exactly the
    instructions whose *completion* -- load data arrival for ``rasa_tl``,
    store retire for ``rasa_ts``, drain end for ``rasa_mm`` -- lands at or
    before the boundary.  The loop mirrors :func:`run_segment` statement
    for statement (same arithmetic, same order, so the cut index is
    bit-identical on every backend) and stops at the first instruction
    that completes after ``limit``: returns ``k`` such that instructions
    ``[0, k)`` are done and instruction ``k`` is not.

    ``carry`` resumes the replay from a :class:`SimCarry` recorded by
    :func:`run_segment` under the *same* ``params`` schedule.  Valid only
    when ``carry.t_end <= limit``: ``t_end`` is the max completion time
    over instructions ``[0, carry.i)``, so none of them can be the first
    violator and the cut from ``carry.i`` on is bit-identical to the
    full replay -- repeated preemptions of one segment then replay only
    the work past its latest checkpoint instead of its whole history.
    """
    if carry is not None and carry.t_end > limit:
        raise ValueError("completed_prefix carry is past the limit: an "
                         "instruction before carry.i may be the cut")
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
        # == run_segment's inlined EpochBandwidthLoadModel._grant
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

    if carry is None:
        i0 = 0
        reg_ready = [0.0] * NUM_TREGS
        p_ff_start = -1.0
        p_ff_end = p_fs_end = p_dr_end = 0.0
        have_prev = False
        wl_port_free = 0.0
        next_free = store_next = 0.0
    else:
        i0 = carry.i
        reg_ready = list(carry.reg_ready)
        p_ff_start = carry.p_ff_start
        p_ff_end = carry.p_ff_end
        p_fs_end = carry.p_fs_end
        p_dr_end = carry.p_dr_end
        have_prev = carry.have_prev
        wl_port_free = carry.wl_port_free
        next_free = carry.next_free
        store_next = carry.store_next
        tokens = carry.tokens
        bt = carry.bt

    for i in range(i0, len(op)):
        o = op[i]
        t_issue = i / issue_per_cycle

        if o == OP_TL:
            port_start = t_issue if t_issue > next_free else next_free
            if port:
                start = port_start
            else:
                start, tokens, bt = grant(tokens, bt, port_start, nb[i])
            next_free = start + inv_load
            done = start + load_lat
            if done > limit:
                return i
            reg_ready[rd[i]] = done
            continue

        if o == OP_TS:
            r = reg_ready[ra[i]]
            t_avail = t_issue if t_issue > r else r
            if store_free:
                e = t_avail + 1.0
            else:
                port_start = t_avail if t_avail > store_next else store_next
                if charge:
                    start, tokens, bt = grant(tokens, bt, port_start, nb[i])
                else:
                    start = port_start
                store_next = start + inv_store
                e = start + 1.0
            if e > limit:
                return i
            continue

        if o != OP_MM:          # OP_NOP padding: retires instantly
            continue

        c, a, b = rd[i], ra[i], rb[i]
        t_ready_ac = max(t_issue, reg_ready[a], reg_ready[c])
        t_ready_b = max(t_issue, reg_ready[b])
        reuse = wlbp and reus[i]

        if reuse:
            ff_start = max(t_ready_ac, p_ff_end if have_prev else 0.0)
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
        if dr_end > limit:
            return i
        reg_ready[c] = dr_end
        p_ff_start, p_ff_end, p_fs_end, p_dr_end = (ff_start, ff_end,
                                                    fs_end, dr_end)
        have_prev = True

    return len(op)


def _pow2(n: int, lo: int = 16) -> int:
    """The least power of two >= ``n``, at least ``lo``."""
    return max(lo, 1 << max(0, (n - 1)).bit_length())



# --------------------------------------------------------------------------
# MM-only port-model path: compile the memory behaviour into the trace
# --------------------------------------------------------------------------
#
# Under the paper's idealized port model the tile-load stream never couples
# back into the compute recurrence: TL grant times are the running-max
# recurrence  start_k = max(t_issue_k, start_{k-1} + 1/ports),  solvable in
# closed form (max-accumulate) with numpy, and a free store's finish time is
# max(t_issue, producer's DR end) + 1 where the producer of the stored
# register is statically known.  Only the rasa_mm scheduling recurrence is
# genuinely sequential -- so the scan runs over MM rows alone (roughly half
# the stream) with a step that has no arbiter state at all.  This is the
# design-sweep fast path; the token-bucket models keep the full-stream scan.

@dataclasses.dataclass(frozen=True, eq=False)
class _MMAnalysis:
    """Design-independent static analysis of a trace's dataflow."""

    mm_pos: np.ndarray      # [n_mm] stream position (issue index)
    c: np.ndarray           # int32 register ids
    a: np.ndarray
    b: np.ndarray
    #: per-operand last-writer kind: 0 = never written, 1 = TL, 2 = MM
    a_kind: np.ndarray
    b_kind: np.ndarray
    c_kind: np.ndarray
    #: TL ordinal of the writer when kind == 1
    a_tl: np.ndarray
    b_tl: np.ndarray
    c_tl: np.ndarray
    reusable: np.ndarray
    tm: np.ndarray
    #: max stream position of free stores whose producer is MM m (-1: none)
    ts_max_pos: np.ndarray  # [n_mm]
    tl_pos: np.ndarray      # [n_tl] stream positions of TLs
    #: free stores with a static (TL / never-written) source: position,
    #: kind and TL ordinal
    ts_const_pos: np.ndarray
    ts_const_kind: np.ndarray
    ts_const_tl: np.ndarray


def _resolve_writers(wr_pos: dict[int, np.ndarray], is_tl: np.ndarray,
                     tl_ord: np.ndarray, mm_ord: np.ndarray,
                     read_pos: np.ndarray, read_reg: np.ndarray):
    """Last writer strictly before each read: (kind, tl ordinal, mm ordinal).

    kind: 0 = never written, 1 = TL, 2 = MM.
    """
    kind = np.zeros(len(read_pos), dtype=np.int8)
    tl_i = np.zeros(len(read_pos), dtype=np.int32)
    mm_i = np.zeros(len(read_pos), dtype=np.int32)
    for reg, wpos in wr_pos.items():
        mask = read_reg == reg
        if not mask.any() or not len(wpos):
            continue
        k = np.searchsorted(wpos, read_pos[mask], side="left") - 1
        wj = wpos[np.clip(k, 0, None)]
        has = k >= 0
        w_is_tl = is_tl[wj]
        kind[mask] = np.where(has, np.where(w_is_tl, 1, 2), 0)
        tl_i[mask] = np.where(has & w_is_tl, tl_ord[wj], 0)
        mm_i[mask] = np.where(has & ~w_is_tl, mm_ord[wj], 0)
    return kind, tl_i, mm_i


_MM_CACHE = None  # type: ignore[assignment]


def _mm_analysis(trace: CompiledTrace) -> _MMAnalysis:
    global _MM_CACHE
    if _MM_CACHE is None:
        import weakref
        _MM_CACHE = weakref.WeakKeyDictionary()
    hit = _MM_CACHE.get(trace)
    if hit is not None:
        return hit
    op = trace.opcode
    is_tl = op == OP_TL
    is_ts = op == OP_TS
    is_mm = op == OP_MM
    pos = np.arange(len(op), dtype=np.int64)
    tl_ord = (np.cumsum(is_tl) - 1).astype(np.int32)
    mm_ord = (np.cumsum(is_mm) - 1).astype(np.int32)
    writes = is_tl | is_mm
    wr_pos = {reg: pos[writes & (trace.r_dst == reg)]
              for reg in range(NUM_TREGS)}

    mm_pos = pos[is_mm]
    c = trace.r_dst[is_mm]
    a = trace.r_a[is_mm]
    b = trace.r_b[is_mm]
    a_kind, a_tl, _ = _resolve_writers(wr_pos, is_tl, tl_ord, mm_ord,
                                       mm_pos, a)
    b_kind, b_tl, _ = _resolve_writers(wr_pos, is_tl, tl_ord, mm_ord,
                                       mm_pos, b)
    c_kind, c_tl, _ = _resolve_writers(wr_pos, is_tl, tl_ord, mm_ord,
                                       mm_pos, c)

    ts_pos = pos[is_ts]
    ts_src = trace.r_a[is_ts]
    t_kind, t_tl, t_mm = _resolve_writers(wr_pos, is_tl, tl_ord, mm_ord,
                                          ts_pos, ts_src)
    n_mm = int(is_mm.sum())
    ts_max_pos = np.full(n_mm, -1, dtype=np.int64)
    dyn = t_kind == 2
    if dyn.any():
        np.maximum.at(ts_max_pos, t_mm[dyn], ts_pos[dyn])
    out = _MMAnalysis(
        mm_pos=mm_pos, c=c, a=a, b=b,
        a_kind=a_kind, b_kind=b_kind, c_kind=c_kind,
        a_tl=a_tl, b_tl=b_tl, c_tl=c_tl,
        reusable=trace.reusable[is_mm], tm=trace.tm[is_mm],
        ts_max_pos=ts_max_pos, tl_pos=pos[is_tl],
        ts_const_pos=ts_pos[~dyn], ts_const_kind=t_kind[~dyn],
        ts_const_tl=t_tl[~dyn])
    _MM_CACHE[trace] = out
    return out



def _load_sig(cfg: EngineConfig, params: StreamModelParams | None):
    ports = params.load_ports if params is not None else cfg.load_ports
    issue = cfg.core_issue_width * (cfg.core_clock_hz / cfg.engine_clock_hz)
    return (issue, ports, float(cfg.load_latency))


def _port_static(ana: _MMAnalysis, sig) -> tuple[np.ndarray, float]:
    """Per load-signature: TL done times + the static part of ``cycles``."""
    issue, ports, load_lat = sig
    inv = 1.0 / ports
    t_issue_tl = ana.tl_pos / issue
    if len(t_issue_tl):
        drift = np.arange(len(t_issue_tl), dtype=np.float64) * inv
        start = np.maximum.accumulate(t_issue_tl - drift) + drift
        done_tl = start + load_lat
        static_end = float(done_tl.max())
    else:
        done_tl = np.zeros(0, dtype=np.float64)
        static_end = 0.0
    if len(ana.ts_const_pos):
        ready = np.where(ana.ts_const_kind == 1,
                         done_tl[ana.ts_const_tl] if len(done_tl)
                         else 0.0, 0.0)
        contrib = np.maximum(ana.ts_const_pos / issue, ready) + 1.0
        static_end = max(static_end, float(contrib.max()))
    return done_tl, static_end



def _pack_lane(segs: Sequence[CompiledTrace]
               ) -> tuple[CompiledTrace, np.ndarray, list[int]]:
    """Concatenate segment traces with OP_END markers after each.

    Returns the packed trace, the per-instruction *segment-local* index
    array (issue times restart per segment), and the marker positions at
    which the lane's per-segment results are emitted.
    """
    fields: dict[str, list[np.ndarray]] = {k: [] for k in
                                           ("opcode", "r_dst", "r_a", "r_b",
                                            "nbytes", "tm", "macs",
                                            "reusable")}
    idx_parts: list[np.ndarray] = []
    ends: list[int] = []
    pos = 0
    for t in segs:
        for k in fields:
            fields[k].append(getattr(t, k))
        idx_parts.append(np.arange(len(t), dtype=np.float64))
        pos += len(t)
        ends.append(pos)
        pos += 1
        fields["opcode"].append(np.array([OP_END], dtype=np.int32))
        for k in ("r_dst", "r_a", "r_b"):
            fields[k].append(np.zeros(1, dtype=np.int32))
        for k in ("nbytes", "tm", "macs"):
            fields[k].append(np.zeros(1, dtype=np.float64))
        fields["reusable"].append(np.zeros(1, dtype=bool))
        idx_parts.append(np.zeros(1, dtype=np.float64))
    cat = {k: np.concatenate(v) for k, v in fields.items()}
    packed = CompiledTrace(**cat, n_tl=sum(t.n_tl for t in segs),
                           n_ts=sum(t.n_ts for t in segs),
                           n_mm=sum(t.n_mm for t in segs),
                           useful_macs=sum(t.useful_macs for t in segs))
    return packed, np.concatenate(idx_parts), ends



# --------------------------------------------------------------------------
# device lanes: pack traces and lanes for the scan kernels
# --------------------------------------------------------------------------

def _trace_columns(trace: CompiledTrace) -> tuple[np.ndarray, np.ndarray]:
    """The kernel's two columns of a trace: ``code`` packs the opcode, the
    three register ids and the reuse bit (``fsk.pack_code``), ``val`` is
    the tile bytes of a TL/TS and the valid rows of an MM."""
    regs = (trace.r_dst, trace.r_a, trace.r_b)
    if len(trace) and (min(int(r.min()) for r in regs) < 0
                       or max(int(r.max()) for r in regs) >= NUM_TREGS):
        raise ValueError(f"register ids outside [0, {NUM_TREGS})")
    code = fsk.pack_code(trace.opcode, trace.r_dst, trace.r_a, trace.r_b,
                         trace.reusable)
    val = np.where(trace.opcode == OP_MM, trace.tm, trace.nbytes)
    return code, val.astype(np.float64)


def _lane_row(cfg: EngineConfig, params: StreamModelParams) -> list[float]:
    """One lane's design and bucket fields, in ``fsk.LANE_FIELDS`` order,
    each computed as :func:`run_segment` computes it, and the flags that let
    the kernels divide by the epoch and the issue rate exactly by a product
    (``fsk.pow2_or_inf``)."""
    store_free = params.store_ports is None
    issue = cfg.core_issue_width * (cfg.core_clock_hz / cfg.engine_clock_hz)
    return [float(cfg.wl_cycles), float(cfg.fs_cycles), float(cfg.dr_cycles), issue,
            float(cfg.load_latency), float(cfg.wlbp), float(cfg.wls),
            float(cfg.pipe), 1.0 / params.load_ports,
            1.0 / params.store_ports if not store_free else 0.0,
            float(store_free),
            float(params.charge_store_bytes and not params.is_port_model),
            float(params.epoch_cycles), float(params.tail_share),
            float(params.burst_bytes), float(params.schedule_end),
            float(fsk.pow2_or_inf(params.epoch_cycles)), float(fsk.pow2_or_inf(issue))]


def scan_inputs(traces: Sequence[CompiledTrace],
                lanes: Sequence[tuple[int, EngineConfig, StreamModelParams]],
                device) -> tuple[tuple[torch.Tensor, ...], bool]:
    """The full-stream scan's tensors on ``device`` (``fsk.fastsim_scan``'s
    positional arguments) and its template: lane ``(t, cfg, params)``
    simulates ``traces[t]``, and every lane's params must agree on the port
    model against the bucket (one kernel template a launch)."""
    bucket = {not p.is_port_model for _, _, p in lanes}
    if len(bucket) != 1:
        raise ValueError("one launch takes lanes of one load-model kind")
    cols = [_trace_columns(t) for t in traces]
    offs = np.concatenate([[0], np.cumsum([len(t) for t in traces])])
    share_of: dict[tuple, int] = {}
    shares: list[float] = []
    lane_i = []
    for t, _, p in lanes:
        if p.shares not in share_of:
            share_of[p.shares] = len(shares)
            shares.extend(p.shares)
        lane_i.append((offs[t], offs[t + 1], share_of[p.shares], len(p.shares)))

    def put(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    args = (put(np.concatenate([c for c, _ in cols]), torch.int32),
            put(np.concatenate([v for _, v in cols]), torch.float64),
            put([_lane_row(cfg, p) for _, cfg, p in lanes], torch.float64),
            put(np.asarray(lane_i, dtype=np.int64), torch.int64),
            # one spare entry, so that a gather never meets an empty tensor
            put(shares + [0.0], torch.float64))
    return args, bucket.pop()


def _scan(traces: Sequence[CompiledTrace],
          lanes: Sequence[tuple[int, EngineConfig, StreamModelParams]],
          backend: str, device, n_seg: int = 0):
    """Run the full-stream scan (see :func:`scan_inputs`).  Returns the
    per-lane results ``[L, 5]`` (t_end, wl_skips, bw_stall, last_grant,
    bucket walk steps) as float64 numpy, and with ``n_seg`` > 0 (packed
    traces, OP_END after each of their n_seg segments) the per-segment
    rows ``[n_seg, L, 5]``."""
    args, bucket = scan_inputs(traces, lanes, _device(backend, device))
    if backend == "torch":
        out, seg = fsk.fastsim_scan_plain(*args, bucket=bucket, n_seg=n_seg)
    else:
        out, seg = fsk.fastsim_scan(*args, bucket=bucket, n_seg=n_seg)
    return out.cpu().numpy(), (seg.cpu().numpy() if n_seg else None)


def mm_scan_inputs(traces: Sequence[CompiledTrace],
                   cfgs: Sequence[EngineConfig],
                   params: StreamModelParams | None):
    """The MM-only scan's host columns for every (trace, config) lane:
    ``(code, val, lane_f, lane_rows)`` as numpy (``fsk.fastsim_mm_scan``'s
    arguments), each lane's ``(trace, config, load signature)``, and the
    static part of ``cycles`` per (trace, signature).  One block of rows per
    trace and load signature, the 15 columns of the reference's
    ``_sweep_port_mm`` packed into an int32 code and six doubles."""
    codes, vals, lane_f, lane_rows, where = [], [], [], [], []
    static: dict[tuple[int, tuple], float] = {}
    rows = 0
    for ti, trace in enumerate(traces):
        ana = _mm_analysis(trace)
        n_mm = len(ana.mm_pos)
        groups: dict[tuple, list[int]] = {}
        for j, cfg in enumerate(cfgs):
            groups.setdefault(_load_sig(cfg, params), []).append(j)
        for sig, members in groups.items():
            done_tl, static[ti, sig] = _port_static(ana, sig)
            if n_mm == 0:
                continue
            issue = sig[0]

            def const_of(kind, tl_idx):
                v = done_tl[tl_idx] if len(done_tl) else np.zeros(len(tl_idx))
                return np.where(kind == 1, v, 0.0)

            has_ts = ana.ts_max_pos >= 0
            codes.append(fsk.pack_mm_code(
                ana.c, ana.a, ana.b, ana.a_kind == 2, ana.b_kind == 2,
                ana.c_kind == 2, ana.reusable, has_ts))
            vals.append(np.stack(
                [const_of(ana.a_kind, ana.a_tl), const_of(ana.b_kind, ana.b_tl),
                 const_of(ana.c_kind, ana.c_tl), ana.tm, ana.mm_pos / issue,
                 np.where(has_ts, ana.ts_max_pos / issue, 0.0)],
                axis=1).astype(np.float64))
            for j in members:
                c = cfgs[j]
                lane_f.append([float(c.wl_cycles), float(c.fs_cycles),
                               float(c.dr_cycles), float(c.wlbp),
                               float(c.wls), float(c.pipe)])
                lane_rows.append((rows, rows + n_mm))
                where.append((ti, j, sig))
            rows += n_mm
    cols = None
    if where:
        cols = (np.concatenate(codes), np.concatenate(vals),
                np.asarray(lane_f, dtype=np.float64),
                np.asarray(lane_rows, dtype=np.int64))
    return cols, where, static


def _sweep_port_mm(traces: Sequence[CompiledTrace],
                   cfgs: Sequence[EngineConfig],
                   params: StreamModelParams | None, backend: str,
                   device) -> list[list[TimingResult]]:
    """The MM-only sweep (see section comment above) of every (trace,
    config) pair in one launch: a lane per pair."""
    cols, where, static = mm_scan_inputs(traces, cfgs, params)
    results: list[list[TimingResult | None]] = [[None] * len(cfgs)
                                                for _ in traces]
    if where:
        dev = _device(backend, device)
        args = tuple(torch.as_tensor(c, device=dev) for c in cols)
        if backend == "torch":
            out = fsk.fastsim_mm_scan_plain(*args)
        else:
            out = fsk.fastsim_mm_scan(*args)
        out = out.cpu().numpy()
        for (ti, j, sig), (t_end, skips) in zip(where, out):
            results[ti][j] = _result(traces[ti], cfgs[j],
                                     max(float(t_end), static[ti, sig]),
                                     int(skips), 0.0)
    for ti, trace in enumerate(traces):
        for j, cfg in enumerate(cfgs):
            if results[ti][j] is None:              # a trace with no rasa_mm
                results[ti][j] = _result(trace, cfg,
                                         static[ti, _load_sig(cfg, params)],
                                         0, 0.0)
    return results  # type: ignore[return-value]


def sweep_trace(trace: CompiledTrace, cfgs: Sequence[EngineConfig],
                params: StreamModelParams | None = None,
                backend: str = "cuda", device="cuda") -> list[TimingResult]:
    """Simulate one compiled trace under many engine configs at once.

    With ``params=None`` each config gets the paper's idealized port model
    (``LoadStreamModel(cfg.load_ports)``); an explicit ``params`` applies
    to every config.  ``device`` is where ``backend="torch"`` runs.
    """
    if not cfgs:
        return []
    # a single design lane cannot amortize a launch: "fast" keeps one-off
    # simulations on the numpy loop (an explicit "cuda" is still honored)
    work = len(trace) * len(cfgs) if len(cfgs) > 1 else 0
    concrete = resolve_backend(backend, work)
    if concrete == "numpy":
        return [_run_numpy_params(
                    trace, cfg,
                    params or StreamModelParams.for_config(cfg))[0]
                for cfg in cfgs]
    base = params or StreamModelParams(load_ports=1)
    if base.is_port_model and base.store_ports is None:
        return _sweep_port_mm([trace], cfgs, params, concrete, device)[0]
    out, _ = _scan([trace], [(0, cfg, base) for cfg in cfgs], concrete, device)
    return [_result(trace, cfg, r[0], r[1], r[2]) for cfg, r in zip(cfgs, out)]


def run_cores(traces: Sequence[CompiledTrace],
              cfg: EngineConfig | Sequence[EngineConfig],
              params: Sequence[StreamModelParams],
              backend: str = "cuda", device="cuda"
              ) -> list[tuple[TimingResult, float]]:
    """Simulate one trace per core.

    ``cfg`` is one engine config shared by every core, or one per core
    (heterogeneous chips).  ``params[i]`` describes core *i*'s arbiter;
    schedules may differ per core in both ``shares`` and ``tail_share`` --
    exactly what weighted epoch arbitration produces.  Returns
    ``(TimingResult, last_grant)`` per core; ``last_grant`` is the activity
    horizon the chip-level relaxation reads back.
    """
    if len(traces) != len(params):
        raise ValueError("need one StreamModelParams per trace")
    if not traces:
        return []
    cfgs = [cfg] * len(traces) if isinstance(cfg, EngineConfig) else list(cfg)
    if len(cfgs) != len(traces):
        raise ValueError("need one EngineConfig per trace (or a single "
                         "shared one)")
    # the reference's lane groups: same engine config and bucket *shape*
    # (port vs. bucket model, epoch length, burst, store accounting);
    # shares/tails vary per lane.  "fast" is resolved per group.
    groups: dict[tuple, list[int]] = {}
    for i, (c, p) in enumerate(zip(cfgs, params)):
        key = (c, p.is_port_model, p.epoch_cycles, p.burst_bytes,
               p.charge_store_bytes, p.load_ports, p.store_ports)
        groups.setdefault(key, []).append(i)
    out: list[tuple[TimingResult, float] | None] = [None] * len(traces)
    for idxs in groups.values():
        # each lane reads its own trace, so the device lane only beats the
        # numpy loop on large batches (and never for one lane)
        total = sum(len(traces[i]) for i in idxs) if len(idxs) > 1 else 0
        concrete = resolve_backend(
            backend, total if total >= FAST_CUDA_MIN_CORES_INSTRS else 0)
        if concrete == "numpy":
            for i in idxs:
                out[i] = _run_numpy_params(traces[i], cfgs[i], params[i])
            continue
        res, _ = _scan([traces[i] for i in idxs],
                       [(k, cfgs[i], params[i]) for k, i in enumerate(idxs)],
                       concrete, device)
        for i, r in zip(idxs, res):
            out[i] = (_result(traces[i], cfgs[i], r[0], r[1], r[2]),
                      float(r[3]))
    return out  # type: ignore[return-value]


def sweep_traces(traces: Sequence[CompiledTrace],
                 cfgs: Sequence[EngineConfig],
                 params: StreamModelParams | None = None,
                 backend: str = "cuda", device="cuda"
                 ) -> list[list[TimingResult]]:
    """Simulate the full (trace x config) grid: ``out[i][j]`` is trace *i*
    under config *j*.

    The device lanes pack all traces back to back into *one* shared stream
    (OP_END markers emit each segment's results and reset the lane state),
    one lane per config; under the port model the MM-only scan takes every
    (trace, config) pair in one launch.
    """
    if not traces or not cfgs:
        return [[] for _ in traces]
    total = sum(len(t) for t in traces) * len(cfgs)
    concrete = resolve_backend(backend, total)
    if concrete == "numpy":
        return [[_run_numpy_params(
                    t, cfg, params or StreamModelParams.for_config(cfg))[0]
                 for cfg in cfgs] for t in traces]
    base = params or StreamModelParams(load_ports=1)
    if base.is_port_model and base.store_ports is None:
        return _sweep_port_mm(traces, cfgs, params, concrete, device)
    packed, _, _ = _pack_lane(traces)
    _, seg = _scan([packed], [(0, cfg, base) for cfg in cfgs], concrete,
                   device, n_seg=len(traces))
    return [[_result(traces[s], cfgs[j], seg[s, j, 0], seg[s, j, 1],
                     seg[s, j, 2]) for j in range(len(cfgs))]
            for s in range(len(traces))]
