"""Trace compilation: lower an instruction stream once into a cached
structure-of-arrays ``CompiledTrace``.

Every simulation backend consumes the same per-instruction facts -- opcode,
register ids, valid tile dims, tile bytes -- but the reference
:class:`repro_torch.core.timing.PipelineSimulator` re-derives them from ``Instr``
dataclasses on every run (attribute access, ``tile_bytes`` calls, dirty-bit
bookkeeping through :class:`repro_torch.core.isa.TileRegisterFile`).  A
``CompiledTrace`` hoists all of it into flat numpy arrays so that the fast
backends (:mod:`repro_torch.core.fastsim`) touch only scalars inside the timing
recurrence, and the CUDA scan kernels can consume the arrays directly.

The key observation that makes the weight-reuse (WLBP) decision compilable:
the dirty-bit state the reference simulator tracks at *run* time is a pure
function of the instruction sequence -- timing never feeds back into it.
``rasa_tl`` bumps the destination register's generation; every ``rasa_mm``
bumps its C register's generation and then latches ``(B, gen(B))``.  So the
per-``rasa_mm`` "B register clean and still latched" bit is precomputed here
by replaying exactly that bookkeeping (see ``test_fastsim`` for the parity
suite that pins this against the runtime ``TileRegisterFile``).

Traces are cached per ``(specs, policy)`` -- the lowering and the replay are
paid once per workload, not once per design x arbiter round x probe.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Iterable, Sequence

import numpy as np

from .isa import NUM_TREGS, Instr, Op, tile_bytes
from .tiling import GemmSpec, RegPolicy, lowered_stream

#: fastsim opcode encoding.  ``NOP`` pads batched traces to a common length
#: and leaves every piece of simulator state untouched; ``END`` is a
#: segment separator for lane-packed batches (emit the lane's results, then
#: reset the simulator state for the next packed stream).
OP_TL, OP_TS, OP_MM, OP_NOP, OP_END = 0, 1, 2, 3, 4


@dataclasses.dataclass(frozen=True, eq=False)
class CompiledTrace:
    """Structure-of-arrays form of one instruction stream.

    All arrays have length ``len(self)``; entries of fields that do not
    apply to an opcode (e.g. ``r_b`` of a ``rasa_tl``) are zero.
    Identity-hashed (``eq=False``): derived analyses are cached per trace
    object (see ``fastsim._mm_analysis``).
    """

    #: OP_TL / OP_TS / OP_MM (OP_NOP only appears in padded traces)
    opcode: np.ndarray          # int32
    #: destination register: C for MM, dst for TL (0 for TS)
    r_dst: np.ndarray           # int32
    #: first source: A for MM, the stored register for TS (0 for TL)
    r_a: np.ndarray             # int32
    #: second source: B for MM (0 otherwise)
    r_b: np.ndarray             # int32
    #: memory traffic of TL/TS accesses (:func:`repro_torch.core.isa.tile_bytes`)
    nbytes: np.ndarray          # float64
    #: valid tile rows of an MM (drives the FF stage length)
    tm: np.ndarray              # float64
    #: useful MACs of an MM (tm*tk*tn; 0 otherwise)
    macs: np.ndarray            # float64
    #: static WLBP-reusability of an MM's B register (see module docstring)
    reusable: np.ndarray        # bool
    n_tl: int
    n_ts: int
    n_mm: int
    useful_macs: float

    def __len__(self) -> int:
        return int(self.opcode.shape[0])

    def padded(self, length: int) -> "CompiledTrace":
        """Return a copy padded with NOPs to ``length`` instructions."""
        n = len(self)
        if length < n:
            raise ValueError(f"cannot pad length-{n} trace to {length}")
        if length == n:
            return self
        pad = length - n

        def ext(a: np.ndarray, fill=0) -> np.ndarray:
            return np.concatenate([a, np.full(pad, fill, dtype=a.dtype)])

        return dataclasses.replace(
            self, opcode=ext(self.opcode, OP_NOP), r_dst=ext(self.r_dst),
            r_a=ext(self.r_a), r_b=ext(self.r_b), nbytes=ext(self.nbytes),
            tm=ext(self.tm), macs=ext(self.macs), reusable=ext(self.reusable))


def slice_trace(trace: CompiledTrace, k: int) -> CompiledTrace:
    """The trace of instructions ``[k, len(trace))`` as a fresh stream.

    Equivalent to ``compile_stream(stream[k:])`` (pinned by
    ``tests/test_faults.py``) but built from array slices -- the preemption
    remainder of a long segment must not pay a full re-lowering.  The only
    per-instruction fact that depends on the cut is the first in-slice
    ``rasa_mm``'s WLBP reusability: its predecessor MM is gone, so the
    fresh engine's weight latch is empty and it must reload
    (``reusable=False``).  Every later MM compares against an in-slice
    predecessor with identical writes in between, so its bit is unchanged.
    """
    n = len(trace)
    if not 0 <= k <= n:
        raise ValueError(f"slice index {k} out of range for length-{n} trace")
    if k == 0:
        return trace
    opcode = trace.opcode[k:]
    tm = trace.tm[k:]
    macs = trace.macs[k:]
    reusable = trace.reusable[k:]
    is_mm = opcode == OP_MM
    mm_idx = np.flatnonzero(is_mm)
    if len(mm_idx) and reusable[mm_idx[0]]:
        reusable = reusable.copy()
        reusable[mm_idx[0]] = False
    return CompiledTrace(
        opcode=opcode, r_dst=trace.r_dst[k:], r_a=trace.r_a[k:],
        r_b=trace.r_b[k:], nbytes=trace.nbytes[k:], tm=tm, macs=macs,
        reusable=reusable,
        n_tl=int((opcode == OP_TL).sum()), n_ts=int((opcode == OP_TS).sum()),
        n_mm=int(is_mm.sum()), useful_macs=float(macs.sum()),
    )


_OP_CODE = {Op.TL: OP_TL, Op.TS: OP_TS, Op.MM: OP_MM}
_MAT_CODE = {"A": 0, "B": 1}                 # everything else is a C tile


def compile_stream(stream: Iterable[Instr]) -> CompiledTrace:
    """Lower an instruction stream into its :class:`CompiledTrace`.

    Field extraction and the dirty-bit replay are vectorized; the replay
    mirrors ``PipelineSimulator.run``'s event order exactly: an MM's reuse
    check reads generations *before* its own C write, and the latch is
    taken *after* it -- so ``reusable[k]`` holds iff MM ``k`` names the same
    B register as MM ``k-1`` and no write touched that register strictly
    between the two (MM ``k-1``'s own C write included in the baseline).
    """
    instrs = stream if isinstance(stream, (list, tuple)) else list(stream)
    n = len(instrs)
    f64, i32 = np.float64, np.int32
    opcode = np.fromiter((_OP_CODE[i.op] for i in instrs), i32, n)
    dst = np.fromiter(((i.dst or 0) for i in instrs), i32, n)
    src1 = np.fromiter(((i.src1 or 0) for i in instrs), i32, n)
    src2 = np.fromiter(((i.src2 or 0) for i in instrs), i32, n)
    tm = np.fromiter((i.tm for i in instrs), f64, n)
    tk = np.fromiter((i.tk for i in instrs), f64, n)
    tn = np.fromiter((i.tn for i in instrs), f64, n)
    mat = np.fromiter((_MAT_CODE.get(i.addr[0] if i.addr else "C", 2)
                       for i in instrs), i32, n)
    is_tl = opcode == OP_TL
    is_ts = opcode == OP_TS
    is_mm = opcode == OP_MM

    # tile_bytes: bf16 A (tm*tk*2) / bf16 B (tk*tn*2) / fp32 C (tm*tn*4)
    nbytes = np.where(mat == 0, tm * tk * 2.0,
                      np.where(mat == 1, tk * tn * 2.0, tm * tn * 4.0))
    nbytes = np.where(is_tl | is_ts, nbytes, 0.0)
    macs = np.where(is_mm, tm * tk * tn, 0.0)

    # WLBP reuse replay (see docstring): per B register, count writes
    # strictly before each of the two probe positions with searchsorted.
    reusable = np.zeros(n, dtype=bool)
    if is_mm.any():
        pos = np.arange(n, dtype=np.int64)
        writes = is_tl | is_mm
        mm_pos = pos[is_mm]
        mm_b = src2[is_mm]
        ok = np.zeros(len(mm_pos), dtype=bool)
        same_b = np.zeros(len(mm_pos), dtype=bool)
        same_b[1:] = mm_b[1:] == mm_b[:-1]
        for reg in np.unique(mm_b):
            wpos = pos[writes & (dst == reg)]
            sel = np.flatnonzero(mm_b == reg)
            sel = sel[sel > 0]
            if not len(sel):
                continue
            before_k = np.searchsorted(wpos, mm_pos[sel])
            after_prev = np.searchsorted(wpos, mm_pos[sel - 1] + 1)
            ok[sel] = before_k == after_prev
        reusable[is_mm] = same_b & ok

    return CompiledTrace(
        opcode=opcode,
        r_dst=np.where(is_tl | is_mm, dst, 0).astype(i32),
        r_a=np.where(is_mm | is_ts, src1, 0).astype(i32),
        r_b=np.where(is_mm, src2, 0).astype(i32),
        nbytes=nbytes.astype(f64),
        tm=np.where(is_mm, tm, 0.0).astype(f64),
        macs=macs.astype(f64),
        reusable=reusable,
        n_tl=int(is_tl.sum()), n_ts=int(is_ts.sum()),
        n_mm=int(is_mm.sum()), useful_macs=float(macs.sum()),
    )


def _chain(specs: Sequence[GemmSpec], policy: RegPolicy) -> Iterable[Instr]:
    for spec in specs:
        yield from lowered_stream(spec, policy)


#: workloads above this many rasa_mm are compiled fresh instead of cached
#: (the SoA arrays are ~42 B/instr; a handful of multi-million-instruction
#: traces would otherwise pin GBs across a long sweep).
_TRACE_CACHE_MAX_MM = 600_000


@functools.lru_cache(maxsize=64)
def _compiled_trace_cached(specs: tuple[GemmSpec, ...],
                           policy: RegPolicy) -> CompiledTrace:
    return compile_stream(_chain(specs, policy))


def compiled_trace(specs: tuple[GemmSpec, ...],
                   policy: RegPolicy) -> CompiledTrace:
    """The cached ``CompiledTrace`` of ``specs`` lowered back to back.

    Register/dirty-bit state deliberately carries across GEMM boundaries,
    exactly as the reference simulator sees the concatenated stream.
    """
    mm = sum(m * k * n for m, k, n in (s.tiles() for s in specs))
    if mm > _TRACE_CACHE_MAX_MM:
        return compile_stream(_chain(specs, policy))
    return _compiled_trace_cached(specs, policy)


def gemm_trace(spec: GemmSpec, policy: RegPolicy) -> CompiledTrace:
    """Cached trace of a single GEMM (the ``simulate()`` fast path)."""
    return compiled_trace((spec,), policy)
