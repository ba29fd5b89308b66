"""Register-aware GEMM -> RASA instruction-stream lowering (the "compiler").

This reproduces the software layer the paper relies on (LIBXSMM-generated
AMX microkernels, Algorithm 1): a tiled GEMM

    C[M,N] += A[M,K] @ B[K,N]      (bf16 inputs, fp32 accumulation)

is lowered into ``rasa_tl`` / ``rasa_mm`` / ``rasa_ts`` over the eight tile
registers.  The *register allocation policy* determines the weight-register
reuse pattern that RASA-WLBP exploits, and the spacing between ``rasa_mm``
that accumulate into the same C register (a true dependency through the
array) -- hence "register-aware".

Policy := (mc, nc, a_regs, b_regs): an mc x nc block of C tiles stays
resident in registers while K streams; A tiles cycle through ``a_regs``
registers and B tiles through ``b_regs``.  Algorithm 1 in the paper is
(mc=2, nc=2, a_regs=2, b_regs=2).  The inner rasa_mm order is n-outer /
m-inner so that the B register is reused for (mc-1) consecutive rasa_mm
out of every mc (WLBP hit rate = (mc-1)/mc within a k-step).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Iterator

from .isa import (NUM_TREGS, TILE_K, TILE_M, TILE_N, Instr, Op)


@dataclasses.dataclass(frozen=True)
class RegPolicy:
    mc: int = 2        # C-block tiles in M
    nc: int = 2        # C-block tiles in N
    a_regs: int = 2
    b_regs: int = 2
    #: emit loads of C before accumulation (beta=1) and stores after.
    load_c: bool = True
    #: rasa_mm order within a k-step: "n_outer" (Algorithm 1; B register is
    #: reused (mc-1)/mc of the time) or "m_outer" (B changes every rasa_mm --
    #: the reuse-hostile order; used to bracket trace-level reuse rates).
    mm_order: str = "n_outer"
    #: pad edge tiles to the full 16x32x16 (LIBXSMM/paper behaviour: batch
    #: 1..16 all cost the same -- Fig. 7).  False = AMX-tilecfg-style exact
    #: tiles whose FF stage shortens; a beyond-paper optimization.
    pad_tiles: bool = True

    def __post_init__(self):
        need = self.mc * self.nc + self.a_regs + self.b_regs
        if need > NUM_TREGS:
            raise ValueError(
                f"policy needs {need} tile registers > {NUM_TREGS} available")
        if self.a_regs < 1 or self.b_regs < 1:
            raise ValueError("need at least one A and one B register")

    @property
    def c_base(self) -> int:
        return 0

    @property
    def a_base(self) -> int:
        return self.mc * self.nc

    @property
    def b_base(self) -> int:
        return self.mc * self.nc + self.a_regs


#: the paper's Algorithm-1 policy
ALG1_POLICY = RegPolicy(mc=2, nc=2, a_regs=2, b_regs=2)
#: reuse-maximizing policy found by the design-space benchmark (mc=5 keeps
#: five consecutive rasa_mm on one weight register: WLBP hit rate 4/5)
MAX_REUSE_POLICY = RegPolicy(mc=5, nc=1, a_regs=2, b_regs=1)
#: reuse-hostile order: the B register changes on every rasa_mm (WLBP never
#: fires).  Together with ALG1_POLICY this brackets the effective reuse rate
#: of the paper's LIBXSMM traces (see EXPERIMENTS.md §Fig5).
LOW_REUSE_POLICY = RegPolicy(mc=2, nc=2, a_regs=2, b_regs=2, mm_order="m_outer")


@dataclasses.dataclass(frozen=True)
class GemmSpec:
    name: str
    M: int
    K: int
    N: int

    @property
    def macs(self) -> int:
        return self.M * self.K * self.N

    @property
    def flops(self) -> int:
        return 2 * self.macs

    def tiles(self, tile_m: int = TILE_M, tile_k: int = TILE_K,
              tile_n: int = TILE_N) -> tuple[int, int, int]:
        return (math.ceil(self.M / tile_m),
                math.ceil(self.K / tile_k),
                math.ceil(self.N / tile_n))


@dataclasses.dataclass(frozen=True)
class ReduceSpec:
    """Cross-core reduction of ``ways`` partial C matrices into one.

    Emitted by the K-split partitioner: each of the ``ways`` K-shards
    produces a full [M, N] fp32 partial, and the hosting core merges them
    with element-wise adds.  The merge runs on the core's vector unit, not
    the systolic array, so a ``ReduceSpec`` lowers to a pure memory stream
    -- ``ways`` ``rasa_tl`` loads plus one ``rasa_ts`` store per C tile, no
    ``rasa_mm`` -- and its cost is the load/store port time plus whatever
    the shared-bandwidth arbiter charges for the (ways + 1) x M x N x 4
    bytes of reduction traffic.  ``macs`` is 0: a reduction adds no
    multiply work, so MAC conservation across a K-split holds exactly.
    """

    name: str
    M: int
    N: int
    ways: int

    def __post_init__(self):
        if self.ways < 2:
            raise ValueError("a reduction needs at least 2 partials")

    @property
    def macs(self) -> int:
        return 0

    @property
    def flops(self) -> int:
        #: element-wise adds of the merge ((ways - 1) per C element)
        return (self.ways - 1) * self.M * self.N

    @property
    def bytes_moved(self) -> int:
        """fp32 traffic of the merge: ``ways`` partials in, one result out."""
        return (self.ways + 1) * self.M * self.N * 4

    def tiles(self, tile_m: int = TILE_M, tile_k: int = TILE_K,
              tile_n: int = TILE_N) -> tuple[int, int, int]:
        """C-tile grid as an ``(mt, kt, nt)`` triple; ``kt`` is 0 so the
        ``mt * kt * nt`` rasa_mm cache guards see a reduction's true MM
        count (zero)."""
        return (math.ceil(self.M / tile_m), 0, math.ceil(self.N / tile_n))


def lower_reduce(spec: ReduceSpec, policy: RegPolicy = ALG1_POLICY,
                 tile_m: int = TILE_M, tile_n: int = TILE_N
                 ) -> Iterator[Instr]:
    """Yield the memory stream of a cross-core partial-sum reduction.

    Per C tile: ``rasa_tl`` each of the ``ways`` fp32 partials into
    rotating registers, then ``rasa_ts`` the merged tile.  The partial for
    way ``p`` of tile (mi, ni) is addressed ``("C", mi, ni, p)`` -- a C-kind
    tile, so :func:`repro_torch.core.isa.tile_bytes` charges ``tm * tn * 4``
    bytes, the rate the bandwidth arbiters throttle.  Edge-tile extents
    follow ``policy.pad_tiles`` exactly like :func:`lower_gemm`.
    """
    mt, _, nt = spec.tiles(tile_m=tile_m, tile_n=tile_n)

    def dim(i, full, tile):
        if policy.pad_tiles:
            return tile
        return min(tile, full - i * tile)

    for ni in range(nt):
        for mi in range(mt):
            tm = dim(mi, spec.M, tile_m)
            tn = dim(ni, spec.N, tile_n)
            for p in range(spec.ways):
                yield Instr(Op.TL, dst=p % NUM_TREGS,
                            addr=("C", mi, ni, p), tm=tm, tn=tn)
            yield Instr(Op.TS, src1=0, addr=("C", mi, ni), tm=tm, tn=tn)


def lower_gemm(spec: GemmSpec, policy: RegPolicy = ALG1_POLICY,
               tile_m: int = TILE_M, tile_k: int = TILE_K,
               tile_n: int = TILE_N) -> Iterator[Instr]:
    """Yield the RASA instruction stream for one GEMM.

    Loop nest (LIBXSMM-style, C-block resident):

        for n_blk:                      # steps of nc tiles
          for m_blk:                    # steps of mc tiles
            rasa_tl C[mi,ni] ...        # mc*nc loads (if beta=1)
            for k:                      # K tiles stream
              rasa_tl A[mi,k], B[k,ni]  # as registers cycle
              for ni: for mi:           # n-outer/m-inner => B reuse
                rasa_mm C[mi,ni], A[mi], B[ni]
            rasa_ts C[mi,ni] ...
    """
    mt, kt, nt = spec.tiles(tile_m, tile_k, tile_n)

    def dim(i, t, full, tile):
        """tile-i extent along a dimension: full tile when padding (the
        hardware streams every configured register row), exact otherwise."""
        if policy.pad_tiles:
            return tile
        return min(tile, full - i * tile)

    for n0 in range(0, nt, policy.nc):
        ncur = min(policy.nc, nt - n0)
        for m0 in range(0, mt, policy.mc):
            mcur = min(policy.mc, mt - m0)
            # --- load the C block ------------------------------------------
            if policy.load_c:
                for ni in range(ncur):
                    for mi in range(mcur):
                        yield Instr(Op.TL, dst=policy.c_base + ni * policy.mc + mi,
                                    addr=("C", m0 + mi, n0 + ni),
                                    tm=dim(m0 + mi, mt, spec.M, tile_m),
                                    tn=dim(n0 + ni, nt, spec.N, tile_n))
            # --- stream K ---------------------------------------------------
            for k in range(kt):
                tk = dim(k, kt, spec.K, tile_k)
                preload_a = policy.a_regs >= mcur
                preload_b = policy.b_regs >= ncur
                if preload_a:
                    # all A tiles for this k fit; load once up front
                    for mi in range(mcur):
                        yield Instr(Op.TL, dst=policy.a_base + mi % policy.a_regs,
                                    addr=("A", m0 + mi, k),
                                    tm=dim(m0 + mi, mt, spec.M, tile_m), tk=tk)
                if policy.mm_order == "m_outer" and preload_b:
                    for ni in range(ncur):
                        yield Instr(Op.TL, dst=policy.b_base + ni % policy.b_regs,
                                    addr=("B", k, n0 + ni),
                                    tk=tk, tn=dim(n0 + ni, nt, spec.N, tile_n))

                if policy.mm_order == "n_outer":
                    order = [(mi, ni) for ni in range(ncur) for mi in range(mcur)]
                else:
                    order = [(mi, ni) for mi in range(mcur) for ni in range(ncur)]

                last_b_loaded: int | None = None
                for mi, ni in order:
                    a_reg = policy.a_base + mi % policy.a_regs
                    b_reg = policy.b_base + ni % policy.b_regs
                    # just-in-time (re)loads under register pressure / order
                    need_b = ((policy.mm_order == "n_outer" and mi == order[0][0]
                               and last_b_loaded != ni)
                              or (policy.mm_order == "m_outer" and not preload_b))
                    if need_b:
                        yield Instr(Op.TL, dst=b_reg, addr=("B", k, n0 + ni),
                                    tk=tk, tn=dim(n0 + ni, nt, spec.N, tile_n))
                        last_b_loaded = ni
                    if not preload_a:
                        yield Instr(Op.TL, dst=a_reg, addr=("A", m0 + mi, k),
                                    tm=dim(m0 + mi, mt, spec.M, tile_m), tk=tk)
                    yield Instr(
                        Op.MM,
                        dst=policy.c_base + ni * policy.mc + mi,
                        src1=a_reg, src2=b_reg,
                        tm=dim(m0 + mi, mt, spec.M, tile_m),
                        tk=tk,
                        tn=dim(n0 + ni, nt, spec.N, tile_n))
            # --- store the C block -----------------------------------------
            for ni in range(ncur):
                for mi in range(mcur):
                    yield Instr(Op.TS, src1=policy.c_base + ni * policy.mc + mi,
                                addr=("C", m0 + mi, n0 + ni),
                                tm=dim(m0 + mi, mt, spec.M, tile_m),
                                tn=dim(n0 + ni, nt, spec.N, tile_n))


#: streams whose rasa_mm count exceeds this are not memoized -- a cached
#: million-``Instr`` list would pin hundreds of MB for a stream that is
#: cheaper to regenerate (the compact SoA form in ``repro_torch.core.trace`` has
#: its own, much denser cache).
_STREAM_CACHE_MAX_MM = 150_000


def lower_spec(spec, policy: RegPolicy = ALG1_POLICY) -> Iterator[Instr]:
    """Lower one workload op: a :class:`GemmSpec` through
    :func:`lower_gemm`, a :class:`ReduceSpec` through
    :func:`lower_reduce`."""
    if isinstance(spec, ReduceSpec):
        return lower_reduce(spec, policy)
    return lower_gemm(spec, policy)


@functools.lru_cache(maxsize=256)
def _lowered_stream_cached(spec,
                           policy: RegPolicy) -> tuple[Instr, ...]:
    return tuple(lower_spec(spec, policy))


def lowered_stream(spec,
                   policy: RegPolicy = ALG1_POLICY) -> tuple[Instr, ...]:
    """Memoized :func:`lower_spec`: one lowering per ``(spec, policy)``.

    Design sweeps, scheduler cost probes and arbiter relaxation rounds all
    re-simulate the same stream; lowering it once per key removes the
    biggest constant factor from those loops.  Very large streams (see
    ``_STREAM_CACHE_MAX_MM``) are regenerated instead of cached.
    """
    mt, kt, nt = spec.tiles()
    # GEMMs are guarded by their rasa_mm count; reductions (kt == 0, no
    # rasa_mm at all) by their C-tile count, the driver of stream length.
    if mt * (kt or 1) * nt > _STREAM_CACHE_MAX_MM:
        return tuple(lower_spec(spec, policy))
    return _lowered_stream_cached(spec, policy)


def stream_stats(spec: GemmSpec, policy: RegPolicy = ALG1_POLICY) -> dict:
    """Static properties of the lowered stream (no timing)."""
    n_tl = n_ts = n_mm = 0
    reuse = 0
    last_b: tuple | None = None
    b_contents: dict[int, tuple] = {}
    for ins in lower_gemm(spec, policy):
        if ins.op is Op.TL:
            n_tl += 1
            b_contents[ins.dst] = ins.addr  # type: ignore[index]
            if last_b is not None and ins.dst == last_b[0]:
                last_b = None  # weight register overwritten
        elif ins.op is Op.TS:
            n_ts += 1
        else:
            n_mm += 1
            key = (ins.src2, b_contents.get(ins.src2))
            if last_b == key:
                reuse += 1
            last_b = key
    return {"tl": n_tl, "ts": n_ts, "mm": n_mm,
            "wlbp_hits": reuse,
            "wlbp_rate": reuse / max(n_mm, 1)}
