"""RASA instruction set + architectural tile-register file.

The paper (§IV-A) assumes an AMX-inspired ISA:

* eight architectural tile registers ``treg0-7``, each 16 rows x 64 B (1 KB);
* ``rasa_tl  treg, ptr``   -- load a tile from memory into a register;
* ``rasa_ts  ptr, treg``   -- store a tile register back to memory;
* ``rasa_mm  tC, tA, tB``  -- C[16x16,fp32] += A[16x32,bf16] @ B[32x16,bf16].

A bf16 tile register holds 16 rows x 32 cols (64 B of bf16 per row); an fp32
tile register holds 16 x 16.  The matrix engine is a weight-stationary
systolic array of ``rows x cols`` PEs (32x16 baseline; 16x16 with the DM
optimization), so one ``rasa_mm`` maps T_M=16, T_K=32, T_N=16.

Each tile register carries a *dirty bit* (paper §IV-B, WLBP): set on any
write (``rasa_tl`` or being an ``rasa_mm`` destination), cleared when the
register's content is latched into the array as the stationary operand.  A
subsequent ``rasa_mm`` whose B register is clean may skip its WL stage.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Iterable, Iterator, Sequence

NUM_TREGS = 8
TREG_ROWS = 16          # rows per tile register
TREG_ROW_BYTES = 64     # bytes per row
TREG_BYTES = TREG_ROWS * TREG_ROW_BYTES

# Logical tile dims of one rasa_mm at bf16-in/fp32-out (AMX-style).
TILE_M = 16             # rows of A / C
TILE_K = 32             # cols of A / rows of B  (bf16: 64B row = 32 elements)
TILE_N = 16             # cols of B / C          (fp32: 64B row = 16 elements)


class Op(enum.Enum):
    TL = "rasa_tl"
    TS = "rasa_ts"
    MM = "rasa_mm"


@dataclasses.dataclass(frozen=True)
class Instr:
    """One RASA instruction.

    ``addr`` is an abstract tile identifier (matrix name, tile row, tile col)
    used both by the functional engine to fetch operand data and by the
    timing model to attribute memory traffic.  For MM: dst/src1/src2 are
    (C, A, B) register ids.  ``tm/tk/tn`` give the *valid* sub-tile dims so
    edge tiles of a GEMM are modelled and executed exactly.
    """

    op: Op
    dst: int | None = None            # treg id (TL, MM) -- None for TS
    src1: int | None = None           # A treg (MM) / treg to store (TS)
    src2: int | None = None           # B treg (MM)
    addr: tuple | None = None         # abstract memory tile id (TL / TS)
    tm: int = TILE_M
    tk: int = TILE_K
    tn: int = TILE_N

    def __post_init__(self):
        if self.op is Op.MM:
            assert self.dst is not None and self.src1 is not None and self.src2 is not None
        elif self.op is Op.TL:
            assert self.dst is not None and self.addr is not None
        elif self.op is Op.TS:
            assert self.src1 is not None and self.addr is not None

    def __str__(self) -> str:  # pragma: no cover - debug aid
        if self.op is Op.TL:
            return f"rasa_tl  treg{self.dst}, {self.addr}"
        if self.op is Op.TS:
            return f"rasa_ts  {self.addr}, treg{self.src1}"
        return f"rasa_mm  treg{self.dst}, treg{self.src1}, treg{self.src2}"


def tile_bytes(ins: Instr) -> int:
    """Memory traffic of one tile access: bf16 A/B operands, fp32 C tiles.

    Used by bandwidth-aware load models (``addr[0]`` names the matrix).
    """
    mat = ins.addr[0] if ins.addr else "C"
    if mat == "A":
        return ins.tm * ins.tk * 2
    if mat == "B":
        return ins.tk * ins.tn * 2
    return ins.tm * ins.tn * 4


@dataclasses.dataclass
class TregState:
    """Architectural state of one tile register as seen by the scheduler."""

    #: abstract id of the value currently held (None = undefined)
    value: tuple | None = None
    #: dirty bit -- set on write, cleared when latched as stationary operand
    dirty: bool = True
    #: generation counter; bumped on every write (disambiguates reuse checks)
    generation: int = 0


class TileRegisterFile:
    """Tracks register contents + dirty bits for WLBP reuse detection.

    This mirrors the microarchitectural bookkeeping the paper adds: one dirty
    bit per register (8 bits total).  The *timing* model queries
    :meth:`mm_weight_reusable` at rename time; the *functional* engine keeps
    its own data copies (see ``engine.py``).
    """

    def __init__(self, num_regs: int = NUM_TREGS):
        self.regs = [TregState() for _ in range(num_regs)]
        #: (reg id, generation) of the weights currently latched in the array
        self._latched: tuple[int, int] | None = None

    def write(self, reg: int, value: tuple | None) -> None:
        st = self.regs[reg]
        st.value = value
        st.dirty = True
        st.generation += 1

    def mm_weight_reusable(self, b_reg: int) -> bool:
        """True iff this MM's B register equals the latched weights and has
        not been written since they were latched (clean dirty bit)."""
        if self._latched is None:
            return False
        reg, gen = self._latched
        return reg == b_reg and self.regs[b_reg].generation == gen

    def latch_weights(self, b_reg: int) -> None:
        self.regs[b_reg].dirty = False
        self._latched = (b_reg, self.regs[b_reg].generation)

    def invalidate_latch(self) -> None:
        self._latched = None


def validate_stream(stream: Iterable[Instr]) -> None:
    """Static sanity checks on an instruction stream (used by tests)."""
    defined: set[int] = set()
    for i, ins in enumerate(stream):
        if ins.op is Op.TL:
            defined.add(ins.dst)  # type: ignore[arg-type]
        elif ins.op is Op.MM:
            for r, role in ((ins.dst, "C"), (ins.src1, "A"), (ins.src2, "B")):
                if r not in defined:
                    raise ValueError(f"instr {i}: {role} register treg{r} used before defined")
        elif ins.op is Op.TS:
            if ins.src1 not in defined:
                raise ValueError(f"instr {i}: stored register treg{ins.src1} undefined")


def count_ops(stream: Sequence[Instr]) -> dict[str, int]:
    out = {"tl": 0, "ts": 0, "mm": 0}
    for ins in stream:
        out[{Op.TL: "tl", Op.TS: "ts", Op.MM: "mm"}[ins.op]] += 1
    return out


def mm_instrs(stream: Iterable[Instr]) -> Iterator[Instr]:
    return (i for i in stream if i.op is Op.MM)
