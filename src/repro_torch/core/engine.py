"""Functional execution of RASA instruction streams (numerics oracle).

Counterpart of the JAX package's ``core/engine.py``, in torch.  Executes a
lowered instruction stream against real matrices with the engine's
mixed-precision semantics -- bf16 operands, fp32 accumulation -- exactly as
the paper's PEs do ("BF16 in, FP32 out", §IV-B).  ``torch.bfloat16``
rounds to nearest even, as the reference's ``ml_dtypes.bfloat16`` does, so
the operands' bits agree.  Used by tests to prove that
``tiling.lower_gemm`` is a correct compiler for every register policy and
edge-tile case.  Everything runs on the device of the tensors given.
"""

from __future__ import annotations

import torch

from .isa import NUM_TREGS, TILE_K, TILE_M, TILE_N, Instr, Op
from .tiling import GemmSpec, RegPolicy, lower_gemm

BF16 = torch.bfloat16


class FunctionalEngine:
    """Executes rasa_tl / rasa_mm / rasa_ts against torch tile storage."""

    def __init__(self, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                 tile_m: int = TILE_M, tile_k: int = TILE_K, tile_n: int = TILE_N):
        self.tile_m, self.tile_k, self.tile_n = tile_m, tile_k, tile_n
        self.a = torch.as_tensor(a).to(BF16)
        self.b = torch.as_tensor(b).to(BF16)
        self.c = torch.as_tensor(c).to(torch.float32).clone()
        self.tregs: list[torch.Tensor | None] = [None] * NUM_TREGS

    # -- tile address helpers ------------------------------------------------
    def _slice(self, mat: str, addr: tuple) -> tuple:
        _, i, j = addr
        if mat == "A":
            return (slice(i * self.tile_m, (i + 1) * self.tile_m),
                    slice(j * self.tile_k, (j + 1) * self.tile_k))
        if mat == "B":
            return (slice(i * self.tile_k, (i + 1) * self.tile_k),
                    slice(j * self.tile_n, (j + 1) * self.tile_n))
        return (slice(i * self.tile_m, (i + 1) * self.tile_m),
                slice(j * self.tile_n, (j + 1) * self.tile_n))

    def execute(self, ins: Instr) -> None:
        if ins.op is Op.TL:
            mat = ins.addr[0]                          # type: ignore[index]
            src = {"A": self.a, "B": self.b, "C": self.c}[mat]
            self.tregs[ins.dst] = src[self._slice(mat, ins.addr)].clone()  # type: ignore
        elif ins.op is Op.TS:
            self.c[self._slice("C", ins.addr)] = self.tregs[ins.src1]     # type: ignore
        else:  # MM: C += A @ B with bf16 multiply, fp32 accumulate
            a = self.tregs[ins.src1].float()     # type: ignore[union-attr]
            b = self.tregs[ins.src2].float()     # type: ignore[union-attr]
            c = self.tregs[ins.dst].float()      # type: ignore[union-attr]
            self.tregs[ins.dst] = c + a @ b


def run_gemm(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
             policy: RegPolicy | None = None) -> torch.Tensor:
    """Lower + functionally execute C += A @ B; returns the resulting C."""
    a, b, c = (torch.as_tensor(x) for x in (a, b, c))
    m, k = a.shape
    k2, n = b.shape
    assert k == k2 and tuple(c.shape) == (m, n)
    spec = GemmSpec("run", m, k, n)
    # pad to tile multiples so tile slicing is uniform; strip afterwards.
    mt, kt, nt = spec.tiles()
    f32 = dict(dtype=torch.float32, device=a.device)
    ap = torch.zeros((mt * TILE_M, kt * TILE_K), **f32); ap[:m, :k] = a
    bp = torch.zeros((kt * TILE_K, nt * TILE_N), **f32); bp[:k, :n] = b
    cp = torch.zeros((mt * TILE_M, nt * TILE_N), **f32); cp[:m, :n] = c
    eng = FunctionalEngine(ap, bp, cp)
    for ins in lower_gemm(spec, policy or RegPolicy()):
        eng.execute(ins)
    return eng.c[:m, :n]


def reference_gemm(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Mixed-precision reference: bf16-rounded operands, fp32 accumulate."""
    a16 = torch.as_tensor(a).to(BF16).float()
    b16 = torch.as_tensor(b).to(BF16).float()
    return torch.as_tensor(c).float() + a16 @ b16


def simulate_chip(workload, chip=None, **kwargs):
    """Chip-level (multi-core) simulation entry point.

    Convenience re-export: delegates to
    :func:`repro_torch.multicore.simulate_chip` (imported lazily so
    ``repro_torch.core`` stays free of the chip layer).  ``workload`` is a
    single :class:`~repro_torch.core.tiling.GemmSpec` (partitioned across
    cores) or a sequence of them (scheduled across cores); see
    :mod:`repro_torch.multicore` for the knobs.
    """
    from ..multicore import simulate_chip as _simulate_chip
    return _simulate_chip(workload, chip, **kwargs)
