"""Public entry points of the kernels: device dispatch.

Counterpart of the JAX package's ``kernels/ops.py``.  Models call
``rasa_matmul`` through ``repro_torch.models.common.matmul`` when the engine
is ``pallas_rasa``.  No padding copies are made: the CUDA kernels mask the
ragged edge themselves.  A CPU tensor takes a kernel's plain PyTorch
version; a CUDA tensor launches the kernel, which raises on anything it
does not take.  There is no fallback from the card to the CPU.
"""

from __future__ import annotations

from typing import Optional

import torch

from torch.utils.flop_counter import register_flop_formula

from .flash_attention import flash_attention, flash_attention_plain
from .rasa_gemm import GemmBlocks, default_blocks, rasa_gemm, rasa_gemm_plain


FORWARD_ONLY = ("the RASA engine (pallas_rasa) is forward-only, as the reference's "
                "Pallas engine is: its GEMM has no backward; differentiate under the "
                "xla engine")


class _ForwardOnly(torch.autograd.Function):
    """The RASA GEMM on plain tensors inside autograd: its output carries a
    derivative that raises, so a backward through it fails on either device
    instead of giving the plain version's gradient on the CPU and none on
    the card.  With no input that needs a gradient, or under
    ``torch.no_grad()``, ``apply`` records nothing and this is the GEMM
    alone."""

    @staticmethod
    def forward(ctx, fn, a, b, c, kw):
        return fn(a, b, c, **kw)

    @staticmethod
    def backward(ctx, g):
        raise RuntimeError(FORWARD_ONLY)


@torch.library.custom_op("repro_torch::rasa_mm", mutates_args=(), schema=(
    "(Tensor a, Tensor b, Tensor? c, str schedule, int bk, ScalarType out_dtype) -> Tensor"))
def _rasa_mm(a: torch.Tensor, b: torch.Tensor, c: Optional[torch.Tensor], schedule: str,
             bk: int, out_dtype: torch.dtype) -> torch.Tensor:
    """The RASA GEMM as one operator, for DTensor, fake and meta operands:
    each rank runs the CUDA kernel (its plain version for CPU tensors) on
    its local shards (``_rasa_mm_sharding``); a fake or meta operand takes
    the fake implementation, which allocates nothing, and counts 2 M K N
    under ``FlopCounterMode`` (``_rasa_mm_flops``).  Plain tensors skip
    the operator's dispatch (``rasa_matmul``)."""
    fn = rasa_gemm_plain if a.device.type == "cpu" else rasa_gemm
    return fn(a, b, c, schedule=schedule, blocks=GemmBlocks(bk=bk), out_dtype=out_dtype)


@_rasa_mm.register_fake
def _(a, b, c, schedule, bk, out_dtype):
    return a.new_empty((a.shape[0], b.shape[1]), dtype=out_dtype)


def _forward_only(ctx, g):
    raise RuntimeError(FORWARD_ONLY)


# forward-only under DTensor too (``_ForwardOnly``)
_rasa_mm.register_autograd(_forward_only)


@register_flop_formula(torch.ops.repro_torch.rasa_mm)
def _rasa_mm_flops(a_shape, b_shape, *args, **kwargs) -> int:
    """2 M K N, as ``FlopCounterMode`` counts ``aten.mm`` (the summand C's
    adds are not counted, as ``addmm``'s are not)."""
    return 2 * a_shape[0] * a_shape[1] * b_shape[1]


def _mm_strategies(c_given: bool, batch: bool = False) -> list:
    """Per mesh dim, the (output, inputs) placements under which a product
    of local shards is the product's shard: all replicated; rows of A
    (and of C); columns of B (and of C); the contraction split, whose local
    products are partial sums (a summand C only where it is not split).
    ``batch``: a leading batch dim shared by both operands (bmm), also
    split."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    r, o = Replicate(), int(batch)
    c = (lambda p: p) if c_given else (lambda p: None)
    out = [([r], [r, r, c(r)]),
           ([Shard(o)], [Shard(o), r, c(Shard(o))]),
           ([Shard(o + 1)], [r, Shard(o + 1), c(Shard(o + 1))])]
    if batch:
        out.append(([Shard(0)], [Shard(0), Shard(0), c(Shard(0))]))
    if not c_given:
        out.append(([Partial()], [Shard(o + 1), Shard(o), None]))
    return out


def _register_sharding() -> None:
    """The DTensor rules of the GEMM operators the models call: the RASA
    operator (each rank launches the hand-written kernel on its shards) and
    the ``out_dtype`` overloads of mm / bmm that the xla engine takes on
    the card (``models.common._product``), which DTensor has no rule for."""
    from torch.distributed.tensor.experimental import register_sharding
    aten = torch.ops.aten

    @register_sharding(torch.ops.repro_torch.rasa_mm.default)
    def _rasa_mm_sharding(a, b, c, schedule, bk, out_dtype):
        return [(o, [*i, None, None, None]) for o, i in _mm_strategies(c is not None)]

    @register_sharding(aten.mm.dtype)
    def _mm_dtype_sharding(a, b, out_dtype):
        return [(o, [*i[:2], None]) for o, i in _mm_strategies(False)]

    @register_sharding(aten.bmm.dtype)
    def _bmm_dtype_sharding(a, b, out_dtype):
        return [(o, [*i[:2], None]) for o, i in _mm_strategies(False, batch=True)]


if torch.distributed.is_available():
    _register_sharding()

#: the types of operand that call the kernel (or its plain version) directly
_DIRECT = (torch.Tensor, torch.nn.Parameter)


def _direct(t: torch.Tensor | None) -> bool:
    """A plain tensor on a device that computes (not a DTensor, a fake
    tensor or a meta tensor), or no tensor."""
    return t is None or (type(t) in _DIRECT and not t.is_meta)


def rasa_matmul(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor | None = None,
                *, schedule: str = "wls", blocks: GemmBlocks | None = None,
                out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """C (+)= A @ B with the RASA schedule, any 2D shapes (DTensors: each
    rank on its shards, the k-chunk that of the full shapes; fake and meta
    tensors: the operator's fake implementation).
    Forward-only: a backward through the result raises (``FORWARD_ONLY``).
    Plain tensors call the kernel directly, without the operator's
    dispatch, whose host time an eager decode step would pay ~200 times."""
    if not (_direct(a) and _direct(b) and _direct(c)):
        blocks = blocks or default_blocks(a.shape[0], a.shape[1], b.shape[1])
        return _rasa_mm(a, b, c, schedule, blocks.bk, out_dtype)
    fn = rasa_gemm_plain if a.device.type == "cpu" else rasa_gemm
    kw = dict(schedule=schedule, blocks=blocks, out_dtype=out_dtype)
    return _ForwardOnly.apply(fn, a, b, c, kw)


def flash_block(block: int, s: int) -> int:
    """The reference's rule: the block, capped at the sequence's next power
    of two, and at least 128."""
    return min(block, max(128, 1 << (s - 1).bit_length()))


def flash_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              *, causal: bool = True, scale: float | None = None,
              block_q: int = 512, block_kv: int = 512) -> torch.Tensor:
    """GQA flash attention: q [B,Hq,S,D], k/v [B,Hkv,S,D] -> [B,Hq,S,D].

    kv head h // (Hq // Hkv) serves query head h (read in place, not
    repeated); the sequences count as zero-padded to the block multiples
    (padded kv positions are masked by causality for real query rows,
    padded query rows are never produced).  Non-causal inputs must need no
    padding, as in the reference.
    """
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if hkv == 0 or hq % hkv:
        raise ValueError(f"query heads {hq} not a multiple of kv heads {hkv}")
    if not causal and (sq % min(block_q, sq) or skv % min(block_kv, skv)):
        raise ValueError("zero-padded kv positions are only sound when masked by "
                         f"causality: lengths ({sq}, {skv}), blocks ({block_q}, "
                         f"{block_kv})")
    bq, bkv = flash_block(block_q, sq), flash_block(block_kv, skv)
    fn = flash_attention_plain if q.device.type == "cpu" else flash_attention
    out = fn(q.reshape(b * hq, sq, d).contiguous(),
             k.reshape(b * hkv, skv, d).contiguous(),
             v.reshape(b * hkv, skv, d).contiguous(),
             causal=causal, scale=scale, block_q=bq, block_kv=bkv)
    return out.reshape(b, hq, sq, d)
