"""Public entry points of the kernels: device dispatch.

Counterpart of the JAX package's ``kernels/ops.py``.  Models call
``rasa_matmul`` through ``repro_torch.models.common.matmul`` when the engine
is ``pallas_rasa``.  No padding copies are made: the CUDA kernels mask the
ragged edge themselves.  A CPU tensor takes a kernel's plain PyTorch
version; a CUDA tensor launches the kernel, which raises on anything it
does not take.  There is no fallback from the card to the CPU.
"""

from __future__ import annotations

import torch

from .flash_attention import flash_attention, flash_attention_plain
from .rasa_gemm import GemmBlocks, rasa_gemm, rasa_gemm_plain


FORWARD_ONLY = ("the RASA engine (pallas_rasa) is forward-only, as the reference's "
                "Pallas engine is: its GEMM has no backward; differentiate under the "
                "xla engine")


class _ForwardOnly(torch.autograd.Function):
    """The RASA GEMM inside autograd: its output carries a derivative that
    raises, so a backward through it fails on either device instead of
    giving the plain version's gradient on the CPU and none on the card.
    With no input that needs a gradient, or under ``torch.no_grad()``,
    ``apply`` records nothing and this is the GEMM alone."""

    @staticmethod
    def forward(ctx, fn, a, b, c, kw):
        return fn(a, b, c, **kw)

    @staticmethod
    def backward(ctx, g):
        raise RuntimeError(FORWARD_ONLY)


def rasa_matmul(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor | None = None,
                *, schedule: str = "wls", blocks: GemmBlocks | None = None,
                out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """C (+)= A @ B with the RASA schedule, any 2D shapes.  Forward-only:
    a backward through the result raises (``FORWARD_ONLY``)."""
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
