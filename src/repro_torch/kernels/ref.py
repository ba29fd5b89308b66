"""Plain-torch oracles for the GEMM kernels (bf16-in / fp32-accumulate PE
semantics), the counterparts of the JAX package's ``kernels/ref.py``."""

from __future__ import annotations

import torch


def ref_matmul(a: torch.Tensor, b: torch.Tensor,
               out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """C = A @ B with fp32 accumulation."""
    return torch.matmul(a.float(), b.float()).to(out_dtype)


def ref_matmul_accum(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                     out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """C += A @ B (the rasa_mm contract)."""
    return (c.float() + torch.matmul(a.float(), b.float())).to(out_dtype)
