"""Shared model plumbing: the matrix-engine dispatch + init helpers.

Every GEMM of the models routes through :func:`matmul`, which selects the
engine per config: ``xla`` (a plain product with fp32 accumulation) or
``pallas_rasa`` (the RASA-scheduled CUDA kernels of
``repro_torch.kernels``; their plain version on the CPU).  The engine names
are the JAX package's.
"""

from __future__ import annotations

import torch

from ..config import EngineConfig, ModelConfig
from ..kernels import GemmBlocks, rasa_matmul


def matmul(x: torch.Tensor, w: torch.Tensor, engine: EngineConfig | None = None,
           out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """x [..., K] @ w [K, N] with fp32 accumulation, cast to out_dtype
    (default: x.dtype)."""
    out_dtype = out_dtype or x.dtype
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if engine is not None and engine.kind == "pallas_rasa":
        blocks = GemmBlocks(engine.block_m, engine.block_k, engine.block_n)
        out = rasa_matmul(x2, w, schedule=engine.schedule, blocks=blocks)
    else:
        out = dot_f32(torch.mm, x2, w)
    return out.reshape(*lead, w.shape[-1]).to(out_dtype)


def dot_f32(op, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``op`` (``torch.mm`` or ``torch.bmm``) of a and b with fp32
    accumulation and an fp32 result, as ``jnp.dot(...,
    preferred_element_type=float32)``.  On a CUDA device with bf16 operands
    this is the library's ``out_dtype`` overload, which reads the operands
    as they are; elsewhere (that overload has no CPU kernel) the operands
    are cast to fp32 first.  Products of bf16 values are exact in fp32, so
    the two differ only in the order of the sums."""
    if a.is_cuda and a.dtype == b.dtype == torch.bfloat16:
        return op(a, b, out_dtype=torch.float32)
    return op(a.float(), b.float())


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device must be present (there is
    no silent fallback to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but no CUDA device is "
                               "present; pass device='cpu' to run on the CPU")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def he_init(gen: torch.Generator, shape, dtype, fan_in=None,
            device=None) -> torch.Tensor:
    """He-scaled normal truncated to [-2, 2], drawn in fp32 from ``gen``."""
    fan_in = fan_in if fan_in is not None else shape[-2] if len(shape) >= 2 else shape[-1]
    scale = (2.0 / max(fan_in, 1)) ** 0.5
    x = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (x * scale).to(dtype)


def embed_init(gen: torch.Generator, shape, dtype, device=None) -> torch.Tensor:
    x = torch.randn(shape, dtype=torch.float32, device=device, generator=gen)
    return (x * 0.02).to(dtype)
