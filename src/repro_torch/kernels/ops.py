"""Public entry point of the GEMM kernels: device dispatch.

Counterpart of the JAX package's ``kernels/ops.py``.  Models call it
through ``repro_torch.models.common.matmul`` when the engine is
``pallas_rasa``.  No padding is needed: the CUDA kernels mask the ragged
edge themselves.
"""

from __future__ import annotations

import torch

from .rasa_gemm import GemmBlocks, rasa_gemm, rasa_gemm_plain


def rasa_matmul(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor | None = None,
                *, schedule: str = "wls", blocks: GemmBlocks | None = None,
                out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """C (+)= A @ B with the RASA schedule, any 2D shapes.

    A CPU tensor takes the plain PyTorch version; a CUDA tensor launches the
    kernel, which raises on anything it does not take.  There is no
    fallback from the card to the CPU.
    """
    fn = rasa_gemm_plain if a.device.type == "cpu" else rasa_gemm
    return fn(a, b, c, schedule=schedule, blocks=blocks, out_dtype=out_dtype)
