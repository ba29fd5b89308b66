"""Int8 error-feedback gradient compression.  Counterpart of the JAX
package's ``optim/compression.py``: per-tensor symmetric int8 quantisation,
whose residual the caller keeps and adds to the next step's gradient
(error feedback keeps the scheme unbiased over time).

The reference's ``compressed_psum``, the data-parallel all-reduce that
uses it (a ``shard_map`` collective), comes with the distributed slice
(ROADMAP queue 1, item 11).
"""

from __future__ import annotations

import torch


def compress_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantisation -> (q int8, scale fp32 0-d)."""
    xf = x.float()
    scale = torch.clamp(torch.max(torch.abs(xf)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale
