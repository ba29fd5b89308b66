"""LR schedules.  Counterpart of the JAX package's ``optim/schedule.py``."""

from __future__ import annotations

import math

import torch


def linear_warmup_cosine(step, *, peak_lr: float, warmup_steps: int,
                         total_steps: int, min_ratio: float = 0.1) -> torch.Tensor:
    """The learning rate at ``step`` (a number or a 0-d tensor, read on its
    device: no host sync): linear warm-up to ``peak_lr`` over
    ``warmup_steps``, then a cosine decay to ``min_ratio * peak_lr`` at
    ``total_steps``.  A 0-d fp32 tensor, computed in fp32 as the reference
    does, except the cosine: XLA's fp32 cosine is not correctly rounded,
    and the correctly rounded one (fp64, rounded once) is nearer to it than
    torch's fp32 one; the two differ by at most one ulp of the cosine."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = peak_lr * step / max(warmup_steps, 1)
    frac = torch.clamp((step - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0)
    cosine = torch.cos((math.pi * frac).double()).float()
    cos = peak_lr * (min_ratio + (1 - min_ratio) * 0.5 * (1 + cosine))
    return torch.where(step < warmup_steps, warm, cos)
