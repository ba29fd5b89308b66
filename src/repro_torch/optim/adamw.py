"""AdamW with dtype-configurable moments (bf16 moments halve optimizer
memory) and global-norm clipping.  Counterpart of the JAX package's
``optim/adamw.py``.

The optimizer works over the model's parameters by name (a dict name ->
tensor, as ``dict(model.named_parameters())``) and updates the parameters
and the moments in place, so that the model trains on its own parameters
with no second copy of the state (the reference donates its state to the
jitted step for the same reason).  Math is fp32 whatever the storage
dtypes; parameters and moments are rounded back to theirs.  Parameters
may be DTensors: their moments take the same placements, and every update
runs on each rank's shards.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class AdamWState(NamedTuple):
    step: torch.Tensor                 # int32 0-d, on the parameters' device
    m: dict[str, torch.Tensor]
    v: dict[str, torch.Tensor]


def tree_order(names) -> list[str]:
    """``names`` (the port's parameter names: "embedding", "layers.3.wq",
    "shared_attn.wq", ...) in the reference's leaf order: ``jax.tree``
    flattens dicts by sorted key, with each per-layer name a stacked
    [L, ...] leaf, so layers come by name, then by index."""
    def key(name: str):
        parts = name.split(".")
        if len(parts) == 3 and parts[1].isdigit():
            return parts[0], parts[2], int(parts[1])
        return parts[0], ".".join(parts[1:]), 0
    return sorted(names, key=key)


def adamw_init(params: dict[str, torch.Tensor], dtype: str = "float32") -> AdamWState:
    dt = getattr(torch, dtype)
    device = next(iter(params.values())).device
    zeros = lambda p: torch.zeros_like(p, dtype=dt)   # a DTensor's moments share its layout
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                      m={n: zeros(p) for n, p in params.items()},
                      v={n: zeros(p) for n, p in params.items()})


def global_norm(grads: dict[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every gradient, in fp32: each leaf's
    sum, added in the reference's leaf order (``tree_order``)."""
    total = torch.zeros((), dtype=torch.float32, device=next(iter(grads.values())).device)
    for name in tree_order(grads):
        total = total + torch.sum(torch.square(grads[name].float()))
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(params: dict[str, torch.Tensor], grads: dict[str, torch.Tensor],
                 state: AdamWState, *, lr: torch.Tensor | float, b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8, weight_decay: float = 0.1,
                 grad_clip: float = 1.0) -> tuple[dict, AdamWState, dict]:
    """One AdamW step with global-norm clipping (the norm reported is the
    one before clipping).  Updates params and the moments in place and
    returns (params, state, {"grad_norm"}), the objects it was given.
    Nothing here syncs with the host."""
    state.step.add_(1)
    gnorm = global_norm(grads)
    scale = (torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0)
             if grad_clip else 1.0)
    step = state.step.float()
    c1 = 1.0 - b1 ** step
    c2 = 1.0 - b2 ** step
    for name, p in params.items():
        m, v = state.m[name], state.v[name]
        gf = grads[name].float() * scale
        mf = b1 * m.float() + (1 - b1) * gf
        vf = b2 * v.float() + (1 - b2) * torch.square(gf)
        update = (mf / c1) / (torch.sqrt(vf / c2) + eps)
        pf = p.float() * (1.0 - lr * weight_decay) - lr * update
        p.copy_(pf)
        m.copy_(mf)
        v.copy_(vf)
    return params, state, {"grad_norm": gnorm}
