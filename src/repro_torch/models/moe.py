"""Mixture-of-Experts FFN: top-k routing, grouped sort-based dispatch.

Counterpart of the JAX package's ``models/moe.py``.  Dispatch happens
independently inside ``dispatch_groups`` token groups, with a per-group
expert capacity; tokens over capacity keep only their residual path.  The
group count and the capacity follow from the config and the batch, so every
shape is static and a step captures in a CUDA graph.  The router and the
expert products are plain library products (``torch.mm``/``torch.bmm``), as
the reference leaves them to ``jnp.dot``/``einsum`` outside any kernel.

Order semantics follow the reference's: ``lax.top_k`` puts the lower index
first on ties (a stable descending sort here), ``jnp.argsort`` is stable,
slots are assigned in token order per expert and the first ``cap`` kept,
and the combine adds each token's contributions in ascending expert id,
rounding to the activations' type after each add, as the reference's
``.at[].add`` applies its updates one by one in the expert-sorted order.
Nothing here uses atomics, so a step gives the same bits on every run.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..config import ModelConfig
from ..distributed.sharding import constrain, map_shards, reshape
from .common import dot_f32, matmul


class Routing(NamedTuple):
    """What a dispatch decided: the router's probabilities [G, Tg, E], each
    token's top-k experts [G, Tg, k], and which expert-sorted entries
    [G, Tg*k] found a slot under the capacity."""
    probs: torch.Tensor
    top_i: torch.Tensor
    keep: torch.Tensor


def _group_count(t: int, requested: int) -> int:
    """Largest divisor of t that is <= requested (decode steps have tiny t)."""
    g = min(requested, t)
    while t % g:
        g -= 1
    return g


def capacity(tg: int, cfg: ModelConfig) -> int:
    """Slots per expert in a group of tg tokens."""
    moe = cfg.moe
    return max(int(tg * moe.top_k / moe.n_experts * moe.capacity_factor) + 1, 1)


def expert_ffn(p, buf: torch.Tensor) -> torch.Tensor:
    """The experts' SwiGLU FFN on their slots buf [E, C, D] -> [E, C, D]:
    each product accumulated in fp32 and rounded once to buf's type.  The
    activation is SiLU whatever ``cfg.act`` says, as in the reference."""
    dtype = buf.dtype
    if "experts_w_gate_up" in p:
        w = p["experts_w_gate_up"]                       # [E, D, 2, Fe]
        gu = dot_f32(torch.bmm, buf, w.reshape(w.shape[0], w.shape[1], -1), dtype)
        gu = reshape(gu, *gu.shape[:2], 2, -1)
        gate, up = gu[:, :, 0], gu[:, :, 1]
    else:
        gate = dot_f32(torch.bmm, buf, p["experts_w_gate"], dtype)
        up = dot_f32(torch.bmm, buf, p["experts_w_up"], dtype)
    inner = constrain(F.silu(gate) * up, "ecf")
    return dot_f32(torch.bmm, inner, p["experts_w_down"], dtype)


def _dispatch(xf: torch.Tensor, logits: torch.Tensor, k: int, cap: int):
    """Each group's routing and dispatch into its experts' slots: xf [G,
    Tg, D], the router's logits [G, Tg, E] -> (buf [G, E, cap + 1, D], the
    probabilities, the top-k experts, and of the expert-sorted entries
    [G, Tg*k]: kept, expert, token, slot and weight)."""
    g, tg, d = xf.shape
    e = logits.shape[-1]
    dev = xf.device
    probs = torch.softmax(logits, dim=-1)
    top_w, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_i = top_w[..., :k], top_i[..., :k]                   # [G, Tg, k]
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)

    # ---- grouped sort-based dispatch (all ops batched over G) ----
    e_flat = top_i.reshape(g, tg * k)
    t_flat = torch.arange(tg, device=dev)[:, None].expand(tg, k).reshape(tg * k)
    order = torch.argsort(e_flat, dim=-1, stable=True)
    se = e_flat.gather(-1, order)
    st = t_flat[order]
    counts = (e_flat[..., None] == torch.arange(e, device=dev)).sum(1)   # [G, E]
    starts = torch.cumsum(counts, dim=-1) - counts
    slot = torch.arange(tg * k, device=dev) - starts.gather(-1, se)
    keep = slot < cap

    # kept entries have distinct (expert, slot) pairs; the dropped ones go to
    # a spare slot that is sliced off
    gi = torch.arange(g, device=dev)[:, None]
    buf = torch.zeros((g, e, cap + 1, d), dtype=xf.dtype, device=dev)
    buf[gi, se, torch.where(keep, slot, cap)] = xf[gi, st]
    return buf, probs, top_i, keep, se, st, slot, top_w.reshape(g, tg * k).gather(-1, order)


def _combine(out_buf: torch.Tensor, keep, se, st, slot, w, k: int) -> torch.Tensor:
    """Each token's k contributions (out_buf [G, E, cap, D] at its entries'
    slots, times their weights) added in ascending expert id -> [G, Tg, D]."""
    g, tk = se.shape
    d = out_buf.shape[-1]
    gi = torch.arange(g, device=out_buf.device)[:, None]
    slot_c = torch.where(keep, slot, 0)
    contrib = out_buf[gi, se, slot_c] * (w * keep).to(out_buf.dtype)[..., None]
    # back from the expert-sorted order to (token, expert id ascending): a
    # token's entries are already in ascending expert id within the sort
    by_token = torch.argsort(st, dim=-1, stable=True)
    contrib = contrib.gather(1, by_token[..., None].expand(g, tk, d)).reshape(g, tk // k, k, d)
    y = contrib[:, :, 0]
    for j in range(1, k):
        y = y + contrib[:, :, j]
    return y


def moe_forward(p, x: torch.Tensor, cfg: ModelConfig) -> tuple[torch.Tensor, Routing]:
    """x: [B, S, D] -> (y [B, S, D], the routing).  No product of this
    block goes through the RASA engine.  The routing, dispatch and combine
    of each group are its own (on each rank's groups under a mesh); the
    experts' products run on their slots of every group."""
    moe = cfg.moe
    b, s, d = x.shape
    t = b * s
    e, k = moe.n_experts, moe.top_k
    g = _group_count(t, moe.dispatch_groups)
    tg = t // g
    cap = capacity(tg, cfg)

    xf = reshape(x, g, tg, d)
    logits = reshape(matmul(reshape(x, t, d), p["router"].to(x.dtype),
                            out_dtype=torch.float32), g, tg, e)
    group = (0, None)
    buf, probs, top_i, keep, se, st, slot, w = map_shards(
        lambda xf_, logits_: _dispatch(xf_, logits_, k, cap), (xf, logits), (group,) * 2,
        (group,) * 8)
    buf_e = constrain(reshape(buf[:, :, :cap].transpose(0, 1), e, g * cap, d), "ecd")
    out_buf = reshape(expert_ffn(p, buf_e), e, g, cap, d).transpose(0, 1)
    y = map_shards(lambda *a: _combine(*a, k), (out_buf, keep, se, st, slot, w),
                   (group,) * 6, group)
    return reshape(y, b, s, d), Routing(probs, top_i, keep)


def load_balance_loss(routing: Routing, cfg: ModelConfig) -> torch.Tensor:
    """The Switch-style auxiliary loss: E * sum(fraction routed to each
    expert * its mean probability) * the config's weight.  The fractions
    come from the per-expert counts (no one-hot, which syncs with the host
    on the CPU)."""
    moe = cfg.moe
    e = moe.n_experts
    top_i = routing.top_i
    counts = (reshape(top_i, -1, 1) == torch.arange(e, device=top_i.device)).sum(0)
    frac_routed = counts.float() / top_i.numel()
    return e * torch.sum(frac_routed * routing.probs.mean((0, 1))) * moe.aux_loss_weight


def moe_block(p, x: torch.Tensor, cfg: ModelConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, D] -> (y [B, S, D], aux_loss scalar), as the reference's
    moe_block.  The serving steps call moe_forward: they discard the loss,
    as the reference's compiled steps do."""
    y, routing = moe_forward(p, x, cfg)
    return y, load_balance_loss(routing, cfg)
