"""Sequence-parallel flash decode for long-context serving.

Counterpart of the JAX package's ``serving/sp_decode.py`` (a ``shard_map``
there).  The KV cache is split along the *sequence* over one mesh axis;
each rank computes attention over its own slice with a local logsumexp,
and the slices are combined with the exact flash-decoding reduction

    out = sum_i exp(lse_i - lse) out_i,   lse = logsumexp_i(lse_i)

as two all-reduces over that axis: MAX of the lse, then SUM of the
weighted outputs and of the weights ([B, H, hd + 1] per layer instead of a
gathered score row or cache).  Heads are split over "model" when they
divide.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..distributed.sharding import NamedSharding, distribute, is_dtensor


def _local_decode(q, k, v, start: int, lengths, scale: float):
    """q: [B,H,hd]; k/v: [B,H,Sl,hd] (this rank's slice); start: the global
    offset of the slice; lengths: [B] valid global lengths.
    Returns (out [B,H,hd], lse [B,H])."""
    s_local = k.shape[2]
    logits = torch.einsum("bhd,bhsd->bhs", q.float() * scale, k.float())
    pos = start + torch.arange(s_local, device=q.device)[None, None, :]
    mask = pos < lengths[:, None, None]
    logits = torch.where(mask, logits, -1e30)
    m = logits.amax(dim=-1)                               # [B,H]
    p = torch.exp(logits - m[..., None])
    l = p.sum(dim=-1)
    out = torch.einsum("bhs,bhsd->bhd", p, v.float())
    # locally normalised output + logsumexp (guard fully masked slices)
    out = out / torch.clamp(l, min=1e-30)[..., None]
    lse = torch.where(l > 0, m + torch.log(torch.clamp(l, min=1e-30)),
                      torch.full_like(l, -torch.inf))
    return out, lse


def _mine(t: torch.Tensor, sharding: NamedSharding) -> torch.Tensor:
    """This rank's shard of ``t`` (a DTensor, redistributed if needed, or a
    plain full tensor, sliced) under ``sharding``."""
    if is_dtensor(t):
        return t.redistribute(sharding.mesh, sharding.effective).to_local()
    return distribute(t, sharding).to_local()


def sp_flash_decode(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                    lengths: torch.Tensor, mesh, *, seq_axis: str = "data",
                    scale: float | None = None) -> torch.Tensor:
    """Decode attention over a sequence-split KV cache; every rank of
    ``mesh`` calls it.

    q: [B, H, hd] (the same on every rank of the sequence axis); caches
    [B, H, S, hd] (DTensors, or plain full tensors that each rank slices)
    split on S over ``seq_axis``; lengths [B].  GQA expansion happens
    before the call.  Returns a DTensor [B, H, hd], heads split over
    "model" when they divide, replicated over the sequence axis.
    """
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor import Replicate, Shard
    b, h, hd = q.shape
    s = k_cache.shape[2]
    if scale is None:
        scale = hd ** -0.5
    names = list(mesh.mesh_dim_names)
    n_shards = mesh.size(names.index(seq_axis))
    if s % n_shards:
        raise ValueError(f"sequence {s} does not split over {n_shards} {seq_axis!r} ranks")
    s_local = s // n_shards
    heads = "model" in names and h % mesh.size(names.index("model")) == 0
    spec_q = [Replicate()] * len(names)
    spec_kv = list(spec_q)
    if heads:
        spec_q[names.index("model")] = spec_kv[names.index("model")] = Shard(1)
    spec_kv[names.index(seq_axis)] = Shard(2)
    q_sh, kv_sh = NamedSharding(mesh, tuple(spec_q)), NamedSharding(mesh, tuple(spec_kv))

    q_l = _mine(q, q_sh)
    k_l, v_l = _mine(k_cache, kv_sh), _mine(v_cache, kv_sh)
    lengths = lengths.to_local() if is_dtensor(lengths) else lengths
    start = mesh.get_local_rank(seq_axis) * s_local
    out, lse = _local_decode(q_l, k_l, v_l, start, lengths, scale)
    # the flash-decoding combine across the sequence ranks
    group = mesh.get_group(seq_axis)
    g_max = lse.clone()
    dist.all_reduce(g_max, op=dist.ReduceOp.MAX, group=group)
    g_max = torch.where(torch.isfinite(g_max), g_max, torch.zeros_like(g_max))
    w = torch.exp(torch.where(torch.isfinite(lse), lse - g_max,
                              torch.full_like(lse, -torch.inf)))
    num_den = torch.cat([out * w[..., None], w[..., None]], dim=-1)   # [B,H,hd+1]
    dist.all_reduce(num_den, op=dist.ReduceOp.SUM, group=group)
    num, den = num_den[..., :hd], num_den[..., hd]
    res = (num / torch.clamp(den[..., None], min=1e-30)).to(q.dtype)
    return DTensor.from_local(res, mesh, q_sh.effective, run_check=False)
