"""GPipe-style pipeline parallelism over a mesh axis, with torch.distributed
point-to-point.

Counterpart of the JAX package's ``training/pipeline.py`` (``shard_map`` +
``ppermute`` there).  The layer stack is split into ``n_stages``
contiguous stages; stage s is the rank at coordinate s of the mesh axis.
Microbatches stream through: at tick t, stage s computes microbatch t - s
(a bubble at the ends, the classic GPipe schedule), then each stage sends
its activation to the next one around the ring (``_RingShift``: a send and
a receive, whose backward sends the gradient the other way).  The last
stage's outputs are summed over the axis (``_SumReplicated``), so every
stage returns the whole output.  Every stage runs the same ticks, so the
backward's sends and receives pair up in the same order on every rank.

API:
    y = pipeline_apply(stage_params, x, stage_fn, mesh,
                       axis="pod", n_microbatches=m)
where stage_params leaves are [n_stages, ...] (each rank uses its own
stage's slice; its gradients land there) and
``stage_fn(params_slice, x_mb) -> y_mb``.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist


def _ring(x: torch.Tensor, step: int, group) -> torch.Tensor:
    """x sent ``step`` places along the ring of ``group`` (each rank
    receives the tensor of the rank ``step`` places before it)."""
    n = dist.get_world_size(group)
    if n == 1:
        return x
    me = dist.get_rank(group)
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x.contiguous(), dist.get_global_rank(group, (me + step) % n),
                      group),
           dist.P2POp(dist.irecv, out, dist.get_global_rank(group, (me - step) % n), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _RingShift(torch.autograd.Function):
    """The activation to the next stage; its gradient back to this one."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _ring(x, 1, group)

    @staticmethod
    def backward(ctx, g):
        return _ring(g, -1, ctx.group), None


class _SumReplicated(torch.autograd.Function):
    """The sum over ``group`` of each rank's value, the same on every rank.
    Every rank's loss then reads the whole result, so each receives the
    whole cotangent of it: the backward is the identity."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.clone()
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def pipeline_apply(stage_params: Any, x: torch.Tensor,
                   stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                   mesh, *, axis: str = "pod",
                   n_microbatches: int | None = None) -> torch.Tensor:
    """Run x [B, ...] (the same on every rank) through the staged
    computation; returns y [B, ...] on every rank.

    Stage params: a dict tree whose leaves have a leading [n_stages] dim;
    this rank computes with its stage's slice.  The batch is split into
    n_microbatches (default n_stages) along dim 0.
    """
    group = mesh.get_group(axis)
    n_stages = mesh.size(list(mesh.mesh_dim_names).index(axis))
    stage = mesh.get_local_rank(axis)
    m = n_microbatches or n_stages
    b = x.shape[0]
    if b % m:
        raise ValueError(f"batch {b} does not split into {m} microbatches")
    x_mb = x.reshape(m, b // m, *x.shape[1:])
    params_s = _tree_map(lambda a: a[stage], stage_params)
    first = torch.tensor(stage == 0, device=x.device)

    buf = torch.zeros_like(x_mb[0])
    outs = []
    for t in range(m + n_stages - 1):
        # stage 0 takes microbatch t from the input stream; a select (not a
        # branch), so every stage's graph has the same shifts to run back
        cur = torch.where(first, x_mb[min(t, m - 1)], buf)
        out = stage_fn(params_s, cur)
        outs.append(out)
        if t < m + n_stages - 2:
            buf = _RingShift.apply(out, group)
    # the last stage's outputs, ticks [n_stages - 1, n_stages - 1 + m)
    valid = torch.stack(outs[n_stages - 1:n_stages - 1 + m])
    contrib = valid * float(stage == n_stages - 1)
    y = _SumReplicated.apply(contrib, group)
    return y.reshape(b, *y.shape[2:])


def split_stages(params: Any, n_stages: int) -> Any:
    """Reshape stacked per-layer params [L, ...] -> [n_stages, L/n_stages, ...]."""
    def f(a):
        L = a.shape[0]
        if L % n_stages:
            raise ValueError(f"{L} layers do not split into {n_stages} stages")
        return a.reshape(n_stages, L // n_stages, *a.shape[1:])
    return _tree_map(f, params)
