"""Int8 error-feedback gradient compression for the DP all-reduce.
Counterpart of the JAX package's ``optim/compression.py``: per-tensor
symmetric int8 quantisation, whose residual the caller keeps and adds to
the next step's gradient (error feedback keeps the scheme unbiased over
time), and ``compressed_psum``, the data-parallel all-reduce that uses it:
each rank quantises its own gradient, the int8 values are summed in int32
over the mesh axes' process groups (int8 summands would overflow int8)
and the scales reduced to their maximum, as the reference's ``shard_map``
collective does.
"""

from __future__ import annotations


import torch
import torch.distributed as dist

from ..distributed.sharding import is_dtensor


def compress_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantisation -> (q int8, scale fp32 0-d)."""
    xf = x.float()
    scale = torch.clamp(torch.max(torch.abs(xf)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def _psum_one(g: torch.Tensor, residual: torch.Tensor,
              groups) -> tuple[torch.Tensor, torch.Tensor]:
    gf = g.float() + residual.float()
    q, scale = compress_int8(gf)
    new_residual = gf - decompress_int8(q, scale)
    summed, scale_max = q.to(torch.int32), scale.clone()
    for group in groups:     # a sum (max) over each axis in turn is the sum (max) over all
        dist.all_reduce(summed, op=dist.ReduceOp.SUM, group=group)
        dist.all_reduce(scale_max, op=dist.ReduceOp.MAX, group=group)
    return summed.float() * scale_max, new_residual.to(residual.dtype)


def compressed_psum(grads: dict[str, torch.Tensor], residuals: dict[str, torch.Tensor],
                    mesh, axis_names: tuple[str, ...] = ("data",)) -> tuple[dict, dict]:
    """Sum ``grads`` over the mesh axes ``axis_names`` with int8 error
    feedback; every rank of the mesh calls it.

    grads / residuals: {name: tensor} of this rank's own values (plain
    tensors, or DTensors, whose local shards are summed and keep their
    layout).  Returns (summed grads fp32, new residuals).
    """
    groups = [mesh.get_group(a) for a in axis_names]
    summed, new_res = {}, {}
    for name, g in grads.items():
        r = residuals[name]
        if is_dtensor(g):
            from torch.distributed.tensor import DTensor
            s_l, r_l = _psum_one(g.to_local(), r.to_local(), groups)
            wrap = lambda t, like: DTensor.from_local(t, like.device_mesh, like.placements,
                                                      run_check=False)
            summed[name], new_res[name] = wrap(s_l, g), wrap(r_l, r)
        else:
            summed[name], new_res[name] = _psum_one(g, r, groups)
    return summed, new_res
