"""Mesh construction over the ranks of a torch.distributed process group.

Counterpart of the JAX package's ``launch/mesh.py``.  Meshes are
``DeviceMesh``es with the reference's axis names, built by functions (not
module constants) so that importing this module starts nothing.  A mesh
needs a process group: ``init_distributed`` starts one when none exists
(NCCL on the card, gloo on the CPU), from the usual ``RANK`` /
``WORLD_SIZE`` / ``MASTER_ADDR`` / ``MASTER_PORT`` environment when it is
set, else as a world of one.  NCCL takes one device per rank, so a world
of several ranks on one card runs only on the CPU (gloo).

The reference's ``TPU_PERF_FLAGS`` are XLA flags for the TPU's collective
overlap; they have no counterpart here (NCCL overlaps on its own streams).
"""

from __future__ import annotations

import os
import socket

import torch
import torch.distributed as dist

from ..config import ParallelConfig
from ..models.common import resolve_device


def free_port() -> int:
    """A TCP port on localhost that is free now."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def init_distributed(device="cuda", backend: str | None = None) -> None:
    """Start the default process group unless one exists: ``backend``
    (default NCCL for a CUDA device, gloo for the CPU), with rank and world
    from ``RANK`` / ``WORLD_SIZE`` and the rendezvous from ``MASTER_ADDR`` /
    ``MASTER_PORT`` when they are set, else a world of one on a free local
    port.  On a CUDA device each rank takes device ``LOCAL_RANK`` (default
    its rank)."""
    if dist.is_initialized():
        return
    device = resolve_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if "WORLD_SIZE" in os.environ:
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        init = "env://"
    else:
        rank, world = 0, 1
        init = f"tcp://localhost:{free_port()}"
    if device.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)) % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init, rank=rank, world_size=world)


def _world() -> int:
    if not dist.is_initialized():
        raise RuntimeError("no process group: call launch.mesh.init_distributed() first")
    return dist.get_world_size()


def _mesh(device, shape: tuple[int, ...], axes: tuple[str, ...]):
    from torch.distributed.device_mesh import DeviceMesh
    n = 1
    for s in shape:
        n *= s
    ranks = torch.arange(n).reshape(shape)
    return DeviceMesh(resolve_device(device).type, ranks, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    """16x16 = 256 ranks per pod; (2, 16, 16) = 512 ranks across two pods.
    The world must have that many ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    want = 512 if multi_pod else 256
    if _world() != want:
        raise RuntimeError(f"the production mesh {shape} needs {want} ranks; the world "
                           f"has {_world()}")
    return _mesh(device, shape, axes)


def make_mesh_for(parallel: ParallelConfig, device="cuda"):
    """Mesh matching a ParallelConfig (elastic restart rebuilds a smaller one
    after node loss): (pods, data, model) or (data, model).  The world must
    hold at least its ranks; the mesh takes the first of them."""
    if parallel.pods > 1:
        shape = (parallel.pods, parallel.data, parallel.model)
        axes = ("pod", "data", "model")
    else:
        shape = (parallel.data, parallel.model)
        axes = ("data", "model")
    n = 1
    for s in shape:
        n *= s
    if n > _world():
        raise RuntimeError(f"the mesh {shape} of {parallel} needs {n} ranks; the world "
                           f"has {_world()}")
    return _mesh(device, shape, axes)


def make_host_mesh(max_devices: int | None = None, device="cuda"):
    """Best-effort (data, model) mesh over the world's ranks (at most
    ``max_devices``): model 4, 2 or 1, whichever divides first, data the
    rest; a world of one gives (1, 1)."""
    n = _world() if max_devices is None else min(max_devices, _world())
    model = 1
    for m in (4, 2, 1):
        if n % m == 0 and n >= m:
            model = m
            break
    return _mesh(device, (n // model, model), ("data", "model"))
