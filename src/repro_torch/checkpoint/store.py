"""Fault-tolerant checkpoint store.  Counterpart of the JAX package's
``checkpoint/store.py``, with its properties:

  * atomic    -- write to <dir>/.tmp-<uuid>, fsync, rename; a crashed save
                 never corrupts the latest checkpoint;
  * async     -- the device -> host copy happens at once, the file write on
                 one background thread, so the train loop overlaps step N+1
                 with persisting step N;
  * integrity -- a crc32 per leaf in the manifest, checked on load;
  * retention -- keep the newest K checkpoints;
  * resharding -- a restore takes target shardings: a checkpoint written
                 on one mesh (or none) restores onto another mesh (or none),
                 the elastic restart after node loss.

Format: one ``arrays.npz`` of raw bytes per checkpoint (one uint8 array per
leaf; the logical dtype and shape live in ``manifest.json``), so bf16 goes
through its bytes and needs no numpy dtype.  A state is a tree of dicts,
NamedTuples, lists and tuples over tensor leaves; a leaf's name is its
path.  A checkpoint holds full tensors: a DTensor leaf is gathered on
save (every rank takes part; rank 0 writes, and the others wait for it), so
what was written does not depend on the mesh.  A restore puts each leaf on
the device of the template's leaf, laid out as the target sharding says
(a ``distributed.NamedSharding``), or by default as the template's leaf
is (a DTensor's own placements on the current mesh; ``restore_into``
writes each rank's shard into the leaf itself).
"""

from __future__ import annotations

import concurrent.futures
import json
import os
import shutil
import threading
import uuid
import zlib
from pathlib import Path
from typing import Any, Iterator

import numpy as np
import torch
import torch.distributed as dist

from ..distributed.sharding import (NamedSharding, distribute, full, is_dtensor, laid_out,
                                    shard_like)


def _items(tree: Any):
    if isinstance(tree, dict):
        return tree.items()
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return zip(tree._fields, tree)
    if isinstance(tree, (list, tuple)):
        return enumerate(tree)
    raise TypeError(f"not a tree of tensors: {type(tree).__name__}")


def flatten_with_names(tree: Any, prefix: str = "",
                       leaf_type: type = torch.Tensor) -> list[tuple[str, Any]]:
    """(path, leaf) of every leaf (an instance of ``leaf_type``), in the
    tree's order."""
    if isinstance(tree, leaf_type):
        return [(prefix, tree)]
    out = []
    for key, sub in _items(tree):
        out += flatten_with_names(sub, f"{prefix}/{key}", leaf_type)
    return out


def unflatten_like(tree: Any, leaves: Iterator[torch.Tensor]) -> Any:
    """A tree of ``tree``'s structure with its leaves taken, in order, from
    ``leaves``."""
    if isinstance(tree, torch.Tensor):
        return next(leaves)
    if isinstance(tree, dict):
        return {k: unflatten_like(v, leaves) for k, v in tree.items()}
    subs = [unflatten_like(v, leaves) for _, v in _items(tree)]
    return type(tree)(*subs) if hasattr(tree, "_fields") else type(tree)(subs)


def _raw(t: torch.Tensor) -> np.ndarray:
    """A host tensor's bytes, as a uint8 array (any dtype, bf16 included)."""
    return t.detach().contiguous().reshape(-1).view(torch.uint8).numpy()


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def to_host(state: Any) -> Any:
    """A copy of ``state`` with every leaf on the host, DTensors gathered
    (a collective: every rank of their mesh calls it)."""
    names = flatten_with_names(state)
    return unflatten_like(state, iter(full(t.detach()).to("cpu", copy=True)
                                      for _, t in names))


def _writer() -> bool:
    """Whether this process writes checkpoints: rank 0, or the only process."""
    return not dist.is_initialized() or dist.get_rank() == 0


def _barrier() -> None:
    """Wait for every rank (the writer's files are on disk after it)."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


def save_checkpoint(directory: str | Path, step: int, state: Any) -> Path:
    """Synchronous atomic save; returns the final checkpoint dir.  With
    DTensor leaves every rank calls it: the leaves are gathered, rank 0
    writes, and every rank returns once the files are on disk."""
    directory = Path(directory)
    final = directory / f"step_{step:08d}"
    if any(is_dtensor(t) for _, t in flatten_with_names(state)):
        host = to_host(state)
        if _writer():
            save_checkpoint(directory, step, host)
        _barrier()
        return final
    tmp = directory / f".tmp-{uuid.uuid4().hex[:8]}"
    tmp.mkdir(parents=True, exist_ok=True)
    try:
        arrays = {}
        manifest = {"step": int(step), "leaves": []}
        for i, (name, leaf) in enumerate(flatten_with_names(state)):
            host = leaf.detach().cpu()
            raw = _raw(host)
            key = f"leaf_{i}"
            arrays[key] = raw
            manifest["leaves"].append({
                "name": name, "key": key, "shape": list(host.shape),
                "dtype": _dtype_name(host), "crc32": zlib.crc32(raw)})
        np.savez(tmp / "arrays.npz", **arrays)
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        for f in ("arrays.npz", "manifest.json"):
            with open(tmp / f, "r+b") as fh:
                os.fsync(fh.fileno())
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)
        return final
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def _steps(directory: Path) -> list[int]:
    return sorted(int(p.name.split("_")[1]) for p in directory.iterdir()
                  if p.name.startswith("step_"))


def latest_step(directory: str | Path) -> int | None:
    directory = Path(directory)
    if not directory.exists():
        return None
    steps = _steps(directory)
    return steps[-1] if steps else None


def _open(directory: str | Path, template: Any,
          step: int | None) -> tuple[Path, int, list[tuple[str, torch.Tensor, dict]]]:
    """Checkpoint ``step`` (default: the newest) of ``directory``: its path,
    its step and, for each leaf of ``template`` in order, (name, leaf,
    manifest entry).  Raises on a missing leaf or a shape that differs,
    before any leaf is read."""
    directory = Path(directory)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    d = directory / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())
    by_name = {e["name"]: e for e in manifest["leaves"]}
    leaves = []
    for name, leaf in flatten_with_names(template):
        if name not in by_name:
            raise KeyError(f"checkpoint missing leaf {name}")
        e = by_name[name]
        if tuple(e["shape"]) != tuple(leaf.shape):
            raise ValueError(f"{name}: checkpoint shape {tuple(e['shape'])} != "
                             f"template {tuple(leaf.shape)}")
        leaves.append((name, leaf, e))
    return d, step, leaves


def _read(data, name: str, e: dict) -> torch.Tensor:
    """One leaf on the host, its checksum checked."""
    raw = data[e["key"]]
    if zlib.crc32(raw) != e["crc32"]:
        raise IOError(f"checksum mismatch for {name} (corrupt checkpoint)")
    return torch.from_numpy(raw).view(getattr(torch, e["dtype"])).reshape(e["shape"])


def _flat_shardings(shardings: Any, n: int) -> list:
    if shardings is None:
        return [None] * n
    flat = [s for _, s in flatten_with_names(shardings, leaf_type=NamedSharding)]
    if len(flat) != n:
        raise ValueError(f"{len(flat)} shardings for {n} leaves")
    return flat


def restore_checkpoint(directory: str | Path, template: Any, step: int | None = None,
                       shardings: Any = None) -> tuple[Any, int]:
    """A new tree of ``template``'s structure holding checkpoint ``step``
    (default: the newest), each leaf with the dtype of the template's leaf
    and on its device; and the step.  ``shardings`` (a tree of
    NamedShardings of the template's structure) reshard onto the current
    mesh, which may differ from the mesh that wrote the checkpoint; by
    default a DTensor leaf of the template gives its own layout and a plain
    one none.  Raises on a missing leaf, a shape that differs, or a
    checksum that does not match (a corrupt file)."""
    d, step, leaves = _open(directory, template, step)
    out = []
    with np.load(d / "arrays.npz") as data:
        for (name, leaf, e), sh in zip(leaves, _flat_shardings(shardings, len(leaves))):
            if sh is None and is_dtensor(leaf):
                sh = NamedSharding(leaf.device_mesh, tuple(leaf.placements))
            t = _read(data, name, e).to(device=leaf.device, dtype=leaf.dtype)
            # a plain leaf stays plain where its sharding replicates
            keep = sh is None or (not is_dtensor(leaf) and sh.replicated)
            out.append(t if keep else distribute(t, sh))
    return unflatten_like(template, iter(out)), step


@torch.no_grad()
def restore_into(directory: str | Path, state: Any, step: int | None = None,
                 shardings: Any = None) -> int:
    """Checkpoint ``step`` (default: the newest) written into ``state``'s own
    tensors, leaf by leaf from the host: the device never holds a second
    copy of the state, and a DTensor leaf takes its rank's shard, whatever
    mesh wrote the checkpoint.  ``shardings`` (a tree of NamedShardings of
    the state's structure), when given, must be the state's own layout.
    Returns the step.  A missing leaf, a shape that differs or a leaf laid
    out otherwise than ``shardings`` raises before any leaf is written; a
    checksum that does not match raises with the leaves before it already
    written."""
    d, step, leaves = _open(directory, state, step)
    for (name, leaf, _), sh in zip(leaves, _flat_shardings(shardings, len(leaves))):
        if sh is not None and not laid_out(leaf, sh):
            raise ValueError(f"{name} is not laid out as its target sharding {sh}")
    with np.load(d / "arrays.npz") as data:
        for name, leaf, e in leaves:
            dst, src = shard_like(_read(data, name, e).to(leaf.device), leaf)
            dst.copy_(src)
    return step


class CheckpointManager:
    """Async save + retention."""

    def __init__(self, directory: str | Path, keep: int = 3):
        self.directory = Path(directory)
        self.keep = keep
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="ckpt")
        self._pending: concurrent.futures.Future | None = None
        self._lock = threading.Lock()

    def save_async(self, step: int, state: Any) -> None:
        """Device -> host copy now (DTensors gathered: every rank calls
        this); file IO on rank 0's background thread."""
        host_state = to_host(state)
        self.wait()
        if _writer():
            self._pending = self._pool.submit(self._save_and_gc, step, host_state)

    def _save_and_gc(self, step: int, state: Any) -> None:
        save_checkpoint(self.directory, step, state)
        self._gc()

    def _gc(self) -> None:
        with self._lock:
            for s in _steps(self.directory)[:-self.keep]:
                shutil.rmtree(self.directory / f"step_{s:08d}", ignore_errors=True)

    def wait(self) -> None:
        """Block until the pending save is on disk (on every rank); raises
        its error."""
        if self._pending is not None:
            pending, self._pending = self._pending, None
            pending.result()
        _barrier()

    def restore_latest(self, template: Any, shardings: Any = None):
        return restore_checkpoint(self.directory, template, shardings=shardings)
