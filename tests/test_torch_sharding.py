"""The port's sharding rules against the reference's, in one process.

The reference's rules give PartitionSpecs (axis names per tensor dim) on a
FakeMesh (tests/test_distributed.py:20-34); the port's give DTensor
placements (one per mesh dim).  Each case maps the reference's spec to
placements (``Shard(d)`` on each mesh dim named at tensor dim d) and
holds the port's equal to it:

- every parameter of all ten FULL configs (shapes from the reference's
  ``jax.eval_shape`` of init; its stacked [L, ...] layer leaves mapped to
  the port's per-layer names, whose dims lack the leading L) on meshes
  (16, 16) and (2, 16, 16) with FSDP on and off, (4, 2) and (1, 1);
- every ``activation_spec`` kind, ``kv_cache_spec`` with and without
  sequence parallelism, and ``decode_state_shardings`` on each leaf of the
  reference's decode states (batch 128 and batch 1).
"""

import functools
import types

import jax
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from _torch_parity import port_model_cfg
from repro.config import ParallelConfig as JParallel
from repro.configs import ARCH_NAMES, get_config as j_get_config
from repro.distributed.sharding import MeshContext as JCtx
from repro.distributed.sharding import activation_spec as j_activation_spec
from repro.distributed.sharding import kv_cache_spec as j_kv_cache_spec
from repro.distributed.sharding import param_spec as j_param_spec
from repro.models import build_model as j_build_model
from repro_torch.config import ParallelConfig
from repro_torch.configs import get_config
from repro_torch.distributed import (ACTIVATION_KINDS, MeshContext, activation_spec,
                                     kv_cache_spec, param_spec, param_specs)
from repro_torch.models import build_model
from repro_torch.serving.engine import decode_state_shardings

#: (name, axis sizes, fsdp)
MESHES = [("16x16", {"data": 16, "model": 16}, True),
          ("16x16-nofsdp", {"data": 16, "model": 16}, False),
          ("2x16x16", {"pod": 2, "data": 16, "model": 16}, True),
          ("2x16x16-nofsdp", {"pod": 2, "data": 16, "model": 16}, False),
          ("4x2", {"data": 4, "model": 2}, True),
          ("1x1", {"data": 1, "model": 1}, True)]
MESH_IDS = [m[0] for m in MESHES]


class JFakeMesh:
    def __init__(self, shape_map, axis_names):
        self.shape = shape_map
        self.axis_names = axis_names


def contexts(sizes: dict, fsdp: bool, sp: bool = False):
    """(reference MeshContext, port MeshContext) on fake meshes of ``sizes``."""
    names = tuple(sizes)
    pods = sizes.get("pod", 1)
    jctx = JCtx(mesh=JFakeMesh(sizes, names),
                parallel=JParallel(pods=pods, fsdp=fsdp, sequence_parallel_decode=sp))
    mesh = types.SimpleNamespace(mesh_dim_names=names, shape=tuple(sizes.values()))
    tctx = MeshContext(mesh=mesh, parallel=ParallelConfig(
        pods=pods, fsdp=fsdp, sequence_parallel_decode=sp))
    return jctx, tctx


def to_placements(spec, names) -> tuple:
    """The reference's PartitionSpec as one placement per mesh dim."""
    out = [Replicate()] * len(names)
    for dim, axes in enumerate(spec):
        if axes is not None:
            for a in (axes if isinstance(axes, tuple) else (axes,)):
                out[names.index(a)] = Shard(dim)
    return tuple(out)


@functools.lru_cache(maxsize=None)
def reference_leaves(arch: str, smoke: bool = False) -> tuple:
    """(port name, reference leaf name, reference shape, stacked) of every
    parameter of the reference's init of ``arch``."""
    api = j_build_model(j_get_config(arch, smoke=smoke))
    shapes = jax.eval_shape(api.init, jax.random.key(0))
    out = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        keys = [p.key for p in path]
        stacked = keys[0] == "layers"
        name = f"layers.0.{keys[1]}" if stacked else ".".join(keys)
        out.append((name, keys[-1], tuple(leaf.shape), stacked))
    return tuple(out)


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_placements_match_reference(arch, mesh):
    _, sizes, fsdp = mesh
    jctx, tctx = contexts(sizes, fsdp)
    names = tuple(sizes)
    leaves = reference_leaves(arch)
    shapes = {name: shape[1:] if stacked else shape for name, _, shape, stacked in leaves}
    got = param_specs(shapes, tctx)
    for name, leaf, shape, stacked in leaves:
        want = j_param_spec(leaf, shape, jctx)
        if stacked:                          # the port's layer lacks the leading L dim
            assert len(want) == 0 or want[0] is None, (name, want)
            want = want[1:]
        assert got[name] == to_placements(want, names), (name, shape, want, got[name])
        assert param_spec(name, shapes[name], tctx) == got[name]


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_port_parameters_are_the_mapped_leaves(arch):
    """The port's parameter names and shapes (smoke model) are the
    reference's leaves under the name mapping the placement test uses."""
    model = build_model(get_config(arch, smoke=True), device="cpu")
    port = {n: tuple(p.shape) for n, p in model.named_parameters()
            if not n.startswith("layers.") or n.startswith("layers.0.")}
    want = {name: shape[1:] if stacked else shape
            for name, _, shape, stacked in reference_leaves(arch, smoke=True)}
    assert port == want


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("kind", ACTIVATION_KINDS)
def test_activation_placements_match_reference(kind, mesh):
    _, sizes, fsdp = mesh
    jctx, tctx = contexts(sizes, fsdp)
    assert activation_spec(kind, tctx) == to_placements(j_activation_spec(kind, jctx),
                                                        tuple(sizes))


KV_LAYOUTS = [(8, 128), (1, 256), (4, 64), (2, 16), (16, 128), (32, 128)]


@pytest.mark.parametrize("sp", [None, True, False])
@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
def test_kv_cache_placements_match_reference(mesh, sp):
    _, sizes, fsdp = mesh
    for default_sp in (False, True):
        jctx, tctx = contexts(sizes, fsdp, sp=default_sp)
        for n_kv, hd in KV_LAYOUTS:
            want = j_kv_cache_spec(n_kv, hd, jctx, sequence_parallel=sp)
            got = kv_cache_spec(n_kv, hd, tctx, sequence_parallel=sp)
            assert got == to_placements(want, tuple(sizes)), (n_kv, hd, default_sp)


def test_kv_cache_spec_without_a_mesh():
    assert j_kv_cache_spec(8, 128) == jax.sharding.PartitionSpec()
    assert kv_cache_spec(8, 128) is None


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_decode_state_placements_match_reference(arch, mesh, monkeypatch):
    import repro.serving.engine as j_engine
    # the reference wraps each spec in a NamedSharding of its (real) mesh:
    # keep the spec itself on the fake one
    monkeypatch.setattr(j_engine, "NamedSharding", lambda mesh, spec: spec)
    _, sizes, fsdp = mesh
    cfg = j_get_config(arch)
    api = j_build_model(cfg)
    port_model = types.SimpleNamespace(model=port_model_cfg(cfg.model))
    for sp in (False, True):
        jctx, tctx = contexts(sizes, fsdp, sp=sp)
        for batch in (128, 1):
            state = jax.eval_shape(lambda: api.init_decode_state(batch, 64))
            want = j_engine.decode_state_shardings(api, state, jctx)
            flat = jax.tree_util.tree_flatten_with_path(state)[0]
            specs = jax.tree_util.tree_leaves(
                want, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
            leaves = {jax.tree_util.keystr(p): torch.empty(leaf.shape, device="meta")
                      for p, leaf in flat}
            got = decode_state_shardings(port_model, leaves, tctx)
            for (path, _), spec in zip(flat, specs, strict=True):
                key = jax.tree_util.keystr(path)
                assert got[key].placements == to_placements(spec, tuple(sizes)), (key, batch)
