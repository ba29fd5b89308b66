"""Logical-axis sharding rules -> DTensor placements (DP / FSDP / TP / SP / EP).

Counterpart of the JAX package's ``distributed/sharding.py``, over a
``torch.distributed.device_mesh.DeviceMesh`` with the reference's axis
names ("pod", "data", "model").  Strategy:

  * batch (DP)            over ("pod", "data")  [multi-pod] or ("data",)
  * parameter storage     FSDP over the data axes (d_model-ish dims)
  * tensor parallel (TP)  over "model" (heads / ff / vocab dims)
  * sequence parallel     over "data" for the long KV cache (decode)
  * experts               TP within each expert (the expert dim replicated)

A rule is first a partition spec, as the reference writes it: per tensor
dim, None, an axis name or a tuple of axis names (``_param_partition``,
``_activation_partition``).  ``placements`` turns it into one DTensor
placement per mesh dim: ``Shard(d)`` on each mesh dim named at tensor dim
d (several axes at one dim shard it major to minor, as DTensor applies
the mesh dims in order), ``Replicate()`` on the others.  An axis that
does not divide its dim is dropped (the tensor is replicated over it), as
in the reference, so DTensor never shards unevenly.

Parameter rules are keyed on leaf *names* (wq, wo, w_up, experts_w1,
...): the port's parameters are per layer ("layers.3.wq"), so the rule
applies to the last part of the name; the reference's stacked [L, ...]
leaves take the same rule behind a leading None, which gives the same
placements.  Every rank builds the same weights from the same seed, so
distributing a tensor (``distribute``) keeps the local shard of the full
tensor the rank already holds and moves no data.

Inside ``mesh_context`` plain tensors mix with DTensors as replicated ones
(DTensor's ``implicit_replication``), so the models' own index and mask
tensors need no conversion.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Mapping

import torch
from torch import nn

from ..config import ParallelConfig


class _State:
    """The active mesh context: the process's, not a thread's, since the
    autograd engine runs a CUDA backward (and a checkpoint's recomputed
    forward) on a thread of its own, which must lay tensors out as the
    forward did."""
    ctx: "MeshContext | None" = None


_STATE = _State()

#: partition spec of one tensor: per dim, None, an axis name or a tuple of them
Spec = tuple


@dataclasses.dataclass(frozen=True)
class MeshContext:
    """The active mesh (a ``DeviceMesh``, or any object with its
    ``mesh_dim_names`` and ``shape``) and the run's ParallelConfig."""
    mesh: Any
    parallel: ParallelConfig

    @property
    def axis_sizes(self) -> dict[str, int]:
        return dict(zip(self.mesh.mesh_dim_names, self.mesh.shape))

    @property
    def fsdp_axes(self) -> tuple[str, ...] | None:
        if not self.parallel.fsdp:
            return None
        return self.dp_axes or None

    @property
    def dp_axes(self) -> tuple[str, ...]:
        return tuple(a for a in ("pod", "data") if a in self.mesh.mesh_dim_names)

    def axes_size(self, axes) -> int:
        """The number of shards over ``axes`` (a name or a tuple of names)."""
        sizes = self.axis_sizes
        return math.prod(sizes[a] for a in _as_tuple(axes))


def current_ctx() -> MeshContext | None:
    return _STATE.ctx


@contextlib.contextmanager
def mesh_context(mesh, parallel: ParallelConfig):
    """Make ``mesh`` the active mesh for ``parallel``; plain tensors mix
    with DTensors as replicated ones inside."""
    from torch.distributed.tensor.experimental import implicit_replication
    prev = _STATE.ctx
    _STATE.ctx = MeshContext(mesh, parallel)
    try:
        with implicit_replication():
            yield _STATE.ctx
    finally:
        _STATE.ctx = prev


def _as_tuple(axes) -> tuple[str, ...]:
    return axes if isinstance(axes, tuple) else (axes,)


def _fit(spec: Spec, shape, ctx: MeshContext) -> Spec:
    """``spec`` with each axis entry that does not divide its dim dropped."""
    return tuple(None if axes is None or dim % ctx.axes_size(axes) else axes
                 for dim, axes in zip(shape, spec))


def placements(spec: Spec, ctx: MeshContext, shape=None) -> tuple:
    """One DTensor placement per mesh dim for partition spec ``spec``
    (``Shard(d)`` where a mesh dim names tensor dim d, else ``Replicate()``);
    with ``shape``, axes that do not divide their dim are dropped first."""
    from torch.distributed.tensor import Replicate, Shard
    if shape is not None:
        spec = _fit(tuple(spec) + (None,) * (len(shape) - len(spec)), shape, ctx)
    names = list(ctx.mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for dim, axes in enumerate(spec):
        if axes is not None:
            for a in _as_tuple(axes):
                out[names.index(a)] = Shard(dim)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """Where a tensor lives: a mesh and one placement per mesh dim (the
    rule's; ``effective`` is what a DTensor of it holds)."""
    mesh: Any
    placements: tuple

    @property
    def effective(self) -> tuple:
        return effective(self.placements, self.mesh)

    @property
    def replicated(self) -> bool:
        return all(p.is_replicate() for p in self.placements)


def effective(placements_: tuple, mesh) -> tuple:
    """The placements a DTensor takes for ``placements_`` on ``mesh``: a
    split over a mesh dim of size 1 splits nothing and becomes
    ``Replicate()`` (DTensor refuses views of a dim it counts as split,
    such as a decode step's sequence of one)."""
    from torch.distributed.tensor import Replicate
    return tuple(Replicate() if p.is_shard() and size == 1 else p
                 for p, size in zip(placements_, mesh.shape))


def laid_out(t: torch.Tensor, sharding: NamedSharding) -> bool:
    """Whether ``t`` is laid out as ``sharding``: a DTensor of it, or a
    plain tensor (the same on every rank) where it replicates."""
    if not is_dtensor(t):
        return sharding.replicated
    return t.device_mesh == sharding.mesh and tuple(t.placements) == sharding.effective


# ---------------------------------------------------------------- parameters

def _param_rules(fsdp) -> dict[str, Spec]:
    """leaf-name -> partition spec (without the stacked-layer leading dim)."""
    f = fsdp  # None (replicated storage) or axis tuple
    return {
        # embeddings / head
        "embedding": ("model", f),           # [V, D]
        "lm_head": (f, "model"),             # [D, V] (or [D, cb*V])
        "patch_proj": (f, "model"),          # vlm stub frontend
        # attention
        "wq": (f, "model"),                  # [D, H*hd]
        "wk": (f, "model"),
        "wv": (f, "model"),
        "wo": ("model", f),                  # [H*hd, D]
        "q_norm": (),                        # [hd]
        "k_norm": (),
        # dense mlp
        "w_gate": (f, "model"),              # [D, F]
        "w_up": (f, "model"),
        "w_gate_up": (f, None, "model"),     # [D, 2, F] (fused)
        "w_down": ("model", f),              # [F, D]
        # moe
        "router": (f, None),                 # [D, E]
        "experts_w_gate": (None, f, "model"),    # [E, D, Fe]
        "experts_w_up": (None, f, "model"),
        "experts_w_gate_up": (None, f, None, "model"),  # [E, D, 2, Fe]
        "experts_w_down": (None, "model", f),    # [E, Fe, D]
        # mamba2 / ssd
        "in_proj": (f, "model"),             # [D, proj]
        "out_proj": ("model", f),            # [di, D]
        "conv_w": (None, "model"),           # [k, channels]
        "conv_b": ("model",),
        "A_log": (),                         # [h]
        "D_skip": (),                        # [h]
        "dt_bias": (),
        "ssm_norm": ("model",),              # [di]
        # norms
        "scale": (),
        "norm1": (), "norm2": (), "norm3": (), "final_norm": (),
    }


def _param_partition(name: str, shape, ctx: MeshContext) -> Spec:
    """The reference's ``param_spec`` as a partition spec: the rule of the
    leaf name (a leading None for a stacked [L, ...] leaf), replicated for
    an unknown name or another rank, axes that do not divide dropped."""
    spec = _param_rules(ctx.fsdp_axes).get(name.rsplit(".", 1)[-1])
    if spec is None:
        return ()                            # replicate unknown small params
    if len(shape) == len(spec) + 1:
        spec = (None, *spec)
    elif len(shape) != len(spec):
        return ()                            # biases / scalars sharing a rule name
    return _fit(spec, shape, ctx)


def param_spec(name: str, shape, ctx: MeshContext | None = None) -> tuple:
    """DTensor placements (one per mesh dim) of parameter ``name`` (its
    last dotted part picks the rule) of ``shape`` on the context's mesh."""
    ctx = _require(ctx)
    return placements(_param_partition(name, tuple(shape), ctx), ctx)


def param_specs(params: Mapping[str, Any], ctx: MeshContext | None = None) -> dict:
    """{name: placements} for a mapping of names to tensors (or shapes)."""
    return {name: param_spec(name, getattr(t, "shape", t), ctx)
            for name, t in params.items()}


def distribute(t: torch.Tensor, sharding: NamedSharding) -> torch.Tensor:
    """``t`` (the full tensor, the same on every rank) as a DTensor of
    ``sharding``: each rank keeps its own shard; no data moves."""
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(t, sharding.mesh, list(sharding.effective),
                             src_data_rank=None)


def is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def full(t: torch.Tensor) -> torch.Tensor:
    """A DTensor gathered into the full tensor on every rank, or the tensor
    itself."""
    return t.full_tensor() if is_dtensor(t) else t


def unshard_dim(x: torch.Tensor, dim: int) -> torch.Tensor:
    """A DTensor with its partial sums reduced and dim ``dim`` gathered
    (replicated over the mesh dims that split it; other splits kept), for
    an op that DTensor cannot run on a split dim; a plain tensor as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    dim %= x.dim()
    target = tuple(Replicate() if p.is_shard(dim) or p.is_partial() else p
                   for p in x.placements)
    return x if target == tuple(x.placements) else x.redistribute(x.device_mesh, target)


def _batch_axes(ctx: MeshContext, batch: int) -> tuple[str, ...]:
    """The data axes a batch of ``batch`` splits over: all of them, else the
    innermost ones that divide it, else none."""
    dp = ctx.dp_axes
    for i in range(len(dp)):
        if batch % ctx.axes_size(dp[i:]) == 0:
            return dp[i:]
    return ()


def map_shards(fn, args: tuple, dims: tuple, out_dims):
    """``fn(*args)`` on each rank's shards, for a computation independent
    along a batch and a heads axis.  ``dims[i]`` is (the batch dim, the
    heads dim) of ``args[i]`` (None where it has none, or for an arg that
    is None), ``out_dims`` those of fn's result (a tuple of them for a
    tuple result).  Under a mesh context with a DTensor among the args,
    each arg is laid out with its batch split over the data axes and its
    heads over "model" (each where it divides; else that axis repeats the
    work), its other splits and partial sums gathered; fn runs on the local
    shards and its results come back as DTensors of that layout.  Else
    fn(*args).  GSPMD partitions such a computation the same way; DTensor's
    rules for the reshapes inside it differ between torch versions."""
    ctx = current_ctx()
    if ctx is None or not any(is_dtensor(a) for a in args):
        return fn(*args)
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = ctx.mesh
    batch = next(a.shape[d[0]] for a, d in zip(args, dims) if d[0] is not None)
    heads = next((a.shape[d[1]] for a, d in zip(args, dims) if d[1] is not None), None)
    batch_axes = _batch_axes(ctx, batch)
    split_heads = (heads is not None and "model" in mesh.mesh_dim_names
                   and heads % ctx.axes_size("model") == 0)

    def layout(t: torch.Tensor, batch_dim, heads_dim) -> tuple:
        out = []
        for name in mesh.mesh_dim_names:
            if name in batch_axes and batch_dim is not None:
                out.append(Shard(batch_dim % t.dim()))
            elif name == "model" and split_heads and heads_dim is not None:
                out.append(Shard(heads_dim % t.dim()))
            else:
                out.append(Replicate())
        return effective(tuple(out), mesh)

    def local(a, d):
        if a is None:
            return None
        target = layout(a, *d)
        if not is_dtensor(a):
            return distribute(a, NamedSharding(mesh, target)).to_local()
        return (a if tuple(a.placements) == target else a.redistribute(mesh, target)).to_local()

    out = fn(*(local(a, d) for a, d in zip(args, dims)))
    wrap = lambda t, d: None if t is None else DTensor.from_local(t, mesh, layout(t, *d),
                                                                  run_check=False)
    if isinstance(out, tuple):
        return tuple(wrap(t, d) for t, d in zip(out, out_dims))
    return wrap(out, out_dims)


def _reshape_groups(src: tuple, dst: tuple) -> list[tuple[list[int], list[int]]]:
    """The (source dims, target dims) runs of a reshape from ``src`` to
    ``dst``: dims whose sizes multiply to the same product; a dim of size
    1 stands alone."""
    groups, i, j = [], 0, 0
    while i < len(src) or j < len(dst):
        if i < len(src) and src[i] == 1:
            groups.append(([i], []))
            i += 1
            continue
        if j < len(dst) and dst[j] == 1:
            groups.append(([], [j]))
            j += 1
            continue
        gi, gj, pi, pj = [i], [j], src[i], dst[j]
        i, j = i + 1, j + 1
        while pi != pj:
            if pi < pj:
                gi.append(i)
                pi *= src[i]
                i += 1
            else:
                gj.append(j)
                pj *= dst[j]
                j += 1
        groups.append((gi, gj))
    return groups


def _view_layout(x: torch.Tensor, dst: tuple) -> torch.Tensor:
    """DTensor ``x`` with each split gathered (``Replicate``) that a view to
    ``dst`` cannot keep: a split dim merged behind another dim, or split
    into pieces whose first does not divide by its shard count."""
    from torch.distributed.tensor import Replicate
    src = tuple(x.shape)
    mesh, placements = x.device_mesh, list(x.placements)
    for gi, gj in _reshape_groups(src, dst):
        if len(gi) == 1 and len(gj) <= 1:
            continue
        for d in gi:
            splits = [m for m, p in enumerate(placements) if p.is_shard(d)]
            count = math.prod(mesh.size(m) for m in splits)
            keep = d == gi[0] and src[d] % count == 0 and (
                len(gj) == 1 or (gj and dst[gj[0]] % count == 0))
            if not keep:
                for m in splits:
                    placements[m] = Replicate()
    return x if placements == list(x.placements) else x.redistribute(mesh, placements)


class _Reshape(torch.autograd.Function):
    """A DTensor's reshape whose backward reshapes the gradient back the
    same way (gathering what that view cannot keep)."""

    @staticmethod
    def forward(ctx, x, shape):
        ctx.shape = tuple(x.shape)
        return _view_layout(x, shape).reshape(shape)

    @staticmethod
    def backward(ctx, g):
        return _view_layout(g, ctx.shape).reshape(ctx.shape), None


def reshape(x: torch.Tensor, *shape: int) -> torch.Tensor:
    """``x.reshape(shape)``.  A DTensor first has gathered each split that
    the view cannot keep, and so has its gradient on the way back (some
    torch versions' DTensor refuses such a view outright, others rewrite
    it into strided shards; the gather gives the same numbers on all).  A
    plain tensor is reshaped as it is."""
    if not is_dtensor(x):
        return x.reshape(*shape)
    dst = list(shape)
    if -1 in dst:
        known = math.prod(d for d in dst if d != -1)
        dst[dst.index(-1)] = x.numel() // known
    return _Reshape.apply(x, tuple(dst))


def single_split(x: torch.Tensor) -> torch.Tensor:
    """A DTensor whose dims are each split over one mesh dim at most: a dim
    split over several keeps the innermost split and is gathered over the
    others (a lookup's sharding rule takes one mesh dim a tensor dim); a
    plain tensor as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    target, seen = list(x.placements), set()
    for m in reversed(range(len(target))):
        p = target[m]
        if p.is_shard():
            if p.dim in seen:
                target[m] = Replicate()
            seen.add(p.dim)
    if target == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, target)


def shard_like(src: torch.Tensor, dst: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(dst's local shard, src laid out as dst and local) for an in-place
    write of src into dst on each rank's own shard (DTensor has no rule for
    a slice assignment or an ``index_copy_`` into a sharded tensor).  dst
    must not be sharded along the sequence (dim 2 of a cache), where the
    write position picks the rank: ``write_prefix`` and ``write_at`` write
    there.  For a plain dst: (dst, src gathered)."""
    if not is_dtensor(dst):
        return dst, full(src)
    if any(p.is_shard(2) for p in dst.placements):
        raise NotImplementedError("an in-place write into a cache sharded along the "
                                  "sequence (sequence_parallel_decode): write it with "
                                  "write_prefix or write_at")
    return dst.to_local(), _local_as(src, dst, tuple(dst.placements))


def _local_as(src: torch.Tensor, dst: torch.Tensor, placements_: tuple) -> torch.Tensor:
    """This rank's shard of src laid out on dst's mesh as ``placements_``."""
    sharding = NamedSharding(dst.device_mesh, placements_)
    src = (src.redistribute(sharding.mesh, sharding.effective) if is_dtensor(src)
           else distribute(src, sharding))
    return src.to_local()


def _split_along(src: torch.Tensor, dst: torch.Tensor, dim: int):
    """For a DTensor dst split along ``dim``: (dst's local shard, the offset
    of its slice of ``dim``, src laid out as dst but whole along ``dim``,
    local); None when dst is not split along ``dim``."""
    if not is_dtensor(dst) or not any(p.is_shard(dim) for p in dst.placements):
        return None
    from torch.distributed.tensor import Replicate, Shard
    mesh, coord = dst.device_mesh, dst.device_mesh.get_coordinate()
    size, offset = dst.shape[dim], 0
    for i, p in enumerate(dst.placements):     # split major to minor, mesh dim by mesh dim
        if p.is_shard(dim):
            if type(p) is not Shard or size % mesh.size(i):
                raise ValueError(f"dim {dim} of {tuple(dst.shape)} is not split evenly "
                                 f"by {dst.placements}")
            size //= mesh.size(i)
            offset += coord[i] * size
    whole = tuple(Replicate() if p.is_shard(dim) else p for p in dst.placements)
    return dst.to_local(), offset, _local_as(src, dst, whole)


def write_prefix(dst: torch.Tensor, dim: int, src: torch.Tensor) -> None:
    """dst's first ``src.shape[dim]`` entries along ``dim`` = src, in place
    on each rank's own shard (a prefill's cache write).  Where dst is split
    along ``dim``, each rank writes the part of the prefix inside its own
    slice; the prefix length is static, so no rank waits on another."""
    n = src.shape[dim]
    split = _split_along(src, dst, dim)
    if split is None:
        dst, src = shard_like(src, dst)
        dst.narrow(dim, 0, n).copy_(src)
        return
    local, start, src = split
    count = min(local.shape[dim], n - start)
    if count > 0:
        local.narrow(dim, 0, count).copy_(src.narrow(dim, start, count))


def write_at(dst: torch.Tensor, dim: int, index: torch.Tensor, src: torch.Tensor) -> None:
    """``dst.index_copy_(dim, index, src)`` in place on each rank's own shard
    (a decode step's cache write at the position held in ``index``, a
    one-element tensor on the device).  Where dst is split along ``dim``
    the position picks the rank: every rank writes either src or the entry
    it already holds at the position clamped into its slice, decided on
    the device (nothing syncs with the host)."""
    split = _split_along(src, dst, dim)
    if split is None:
        dst, src = shard_like(src, dst)
        dst.index_copy_(dim, index, src)
        return
    if index.numel() != 1:
        raise ValueError(f"a write into a tensor split along dim {dim} takes one "
                         f"position, got {index.numel()}")
    local, start, src = split
    rel = index - start
    inside = (rel >= 0) & (rel < local.shape[dim])
    rel = rel.clamp(0, local.shape[dim] - 1)
    keep = local.index_select(dim, rel)
    local.index_copy_(dim, rel, torch.where(inside, src, keep))


@torch.no_grad()
def shardings_for(module: nn.Module, ctx: MeshContext | None = None) -> dict:
    """Distribute ``module``'s parameters over the context's mesh by their
    rules, in place (each becomes a DTensor ``Parameter``, its
    ``requires_grad`` kept; one already on this mesh is left as it is);
    returns {name: NamedSharding}."""
    ctx = _require(ctx)
    out = {}
    for name, p in list(module.named_parameters()):
        sharding = NamedSharding(ctx.mesh, param_spec(name, p.shape, ctx))
        out[name] = sharding
        if is_dtensor(p):
            if laid_out(p, sharding):
                continue
            raise ValueError(f"{name} is already distributed as {p.placements} on "
                             f"{p.device_mesh}; build the model anew for another layout")
        owner, _, leaf = name.rpartition(".")
        sub = module.get_submodule(owner) if owner else module
        setattr(sub, leaf, nn.Parameter(distribute(p.data, sharding),
                                        requires_grad=p.requires_grad))
    return out


# --------------------------------------------------------------- activations

def _activation_partition(kind: str, ctx: MeshContext) -> Spec:
    dp = ctx.dp_axes
    return {
        "tokens": (dp, None),
        # residual stream: sequence sharded over "model" between blocks
        # (Megatron-style sequence parallelism)
        "btd": (dp, "model", None),
        "btf": (dp, None, "model"),
        "logits": (dp, None, "model"),
        "bhsd": (dp, "model", None, None),
        "bd": (dp, None),
        # MoE expert buffers [E, G*C, *] (group-major): capacity over DP,
        # expert hidden over model
        "ecd": (None, dp, None),
        "ecf": (None, dp, "model"),
        # audio per-codebook logits [B, S, cb, V]
        "bscv": (dp, None, None, "model"),
    }[kind]


#: the activation kinds of ``activation_spec``
ACTIVATION_KINDS = ("tokens", "btd", "btf", "logits", "bhsd", "bd", "ecd", "ecf", "bscv")


def activation_spec(kind: str, ctx: MeshContext | None = None, shape=None) -> tuple:
    """Canonical activation placements of ``kind`` (tokens [B,S] | btd
    [B,S,D] | btf [B,S,F] | logits [B,S,V] | bhsd [B,H,S,hd] | bd [B,D] |
    ecd / ecf, the MoE's expert buffers | bscv, audio's logits); with
    ``shape``, for a tensor of that shape (the kind's dims from the first,
    each axis that does not divide its dim dropped)."""
    ctx = _require(ctx)
    return placements(_activation_partition(kind, ctx), ctx, shape)


def constrain(x: torch.Tensor, kind: str) -> torch.Tensor:
    """``x`` redistributed to the placements of ``kind`` when it is a
    DTensor under an active mesh context; the identity otherwise (and so
    outside a mesh: no op, no copy).  Mesh axes that do not divide the
    concrete dim are dropped (decode steps with S=1, small batches, smoke
    configs)."""
    ctx = current_ctx()
    if ctx is None or not is_dtensor(x):
        return x
    target = effective(activation_spec(kind, ctx, x.shape), ctx.mesh)
    if tuple(x.placements) == target:
        return x
    return x.redistribute(ctx.mesh, target)


def kv_cache_spec(n_kv_heads: int, head_dim: int, ctx: MeshContext | None = None,
                  sequence_parallel: bool | None = None) -> tuple | None:
    """Placements of a [B, Hkv, S, hd] cache, or None outside a mesh.

    Default: batch over DP, kv heads over model (falling back to head_dim
    when kv heads don't divide, e.g. MQA kv=1 with head_dim 256).
    Sequence-parallel decode: sequence over "data", batch replicated.
    """
    ctx = ctx or current_ctx()
    if ctx is None:
        return None
    return placements(_kv_partition(n_kv_heads, head_dim, ctx, sequence_parallel), ctx)


def _kv_partition(n_kv_heads: int, head_dim: int, ctx: MeshContext,
                  sequence_parallel: bool | None = None) -> Spec:
    model = ctx.axis_sizes.get("model", 1)
    heads_shardable = n_kv_heads % model == 0
    hd_shardable = head_dim % model == 0
    sp = (ctx.parallel.sequence_parallel_decode
          if sequence_parallel is None else sequence_parallel)
    if sp:
        if heads_shardable:
            return (None, "model", "data", None)
        return (None, None, "data", "model" if hd_shardable else None)
    dp = ctx.dp_axes
    if heads_shardable:
        return (dp, "model", None, None)
    if hd_shardable:
        return (dp, None, None, "model")
    return (dp, None, None, None)


def decode_state_spec(cfg, shape, ctx: MeshContext) -> tuple:
    """Placements of one decode-state leaf of ``shape`` for ModelConfig
    ``cfg`` (the reference's ``decode_state_shardings`` rule): a stacked KV
    cache [L (or apps), B, Hkv, S, hd] by ``kv_cache_spec`` behind the
    stacking dim (batch replicated when it does not divide), an SSM state
    [L, B, H, P, N] or conv window [L, B, k-1, C] batch over DP when it
    divides, anything else (lengths, position) replicated."""
    shape = tuple(shape)
    dp = ctx.dp_axes
    dp_size = ctx.axes_size(dp) if dp else 1
    if (len(shape) == 5 and cfg.n_kv_heads and shape[2] == cfg.n_kv_heads
            and shape[4] == cfg.resolved_head_dim):
        base = list(_kv_partition(cfg.n_kv_heads, cfg.resolved_head_dim, ctx,
                                  ctx.parallel.sequence_parallel_decode))
        if base[0] is not None and shape[1] % dp_size != 0:
            base[0] = None           # batch too small to shard
        return placements((None, *base), ctx)
    if cfg.ssm is not None and len(shape) in (4, 5) and shape[0] == cfg.n_layers:
        batch = dp if shape[1] % dp_size == 0 else None
        return placements((None, batch), ctx)
    return placements((), ctx)


def place_state(cfg, t: torch.Tensor) -> torch.Tensor:
    """A decode-state buffer made by ``init_decode_state`` placed on the
    active mesh by ``decode_state_spec``: the KV caches and SSM states (4
    dims and more) become DTensors; lengths and the position stay plain
    tensors, the same on every rank (replicated).  Outside a mesh, ``t``."""
    ctx = current_ctx()
    if ctx is None or t.dim() < 4:
        return t
    return distribute(t, NamedSharding(ctx.mesh, decode_state_spec(cfg, t.shape, ctx)))


def decode_state_shardings(model, state, ctx: MeshContext | None = None):
    """A tree of ``state``'s structure (``DecodeState`` / ``HybridState``,
    their per-layer cache views included) with a NamedSharding per tensor
    (``decode_state_spec``) for ``model`` (either family)."""
    ctx = _require(ctx)
    return map_tree(lambda t: NamedSharding(
        ctx.mesh, decode_state_spec(model.model, t.shape, ctx)), state)


def map_tree(fn, tree):
    """``fn`` over every tensor leaf of a tree of dicts, NamedTuples, lists,
    tuples and dataclasses (a KVCache), keeping the structure."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_tree(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tree(fn, v) for v in tree)
    if dataclasses.is_dataclass(tree):
        return type(tree)(**{f.name: map_tree(fn, getattr(tree, f.name))
                             for f in dataclasses.fields(tree)})
    return tree


def _require(ctx: MeshContext | None) -> MeshContext:
    ctx = ctx or current_ctx()
    if ctx is None:
        raise RuntimeError("no mesh context: call inside mesh_context(mesh, parallel) "
                           "or pass ctx")
    return ctx
