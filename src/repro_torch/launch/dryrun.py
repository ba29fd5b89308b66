"""Multi-pod dry run: trace every (arch x shape x mesh) cell on a fake world.

Counterpart of the JAX package's ``launch/dryrun.py``, which lowers and
compiles each cell for 256 or 512 fake host devices and reads XLA's
``memory_analysis``, ``cost_analysis`` and optimized HLO.  Here each cell
runs once, eagerly, on rank 0 of a fake process group of 256 or 512 ranks
(``torch.testing._internal.distributed.fake_pg``): the model is built
under ``FakeTensorMode`` on the card's device type, so nothing is
allocated and no kernel runs; its parameters and state are distributed by
the port's rules (``distributed/sharding.py``) over the production mesh
(``launch.mesh.make_production_mesh``), and the step (the sharded train
step, prefill or decode step) is traced under ``StepCounter``, which sees
the local operators DTensor issues on rank 0's shards:

  * FLOPs per device: ``FlopCounterMode``'s formulas (products only:
    ``mm``, ``bmm``, ``addmm``, attention, convolution, and the RASA GEMM's
    own, ``kernels/ops.py``) on the local shapes.  XLA's ``flops`` also
    counts elementwise work, so the two differ by that;
  * bytes accessed per device: operand and result bytes of every operator
    that is not a view, unfused (XLA counts a fusion's operands and
    results once);
  * collectives per device: the result bytes of each of DTensor's
    collectives, under the reference's names (``all-gather``, ...) with
    ``_count`` keys, as the reference reads the HLO's result shapes;
    ``wait_tensor`` (XLA's ``-done``) is not counted;
  * memory per device, in the reference's four terms: arguments (rank 0's
    local bytes of the step's inputs: parameters, optimizer or decode
    state, tokens), outputs, temp (the most bytes allocated during the
    step and alive at once, beyond the outputs) and alias (the state the
    step updates in place, XLA's donated buffers); peak = argument +
    output + temp - alias, as in the reference.

Rematerialisation recomputes the forward in the backward and is counted,
as XLA counts it (``useful_flops_ratio`` shows it).  The trace's seconds
(model build, distribution and step) stand under ``lower_s``; nothing
compiles, so ``compile_s`` is 0.0; there is no HLO, so ``hlo_bytes`` is
left out.  Each cell's JSON goes to ``<out>/<arch>__<shape>__pod{1,2}.json``
(default ``build/dryrun/``) with every key ``roofline/analysis.py`` reads.

XLA counts a scan body once, so the reference also compiles depth-0 and
one-unit variants (``--layer-costs``).  The eager trace counts every layer,
so the full-depth counts are already totals (the artifact says so:
``counts_every_layer``, and ``analyze_all`` takes them as they are); the
flag still writes the ``__d0`` / ``__d<unit>`` artifacts (the same cell at
that depth), a unit's cost: full FLOPs = d0 + n_units x (d_unit - d0)
exactly; bytes and collective bytes differ from that by the head's input,
whose placements at depth 0 are the embedding's, not a layer's.

It must run as its own process (``python -m repro_torch.launch.dryrun``),
because it starts a process group; ``--device cpu`` traces the CPU's path
(a CPU-only torch cannot trace autograd on fake CUDA tensors).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys
import time
import traceback
import weakref
from pathlib import Path
from typing import Any, Callable

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.weak import WeakIdKeyDictionary

RESULTS_DIR = Path(__file__).resolve().parents[3] / "build" / "dryrun"

#: DTensor's functional collectives and c10d's in-place ones, by the
#: reference's HLO names
COLLECTIVES = {
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "allreduce_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter", "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_base_": "all-to-all",
}
#: operators whose every output element is one transcendental function
TRANSCENDENTAL = {"exp", "exp2", "expm1", "log", "log1p", "log2", "tanh", "sigmoid",
                  "rsqrt", "sqrt", "sin", "cos", "erf", "silu", "gelu", "softplus",
                  "pow", "_softmax", "_log_softmax", "logsumexp"}
#: operators that only allocate: they read and write nothing
ALLOCATORS = {"empty", "empty_strided", "empty_like", "new_empty", "new_empty_strided"}


def _tensors(tree) -> list[torch.Tensor]:
    """The tensors among an operator's arguments or results."""
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _leaves(tree) -> list[torch.Tensor]:
    """The tensors of a model-level tree (dicts, NamedTuples, lists,
    dataclasses such as a KVCache)."""
    from ..distributed.sharding import map_tree
    out = []
    map_tree(out.append, tree)
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard on this rank, or the tensor itself."""
    return t._local_tensor if hasattr(t, "_local_tensor") else t


def storages_bytes(tree) -> dict[int, int]:
    """{storage id: bytes} of the distinct storages of a tree's tensors
    (DTensors: this rank's shard), each counted once however many views
    share it."""
    out = {}
    for t in _leaves(tree):
        st = _local(t).untyped_storage()
        out[st._cdata] = st.nbytes()
    return out


class StepCounter(TorchDispatchMode):
    """Counts what rank 0 runs: FLOPs (``FlopCounterMode``'s formulas),
    bytes accessed, collectives and transcendental elements of every local
    operator, and the bytes of the storages operators allocate, alive and
    at their peak.  DTensor operators pass through (``NotImplemented``)
    to the local operators they issue; the global-shape operators DTensor's
    sharding propagation runs to infer output shapes are not counted
    (``dtensor_on_fake``).  Under fake tensors, ``wait_tensor`` returns
    its input, as on the card (its fake kernel makes a new tensor)."""

    def __init__(self):
        super().__init__()
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry
        self.dtensor = DTensor
        self.flop_registry = flop_registry
        self.flops = 0
        self.bytes = 0
        self.transcendentals = 0
        self.collectives: dict[str, int] = {}
        self.live = 0
        self.peak = 0
        self._owned = WeakIdKeyDictionary()
        self._paused = 0

    def own(self, tree) -> None:
        """Count ``tree``'s storages as existing before the step (its
        arguments): an operator that writes them allocates nothing."""
        for t in _leaves(tree):
            self._owned.setdefault(_local(t).untyped_storage(), 0)

    @contextlib.contextmanager
    def paused(self):
        self._paused += 1
        try:
            yield
        finally:
            self._paused -= 1

    def _free(self, size: int) -> None:
        self.live -= size

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        if st in self._owned:
            return
        size = st.nbytes()
        self._owned[st] = size
        weakref.finalize(st, self._free, size)
        self.live += size
        self.peak = max(self.peak, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, self.dtensor) for t in types):
            return NotImplemented
        name = func._overloadpacket.__name__
        if name == "wait_tensor":
            return args[0]
        out = func(*args, **kwargs)
        if self._paused:
            return out
        packet = func._overloadpacket
        if packet in self.flop_registry:
            # an overload's dtype (mm.dtype, bmm.dtype) is no shape: left out,
            # as some versions' formulas take no argument past the shapes
            shapes = [a for a in args if not isinstance(a, torch.dtype)]
            self.flops += self.flop_registry[packet](*shapes, **kwargs, out_val=out)
        outs = _tensors(out)
        if name in COLLECTIVES:
            key = COLLECTIVES[name]
            self.collectives[key] = (self.collectives.get(key, 0)
                                     + sum(_nbytes(t) for t in outs))
            self.collectives[f"{key}_count"] = self.collectives.get(f"{key}_count", 0) + 1
        if name in TRANSCENDENTAL:
            self.transcendentals += sum(t.numel() for t in outs)
        if not func.is_view and name not in ALLOCATORS:
            self.bytes += (sum(_nbytes(t) for t in _tensors((args, kwargs)))
                           + sum(_nbytes(t) for t in outs))
        if not func.is_view:
            for t in outs:
                self._track(t)
        return out


@contextlib.contextmanager
def _patched(owner, name: str, wrap):
    """``owner.name`` replaced by ``wrap(original)`` inside the block."""
    orig = getattr(owner, name)
    setattr(owner, name, wrap(orig))
    try:
        yield
    finally:
        setattr(owner, name, orig)


@contextlib.contextmanager
def dtensor_on_fake(counter: StepCounter | None = None):
    """Two places where DTensor's Python code does not run as it does on
    real tensors, each patched inside the block:

    * its sharding propagation runs an operator on global-shape fake
      tensors to infer its output's shape: ``counter`` (if given) pauses
      there, so that only rank 0's local operators count;
    * a ``_StridedShard`` (a split dim reshaped, such as grouped-query
      heads) reads its shard's offsets to the host with ``.tolist()``,
      which a fake tensor refuses: that arithmetic on index tensors runs
      on real (CPU) tensors, and ``counter`` pauses there too.
    """
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor import placement_types
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    with contextlib.ExitStack() as stack:
        if counter is not None:
            name = next((n for n in ("_propagate_tensor_meta_non_cached",
                                     "_propagate_tensor_meta")
                         if hasattr(ShardingPropagator, n)), None)
            if name is None:
                raise RuntimeError("this torch's ShardingPropagator has no tensor-meta "
                                   "propagation to keep out of the counts")

            def paused(orig):
                def propagate(self, *args, **kwargs):
                    with counter.paused():
                        return orig(self, *args, **kwargs)
                return propagate
            stack.enter_context(_patched(ShardingPropagator, name, paused))
        strided = getattr(placement_types, "_StridedShard", None)
        if strided is not None and "local_shard_size_and_offset" in vars(strided):
            def real(orig):
                def offsets(self, *args, **kwargs):
                    with unset_fake_temporarily(), (counter.paused() if counter is not None
                                                    else contextlib.nullcontext()):
                        return orig(self, *args, **kwargs)
                return offsets
            stack.enter_context(_patched(strided, "local_shard_size_and_offset", real))
        yield


@contextlib.contextmanager
def fake_world(n: int):
    """A fake process group of ``n`` ranks, this process rank 0: collectives
    return at once and move nothing.  Destroyed on exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group exists: the dry run starts its own fake one "
                           "(run it as its own process)")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def fake_model(cfg, device):
    """The model of ``cfg`` with fake parameters on ``device`` (call inside
    a ``FakeTensorMode``): the parameters' shapes and dtypes come from an
    initialisation on the meta device, which draws nothing."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from ..distributed.sharding import map_tree
    from ..models import init_params, model_of
    with unset_fake_temporarily():
        meta = init_params(cfg, torch.Generator(), torch.device("meta"))
    return model_of(cfg, map_tree(
        lambda t: torch.zeros(t.shape, dtype=t.dtype, device=device), meta))


@dataclasses.dataclass
class Step:
    """A cell's step: ``run()`` traces it once and returns its outputs;
    ``args`` are its inputs (parameters and state included), ``donated``
    the part of them it updates in place."""
    run: Callable[[], Any]
    args: Any
    donated: Any


def _placed(spec: torch.Tensor, sharding, device) -> torch.Tensor:
    """A tensor of ``spec``'s shape and dtype on ``device`` placed as
    ``sharding``."""
    from ..distributed.sharding import distribute
    return distribute(torch.zeros(spec.shape, dtype=spec.dtype, device=device), sharding)


def build_step(cfg, shape_kind: str, seq_len: int, batch: int, ctx, device) -> Step:
    """The cell's step on the context's mesh (call inside ``mesh_context``
    and a ``FakeTensorMode``), as the reference's ``build_step``: train,
    the sharded train step on the FSDP x TP state (AdamW moments in
    ``opt_state_dtype``) and a batch placed by ``batch_shardings``;
    prefill / decode, the sharded steps (parameters by
    ``_params_shardings``, the decode state of ``seq_len`` by
    ``decode_state_spec``, tokens batch over DP)."""
    from ..configs import input_specs
    from ..serving.engine import _token_sharding, jit_decode_step
    from ..training.step import batch_shardings, build_train_step, init_train_state

    model = fake_model(cfg, device)
    if shape_kind == "train":
        specs = input_specs(cfg, "train_4k", seq_len=seq_len, global_batch=batch)
        state = init_train_state(model)
        b_sh = batch_shardings(specs, ctx)
        placed = {k: _placed(v, b_sh[k], device) for k, v in specs.items()}
        step = build_train_step(model)
        return Step(lambda: step(state, placed), (state, placed), state)

    jit_decode_step(model, ctx)              # distributes the parameters for serving
    params = list(model.parameters())
    state = model.init_decode_state(batch, max_seq=seq_len)
    if shape_kind == "prefill":
        spec = input_specs(cfg, "prefill_32k", seq_len=seq_len, global_batch=batch)["tokens"]
        fn = model.prefill
    else:
        name = "long_500k" if seq_len >= 500_000 else "decode_32k"
        spec = input_specs(cfg, name, seq_len=seq_len, global_batch=batch)["token"]
        fn = model.decode_step
    tokens = _placed(spec, _token_sharding(ctx, spec.shape), device)
    return Step(lambda: fn(tokens, state), (params, tokens, state), state)


def cell_config(arch: str, shape: str, multi_pod: bool, reduced_depth: int | None = None):
    """The cell's RunConfig, as the reference's ``run_cell`` makes it: two
    pods for the multi-pod mesh, sequence-parallel decode for long_500k,
    and ``reduced_depth`` layers for a layer-cost variant (no other change:
    the eager trace already counts every chunk the reference unrolls)."""
    from ..configs import get_config
    cfg = get_config(arch)
    if multi_pod:
        cfg = dataclasses.replace(cfg, parallel=dataclasses.replace(cfg.parallel, pods=2))
    if shape == "long_500k":
        cfg = dataclasses.replace(cfg, parallel=dataclasses.replace(
            cfg.parallel, sequence_parallel_decode=True))
    if reduced_depth is not None:
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, n_layers=reduced_depth))
    return cfg


def step_arguments(cfg, kind: str, seq_len: int, batch: int, mesh,
                   device="cuda") -> int:
    """Rank 0's argument bytes of the cell's step on ``mesh`` (the step is
    built, not traced; inside a fake world)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from ..distributed.sharding import mesh_context
    with FakeTensorMode(), dtensor_on_fake(), mesh_context(mesh, cfg.parallel) as ctx:
        step = build_step(cfg, kind, seq_len, batch, ctx, torch.device(device))
        return sum(storages_bytes(step.args).values())


def trace(cfg, kind: str, seq_len: int, batch: int, mesh, device="cuda") -> dict:
    """Build and trace one step of ``cfg`` on ``mesh`` (inside a fake
    world): {"memory", "cost_per_device", "collectives_per_device_bytes",
    "lower_s"} in the reference's keys."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from ..distributed.sharding import mesh_context
    t0 = time.perf_counter()
    counter = StepCounter()
    with (FakeTensorMode(), dtensor_on_fake(counter),
          mesh_context(mesh, cfg.parallel) as ctx):
        step = build_step(cfg, kind, seq_len, batch, ctx, torch.device(device))
        args = storages_bytes(step.args)
        counter.own(step.args)
        with counter:
            outputs = step.run()
        outs = storages_bytes(outputs)
        donated = storages_bytes(step.donated)
    argument = sum(args.values())
    output = sum(outs.values())
    alias = sum(b for k, b in outs.items() if k in donated)
    new_out = sum(b for k, b in outs.items() if k not in args)
    temp = max(counter.peak - new_out, 0)
    return {
        "lower_s": round(time.perf_counter() - t0, 3), "compile_s": 0.0,
        "memory": {
            "argument_bytes_per_device": argument,
            "output_bytes_per_device": output,
            "temp_bytes_per_device": temp,
            "alias_bytes_per_device": alias,
            "peak_bytes_per_device": argument + output + temp - alias,
        },
        "cost_per_device": {
            "flops": float(counter.flops),
            "transcendentals": float(counter.transcendentals),
            "bytes_accessed": float(counter.bytes),
        },
        "collectives_per_device_bytes": counter.collectives,
    }


def _cell_path(out: Path, arch: str, shape: str, multi_pod: bool,
               reduced_depth: int | None = None) -> Path:
    pod = "pod2" if multi_pod else "pod1"
    suffix = "" if reduced_depth is None else f"__d{reduced_depth}"
    return out / f"{arch}__{shape}__{pod}{suffix}.json"


def run_cell(arch: str, shape: str, multi_pod: bool, force: bool = False,
             reduced_depth: int | None = None, out: Path = RESULTS_DIR,
             device="cuda") -> dict:
    """Trace one cell on a fake world of 256 (or 512) ranks and write its
    artifact; an existing artifact is read back unless ``force``."""
    from ..config import SHAPES
    from ..configs import cell_applicable, get_config
    from .mesh import make_production_mesh

    path = _cell_path(Path(out), arch, shape, multi_pod, reduced_depth)
    if path.exists() and not force:
        return json.loads(path.read_text())
    path.parent.mkdir(parents=True, exist_ok=True)
    ok, why = cell_applicable(arch, shape)
    if not ok:
        result = {"arch": arch, "shape": shape, "skipped": True, "reason": why}
        path.write_text(json.dumps(result, indent=2))
        return result

    seq_len, batch, kind = SHAPES[shape]
    cfg = cell_config(arch, shape, multi_pod, reduced_depth)
    n_dev = 512 if multi_pod else 256
    with fake_world(n_dev):
        counts = trace(cfg, kind, seq_len, batch,
                       make_production_mesh(multi_pod=multi_pod, device=device), device)
    full = get_config(arch).model
    unit = full.hybrid.attn_every if full.family == "hybrid" else 1
    result = {
        "arch": arch, "shape": shape, "multi_pod": multi_pod,
        "unit_layers": unit, "total_layers": full.n_layers,
        "mesh": [2, 16, 16] if multi_pod else [16, 16], "devices": n_dev,
        "kind": kind, "seq_len": seq_len, "batch": batch,
        "reduced_depth": reduced_depth, "counts_every_layer": True,
        "device": torch.device(device).type, **counts,
    }
    path.write_text(json.dumps(result, indent=2))
    return result


def run_layer_costs(arch: str, shape: str, force: bool = False, out: Path = RESULTS_DIR,
                    device="cuda") -> None:
    """The depth-0 and one-unit variants on the single-pod mesh."""
    from ..configs import get_config
    m = get_config(arch).model
    unit = m.hybrid.attn_every if m.family == "hybrid" else 1
    for depth in (0, unit):
        run_cell(arch, shape, multi_pod=False, force=force, reduced_depth=depth,
                 out=out, device=device)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description="multi-pod dry run on a fake world")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--layer-costs", action="store_true",
                    help="also trace the depth-0 and one-unit variants (the "
                         "roofline's per-layer costs)")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default=str(RESULTS_DIR),
                    help="directory of the cells' JSON (default build/dryrun/)")
    ap.add_argument("--device", default="cuda",
                    help="the device type the fake tensors take (default cuda)")
    args = ap.parse_args(argv)

    from ..configs import ARCH_NAMES, SHAPES

    archs = [args.arch] if args.arch else ARCH_NAMES
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = [False, True] if (args.both_meshes or args.all) else [args.multi_pod]
    out = Path(args.out)
    failures = 0
    t_all = time.perf_counter()
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                tag = f"{arch} x {shape} x {'2x16x16' if mp else '16x16'}"
                try:
                    r = run_cell(arch, shape, mp, force=args.force, out=out,
                                 device=args.device)
                    if r.get("skipped"):
                        print(f"[skip] {tag}: {r['reason']}", flush=True)
                        continue
                    mem = r["memory"]["peak_bytes_per_device"] / 2**30
                    print(f"[ ok ] {tag}: peak {mem:.2f} GiB/dev, trace {r['lower_s']}s "
                          f"(flops/dev {r['cost_per_device']['flops']:.3g})", flush=True)
                    if args.layer_costs and not mp:
                        run_layer_costs(arch, shape, force=args.force, out=out,
                                        device=args.device)
                        print(f"[ ok ] {tag}: layer-cost artifacts written", flush=True)
                except Exception as e:
                    failures += 1
                    print(f"[FAIL] {tag}: {type(e).__name__}: {e}", flush=True)
                    traceback.print_exc()
    print(f"dry run: {failures} failed, {time.perf_counter() - t_all:.1f} s", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
