"""The port's dry run (``launch/dryrun.py``) against the reference's: its
artifacts, argument bytes, collectives, and the RASA GEMM on fake tensors.

Each case that starts a fake process group runs in a subprocess of its own
(``_torch_dryrun.run_case``).  Held to the reference:

- argument bytes: rank 0's argument bytes of every applicable cell of the
  ten FULL configs on the (16, 16) mesh, and of two configs on (2, 16, 16),
  equal the reference's, computed from its own partition specs (on
  tests/test_torch_sharding.py's fake meshes) by shard shapes with ceil
  division, as XLA pads an uneven split.  Neither step is traced;
- collectives on a fake (2, 2) world: Shard -> Replicate is one all-gather
  of the result's bytes, Partial -> Replicate one all-reduce, Partial ->
  Shard one reduce-scatter; ``wait_tensor`` is not counted;
- the CLI on mamba2-130m x decode_32k at FULL width writes artifacts that
  ``analyze_all`` reads (the port's counts are totals, taken as they are;
  its layer-cost artifacts give the full FLOPs back);
- the RASA GEMM on fake tensors goes through its operator and counts
  2 M K N: a pallas_rasa smoke forward counts the FLOPs of its xla twin.
"""

import dataclasses
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import torch

from _torch_dryrun import run_case, run_cases
from repro.configs import get_config as j_get_config
from repro.configs import input_specs as j_input_specs
from repro.distributed.sharding import activation_spec as j_activation_spec
from repro.distributed.sharding import param_specs as j_param_specs
from repro.models import build_model as j_build_model
from repro_torch.config import SHAPES
from repro_torch.configs import all_cells, get_config
from repro_torch.launch import dryrun
from repro_torch.roofline import analyze_all
from test_torch_sharding import contexts

ROOT = Path(__file__).resolve().parents[1]


# ------------------------------------------------------------ argument bytes

def _leaf_bytes(shape, dtype, spec, sizes: dict) -> int:
    """Bytes of one shard of a leaf under partition spec ``spec`` (ceil
    division, as XLA pads an uneven split)."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    n = 1
    for dim, axes in zip(shape, spec):
        split = 1
        for a in (() if axes is None else axes if isinstance(axes, tuple) else (axes,)):
            split *= sizes[a]
        n *= -(-dim // split)
    return n * jnp.dtype(dtype).itemsize


@functools.lru_cache(maxsize=None)
def _reference_params(arch: str):
    return jax.eval_shape(j_build_model(j_get_config(arch)).init, jax.random.key(0))


def reference_argument_bytes(arch: str, shape: str, sizes: dict, monkeypatch) -> int:
    """The reference's argument bytes per device of the cell, from the
    partition specs its ``build_step`` gives the step's arguments."""
    import repro.serving.engine as j_engine
    monkeypatch.setattr(j_engine, "NamedSharding", lambda mesh, spec: spec)
    P = jax.sharding.PartitionSpec
    seq, batch, kind = SHAPES[shape]
    cfg = j_get_config(arch)
    jctx, _ = contexts(sizes, cfg.parallel.fsdp, sp=shape == "long_500k")
    api = j_build_model(cfg)
    params = _reference_params(arch)
    leaves = []                                   # (shape, dtype, spec)

    def add(tree, specs):
        flat = jax.tree.leaves(tree)
        sp = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, P))
        assert len(flat) == len(sp)
        leaves.extend((l.shape, l.dtype, s) for l, s in zip(flat, sp))

    if kind == "train":
        pspecs = j_param_specs(params, jctx)
        add(params, pspecs)
        opt_dt = jnp.dtype(cfg.parallel.opt_state_dtype)
        for _ in ("m", "v"):
            add(jax.tree.map(lambda l: jax.ShapeDtypeStruct(l.shape, opt_dt), params), pspecs)
        leaves.extend([((), jnp.int32, P()), ((), jnp.int32, P())])    # the two steps
        for name, v in j_input_specs(cfg, shape, seq_len=seq, global_batch=batch).items():
            kind_ = "tokens" if v.ndim == 2 and name != "patch_embeds" else "btd"
            leaves.append((v.shape, v.dtype, j_activation_spec(kind_, jctx)))
    else:
        add(params, j_param_specs(params, jctx))
        state = jax.eval_shape(lambda: api.init_decode_state(batch, max_seq=seq))
        add(state, j_engine.decode_state_shardings(api, state, jctx))
        spec = j_input_specs(cfg, shape, seq_len=seq, global_batch=batch)
        tok = spec["tokens"] if kind == "prefill" else spec["token"]
        if kind == "prefill":
            tspec = j_activation_spec("tokens", jctx)
        else:
            dp = jctx.dp_axes
            tspec = P(dp if batch % 16 == 0 else None, *([None] * (tok.ndim - 1)))
        leaves.append((tok.shape, tok.dtype, tspec))
    return sum(_leaf_bytes(s, d, sp, sizes) for s, d, sp in leaves)


POD1 = {"data": 16, "model": 16}
POD2 = {"pod": 2, "data": 16, "model": 16}
POD2_ARCHS = ("qwen3-1.7b", "zamba2-2.7b")


def test_argument_bytes_match_reference(monkeypatch):
    cells = [(a, s) for a, s, _, _ in all_cells()]
    pod2 = [(a, s) for a, s in cells if a in POD2_ARCHS]
    half = len(cells) // 2
    first, second, got2 = run_cases(("argument_bytes", cells[:half], False),
                                    ("argument_bytes", cells[half:], False),
                                    ("argument_bytes", pod2, True))
    got = {**first, **second}
    assert len(cells) == 32
    for (arch, shape), results, sizes in ([(c, got, POD1) for c in cells]
                                          + [(c, got2, POD2) for c in pod2]):
        want = reference_argument_bytes(arch, shape, sizes, monkeypatch)
        assert results[f"{arch}|{shape}"] == want, (arch, shape, sizes)


# ------------------------------------------------------------- collectives

def test_collectives_are_counted_by_result_bytes():
    got = run_case("collectives")
    ag, ag_bytes = got["shard_to_replicate"]
    ar, ar_bytes = got["partial_to_replicate"]
    rs, rs_bytes = got["partial_to_shard"]
    assert ag == {"all-gather": ag_bytes, "all-gather_count": 1}
    assert ar == {"all-reduce": ar_bytes, "all-reduce_count": 1}
    assert rs == {"reduce-scatter": rs_bytes, "reduce-scatter_count": 1}
    assert (ag_bytes, ar_bytes, rs_bytes) == (128 * 96 * 4, 64 * 96 * 4, 64 * 48 * 4)


# -------------------------------------------------------------------- CLI

def test_cli_writes_artifacts_analyze_all_reads(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                           "mamba2-130m", "--shape", "decode_32k", "--layer-costs",
                           "--device", "cpu", "--out", str(tmp_path)],
                          capture_output=True, text=True, timeout=600, cwd=ROOT, env=env)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "[ ok ] mamba2-130m x decode_32k x 16x16: peak" in proc.stdout
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == ["mamba2-130m__decode_32k__pod1.json",
                     "mamba2-130m__decode_32k__pod1__d0.json",
                     "mamba2-130m__decode_32k__pod1__d1.json"]
    cell = json.loads((tmp_path / names[0]).read_text())
    assert cell["devices"] == 256 and cell["mesh"] == [16, 16] and cell["compile_s"] == 0.0
    assert cell["memory"]["peak_bytes_per_device"] == (
        cell["memory"]["argument_bytes_per_device"] + cell["memory"]["output_bytes_per_device"]
        + cell["memory"]["temp_bytes_per_device"] - cell["memory"]["alias_bytes_per_device"])
    assert cell["counts_every_layer"]
    (r,) = analyze_all(tmp_path)
    assert (r.arch, r.shape, r.devices, r.extrapolated) == ("mamba2-130m", "decode_32k",
                                                            256, False)
    assert r.flops_per_device == cell["cost_per_device"]["flops"] > 0
    assert r.bytes_per_device == cell["cost_per_device"]["bytes_accessed"] > 0
    assert r.peak_mem_bytes == cell["memory"]["peak_bytes_per_device"] > 0
    assert 0 < r.mfu < 1 and r.dominant in ("compute", "memory", "collective")
    d0, d1 = (json.loads((tmp_path / n).read_text()) for n in names[1:])
    assert (d0["reduced_depth"], d1["reduced_depth"]) == (0, 1)
    layers = cell["total_layers"]
    assert cell["cost_per_device"]["flops"] == (d0["cost_per_device"]["flops"] + layers * (
        d1["cost_per_device"]["flops"] - d0["cost_per_device"]["flops"]))


def test_cells_outside_the_shapes_are_skipped(tmp_path):
    r = dryrun.run_cell("qwen3-1.7b", "long_500k", False, out=tmp_path, device="cpu")
    assert r["skipped"] and "full-attention" in r["reason"]
    assert json.loads((tmp_path / "qwen3-1.7b__long_500k__pod1.json").read_text()) == r


# --------------------------------------------------------------- RASA GEMM

def test_rasa_gemm_on_fake_tensors_counts_its_products():
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.config import EngineConfig
    counts = {}
    for kind in ("xla", "pallas_rasa"):
        base = get_config("qwen3-1.7b", smoke=True)
        cfg = dataclasses.replace(base, engine=EngineConfig(kind=kind, schedule="wls"))
        with FakeTensorMode():
            model = dryrun.fake_model(cfg, torch.device("cpu"))
            state = model.init_decode_state(2, 16)
            with FlopCounterMode(display=False) as fc:
                logits, _ = model.prefill(torch.zeros((2, 16), dtype=torch.int32), state)
        assert logits.shape == (2, cfg.model.vocab)
        counts[kind] = fc.get_flop_counts()["Global"]
    rasa = counts["pallas_rasa"]
    assert sum(counts["xla"].values()) == sum(rasa.values()) > 0
    assert rasa[torch.ops.repro_torch.rasa_mm] > 0
