"""What every run shares: the manifest (``BENCHMARK.json``) and the files it
names, found by name; the configuration as the port runs it; the result's
line; the guard against jax in the process.

A cell names a configuration (``bench/configs/<config>.json``, with its
plain reference ``bench/reference/<module>.py``), a traffic mix
(``bench/traffic/<mix>.json``, whose ``driver`` names
``bench/drivers/<kind>.py``) and its correctness limits
(``bench/limits/<cell>.json``); each per-layer metric is
``bench/metrics/<metric>.py``.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "bench"
#: build and kernel caches of the run, at fixed paths inside the checkout
CACHE = ROOT / "build" / "bench-cache"
#: top-level module names that may not be loaded where the result is printed
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def set_cache_env() -> None:
    """Point every build and kernel cache into the checkout, and keep
    libraries from loading jax on their own."""
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["USE_FLAX"] = "0"


def process_start() -> float:
    """The process's start on the ``time.time()`` clock (Linux: from
    /proc; elsewhere the first call)."""
    try:
        ticks = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time()


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def manifest(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def cell_metrics(man: dict, cell: str) -> tuple[list[dict], list[dict]]:
    """The end-to-end and per-layer metrics the cell reports."""
    def applies(m):
        return "workloads" not in m or cell in m["workloads"]
    e2e = [m for m in man["end_to_end"] if applies(m)]
    names = {m["name"] for m in e2e}
    layer = [m for m in man["per_layer"]
             if (cell in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return e2e, layer


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    e2e: list[dict]
    per_layer: list[dict]


def resolve(man: dict, workload: str, root: Path = ROOT) -> Cell:
    cells = {w["name"]: w for w in man["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; cells: {sorted(cells)}")
    w = cells[workload]
    cfg = next(c for c in man["configs"] if c["name"] == w["config"])
    e2e, layer = cell_metrics(man, workload)
    return Cell(workload, w["chips"], load_json(root / cfg["file"]),
                load_json(root / "bench" / "traffic" / f"{w['traffic']}.json"),
                load_json(root / "bench" / "limits" / f"{workload}.json"), e2e, layer)


def spec_of(config: dict) -> dict:
    """The sizes of a configuration's file, under the names the weights,
    counts and references use."""
    spec = {"d_model": config["hidden_size"], "n_layers": config["num_hidden_layers"],
            "n_heads": config["num_attention_heads"],
            "n_kv_heads": config["num_key_value_heads"], "head_dim": config["head_dim"],
            "vocab": config["vocab_size"], "rope_theta": float(config["rope_theta"]),
            "rms_eps": float(config["rms_norm_eps"]), "qk_norm": config["qk_norm"],
            "tie_embeddings": config["tie_word_embeddings"], "moe": None,
            "d_ff": config["intermediate_size"]}
    if config.get("num_local_experts"):
        spec["moe"] = {"n_experts": config["num_local_experts"],
                       "top_k": config["num_experts_per_tok"],
                       "d_ff_expert": config["intermediate_size"],
                       "capacity_factor": config["moe_capacity_factor"],
                       "dispatch_groups": config["moe_dispatch_groups"]}
        spec["d_ff"] = 0
    return spec


def port_config(config: dict, kind: str, model=None):
    """The port's RunConfig of a configuration's file for a driver kind
    (``config[kind]`` sets the engine and, for training, TrainConfig),
    checked size by size against the file.  ``model`` replaces the port's
    ModelConfig (the tests' small ones)."""
    from repro_torch.config import EngineConfig, TrainConfig
    from repro_torch.configs import get_config
    run = get_config(config["arch"])
    if model is not None:
        run = dataclasses.replace(run, model=model)
    else:
        check_sizes(config, run.model)
    opts = dict(config[kind])
    engine = EngineConfig(kind=opts.pop("engine"), schedule=opts.pop("schedule", "wls"))
    run = dataclasses.replace(run, engine=engine)
    if kind == "train":
        run = dataclasses.replace(run, train=TrainConfig(**opts))
    return run


def check_sizes(config: dict, m) -> None:
    """Raise unless the port's ModelConfig runs the file's sizes."""
    spec, got = spec_of(config), spec_of_model(m)
    bad = {k: (spec[k], got[k]) for k in spec if spec[k] != got[k]}
    if bad or m.dtype != config["torch_dtype"] or m.act != "swiglu":
        raise SystemExit(f"{config['name']}: the port's config differs from the file: {bad}")


def spec_of_model(m) -> dict:
    """``spec_of`` for a port's ModelConfig (the tests' small ones)."""
    return {"d_model": m.d_model, "n_layers": m.n_layers, "n_heads": m.n_heads,
            "n_kv_heads": m.n_kv_heads, "head_dim": m.resolved_head_dim, "vocab": m.vocab,
            "rope_theta": float(m.rope_theta), "rms_eps": float(m.rms_eps),
            "qk_norm": m.qk_norm, "tie_embeddings": m.tie_embeddings, "d_ff": m.d_ff,
            "moe": None if m.moe is None else {
                "n_experts": m.moe.n_experts, "top_k": m.moe.top_k,
                "d_ff_expert": m.moe.d_ff_expert, "capacity_factor": m.moe.capacity_factor,
                "dispatch_groups": m.moe.dispatch_groups}}


def reference(config: dict):
    return importlib.import_module(f"bench.reference.{config['reference']}")


def driver(traffic: dict):
    return importlib.import_module(f"bench.drivers.{traffic['driver']}")


def metric_reader(name: str):
    """``read(record) -> float | None`` of ``bench/metrics/<name>.py``."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


@dataclasses.dataclass
class Context:
    """What a driver is given."""
    cell: Cell
    spec: dict
    seed: int
    seconds: float
    trace: bool
    device: object
    t_start: float
    model: object = None          # a port ModelConfig in place of the file's (tests)
    until_longest: bool = False   # keep the window open until the longest request is done
    trace_path: Path = CACHE / "trace.json"


@dataclasses.dataclass
class Outcome:
    """What a driver hands back."""
    e2e: dict                     # end-to-end values by name, setup_s among them
    record: dict                  # what the per-layer readers read
    attempted: int
    failed: int
    checks: dict                  # name -> (value, limit)
    memory_peak: int
    extra: dict = dataclasses.field(default_factory=dict)


def result(cell: Cell, out: Outcome, trace: bool, device_kind: str, count: int) -> dict:
    """The result's line: the contract's keys, with the numbers compared
    for ``correct`` last."""
    metrics = {}
    if trace:
        for m in cell.per_layer:
            value = metric_reader(m["name"])(out.record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell.e2e:
            if m["name"] in out.e2e:
                metrics[m["name"]] = {"value": out.e2e[m["name"]], "unit": m["unit"]}
    correct = out.failed == 0 and all(v <= lim for v, lim in out.checks.values())
    device = {"platform": "gpu", "kind": device_kind, "count": count,
              "memory_peak_bytes": out.memory_peak}
    line = {"correct": correct, "attempted": out.attempted, "failed": out.failed,
            "metrics": metrics, "device": device}
    tr = out.record.get("trace")
    if trace and tr:
        device["busy_s"] = tr["busy_s"]
        device["window_s"] = tr["window_s"]
        from .tracing import breakdown
        line["breakdown"] = breakdown(tr)
    line["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in out.checks.items()}
    return line


def loaded_forbidden() -> list[str]:
    return sorted(name for name, mod in list(sys.modules.items())
                  if mod is not None and name.split(".")[0] in FORBIDDEN)
