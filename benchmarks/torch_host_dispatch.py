#!/usr/bin/env python3
"""Host time of the port's dispatch on the card: the RASA GEMM's entry
point and DTensor's, read where the host sets the pace.

    python3 benchmarks/torch_host_dispatch.py serve [--src DIR] [--label NAME]
    python3 benchmarks/torch_host_dispatch.py train-profile

``serve`` imports ``repro_torch`` from ``--src`` (this checkout's ``src``
by default, so that two trees can be compared in one call) and reads, on
qwen3-1.7b FULL (bf16, random weights from seed 0, engine pallas_rasa
``wls``): the eager ServeSession's decode ms a step and prefill ms (batch
4, prompt 128, 32 greedy steps; the median of three generations after a
warm-up one), the forward loss of phase 10's batch (8 x 512) under
``torch.no_grad()`` (ms, the median of three), and ``rasa_matmul``'s
host time a call at a decode step's shape (M 4, K = N 2048, bf16: 2,000
calls in a row, then one synchronisation; the kernel is shorter than
the call, so the loop runs at the host's pace).

``train-profile`` takes one qwen3-1.7b FULL train step (engine ``xla``,
8 x 512 in 2 microbatches, as chip_smoke.py's phase 13) on a (1, 1)
DeviceMesh and one outside any mesh, each after a warm-up step, under
``torch.profiler`` (CPU activity only): each side's step ms untraced and
traced, its operators' count and the ten heaviest by self CPU time; then
the meshed step once more under ``cProfile``, its ten heaviest Python
functions by own time.  Full tables go to ``chiprun_out/``.

Each mode prints one JSON line, its last, beside the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ARCH = "qwen3-1.7b"
BATCH, PROMPT, STEPS = 4, 128, 32
TRAIN_BATCH, TRAIN_SEQ, MICROBATCHES = 8, 512, 2
CALLS = 2000
OUT = ROOT / "chiprun_out"


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def wls(cfg):
    return dataclasses.replace(cfg, engine=dataclasses.replace(
        cfg.engine, kind="pallas_rasa", schedule="wls"))


def serve(label: str) -> dict:
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.serving import ServeSession
    cfg = wls(get_config(ARCH))
    model = build_model(cfg, device="cuda", seed=0)
    session = ServeSession(model, max_seq=PROMPT + STEPS + 8, device="cuda", eager=True)
    prompts = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.model.vocab, (BATCH, PROMPT)).astype(np.int32), device="cuda")
    session.generate(prompts, STEPS)
    prefill, decode = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        session.prefill(prompts)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        session.generate(prompts, STEPS)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        prefill.append((t1 - t0) * 1e3)
        decode.append(((t2 - t1) - (t1 - t0)) * 1e3 / STEPS)
    del session
    batch = SyntheticLMDataset(cfg.model, seq_len=TRAIN_SEQ,
                               global_batch=TRAIN_BATCH).batch(0)
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in batch.items()}
    forward = []
    with torch.no_grad():
        model.loss(batch)
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            float(model.loss(batch)[0])
            forward.append((time.perf_counter() - t0) * 1e3)
    del model
    a = torch.randn(BATCH, 2048, device="cuda", dtype=torch.bfloat16)
    b = torch.randn(2048, 2048, device="cuda", dtype=torch.bfloat16)
    with torch.no_grad():
        for _ in range(100):
            ops.rasa_matmul(a, b)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(CALLS):
            ops.rasa_matmul(a, b)
        torch.cuda.synchronize()
        call_us = (time.perf_counter() - t0) * 1e6 / CALLS
    return {"mode": "serve", "label": label, "src": ops.__file__,
            "decode_ms": decode, "median_decode_ms": statistics.median(decode),
            "prefill_ms": prefill, "median_prefill_ms": statistics.median(prefill),
            "forward_ms": forward, "median_forward_ms": statistics.median(forward),
            "rasa_matmul_us_a_call": call_us}


def top(prof, n: int = 10) -> tuple[int, list]:
    rows = sorted(prof.key_averages(), key=lambda e: e.self_cpu_time_total, reverse=True)
    return sum(e.count for e in rows), [
        {"op": e.key, "count": e.count, "self_cpu_ms": e.self_cpu_time_total / 1e3}
        for e in rows[:n]]


def train_profile() -> dict:
    import cProfile
    import io
    import pstats
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.config import TrainConfig
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.distributed import mesh_context
    from repro_torch.launch.mesh import init_distributed, make_host_mesh
    from repro_torch.models import build_model
    from repro_torch.training import build_train_step, init_train_state
    from repro_torch.training.step import jit_train_step
    cfg = get_config(ARCH)
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        TrainConfig(microbatches=MICROBATCHES), global_batch=TRAIN_BATCH,
        seq_len=TRAIN_SEQ))
    data = SyntheticLMDataset(cfg.model, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH)
    init_distributed("cuda")
    mesh = make_host_mesh(device="cuda")
    OUT.mkdir(exist_ok=True)
    result = {"mode": "train-profile", "mesh": list(mesh.shape)}

    def timed(step, state, i):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, metrics = step(state, data.batch(i))
        float(metrics["loss"])
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    for side in ("meshed", "unmeshed"):
        torch.cuda.empty_cache()
        if side == "meshed":
            with mesh_context(mesh, cfg.parallel) as ctx:
                model = build_model(cfg, device="cuda", seed=cfg.train.seed)
                state = init_train_state(model)
                step = jit_train_step(model, state, data.batch(0), ctx)
                ms = [timed(step, state, i) for i in range(2)]
                with profile(activities=[ProfilerActivity.CPU]) as prof:
                    traced = timed(step, state, 2)
                pr = cProfile.Profile()
                pr.enable()
                timed(step, state, 3)
                pr.disable()
        else:
            model = build_model(cfg, device="cuda", seed=cfg.train.seed)
            state = init_train_state(model)
            step = build_train_step(model)
            ms = [timed(step, state, i) for i in range(2)]
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                traced = timed(step, state, 2)
        n_ops, heavy = top(prof)
        (OUT / f"host_dispatch_{side}_ops.txt").write_text(
            prof.key_averages().table(sort_by="self_cpu_time_total", row_limit=60))
        result[side] = {"step_ms": ms, "traced_step_ms": traced, "ops": n_ops,
                        "heaviest": heavy}
        del model, state, step, prof
    text = io.StringIO()
    stats = pstats.Stats(pr, stream=text).sort_stats("tottime")
    stats.print_stats(40)
    (OUT / "host_dispatch_meshed_python.txt").write_text(text.getvalue())
    funcs = sorted(stats.stats.items(), key=lambda kv: kv[1][2], reverse=True)[:10]
    result["meshed_python"] = {
        "total_s": stats.total_tt,
        "heaviest": [{"function": f"{Path(f).name}:{line}({name})", "calls": nc,
                      "own_s": tt, "cumulative_s": ct}
                     for (f, line, name), (_, nc, tt, ct, _) in funcs]}
    return result


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", choices=("serve", "train-profile"))
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="this tree")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: this script measures the card", file=sys.stderr)
        return 1
    result = serve(args.label) if args.mode == "serve" else train_profile()
    result["card"] = card()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
