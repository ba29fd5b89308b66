#!/usr/bin/env python3
"""Two ranks on one card: serve qwen3-1.7b FULL under a (1, 2) TP mesh.

    python3 benchmarks/torch_tp2_one_card.py [--steps 8]

NCCL takes one device per rank, so a world of two on one H100 needs
another backend: this script starts two processes on the same card with a
gloo group over CUDA tensors (``backend="cuda:gloo,cpu:gloo"``), serves
the port's qwen3-1.7b FULL (bf16, random weights from seed 0, batch 4,
prompt 128, engine pallas_rasa ``wls``) through the eager ServeSession
under a (1, 2) DeviceMesh
(tensor parallel; the graphed session cannot capture gloo's host-side
collectives), and holds it against the same weights served by a world of
one in each process: the prefill logits and each decode step's logits
(the steps teacher-forced on the world of one's greedy tokens) within
rel_err 0.15 (bf16, the kernel-vs-xla tolerance), and the count of steps
whose greedy tokens agree.  If gloo refuses a collective on CUDA tensors,
the exact error is the result.  Each rank logs its stages as it reaches
them (flushed), and a rank still running ``HANG_S`` seconds after its
mesh is made dumps every thread's stack to its standard error, and again
every ``HANG_S`` seconds (``faulthandler``), which shows the collective it
waits on; the group's timeout is 120 s.  Ranks that have not reported
``WAIT_S`` seconds after the start are sent SIGUSR1 (another dump) and
killed; the JSON line gives each rank's exit code at that point (None:
still running).  The parent prints one JSON line and writes it to
chiprun_out/tp2_one_card.json.  ``--device cpu --smoke``
rehearses the same flow on the CPU.
"""

from __future__ import annotations

import argparse
import datetime
import faulthandler
import json
import multiprocessing
import os
import queue
import signal
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BATCH, PROMPT = 4, 128
TOL = 0.15
HANG_S = 150     # a rank's stacks are dumped this long after its mesh is made
WAIT_S = 300     # the parent's wait for both ranks' results


def rel_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max() / want.float().abs().max())


def logits_run(torch, session, prompts, forced):
    """Prefill, then one decode step per token of ``forced`` [B, steps]
    (the first argument's greedy tokens when None): the logits of each, on
    the host, and the greedy tokens; and ms a decode step."""
    logits = [session.prefill(prompts).float().cpu()]
    tokens = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps = forced.shape[1]
    for i in range(steps):
        tok = torch.argmax(logits[-1], dim=-1).to(torch.int32)
        tokens.append(tok)
        logits.append(session.decode_step(forced[:, i].to(prompts.device)).float().cpu())
    torch.cuda.synchronize()
    return logits, torch.stack(tokens, 1), (time.perf_counter() - t0) * 1e3 / steps


def rank_main(rank: int, port: int, steps: int, device: str, smoke: bool, out) -> None:
    sys.path.insert(0, str(ROOT / "src"))
    import dataclasses
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.distributed import mesh_context
    from repro_torch.launch.mesh import _mesh
    from repro_torch.launch.serve import prompts_for
    from repro_torch.models import build_model
    from repro_torch.serving import ServeSession
    result = {"rank": rank, "steps": steps, "stages": []}
    t_start = time.perf_counter()
    faulthandler.enable()
    faulthandler.register(signal.SIGUSR1, all_threads=True)

    def stage(name):
        result["stages"].append([name, round(time.perf_counter() - t_start, 3)])
        print(f"rank {rank}: {name} at {result['stages'][-1][1]} s", flush=True)

    if device == "cpu":
        torch.cuda.synchronize = lambda *a, **k: None
    try:
        if device == "cuda":
            torch.cuda.set_device(0)
        dist.init_process_group("cuda:gloo,cpu:gloo" if device == "cuda" else "gloo",
                                init_method=f"tcp://localhost:{port}", rank=rank,
                                world_size=2, timeout=datetime.timedelta(seconds=120))
        stage("process group")
        base = get_config("qwen3-1.7b", smoke=smoke)
        cfg = dataclasses.replace(base, engine=dataclasses.replace(
            base.engine, kind="pallas_rasa", schedule="wls"))
        prompts = torch.as_tensor(prompts_for(cfg, BATCH, PROMPT), device=device)
        max_seq = PROMPT + steps + 8
        one = ServeSession(build_model(cfg, device=device, seed=0), max_seq, device=device,
                           eager=True)
        free = torch.zeros((BATCH, steps), dtype=torch.int32)
        # the world of one's greedy tokens, then its logits teacher-forced on them
        _, greedy, _ = logits_run(torch, one, prompts, free)
        want, _, one_ms = logits_run(torch, one, prompts, greedy)
        result["world1_decode_ms"] = one_ms
        stage("world of one served")
        del one
        mesh = _mesh(device, (1, 2), ("data", "model"))
        stage("mesh")
        faulthandler.dump_traceback_later(HANG_S, repeat=True)
        try:
            with mesh_context(mesh, cfg.parallel):
                tp = ServeSession(build_model(cfg, device=device, seed=0), max_seq,
                                  device=device, eager=True)
                stage("model distributed")
                got, tokens, tp_ms = logits_run(torch, tp, prompts, greedy)
                stage("tp served")
        except Exception as e:  # noqa: BLE001 -- the refusal is the result
            result.update(ok=False, error=f"{type(e).__name__}: {e}",
                          where=traceback.format_exc().strip().splitlines()[-3:])
        else:
            errs = [rel_err(g, w) for g, w in zip(got, want)]
            result.update(ok=max(errs) < TOL, prefill_rel_err=errs[0],
                          decode_rel_err=errs[1:], max_rel_err=max(errs),
                          tokens_agree=int((tokens == greedy.cpu()).all(dim=0).sum()),
                          tp2_decode_ms=tp_ms)
    except Exception as e:  # noqa: BLE001 -- reported by rank 0's line
        result.update(ok=False, error=f"{type(e).__name__}: {e}",
                      where=traceback.format_exc().strip().splitlines()[-3:])
    faulthandler.cancel_dump_traceback_later()
    stage("done")
    out.put(result)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch.mesh import free_port
    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=rank_main, args=(r, port, args.steps, args.device,
                                                 args.smoke, out))
             for r in range(2)]
    deadline = time.monotonic() + WAIT_S
    for p in procs:
        p.start()
    results = []
    try:
        for _ in procs:
            results.append(out.get(timeout=max(deadline - time.monotonic(), 1)))
    except queue.Empty:
        results.append({"rank": -1, "ok": False, "error": f"a rank did not report in {WAIT_S} s"})
    exitcodes = [p.exitcode for p in procs]
    if len(results) < len(procs):
        for p in procs:
            if p.is_alive():
                os.kill(p.pid, signal.SIGUSR1)
        time.sleep(2)
    for p in procs:
        p.join(timeout=30)
        if p.is_alive():
            p.kill()
    results.sort(key=lambda r: r["rank"])
    line = {"ranks": results, "exitcodes_at_wait_end": exitcodes,
            "ok": all(r.get("ok") for r in results)}
    print(json.dumps(line))
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "tp2_one_card.json").write_text(json.dumps(line, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
