#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU: build, check, time, serve.

    python3 chip_smoke.py

Phases, each of which raises (exit code != 0) when it fails:
  1. the card: name and power limit;
  2. the build of every CUDA source under src/repro_torch/kernels/csrc/;
  3. every kernel against its plain PyTorch version, on the card, at the
     GEMM shapes of qwen3-1.7b (M in {4, 512}) and at ragged shapes, bf16 and
     f32, with and without C: rel_err < 1e-5, schedules bit-identical;
  4. kernel times at the main-path shapes against their bound, the plain
     version and torch.matmul (the yardstick the port never calls);
  5. serving: qwen3-1.7b at full width, random weights from a seeded
     torch.Generator, ServeSession.generate (batch 4, prompt 128, 32 steps)
     under the pallas_rasa engine (wls, wlbp, base) and the xla engine.
The line before the last is the kernels' JSON summary and the card line;
the last line is {"ok": true, "device": {...}}.  Without a CUDA device, or
without the repository beside it, it exits non-zero and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
F32_SIMT_FLOPS = 67e12         # H100 SXM fp32 outside the tensor cores
REL_TOL = 1e-5                 # the reference's GEMM tolerance
SERVE_TOL = 2e-2               # the reference's pallas-vs-xla tolerance
BF16_TOL = 0.15                # the reference's bf16 logits tolerance
BATCH, PROMPT, STEPS = 4, 128, 32
SOURCE = "src/repro_torch/kernels/csrc/rasa_gemm.cu"
REPLACES = {"base": "src/repro/kernels/rasa_gemm.py:103 (_ws_call, schedule=base)",
            "wlbp": "src/repro/kernels/rasa_gemm.py:103 (_ws_call, schedule=wlbp)",
            "wls": "src/repro/kernels/rasa_gemm.py:140 (rasa_gemm, schedule=wls)"}


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def rel_err(got, want) -> float:
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp_min(1e-6)).item()


def device_ms(torch, fn, reps: int) -> tuple[float, float]:
    """(device, wall) ms of one fn() call: the CUDA kernels' own time summed
    from a torch.profiler trace, and CUDA-event time including launch gaps;
    means over reps runs after a warm-up."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    wall = start.elapsed_time(end) / reps
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    dev_us = sum(e.self_device_time_total for e in prof.key_averages())
    if dev_us <= 0:
        raise RuntimeError("the profiler trace shows no device time")
    return dev_us / reps / 1e3, wall


def layer_shapes(m) -> list[tuple[int, int, int]]:
    """(K, N, count per layer) of one decoder layer's GEMMs."""
    d, hd, f = m.d_model, m.resolved_head_dim, m.d_ff
    return [(d, m.n_heads * hd, 1), (d, m.n_kv_heads * hd, 2),
            (m.n_heads * hd, d, 1), (d, f, 2), (f, d, 1)]


def check_kernels(torch, rk, cfg) -> dict[str, float]:
    """Phase 3: every schedule against the plain version; returns the max
    abs error per schedule."""
    m = cfg.model
    main = rk.GemmBlocks(cfg.engine.block_m, cfg.engine.block_k, cfg.engine.block_n)
    small = rk.GemmBlocks(128, 128, 128)
    gen = torch.Generator(device="cuda").manual_seed(1)
    rnd = lambda *shape: torch.randn(shape, device="cuda", generator=gen)
    cases = [(mm, k, n, False, main) for k, n, _ in layer_shapes(m)
             for mm in (4, 512)]
    cases += [(mm, m.d_model, m.vocab, True, main) for mm in (4, 512)]
    cases += [(1, 256, 256, False, small), (257, 130, 100, False, small),
              (130, 260, 140, False, small), (3, 130, 100, False, small),
              (4, 260, 140, True, small)]
    worst = {s: 0.0 for s in rk.SCHEDULES}
    emb = {}
    for mm, k, n, transposed, blocks in cases:
        for dtype in (torch.bfloat16, torch.float32):
            a = rnd(mm, k).to(dtype)
            if transposed:        # the tied head: embedding.T, read in place
                if (dtype, n, k) not in emb:
                    emb[(dtype, n, k)] = rnd(n, k).to(dtype)
                b = emb[(dtype, n, k)].T
            else:
                b = rnd(k, n).to(dtype)
            for c in (None, rnd(mm, n)):
                want = rk.rasa_gemm_plain(a, b, c, blocks=blocks)
                outs = {s: rk.rasa_gemm(a, b, c, schedule=s, blocks=blocks)
                        for s in rk.SCHEDULES}
                torch.cuda.synchronize()
                for s, got in outs.items():
                    err = rel_err(got, want)
                    worst[s] = max(worst[s], (got - want).abs().max().item())
                    if not err < REL_TOL:
                        raise AssertionError(f"{s} ({mm},{k},{n}) {dtype} c={c is not None}: "
                                             f"rel_err {err:.3g} >= {REL_TOL}")
                    if not torch.equal(got, outs["wls"]):
                        raise AssertionError(f"{s} differs from wls at ({mm},{k},{n}) {dtype}")
            print(f"check ({mm},{k},{n}){' B=embedding.T' if transposed else ''} "
                  f"{str(dtype)[6:]}: rel_err < {REL_TOL}, schedules bit-identical")
    del emb
    return worst


def gemm_bound_ms(mm: int, k: int, n: int, in_bytes: int = 2) -> tuple[float, float]:
    """(bytes, operations) times for C = A @ B: inputs read once, the f32
    output written once, over the HBM rate; 2MKN fp32 operations (the
    kernels' arithmetic) over the SIMT peak.  The bound is the larger."""
    byte_ms = (mm * k * in_bytes + k * n * in_bytes + mm * n * 4) / HBM_BYTES_PER_S * 1e3
    op_ms = 2 * mm * k * n / F32_SIMT_FLOPS * 1e3
    return byte_ms, op_ms


def time_kernels(torch, rk, cfg) -> tuple[dict, dict]:
    """Phase 4: per-GEMM times at the main-path shapes, with weights that
    are cold in L2 as in a real step (a distinct weight per layer), summed
    over one decode step (M = batch) and one prefill (M = batch * prompt).
    Device time (kernels only, from the profiler) and wall time (CUDA
    events, launch gaps included) for each."""
    m = cfg.model
    blocks = rk.GemmBlocks(cfg.engine.block_m, cfg.engine.block_k, cfg.engine.block_n)
    gen = torch.Generator(device="cuda").manual_seed(2)
    bf16 = torch.bfloat16
    shapes = [(k, n, c * m.n_layers, False) for k, n, c in layer_shapes(m)]
    shapes.append((m.d_model, m.vocab, 1, True))
    timed = (*rk.SCHEDULES, "plain", "library")
    step = {name: {"decode": 0.0, "prefill": 0.0}
            for name in (*timed, *(f"{t}_wall" for t in timed), "bytes", "operations")}
    rows = []
    for k, n, count, transposed in shapes:
        if transposed:
            ws = [torch.randn(n, k, device="cuda", generator=gen).to(bf16).T]
        else:
            ws = [torch.randn(k, n, device="cuda", generator=gen).to(bf16)
                  for _ in range(m.n_layers)]
        for phase, mm in (("decode", BATCH), ("prefill", BATCH * PROMPT)):
            if transposed:
                mm = BATCH          # the head sees only the last position
            a = torch.randn(mm, k, device="cuda", generator=gen).to(bf16)
            def run(f):
                dev, wall = device_ms(torch, lambda: [f(a, w) for w in ws], 3)
                return dev / len(ws), wall / len(ws)
            t, wall = {}, {}
            for s in rk.SCHEDULES:
                t[s], wall[s] = run(lambda x, w, s=s: rk.rasa_gemm(
                    x, w, schedule=s, blocks=blocks))
            t["plain"], wall["plain"] = run(
                lambda x, w: rk.rasa_gemm_plain(x, w, blocks=blocks))
            t["library"], wall["library"] = run(torch.matmul)
            t["bytes"], t["operations"] = gemm_bound_ms(mm, k, n)
            for name, v in t.items():
                step[name][phase] += count * v
            for name, v in wall.items():
                step[f"{name}_wall"][phase] += count * v
            rows.append({"phase": phase, "M": mm, "K": k, "N": n, "per_step": count,
                         **{f"{kk}_ms": v for kk, v in t.items()},
                         **{f"{kk}_wall_ms": v for kk, v in wall.items()}})
            print("time " + json.dumps(rows[-1]))
        del ws
    return step, rows


def serve(torch, cfg) -> dict:
    """Phase 5: qwen3-1.7b FULL through ServeSession under four engines."""
    from repro_torch.config import EngineConfig
    from repro_torch.kernels import rasa_gemm as rk
    from repro_torch.models import build_model
    from repro_torch.serving import ServeSession

    m = cfg.model
    t0 = time.perf_counter()
    model = build_model(cfg, device="cuda", seed=0)
    torch.cuda.synchronize()
    print(f"serve: built {m.name} ({m.n_layers} layers, d={m.d_model}, "
          f"vocab={m.vocab}) in {time.perf_counter() - t0:.3f} s")
    gen = torch.Generator(device="cuda").manual_seed(3)
    prompts = torch.randint(0, m.vocab, (BATCH, PROMPT), device="cuda",
                            generator=gen, dtype=torch.int32)
    max_seq = PROMPT + STEPS
    per_layer = sum(c for _, _, c in layer_shapes(m))              # 7 GEMMs
    chunks = lambda k: -(-k // cfg.engine.block_k)
    chunk_launches = (m.n_layers * sum(c * chunks(k) for k, _, c in layer_shapes(m))
                      + chunks(m.d_model))
    per_forward = {"wls": m.n_layers * per_layer + 1,
                   "base": chunk_launches, "wlbp": chunk_launches}
    results = {}
    for name in ("wls", "wlbp", "base", "xla"):
        engine = (EngineConfig(kind="xla") if name == "xla" else
                  dataclasses.replace(cfg.engine, kind="pallas_rasa", schedule=name))
        model.cfg = dataclasses.replace(cfg, engine=engine)
        session = ServeSession(model, max_seq=max_seq, device="cuda")
        session.generate(prompts[:, :8], 2)                       # warm-up
        torch.cuda.synchronize()

        # prefill logits, for the comparisons
        rk.reset_launches()
        logits, _ = model.prefill(prompts, model.init_decode_state(BATCH, max_seq))
        torch.cuda.synchronize()
        if name != "xla" and rk.launches[name] != per_forward[name]:
            raise AssertionError(f"{name}: prefill launched {rk.launches[name]}, "
                                 f"expected {per_forward[name]}")

        # the main path: counts from 0 just before, read just after
        torch.cuda.reset_peak_memory_stats()
        rk.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.prefill(prompts, model.init_decode_state(BATCH, max_seq))
        torch.cuda.synchronize()
        t_prefill = time.perf_counter() - t0
        rk.reset_launches()
        t0 = time.perf_counter()
        tokens = session.generate(prompts, STEPS)
        torch.cuda.synchronize()
        t_gen = time.perf_counter() - t0
        counts = dict(rk.launches)
        decode_ms = (t_gen - t_prefill) / STEPS * 1e3
        if tokens.shape != (BATCH, STEPS) or tokens.min() < 0 or tokens.max() >= m.vocab:
            raise AssertionError(f"{name}: bad tokens {tuple(tokens.shape)}")
        if not torch.isfinite(logits).all():
            raise AssertionError(f"{name}: non-finite prefill logits")
        expect = {s: 0 for s in rk.SCHEDULES}
        if name != "xla":
            expect[name] = per_forward[name] * (1 + STEPS)
        if counts != expect:
            raise AssertionError(f"{name}: launches {counts}, expected {expect}")
        results[name] = {"logits": logits, "tokens": tokens, "launches": counts,
                         "prefill_s": t_prefill, "decode_ms_per_step": decode_ms,
                         "tokens_per_s": BATCH * STEPS / (t_gen - t_prefill),
                         "max_memory_bytes": torch.cuda.max_memory_allocated()}
        print(f"serve {name}: prefill {t_prefill * 1e3:.3f} ms, decode "
              f"{decode_ms:.3f} ms/step, {results[name]['tokens_per_s']:.1f} tok/s, "
              f"peak memory {results[name]['max_memory_bytes']} B, launches {counts}")

    ref = results["wls"]
    for s in ("wlbp", "base"):
        if not torch.equal(results[s]["logits"], ref["logits"]):
            raise AssertionError(f"{s}: prefill logits not bit-identical to wls")
        if not torch.equal(results[s]["tokens"], ref["tokens"]):
            raise AssertionError(f"{s}: tokens differ from wls")
    err16 = rel_err(ref["logits"], results["xla"]["logits"])
    agree = (ref["tokens"] == results["xla"]["tokens"]).float().mean().item()
    print(f"serve: schedules bit-identical (prefill logits and tokens); bf16 "
          f"kernel vs xla prefill logits rel_err {err16:.6g} (< {BF16_TOL}); "
          f"token agreement with xla {agree:.4f}")
    if not err16 < BF16_TOL:
        raise AssertionError(f"bf16 kernel engine vs xla rel_err {err16} >= {BF16_TOL}")

    # the same weights in f32: the GEMM path without bf16 rounding flips
    del model, results["wlbp"]["logits"], results["base"]["logits"]
    cfg32 = dataclasses.replace(cfg, model=dataclasses.replace(m, dtype="float32"))
    model = build_model(cfg32, device="cuda", seed=0)
    logits32 = {}
    for name in ("wls", "xla"):
        engine = (EngineConfig(kind="xla") if name == "xla" else
                  dataclasses.replace(cfg.engine, kind="pallas_rasa", schedule=name))
        model.cfg = dataclasses.replace(cfg32, engine=engine)
        logits32[name], _ = model.prefill(prompts, model.init_decode_state(BATCH, max_seq))
    err32 = rel_err(logits32["wls"], logits32["xla"])
    print(f"serve: f32 weights, kernel vs xla prefill logits rel_err {err32:.6g} "
          f"(< {SERVE_TOL})")
    if not err32 < SERVE_TOL:
        raise AssertionError(f"f32 kernel engine vs xla rel_err {err32} >= {SERVE_TOL}")
    return results


def main() -> int:
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke.py: src/repro_torch not found beside the script",
              file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels import rasa_gemm as rk
    torch.backends.cuda.matmul.allow_tf32 = False     # plain versions in full fp32
    torch.backends.cudnn.allow_tf32 = False

    t_start = time.perf_counter()
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card} | torch {torch.__version__} cuda {torch.version.cuda} | {kind}")

    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"build: {', '.join(p.name for p in libs.values())} in "
          f"{time.perf_counter() - t0:.3f} s")
    for name, report in _build.reports.items():
        print(f"build report {name}.cu (-Xptxas -v):")
        print("\n".join(line for line in report.splitlines()
                        if "registers" in line or "spill" in line or "entry" in line))

    cfg = get_config("qwen3-1.7b")
    worst = check_kernels(torch, rk, cfg)
    step, _ = time_kernels(torch, rk, cfg)
    print("time per decode step (M=4, ms; *_wall with launch gaps): " + json.dumps(
        {k: v["decode"] for k, v in step.items()}))
    print("time per prefill (M=512, head M=4, ms; *_wall with launch gaps): " + json.dumps(
        {k: v["prefill"] for k, v in step.items()}))
    results = serve(torch, cfg)

    bound_by = max(("bytes", "operations"), key=lambda b: step[b]["decode"])
    kernels = []
    for s in rk.SCHEDULES:
        kernels.append({
            "name": rk.KERNEL_NAMES[s], "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[s], "launches": results[s]["launches"][s],
            "max_abs_err": worst[s], "ms": step[s]["decode"],
            "plain_ms": step["plain"]["decode"], "bound_ms": step[bound_by]["decode"],
            "bound_by": bound_by, "library_ms": step["library"]["decode"],
            "work": "one qwen3-1.7b decode step of GEMMs (M=4, bf16)"})
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
