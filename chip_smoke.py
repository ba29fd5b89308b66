#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU: build, check, time, serve.

    python3 chip_smoke.py

Phases, each of which raises (exit code != 0) when it fails:
  1. the card: name and power limit;
  2. the build of every CUDA source under src/repro_torch/kernels/csrc/,
     one nvcc per source, all at once;
  3. every kernel against its plain PyTorch version, on the card:
     the RASA GEMM at every GEMM shape of the served models (qwen3-1.7b,
     mamba2-130m, zamba2-2.7b, granite-moe-3b-a800m, musicgen-large,
     qwen2-vl-72b, grok-1-314b; tied heads through embedding.T, untied
     ones row-major, granite's N 49155 with rows not a multiple of 8) at
     M = batch and at the prefill's M (qwen3-1.7b's layers also at phase
     10's M, 8 x 512), and at ragged shapes, bf16 and f32,
     and at f32-only M > 4 shapes of the SIMT kernels (wlbp chunks 2048
     and 3072 deep, M 300 across a cluster, A a column slice), with and
     without C: rel_err < 1e-5, schedules bit-identical;
     flash attention through flash_mha at the head layouts of qwen3-1.7b,
     zamba2-2.7b and gemma-2b, S in {128, 257, 4096}, batch 4: rel_err
     < 2e-2 in bf16, < 1e-5 in f32, over the whole output and over the
     rows from S/2 on (scaled by their own largest value); the SSD scan at the head layouts of
     mamba2-130m and zamba2-2.7b, S in {512, 1024}, chunk 256, batch 4:
     rtol = atol = 2e-5 in f32, rel_err < 3e-2 in bf16;
  4. kernel times against their bound, the plain version and the one
     PyTorch call that computes the same function (torch.matmul, and
     scaled_dot_product_attention for flash; none exists for the SSD),
     which the port never calls.  Flash is timed in bf16 (the tensor-core
     kernel) and in f32 (the SIMT kernel) at every layout and S of the
     check, and in f32 at the qwen3-1.7b prefill layer's shape; each flash
     row names the device kernel that ran, read from the trace's records
     ("unverified: no trace" where no trace held one and the launch counter
     stands in), and the device kernels SDPA's call ran (library_kernels).
     The GEMM rows of the kernels line give one qwen3-1.7b decode step of
     GEMMs (M = 4) and, under prefill_*, one prefill (M = 512; the head
     sees M = 4).  Each decode `time gemm` row splits each schedule's
     device time by record (the GEMM kernel's, and any other, such as a
     fill) and gives each timed call's share of the HBM rate.  The f32
     M > 4 path (SIMT) is timed on one qwen3-1.7b prefill of layer GEMMs in
     f32 beside torch.matmul in f32, each row with the CTA tile of each
     schedule and its device time by record.  Each SSD row names its
     device kernels' launches per call (device_kernels) and splits its
     device time by device kernel (by_record_ms).  Bound: the
     larger of the bytes over the HBM rate and the operations over the
     card's peak for the inputs' type
     (bf16 tensor cores, or fp32 outside them).  Times are the device's
     busy time in torch.profiler traces (the union of the kernels'
     intervals); the "timer" of each row says where CUDA-event time stood
     in for it;
  5. serving qwen3-1.7b at full width, random weights from a seeded
     torch.Generator, ServeSession.generate (batch 4, prompt 128, 32 steps)
     under the pallas_rasa engine (wls, wlbp, base) and the xla engine,
     through the graphed session (CUDA graphs of prefill and decode, the
     main path) and the eager one (eager=True): each engine's decode
     ms/step and prefill ms on both (host clock, synchronised; the median
     of three), the graphed prefill logits and tokens equal to the eager
     ones bit for bit, the wrapper's launches counted at capture, the
     GEMM records of each replayed forward read from a torch.profiler
     trace, and the device idle share of consecutive decode steps and of
     prefill on both sessions;
  6. the flash path: flash_mha on the q/k/v of every layer of a qwen3-1.7b
     prefill (batch 4, prompt 512), against the model's own attention,
     every launch on the tensor-core kernel (flash_fwd_tc); then the same
     q/k/v cast to f32, every launch on the SIMT kernel, each output
     against chunked_causal_attention in f32 at rel_err < 1e-5 (whole
     output and rows from S/2 on);
  7. serving mamba2-130m and zamba2-2.7b at full width (batch 4, prompt
     512, 32 steps) under pallas_rasa (wls) and xla, graphed and eager as
     in phase 5, and the SSD path:
     ssd_chunk_fused on the SSD inputs of every mamba2-130m layer of a
     prefill, against ssd_chunked in f32, each of the f32 route's device
     kernels launched once per layer; then the SSD kernel's time on one
     real layer's inputs, on random ones and on mixes of the two, with the
     SM clock and board power sampled while it runs;
  8. serving granite-moe-3b-a800m and musicgen-large at full width and
     depth (batch 4, prompt 128, 32 steps; musicgen's tokens [B, S, 4])
     under pallas_rasa (wls) and xla, graphed and eager as in phase 5,
     beside each model's decode floor (its weight bytes per step over the
     HBM rate); for granite also the entries the expert capacity dropped
     in a prefill, and one decode step's device time split into the RASA
     GEMM records (graphed trace), the expert products, the router and the
     dispatch/combine (each MoE piece timed alone on the step's own
     inputs); then the four untied heads timed at M 4.  One timed
     generation per session (phases 5 and 7 take the median of three);
  9. serving qwen2-vl-72b (8 of 80 layers) and grok-1-314b (2 of 64) at
     full width and reduced depth, under wls graphed and eager (bit for
     bit; one timed generation each), with the xla engine's prefill logits
     beside wls's;
 10. training qwen3-1.7b and mamba2-130m at full width and depth (bf16,
     random weights from seed 0, the xla engine, AdamW with f32 moments,
     global batch 8 x 512 in 2 microbatches, remat full, warm-up 2 of 8
     steps) through TrainLoop with a checkpoint every 4 steps into a
     directory under build/: each step's loss, grad_norm, lr and host-clock
     ms; every parameter's gradient finite and nonzero, the losses finite
     and the last below the first, no step retried; tokens/s and the
     model FLOPs' share of the bf16 peak from the median of steps 1-3
     (before the first save), beside the median of steps 4-7 (the
     checkpoint writer's thread running) and of the resumed steps 5-7 (no
     writer); peak device memory; the step-4 checkpoint restored in place
     into a fresh state (bit for bit the state the loop held there) and
     steps 4-7 rerun from it (losses within 1e-3 of the first run's;
     bit-equal or not, printed); a traced step (device busy time, idle
     share, library GEMMs, the top kernels), the loss forward and AdamW
     alone; and for qwen3-1.7b the forward loss under pallas_rasa (wls)
     against xla's (rtol = atol = 0.02), with the wrapper's wls launches
     counted from 0 over it: 7 per layer, 196; then every wls call of
     that forward against the plain version on its own inputs (rel_err <
     1e-5); first, how far the xla engine's bf16 products (out_dtype, over
     the whole contraction and in pieces) and the f32-cast ones are from
     the exact (f64) product at the contractions of dot_f32's backward
     (8192 and 12288).
The line before the last is the card line, the one before it the kernels'
JSON summary; the last line is {"ok": true, "device": {...}}.  Without a
CUDA device, or without the repository beside it, it exits non-zero and
prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
DEV = "cuda"

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
# H100 SXM dense peak for inputs of each type: bf16 on the tensor cores,
# fp32 outside them (the data sheet's rate for the type, whatever the
# kernel itself uses)
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
TRACE_PAIRS = 6                # profiler attempts per timed function
# consecutive decode steps per serving trace: a qwen3-1.7b step is ~2,700
# device records, and traces of 16 steps lost a few of ~43,000
TRACE_STEPS = 4
REL_TOL = 1e-5                 # the reference's GEMM tolerance
# device records of csrc/rasa_gemm.cu's kernels (decode, tensor-core, SIMT):
# its __global__ names, no one a part of another
GEMM_RECORDS = ("decode_kernel", "tile_kernel", "wlbp_kernel", "sgemm_tile", "sgemm_wlbp")
FLASH_TOL = {"bfloat16": 2e-2, "float32": 1e-5}   # tests/test_kernels.py:112,121
SSD_TOL = {"bfloat16": 3e-2, "float32": 2e-5}     # tests/test_ssd_kernel.py:55,37
SERVE_TOL = 2e-2               # kernel vs xla engine, f32 weights
PREDICTION_FAMILIES = (
    "graphed decode ms/step: granite-moe-3b-a800m wls 8-20 (floor 1.97), xla 8-22; "
    "musicgen-large wls 8-20 (floor 1.44), xla 8-22; qwen2-vl-72b (8 layers) wls 8-20; "
    "grok-1-314b (2 layers) wls 8-20. graphed prefill ms: granite 15-40, musicgen 15-45, "
    "qwen2-vl 30-90, grok 10-25. Device idle share of a graphed decode step 0.05-0.35. "
    "granite's decode step: expert products 2-5 ms, dispatch/combine 1-4 ms, RASA GEMMs "
    "0.5-1.5 ms. Graphed = eager bit for bit; wls vs xla within 0.15.")
PREDICTION = ("graphed decode ms/step: qwen3-1.7b wls 7-15, base/wlbp 9-17, xla 10-20; "
              "mamba2-130m 2-8; zamba2-2.7b wls 10-20, xla 15-30. graphed prefill ms: "
              "qwen3-1.7b wls 18-30; mamba2-130m 5-15; zamba2-2.7b wls 60-200. Device idle "
              "share of a captured qwen3-1.7b wls decode step 0.15-0.40. Eager: host-bound, "
              "as before. Graphed = eager bit for bit.")
BF16_TOL = 0.15                # the reference's bf16 logits tolerance
BATCH, PROMPT, STEPS = 4, 128, 32
SSM_PROMPT = 512               # two SSD chunks: the inter-chunk recurrence runs
FLASH_SEQS = (128, 257, 4096)
SSD_SEQS = (512, 1024)
SSD_CHUNK = 256
FLASH_ARCHS = ("qwen3-1.7b", "zamba2-2.7b", "gemma-2b")
SSD_ARCHS = ("mamba2-130m", "zamba2-2.7b")
FAMILY_ARCHS = ("granite-moe-3b-a800m", "musicgen-large")     # phase 8, full depth
REDUCED = {"qwen2-vl-72b": 8, "grok-1-314b": 2}               # phase 9: layers kept
# device records of the library's GEMM kernels (cuBLAS, CUTLASS) by name
LIBRARY_GEMM_RECORDS = ("gemm", "nvjet", "xmma", "cutlass", "cublas")
SOURCES = {"gemm": "src/repro_torch/kernels/csrc/rasa_gemm.cu",
           "flash": "src/repro_torch/kernels/csrc/flash_attention.cu",
           "ssd": "src/repro_torch/kernels/csrc/ssd_chunk.cu"}
REPLACES = {"base": "src/repro/kernels/rasa_gemm.py:103 (_ws_call, schedule=base)",
            "wlbp": "src/repro/kernels/rasa_gemm.py:103 (_ws_call, schedule=wlbp)",
            "wls": "src/repro/kernels/rasa_gemm.py:140 (rasa_gemm, schedule=wls)",
            "flash": "src/repro/kernels/flash_attention.py:69 (flash_attention, "
                     "via ops.flash_mha)",
            "ssd": "src/repro/kernels/ssd_chunk.py:77 (ssd_chunk_fused)"}


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def rel_err(got, want) -> float:
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp_min(1e-6)).item()


def allclose_ratio(got, want, tol: float) -> float:
    """max |got - want| / (tol + tol |want|): <= 1 is assert_allclose with
    rtol = atol = tol."""
    got, want = got.float(), want.float()
    return ((got - want).abs() / (tol + tol * want.abs())).max().item()


def dtype_name(t) -> str:
    return str(t.dtype)[6:]


def event_ms(torch, fn, reps: int) -> float:
    """CUDA-event ms of one fn() call, launch gaps included, over reps."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def busy_us(spans) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def profiled(torch, work, warm=None):
    """torch.profiler's device records of work(), after a warm-up step
    that runs warm() (default: work()) under the tracer and is thrown away
    (on an H100, traces without one lost the first kernel records)."""
    from torch.profiler import ProfilerActivity, profile, schedule
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        for run in (warm or work, work):
            run()
            torch.cuda.synchronize()
            prof.step()
    return prof


def device_spans(prof) -> list[tuple[str, float, float]]:
    """(name, start us, end us) of every device record of a trace."""
    from torch.autograd import DeviceType
    return [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
            if e.device_type == DeviceType.CUDA]


def kernel_trace(torch, fn, reps: int) -> tuple[dict, float, dict]:
    """One torch.profiler trace of reps fn() calls: the device records per
    kernel name, the device's busy time in us, the union of the records'
    intervals (base and wlbp let a k-chunk's kernel start while the
    previous one drains, so their records overlap; elsewhere the union is
    the sum), and each name's device time in us."""
    prof = profiled(torch, lambda: [fn() for _ in range(reps)])
    evs = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    spans = [(a, b) for _, a, b in device_spans(prof)]
    return ({e.key: e.count for e in evs}, busy_us(spans),
            {e.key: e.self_device_time_total for e in evs})


def idle_share(spans) -> float:
    """1 - busy / window over device records (name, start, end): the share
    of the time from the first record's start to the last record's end in
    which no record ran."""
    window = max(b for _, _, b in spans) - min(a for _, a, _ in spans)
    return 1 - busy_us([(a, b) for _, a, b in spans]) / window


def device_ms(torch, fn, reps: int) -> tuple[float, float, str, dict]:
    """(time, wall, timer, records) of one fn() call, after a warm-up: ms,
    ms, the timer, and the device records by name (the kernels that ran):
    each name's device ms per call from the pair of traces that counted,
    or None for every name seen where none did.  time is
    the device's busy time in torch.profiler traces of reps and 2 reps
    calls (timer "profiler"); wall is CUDA-event time over reps calls,
    launch gaps included.  The profiler can drop kernel records (on
    an H100 it did, even after a warm-up step), so a pair of traces
    counts only when every kernel's records are a multiple of reps and the
    longer trace holds exactly twice the shorter one's.  After TRACE_PAIRS
    pairs that do not, time is the event time, an upper bound, and timer
    says "events"."""
    fn()
    torch.cuda.synchronize()
    wall = event_ms(torch, fn, reps)
    records = set()
    for _ in range(TRACE_PAIRS):
        once, t1, by1 = kernel_trace(torch, fn, reps)
        twice, t2, by2 = kernel_trace(torch, fn, 2 * reps)
        records |= once.keys() | twice.keys()
        if (once and twice == {k: 2 * v for k, v in once.items()}
                and all(v % reps == 0 for v in once.values())):
            per_call = {k: (by1[k] + by2[k]) / (3 * reps) / 1e3 for k in once}
            return (t1 + t2) / (3 * reps) / 1e3, wall, "profiler", per_call
        print(f"time: kernel records do not add up over {reps} and {2 * reps} calls "
              f"({sum(once.values())}, {sum(twice.values())}); tracing again")
    print(f"time: no trace held every kernel record; CUDA-event time {wall:.6g} ms "
          "stands for the device time (timer: events)")
    return wall, wall, "events", dict.fromkeys(records)


# --------------------------------------------------------------------- GEMM


def layer_shapes(m) -> list[tuple[int, int, int]]:
    """(K, N, count per forward) of one model's RASA GEMMs, without the
    head: each decoder layer's attention and MLP projections (dense, vlm,
    audio; the MoE's attention only: its router and experts are library
    products, as in the reference); each Mamba2 layer's and each
    application of the hybrid's shared attention + MLP block for
    ssm/hybrid."""
    d, hd, f = m.d_model, m.resolved_head_dim, m.d_ff
    attn = [(d, m.n_heads * hd, 1), (d, m.n_kv_heads * hd, 2), (m.n_heads * hd, d, 1)]
    mlp = [(d, f, 2 if m.act in ("swiglu", "geglu") else 1), (f, d, 1)]
    if m.family in ("dense", "vlm", "audio", "moe"):
        per_layer = attn if m.family == "moe" else attn + mlp
        return [(k, n, c * m.n_layers) for k, n, c in per_layer]
    s = m.ssm
    d_inner = s.expand * d
    proj = 2 * d_inner + 2 * s.n_groups * s.d_state + d_inner // s.head_dim
    shapes = [(d, proj, m.n_layers), (d_inner, d, m.n_layers)]
    apps = m.n_layers // m.hybrid.attn_every if m.family == "hybrid" else 0
    return shapes + [(k, n, c * apps) for k, n, c in attn + mlp if apps]


def gemm_launches_per_forward(m, bk: int) -> dict[str, int]:
    """RASA launches of one forward (prefill or decode step) per schedule:
    one per GEMM for wls, one per k-chunk of bk for base/wlbp; head included."""
    from repro_torch.models.transformer import head_width
    chunks = lambda k: -(-k // bk)
    shapes = layer_shapes(m) + [(m.d_model, head_width(m), 1)]
    per_chunk = sum(c * chunks(k) for k, _, c in shapes)
    return {"wls": sum(c for _, _, c in shapes), "base": per_chunk, "wlbp": per_chunk}


def check_gemm(torch, rk, configs) -> dict[str, float]:
    """Phase 3, GEMM: every schedule against the plain version; returns the
    max abs error per schedule.  Each model's distinct (K, N) at M = batch
    (decode) and M = batch * prompt (prefill), TRAIN_RASA's also at phase
    10's M (global batch * sequence: its pallas_rasa loss), its head at M = batch and
    512 (a tied head reads embedding.T in place, an untied one is row-major
    [d, head_width]), and ragged shapes, in bf16 and f32; then f32-only
    M > 4 cases of the SIMT kernels: wlbp chunks deeper than the bf16 block
    holds (2048, and 3072, the deepest a cluster of 8 holds), a ragged M
    across a cluster, and embedding.T with A a column slice (unaligned
    rows)."""
    from repro_torch.models.transformer import head_width
    main = rk.GemmBlocks(configs[0].engine.block_m, configs[0].engine.block_k,
                         configs[0].engine.block_n)
    small = rk.GemmBlocks(128, 128, 128)
    gen = torch.Generator(device=DEV).manual_seed(1)
    rnd = lambda *shape: torch.randn(shape, device=DEV, generator=gen)
    cases, seen = [], set()
    for cfg in configs:
        m = cfg.model
        prefill_m = BATCH * (SSM_PROMPT if m.family in ("ssm", "hybrid") else PROMPT)
        head = (m.d_model, head_width(m), m.tie_embeddings)
        train_m = (TRAIN["global_batch"] * TRAIN["seq_len"],) if m.name == TRAIN_RASA else ()
        for k, n, transposed in [(k, n, False) for k, n, _ in layer_shapes(m)] + [head]:
            for mm in ((BATCH, 512) if (k, n, transposed) == head
                       else (BATCH, prefill_m, *train_m)):
                if (mm, k, n, transposed) not in seen:
                    seen.add((mm, k, n, transposed))
                    cases.append((mm, k, n, transposed, main))
    cases += [(1, 256, 256, False, small), (257, 130, 100, False, small),
              (130, 260, 140, False, small), (3, 130, 100, False, small),
              (4, 260, 140, True, small),
              # decode chunks deeper than K and than 1024, a ragged last one
              (4, 700, 300, False, rk.GemmBlocks(128, 2048, 128)),
              (3, 2500, 515, True, rk.GemmBlocks(128, 2048, 128)),
              (1, 1500, 1000, False, rk.GemmBlocks(128, 1280, 128)),
              (2, 6144, 2048, False, main)]
    both, f32 = (torch.bfloat16, torch.float32), (torch.float32,)
    cases = [(*case, both, 0) for case in cases] + [
        (64, 2500, 300, False, rk.GemmBlocks(128, 2048, 128), f32, 0),
        (64, 3200, 300, True, rk.GemmBlocks(128, 3072, 128), f32, 0),
        (300, 1000, 260, False, main, f32, 0),
        (300, 700, 515, True, rk.GemmBlocks(128, 256, 128), f32, 1)]
    worst = {s: 0.0 for s in rk.SCHEDULES}
    for mm, k, n, transposed, blocks, dtypes, offset in cases:
        for dtype in dtypes:
            # offset: A as a column slice of a wider tensor (rows not 16-byte aligned)
            a = rnd(mm, k + offset).to(dtype)[:, offset:]
            # a tied head reads embedding.T in place
            b = rnd(n, k).to(dtype).T if transposed else rnd(k, n).to(dtype)
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
            del a, b
        print(f"check gemm ({mm},{k},{n}) bk={blocks.bk}{' B=embedding.T' if transposed else ''}"
              f"{f' A offset {offset}' if offset else ''}: rel_err < {REL_TOL} in "
              f"{' and '.join(str(d)[6:] for d in dtypes)}, "
              "schedules bit-identical")
    return worst


def gemm_bound_ms(mm: int, k: int, n: int, dtype: str = "bfloat16") -> tuple[float, float]:
    """(bytes, operations) times for C = A @ B with A, B of ``dtype``: inputs
    read once, the f32 output written once, over the HBM rate; 2MKN
    operations over the card's peak for that type.  The bound is the larger."""
    in_bytes = 2 if dtype == "bfloat16" else 4
    byte_ms = (mm * k * in_bytes + k * n * in_bytes + mm * n * 4) / HBM_BYTES_PER_S * 1e3
    op_ms = 2 * mm * k * n / PEAK_FLOPS[dtype] * 1e3
    return byte_ms, op_ms


def time_gemm(torch, rk, cfg) -> tuple[dict, dict]:
    """Phase 4, GEMM: per-GEMM times at the main-path shapes, with weights
    that are cold in L2 as in a real step (a distinct weight per layer),
    summed over one decode step (M = batch) and one prefill (M = batch *
    prompt).  Device time (kernels only, from the profiler) and wall time
    (CUDA events, launch gaps included) for each; returns the sums and,
    per timed function, the timer behind its device time ("profiler",
    "events", or both joined by "+")."""
    m = cfg.model
    blocks = rk.GemmBlocks(cfg.engine.block_m, cfg.engine.block_k, cfg.engine.block_n)
    gen = torch.Generator(device=DEV).manual_seed(2)
    bf16 = torch.bfloat16
    shapes = [(k, n, count, False) for k, n, count in layer_shapes(m)]
    shapes.append((m.d_model, m.vocab, 1, True))
    timed = (*rk.SCHEDULES, "plain", "library")
    step = {name: {"decode": 0.0, "prefill": 0.0}
            for name in (*timed, *(f"{t}_wall" for t in timed), "bytes", "operations")}
    timers = {name: set() for name in timed}
    rows = []
    for k, n, count, transposed in shapes:
        if transposed:
            ws = [torch.randn(n, k, device=DEV, generator=gen).to(bf16).T]
        else:
            ws = [torch.randn(k, n, device=DEV, generator=gen).to(bf16)
                  for _ in range(m.n_layers)]
        for phase, mm in (("decode", BATCH), ("prefill", BATCH * PROMPT)):
            if transposed:
                mm = BATCH          # the head sees only the last position
            a = torch.randn(mm, k, device=DEV, generator=gen).to(bf16)
            t, wall, split = {}, {}, {}
            fns = {**{s: lambda x, w, s=s: rk.rasa_gemm(x, w, schedule=s, blocks=blocks)
                      for s in rk.SCHEDULES},
                   "plain": lambda x, w: rk.rasa_gemm_plain(x, w, blocks=blocks),
                   "library": torch.matmul}
            for name, f in fns.items():
                dev, w_ms, timer, recs = device_ms(torch, lambda: [f(a, w) for w in ws], 3)
                t[name], wall[name] = dev / len(ws), w_ms / len(ws)
                timers[name].add(timer)
                if phase == "decode" and name in rk.SCHEDULES:
                    split[name] = record_split(recs, GEMM_RECORDS, len(ws))
            t["bytes"], t["operations"] = gemm_bound_ms(mm, k, n, "bfloat16")
            extra = {}
            if split:   # decode: time by device record, share of the HBM rate
                extra = {"by_record_ms": split, "hbm_share": {
                    name: hbm_share(t["bytes"], t[name]) for name in timed}}
            for name, v in t.items():
                step[name][phase] += count * v
            for name, v in wall.items():
                step[f"{name}_wall"][phase] += count * v
            rows.append({"phase": phase, "M": mm, "K": k, "N": n, "per_step": count,
                         **{f"{kk}_ms": v for kk, v in t.items()},
                         **{f"{kk}_wall_ms": v for kk, v in wall.items()}, **extra})
            print("time gemm " + json.dumps(rows[-1]))
        del ws
    return step, {name: "+".join(sorted(ts)) for name, ts in timers.items()}


def time_gemm_f32_prefill(torch, rk, cfg) -> dict:
    """Phase 4, the GEMM's f32 M > 4 path (SIMT): one qwen3-1.7b prefill of
    layer GEMMs (M = batch * prompt, no head) in f32 under each schedule,
    the plain version and torch.matmul (TF32 off, as main() sets it), by
    time_gemm's method: each shape's device time over a distinct weight per
    layer, times its count per forward.  Each row gives the CTA tile each
    schedule's kernel took and splits each schedule's device time by record
    (by_record_ms: the GEMM kernels, and any other, such as C's zero fill).
    Returns the sums (ms) and each timed function's timer; the bound is the
    larger of the f32 bytes and the operations at the fp32 peak."""
    m = cfg.model
    blocks = rk.GemmBlocks(cfg.engine.block_m, cfg.engine.block_k, cfg.engine.block_n)
    gen = torch.Generator(device=DEV).manual_seed(10)
    mm = BATCH * PROMPT
    fns = {**{s: lambda x, w, s=s: rk.rasa_gemm(x, w, schedule=s, blocks=blocks)
              for s in rk.SCHEDULES},
           "plain": lambda x, w: rk.rasa_gemm_plain(x, w, blocks=blocks),
           "library": torch.matmul}
    total = dict.fromkeys((*fns, "bytes", "operations"), 0.0)
    timers = {name: set() for name in fns}
    for k, n, count in layer_shapes(m):
        ws = [torch.randn(k, n, device=DEV, generator=gen) for _ in range(m.n_layers)]
        a = torch.randn(mm, k, device=DEV, generator=gen)
        row = {"M": mm, "K": k, "N": n, "per_forward": count, "dtype": "float32",
               "tile": {s: rk.simt_tile(s, mm, n) for s in rk.SCHEDULES}, "by_record_ms": {}}
        for name, f in fns.items():
            dev, _, timer, recs = device_ms(torch, lambda: [f(a, w) for w in ws], 3)
            row[f"{name}_ms"] = dev / len(ws)
            if name in rk.SCHEDULES:
                row["by_record_ms"][name] = record_split(recs, GEMM_RECORDS, len(ws))
            total[name] += count * dev / len(ws)
            timers[name].add(timer)
        row["bytes_ms"], row["operations_ms"] = gemm_bound_ms(mm, k, n, "float32")
        total["bytes"] += count * row["bytes_ms"]
        total["operations"] += count * row["operations_ms"]
        print("time gemm f32 prefill " + json.dumps(row))
        del ws, a
    total["timer"] = {name: "+".join(sorted(ts)) for name, ts in timers.items()}
    return total


# -------------------------------------------------------------------- flash


def flash_bound_ms(bh: int, bhkv: int, sq: int, skv: int, d: int, causal: bool,
                   dtype: str) -> tuple[float, float]:
    """(bytes, operations) times of attention on q/k/v of ``dtype``: q, k, v
    read once and the output written once over the HBM rate; 4 d operations
    per (row, visible key) pair, the pairs this run's mask lets through,
    over the card's peak for that type."""
    in_bytes = 2 if dtype == "bfloat16" else 4
    byte_ms = (2 * bh * sq + 2 * bhkv * skv) * d * in_bytes / HBM_BYTES_PER_S * 1e3
    pairs = sum(min(i + 1, skv) for i in range(sq)) if causal else sq * skv
    return byte_ms, 4 * d * pairs * bh / PEAK_FLOPS[dtype] * 1e3


def bound_fields(byte_ms: float, op_ms: float) -> dict:
    return {"bytes_ms": byte_ms, "operations_ms": op_ms, "bound_ms": max(byte_ms, op_ms),
            "bound_by": "bytes" if byte_ms >= op_ms else "operations"}


def flash_layouts():
    """(arch, q heads, kv heads, head dim) of the flash check."""
    from repro_torch.configs import get_config
    return [(a, m.n_heads, m.n_kv_heads, m.resolved_head_dim)
            for a, m in ((a, get_config(a).model) for a in FLASH_ARCHS)]


def flash_inputs(torch, gen, hq, hkv, s, d, dtype):
    rnd = lambda h: torch.randn(BATCH, h, s, d, device=DEV, generator=gen).to(dtype)
    return rnd(hq), rnd(hkv), rnd(hkv)


def flash_plain(fa, q, k, v, **kw):
    """flash_attention_plain on [B, H, S, D] inputs, as flash_mha calls it."""
    from repro_torch.kernels.ops import flash_block
    b, hq, s, d = q.shape
    out = fa.flash_attention_plain(
        q.reshape(b * hq, s, d), k.reshape(-1, k.shape[2], d), v.reshape(-1, v.shape[2], d),
        block_q=flash_block(512, s), block_kv=flash_block(512, k.shape[2]), **kw)
    return out.reshape(b, hq, s, d)


def check_flash(torch, fa, flash_mha) -> float:
    """Phase 3, flash: the kernel through flash_mha against its plain
    version, each call counted on its dtype's route; returns the max abs
    error."""
    gen = torch.Generator(device=DEV).manual_seed(4)
    worst = 0.0
    for arch, hq, hkv, d in flash_layouts():
        for s in FLASH_SEQS:
            for dtype in (torch.bfloat16, torch.float32):
                q, k, v = flash_inputs(torch, gen, hq, hkv, s, d, dtype)
                route = "flash_" + fa.flash_route(dtype, d)
                before = fa.launches[route]
                got = flash_mha(q, k, v)
                torch.cuda.synchronize()
                if fa.launches[route] != before + 1:
                    raise AssertionError(f"flash {arch} S={s} {dtype}: no {route} launch")
                want = flash_plain(fa, q, k, v)
                # the causal output's first rows set rel_err's scale, so the
                # rows from S/2 on are held to their own largest value too
                err = rel_err(got, want)
                late = rel_err(got[:, :, s // 2:], want[:, :, s // 2:])
                tol = FLASH_TOL[str(dtype)[6:]]
                worst = max(worst, (got.float() - want.float()).abs().max().item())
                print(f"check flash {arch} ({BATCH},{hq}/{hkv},{s},{d}) {str(dtype)[6:]} "
                      f"[{route}]: rel_err {err:.3g}, rows from S/2 {late:.3g} (< {tol})")
                if not (err < tol and late < tol):
                    raise AssertionError(f"flash {arch} S={s} {dtype}: rel_err {err}, "
                                         f"rows from S/2 {late}, >= {tol}")
                del q, k, v, got, want
    return worst


#: the f32 row of phase 4 that stands for the SIMT kernel in the kernels line
F32_LAYER_ROW = "qwen3-1.7b prefill layer shape"


def time_flash(torch, fa, flash_mha) -> list[dict]:
    """Phase 4, flash: bf16 (the tensor-core kernel) and f32 (the SIMT
    kernel) at every layout and S of the check, then f32 at the qwen3-1.7b
    prefill layer's shape."""
    import torch.nn.functional as F
    gen = torch.Generator(device=DEV).manual_seed(5)
    rows = []
    cases = [(arch, hq, hkv, d, s, dtype)
             for dtype in (torch.bfloat16, torch.float32)
             for arch, hq, hkv, d in flash_layouts() for s in FLASH_SEQS]
    arch, hq, hkv, d = flash_layouts()[0]
    cases.append((F32_LAYER_ROW, hq, hkv, d, SSM_PROMPT, torch.float32))
    for arch, hq, hkv, d, s, dtype in cases:
        q, k, v = flash_inputs(torch, gen, hq, hkv, s, d, dtype)
        rows.append(flash_row(torch, fa, flash_mha, F, arch, q, k, v))
        print("time flash " + json.dumps(rows[-1]))
        del q, k, v
    return rows


def timed_fields(torch, fns: dict) -> tuple[dict, dict]:
    """{"ms": ..., "plain_ms": ..., ...} device times of each fn, keyed as
    in the kernels line, and "timer": the timer behind each; and the device
    records of each function's traces, under the same keys."""
    out, timer, records = {}, {}, {}
    for key, fn in fns.items():
        out[key], _, timer[key], records[key] = device_ms(torch, fn, 3)
    return {**out, "timer": timer}, records


def record_split(records: dict, names, calls: int) -> dict:
    """Device ms per call by record: the records whose name holds one of
    ``names`` (the kernels under test) summed under "kernels", every other
    record (a fill, a copy) under its own name in "other"; None where the
    records carry no time (CUDA-event fallback)."""
    if any(v is None for v in records.values()):
        return {"kernels": None, "other": dict.fromkeys(
            r for r in records if not any(n in r for n in names))}
    out = {"kernels": 0.0, "other": {}}
    for rec, ms in sorted(records.items()):
        if any(n in rec for n in names):
            out["kernels"] += ms / calls
        else:
            out["other"][rec] = ms / calls
    return out


def hbm_share(byte_ms: float, ms: float) -> float:
    """The share of the HBM rate a call reached: its bytes' time at that
    rate over its time."""
    return byte_ms / ms


def timed_kernels(records, names) -> list[str]:
    """Which of ``names`` appear among the device records' names."""
    return sorted(n for n in names if any(n in r for r in records))


def kernel_name(record: str) -> str:
    """A device record's kernel name, without its return type, namespaces,
    template arguments and parameters: "void at::native::(anonymous
    namespace)::softmax_warp_forward<float, float, float, 9, false>(...)"
    -> "softmax_warp_forward"."""
    name = record.replace("(anonymous namespace)", "").removeprefix("void ")
    for stop in "<(":
        name = name.split(stop)[0]
    return name.strip().split("::")[-1] or record


def library_kernels(records) -> list[str]:
    """The device kernels a library call ran, by name, from its traces'
    records: whether SDPA was one fused kernel or a math path of GEMMs and a
    softmax decides what its time is a yardstick of."""
    return sorted({kernel_name(r) for r in records})


def kernel_split(records: dict, names, calls: int) -> dict:
    """record_split by device kernel: each of ``names`` with its records'
    device ms per call, and the records of none of them under "other"."""
    out = {n: record_split(records, (n,), calls)["kernels"] for n in names}
    out["other"] = record_split(records, names, calls)["other"]
    return out


def flash_row(torch, fa, flash_mha, F, what, q, k, v) -> dict:
    """Kernel, plain and SDPA times (device, profiler) of one causal call,
    and the flash device kernel the kernel's traces recorded: the one of
    its dtype's route, or it raises.  Where no trace held a flash record
    (CUDA-event time), the route's launch counter stands in and the kernel
    is marked unverified."""
    b, hq, s, d = q.shape
    route = fa.flash_route(q.dtype, d)
    before = fa.launches[f"flash_{route}"]
    t, by_fn = timed_fields(torch, {
        "ms": lambda: flash_mha(q, k, v),
        "plain_ms": lambda: flash_plain(fa, q, k, v),
        "library_ms": lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=k.shape[1] != hq)})
    ran = timed_kernels(by_fn["ms"], (fa.KERNEL_NAMES["tc"], fa.KERNEL_NAMES["simt"]))
    kernel = want = fa.KERNEL_NAMES[route]
    if not ran and t["timer"]["ms"] == "events" and fa.launches[f"flash_{route}"] > before:
        kernel = "unverified: no trace"
    elif ran != [want]:
        raise AssertionError(f"flash {what} S={s} {dtype_name(q)}: traces recorded {ran}, "
                             f"expected [{want!r}]")
    tile = {}
    if route == "simt":   # the SIMT kernel's CTA tile follows D and the grid
        tile["tile"] = dict(zip(("rows", "keys", "warps"), fa.simt_tile(b * hq, s, d)))
    return {"what": what, "B": b, "Hq": hq, "Hkv": k.shape[1], "S": s, "D": d,
            "dtype": dtype_name(q), "device_kernel": kernel, **tile, **t,
            "library_kernels": library_kernels(by_fn["library_ms"]),
            **bound_fields(*flash_bound_ms(b * hq, b * k.shape[1], s, s, d, True,
                                           dtype_name(q)))}


def capture(module, name: str, run):
    """Call run() with ``module.name`` wrapped so that every call's
    arguments and result are recorded; returns the records."""
    orig = getattr(module, name)
    seen = []

    def spy(*args, **kw):
        out = orig(*args, **kw)
        seen.append((args, kw, out))
        return out

    setattr(module, name, spy)
    try:
        run()
    finally:
        setattr(module, name, orig)
    return seen


def flash_path(torch, fa, flash_mha, cfg) -> dict:
    """Phase 6: the q/k/v of every attention layer of a qwen3-1.7b prefill
    (batch 4, prompt 512) through flash_mha, counts from 0 just before and
    read just after, each output against the model's own attention
    (chunked_causal_attention) on the same tensors; then one layer's times."""
    import torch.nn.functional as F
    from repro_torch.models import build_model, layers
    m = cfg.model
    model = build_model(cfg, device=DEV, seed=0)
    gen = torch.Generator(device=DEV).manual_seed(6)
    prompts = torch.randint(0, m.vocab, (BATCH, SSM_PROMPT), device=DEV, generator=gen)
    seen = capture(layers, "chunked_causal_attention", lambda: model.prefill(
        prompts, model.init_decode_state(BATCH, SSM_PROMPT)))
    del model
    group = m.n_heads // m.n_kv_heads
    # kv heads as the model projects them (gqa_expand repeated each one)
    calls = [(q, k[:, ::group].contiguous(), v[:, ::group].contiguous(), kw["scale"], out)
             for (q, k, v), kw, out in seen]
    fa.reset_launches()
    outs = [flash_mha(q, k, v, scale=scale) for q, k, v, scale, _ in calls]
    torch.cuda.synchronize()
    counts = dict(fa.launches)
    launches = counts["flash"]
    if counts != {"flash": m.n_layers, "flash_tc": m.n_layers, "flash_simt": 0}:
        raise AssertionError(f"flash path launched {counts}, expected {m.n_layers} "
                             "on the tensor-core route")
    errs = [rel_err(got, want) for got, (*_, want) in zip(outs, calls)]
    print(f"flash path: {launches} launches over {m.n_layers} qwen3-1.7b prefill layers "
          f"({BATCH},{m.n_heads}/{m.n_kv_heads},{SSM_PROMPT},{m.resolved_head_dim}) bf16, "
          f"launches by route {counts}; "
          f"rel_err vs chunked_causal_attention max {max(errs):.3g} (< {FLASH_TOL['bfloat16']})")
    if not max(errs) < FLASH_TOL["bfloat16"]:
        raise AssertionError(f"flash path: rel_err {max(errs)} >= {FLASH_TOL['bfloat16']}")
    q, k, v, _, _ = calls[0]
    row = flash_row(torch, fa, flash_mha, F, "qwen3-1.7b prefill layer", q, k, v)
    row["max_abs_err"] = max((o.float() - c[-1].float()).abs().max().item()
                             for o, c in zip(outs, calls))
    print("time flash " + json.dumps(row))
    del outs
    f32 = flash_path_f32(torch, fa, flash_mha, layers, seen, group)
    return {"launches": launches,
            "device_kernels": {fa.KERNEL_NAMES["tc"]: counts["flash_tc"],
                               fa.KERNEL_NAMES["simt"]: counts["flash_simt"]},
            **row, **f32}


def flash_path_f32(torch, fa, flash_mha, layers, seen, group: int) -> dict:
    """Phase 6, f32: the same layers' q/k/v cast to f32 through flash_mha
    (the SIMT route), counts from 0 just before and read just after, each
    output against chunked_causal_attention on the same f32 tensors at the
    reference's 1e-5, over the whole output and over the rows from S/2 on."""
    n = len(seen)
    fa.reset_launches()
    outs = [flash_mha(q.float(), k[:, ::group].float().contiguous(),
                      v[:, ::group].float().contiguous(), scale=kw["scale"])
            for (q, k, v), kw, _ in seen]
    torch.cuda.synchronize()
    counts = dict(fa.launches)
    if counts != {"flash": n, "flash_tc": 0, "flash_simt": n}:
        raise AssertionError(f"flash path f32 launched {counts}, expected {n} on the SIMT route")
    tol = FLASH_TOL["float32"]
    errs, late, worst = [], [], 0.0
    for got, ((q, k, v), kw, _) in zip(outs, seen):
        want = layers.chunked_causal_attention(q.float(), k.float(), v.float(), scale=kw["scale"])
        s = q.shape[2]
        errs.append(rel_err(got, want))
        late.append(rel_err(got[:, :, s // 2:], want[:, :, s // 2:]))
        worst = max(worst, (got - want).abs().max().item())
    print(f"flash path f32: {counts['flash']} launches over {n} layers, by route {counts}; "
          f"rel_err vs chunked_causal_attention (f32) max {max(errs):.3g}, rows from S/2 "
          f"max {max(late):.3g} (< {tol}); per layer {[float(f'{e:.3g}') for e in errs]}")
    if not (max(errs) < tol and max(late) < tol):
        raise AssertionError(f"flash path f32: rel_err {max(errs)}, rows from S/2 "
                             f"{max(late)}, >= {tol}")
    return {"f32_launches": counts["flash"],
            "f32_device_kernels": {fa.KERNEL_NAMES["tc"]: counts["flash_tc"],
                                   fa.KERNEL_NAMES["simt"]: counts["flash_simt"]},
            "f32_max_abs_err": worst}


# ---------------------------------------------------------------------- SSD


def ssd_ops(bh: int, s: int, p: int, n: int, chunk: int) -> int:
    """fp32 operations of the SSD scan: per chunk, q(q+1)/2 (row, column)
    pairs of 2N (C.B) + 2P (W x) operations, and 2qNP each for the
    inter-chunk term and the state update."""
    q = chunk
    return bh * (s // q) * (q * (q + 1) // 2 * 2 * (n + p) + 4 * q * n * p)


def ssd_layouts():
    """(arch, heads, head dim P, state N) of the SSD check."""
    from repro_torch.configs import get_config
    out = []
    for a in SSD_ARCHS:
        m = get_config(a).model
        out.append((a, m.ssm.expand * m.d_model // m.ssm.head_dim, m.ssm.head_dim,
                    m.ssm.d_state))
    return out


def ssd_inputs(torch, gen, bh, s, p, n, dtype):
    x = torch.randn(bh, s, p, device=DEV, generator=gen).to(dtype)
    dt = torch.rand(bh, s, device=DEV, generator=gen) * 0.19 + 0.01
    a = -(torch.rand(bh, device=DEV, generator=gen) * 1.5 + 0.5)
    b = torch.randn(bh, s, n, device=DEV, generator=gen).to(dtype)
    c = torch.randn(bh, s, n, device=DEV, generator=gen).to(dtype)
    return x, dt, a, b, c


def check_ssd_result(torch, got, want, dtype: str, what: str) -> float:
    """Raise unless (y, state) agree at SSD_TOL; returns the max abs error."""
    tol = SSD_TOL[dtype]
    if dtype == "float32":
        ratio = max(allclose_ratio(g, w, tol) for g, w in zip(got, want))
        print(f"check ssd {what}: max |diff| / (tol + tol |want|) {ratio:.3g} (<= 1, "
              f"tol {tol})")
        if not ratio <= 1:
            raise AssertionError(f"ssd {what}: outside rtol = atol = {tol} ({ratio:.3g})")
    else:
        err = max(rel_err(g, w) for g, w in zip(got, want))
        print(f"check ssd {what}: rel_err {err:.3g} (< {tol})")
        if not err < tol:
            raise AssertionError(f"ssd {what}: rel_err {err} >= {tol}")
    return max((g.float() - w.float()).abs().max().item() for g, w in zip(got, want))


def check_ssd(torch, sc) -> float:
    """Phase 3, SSD: the kernel through ssd_chunk_fused against its plain
    version; returns the max abs error."""
    gen = torch.Generator(device=DEV).manual_seed(7)
    worst = 0.0
    for arch, h, p, n in ssd_layouts():
        for s in SSD_SEQS:
            for dtype in (torch.bfloat16, torch.float32):
                args = ssd_inputs(torch, gen, BATCH * h, s, p, n, dtype)
                got = sc.ssd_chunk_fused(*args, chunk=SSD_CHUNK)
                torch.cuda.synchronize()
                want = sc.ssd_chunk_plain(*args, chunk=SSD_CHUNK)
                worst = max(worst, check_ssd_result(
                    torch, got, want, str(dtype)[6:],
                    f"{arch} ({BATCH * h},{s},{p},{n}) {str(dtype)[6:]}"))
    return worst


def ssd_device_kernels(sc) -> tuple[str, ...]:
    """The SSD's device kernels, as named in csrc/ssd_chunk.cu."""
    return tuple(v for k, v in sc.KERNEL_NAMES.items() if k != "ssd")


def ssd_row(torch, sc, what, x, dt, a, b, c) -> dict:
    """Kernel and plain times (device, profiler) of one call, and the bound:
    the bytes of ``hbm_bytes_fused`` and the operations over the card's peak
    for x's type.  device_kernels: each device kernel's launches in one call
    (the wrapper's counts); by_record_ms: the kernel's device time per call
    by device kernel (None where CUDA events stood in).  Raises unless the
    traces recorded exactly the device kernels of x's route."""
    bh, s, p = x.shape
    n = b.shape[-1]
    names = ssd_device_kernels(sc)
    route = sorted(sc.KERNEL_NAMES[k] for k in sc.ROUTES[x.dtype])
    before = dict(sc.launches)
    sc.ssd_chunk_fused(x, dt, a, b, c, chunk=SSD_CHUNK)
    torch.cuda.synchronize()
    launched = {sc.KERNEL_NAMES[k]: sc.launches[k] - before[k] for k in sc.KERNEL_NAMES
                if k != "ssd"}
    if sorted(k for k, v in launched.items() if v) != route or max(launched.values()) > 1:
        raise AssertionError(f"ssd {what} {dtype_name(x)}: one call launched {launched}, "
                             f"expected one each of {route}")
    t, by_fn = timed_fields(torch, {
        "ms": lambda: sc.ssd_chunk_fused(x, dt, a, b, c, chunk=SSD_CHUNK),
        "plain_ms": lambda: sc.ssd_chunk_plain(x, dt, a, b, c, chunk=SSD_CHUNK)})
    records = by_fn["ms"]
    ran = timed_kernels(records, names)
    if ran != route and not (t["timer"]["ms"] == "events" and not ran):
        raise AssertionError(f"ssd {what} {dtype_name(x)}: traces recorded {ran}, "
                             f"expected {route}")
    byte_ms = sc.hbm_bytes_fused(bh, s, p, n, x.element_size()) / HBM_BYTES_PER_S * 1e3
    op_ms = ssd_ops(bh, s, p, n, SSD_CHUNK) / PEAK_FLOPS[dtype_name(x)] * 1e3
    return {"what": what, "BH": bh, "S": s, "P": p, "N": n, "chunk": SSD_CHUNK,
            "dtype": dtype_name(x), **t, "library_ms": None,
            "device_kernels": launched,
            "by_record_ms": kernel_split(records, route, 1),
            **bound_fields(byte_ms, op_ms)}


def clock_under_load(torch, fn, ms_per_call: float) -> dict:
    """Time fn() with CUDA events over about a second of back-to-back calls
    while nvidia-smi samples the SM clock (MHz) and board power (W) every
    100 ms; returns the event ms per call and the median samples."""
    reps = max(50, int(1000 / max(ms_per_call, 1e-3)))
    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                            "--format=csv,noheader,nounits", "-lms", "100"],
                           stdout=subprocess.PIPE, text=True)
    try:
        time.sleep(0.3)                     # nvidia-smi's own start-up
        ms = event_ms(torch, fn, reps)
    finally:
        smi.terminate()
        out, _ = smi.communicate(timeout=30)
    samples = [[float(v) for v in line.split(",")] for line in out.splitlines()
               if line.strip() and "N/A" not in line]
    samples = samples[3:] or samples        # skip the reads before the calls began
    med = lambda i: sorted(s[i] for s in samples)[len(samples) // 2] if samples else None
    return {"event_ms": ms, "reps": reps, "sm_clock_mhz": med(0), "power_w": med(1),
            "samples": len(samples)}


def weight_shares(torch, dt, a, chunk: int) -> dict:
    """Shares of the intra-chunk weights exp(seg_i - seg_j), i >= j, that are
    0, subnormal (below 2^-126) and normal in f32."""
    bh, s = dt.shape
    seg = torch.cumsum((dt.float() * a[:, None]).reshape(bh, s // chunk, chunk).double(),
                       dim=-1).float()
    w = torch.exp(seg[..., :, None] - seg[..., None, :])
    lower = torch.ones(chunk, chunk, dtype=torch.bool, device=dt.device).tril()
    w = w[..., lower]
    tiny = torch.finfo(torch.float32).tiny
    zero, sub = (w == 0).float().mean().item(), ((w > 0) & (w < tiny)).float().mean().item()
    return {"zero": zero, "subnormal": sub, "normal": 1 - zero - sub}


def ssd_input_study(torch, sc, real) -> dict:
    """The SSD kernel at one real layer's shape on the real inputs, on random
    ones as phase 4 makes them, and on mixes of the two: device time
    (profiler), CUDA-event time over a second of calls with the SM clock
    and board power sampled meanwhile, and the share of zero and subnormal
    intra-chunk weights.  Returns the rows by name."""
    x, dt, a, b, c = real
    bh, s, p = x.shape
    gen = torch.Generator(device=DEV).manual_seed(9)
    rx, rdt, ra, rb, rc = ssd_inputs(torch, gen, bh, s, p, b.shape[-1], torch.float32)
    variants = {"real": (x, dt, a, b, c),
                "random": (rx, rdt, ra, rb, rc),
                "random x/b/c, real dt/a": (rx, dt, a, rb, rc),
                "real x/b/c, random dt/a": (x, rdt, ra, b, c),
                "random, dt / 100 (no weight underflows)": (rx, rdt / 100, ra, rb, rc),
                "zero x/b/c, real dt/a": (torch.zeros_like(x), dt, a, torch.zeros_like(b),
                                          torch.zeros_like(c))}
    rows = {}
    for name, args in variants.items():
        fn = lambda: sc.ssd_chunk_fused(*args, chunk=SSD_CHUNK)
        dev, _, timer, _ = device_ms(torch, fn, 3)
        rows[name] = {"ms": dev, "timer": timer, **clock_under_load(torch, fn, dev),
                      "weights": weight_shares(torch, args[1], args[2], SSD_CHUNK)}
        print(f"time ssd inputs {name}: " + json.dumps(rows[name]))
    return rows


def time_ssd(torch, sc) -> list[dict]:
    """Phase 4, SSD: bf16 and f32 at every layout and S of the check.  No
    single PyTorch call computes the scan, so there is no library time."""
    gen = torch.Generator(device=DEV).manual_seed(8)
    rows = []
    for arch, h, p, n in ssd_layouts():
        for s in SSD_SEQS:
            for dtype in (torch.bfloat16, torch.float32):
                args = ssd_inputs(torch, gen, BATCH * h, s, p, n, dtype)
                rows.append(ssd_row(torch, sc, arch, *args))
                print("time ssd " + json.dumps(rows[-1]))
    return rows


def ssd_path(torch, sc, model, prompts) -> dict:
    """Phase 7, the SSD path: the SSD inputs of every Mamba2 layer of a
    mamba2-130m prefill, flattened to [BH, S, .] in f32, through
    ssd_chunk_fused (counts from 0 just before, read just after), each
    against ssd_chunked in f32 on the CPU with the heads as independent
    rows, as the reference's oracle runs it (tests/test_ssd_kernel.py:12-21)."""
    from repro_torch.models import ssm
    m = model.model
    seen = capture(ssm, "ssd_chunked", lambda: model.prefill(
        prompts, model.init_decode_state(BATCH, prompts.shape[1])))
    calls = []
    for (x, dt, A, B, C, chunk, *_), _, _ in seen:
        b, s, h, p = x.shape
        rep = h // B.shape[2]
        heads = lambda t: torch.repeat_interleave(t, rep, dim=2).transpose(1, 2)
        calls.append((x.transpose(1, 2).reshape(b * h, s, p).float().contiguous(),
                      dt.transpose(1, 2).reshape(b * h, s).float().contiguous(),
                      A.float().repeat(b).contiguous(),
                      heads(B).reshape(b * h, s, -1).float().contiguous(),
                      heads(C).reshape(b * h, s, -1).float().contiguous(), chunk))
    if len(calls) != m.n_layers or calls[0][-1] != SSD_CHUNK:
        raise AssertionError(f"captured {len(calls)} SSD calls (chunk "
                             f"{calls[0][-1] if calls else None}), expected {m.n_layers}")
    sc.reset_launches()
    outs = [sc.ssd_chunk_fused(x, dt, a, b, c, chunk=chunk)
            for x, dt, a, b, c, chunk in calls]
    torch.cuda.synchronize()
    counts = dict(sc.launches)
    launches = counts["ssd"]
    # every device kernel of the f32 route once per layer, the others never
    route = sc.ROUTES[torch.float32]
    expect = {k: m.n_layers if k == "ssd" or k in route else 0 for k in counts}
    if counts != expect:
        raise AssertionError(f"ssd path launched {counts}, expected {expect}")
    device_kernels = {sc.KERNEL_NAMES[k]: counts[k] for k in counts if k != "ssd"}
    worst = 0.0
    for i, ((x, dt, a, b, c, chunk), got) in enumerate(zip(calls, outs)):
        # one batch row, the BH rows as heads (each its own group), on the
        # CPU, whose torch.cumsum rounds the f64 running sum once as the
        # kernel does (at these decay rates |seg| reaches the hundreds, and
        # exp(seg_i - seg_j) inherits seg's absolute error)
        x, dt, a, b, c = (t.cpu() for t in (x, dt, a, b, c))
        y, fin = ssm.ssd_chunked(x.transpose(0, 1)[None], dt.T[None], a,
                                 b.transpose(0, 1)[None], c.transpose(0, 1)[None], chunk)
        want = (y[0].transpose(0, 1).to(DEV), fin[0].transpose(1, 2).to(DEV))
        worst = max(worst, check_ssd_result(torch, got, want, "float32",
                                            f"path layer {i} vs ssd_chunked"))
    x, dt, a, b, c, _ = calls[0]
    row = ssd_row(torch, sc, f"{m.name} prefill layer", x, dt, a, b, c)
    row.update(launches=launches, max_abs_err=worst, device_kernels=device_kernels)
    print(f"ssd path: {launches} launches over {m.n_layers} {m.name} prefill layers "
          f"({tuple(x.shape)}, N={b.shape[-1]}) f32, by device kernel {device_kernels}; "
          f"max abs err vs ssd_chunked {worst:.3g}")
    study = ssd_input_study(torch, sc, (x, dt, a, b, c))
    row["ms_random_inputs"] = study["random"]["ms"]
    row["timer"]["ms_random_inputs"] = study["random"]["timer"]
    print("time ssd " + json.dumps(row))
    return row


# ------------------------------------------------------------------ serving


def engine_of(cfg, name: str):
    from repro_torch.config import EngineConfig
    return (EngineConfig(kind="xla") if name == "xla" else
            dataclasses.replace(cfg.engine, kind="pallas_rasa", schedule=name))


def timed_generation(torch, session, prompts) -> dict:
    """One generation of STEPS tokens through session.prefill and
    session.decode_step, as generate runs them: host clock around the
    prefill and around the steps (each step the argmax of the last logits
    and one decode_step), each ending in torch.cuda.synchronize().  Returns
    the prefill logits (a copy), the tokens and both times."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits = session.prefill(prompts)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    first = logits.clone()
    outs = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(STEPS):
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        outs.append(tok)
        logits = session.decode_step(tok)
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) * 1e3 / STEPS
    return {"logits": first, "tokens": torch.stack(outs, dim=1),
            "prefill_ms": prefill_ms, "decode_ms": decode_ms}


def serve_trace(torch, session, prompts, gemms_per_forward) -> dict:
    """Device records of the session's steps, by torch.profiler: one
    prefill (after another as the profiler's warm-up), and TRACE_STEPS
    consecutive decode steps, each the argmax of the last logits and one
    decode_step as generate runs it (the warm-up: a prefill and TRACE_STEPS
    steps before them).  For each: the device records per call, the GEMM
    kernels' records per call (csrc/rasa_gemm.cu's, by name), the busy
    time per call of all records and of the GEMM records (the union of
    their intervals), the traced window per call (first record's start to
    last record's end: the profiler's per-kernel records stretch it beyond
    the untraced step) and the device idle share (idle_share) over the
    calls.  Where ``gemms_per_forward`` is given, a trace counts only when
    its GEMM records per call equal it, and after TRACE_PAIRS traces that
    do not it raises; otherwise the first trace counts.  "complete" says
    whether every record's count was a multiple of the calls (the
    profiler drops a few records of some traces)."""
    last = []

    def prefill():
        last[:] = [session.prefill(prompts)]

    def steps():
        for _ in range(TRACE_STEPS):
            last[:] = [session.decode_step(torch.argmax(last[0], dim=-1).to(torch.int32))]

    def warm_steps():
        prefill()
        steps()

    out = {}
    for part, calls, work, warm in (("prefill", 1, prefill, None),
                                    ("decode", TRACE_STEPS, steps, warm_steps)):
        for _ in range(TRACE_PAIRS):
            spans = device_spans(profiled(torch, work, warm))
            counts = {}
            for name, _, _ in spans:
                counts[name] = counts.get(name, 0) + 1
            gemm_spans = [(a, b) for n, a, b in spans if any(g in n for g in GEMM_RECORDS)]
            if spans and (gemms_per_forward is None
                          or len(gemm_spans) == calls * gemms_per_forward):
                window = max(b for _, _, b in spans) - min(a for _, a, _ in spans)
                out[part] = {"calls": calls, "records_per_call": len(spans) / calls,
                             "gemm_records_per_call": len(gemm_spans) / calls,
                             "busy_ms_per_call": busy_us([(a, b) for _, a, b in spans])
                             / calls / 1e3,
                             "gemm_busy_ms_per_call": busy_us(gemm_spans) / calls / 1e3,
                             "window_ms_per_call": window / calls / 1e3,
                             "idle_share": idle_share(spans),
                             "complete": all(c % calls == 0 for c in counts.values())}
                break
            print(f"serve trace {part}: {len(gemm_spans)} GEMM records over {calls} calls, "
                  f"expected {calls * gemms_per_forward}; tracing again")
        else:
            raise AssertionError(f"serve trace {part}: no trace held every GEMM record of "
                                 f"{calls} calls")
    return out


def graph_contents(torch, model, batch: int, max_seq: int) -> dict:
    """What a captured decode step holds: model.decode_step captured as
    ServeSession captures it (a warm-up on a side stream first), read
    back from the CUDA graph through the driver API (cuGraphGetNodes,
    cuFuncGetName, cuGraphGetEdges_v2; CUDA 12.3 or later).  Returns the
    nodes by type, the kernel nodes of csrc/rasa_gemm.cu (by name) and
    the others, and the edges by type: "programmatic" is the dependency a
    programmatic dependent launch leaves in a graph (the chained k-chunks
    of base and wlbp), "full" an ordinary one."""
    import ctypes
    from repro_torch.models.transformer import token_shape
    cu = ctypes.CDLL("libcuda.so.1")

    def call(fn, *args):
        err = getattr(cu, fn)(*args)
        if err != 0:
            raise RuntimeError(f"{fn} failed: CUresult {err}")

    state = model.init_decode_state(batch, max_seq)
    tok = torch.zeros(token_shape(model.model, batch), dtype=torch.int32, device=DEV)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        model.decode_step(tok, state)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        model.decode_step(tok, state)
    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    call("cuGraphGetNodes", raw, None, ctypes.byref(n))
    nodes = (ctypes.c_void_p * n.value)()
    call("cuGraphGetNodes", raw, nodes, ctypes.byref(n))
    types, gemm, other = {}, 0, 0
    for node in nodes:
        kind = ctypes.c_int()
        call("cuGraphNodeGetType", ctypes.c_void_p(node), ctypes.byref(kind))
        types[kind.value] = types.get(kind.value, 0) + 1
        if kind.value != 0:                   # CU_GRAPH_NODE_TYPE_KERNEL
            continue
        params = (ctypes.c_byte * 256)()      # CUDA_KERNEL_NODE_PARAMS_v2; func first
        call("cuGraphKernelNodeGetParams_v2", ctypes.c_void_p(node), params)
        name = ctypes.c_char_p()
        call("cuFuncGetName", ctypes.byref(name),
             ctypes.c_void_p(ctypes.c_void_p.from_buffer(params).value))
        if any(g in name.value.decode() for g in GEMM_RECORDS):
            gemm += 1
        else:
            other += 1
    ne = ctypes.c_size_t(0)
    call("cuGraphGetEdges_v2", raw, None, None, None, ctypes.byref(ne))
    frm, to = (ctypes.c_void_p * ne.value)(), (ctypes.c_void_p * ne.value)()
    data = (ctypes.c_ubyte * (8 * ne.value))()  # CUgraphEdgeData: ports, type, reserved
    call("cuGraphGetEdges_v2", raw, frm, to, data, ctypes.byref(ne))
    edges = {"full": 0, "programmatic": 0}
    for i in range(ne.value):
        edges["programmatic" if data[8 * i + 2] == 1 else "full"] += 1
    graph.reset()
    names = {0: "kernel", 1: "memcpy", 2: "memset"}
    return {"nodes": {names.get(k, str(k)): v for k, v in sorted(types.items())},
            "gemm_kernels": gemm, "other_kernels": other, "edges": edges}


def serve_engines(torch, rk, cfg, model, prompts, names, repeats: int = 3) -> dict:
    """Serve ``prompts`` under each engine of ``names`` through two
    ServeSessions: eager (eager=True) and graphed (the default on the
    card), one each for all the engines (the graphs are keyed by the model's
    config).  Per engine: the eager session's prefill launches (one
    forward); the main path, the graphed session's first generate with the
    counts from 0 just before and read just after (it captures prefill and
    decode, one warm-up forward and one captured forward each, and replays
    them); the eager session's generate, counted the same way; then
    timed_generation ``repeats`` times on each session (prefill logits and
    tokens must equal the eager ones bit for bit), serve_trace on each
    (the graphed replays' GEMM records per forward must equal the counted
    launches per forward), and graph_contents of the decode step."""
    from repro_torch.models.transformer import prompt_shape
    from repro_torch.serving import ServeSession
    m = cfg.model
    b, s = prompts.shape[:2]
    max_seq = s + STEPS
    per_forward = gemm_launches_per_forward(m, cfg.engine.block_k)
    sessions = {"eager": ServeSession(model, max_seq=max_seq, device=DEV, eager=True),
                "graphed": ServeSession(model, max_seq=max_seq, device=DEV)}
    results = {}
    for name in names:
        t_engine = time.perf_counter()
        model.cfg = dataclasses.replace(cfg, engine=engine_of(cfg, name))
        rasa = name != "xla"
        eager, graphed = sessions["eager"], sessions["graphed"]
        eager.generate(prompts[:, :8], 2)                       # warm-up
        torch.cuda.synchronize()
        rk.reset_launches()
        eager.prefill(prompts)
        torch.cuda.synchronize()
        if rasa and rk.launches[name] != per_forward[name]:
            raise AssertionError(f"{m.name} {name}: prefill launched {rk.launches[name]}, "
                                 f"expected {per_forward[name]}")

        # the main path: counts from 0 just before, read just after
        torch.cuda.reset_peak_memory_stats()
        rk.reset_launches()
        tokens = graphed.generate(prompts, STEPS)
        torch.cuda.synchronize()
        counts = dict(rk.launches)
        peak = torch.cuda.max_memory_allocated()
        rk.reset_launches()
        eager_tokens = eager.generate(prompts, STEPS)
        torch.cuda.synchronize()
        eager_counts = dict(rk.launches)
        if (tokens.shape != prompt_shape(m, b, STEPS) or tokens.min() < 0
                or tokens.max() >= m.vocab):
            raise AssertionError(f"{m.name} {name}: bad tokens {tuple(tokens.shape)}")
        for what, got, n in (("graphed (warm-up + capture)", counts, 4),
                             ("eager", eager_counts, 1 + STEPS)):
            expect = {sch: n * per_forward[sch] if sch == name else 0 for sch in rk.SCHEDULES}
            if got != expect:
                raise AssertionError(f"{m.name} {name} {what}: launches {got}, expected {expect}")

        runs = {mode: [timed_generation(torch, sessions[mode], prompts) for _ in range(repeats)]
                for mode in ("eager", "graphed")}
        logits = runs["eager"][0]["logits"]
        for mode, rs in runs.items():
            for r in rs:
                if not torch.equal(r["logits"], logits):
                    raise AssertionError(f"{m.name} {name} {mode}: prefill logits differ "
                                         "from the eager ones")
                if not (torch.equal(r["tokens"], eager_tokens)
                        and torch.equal(r["tokens"], tokens)):
                    raise AssertionError(f"{m.name} {name} {mode}: tokens differ from "
                                         "generate's")
        if not torch.isfinite(logits).all():
            raise AssertionError(f"{m.name} {name}: non-finite prefill logits")
        # the wrapper counts the eager launches; a replay's only from its trace
        traces = {mode: serve_trace(torch, sessions[mode], prompts,
                                    per_forward[name] if rasa and mode == "graphed" else None)
                  for mode in ("eager", "graphed")}
        contents = graph_contents(torch, model, b, max_seq)
        if rasa:
            # each k-chunk after a GEMM's first waits on the one before it
            # through a programmatic edge (base, wlbp); wls launches once
            chained = per_forward[name] - per_forward["wls"]
            if (contents["gemm_kernels"], contents["edges"]["programmatic"]) != (
                    per_forward[name], chained):
                raise AssertionError(f"{m.name} {name}: the captured decode step holds "
                                     f"{contents}, expected {per_forward[name]} GEMM kernels "
                                     f"and {chained} programmatic edges")
        res = {"logits": logits, "tokens": tokens, "launches": counts,
               "eager_launches": eager_counts, "max_memory_bytes": peak,
               "decode_graph": contents}
        for mode, rs in runs.items():
            prefill = [r["prefill_ms"] for r in rs]
            decode = [r["decode_ms"] for r in rs]
            step = statistics.median(decode)
            res[mode] = {"prefill_ms": statistics.median(prefill), "decode_ms_per_step": step,
                         "tokens_per_s": b * 1e3 / step, "prefill_ms_runs": prefill,
                         "decode_ms_runs": decode, "trace": traces[mode]}
        results[name] = res
        print(f"serve {m.name} {name}: " + json.dumps(
            {k: v for k, v in res.items() if k not in ("logits", "tokens")}))
        print(f"serve {m.name} {name}: graphed prefill {res['graphed']['prefill_ms']:.3f} ms, "
              f"decode {res['graphed']['decode_ms_per_step']:.3f} ms/step (idle share "
              f"{traces['graphed']['decode']['idle_share']:.4f}); eager prefill "
              f"{res['eager']['prefill_ms']:.3f} ms, decode "
              f"{res['eager']['decode_ms_per_step']:.3f} ms/step; graphed = eager bit for "
              f"bit (prefill logits, tokens); {time.perf_counter() - t_engine:.1f} s")
    return results


def compare_engines(torch, cfg, results, prompts, build_model) -> None:
    """Kernel engine vs xla on prefill logits: bf16 within BF16_TOL, then
    the same weights in f32 within SERVE_TOL."""
    m = cfg.model
    ref = results["wls"]
    err16 = rel_err(ref["logits"], results["xla"]["logits"])
    agree = (ref["tokens"] == results["xla"]["tokens"]).float().mean().item()
    print(f"serve {m.name}: bf16 kernel vs xla prefill logits rel_err {err16:.6g} "
          f"(< {BF16_TOL}); token agreement with xla {agree:.4f}")
    if not err16 < BF16_TOL:
        raise AssertionError(f"{m.name}: bf16 kernel engine vs xla rel_err {err16} >= {BF16_TOL}")
    cfg32 = dataclasses.replace(cfg, model=dataclasses.replace(m, dtype="float32"))
    model = build_model(cfg32, device=DEV, seed=0)
    logits32 = {}
    for name in ("wls", "xla"):
        model.cfg = dataclasses.replace(cfg32, engine=engine_of(cfg, name))
        logits32[name], _ = model.prefill(
            prompts, model.init_decode_state(prompts.shape[0], prompts.shape[1]))
    err32 = rel_err(logits32["wls"], logits32["xla"])
    print(f"serve {m.name}: f32 weights, kernel vs xla prefill logits rel_err "
          f"{err32:.6g} (< {SERVE_TOL})")
    if not err32 < SERVE_TOL:
        raise AssertionError(f"{m.name}: f32 kernel engine vs xla rel_err {err32} >= {SERVE_TOL}")


def build_served(torch, cfg, prompt: int):
    """The model of ``cfg`` (random weights from seed 0) and its prompts
    [BATCH, prompt] ([BATCH, prompt, n_codebooks] for audio) from seed 3."""
    from repro_torch.models import build_model
    from repro_torch.models.transformer import prompt_shape
    m = cfg.model
    t0 = time.perf_counter()
    model = build_model(cfg, device=DEV, seed=0)
    torch.cuda.synchronize()
    print(f"serve: built {m.name} ({m.n_layers} layers, d={m.d_model}, vocab={m.vocab}) "
          f"in {time.perf_counter() - t0:.3f} s")
    gen = torch.Generator(device=DEV).manual_seed(3)
    prompts = torch.randint(0, m.vocab, prompt_shape(m, BATCH, prompt), device=DEV,
                            generator=gen, dtype=torch.int32)
    return model, prompts


def serve(torch, rk, cfg, names, prompt: int, path=None, repeats: int = 3) -> dict:
    """Phases 5, 7 and 8: one model at full width through ServeSession
    under ``names`` (serve_engines, ``repeats`` timed generations a
    session); schedules bit-identical; kernel vs xla logits.
    ``path(model, prompts, results)``: a further phase on this model (the
    SSD path on mamba2-130m's prefill, granite's MoE), kept under "path"."""
    from repro_torch.models import build_model
    m = cfg.model
    model, prompts = build_served(torch, cfg, prompt)
    results = serve_engines(torch, rk, cfg, model, prompts, names, repeats)
    ref = results["wls"]
    for s in names:
        if s in rk.SCHEDULES and s != "wls":
            if not torch.equal(results[s]["logits"], ref["logits"]):
                raise AssertionError(f"{s}: prefill logits not bit-identical to wls")
            if not torch.equal(results[s]["tokens"], ref["tokens"]):
                raise AssertionError(f"{s}: tokens differ from wls")
            print(f"serve {m.name}: {s} bit-identical to wls (prefill logits and tokens)")
    if path is not None:
        results["path"] = path(model, prompts, results)
    del model
    compare_engines(torch, cfg, results, prompts, build_model)
    for r in results.values():
        r.pop("logits", None)
    return results


def decode_floor_ms(model) -> tuple[float, float]:
    """(weight bytes a decode step reads, their time at the HBM rate, ms):
    every parameter but the embedding, of which a step reads B rows (the
    embedding counts when the head is tied to it).  The MoE's experts all
    count: at decode every group holds one token and one slot per expert,
    so the expert products read all of them."""
    m = model.model
    total = sum(p.numel() * p.element_size() for p in model.parameters())
    if not m.tie_embeddings:
        total -= model.embedding.numel() * model.embedding.element_size()
    return total, total / HBM_BYTES_PER_S * 1e3


def is_library_gemm(record: str) -> bool:
    """Whether a device record is a GEMM kernel of the library (not one of
    csrc/rasa_gemm.cu's)."""
    return (any(n in record.lower() for n in LIBRARY_GEMM_RECORDS)
            and not any(g in record for g in GEMM_RECORDS))


def moe_path(torch, model, prompts, results) -> dict:
    """Phase 8, granite-moe-3b-a800m under wls: the expert-sorted entries the
    capacity dropped in an eager prefill (per layer, of B * S * top_k), and
    one decode step's device time split: the RASA GEMM records of the
    graphed step (its trace), and each MoE piece of the step timed alone
    (profiler device time) on the inputs the step gave it: every layer's
    moe_forward, its expert_ffn (the expert products, of which the
    library's GEMM records are the bmm's), the router's product (the
    library GEMM records of moe_forward beyond the experts') and the rest,
    dispatch and combine.  The router and dispatch/combine times are
    differences between those separate traces, not records of their own;
    the records that is_library_gemm does not match are printed in full
    (per call ms), so that a library GEMM record under another name shows
    there."""
    from repro_torch.models import moe, transformer
    m = model.model
    b, s = prompts.shape[:2]
    model.cfg = dataclasses.replace(model.cfg, engine=engine_of(model.cfg, "wls"))
    state = model.init_decode_state(b, s + STEPS)
    seen = capture(transformer, "moe_forward", lambda: model.prefill(prompts, state))
    dropped = [int((~out[1].keep).sum()) for _, _, out in seen]
    entries = b * s * m.moe.top_k
    g = moe._group_count(b * s, m.moe.dispatch_groups)
    print(f"moe {m.name}: prefill ({b}x{s} tokens, {g} groups of {b * s // g}, capacity "
          f"{moe.capacity(b * s // g, m)} per expert): {sum(dropped)} of "
          f"{entries * len(dropped)} expert entries dropped by the capacity over "
          f"{len(dropped)} layers; per layer {dropped}")
    tok = torch.zeros(transformer.token_shape(m, b), dtype=torch.int32, device=DEV)
    ffn = []
    seen = capture(transformer, "moe_forward", lambda: ffn.extend(
        capture(moe, "expert_ffn", lambda: model.decode_step(tok, state))))
    torch.cuda.synchronize()
    calls = [(a, kw) for a, kw, _ in seen]
    ffn_calls = [(a, kw) for a, kw, _ in ffn]
    t_moe, _, timer_moe, rec_moe = device_ms(
        torch, lambda: [transformer.moe_forward(*a, **kw) for a, kw in calls], 3)
    t_ffn, _, timer_ffn, rec_ffn = device_ms(
        torch, lambda: [moe.expert_ffn(*a, **kw) for a, kw in ffn_calls], 3)
    lib = lambda recs: (None if any(v is None for v in recs.values())
                        else sum(v for r, v in recs.items() if is_library_gemm(r)))
    bmm, lib_moe = lib(rec_ffn), lib(rec_moe)
    router = None if bmm is None or lib_moe is None else lib_moe - bmm
    trace = results["wls"]["graphed"]["trace"]["decode"]
    busy, rasa = trace["busy_ms_per_call"], trace["gemm_busy_ms_per_call"]
    split = {"busy_ms": busy, "rasa_gemm_ms": rasa, "moe_ms": t_moe, "expert_ffn_ms": t_ffn,
             "expert_bmm_ms": bmm, "router_mm_ms": router,
             "dispatch_combine_ms": None if router is None else t_moe - t_ffn - router,
             "other_ms": busy - rasa - t_moe, "layers": len(calls),
             "expert_kernels": library_kernels(r for r in rec_ffn if is_library_gemm(r)),
             "timer": {"moe_ms": timer_moe, "expert_ffn_ms": timer_ffn}}
    print(f"moe {m.name} decode step split (ms; busy and rasa_gemm from the graphed trace, "
          "the MoE pieces timed alone; router_mm_ms and dispatch_combine_ms are differences "
          "of those timings): " + json.dumps(split))
    unmatched = {what: {r: v for r, v in sorted(recs.items()) if not is_library_gemm(r)}
                 for what, recs in (("moe_forward", rec_moe), ("expert_ffn", rec_ffn))}
    print(f"moe {m.name} decode step records not matched as library GEMMs (ms per call): "
          + json.dumps(unmatched))
    return {"prefill_dropped": dropped, "prefill_entries_per_layer": entries,
            "decode_split": split, "unmatched_records": unmatched}


def time_heads(torch, rk, cfg) -> list[dict]:
    """Phase 8: the untied heads of phases 8 and 9 at M = batch (the head
    sees only the last position, in prefill as in decode), bf16: each
    schedule, the plain version and torch.matmul (device time; distinct
    weights summing to at least 100 MB, so that the weights come cold from
    HBM as in a step), against the bound."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import head_width
    blocks = rk.GemmBlocks(cfg.engine.block_m, cfg.engine.block_k, cfg.engine.block_n)
    gen = torch.Generator(device=DEV).manual_seed(11)
    fns = {**{sch: lambda x, w, sch=sch: rk.rasa_gemm(x, w, schedule=sch, blocks=blocks)
              for sch in rk.SCHEDULES},
           "plain": lambda x, w: rk.rasa_gemm_plain(x, w, blocks=blocks),
           "library": torch.matmul}
    rows = []
    for arch in (*FAMILY_ARCHS, *REDUCED):
        m = get_config(arch).model
        k, n = m.d_model, head_width(m)
        copies = max(1, -(-100_000_000 // (2 * k * n)))
        ws = [torch.randn(k, n, device=DEV, generator=gen).to(torch.bfloat16)
              for _ in range(copies)]
        a = torch.randn(BATCH, k, device=DEV, generator=gen).to(torch.bfloat16)
        row = {"what": f"{arch} head", "M": BATCH, "K": k, "N": n, "timer": {}}
        for name, f in fns.items():
            dev, _, row["timer"][name], _ = device_ms(torch, lambda: [f(a, w) for w in ws], 3)
            row[f"{name}_ms"] = dev / copies
        row.update(bound_fields(*gemm_bound_ms(BATCH, k, n, "bfloat16")))
        row["hbm_share"] = {name: hbm_share(row["bytes_ms"], row[f"{name}_ms"]) for name in fns}
        rows.append(row)
        print("time head " + json.dumps(row))
        del ws, a
    return rows


def serve_family(torch, rk, cfg) -> dict:
    """Phase 8: one model (granite-moe-3b-a800m, musicgen-large) at full
    width and depth under wls and xla (serve, one timed generation a
    session), beside its decode floor; the MoE with moe_path."""
    m = cfg.model
    path = (lambda model, prompts, results: {
        "floor": decode_floor_ms(model),
        **(moe_path(torch, model, prompts, results) if m.family == "moe" else {})})
    out = serve(torch, rk, cfg, ("wls", "xla"), PROMPT, path=path, repeats=1)
    floor_bytes, floor_ms = out["path"]["floor"]
    print(f"serve {m.name}: decode floor {floor_bytes / 1e9:.3f} GB of weights per step "
          f"-> {floor_ms:.4f} ms at {HBM_BYTES_PER_S / 1e12} TB/s; graphed wls "
          f"{out['wls']['graphed']['decode_ms_per_step']:.3f} ms/step")
    torch.cuda.empty_cache()
    return out


def serve_reduced(torch, rk, arch: str, layers: int) -> dict:
    """Phase 9: ``arch`` at full width and ``layers`` of its layers under wls
    through the graphed and the eager session (serve_engines: bit for bit,
    one timed generation each, traced), then the xla engine's eager prefill logits against
    wls's at the bf16 tolerance."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    full = cfg.model.n_layers
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, n_layers=layers))
    label = f"{arch} (reduced depth, {layers} of {full} layers)"
    print(f"serve {label}")
    model, prompts = build_served(torch, cfg, PROMPT)
    results = serve_engines(torch, rk, cfg, model, prompts, ("wls",), repeats=1)
    model.cfg = dataclasses.replace(cfg, engine=engine_of(cfg, "xla"))
    xla, _ = model.prefill(prompts, model.init_decode_state(BATCH, PROMPT))
    err = rel_err(results["wls"]["logits"], xla)
    print(f"serve {label}: bf16 kernel vs xla prefill logits rel_err {err:.6g} (< {BF16_TOL})")
    if not (err < BF16_TOL and torch.isfinite(xla).all()):
        raise AssertionError(f"{label}: bf16 kernel engine vs xla rel_err {err} >= {BF16_TOL}")
    results["floor"] = decode_floor_ms(model)
    print(f"serve {label}: decode floor {results['floor'][0] / 1e9:.3f} GB of weights per "
          f"step -> {results['floor'][1]:.4f} ms at {HBM_BYTES_PER_S / 1e12} TB/s; graphed "
          f"wls {results['wls']['graphed']['decode_ms_per_step']:.3f} ms/step")
    del model, xla
    torch.cuda.empty_cache()
    results["wls"].pop("logits")
    results["label"], results["xla_rel_err"] = label, err
    return results


# ------------------------------------------------------------------- train

TRAIN_ARCHS = ("qwen3-1.7b", "mamba2-130m")
TRAIN_RASA = "qwen3-1.7b"      # the arch whose loss phase 10 also takes under pallas_rasa
TRAIN = dict(global_batch=8, seq_len=512, microbatches=2, lr=3e-4, warmup_steps=2,
             total_steps=8)
TRAIN_RESUME_AT = 4            # checkpoint_every: the step the resumed run restores
TRAIN_RTOL = 1e-3              # resumed losses against the first run's
RASA_LOSS_TOL = 0.02           # tests/test_arch_smoke.py::test_pallas_engine_integration
PREDICTION_TRAIN = (
    "qwen3-1.7b FULL, batch 8 x 512, 2 microbatches, remat full, AdamW f32 moments: "
    "300-700 ms/step (6k-14k tokens/s), model FLOPs 6-15% of the bf16 peak, peak device "
    "memory 28-40 GB; mamba2-130m FULL: 150-600 ms/step, under 2% of the peak, 3-12 GB. "
    "Resumed losses bit-equal to the first run's. pallas_rasa (wls) loss within 0.005 of "
    "xla's.")


def model_flops(m, tokens: int) -> float:
    """The model FLOPs of one train step over ``tokens`` tokens of length
    TRAIN["seq_len"]: 6 N per token (N = ModelConfig.param_count(), the
    embedding counted once) plus attention's 12 L H hd S per token (PaLM's
    count: QK^T and PV, forward and backward, without the causal half); the
    remat re-forward is not counted.  An attention-free model has no second
    term (the SSD scan's operations are not counted)."""
    attn_layers = {"ssm": 0, "hybrid": m.n_layers // m.hybrid.attn_every
                   if m.hybrid else 0}.get(m.family, m.n_layers)
    attn = 12 * attn_layers * m.n_heads * m.resolved_head_dim * TRAIN["seq_len"]
    return (6 * m.param_count() + attn) * tokens


def state_bits(torch, state) -> list:
    """Every leaf of a TrainState as raw bytes, on its device (a snapshot)."""
    from repro_torch.checkpoint.store import flatten_with_names
    return [t.detach().reshape(-1).view(torch.uint8).clone()
            for _, t in flatten_with_names(state)]


def train_steps(torch, step_fn, card: str, label: str, records: list):
    """step_fn timed on the host clock (synchronised before and after),
    each step's loss, grad_norm, lr and ms appended to records and
    printed."""
    def step(state, batch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        row = {k: float(metrics[k]) for k in ("loss", "grad_norm", "lr")}
        torch.cuda.synchronize()
        row["ms"] = (time.perf_counter() - t0) * 1e3
        row["step"] = int(state.step) - 1
        records.append(row)
        print(f"train {label} step {row['step']}: loss {row['loss']:.6f} grad_norm "
              f"{row['grad_norm']:.6f} lr {row['lr']:.6g} {row['ms']:.3f} ms | {card}")
        return state, metrics
    return step


def check_gradients(torch, model, batch) -> int:
    """One forward and backward outside the loop: every parameter has a
    finite gradient that is not all zero.  Returns the parameter count."""
    loss, _ = model.loss(batch)
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, params)
    for name, g in zip(names, grads):
        if g is None or not torch.isfinite(g).all() or not g.any():
            raise AssertionError(f"train: parameter {name} has no usable gradient")
    return len(names)


def rasa_loss_check(torch, rk, model, cfg, batch, card: str) -> dict:
    """The forward loss of the trained parameters on one batch under the
    xla engine and under pallas_rasa (wls), under torch.no_grad(): within
    RASA_LOSS_TOL, and the wrapper's wls launches counted from 0 over the
    RASA forward (7 projections a layer; the CE head is not an engine
    product).  Then the RASA forward again, every wls call's output held
    to the plain version on its own inputs at REL_TOL (the kernel at this
    path's shapes and activations; the plain version launches no kernel)."""
    from repro_torch.kernels import ops
    with torch.no_grad():
        timed = {}
        for name in ("xla", "wls"):
            model.cfg = dataclasses.replace(cfg, engine=engine_of(cfg, name))
            if name == "wls":
                for s in rk.launches:
                    rk.launches[s] = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, _ = model.loss(batch)
            loss = float(loss)
            timed[name] = (loss, (time.perf_counter() - t0) * 1e3)
            if name == "wls":
                launches = dict(rk.launches)
        kernel, errs = ops.rasa_gemm, []

        def held(a, b, c=None, **kw):
            out = kernel(a, b, c, **kw)
            want = rk.rasa_gemm_plain(a, b, c, **kw)
            errs.append(((a.shape[0], *b.shape), rel_err(out, want)))
            return out

        ops.rasa_gemm = held
        try:
            model.loss(batch)
        finally:
            ops.rasa_gemm = kernel
    model.cfg = cfg
    worst_shape, worst = max(errs, key=lambda e: e[1])
    print(f"train {cfg.model.name}: {len(errs)} wls calls of the pallas_rasa loss against "
          f"the plain version on their inputs: max rel_err {worst:.3g} at (M, K, N) "
          f"{worst_shape} (< {REL_TOL}) | {card}")
    if len(errs) != 7 * cfg.model.n_layers or not worst < REL_TOL:
        raise AssertionError(f"train: {len(errs)} wls calls, max rel_err {worst} at "
                             f"{worst_shape}, want {7 * cfg.model.n_layers} under {REL_TOL}")
    (lx, mx), (lr_, mr) = timed["xla"], timed["wls"]
    want = 7 * cfg.model.n_layers
    print(f"train {cfg.model.name}: forward loss xla {lx:.6f} ({mx:.3f} ms), pallas_rasa wls "
          f"{lr_:.6f} ({mr:.3f} ms), |diff| {abs(lr_ - lx):.6g}; wls launches "
          f"{launches['wls']} (want {want}) | {card}")
    if not abs(lr_ - lx) <= RASA_LOSS_TOL * (1 + abs(lx)):
        raise AssertionError(f"train: pallas_rasa loss {lr_} vs xla {lx} beyond "
                             f"rtol = atol = {RASA_LOSS_TOL}")
    if launches["wls"] != want or launches["base"] or launches["wlbp"]:
        raise AssertionError(f"train: RASA launches {launches}, want wls {want}")
    return {"xla_loss": lx, "wls_loss": lr_, "xla_ms": mx, "wls_ms": mr,
            "launches": launches["wls"], "calls_max_rel_err": worst}


def train_trace(torch, model, step_fn, state, batch, label: str, card: str) -> dict:
    """One more train step traced by torch.profiler (after another as its
    warm-up; both update the state, after the checks): its device busy ms,
    the idle share of its window, the library GEMMs' device ms (cuBLAS's
    records; the bf16 products and the f32 ones alike), and the ten kernels
    that took the most device time, by name (records summed).  Beside it,
    by CUDA events over 3 calls each: the loss forward of one microbatch
    under torch.no_grad(), and one AdamW update of every parameter (zero
    gradients: the same work)."""
    from repro_torch.optim import adamw_update
    tr = model.cfg.train
    rows = TRAIN["global_batch"] // tr.microbatches
    with torch.no_grad():
        forward = event_ms(torch, lambda: model.loss({k: v[:rows] for k, v in batch.items()}), 3)
    zeros = {n: torch.zeros_like(p) for n, p in state.params.items()}
    optimizer = event_ms(torch, lambda: adamw_update(state.params, zeros, state.opt, lr=tr.lr), 3)
    del zeros
    prof = profiled(torch, lambda: step_fn(state, batch))
    spans = device_spans(prof)
    by_name: dict[str, list] = {}
    for name, a, b in spans:
        row = by_name.setdefault(kernel_name(name), [0, 0.0, is_library_gemm(name)])
        row[0] += 1
        row[1] += (b - a) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    out = {"forward_ms": forward, "optimizer_ms": optimizer,
           "busy_ms": busy_us([(a, b) for _, a, b in spans]) / 1e3,
           "idle_share": idle_share(spans), "records": len(spans),
           "library_gemm_ms": sum(v[1] for v in by_name.values() if v[2]),
           "top": {k: {"records": v[0], "ms": v[1]} for k, v in top}}
    print(f"train {label}: loss forward of one microbatch {forward:.3f} ms, AdamW update "
          f"{optimizer:.3f} ms (CUDA events); traced step busy {out['busy_ms']:.3f} ms, idle share "
          f"{out['idle_share']:.4f}, {out['records']} records, library GEMMs "
          f"{out['library_gemm_ms']:.3f} ms; top kernels (ms): "
          + ", ".join(f"{k} {v['ms']:.3f} ({v['records']})" for k, v in out["top"].items())
          + f" | {card}")
    return out


#: the contractions of dot_f32's backward probed by product_precision:
#: aᵀ G over the tokens of a microbatch of 8192, G wᵀ over 2 d_ff of
#: qwen3-1.7b (the fused gate/up, 12288); (x, y) shapes of x @ y
PRECISION_CASES = {"aT_G_8192": ((2048, 8192), (8192, 1024)),
                   "G_wT_12288": ((2048, 12288), (12288, 2048))}
PRECISION_PIECES = (None, 4096, 2048, 1024, 512)


def product_precision(torch, card: str) -> dict:
    """How far the xla engine's bf16 products are from the exact (f64)
    product at the contractions of dot_f32's backward (PRECISION_CASES; x a
    transposed view where the backward reads one; mm and a bmm of 2): the
    f32-cast product, the ``out_dtype`` overload over the whole contraction
    (``_product``, the forward's route) and in pieces of 4096 .. 512 summed
    in fp32 (``_grad_product``; the backward takes GRAD_K_PIECE).  Max
    error over max."""
    from repro_torch.models.common import GRAD_K_PIECE, _grad_product, _product
    gen = torch.Generator(device=DEV).manual_seed(1)
    rel = lambda x, ref: ((x.double() - ref).abs().max() / ref.abs().max()).item()
    out = {"grad_k_piece": GRAD_K_PIECE}
    for op in ("mm", "bmm"):
        fn, lead = getattr(torch, op), (2,) if op == "bmm" else ()
        for case, ((m, k), (_, n)) in PRECISION_CASES.items():
            if case.startswith("aT"):     # aᵀ: a [k, m] read transposed
                x = torch.randn(*lead, k, m, device=DEV, generator=gen).to(
                    torch.bfloat16).transpose(-1, -2)
                y = torch.randn(*lead, k, n, device=DEV, generator=gen).to(torch.bfloat16)
            else:                         # wᵀ: w [n, k] read transposed
                x = torch.randn(*lead, m, k, device=DEV, generator=gen).to(torch.bfloat16)
                y = torch.randn(*lead, n, k, device=DEV, generator=gen).to(
                    torch.bfloat16).transpose(-1, -2)
            exact = fn(x.double(), y.double())
            row = {"f32_vs_f64": rel(fn(x.float(), y.float()), exact)}
            for piece in PRECISION_PIECES:
                got = _product(fn, x, y) if piece is None else _grad_product(fn, x, y, piece)
                row[f"out_dtype_{piece or 'whole'}_vs_f64"] = rel(got, exact)
            out[f"{op}_{case}"] = row
            del x, y, exact
    torch.cuda.empty_cache()
    print("train: bf16 products at the backward's contractions (max error over max): "
          + json.dumps(out) + f" | {card}")
    return out


def train(torch, rk, arch: str, card: str, rasa: bool) -> dict:
    """Phase 10: ``arch`` at full width and depth, random weights (seed 0),
    TRAIN through TrainLoop (checkpoints every TRAIN_RESUME_AT steps into a
    directory under build/), with every step timed; the losses finite and
    falling, every parameter's gradient present, no step retried.  Then the
    step-TRAIN_RESUME_AT checkpoint restored into a fresh state (seed 1):
    equal bit for bit to the state the loop held there, and steps
    TRAIN_RESUME_AT.. rerun from it, within TRAIN_RTOL of the first run.
    With ``rasa``, the forward loss under pallas_rasa against xla's."""
    import shutil
    import tempfile
    from repro_torch.checkpoint import restore_into
    from repro_torch.config import TrainConfig
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.models import build_model
    from repro_torch.training import (LoopConfig, TrainLoop, build_train_step,
                                      init_train_state)
    cfg = dataclasses.replace(get_config(arch), train=TrainConfig(**TRAIN))
    m = cfg.model
    data = SyntheticLMDataset(m, seq_len=TRAIN["seq_len"], global_batch=TRAIN["global_batch"],
                              seed=1)
    (ROOT / "build").mkdir(exist_ok=True)
    ckpt_dir = Path(tempfile.mkdtemp(prefix="train-ckpt-", dir=ROOT / "build"))
    try:
        torch.cuda.empty_cache()
        model = build_model(cfg, device=DEV, seed=0)
        state = init_train_state(model)
        n_params = check_gradients(torch, model, data.batch(0))
        print(f"train {m.name}: {n_params} parameters, each with a finite, nonzero gradient")
        torch.cuda.reset_peak_memory_stats()
        first, snap = [], {}

        def at_step(step):
            if step == TRAIN_RESUME_AT:
                torch.cuda.synchronize()
                snap["peak"] = torch.cuda.max_memory_allocated()
                snap["bits"] = state_bits(torch, state)

        loop = TrainLoop(train_steps(torch, build_train_step(model), card, m.name, first),
                         state, data.batch,
                         LoopConfig(total_steps=TRAIN["total_steps"],
                                    checkpoint_every=TRAIN_RESUME_AT,
                                    checkpoint_dir=str(ckpt_dir), log_every=TRAIN["total_steps"]),
                         fault_hook=at_step)
        t0 = time.perf_counter()
        loop.run()
        run_s = time.perf_counter() - t0
        losses = [r["loss"] for r in first]
        if loop.restarts or len(first) != TRAIN["total_steps"]:
            raise AssertionError(f"train {m.name}: {loop.restarts} restarts, "
                                 f"{len(first)} steps")
        if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
            raise AssertionError(f"train {m.name}: losses {losses} not finite and falling")
        rasa_row = rasa_loss_check(torch, rk, model, cfg, data.batch(0), card) if rasa else None
        del loop, state, model
        torch.cuda.empty_cache()

        fresh = build_model(cfg, device=DEV, seed=1)
        resumed = init_train_state(fresh)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        at = restore_into(ckpt_dir, resumed, step=TRAIN_RESUME_AT)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        # device memory the restore took beyond the state it writes into
        restore_extra_gb = (torch.cuda.max_memory_allocated() - before) / 1e9
        saved = snap.pop("bits")
        equal = all(torch.equal(a, b) for a, b in
                    zip(state_bits(torch, resumed), saved, strict=True))
        del saved
        if not equal:
            raise AssertionError(f"train {m.name}: the restored state differs from the "
                                 f"state at step {TRAIN_RESUME_AT}")
        second = []
        step = train_steps(torch, build_train_step(fresh), card, f"{m.name} resumed", second)
        for s in range(TRAIN_RESUME_AT, TRAIN["total_steps"]):
            step(resumed, data.batch(s))
        again = [r["loss"] for r in second]
        rel = max(abs(a - b) / abs(b) for a, b in zip(again, losses[TRAIN_RESUME_AT:]))
        bit_equal = again == losses[TRAIN_RESUME_AT:]
        if not rel <= TRAIN_RTOL:
            raise AssertionError(f"train {m.name}: resumed losses {again} vs "
                                 f"{losses[TRAIN_RESUME_AT:]}: rel {rel} > {TRAIN_RTOL}")
        ckpt_gb = sum(f.stat().st_size for f in ckpt_dir.rglob("*") if f.is_file()) / 1e9
        trace = train_trace(torch, fresh, build_train_step(fresh), resumed,
                            data.batch(TRAIN["total_steps"]), m.name, card)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    del fresh, resumed, step
    torch.cuda.empty_cache()

    tokens = TRAIN["global_batch"] * TRAIN["seq_len"]
    # steps 1..TRAIN_RESUME_AT-1 run before the first save; the later ones
    # beside the checkpoint writer's thread; the resumed run saves nothing
    ms = statistics.median(r["ms"] for r in first[1:TRAIN_RESUME_AT])
    ms_writer = statistics.median(r["ms"] for r in first[TRAIN_RESUME_AT:])
    ms_resumed = statistics.median(r["ms"] for r in second[1:])
    flops = model_flops(m, tokens)
    row = {"arch": arch, "step_ms": [r["ms"] for r in first], "median_step_ms": ms,
           "median_step_ms_beside_writer": ms_writer,
           "resumed_step_ms": [r["ms"] for r in second], "median_resumed_step_ms": ms_resumed,
           "tokens_per_s": tokens / ms * 1e3, "losses": losses,
           "grad_norms": [r["grad_norm"] for r in first], "lrs": [r["lr"] for r in first],
           "resumed_losses": again, "resumed_max_rel": rel, "resumed_bit_equal": bit_equal,
           "restored_bit_equal": equal, "restore_s": restore_s,
           "restore_extra_gb": restore_extra_gb, "run_s": run_s,
           "checkpoint_gb_on_disk": ckpt_gb,
           "peak_gb_steps_0_3": snap["peak"] / 1e9, "model_flops": flops,
           "bf16_peak_share": flops / (ms / 1e3) / PEAK_FLOPS["bfloat16"],
           "parameters": m.param_count(), "rasa": rasa_row, "trace": trace, "card": card}
    print(f"train {m.name}: median step {ms:.3f} ms (steps 1-{TRAIN_RESUME_AT - 1}, before "
          f"the first save; step 0 {first[0]['ms']:.3f} ms; steps {TRAIN_RESUME_AT}-"
          f"{TRAIN['total_steps'] - 1} beside the checkpoint writer {ms_writer:.3f} ms; "
          f"resumed steps {TRAIN_RESUME_AT + 1}-{TRAIN['total_steps'] - 1}, no writer, "
          f"{ms_resumed:.3f} ms) -> {row['tokens_per_s']:.1f} tokens/s; model FLOPs {flops:.4g} a step -> "
          f"{row['bf16_peak_share']:.4f} of the bf16 peak (989 TFLOP/s); peak device memory "
          f"{row['peak_gb_steps_0_3']:.3f} GB (steps 0-3); loop {run_s:.3f} s with "
          f"checkpoints; restore of step {at} {restore_s:.3f} s (in place, "
          f"{restore_extra_gb:.3f} GB of device memory beyond the state), state bit-equal "
          f"{equal}; "
          f"resumed losses max rel {rel:.3g}, bit-equal {bit_equal} | {card}")
    return row


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
    from repro_torch.kernels import _build, flash_mha
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rasa_gemm as rk
    from repro_torch.kernels import ssd_chunk as sc
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

    qwen, mamba, zamba = (get_config(a) for a in ("qwen3-1.7b", "mamba2-130m",
                                                  "zamba2-2.7b"))
    print("prediction (written before the first run of the graphed session): " + PREDICTION)
    print("prediction (written before the first run of phases 8 and 9): " + PREDICTION_FAMILIES)
    print("prediction (written before the first run of phase 10): " + PREDICTION_TRAIN)
    phase = lambda name: print(f"phase {name} at {time.perf_counter() - t_start:.1f} s")
    phase("check")
    worst = check_gemm(torch, rk, (qwen, mamba, zamba, *map(get_config, FAMILY_ARCHS),
                                   *map(get_config, REDUCED)))
    worst["flash"] = check_flash(torch, fa, flash_mha)
    worst["ssd"] = check_ssd(torch, sc)
    phase("time")
    step, gemm_timers = time_gemm(torch, rk, qwen)
    print("time per decode step (M=4, ms; *_wall with launch gaps): " + json.dumps(
        {k: v["decode"] for k, v in step.items()}))
    print("time per prefill (M=512, head M=4, ms; *_wall with launch gaps): " + json.dumps(
        {k: v["prefill"] for k, v in step.items()}))
    gemm32 = time_gemm_f32_prefill(torch, rk, qwen)
    print("time per prefill, f32 (M=512, layer GEMMs, ms): " + json.dumps(gemm32))
    flash32 = next(r for r in time_flash(torch, fa, flash_mha) if r["what"] == F32_LAYER_ROW)
    time_ssd(torch, sc)
    phase("serve qwen3-1.7b")
    results = serve(torch, rk, qwen, ("wls", "wlbp", "base", "xla"), PROMPT)
    phase("flash path")
    flash = flash_path(torch, fa, flash_mha, qwen)
    phase("serve mamba2-130m")
    def ssd_on_xla(model, prompts, _):
        model.cfg = dataclasses.replace(mamba, engine=engine_of(mamba, "xla"))
        return ssd_path(torch, sc, model, prompts)

    ssd = serve(torch, rk, mamba, ("wls", "xla"), SSM_PROMPT, path=ssd_on_xla)["path"]
    phase("serve zamba2-2.7b")
    serve(torch, rk, zamba, ("wls", "xla"), SSM_PROMPT)
    families, reduced = {}, {}
    for arch in FAMILY_ARCHS:
        phase(f"serve {arch}")
        families[arch] = serve_family(torch, rk, get_config(arch))
    phase("time heads")
    time_heads(torch, rk, qwen)
    for arch, layers in REDUCED.items():
        phase(f"serve {arch} at reduced depth")
        reduced[arch] = serve_reduced(torch, rk, arch, layers)
    trained = {"product_precision": product_precision(torch, card)}
    for arch in TRAIN_ARCHS:
        phase(f"train {arch}")
        trained[arch] = train(torch, rk, arch, card, rasa=arch == TRAIN_RASA)
    print("train: " + json.dumps(trained))
    by_model = {"qwen3-1.7b": results, **families, **reduced}

    bound_by = {phase: max(("bytes", "operations"), key=lambda b: step[b][phase])
                for phase in ("decode", "prefill")}
    kernels = []
    for s in rk.SCHEDULES:
        kernels.append({
            "name": rk.KERNEL_NAMES[s], "route": "cuda", "source": SOURCES["gemm"],
            "replaces": REPLACES[s], "launches": results[s]["launches"][s],
            "launches_note": "the wrapper's count over the main path (the graphed session's "
                             "first generate: one warm-up and one captured forward each of "
                             "prefill and decode; replays never enter the wrapper)",
            "launches_by_model": {
                name: r[s]["launches"][s] if s in r else 0 for name, r in by_model.items()},
            "replayed_launches_per_forward": {
                part: int(results[s]["graphed"]["trace"][part]["gemm_records_per_call"])
                for part in ("prefill", "decode")},
            "train_launches": (trained["qwen3-1.7b"]["rasa"]["launches"] if s == "wls" else 0),
            "train_launches_note": "phase 10: one forward loss of qwen3-1.7b FULL under "
                                   "pallas_rasa, the counts set to 0 just before it",
            "decode_graph": results[s]["decode_graph"],
            "replayed_gemm_busy_ms": {
                part: results[s]["graphed"]["trace"][part]["gemm_busy_ms_per_call"]
                for part in ("prefill", "decode")},
            "max_abs_err": worst[s], "ms": step[s]["decode"],
            "plain_ms": step["plain"]["decode"],
            "bound_ms": step[bound_by["decode"]]["decode"],
            "bound_by": bound_by["decode"], "library_ms": step["library"]["decode"],
            "timer": {"ms": gemm_timers[s], "plain_ms": gemm_timers["plain"],
                      "library_ms": gemm_timers["library"]},
            "work": "one qwen3-1.7b decode step of GEMMs (M=4, bf16)",
            "prefill_ms": step[s]["prefill"], "prefill_plain_ms": step["plain"]["prefill"],
            "prefill_library_ms": step["library"]["prefill"],
            "prefill_bound_ms": step[bound_by["prefill"]]["prefill"],
            "prefill_bound_by": bound_by["prefill"],
            "prefill_work": "one qwen3-1.7b prefill of GEMMs, M=512, head M=4, bf16",
            "prefill_f32_ms": gemm32[s], "prefill_f32_plain_ms": gemm32["plain"],
            "prefill_f32_library_ms": gemm32["library"],
            "prefill_f32_bound_ms": max(gemm32["bytes"], gemm32["operations"]),
            "prefill_f32_work": "one qwen3-1.7b prefill of layer GEMMs in f32, M=512 "
                                "(the SIMT path; none on the serving path)"})
    for key, row, name, work in (
            ("flash", flash, fa.KERNEL_NAMES["flash"],
             "one qwen3-1.7b prefill layer's attention (B=4, 16/8 heads, S=512, D=128, bf16)"),
            ("ssd", ssd, sc.KERNEL_NAMES["ssd"],
             "one mamba2-130m prefill layer's SSD scan (BH=96, S=512, P=64, N=128, f32); "
             "ms_random_inputs: the same shape on phase 4's random inputs")):
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[key],
            "replaces": REPLACES[key], "launches": row["launches"],
            "max_abs_err": max(worst[key], row["max_abs_err"]), "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            **({"ms_random_inputs": row["ms_random_inputs"]}
               if "ms_random_inputs" in row else {}),
            **{field: row[field] for field in ("device_kernels", "by_record_ms")
               if field in row},
            "timer": row["timer"], "work": work})
    next(k for k in kernels if k["name"] == fa.KERNEL_NAMES["flash"]).update({
        "f32_launches": flash["f32_launches"], "f32_device_kernels": flash["f32_device_kernels"],
        "f32_max_abs_err": flash["f32_max_abs_err"], "f32_ms": flash32["ms"],
        "f32_plain_ms": flash32["plain_ms"], "f32_library_ms": flash32["library_ms"],
        "f32_bound_ms": flash32["bound_ms"], "f32_bound_by": flash32["bound_by"],
        "f32_library_kernels": flash32["library_kernels"],
        "f32_work": "ms etc.: phase 4's f32 row at the qwen3-1.7b prefill layer's shape "
                    "(the SIMT kernel); launches: phase 6's 28 layers cast to f32"})
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
