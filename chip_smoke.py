#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU: build, check, time, serve, train,
simulate, batch, launch, dry-run, and run the examples.

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
     ms/step and prefill ms on both (host clock, synchronised; one timed
     generation a session, the eager one counted), the graphed prefill
     logits and tokens equal to the eager ones bit for bit, the wrapper's
     launches counted at capture, the
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
     generation per session, as in phases 5 and 7;
  9. serving qwen2-vl-72b (8 of 80 layers) and grok-1-314b (2 of 64) at
     full width and reduced depth, under wls graphed and eager (bit for
     bit; one timed generation each), with the xla engine's prefill logits
     beside wls's;
 10. training qwen3-1.7b and mamba2-130m at full width and depth (bf16,
     random weights from seed 0, the xla engine, AdamW with f32 moments,
     global batch 8 x 512 in 2 microbatches, remat full, warm-up 2 of 8
     steps), steps 0-3 through TrainLoop, which writes one checkpoint at
     its end into a directory under build/, steps 4-7 through the same
     step function: each step's loss, grad_norm, lr and host-clock
     ms; every parameter's gradient finite and nonzero, the losses finite
     and the last below the first, no step retried; tokens/s and the
     model FLOPs' share of the bf16 peak from the median of steps 1-3
     (before the save), beside the median of steps 4-7 and of the resumed
     steps 5-7; peak device memory; the step-4 checkpoint restored in place
     into a fresh state (bit for bit the state the loop ended with) and
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
 11. the RASA simulator (src/repro_torch/core/): the paper's Table I
     lowered with Algorithm 1's policy and run under the 8 designs through
     the MM-only scan kernel (sweep_workload, backend "cuda", one launch)
     and through the numpy lane, every pair's cycles, WL skips, stall
     cycles and utilization equal, Fig. 5's normalized runtimes printed;
     Fig. 5's FC layers and Fig. 7's batches to 256 at the golden
     fixtures' raw cycles (tests/fixtures/), batch_sweep() to 2048 against
     the numpy lane; the six FC layers under one core's epoch schedule on
     a 4-core chip at ChipConfig's defaults and under its static equal
     share, through sweep_trace and sweep_traces (packed) on the full-stream
     kernel; run_cores over four Table I layers, each with its own schedule
     and tail, results and last_grant equal; every kernel variant against
     its plain version on DLRM-2 and random streams, bit for bit (the
     plain versions on the card from worker processes, beside the numpy
     lane's, while the main process drives the kernels); then each
     kernel's device time on DLRM-2 x 8 designs (beside its plain version
     and the numpy lane) and at its main-path shape, its bound (bytes over
     the HBM rate, fp64 operations over the fp64 peak), its serial chain
     (a packed lane's longest segment; the MM-only kernel's longest lane)
     and ns a step on it, ptxas's
     registers and spill bytes, the main path's launches by path (shares
     in shared or device memory, the exact-division flags), and the host's
     share (lowering, analysis, packing, upload, readback; the end-to-end
     sweeps timed on traces whose analysis is not cached).
     First on its main path, a telemetry run with stage events
     (tests/test_obs.py's skewed DLRM-2/BERT-1 workload under lpt on 4
     RASA-WLBP cores at 32 B/cycle, a "cuda" chip): its ChipTelemetry equal
     to a numpy chip's, segment by segment and bucket by bucket, each
     segment's events bit-equal three ways (the event kernel, its plain
     version on the host's CPU on a worker, the Python copy), and its Perfetto
     trace written under build/ and parsed back.
     ``python3 chip_smoke.py simulate`` runs the build and this phase
     alone, and its last line says so ("phases": ["build", "simulate"]);
 12. the serving batcher (src/repro_torch/serving/simbatch.py over the
     multicore chip model) on a 4-core RASA-WLBP chip at 32 B/cycle, epochs
     of 1024 cycles: the whole-trace arbitration kernel (csrc/jitarb.cu,
     through run_batcher on a "cuda" chip) under fixed@1, occupancy,
     bandwidth and predicted, with demand shares and on a mixed chip (BASE,
     RASA-WLBP, RASA-DMDB-WLS, RASA-WLBP), 50 TRACE_KW requests each
     against the port's numpy client and, on the inputs the main path
     gave the kernel, against its plain version (finish and admit epochs
     and the program's counters bit for bit; the plain versions on the
     host's CPU, one worker process a run at the lowest priority, started
     at the head of the phase); qwen3-1.7b at full width (1 of 28
     layers, ~0.65 M
     instructions a request), 4 and 8 requests, through the kernel, the
     incremental client on "cuda" (occupancy through _Batcher, and
     phase_aware, which the program does not take) and, at 4, the numpy
     client: reports equal where the policy is the same, host-clock
     lowering, planning and settle apart; 2,000 TRACE_KW requests, cold
     and warm, against the numpy client; benchmarks/serving_batch.py's
     arrival-rate sweep (x1, x0.5, x0.25 of 16 requests) as one launch of
     three CTAs, against the numpy client and its plain version; the
     kernel's row: the device time of the 4-request
     full-width settle from its trace (and an untraced rerun's host clock),
     its bound, the latency bound of its dependent chain and ns a step on
     the longest lane, ptxas's registers and spill bytes, the launches by
     path, and the program's rounds and blocks.  Then telemetry with stage
     events on "cuda" (the incremental client): the 50 requests under
     occupancy against the numpy client's telemetry, and the event kernel
     against its plain version (on the card) on that run's replay; full
     width x 4 under occupancy, its report equal to the telemetry-off one;
     the event kernel's row: the device time of that replay, its bound and
     latency bound, ns a step on the longest lane, ptxas's registers and
     spills, and the host seconds of the Python copy on the same segments,
     events compared.
     ``python3 chip_smoke.py batcher`` runs the build and this phase alone
     ("phases": ["build", "batcher"]);
 13. the launchers under a DeviceMesh: a process group of one NCCL rank
     and make_host_mesh()'s (1, 1) mesh; launch.serve's main on
     qwen3-1.7b FULL (wls, bf16, batch 4, prompt 128, 32 greedy steps,
     graphed) against the same weights served outside any mesh: tokens
     bit for bit, each side's decode ms/step and prefill ms, and the RASA
     GEMM records of a replayed decode step and prefill read from a trace
     of each (equal: the kernel ran on the shards, nothing fell back);
     launch.train's main on qwen3-1.7b FULL (FSDP x TP rules, bf16, xla,
     8 x 512 in 2 microbatches, 3 steps, one checkpoint under build/)
     against TrainLoop's step outside any mesh on the same weights and
     batches (no checkpoint):
     losses within 1e-3 (bit-equal printed), each side's step ms;
     mamba2-130m FULL's train state saved without a mesh and restored in
     place onto the mesh, every leaf bit for bit.
     ``python3 chip_smoke.py launch`` runs the build and this phase alone,
     then checks and times the wls kernel at qwen3-1.7b's shapes as
     phases 3-4 do ("phases": ["build", "launch"]).
 14. the dry run (src/repro_torch/launch/dryrun.py): its CLI in
     subprocesses, all at once, on qwen3-1.7b x decode_32k and x train_4k
     and zamba2-2.7b x long_500k (its KV cache split along the sequence),
     each on a fake world of 256 ranks, the (16, 16) mesh: per-device peak
     GiB, FLOPs, bytes, collective bytes, trace seconds, and
     roofline.format_report under H100; then the one-card cross-check:
     phase 10's train step (qwen3-1.7b, xla, 8 x 512 in 2 microbatches)
     and phase 5's xla serving steps (prefill of 4 x 128, decode at a
     cache of 160) dry-run on a fake world of one, against the card's
     measurements at those shapes (phases 10 and 5's; measured here when
     the phase runs alone): the predicted argument bytes equal to the real
     state's (or the phase raises), predicted peak / max_memory_allocated
     and roofline step time / measured step time printed.
     ``python3 chip_smoke.py dryrun`` runs the build and this phase alone
     ("phases": ["build", "dryrun"]);
 15. the examples' twins (examples/torch_*.py) on the card, each a
     subprocess, all at once, at their defaults (the train twin 4 steps):
     any exit other than 0 fails the run.  ``python3 chip_smoke.py
     examples`` runs the build and this phase alone ("phases": ["build",
     "examples"]).
The line before the last is the card line, the one before it the kernels'
JSON summary; the last line is {"ok": true, "device": {...}}.  Without a
CUDA device, or without the repository beside it, it exits non-zero and
prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import re
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


def serve_engines(torch, rk, cfg, model, prompts, names, repeats: int = 1) -> dict:
    """Serve ``prompts`` under each engine of ``names`` through two
    ServeSessions: eager (eager=True) and graphed (the default on the
    card), one each for all the engines (the graphs are keyed by the model's
    config).  Per engine: the eager session's prefill launches (one
    forward); the main path, the graphed session's first generate with the
    counts from 0 just before and read just after (it captures prefill and
    decode, one warm-up forward and one captured forward each, and replays
    them); timed_generation ``repeats`` times on each session, the eager
    session's first counted the same way (prefill logits and tokens must
    equal the first eager run's and generate's bit for bit), serve_trace
    on each (the graphed replays' GEMM records per forward must equal the
    counted launches per forward), and graph_contents of the decode step."""
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
        first_eager = timed_generation(torch, eager, prompts)
        eager_counts = dict(rk.launches)
        eager_tokens = first_eager["tokens"]
        if (tokens.shape != prompt_shape(m, b, STEPS) or tokens.min() < 0
                or tokens.max() >= m.vocab):
            raise AssertionError(f"{m.name} {name}: bad tokens {tuple(tokens.shape)}")
        for what, got, n in (("graphed (warm-up + capture)", counts, 4),
                             ("eager", eager_counts, 1 + STEPS)):
            expect = {sch: n * per_forward[sch] if sch == name else 0 for sch in rk.SCHEDULES}
            if got != expect:
                raise AssertionError(f"{m.name} {name} {what}: launches {got}, expected {expect}")

        runs = {"eager": [first_eager] + [timed_generation(torch, eager, prompts)
                                          for _ in range(repeats - 1)],
                "graphed": [timed_generation(torch, graphed, prompts) for _ in range(repeats)]}
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
               "argument_bytes": serve_argument_bytes(model, graphed, b),
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


def serve(torch, rk, cfg, names, prompt: int, path=None, repeats: int = 1) -> dict:
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
    out = serve(torch, rk, cfg, ("wls", "xla"), PROMPT, path=path)
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
    results = serve_engines(torch, rk, cfg, model, prompts, ("wls",))
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
    TRAIN's first TRAIN_RESUME_AT steps through TrainLoop (one checkpoint,
    at its end, into a directory under build/), the rest through the same
    step function on the same state, every step timed; the losses finite
    and falling, every parameter's gradient present, no step retried.  Then
    the step-TRAIN_RESUME_AT checkpoint restored into a fresh state (seed
    1): equal bit for bit to the state the loop ended with, and steps
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
        argument_bytes = train_argument_bytes(state, data.batch(0))
        n_params = check_gradients(torch, model, data.batch(0))
        print(f"train {m.name}: {n_params} parameters, each with a finite, nonzero gradient")
        torch.cuda.reset_peak_memory_stats()
        first, snap = [], {}
        step = train_steps(torch, build_train_step(model), card, m.name, first)
        # the loop saves once, at its last step (TrainLoop always saves there)
        loop = TrainLoop(step, state, data.batch,
                         LoopConfig(total_steps=TRAIN_RESUME_AT,
                                    checkpoint_every=TRAIN_RESUME_AT,
                                    checkpoint_dir=str(ckpt_dir), log_every=TRAIN["total_steps"]))
        t0 = time.perf_counter()
        loop.run()
        run_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        snap["peak"] = torch.cuda.max_memory_allocated()
        snap["bits"] = state_bits(torch, state)
        for s in range(TRAIN_RESUME_AT, TRAIN["total_steps"]):
            step(state, data.batch(s))
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
    # steps 1..TRAIN_RESUME_AT-1 run in the loop before its save; the later
    # ones after it, and the resumed run's, beside no checkpoint writer
    ms = statistics.median(r["ms"] for r in first[1:TRAIN_RESUME_AT])
    ms_after = statistics.median(r["ms"] for r in first[TRAIN_RESUME_AT:])
    ms_resumed = statistics.median(r["ms"] for r in second[1:])
    flops = model_flops(m, tokens)
    row = {"arch": arch, "step_ms": [r["ms"] for r in first], "median_step_ms": ms,
           "median_step_ms_after_save": ms_after,
           "resumed_step_ms": [r["ms"] for r in second], "median_resumed_step_ms": ms_resumed,
           "tokens_per_s": tokens / ms * 1e3, "losses": losses,
           "grad_norms": [r["grad_norm"] for r in first], "lrs": [r["lr"] for r in first],
           "resumed_losses": again, "resumed_max_rel": rel, "resumed_bit_equal": bit_equal,
           "restored_bit_equal": equal, "restore_s": restore_s,
           "restore_extra_gb": restore_extra_gb, "run_s": run_s,
           "checkpoint_gb_on_disk": ckpt_gb,
           "peak_gb_steps_0_3": snap["peak"] / 1e9, "peak_bytes_steps_0_3": snap["peak"],
           "argument_bytes": argument_bytes, "model_flops": flops,
           "bf16_peak_share": flops / (ms / 1e3) / PEAK_FLOPS["bfloat16"],
           "parameters": m.param_count(), "rasa": rasa_row, "trace": trace, "card": card}
    print(f"train {m.name}: median step {ms:.3f} ms (steps 1-{TRAIN_RESUME_AT - 1}, in the "
          f"loop before its save; step 0 {first[0]['ms']:.3f} ms; steps {TRAIN_RESUME_AT}-"
          f"{TRAIN['total_steps'] - 1} after it {ms_after:.3f} ms; resumed steps "
          f"{TRAIN_RESUME_AT + 1}-{TRAIN['total_steps'] - 1} {ms_resumed:.3f} ms) -> "
          f"{row['tokens_per_s']:.1f} tokens/s; model FLOPs {flops:.4g} a step -> "
          f"{row['bf16_peak_share']:.4f} of the bf16 peak (989 TFLOP/s); peak device memory "
          f"{row['peak_gb_steps_0_3']:.3f} GB (steps 0-3); loop {run_s:.3f} s with its "
          f"checkpoint; restore of step {at} {restore_s:.3f} s (in place, "
          f"{restore_extra_gb:.3f} GB of device memory beyond the state), state bit-equal "
          f"{equal}; "
          f"resumed losses max rel {rel:.3g}, bit-equal {bit_equal} | {card}")
    return row


# --------------------------------------------------------------- simulator

SIM_FC = ("DLRM-1", "DLRM-2", "DLRM-3", "BERT-1", "BERT-2", "BERT-3")
FIG5_LAYERS = ("DLRM-1", "DLRM-2", "BERT-1", "BERT-3")     # tests/test_golden_figures.py:36
FIG7_BATCHES = (1, 2, 4, 8, 16, 32, 64, 128, 256)          # tests/test_golden_figures.py:37
FIG7_DESIGNS = ("BASE", "RASA-DMDB-WLS")
SIM_CORES = ("DLRM-3", "BERT-2", "ResNet50-1", "DLRM-1")   # run_cores' four lanes
SIM_CORE_DESIGN = "RASA-DMDB-WLS"
SIM_PLAIN_LAYER = "DLRM-2"     # 8,448 instructions: each kernel against its plain version
# a 4-core chip at ChipConfig's defaults (src/repro/multicore/chip.py:299-305): 256
# bytes/cycle shared, epochs of 1024 cycles, bursts of 16384 bytes, stores charged
CHIP = dict(cores=4, bw=256.0, epoch=1024.0, burst=16384.0, stores_charged=True)
# epochs at which the chip's other three cores stop drawing; the bucket sweep's core
# draws on: its equal share is 64, then 85.3, then 128 bytes/cycle, then the budget
SWEEP_DRAINS = (300, 600, 900)
# the epochs at which run_cores' four lanes stop drawing: each lane's schedule is its
# equal share while it draws, its tail the budget over the lanes still drawing after
CORE_DRAINS = (1400, 450, 300, 350)
FP64_PEAK = 34e12              # H100 SXM data sheet: fp64 outside the tensor cores
# fp64 latency of one dependent operation: 8 cycles (DADD/DMUL/DFMA, the published
# microbenchmarks of Volta and Ampere) at the H100 SXM's 1,980 MHz boost clock; a
# dependent chain of n operations takes at least n of them (latency_bound_ms)
FP64_DEP_NS = 8 / 1.98
# fp64 operations of csrc/fastsim.cu, counted from the code: per instruction (the issue
# time's division and the branch's adds, maxima and compares; an MM by its WLS path, the
# longest), per bucket grant beyond its walks, per walk step (the floor division, the
# share, the epoch end, the refill)
SCAN_OPS = {"tl": 6, "ts": 6, "mm": 15, "grant": 5, "walk": 16}
MM_SCAN_OPS = 17               # per MM row of fastsim_mm_kernel (WLS path, a free store)
# the dependent fp64 operations of a step's longest chain through the carry: an MM
# under WLS (wl_start's max of three: 2, the hidden compare: 1, weights_ready: 1,
# ff_start's max of three: 2, ff_end: 1, fs_end: 1).  A floor: it leaves out the
# register file, whose path is longer where a row reads the register the row before
# wrote (dr_end's add, set_reg's select, get_reg's fold of up to 7 selects, the
# operand's select, t_ready_ac's two maxima, ff_start's two, ff_end and fs_end: up to
# 16 dependent operations; fastsim_mm_kernel stores and loads the ready-time in
# shared memory instead)
CHAIN_OPS_PER_STEP = 8
PREDICTION_SIM = (
    "fastsim_mm_scan over Table I x 8 designs (72 lanes; the longest, ResNet50-2, 451,584 "
    "MM rows): 20-120 ms of device time, latency-bound (~8 dependent fp64 operations a "
    "row, ~10 cycles each at ~1.7 GHz), far below 1% of its bound's rate; fastsim_scan "
    "over the six FC layers packed (1,017,088 instructions a lane) x 8 designs under the "
    "epoch bucket: 150-900 ms. sweep_workload(Table I, backend='cuda') end to end 2-6 s, "
    "most of it the host's dataflow analysis and packing; the numpy lane 15-40 s for the "
    "same 72 pairs; lowering Table I 15-35 s. The card idles: 72 threads on 9 of 132 SMs.")

PREDICTION_MM = (
    "fastsim_mm_kernel redesigned (its rows through a TMA ring of six doubles a row, "
    "get_reg a select tree, the next row loaded into registers while a row runs, the last "
    "row's result forwarded past the register file): the main path (Table I x 8 designs, "
    "72 lanes; ResNet50-2's 451,584 rows the longest) 25-60 ms against 235.8-236.0, at "
    "55-130 ns a row on the longest lane (before: ~522), 1.7-4x its latency bound of "
    "14.6 ms; DLRM-2 x 8 0.25-0.60 ms against 1.63. Levers, as shares of the time "
    "removed: the ring 55-75% (a row's loads from device memory were the step), the select "
    "tree 0-10%, the prefetch 5-20%, the forwarding 5-25%. fastsim_mm_kernel at most 96 "
    "registers, 0 spill; rows 6 and 8 within the parent's spread.")


PREDICTION_STEP = (
    "the step redesigned (a TMA ring of the instruction stream, exact epoch and issue "
    "products at power-of-two epochs, shares in shared memory, one CTA a packed segment): "
    "row 6's main path (six FC layers packed x 8 designs, epoch bucket) 80-300 ms against "
    "the previous step's 1,280.8, at 150-550 ns a step on its longest chain (DLRM-3's "
    "532,480 steps; before: 1,259 ns a step over the whole packed lane), DLRM-2 x 8 "
    "1.5-4.5 ms against 9.69; row 8's full-width settle (qwen3-1.7b, 1 layer, x 4) "
    "1,500-5,000 ms against 11,810.8, 200-650 ns a step on its longest lane (before: "
    "1,514). Levers: the "
    "exact division 55-75% of the time, the ring 5-15%, the segment split 1.7-1.9x on row "
    "6's main path only; both kernels without spills.")


# the telemetry runs (tests/test_obs.py:52-53): the skewed closed workload under lpt on
# 4 RASA-WLBP cores sharing 32 bytes/cycle (phase 11), and phase 12's traces
TELE_WORKLOAD = ("DLRM-2", "BERT-1", "DLRM-2", "DLRM-2")
TELE_CHIP = dict(n_cores=4, design="RASA-WLBP", bw_bytes_per_cycle=32.0)
PREDICTION_EVENTS = (
    "fastsim_events_kernel (the shared step with a recorder, one CTA a segment, 40 bytes "
    "written a position): phase 12's full-width telemetry replay (qwen3-1.7b, 1 layer, x 4 "
    "under occupancy; the longest lane a prefill segment of ~0.3-0.6 M steps) 100-400 ms "
    "of device time, 250-700 ns a step on the longest lane, 1.5-4x its latency bound, the "
    "row writes hidden behind the chain; the Python replay of the same segments 4-15 s on "
    "the host (2.6 M instructions at 1.5-5 us each, the host loaded by phase 12's "
    "workers); the scan, MM-only and arbitration kernels' SASS unchanged.")
EVENT_FIELDS = ("tl_index", "tl_start", "tl_stall", "tl_bytes", "ts_index", "ts_start",
                "ts_stall", "mm_index", "mm_skip", "mm_wl_start", "mm_ff_start", "mm_ff_end",
                "mm_fs_end", "mm_dr_end")


def require_same_events(what: str, got, want) -> None:
    """Two lists of StreamEvents (or None), bit for bit, column by column."""
    if len(got) != len(want):
        raise RuntimeError(f"{what}: {len(got)} replays against {len(want)}")
    for k, (g, w) in enumerate(zip(got, want)):
        if (g is None) != (w is None):
            raise RuntimeError(f"{what}: segment {k} has events on one side only")
        if g is None:
            continue
        for f in EVENT_FIELDS:
            a, b = getattr(g, f), getattr(w, f)
            if a.dtype != b.dtype or a.shape != b.shape or not (a == b).all():
                raise RuntimeError(f"{what}: segment {k}'s {f} differs")
        if (g.cycles, g.bw_stall, g.wl_skips) != (w.cycles, w.bw_stall, w.wl_skips):
            raise RuntimeError(f"{what}: segment {k}'s totals differ")


def require_same_telemetry(what: str, got, want) -> int:
    """Two ChipTelemetry field for field: every segment field (events bit
    for bit), every bucket, the share and active traces, the marks.
    Returns the number of stage events compared."""
    for f in ("kind", "design", "n_cores", "epoch_cycles", "window", "share_trace",
              "active_trace", "core_weights", "marks"):
        if getattr(got, f) != getattr(want, f):
            raise RuntimeError(f"{what}: the telemetry's {f} differs")
    if (got.attribution.window, [dataclasses.astuple(c) for c in got.attribution.cores]) != \
            (want.attribution.window, [dataclasses.astuple(c) for c in want.attribution.cores]):
        raise RuntimeError(f"{what}: the buckets differ")
    if len(got.segments) != len(want.segments):
        raise RuntimeError(f"{what}: {len(got.segments)} segments against {len(want.segments)}")
    for g, w in zip(got.segments, want.segments):
        for f in dataclasses.fields(w):
            if f.name != "events" and getattr(g, f.name) != getattr(w, f.name):
                raise RuntimeError(f"{what}: segment {w.sid}'s {f.name} differs")
    require_same_events(what, [s.events for s in got.segments],
                        [s.events for s in want.segments])
    return sum(len(s.events) for s in got.segments if s.events is not None)


def replay_calls(calls) -> tuple[list, list, list, list]:
    """The traces, engines, params and kernel events of the replay_many
    calls a run made (chip_smoke's capture), in call order."""
    out: tuple[list, list, list, list] = ([], [], [], [])
    for args, kw, events in calls:
        for part, got in zip(out, (*args[:3], events)):
            part.extend(got)
    return out


def replay_plain(traces, cfgs, params, backend: str, device: str = DEV):
    """The event replay of the given lanes (on a worker process or a
    thread): "torch" its plain version on ``device`` (on the host's CPU
    with one thread), "numpy" the Python copy.  Returns the events and the
    seconds (host clock, synchronised on the card)."""
    import torch
    from repro_torch.obs import record
    card = backend == "torch" and device != "cpu"
    if card:
        torch.cuda.synchronize()
    elif backend == "torch":
        torch.set_num_threads(1)
    t0 = time.perf_counter()
    out = record.replay_many(traces, cfgs, params, backend=backend, device=device)
    if card:
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def events_bound(traces, cfgs, params) -> dict:
    """The event replay's bound over the given lanes: its columns (12 bytes
    a position) and lane tables read once, its event rows (40 bytes a
    position) and results written once, over the HBM rate; each lane's fp64
    operations (SCAN_OPS; a grant for every TL and charged TS of a bucket
    lane; the walk steps this run took, read from a full-stream scan of the
    same lanes) over the fp64 peak; beside it the longest lane's chain."""
    from repro_torch.kernels import fastsim_scan as fsk
    from repro_torch.obs import record
    nbytes, ops = 0.0, 0.0
    for bucket, idxs in record.lane_kinds(params).items():
        args, _ = record.event_inputs(traces, cfgs, params, idxs, DEV)
        out, _ = fsk.fastsim_scan_cuda(*args, bucket=bucket)
        charge = (args[2][:, fsk.LANE_FIELDS.index("charge")] != 0).tolist()
        ops += SCAN_OPS["walk"] * float(out[:, 4].sum())
        for i, ch in zip(idxs, charge):
            t = traces[i]
            ops += (SCAN_OPS["tl"] * t.n_tl + SCAN_OPS["ts"] * t.n_ts + SCAN_OPS["mm"] * t.n_mm
                    + (SCAN_OPS["grant"] * (t.n_tl + (t.n_ts if ch else 0)) if bucket else 0))
        nbytes += sum(a.numel() * a.element_size() for a in args)
        nbytes += 40 * args[0].numel() + 8 * len(fsk.EVENT_OUT_FIELDS) * len(idxs)
    fields = bound_fields(nbytes / HBM_BYTES_PER_S * 1e3, ops / FP64_PEAK * 1e3)
    longest = max(len(t) for t in traces)
    fields.update(serial_chain_ops=CHAIN_OPS_PER_STEP * longest, longest_chain_steps=longest,
                  lane_steps=sum(len(t) for t in traces))
    return fields


def events_kernel_ms(torch, traces, cfgs, params, long: bool = False) -> tuple[float, str]:
    """Device ms of the event kernel's launches (one a load-model kind) on
    the given lanes' inputs: from device_ms's traces (events where none
    held every record), or with ``long`` (a launch of a good part of a
    second) CUDA events around one call after a warm-up."""
    from repro_torch.kernels import fastsim_scan as fsk
    from repro_torch.obs import record
    groups = [(record.event_inputs(traces, cfgs, params, idxs, DEV)[0], bucket)
              for bucket, idxs in record.lane_kinds(params).items()]

    def run():
        return [fsk.fastsim_events_cuda(*a, bucket=b) for a, b in groups]

    if long:
        run()
        torch.cuda.synchronize()
        return event_ms(torch, run, 1), "events"
    return kernel_ms(torch, run, fsk.KERNEL_NAMES["events"], 1)


def sweep_schedule():
    """(shares, tail) of the bucket sweep's core (see SWEEP_DRAINS)."""
    return (tuple(CHIP["bw"] / (1 + sum(d > e for d in SWEEP_DRAINS))
                  for e in range(max(SWEEP_DRAINS))), CHIP["bw"])


def chip_schedule(drains, k: int):
    """(shares, tail) of core k on a CHIP whose cores stop drawing on the
    shared budget at epochs ``drains``: the equal share of the cores still
    drawing in each epoch up to its own drain, then the budget over the
    cores drawing after it."""
    shares = tuple(CHIP["bw"] / sum(d > e for d in drains) for e in range(drains[k]))
    return shares, CHIP["bw"] / max(1, sum(d > drains[k] for d in drains))


def random_trace(core, seed: int, n: int):
    """A compiled random stream: the reference's test stream, from the one
    jax-free copy the tests draw it from (tests/_sim_streams.py), built
    from the port's classes."""
    import importlib.util
    import random
    from repro_torch.core.trace import compile_stream
    spec = importlib.util.spec_from_file_location("_sim_streams",
                                                  ROOT / "tests" / "_sim_streams.py")
    streams = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(streams)
    return compile_stream(streams.random_stream(random.Random(seed), n, core.isa))


def timing_key(r) -> tuple:
    return (r.cycles, r.wl_skips, r.bw_stall_cycles, r.n_mm, r.n_tl, r.n_ts, r.useful_macs)


def require_equal(what: str, got, want) -> None:
    if got != want:
        bad = next(i for i, (g, w) in enumerate(zip(got, want)) if g != w) \
            if len(got) == len(want) else "length"
        raise RuntimeError(f"simulate: {what} differs from the numpy lane (first at {bad})")


def scan_bound(traces, lanes_traces, out, charged: bool, lanes_bytes: int,
               longest: int | None = None) -> dict:
    """The full-stream scan's bound: its columns (12 bytes an instruction),
    lane tables and results read or written once over the HBM rate, and the
    fp64 operations of each lane's trace (SCAN_OPS, the walk steps this run
    took) over the fp64 peak; beside it the serial chain of the longest
    independent chain (``longest`` steps: a packed lane's longest segment;
    by default the longest lane)."""
    n_instr = sum(len(t) for t in traces)
    ops = sum(SCAN_OPS["tl"] * t.n_tl + SCAN_OPS["ts"] * t.n_ts + SCAN_OPS["mm"] * t.n_mm
              + SCAN_OPS["grant"] * (t.n_tl + (t.n_ts if charged else 0))
              for t in lanes_traces) + SCAN_OPS["walk"] * float(out[:, 4].sum())
    fields = bound_fields((12 * n_instr + lanes_bytes) / HBM_BYTES_PER_S * 1e3,
                          ops / FP64_PEAK * 1e3)
    longest = max(len(t) for t in lanes_traces) if longest is None else longest
    fields["serial_chain_ops"] = CHAIN_OPS_PER_STEP * longest
    fields["longest_chain_steps"] = longest
    fields["lane_steps"] = sum(len(t) for t in lanes_traces)
    return fields


def mm_bound(cols) -> dict:
    """The MM-only scan's bound: its rows (a 4-byte code and six doubles)
    and lane tables read once, results written once, over the HBM rate;
    MM_SCAN_OPS per (lane, row) over the fp64 peak; beside it the chain."""
    code, val, lane_f, lane_rows = cols
    steps = lane_rows[:, 1] - lane_rows[:, 0]
    nbytes = code.nbytes + val.nbytes + lane_f.nbytes + lane_rows.nbytes + 16 * len(lane_f)
    fields = bound_fields(nbytes / HBM_BYTES_PER_S * 1e3,
                          MM_SCAN_OPS * float(steps.sum()) / FP64_PEAK * 1e3)
    fields["serial_chain_ops"] = CHAIN_OPS_PER_STEP * int(steps.max())
    fields["longest_chain_steps"] = int(steps.max())
    fields["lane_steps"] = int(steps.sum())
    return fields


def kernel_ms(torch, fn, name: str, reps: int) -> tuple[float, str]:
    """Device ms of one fn() call's ``name`` kernel (its records in
    device_ms's traces), or the call's event time where no trace held
    every record."""
    ms, _, timer, records = device_ms(torch, fn, reps)
    if timer == "profiler":
        ms = sum(v for k, v in records.items() if name in k)
    return ms, timer


def timed_row(ms: float, timer: str, bound: dict) -> dict:
    row = {"ms": ms, "timer": timer, **bound,
           "latency_bound_ms": bound["serial_chain_ops"] * FP64_DEP_NS / 1e6,
           "lane_steps_per_s": bound["lane_steps"] / (ms / 1e3),
           "ns_per_chain_op": ms * 1e6 / bound["serial_chain_ops"]}
    if "longest_chain_steps" in bound:
        row["ns_per_step"] = ms * 1e6 / bound["longest_chain_steps"]
    return row


def ptxas_label(mangled: str) -> str:
    """A kernel's name and bool template arguments from its mangled name,
    e.g. ``fastsim_scan_kernel<true>`` (the mangled name where none
    parses).  The name is the innermost one that parses: digits of the
    namespace's hash can spell a longer length prefix that also ends in
    the kernel's name."""
    found = None
    for i, ch in enumerate(mangled):
        if not ch.isdigit():
            continue
        j = i
        while j < len(mangled) and mangled[j].isdigit():
            j += 1
        n = int(mangled[i:j])
        name = mangled[j:j + n]
        if len(name) == n and name.isidentifier() and name.endswith("kernel"):
            found = (name, j + n)
    if found is None:
        return mangled
    name, end = found
    args = re.match(r"I((?:Lb[01]E)+)E", mangled[end:])
    flags = re.findall(r"Lb([01])E", args.group(1)) if args else []
    return name + (f"<{', '.join('true' if f == '1' else 'false' for f in flags)}>"
                   if flags else "")


def ptxas_summary(report: str) -> dict:
    """Each entry function of an ``-Xptxas -v`` report: its registers,
    stack frame and spill bytes (under its mangled name where two share a
    label)."""
    out, name = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = ptxas_label(m.group(1))
            name = m.group(1) if name in out else name
            out[name] = {}
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name:
            out[name].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                             spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name]["registers"] = int(m.group(1))
    return out


def path_counts(paths, fields) -> dict:
    """A wrapper's launch-path counter as {"field=value ...": launches}."""
    return {" ".join(f"{f}={v}" for f, v in zip(fields, key)): n for key, n in paths.items()}


#: fields of kernels.fastsim_scan.launch_paths' keys, and of kernels.jitarb's
SCAN_PATH_FIELDS = ("chains", "shares", "epoch_pow2", "issue_pow2")
JITARB_PATH_FIELDS = ("shares", "issue_pow2")
#: what ``python3 chip_smoke.py simulate`` runs (its last line names them)
PARTIAL_PHASES = ("build", "simulate")
SIM_WORKERS = 6                # processes of the numpy lane (the card's host has 8 cores)


def sim_worker_init(src: str) -> None:
    sys.path.insert(0, src)


def sim_numpy(specs, designs, params=None, cores: bool = False):
    """The numpy lane on a worker process: lower ``specs`` (ALG1) and run
    every (spec, design) pair under ``params`` (None: the port model), or
    with ``cores`` the specs as the lanes of run_cores (one design, a
    params per lane).  Returns the results' timing keys (run_cores': with
    last_grant), the lowering's and the lane's seconds."""
    from repro_torch.core import DESIGNS, fastsim
    from repro_torch.core.tiling import ALG1_POLICY
    from repro_torch.core.trace import gemm_trace
    t0 = time.perf_counter()
    traces = [gemm_trace(s, ALG1_POLICY) for s in specs]
    t1 = time.perf_counter()
    cfgs = [DESIGNS[d] for d in designs]
    if cores:
        out = [timing_key(r) + (lg,) for r, lg in
               fastsim.run_cores(traces, cfgs[0], params, backend="numpy")]
    else:
        out = [[timing_key(r) for r in fastsim.sweep_trace(t, cfgs, params, backend="numpy")]
               for t in traces]
    return out, t1 - t0, time.perf_counter() - t1


def sim_plain(cols, bucket: bool | None = None, n_seg: int = 0):
    """A kernel's plain version on the card, on a worker process: ``cols``
    the kernel's inputs as numpy (the MM-only scan's when ``bucket`` is
    None).  Returns its outputs as numpy and its ms (host clock,
    synchronised)."""
    import torch
    from repro_torch.kernels import fastsim_scan as fsk
    args = tuple(torch.as_tensor(c, device=DEV) for c in cols)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if bucket is None:
        out, seg = fsk.fastsim_mm_scan_plain(*args), None
    else:
        out, seg = fsk.fastsim_scan_plain(*args, bucket=bucket, n_seg=n_seg)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    return out.cpu().numpy(), (seg.cpu().numpy() if n_seg else None), ms


def simulate_phase(torch, card: str, ptxas: dict) -> list[dict]:
    """Phase 11: the RASA simulator on the card.  Table I x the 8 designs
    through the MM-only kernel (sweep_workload, backend "cuda") against the
    numpy lane, every pair's cycles, wl_skips, stall cycles and utilization
    equal; the golden fixtures (Fig. 5's FC layers, Fig. 7 to batch 256) at
    their raw cycles, and batch_sweep() to 2048 against the numpy lane; the
    six FC layers under a 4-core chip's epoch schedule and its static equal
    share, through sweep_trace and sweep_traces (the packed layout); four
    layers as the lanes of run_cores, each with its own schedule and tail,
    results and last_grant equal.  Every kernel variant against its plain
    version on DLRM-2 and on random streams.  The plain versions (on the
    card) and the numpy lane (each task lowering its own specs) run on
    SIM_WORKERS processes meanwhile.  Then each kernel's device time on
    DLRM-2 and at its main-path shape beside its bound, the plain
    version's time and the numpy lane's."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    import numpy as np
    from repro_torch import core
    from repro_torch.core import fastsim, simulator
    from repro_torch.core.tiling import ALG1_POLICY
    from repro_torch.core.trace import gemm_trace
    from repro_torch.kernels import fastsim_scan as fsk
    from repro_torch.multicore import chip as chip_mod
    from repro_torch.obs import TelemetryConfig, record, timeline, write_trace
    print("prediction (written before the first run of phase 11): " + PREDICTION_SIM)
    print("prediction (written before the redesigned step's first timed run): "
          + PREDICTION_STEP)
    print("prediction (written before the redesigned MM-only kernel's first timed run): "
          + PREDICTION_MM)
    print("prediction (written before the event kernel's first run): " + PREDICTION_EVENTS)
    fixtures = ROOT / "tests" / "fixtures"
    fig5 = json.loads((fixtures / "fig5_runtime.json").read_text())
    fig7 = json.loads((fixtures / "fig7_batch.json").read_text())
    cfgs = list(core.DESIGNS.values())
    names = list(core.DESIGNS)
    report: dict = {"host_s": {}}
    host = report["host_s"]

    def clock(key, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        host[key] = time.perf_counter() - t0
        return out

    def uncached(fn):
        """fn on traces whose dataflow analysis is not cached, as a first
        sweep_workload call meets them: an end-to-end time counts the
        analysis (the lowering, cached, is timed on its own)."""
        def run():
            if fastsim._MM_CACHE is not None:
                fastsim._MM_CACHE.clear()
            return fn()
        return run

    table = list(core.TABLE_I.values())
    full7 = list(core.batch_sweep().values())
    shares, tail = sweep_schedule()
    models = {"epoch": fastsim.StreamModelParams(2, 1, shares, CHIP["epoch"], tail,
                                                 CHIP["burst"], CHIP["stores_charged"]),
              "static": fastsim.StreamModelParams(2, 1, (), math.inf, CHIP["bw"] / CHIP["cores"],
                                                  CHIP["burst"], CHIP["stores_charged"])}
    cparams = [fastsim.StreamModelParams(2, 1, shares_k, CHIP["epoch"], tail_k, CHIP["burst"],
                                         CHIP["stores_charged"])
               for shares_k, tail_k in (chip_schedule(CORE_DRAINS, k)
                                        for k in range(len(SIM_CORES)))]
    pool = ProcessPoolExecutor(SIM_WORKERS, mp_context=multiprocessing.get_context("spawn"),
                               initializer=sim_worker_init, initargs=(str(ROOT / "src"),))
    # one more worker for the telemetry replay's plain version on the host's CPU (~40 k
    # lockstep steps; ~5x faster there than launch-bound on the card), started as soon
    # as the main path's telemetry run gives its inputs
    tele_pool = ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("spawn"),
                                    initializer=sim_worker_init, initargs=(str(ROOT / "src"),))
    with pool, tele_pool:
        t_pool = time.perf_counter()
        fsk.reset_launches()        # ---- the main path: counts from 0 ----
        # 0. telemetry with stage events on a 4-core cuda chip: tests/test_obs.py's
        # skewed workload under lpt, its stage replay one launch of the event kernel;
        # first, so that its replay's plain version (~40 k lockstep steps on the host's
        # CPU, on a worker of its own) starts at once
        tele_chip = chip_mod.ChipConfig(backend="cuda", **TELE_CHIP)
        tele_specs = [core.TABLE_I[k] for k in TELE_WORKLOAD]
        tcfg = TelemetryConfig(enabled=True, stages=True)
        tele: dict = {}
        tele_calls = clock("telemetry_cuda", lambda: capture(
            timeline, "replay_many", lambda: tele.update(cuda=chip_mod.simulate_chip(
                tele_specs, tele_chip, scheduler="lpt", telemetry=tcfg))))
        tele_in = replay_calls(tele_calls)
        tele_plain = tele_pool.submit(replay_plain, *tele_in[:3], "torch", "cpu")
        # 5 (submitted first, checked below). Every kernel variant on DLRM-2
        # and on random streams: its plain version on the card, on a worker
        small = gemm_trace(core.TABLE_I[SIM_PLAIN_LAYER], ALG1_POLICY)
        rand = [random_trace(core, s, 300) for s in range(3)]
        p_port = fastsim.StreamModelParams(2, 1)
        ccfg = core.DESIGNS[SIM_CORE_DESIGN]
        variants = (  # (name, traces, lanes (trace index, design, params), n_seg)
            ("sweep bucket (epoch), DLRM-2", [small],
             [(0, c, models["epoch"]) for c in cfgs], 0),
            ("packed bucket (static), DLRM-2 + random",
             [fastsim._pack_lane([small, rand[0]])[0]],
             [(0, c, models["static"]) for c in cfgs], 2),
            ("sweep port, DLRM-2", [small], [(0, c, p_port) for c in cfgs], 0),
            ("packed port, random + DLRM-2", [fastsim._pack_lane([rand[1], small])[0]],
             [(0, c, p_port) for c in cfgs], 2),
            ("cores bucket (epoch), random", rand,
             [(k, ccfg, cparams[k]) for k in range(len(rand))], 0),
            ("sweep bucket (epoch), random", rand[:1],
             [(0, c, models["epoch"]) for c in cfgs], 0),
            ("packed bucket (epoch), random", [fastsim._pack_lane(rand)[0]],
             [(0, c, models["epoch"]) for c in cfgs], 3))
        checks = []
        for what, trs, lns, n_seg in variants:
            args, bucket = fastsim.scan_inputs(trs, lns, "cpu")
            cols = tuple(a.numpy() for a in args)
            checks.append(("scan", what, cols, bucket, n_seg,
                           pool.submit(sim_plain, cols, bucket, n_seg)))
        for what, trs in (("MM-only, DLRM-2", [small]), ("MM-only, random", rand)):
            cols = fastsim.mm_scan_inputs(trs, cfgs, None)[0]
            checks.append(("mm_scan", what, cols, None, 0, pool.submit(sim_plain, cols)))
        oracle = {  # the numpy lane, on the workers, while the card runs below
            "table_i": [pool.submit(sim_numpy, [s], names) for s in table],
            "batch_sweep": [pool.submit(sim_numpy, [s], FIG7_DESIGNS) for s in full7],
            **{f"fc_{m}": [pool.submit(sim_numpy, [core.TABLE_I[k]], names, p) for k in SIM_FC]
               for m, p in models.items()},
            "cores": [pool.submit(sim_numpy, [core.TABLE_I[k] for k in SIM_CORES],
                                  [SIM_CORE_DESIGN], cparams, True)]}
        traces = clock("lower_table_i",
                       lambda: {s.name: gemm_trace(s, ALG1_POLICY) for s in table})
        clock("lower_batch_sweep", lambda: [gemm_trace(s, ALG1_POLICY) for s in full7])
        report["table_i_instructions"] = {k: len(t) for k, t in traces.items()}
        # (the lowering above launches nothing: the main path goes on)
        # 1. Table I x 8 designs: the MM-only kernel, one launch
        table_cuda = clock("table_i_cuda", uncached(
            lambda: simulator.sweep_workload(table, backend="cuda")))
        # 2. the golden fixtures at their raw cycles, then the batch sweep to 2048
        rows = simulator.sweep_workload([core.TABLE_I[k] for k in FIG5_LAYERS], backend="cuda")
        for layer, r in zip(FIG5_LAYERS, rows):
            for n in names:
                want_f = fig5[f"{layer}/{n}"]
                if (r[n].cycles, r[n].cycles / r["BASE"].cycles) != (want_f["cycles"],
                                                                      want_f["normalized"]):
                    raise RuntimeError(f"simulate: Fig. 5 {layer}/{n} {r[n].cycles} against "
                                       f"the fixture's {want_f['cycles']}")
        rows = simulator.sweep_workload(list(core.batch_sweep(batches=FIG7_BATCHES).values()),
                                        designs=list(FIG7_DESIGNS), backend="cuda")
        for b, r in zip(FIG7_BATCHES, rows):
            dm = r["RASA-DMDB-WLS"].cycles
            if (dm, dm / r["BASE"].cycles) != (fig7[str(b)]["cycles"],
                                               fig7[str(b)]["normalized"]):
                raise RuntimeError(f"simulate: Fig. 7 batch {b}: {dm} against the fixture's "
                                   f"{fig7[str(b)]['cycles']}")
        batch_cuda = clock("batch_sweep_cuda", uncached(lambda: simulator.sweep_workload(
            full7, designs=list(FIG7_DESIGNS), backend="cuda")))
        # 3. the six FC layers under the chip's epoch schedule and its static share
        fc = [traces[k] for k in SIM_FC]
        fc_cuda = {}
        for model, p in models.items():
            fc_cuda[model] = (
                clock(f"fc_{model}_cuda_sweep", lambda: [
                    [timing_key(r) for r in fastsim.sweep_trace(t, cfgs, p, backend="cuda")]
                    for t in fc]),
                clock(f"fc_{model}_cuda_packed", lambda: [
                    [timing_key(r) for r in row]
                    for row in fastsim.sweep_traces(fc, cfgs, p, backend="cuda")]))
        # 4. run_cores: four lanes, each its own schedule and tail
        lanes = [traces[k] for k in SIM_CORES]
        cores_cuda = clock("cores_cuda",
                           lambda: fastsim.run_cores(lanes, ccfg, cparams, backend="cuda"))
        main_launches = dict(fsk.launches)  # ---- the main path ends ----
        main_paths = path_counts(fsk.launch_paths, SCAN_PATH_FIELDS)
        # the analysis alone: the share of table_i_cuda the host's dataflow takes
        clock("analysis_table_i", uncached(
            lambda: [fastsim._mm_analysis(t) for t in traces.values()]))

        # 5. each kernel variant on the card against its plain version's outputs
        dev = torch.device(DEV)
        plain_ms: dict = {}
        worst = {"scan": 0.0, "mm_scan": 0.0}
        for key, what, cols, bucket, n_seg, future in checks:
            args = tuple(torch.as_tensor(c, device=dev) for c in cols)
            if key == "scan":
                out_k, seg_k = fsk.fastsim_scan_cuda(*args, bucket=bucket, n_seg=n_seg)
            else:
                out_k, seg_k = fsk.fastsim_mm_scan_cuda(*args), None
            out_p, seg_p, plain_ms[what] = future.result()
            err = float(np.abs(out_k.cpu().numpy() - out_p).max())
            if n_seg:
                err = max(err, float(np.abs(seg_k.cpu().numpy() - seg_p).max()))
            worst[key] = max(worst[key], err)
            if err:
                raise RuntimeError(f"simulate: {key} {what} differs from its plain version "
                                   f"by {err}")
        print("simulate: each kernel variant equal to its plain version (plain versions on "
              "the card, on worker processes); plain ms " + json.dumps(plain_ms))

        # the numpy lane's results: the main path's comparisons
        numpy = {key: [f.result() for f in futs] for key, futs in oracle.items()}
        tele_plain_events, host["telemetry_plain"] = tele_plain.result()
        host["numpy_pool_wall"] = time.perf_counter() - t_pool
    for key, res in numpy.items():
        host[f"{key}_numpy_lowering"] = sum(r[1] for r in res)
        host[f"{key}_numpy"] = sum(r[2] for r in res)
    # a SimReport's fields of timing_key; utilization from the numpy lane's
    # cycles and useful MACs, as TimingResult.utilization computes it
    keys = ("cycles", "wl_skips", "bw_stall_cycles", "n_mm", "n_tl", "n_ts")
    require_equal("Table I x 8", [[tuple(getattr(r[n], k) for k in keys) + (r[n].utilization,)
                                   for n in names] for r in table_cuda],
                  [[k[:6] + (k[6] / (k[0] * c.peak_macs_per_cycle),) for k, c in zip(r[0][0], cfgs)]
                   for r in numpy["table_i"]])
    require_equal("batch_sweep() to 2048",
                  [[tuple(getattr(r[n], k) for k in keys) for n in FIG7_DESIGNS]
                   for r in batch_cuda], [[k[:6] for k in r[0][0]] for r in numpy["batch_sweep"]])
    for model in models:
        want = [r[0][0] for r in numpy[f"fc_{model}"]]
        require_equal(f"sweep_trace, six FC layers, {model}", fc_cuda[model][0], want)
        require_equal(f"sweep_traces (packed), six FC layers, {model}", fc_cuda[model][1], want)
    require_equal("run_cores, 4 lanes", [timing_key(r) + (lg,) for r, lg in cores_cuda],
                  numpy["cores"][0][0])
    print(f"simulate: main path equal to the numpy lane; launches {main_launches}")
    print("simulate: the main path's fastsim_scan launches by path: " + json.dumps(main_paths))
    ptxas = {key: {k: v for k, v in ptxas.get("fastsim", {}).items()
                   if k.startswith(fsk.KERNEL_NAMES[key])} for key in fsk.KERNEL_NAMES}
    print("simulate: Fig. 5 normalized runtime (Table I, cuda = numpy): " + json.dumps(
        {s.name: {n: r[n].cycles / r["BASE"].cycles for n in names}
         for s, r in zip(table, table_cuda)}))
    report["fig7_to_2048"] = {s.name: r["RASA-DMDB-WLS"].cycles / r["BASE"].cycles
                              for s, r in zip(full7, batch_cuda)}
    report["cores"] = {k: {"cycles": r.cycles, "bw_stall_cycles": r.bw_stall_cycles,
                           "last_grant": lg} for k, (r, lg) in zip(SIM_CORES, cores_cuda)}
    # 0. the telemetry against a numpy chip's, its events three ways, the export
    tele["numpy"] = clock("telemetry_numpy", lambda: chip_mod.simulate_chip(
        tele_specs, dataclasses.replace(tele_chip, backend="numpy"), scheduler="lpt",
        telemetry=tcfg))
    # ChipReport's telemetry field compares by identity: every other field
    if [dataclasses.replace(r, telemetry=None) for r in (tele["cuda"], tele["numpy"])] != \
            [dataclasses.replace(tele["numpy"], telemetry=None)] * 2:
        raise RuntimeError("simulate: the telemetry run's report differs from the numpy chip's")
    n_events = require_same_telemetry("simulate: telemetry, cuda against numpy",
                                      tele["cuda"].telemetry, tele["numpy"].telemetry)
    copy, host["telemetry_python_replay"] = replay_plain(*tele_in[:3], "numpy")
    require_same_events("simulate: the event kernel against the Python copy", tele_in[3], copy)
    require_same_events("simulate: the event kernel against its plain version (host CPU)",
                        tele_in[3], tele_plain_events)
    path = write_trace(tele["cuda"].telemetry, ROOT / "build" / "chip_smoke" / "closed.json")
    doc = json.loads(path.read_text())
    if doc["otherData"]["schema"] != "rasa-trace/1":
        raise RuntimeError("simulate: the written trace is not rasa-trace/1")
    report["telemetry"] = {
        "workload": f"{'/'.join(TELE_WORKLOAD)} under lpt on {TELE_CHIP}",
        "segments": len(tele["cuda"].telemetry.segments), "stage_events": n_events,
        "lane_steps": sum(len(t) for t in tele_in[0]), "replay_calls": len(tele_calls),
        "attribution": tele["cuda"].telemetry.attribution.fractions(),
        "trace_file_bytes": path.stat().st_size, "trace_events": len(doc["traceEvents"]),
        "stage_events_dropped": doc["otherData"].get("stage_events_dropped", 0),
        "plain_on_cpu_s": host["telemetry_plain"]}
    print("simulate: telemetry (stages) on the cuda chip equals the numpy chip's, every "
          "segment's events bit-equal three ways (kernel, plain version on the host's CPU, "
          f"Python copy), {path.relative_to(ROOT)} parsed back: "
          + json.dumps(report["telemetry"]))

    # 6. times: each kernel on DLRM-2 (beside its plain version) and at the main path
    lanes_e = [(0, c, models["epoch"]) for c in cfgs]
    lane_bytes = len(lanes_e) * (len(fsk.LANE_FIELDS) + 4 + 5) * 8

    def scan(a, n_seg=0):
        return fsk.fastsim_scan_cuda(*a, bucket=True, n_seg=n_seg)

    def mm(a):
        return fsk.fastsim_mm_scan_cuda(*a)

    def upload(cols):
        return tuple(torch.as_tensor(c, device=dev) for c in cols)

    def main_ms(fn) -> tuple[float, str]:
        """A main-path kernel runs for a good part of a second: CUDA events
        around one call (after a warm-up) time it."""
        fn()
        torch.cuda.synchronize()
        return event_ms(torch, fn, 1), "events"

    args, _ = fastsim.scan_inputs([small], lanes_e, dev)
    out, _ = scan(args)
    clock("dlrm2_epoch_numpy",
          lambda: fastsim.sweep_trace(small, cfgs, models["epoch"], backend="numpy"))
    rows = {"scan": timed_row(
        *kernel_ms(torch, lambda: scan(args), fsk.KERNEL_NAMES["scan"], 3),
        scan_bound([small], [small] * len(lanes_e), out.cpu().numpy(), True, lane_bytes))}
    rows["scan"].update(plain_ms=plain_ms["sweep bucket (epoch), DLRM-2"],
                        numpy_ms=host["dlrm2_epoch_numpy"] * 1e3)
    # the same lanes under the port model (stores on their port): the
    # bucket's share of the time
    pargs, _ = fastsim.scan_inputs([small], [(0, c, p_port) for c in cfgs], dev)
    rows["scan"]["ms_port_model"] = kernel_ms(
        torch, lambda: fsk.fastsim_scan_cuda(*pargs, bucket=False),
        fsk.KERNEL_NAMES["scan"], 3)[0]
    packed = fastsim._pack_lane(fc)[0]
    args, _ = clock("pack_fc_epoch", lambda: fastsim.scan_inputs([packed], lanes_e, dev))
    out, _ = scan(args, len(fc))
    main = timed_row(*main_ms(lambda: scan(args, len(fc))),
                     scan_bound([packed], [packed] * len(lanes_e), out.cpu().numpy(), True,
                                lane_bytes, longest=max(len(t) for t in fc)))
    main["numpy_ms"] = host["fc_epoch_numpy"] * 1e3
    rows["scan"]["main_path"] = main

    cols, _, _ = fastsim.mm_scan_inputs([small], cfgs, None)
    margs = upload(cols)
    clock("dlrm2_port_numpy", lambda: fastsim.sweep_trace(small, cfgs, None, backend="numpy"))
    rows["mm_scan"] = timed_row(
        *kernel_ms(torch, lambda: mm(margs), fsk.KERNEL_NAMES["mm_scan"], 3), mm_bound(cols))
    rows["mm_scan"].update(plain_ms=plain_ms["MM-only, DLRM-2"],
                           numpy_ms=host["dlrm2_port_numpy"] * 1e3)
    cols, _, _ = clock("pack_table_i",
                       lambda: fastsim.mm_scan_inputs(list(traces.values()), cfgs, None))
    margs = clock("upload_table_i", lambda: upload(cols))
    main = timed_row(*main_ms(lambda: mm(margs)), mm_bound(cols))
    out = mm(margs)
    torch.cuda.synchronize()
    clock("readback_table_i", lambda: out.cpu())
    main["numpy_ms"] = host["table_i_numpy"] * 1e3
    rows["mm_scan"]["main_path"] = main
    report["kernels"] = rows
    print(f"simulate: {json.dumps(report)} | {card}")
    for key in ("scan", "mm_scan"):
        for what, row in ((key, rows[key]), (f"{key} main path", rows[key]["main_path"])):
            print(f"simulate: {what}: {row['ms']:.3f} ms, latency bound "
                  f"{row['latency_bound_ms']:.3f} ms ({row['ms'] / row['latency_bound_ms']:.1f}x)"
                  + (f", {row['ns_per_step']:.1f} ns a step on the longest chain "
                     f"({row['longest_chain_steps']} steps)" if "ns_per_step" in row else "")
                  + f" | {card}")
    works = {"scan": "DLRM-2 (8,448 instructions) x 8 designs, the chip's epoch schedule "
                     "(sweep layout, one launch); main_path: the six FC layers packed "
                     "(1,017,094 instructions a lane) x 8 designs, the same schedule",
             "mm_scan": "DLRM-2's 4,096 MM rows x 8 designs (one launch); main_path: Table "
                        "I x 8 designs, 72 lanes (one launch)"}
    replaces = {"scan": "src/repro/core/fastsim.py:813 (_sim_chunk_fn)",
                "mm_scan": "src/repro/core/fastsim.py:1346 (_jax_mm_fn)"}
    return [{"name": fsk.KERNEL_NAMES[key], "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/fastsim.cu", "replaces": replaces[key],
             "launches": main_launches[key], "max_abs_err": worst[key],
             "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
             "bound_by": row["bound_by"], "library_ms": None,
             "library_note": "none: no PyTorch call computes the scan",
             "numpy_ms": row["numpy_ms"], "timer": row["timer"],
             "serial_chain_ops": row["serial_chain_ops"],
             "latency_bound_ms": row["latency_bound_ms"],
             "ns_per_chain_op": row["ns_per_chain_op"],
             "lane_steps_per_s": row["lane_steps_per_s"], "main_path": row["main_path"],
             "ns_per_step": row["ns_per_step"], "ptxas": ptxas[key],
             **({"paths": main_paths} if key == "scan" else {}),
             **({"ms_port_model": row["ms_port_model"]} if "ms_port_model" in row else {}),
             "work": works[key]} for key, row in rows.items()]


# ------------------------------------------------------------------ batcher

# the serving batcher's chip and trace (benchmarks/online_scaling.py:101-104): four
# RASA-WLBP cores sharing 32 bytes/cycle, epochs of 1024 cycles
BATCH_CHIP = dict(n_cores=4, design="RASA-WLBP", bw_bytes_per_cycle=32.0)
BATCH_MIXED = ("BASE", "RASA-WLBP", "RASA-DMDB-WLS", "RASA-WLBP")
TRACE_KW = dict(seed=0, mean_gap=2, d_model=128, prompt_lens=(16, 32, 64),
                decode_steps=(1, 2), decode_batch=8)
BATCH_POLICIES = ("fixed", "occupancy", "bandwidth", "predicted")
BATCH_VARIANTS = ("demand", "mixed")
# requests of each case, against the numpy client and against the plain version
# (whose one-thread run on the host's CPU grows with them: ~50 s a case at 50)
BATCH_N = 50
# the full-width trace: qwen3-1.7b, 1 of 28 layers, ~0.65 M instructions a request
FULL_ARCH, FULL_LAYERS = "qwen3-1.7b", 1
FULL_KW = dict(seed=0, mean_gap=2, prompt_lens=(32, 64), decode_steps=(1, 2))
FULL_N_NUMPY, FULL_N = 4, 8
SCALE_N = 2000
# the arrival-rate sweep of benchmarks/serving_batch.py:66,81-83
RATE_FACTORS = (1.0, 0.5, 0.25)
SWEEP_KW = dict(seed=3, mean_gap=4, d_model=128, prompt_lens=(16, 32, 64),
                decode_steps=(1, 2), decode_batch=8)
# its requests: 64 in the benchmark, cut so that the plain version's one-thread run
# of the three traces (~0.9 s a request on the host's CPU) ends with the cases'
SWEEP_N = 16
#: what ``python3 chip_smoke.py batcher`` runs (its last line names them)
BATCHER_PHASES = ("build", "batcher")
PREDICTION_BATCH = (
    "jitarb over qwen3-1.7b FULL width (1 of 28 layers, ~0.65 M instructions a request), "
    "4 requests on 4 RASA-WLBP cores under occupancy: 3-12 s of device time in one launch "
    "(a relaxation round re-simulates each in-flight lane's dirty suffix, ~0.65 M steps at "
    "~1.3 us a step as fastsim_scan runs them, 4 lanes on 4 warps of one SM; 2-4 rounds a "
    "start), latency-bound, 1e5-1e6 x its throughput bound; 16 requests 15-60 s. 2,000 "
    "TRACE_KW requests (fixed@1): 0.5-3 s of device time (~1,200 lane steps a request, "
    "~2,000 settles of a few rounds on one SM), host planning 0.5-2 s, the numpy client "
    "15-30 s; the card idles (one CTA on one of 132 SMs).")


def batch_chip(chip_mod, variant: str, backend: str, **kw):
    """A case's chip: demand-weighted shares on BATCH_CHIP, or the mixed chip."""
    if variant == "mixed":
        return chip_mod.ChipConfig(backend=backend, n_cores=None, design=None,
                                   cores=BATCH_MIXED,
                                   bw_bytes_per_cycle=BATCH_CHIP["bw_bytes_per_cycle"], **kw)
    return chip_mod.ChipConfig(backend=backend, share_policy=variant, **BATCH_CHIP, **kw)


def full_requests(n: int):
    from repro_torch.serving.simbatch import model_trace
    from repro_torch.workload import CompileOptions
    return model_trace(FULL_ARCH, n, options=CompileOptions(max_layers=FULL_LAYERS),
                       **FULL_KW)


def batch_numpy(what: str, n: int, policy: str, variant: str | None = None,
                stages: bool = False):
    """The port's numpy client on a worker process: ``what`` names the trace
    (``trace``: TRACE_KW; ``full``: the full-width model trace; ``sweep x<f>``:
    a variant of the rate sweep); ``stages``: with telemetry and its stage
    events.  Returns the BatchReport and its seconds (lowering included)."""
    import dataclasses as dc
    from repro_torch.multicore import chip as chip_mod
    from repro_torch.obs import OFF, TelemetryConfig
    from repro_torch.serving.simbatch import run_batcher, synthetic_trace
    t0 = time.perf_counter()
    if what == "full":
        requests = full_requests(n)
    elif what.startswith("sweep"):
        f = float(what.split("x")[1])
        requests = [dc.replace(r, arrival_epoch=int(r.arrival_epoch * f))
                    for r in synthetic_trace(n, **SWEEP_KW)]
    else:
        requests = synthetic_trace(n, **TRACE_KW)
    chip = batch_chip(chip_mod, variant, "numpy") if variant \
        else chip_mod.ChipConfig(backend="numpy", **BATCH_CHIP)
    rep = run_batcher(requests, chip, policy=policy, batch_size=1,
                      telemetry=TelemetryConfig(enabled=True, stages=True) if stages else OFF)
    return rep, time.perf_counter() - t0


def plain_worker_init(src: str) -> None:
    """A plain-program worker: the repo's sources, the lowest priority (the
    main path and the numpy pool go first)."""
    sim_worker_init(src)
    os.nice(19)


def batch_plain(args, kw):
    """The program's plain version on a worker process, on the host's CPU
    (one thread, no autograd records): its inputs as numpy.  Returns finish,
    adm, stats as numpy and its ms."""
    import torch
    from repro_torch.kernels import jitarb as kj
    torch.set_num_threads(1)
    targs = tuple(torch.as_tensor(a) for a in args)
    t0 = time.perf_counter()
    with torch.inference_mode():
        fin, adm, st = kj.jitarb_plain(*targs, **kw)
    ms = (time.perf_counter() - t0) * 1e3
    return fin.numpy(), adm.numpy(), st.numpy(), ms


def program_ops(traces, lane_blocks: float) -> float:
    """fp64 operations of the steps a settle ran: its lane blocks (64 steps
    each) at the trace table's mix of instructions (SCAN_OPS; every TL and
    charged TS a grant; the walk steps, which depend on the shares, not
    counted)."""
    n = sum(len(t) for t in traces)
    per = sum(SCAN_OPS["tl"] * t.n_tl + SCAN_OPS["ts"] * t.n_ts + SCAN_OPS["mm"] * t.n_mm
              + SCAN_OPS["grant"] * (t.n_tl + t.n_ts) for t in traces) / max(n, 1)
    return lane_blocks * 64 * per


def program_bound(args, stats, traces) -> dict:
    """The whole-trace program's bound: its inputs read once and its outputs
    written once over the HBM rate, and the fp64 operations of the steps this
    run took over the fp64 peak; beside it the latency bound of the dependent
    chain (the longest lane's steps, CHAIN_OPS_PER_STEP dependent operations
    each, FP64_DEP_NS apiece)."""
    nbytes = sum(a.numel() * a.element_size() for a in args)
    nbytes += 2 * 8 * args[8].numel() + 8 * stats.numel()
    lane_blocks = float(stats[:, 4].sum())
    fields = bound_fields(nbytes / HBM_BYTES_PER_S * 1e3,
                          program_ops(traces, lane_blocks) / FP64_PEAK * 1e3)
    chain = CHAIN_OPS_PER_STEP * 64 * float(stats[:, 5].max())
    fields.update(serial_chain_ops=chain, latency_bound_ms=chain * FP64_DEP_NS / 1e6,
                  lane_steps=lane_blocks * 64)
    return fields


def batch_traffic(requests):
    return [(r.arrival_epoch, r.specs) for r in requests]


def batch_cases():
    """Phase 12's (policy, variant) cases, their BATCH_N-request trace and
    the rate sweep's variants."""
    import dataclasses as dc
    from repro_torch.serving.simbatch import synthetic_trace
    cases = [(p, v) for v in BATCH_VARIANTS for p in BATCH_POLICIES]
    base = synthetic_trace(SWEEP_N, **SWEEP_KW)
    variants = [[dc.replace(r, arrival_epoch=int(r.arrival_epoch * f)) for r in base]
                for f in RATE_FACTORS]
    return cases, synthetic_trace(BATCH_N, **TRACE_KW), variants


def start_batch_plain() -> tuple:
    """Phase 12's plain runs: the program's plain version on the main
    path's inputs of the BATCH_N-request cases (as run_batcher plans them on
    a cuda chip) and of the rate sweep's launch, one spawned process a run
    at the lowest priority, on the host's CPU (~0.7 ms an instruction step;
    20-60 s a run at 50 requests).  Returns the pool (leaving
    its ``with`` block terminates it), the inputs by case and the pending
    results."""
    import multiprocessing
    from repro_torch.multicore import chip as chip_mod
    from repro_torch.multicore import jitarb
    cases, trace, variants = batch_cases()
    plain_in = {}
    for p, v in cases:
        plan, why = jitarb.plan_ex(batch_traffic(trace), batch_chip(chip_mod, v, "cuda"),
                                   policy=p)
        if plan is None:
            raise RuntimeError(f"batcher: {p}/{v} outside the program's domain: {why}")
        plain_in[f"{p}/{v}"] = jitarb._inputs([plan])
    sweep_plans = jitarb.plan_many([batch_traffic(v) for v in variants],
                                   chip_mod.ChipConfig(backend="cuda", **BATCH_CHIP))
    if sweep_plans is None:
        raise RuntimeError("batcher: the rate sweep fell outside the domain")
    plain_in["sweep"] = jitarb._inputs(sweep_plans)
    pool = multiprocessing.get_context("spawn").Pool(
        len(plain_in), initializer=plain_worker_init,
        initargs=(str(ROOT / "src"),))
    results = {key: pool.apply_async(batch_plain, (tuple(a.cpu().numpy() for a in args), kw))
               for key, (args, kw) in plain_in.items()}
    return pool, plain_in, results


def batcher_phase(torch, card: str, ptxas: dict) -> list[dict]:
    """Phase 12: the serving batcher's whole-trace program on the card.  The
    kernel against its plain version (on worker processes, on the host's
    CPU) on the main path's inputs of the BATCH_N-request cases and of the
    rate sweep's one launch, and against the port's numpy client
    (BATCH_N requests) under fixed@1, occupancy, bandwidth and predicted,
    with demand shares and on a mixed chip; qwen3-1.7b at full width through
    the kernel, the incremental client on cuda (phase_aware, and occupancy
    through _Batcher) and the numpy client; 2,000 requests cold and warm;
    the rate sweep as one launch of three CTAs.  Then the kernel's row."""
    import dataclasses as dc
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

    import numpy as np
    from repro_torch.core.fastsim import SNAP_STRIDE
    from repro_torch.core.trace import compiled_trace
    from repro_torch.kernels import fastsim_scan as fsk
    from repro_torch.kernels import jitarb as kj
    from repro_torch.multicore import chip as chip_mod
    from repro_torch.multicore import jitarb
    from repro_torch.obs import OFF, TelemetryConfig, timeline
    from repro_torch.serving import simbatch
    from repro_torch.serving.simbatch import (report_from_finishes, run_batcher,
                                              synthetic_trace)
    print("prediction (written before the first run of phase 12): " + PREDICTION_BATCH)
    print("prediction (written before the redesigned step's first timed run): "
          + PREDICTION_STEP)
    print("prediction (written before the event kernel's first run): " + PREDICTION_EVENTS)
    host: dict = {}

    def clock(key, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        host[key] = time.perf_counter() - t0
        print(f"batcher: {key} {host[key]:.3f} s", flush=True)
        return out

    def expect(what, got, want):
        if got != want:
            raise RuntimeError(f"batcher: {what}: the reports differ")

    cuda_chip = chip_mod.ChipConfig(backend="cuda", **BATCH_CHIP)
    np_chip = dc.replace(cuda_chip, backend="numpy")
    cases, trace, variants = batch_cases()
    plain_pool, plain_in, plain_res = start_batch_plain()
    pool = ProcessPoolExecutor(SIM_WORKERS, mp_context=multiprocessing.get_context("spawn"),
                               initializer=sim_worker_init, initargs=(str(ROOT / "src"),))
    replay_thread = ThreadPoolExecutor(1)
    with pool, plain_pool, replay_thread:
        t_pool = time.perf_counter()
        futs = {
            "cases": {(p, v): pool.submit(batch_numpy, "trace", BATCH_N, p, v)
                      for p, v in cases},
            "full": {p: pool.submit(batch_numpy, "full", FULL_N_NUMPY, p)
                     for p in ("occupancy", "phase_aware")},
            "scale": pool.submit(batch_numpy, "trace", SCALE_N, "fixed"),
            "telemetry": pool.submit(batch_numpy, "trace", BATCH_N, "occupancy", None, True),
            "sweep": [pool.submit(batch_numpy, f"sweep x{f}", SWEEP_N, "fixed")
                      for f in RATE_FACTORS]}

        kj.reset_launches()         # ---- the main path: counts from 0 ----
        fsk.reset_launches()
        # 1. the eight cases through the kernel (run_batcher on a cuda chip)
        got_cases = {}
        for p, v in cases:
            got_cases[p, v] = clock(f"case_{p}_{v}", lambda: run_batcher(
                trace, batch_chip(chip_mod, v, "cuda"), policy=p, batch_size=1))
            if got_cases[p, v].jit_gate is not None:
                raise RuntimeError(f"batcher: {p}/{v} fell back ({got_cases[p, v].jit_gate})")
        # 2. full width: lowering, planning and the settle apart
        full4 = clock("full_requests", lambda: full_requests(FULL_N))
        policy0 = cuda_chip.core_specs[0].policy
        clock("full_lowering", lambda: [compiled_trace(
            tuple(dc.replace(s, name="") for s in r.specs), policy0) for r in full4])
        full_stats, full_reports, full_plans, out = {}, {}, {}, {}
        for n in (FULL_N_NUMPY, FULL_N):
            reqs = full4[:n]
            plan, why = clock(f"full{n}_planning", lambda: jitarb.plan_ex(
                batch_traffic(reqs), cuda_chip, policy="occupancy"))
            if plan is None:
                raise RuntimeError(f"batcher: full width outside the domain: {why}")
            st: dict = {}
            if n == FULL_N_NUMPY:
                # the kernel row's time: this settle's device record, from a trace
                # whose warm-up step is one small launch
                t0 = time.perf_counter()
                prof = profiled(torch, lambda: out.update(r=jitarb.finish_admit_times(plan, st)),
                                warm=lambda: torch.zeros(1, device=DEV))
                host[f"full{n}_settle"] = time.perf_counter() - t0
                print(f"batcher: full{n}_settle {host[f'full{n}_settle']:.3f} s (traced)")
                fins, adm = out["r"]
                recs = [(a, b) for k, a, b in device_spans(prof)
                        if kj.KERNEL_NAMES["jitarb"] in k]
            else:
                fins, adm = clock(f"full{n}_settle", lambda: jitarb.finish_admit_times(plan, st))
            full_stats[n], full_plans[n] = st, plan
            kernel_rep = report_from_finishes(reqs, cuda_chip, fins, policy="occupancy",
                                              admit_epochs=adm)
            client_rep = clock(f"full{n}_cuda_client_occupancy", lambda: simbatch._Batcher(
                reqs, cuda_chip, "occupancy", 1, cuda_chip.bw_bytes_per_cycle
                / (2.0 * cuda_chip.n_cores), SNAP_STRIDE, 1, True, OFF).run())
            expect(f"full width x{n}, kernel against the cuda client (occupancy)",
                   kernel_rep, client_rep)
            full_reports[n] = {"occupancy": kernel_rep}
            if n == FULL_N_NUMPY:
                full_reports[n]["phase_aware"] = clock(
                    f"full{n}_cuda_client_phase_aware",
                    lambda: run_batcher(reqs, cuda_chip, policy="phase_aware", batch_size=1))
                if full_reports[n]["phase_aware"].jit_gate != "admission_policy":
                    raise RuntimeError("batcher: phase_aware did not take the client")
        # 3. scale: cold (planning included), then warm, then its parts apart
        scale = synthetic_trace(SCALE_N, **TRACE_KW)
        scale_rep = clock("scale_cold", lambda: run_batcher(scale, cuda_chip, policy="fixed",
                                                            batch_size=1))
        clock("scale_warm", lambda: run_batcher(scale, cuda_chip, policy="fixed",
                                                batch_size=1))
        scale_plan, _ = clock("scale_planning", lambda: jitarb.plan_ex(
            batch_traffic(scale), cuda_chip, policy="fixed"))
        scale_st: dict = {}
        clock("scale_settle", lambda: jitarb.finish_admit_times(scale_plan, scale_st))
        if scale_rep.jit_gate is not None:
            raise RuntimeError(f"batcher: the scale trace fell back ({scale_rep.jit_gate})")
        # 4. the rate sweep: one launch, three CTAs
        plans = clock("sweep_planning", lambda: jitarb.plan_many(
            [batch_traffic(v) for v in variants], cuda_chip))
        if plans is None:
            raise RuntimeError("batcher: the rate sweep fell outside the domain")
        before = kj.launches["jitarb"]
        sweep_fins = clock("sweep_settle", lambda: jitarb.finish_times_many(plans))
        sweep_launches = kj.launches["jitarb"] - before
        # 5. telemetry with stage events (run_batcher takes the incremental client when
        # telemetry is on): BATCH_N requests, then full width x FULL_N_NUMPY, each run's
        # stage replay one launch of the event kernel a load-model kind
        tcfg = TelemetryConfig(enabled=True, stages=True)
        tele: dict = {}
        tele_calls = {
            "trace": clock("telemetry_trace", lambda: capture(
                timeline, "replay_many", lambda: tele.update(trace=run_batcher(
                    trace, cuda_chip, policy="occupancy", batch_size=1, telemetry=tcfg)))),
            "full": clock(f"telemetry_full{FULL_N_NUMPY}", lambda: capture(
                timeline, "replay_many", lambda: tele.update(full=run_batcher(
                    full4[:FULL_N_NUMPY], cuda_chip, policy="occupancy", batch_size=1,
                    telemetry=tcfg))))}
        main_launches = {**kj.launches, **fsk.launches}   # ---- the main path ends ----
        # the Python copy of the full-width replay, the plain yardstick, on a thread
        # while the main process waits for the plain program's workers below
        python_replay = replay_thread.submit(replay_plain,
                                             *replay_calls(tele_calls["full"])[:3], "numpy")
        main_paths = {"jitarb": path_counts(kj.launch_paths, JITARB_PATH_FIELDS),
                      "scan": path_counts(fsk.launch_paths, SCAN_PATH_FIELDS)}
        if sweep_launches != 1:
            raise RuntimeError(f"batcher: the sweep took {sweep_launches} launches")
        for key in ("jitarb", "scan", "mm_scan", "events"):
            if not main_launches[key]:
                raise RuntimeError(f"batcher: the main path never launched {key}")

        # 5. the kernel against its plain version on the main path's inputs
        worst = 0.0
        plain_ms = {}
        kernel_case_ms = {}
        for key, (args, kw) in plain_in.items():
            fin_k, adm_k, st_k = kj.jitarb_cuda(*args, **kw)
            torch.cuda.synchronize()
            kernel_case_ms[key] = event_ms(torch, lambda: kj.jitarb_cuda(*args, **kw), 1)
            t_wait = time.perf_counter()
            fin_p, adm_p, st_p, plain_ms[key] = plain_res[key].get()
            host["plain_wait"] = host.get("plain_wait", 0.0) + time.perf_counter() - t_wait
            err = max(float(np.abs(fin_k.cpu().numpy() - fin_p).max()),
                      float(np.abs(adm_k.cpu().numpy() - adm_p).max()))
            if err or not np.array_equal(st_k.cpu().numpy(), st_p):
                raise RuntimeError(f"batcher: {key}: the kernel differs from its plain "
                                   f"version by {err}")
            worst = max(worst, err)
        print(f"batcher: the kernel equals its plain version on the {len(cases)} cases of "
              f"{BATCH_N} requests and the sweep's {len(RATE_FACTORS)} x {SWEEP_N} (plain on "
              "the host's CPU, on workers); plain ms " + json.dumps(plain_ms)
              + "; kernel ms " + json.dumps(kernel_case_ms))
        # 6. against the numpy client
        numpy_s = {}
        for (p, v), fut in futs["cases"].items():
            want, numpy_s[f"{p}/{v}"] = fut.result()
            expect(f"{p}/{v} x{BATCH_N}, kernel against the numpy client",
                   got_cases[p, v], want)
        for pol, fut in futs["full"].items():
            want, numpy_s[f"full {pol}"] = fut.result()
            expect(f"full width x{FULL_N_NUMPY} {pol}, against the numpy client",
                   full_reports[FULL_N_NUMPY][pol], want)
        want, numpy_s["scale"] = futs["scale"].result()
        expect(f"scale x{SCALE_N}, against the numpy client", scale_rep, want)
        want, numpy_s["telemetry"] = futs["telemetry"].result()
        expect(f"telemetry x{BATCH_N}, against the numpy client", tele["trace"], want)
        tele_events = require_same_telemetry(
            f"batcher: telemetry x{BATCH_N} (occupancy), cuda against the numpy client",
            tele["trace"].telemetry, want.telemetry)
        python_events, host["telemetry_python_replay"] = python_replay.result()
        for f, v, fin, fut in zip(RATE_FACTORS, variants, sweep_fins, futs["sweep"]):
            want, numpy_s[f"sweep x{f}"] = fut.result()
            expect(f"sweep x{f}", report_from_finishes(v, cuda_chip, fin), want)
        host["numpy_pool_wall"] = time.perf_counter() - t_pool
    print("batcher: every kernel report equals the numpy client's and the cuda "
          f"client's; launches {main_launches}; numpy client s " + json.dumps(numpy_s))
    events_row = telemetry_row(torch, card, ptxas, tele, tele_calls, tele_events,
                               full_reports[FULL_N_NUMPY]["occupancy"], main_launches["events"],
                               python_events, host["telemetry_python_replay"])
    print("batcher: the main path's launches by path: " + json.dumps(main_paths))
    ptxas = ptxas.get("jitarb", {})

    # 7. the row: the device time of the main path's full-width settle of
    # FULL_N_NUMPY requests, from its trace (events over a rerun where the
    # trace lost the record)
    args, kw = jitarb._inputs([full_plans[FULL_N_NUMPY]])
    name = kj.KERNEL_NAMES["jitarb"]
    if len(recs) == 1:
        ms, timer = (recs[0][1] - recs[0][0]) / 1e3, "profiler"
    else:
        ms, timer = event_ms(torch, lambda: kj.jitarb_cuda(*args, **kw), 1), "events"
    # the same settle again, untraced: its host clock beside the traced one's
    _, _, st = clock(f"full{FULL_N_NUMPY}_settle_untraced", lambda: kj.jitarb_cuda(*args, **kw))
    traces = [compiled_trace(tuple(dc.replace(s, name="") for s in r.specs), policy0)
              for r in full4[:FULL_N_NUMPY]]
    bound = program_bound(args, st.cpu(), traces)
    longest = 64 * float(st.cpu()[0, 5])
    ns_step = ms * 1e6 / longest
    print(f"batcher: the full-width settle: {ms:.1f} ms, latency bound "
          f"{bound['latency_bound_ms']:.1f} ms ({ms / bound['latency_bound_ms']:.1f}x), "
          f"{ns_step:.1f} ns a step on the longest lane ({longest:.0f} steps) | {card}")
    report_st = {f: float(x) for f, x in zip(kj.STATS_FIELDS, st[0].tolist())}
    fixed_key = f"fixed/{BATCH_VARIANTS[0]}"
    # the program's own counters of the traced settle
    st = st.cpu()
    report = {"host_s": host, "full_stats": full_stats,
              "makespans": {f"full x{n}": r["occupancy"].makespan
                            for n, r in full_reports.items()},
              "scale_makespan": scale_rep.makespan, "traced_stats": report_st, "card": card}
    print(f"batcher: {json.dumps(report)}")
    return [{
        "name": name, "route": "cuda", "source": "src/repro_torch/kernels/csrc/jitarb.cu",
        "replaces": "src/repro/multicore/jitarb.py:462 (program; jit :899, vmap :900-903)",
        "launches": main_launches["jitarb"], "max_abs_err": worst, "ms": ms,
        "timer": timer, "plain_ms": plain_ms[fixed_key],
        "plain_work": f"{fixed_key}, {BATCH_N} requests, the main path's inputs (the plain "
                      "version on the host's CPU, one thread, on a worker process)",
        "kernel_ms_plain_work": kernel_case_ms[fixed_key],
        "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"],
        "latency_bound_ms": bound["latency_bound_ms"],
        "serial_chain_ops": bound["serial_chain_ops"], "lane_steps": bound["lane_steps"],
        "ns_per_step": ns_step, "longest_lane_steps": longest, "ptxas": ptxas,
        "paths": main_paths,
        "library_ms": None, "library_note": "none: no PyTorch call computes the program",
        "rounds": int(st[0, 1]), "blocks": int(st[0, 2]),
        "settle_s": {n: host[f"full{n}_settle"] for n in (FULL_N_NUMPY, FULL_N)},
        "settle_untraced_s": host[f"full{FULL_N_NUMPY}_settle_untraced"],
        "planning_s": {n: host[f"full{n}_planning"] for n in (FULL_N_NUMPY, FULL_N)},
        "lowering_s": host["full_lowering"],
        "scale_s": {k: host[f"scale_{k}"] for k in ("cold", "warm", "planning", "settle")},
        "scale_stats": scale_st,
        "work": f"{FULL_ARCH} FULL width, {FULL_LAYERS} of 28 layers, {FULL_N_NUMPY} requests "
                "(prompts 32/64, 1-2 decode steps) on 4 RASA-WLBP cores at 32 B/cycle, "
                "occupancy, one launch"}, events_row]


def telemetry_row(torch, card: str, ptxas: dict, tele: dict, calls: dict, n_events: int,
                  off_report, launches: int, copy: list, copy_s: float) -> dict:
    """Phase 12's telemetry checks and the event kernel's row: the BATCH_N
    run's replay against its plain version on the card (on the same
    inputs, the kernel's time beside it); the full-width run's report
    against the telemetry-off one, its replay's device time, bound and
    latency bound, and the Python copy's events (``copy``, on the same
    segments, ``copy_s`` host seconds) against the kernel's."""
    from repro_torch.kernels import fastsim_scan as fsk
    if tele["full"] != off_report:
        raise RuntimeError("batcher: the full-width telemetry run's report differs from the "
                           "telemetry-off report")
    small, full = replay_calls(calls["trace"]), replay_calls(calls["full"])
    plain, plain_s = replay_plain(*small[:3], "torch")
    require_same_events("batcher: the event kernel against its plain version (on the card), "
                        f"{BATCH_N} requests", small[3], plain)
    kernel_small_ms, _ = events_kernel_ms(torch, *small[:3])
    ms, timer = events_kernel_ms(torch, *full[:3], long=True)
    row = timed_row(ms, timer, events_bound(*full[:3]))
    require_same_events("batcher: the event kernel against the Python copy, full width",
                        full[3], copy)
    full_events = sum(len(e) for e in full[3])
    print(f"batcher: the full-width replay: {ms:.1f} ms ({timer}), latency bound "
          f"{row['latency_bound_ms']:.1f} ms ({ms / row['latency_bound_ms']:.1f}x), "
          f"{row['ns_per_step']:.1f} ns a step on the longest lane "
          f"({row['longest_chain_steps']} steps); the Python copy {copy_s:.2f} s on the host; "
          f"{len(full[0])} segments, {full_events} events bit-equal | {card}")
    return {
        "name": fsk.KERNEL_NAMES["events"], "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fastsim.cu",
        "replaces": "src/repro/obs/record.py:72 (replay_events, a Python loop)",
        "launches": launches, "max_abs_err": 0.0, "ms": ms, "timer": timer,
        "plain_ms": plain_s * 1e3,
        "plain_work": f"the stage replay of {BATCH_N} TRACE_KW requests under occupancy "
                      f"({len(small[0])} segments, {sum(len(t) for t in small[0])} positions; "
                      "the plain version on the card, host clock)",
        "kernel_ms_plain_work": kernel_small_ms,
        "python_replay_s": copy_s,
        "python_replay_note": "the Python copy of the reference's loop on the same segments "
                              "(host clock, on a thread of the main process while it waits "
                              "for phase 12's plain-program workers), events bit-equal",
        "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
        "latency_bound_ms": row["latency_bound_ms"],
        "serial_chain_ops": row["serial_chain_ops"], "lane_steps": row["lane_steps"],
        "ns_per_step": row["ns_per_step"], "longest_lane_steps": row["longest_chain_steps"],
        "lane_steps_per_s": row["lane_steps_per_s"],
        "ptxas": {k: v for k, v in ptxas.get("fastsim", {}).items()
                  if k.startswith(fsk.KERNEL_NAMES["events"])},
        "library_ms": None, "library_note": "none: no PyTorch call computes the replay",
        "segments": len(full[0]), "stage_events": full_events,
        "stage_events_compared_trace": n_events,
        "work": f"the stage replay of {FULL_ARCH} FULL width ({FULL_LAYERS} of 28 layers) x "
                f"{FULL_N_NUMPY} requests under occupancy on 4 RASA-WLBP cores at 32 B/cycle "
                f"({len(full[0])} segments, one launch a load-model kind)"}


# ------------------------------------------------------------------ launch

LAUNCH_ARCH = "qwen3-1.7b"            # served and trained through the launchers
LAUNCH_RESTORE_ARCH = "mamba2-130m"   # its checkpoint restored onto the mesh
LAUNCH_TRAIN_STEPS = 3
LAUNCH_PHASES = ("build", "launch")
PREDICTION_LAUNCH = (
    "qwen3-1.7b wls through launch.serve on a (1, 1) DeviceMesh: graphed decode "
    "ms/step within 5% of the unmeshed session's (8-10), prefill within 10% (20-35 ms): a "
    "(1, 1) mesh moves no data and the captured graphs hold the same GEMM launches (197 a "
    "decode step), at most a few added copies; tokens bit-equal. launch.train (FSDP x TP "
    "on (1, 1), 8 x 512 in 2 microbatches): DTensor's dispatch on the host adds 50-200 us "
    "to each of ~20,000 ops a step, so a meshed step takes 2-5 s against 1.1-1.4 s "
    "unmeshed; losses bit-equal. mamba2-130m's 1.3 GB state restored onto the mesh in "
    "1-5 s, bit for bit.")


def launch_serve_argv() -> list[str]:
    """Phase 13's serving command line: qwen3-1.7b FULL, batch 4, prompt
    128, 32 greedy steps (the engine comes with the config)."""
    return ["--arch", LAUNCH_ARCH, "--batch", str(BATCH), "--prompt-len", str(PROMPT),
            "--steps", str(STEPS), "--device", DEV]


def launch_train_argv(ckpt_dir: str) -> list[str]:
    """Phase 13's training command line: phase 10's batch (8 x 512; the
    config brings the 2 microbatches), LAUNCH_TRAIN_STEPS steps, one
    checkpoint at the end."""
    return ["--arch", LAUNCH_ARCH, "--steps", str(LAUNCH_TRAIN_STEPS),
            "--global-batch", str(TRAIN["global_batch"]), "--seq-len", str(TRAIN["seq_len"]),
            "--checkpoint-dir", ckpt_dir, "--checkpoint-every", str(LAUNCH_TRAIN_STEPS),
            "--device", DEV]


def compare_losses(meshed: list, plain: list, rtol: float = TRAIN_RTOL) -> dict:
    """The meshed run's losses against the unmeshed one's: the largest
    relative difference (raises above ``rtol``) and whether they are equal."""
    if len(meshed) != len(plain) or not meshed:
        raise AssertionError(f"launch train: {len(meshed)} meshed steps, {len(plain)} plain")
    rel = max(abs(a - b) / abs(b) for a, b in zip(meshed, plain))
    if not rel <= rtol:
        raise AssertionError(f"launch train: meshed losses {meshed} vs {plain}: rel {rel} "
                             f"> {rtol}")
    return {"max_rel": rel, "bit_equal": meshed == plain}


def launch_serve_part(torch, rk, card: str) -> dict:
    """Phase 13, serving: launch.serve's main under the host mesh against
    the same weights served outside any mesh, tokens bit for bit; each
    side's prefill ms and decode ms/step, and the RASA GEMM records of a
    replayed decode step and prefill from a trace of each."""
    from repro_torch.configs import get_config
    from repro_torch.distributed import mesh_context
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import build_model
    from repro_torch.serving import ServeSession
    base = get_config(LAUNCH_ARCH)
    cfg = dataclasses.replace(base, engine=engine_of(base, "wls"))
    per_forward = gemm_launches_per_forward(cfg.model, cfg.engine.block_k)["wls"]
    rk.reset_launches()
    run = launch_serve.main(launch_serve_argv(), cfg=cfg)
    launches = dict(rk.launches)
    if launches["wls"] == 0 or any(launches[s] for s in ("base", "wlbp")):
        raise AssertionError(f"launch serve: RASA launches {launches}")
    prompts = torch.as_tensor(launch_serve.prompts_for(cfg, BATCH, PROMPT), device=DEV)
    with mesh_context(run.mesh, cfg.parallel):
        meshed_trace = serve_trace(torch, run.session, prompts, per_forward)
        dtensors = sum(type(p).__name__ == "DTensor" for p in run.session.model.parameters())
    model = build_model(cfg, device=DEV, seed=0)
    plain = ServeSession(model, max_seq=PROMPT + STEPS + 8, device=DEV)
    tokens, prefill_ms, decode_ms = launch_serve.timed_generate(plain, prompts, STEPS)
    plain_trace = serve_trace(torch, plain, prompts, per_forward)
    equal = torch.equal(run.tokens, tokens)
    if not equal:
        raise AssertionError("launch serve: the meshed tokens differ from the unmeshed ones")
    for part in ("prefill", "decode"):
        got, want = (t[part]["gemm_records_per_call"] for t in (meshed_trace, plain_trace))
        if got != want or got != per_forward:
            raise AssertionError(f"launch serve {part}: {got} RASA GEMM records a call "
                                 f"meshed, {want} unmeshed, {per_forward} expected")
    n_params = sum(1 for _ in model.parameters())
    if dtensors != n_params:
        raise AssertionError(f"launch serve: {dtensors} of {n_params} parameters DTensors")
    for side, trace in (("meshed", meshed_trace), ("unmeshed", plain_trace)):
        print(f"launch serve trace {side}: " + json.dumps(trace))
    row = {"mesh": list(run.mesh.shape), "tokens_bit_equal": equal,
           "launches": launches["wls"], "graphed": run.session.graphed,
           "meshed": {"prefill_ms": run.prefill_ms, "decode_ms": run.decode_ms_per_step,
                      "trace": meshed_trace},
           "unmeshed": {"prefill_ms": prefill_ms, "decode_ms": decode_ms,
                        "trace": plain_trace},
           "gemm_records_per_decode_step": meshed_trace["decode"]["gemm_records_per_call"],
           "card": card}
    print(f"launch serve {LAUNCH_ARCH} wls on mesh {tuple(run.mesh.shape)}: graphed "
          f"{run.session.graphed}; prefill {run.prefill_ms:.3f} ms meshed, {prefill_ms:.3f} "
          f"unmeshed; decode {run.decode_ms_per_step:.3f} ms/step meshed, {decode_ms:.3f} "
          f"unmeshed; RASA GEMM records a decode step {row['gemm_records_per_decode_step']} "
          f"both; tokens bit-equal {equal}; {dtensors} DTensor parameters | {card}")
    del run, model, plain
    torch.cuda.empty_cache()
    return row


def launch_train_part(torch, card: str) -> dict:
    """Phase 13, training: launch.train's main (FSDP x TP under the host
    mesh) against TrainLoop's step on the same config, weights and batches
    outside any mesh (no checkpoint: the launcher's save is the meshed
    side's); losses within TRAIN_RTOL, each side's step ms."""
    import shutil
    import tempfile
    from repro_torch.config import TrainConfig
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.launch import train as launch_train
    from repro_torch.models import build_model
    from repro_torch.training import build_train_step, init_train_state
    base = dataclasses.replace(get_config(LAUNCH_ARCH),
                               train=TrainConfig(microbatches=TRAIN["microbatches"]))
    (ROOT / "build").mkdir(exist_ok=True)
    out = {}
    for side in ("meshed", "unmeshed"):
        ckpt = tempfile.mkdtemp(prefix=f"launch-{side}-", dir=ROOT / "build")
        try:
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            if side == "meshed":
                loop = launch_train.main(launch_train_argv(ckpt), cfg=base)
                params = list(loop.state.params.values())
                if not all(type(p).__name__ == "DTensor" for p in params):
                    raise AssertionError("launch train: a parameter is not a DTensor")
                hist = loop.metrics_history
                del loop, params
            else:
                cfg = launch_train.run_config(
                    base, steps=LAUNCH_TRAIN_STEPS, global_batch=TRAIN["global_batch"],
                    seq_len=TRAIN["seq_len"], lr=3e-4, checkpoint_every=LAUNCH_TRAIN_STEPS,
                    checkpoint_dir=ckpt)
                model = build_model(cfg, device=DEV, seed=cfg.train.seed)
                data = SyntheticLMDataset(cfg.model, seq_len=TRAIN["seq_len"],
                                          global_batch=TRAIN["global_batch"])
                # TrainLoop's steps and timing without its checkpoint: the
                # meshed side's save is the launcher's, this side writes none
                step_fn, state, hist = build_train_step(model), init_train_state(model), []
                for s in range(LAUNCH_TRAIN_STEPS):
                    t1 = time.perf_counter()
                    _, metrics = step_fn(state, data.batch(s))
                    hist.append({"loss": float(metrics["loss"]),
                                 "time_s": time.perf_counter() - t1})
                del model, state, step_fn
            torch.cuda.synchronize()
            out[side] = {"losses": [m["loss"] for m in hist],
                         "step_ms": [m["time_s"] * 1e3 for m in hist],
                         "median_step_ms": statistics.median(m["time_s"] * 1e3
                                                             for m in hist[1:]),
                         "run_s": time.perf_counter() - t0}
        finally:
            shutil.rmtree(ckpt, ignore_errors=True)
        torch.cuda.empty_cache()
    cmp = compare_losses(out["meshed"]["losses"], out["unmeshed"]["losses"])
    row = {**out, "losses": cmp, "card": card}
    print(f"launch train {LAUNCH_ARCH} (8 x 512, 2 microbatches, {LAUNCH_TRAIN_STEPS} steps): "
          f"median step {out['meshed']['median_step_ms']:.3f} ms meshed, "
          f"{out['unmeshed']['median_step_ms']:.3f} unmeshed (steps 1-"
          f"{LAUNCH_TRAIN_STEPS - 1}); losses {out['meshed']['losses']} vs "
          f"{out['unmeshed']['losses']}: max rel {cmp['max_rel']:.3g}, bit-equal "
          f"{cmp['bit_equal']} | {card}")
    return row


def launch_restore_part(torch, card: str) -> dict:
    """Phase 13, restore onto a mesh: mamba2-130m FULL's train state saved
    with no mesh under build/, restored in place into a state distributed
    on the host mesh (a fresh model, seed 1), every leaf bit for bit."""
    import shutil
    import tempfile
    from repro_torch.checkpoint import restore_into, save_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.distributed import mesh_context
    from repro_torch.distributed.sharding import full, map_tree
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model
    from repro_torch.training import init_train_state
    cfg = get_config(LAUNCH_RESTORE_ARCH)
    ckpt = tempfile.mkdtemp(prefix="launch-restore-", dir=ROOT / "build")
    try:
        state = init_train_state(build_model(cfg, device=DEV, seed=0))
        t0 = time.perf_counter()
        save_checkpoint(ckpt, 0, state)
        save_s = time.perf_counter() - t0
        saved = state_bits(torch, state)
        del state
        with mesh_context(make_host_mesh(device=DEV), cfg.parallel):
            fresh = init_train_state(build_model(cfg, device=DEV, seed=1))
            n_dtensors = sum(type(p).__name__ == "DTensor" for p in fresh.params.values())
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            restore_into(ckpt, fresh)
            torch.cuda.synchronize()
            restore_s = time.perf_counter() - t0
            got = state_bits(torch, map_tree(full, fresh))
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    equal = len(got) == len(saved) and all(torch.equal(a, b) for a, b in zip(got, saved))
    if not equal or n_dtensors != len(fresh.params):
        raise AssertionError(f"launch restore: bit-equal {equal}, {n_dtensors} of "
                             f"{len(fresh.params)} parameters DTensors")
    gb, n_leaves = sum(t.numel() for t in saved) / 1e9, len(saved)
    print(f"launch restore {LAUNCH_RESTORE_ARCH}: {n_leaves} leaves ({gb:.3f} GB) saved "
          f"without a mesh in {save_s:.3f} s, restored onto the mesh in {restore_s:.3f} s, "
          f"bit-equal {equal} | {card}")
    del fresh, saved, got
    torch.cuda.empty_cache()
    return {"leaves": n_leaves, "gb": gb, "save_s": save_s,
            "restore_s": restore_s, "bit_equal": equal, "card": card}


def launch_phase(torch, rk, card: str) -> dict:
    """Phase 13: the launchers on the card under a DeviceMesh of the world
    of one NCCL rank (make_host_mesh: (1, 1))."""
    from repro_torch.launch.mesh import init_distributed, make_host_mesh
    print("prediction (written before the first run of phase 13): " + PREDICTION_LAUNCH)
    init_distributed(DEV)
    shape = tuple(make_host_mesh(device=DEV).shape)
    if shape != (1, 1):
        raise AssertionError(f"launch: the host mesh is {shape}, not (1, 1)")
    t0 = time.perf_counter()
    out = {"mesh": list(shape), "serve": launch_serve_part(torch, rk, card),
           "train": launch_train_part(torch, card),
           "restore": launch_restore_part(torch, card)}
    out["phase_s"] = time.perf_counter() - t0
    print("launch: " + json.dumps({k: v for k, v in out.items() if k != "serve"}))
    return out


def launch_kernel_row(torch, rk, launched: dict) -> dict:
    """The RASA GEMM's row of a ``launch`` run: the wls kernel checked
    against its plain version at qwen3-1.7b's shapes (phase 3) and timed
    over one decode step of GEMMs (phase 4), its launches those of phase
    13's served main path."""
    from repro_torch.configs import get_config
    qwen = get_config(LAUNCH_ARCH)
    worst = check_gemm(torch, rk, (qwen,))
    step, timers = time_gemm(torch, rk, qwen)
    bound_by = max(("bytes", "operations"), key=lambda b: step[b]["decode"])
    serve = launched["serve"]
    return {"name": rk.KERNEL_NAMES["wls"], "route": "cuda", "source": SOURCES["gemm"],
            "replaces": REPLACES["wls"], "launches": serve["launches"],
            "launches_note": "launch.serve's main path under the (1, 1) mesh (warm-up and "
                             "capture of prefill and decode; replays never enter the wrapper)",
            "replayed_launches_per_decode_step": {
                side: serve[side]["trace"]["decode"]["gemm_records_per_call"]
                for side in ("meshed", "unmeshed")},
            "max_abs_err": worst["wls"], "ms": step["wls"]["decode"],
            "plain_ms": step["plain"]["decode"], "bound_ms": step[bound_by]["decode"],
            "bound_by": bound_by, "library_ms": step["library"]["decode"],
            "timer": {"ms": timers["wls"], "plain_ms": timers["plain"],
                      "library_ms": timers["library"]},
            "work": "one qwen3-1.7b decode step of GEMMs (M=4, bf16)"}


# ------------------------------------------------------------------ dry run

#: phase 14's production cells: (arch, shape), each a subprocess of the CLI
DRYRUN_CELLS = (("qwen3-1.7b", "decode_32k"), ("qwen3-1.7b", "train_4k"),
                ("zamba2-2.7b", "long_500k"))
DRYRUN_ARCH = "qwen3-1.7b"            # the one-card cross-check: phases 5 and 10's model
DRYRUN_PHASES = ("build", "dryrun")
EXAMPLES_PHASES = ("build", "examples")
PREDICTION_DRYRUN = (
    "the dry run on a fake world of 256 ranks, traced on the card's host: qwen3-1.7b "
    "decode_32k 2-4 GiB/dev (its 481 GB KV cache split 256 ways), bound by memory; "
    "train_4k 1-10 GiB/dev, useful FLOPs 55-80% (the remat's re-forward); zamba2-2.7b "
    "long_500k (its cache split along the sequence) 0.2-1 GiB/dev; each cell traced in "
    "10-150 s. One card, a world of one: predicted argument bytes equal to the state's; "
    "predicted peak / max_memory_allocated 0.8-1.2 for the train step (8 x 512, 2 "
    "microbatches) and 0.5-1.2 for serving; roofline step time / measured step time "
    "0.01-0.10 for the train step (phase 10's FLOP share 0.0384) and 0.1-0.4 for the "
    "graphed xla decode step. Phase 15: the five twins exit 0, 30-120 s together.")

#: the one-card cross-check, run in a process of its own (it starts a fake
#: world of one): phase 10's train step and phase 5's xla serving steps
#: traced by the dry run; its last line is their counts as JSON
DRYRUN_ONE_CARD = """
import dataclasses, json, sys
sys.path.insert(0, "src")
from repro_torch.config import EngineConfig, TrainConfig
from repro_torch.configs import get_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_host_mesh
base = dataclasses.replace(get_config({arch!r}), engine=EngineConfig(kind="xla"))
train = dataclasses.replace(base, train=TrainConfig(**{train!r}))
out = {{}}
with dryrun.fake_world(1):
    mesh = make_host_mesh(device="cuda")
    out["train"] = dryrun.trace(train, "train", {seq}, {global_batch}, mesh, "cuda")
    out["prefill"] = dryrun.trace(base, "prefill", {prompt}, {batch}, mesh, "cuda")
    out["decode"] = dryrun.trace(base, "decode", {max_seq}, {batch}, mesh, "cuda")
print(json.dumps(out))
"""


def start_dryruns(out_dir: Path) -> dict:
    """Phase 14's subprocesses, all started at once: the CLI on each of
    DRYRUN_CELLS (artifacts under ``out_dir``) and the one-card cross-check."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = {}
    for arch, shape in DRYRUN_CELLS:
        procs[(arch, shape)] = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape",
             shape, "--out", str(out_dir), "--force"], cwd=ROOT, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    code = DRYRUN_ONE_CARD.format(arch=DRYRUN_ARCH, train=TRAIN, seq=TRAIN["seq_len"],
                                  global_batch=TRAIN["global_batch"], prompt=PROMPT,
                                  batch=BATCH, max_seq=PROMPT + STEPS)
    procs["one_card"] = subprocess.Popen([sys.executable, "-c", code], cwd=ROOT, env=env,
                                         stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                         text=True)
    return procs


def finish_process(name, proc, timeout: float = 600) -> str:
    """The subprocess's standard output; raises (with its errors' end) if it
    exits with another code than 0."""
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise AssertionError(f"{name}: no end within {timeout} s")
    if proc.returncode != 0:
        raise AssertionError(f"{name}: exit {proc.returncode}\n{out[-3000:]}\n{err[-6000:]}")
    return out


def stop_processes(procs) -> None:
    """Kill and reap every subprocess of ``procs`` still running (a phase
    that fails leaves none behind)."""
    for proc in procs:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


def tensor_bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def train_argument_bytes(state, batch: dict) -> int:
    """The bytes of a train step's arguments: every leaf of the TrainState
    (parameters, AdamW moments, the two step counts) and the batch."""
    from repro_torch.checkpoint.store import flatten_with_names
    return tensor_bytes(t for _, t in flatten_with_names(state)) + sum(
        v.nbytes for v in batch.values())


def serve_argument_bytes(model, session, batch: int) -> int:
    """The bytes of a serving step's arguments: the model's parameters, the
    session's decode state of ``batch`` (stacked caches, lengths, position)
    and its token buffer."""
    state, token = session._slots[batch]
    return (tensor_bytes(model.parameters()) + tensor_bytes((*state.buffers, state.position))
            + tensor_bytes((token,)))


def measure_train_step(torch) -> dict:
    """Phase 14 alone: phase 10's train step (qwen3-1.7b, xla, 8 x 512 in 2
    microbatches) on the card: its arguments' bytes, the median of steps
    1-3 and the peak device memory of steps 0-3 (the state included)."""
    from repro_torch.config import TrainConfig
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.models import build_model
    from repro_torch.training import build_train_step, init_train_state
    cfg = dataclasses.replace(get_config(DRYRUN_ARCH), train=TrainConfig(**TRAIN))
    data = SyntheticLMDataset(cfg.model, seq_len=TRAIN["seq_len"],
                              global_batch=TRAIN["global_batch"], seed=1)
    torch.cuda.empty_cache()
    model = build_model(cfg, device=DEV, seed=0)
    state = init_train_state(model)
    argument = train_argument_bytes(state, data.batch(0))
    step_fn, times = build_train_step(model), []
    torch.cuda.reset_peak_memory_stats()
    for s in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step_fn(state, data.batch(s))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    del model, state, step_fn
    torch.cuda.empty_cache()
    return {"argument_bytes": argument, "step_ms": statistics.median(times[1:]),
            "peak_bytes": peak}


def measure_serve(torch) -> dict:
    """Phase 14 alone: phase 5's qwen3-1.7b xla session on the card (graphed,
    batch 4, prompt 128, 32 steps): its arguments' bytes, decode ms/step
    and the peak device memory of its first generation (the capture)."""
    from repro_torch.configs import get_config
    from repro_torch.serving import ServeSession
    base = get_config(DRYRUN_ARCH)
    cfg = dataclasses.replace(base, engine=engine_of(base, "xla"))
    torch.cuda.empty_cache()
    model, prompts = build_served(torch, cfg, PROMPT)
    session = ServeSession(model, max_seq=PROMPT + STEPS, device=DEV)
    torch.cuda.reset_peak_memory_stats()
    session.generate(prompts, STEPS)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    run = timed_generation(torch, session, prompts)
    argument = serve_argument_bytes(model, session, BATCH)
    del model, session
    torch.cuda.empty_cache()
    return {"argument_bytes": argument, "decode_ms": run["decode_ms"], "peak_bytes": peak}


def dryrun_phase(torch, card: str, train_row: dict | None = None,
                 serve_row: dict | None = None) -> dict:
    """Phase 14: the dry run.  Its CLI on DRYRUN_CELLS (a fake world of 256
    ranks each, in subprocesses), their counts and format_report under
    H100; then the one-card cross-check: phase 10's train step and phase 5's
    xla serving steps dry-run on a fake world of one, against the card's
    measurements at the same shapes (``train_row``, ``serve_row``: phases
    10 and 5's, or measured here when the phase runs alone).  The predicted
    argument bytes must equal the real ones; the peak and roofline ratios
    are printed."""
    import shutil
    from repro_torch.roofline import H100, analyze_all, analyze_cell, format_report
    print("prediction (written before the first run of phase 14): " + PREDICTION_DRYRUN)
    t0 = time.perf_counter()
    if train_row is None:
        train_row = measure_train_step(torch)
    if serve_row is None:
        serve_row = measure_serve(torch)
    out_dir = ROOT / "build" / "dryrun_smoke"
    shutil.rmtree(out_dir, ignore_errors=True)
    t_dry = time.perf_counter()
    procs = start_dryruns(out_dir)
    try:
        outputs = {key: finish_process(f"dryrun {key}", proc) for key, proc in procs.items()}
    finally:
        stop_processes(procs.values())
    dry_s = time.perf_counter() - t_dry
    cells = {}
    for arch, shape in DRYRUN_CELLS:
        r = json.loads((out_dir / f"{arch}__{shape}__pod1.json").read_text())
        colls = {k: v for k, v in r["collectives_per_device_bytes"].items()
                 if not k.endswith("_count")}
        cells[f"{arch}|{shape}"] = {
            "peak_gib": r["memory"]["peak_bytes_per_device"] / 2**30,
            "flops": r["cost_per_device"]["flops"],
            "bytes_accessed": r["cost_per_device"]["bytes_accessed"],
            "collective_bytes": sum(colls.values()), "trace_s": r["lower_s"]}
        print(f"dryrun {arch} x {shape} x 16x16: peak {cells[f'{arch}|{shape}']['peak_gib']:.3f} "
              f"GiB/dev, flops/dev {r['cost_per_device']['flops']:.4g}, bytes/dev "
              f"{r['cost_per_device']['bytes_accessed']:.4g}, collectives/dev "
              f"{json.dumps(r['collectives_per_device_bytes'])}, trace {r['lower_s']} s")
    report = format_report(analyze_all(out_dir), H100)
    print("dryrun roofline (H100: 989 TFLOP/s bf16, 3.35 TB/s HBM, 450 GB/s NVLink a "
          "direction; data sheet, not measured):\n" + report)

    one = json.loads(outputs["one_card"].strip().splitlines()[-1])
    predicted = {
        "train": one["train"], "decode": one["decode"],
        "serve_peak_bytes": max(one[k]["memory"]["peak_bytes_per_device"]
                                for k in ("prefill", "decode"))}
    for name, want in (("train", train_row["argument_bytes"]),
                       ("decode", serve_row["argument_bytes"])):
        got = one[name]["memory"]["argument_bytes_per_device"]
        if got != want:
            raise AssertionError(f"dryrun one card {name}: predicted argument bytes {got}, "
                                 f"the card's state {want}")

    def roofline_s(counts) -> float:
        cell = {"arch": DRYRUN_ARCH, "shape": "train_4k", "devices": 1, **counts}
        return analyze_cell(cell, H100).step_time_s

    ratios = {
        "train_peak": predicted["train"]["memory"]["peak_bytes_per_device"]
        / train_row["peak_bytes"],
        "serve_peak": predicted["serve_peak_bytes"] / serve_row["peak_bytes"],
        "train_roofline_over_measured": roofline_s(one["train"]) / (train_row["step_ms"] / 1e3),
        "decode_roofline_over_measured": roofline_s(one["decode"]) / (serve_row["decode_ms"] / 1e3)}
    print(f"dryrun one card {DRYRUN_ARCH}: argument bytes equal (train "
          f"{train_row['argument_bytes']}, decode {serve_row['argument_bytes']}); train step "
          f"(8 x 512, 2 microbatches): predicted peak "
          f"{predicted['train']['memory']['peak_bytes_per_device'] / 1e9:.3f} GB / measured "
          f"{train_row['peak_bytes'] / 1e9:.3f} GB = {ratios['train_peak']:.4f}; roofline "
          f"{roofline_s(one['train']) * 1e3:.3f} ms / measured {train_row['step_ms']:.3f} ms = "
          f"{ratios['train_roofline_over_measured']:.4f}; xla serving: predicted peak "
          f"{predicted['serve_peak_bytes'] / 1e9:.3f} GB / measured "
          f"{serve_row['peak_bytes'] / 1e9:.3f} GB = {ratios['serve_peak']:.4f}; decode "
          f"roofline {roofline_s(one['decode']) * 1e3:.4f} ms / measured "
          f"{serve_row['decode_ms']:.3f} ms = {ratios['decode_roofline_over_measured']:.4f}; "
          f"traces {one['train']['lower_s']} / {one['prefill']['lower_s']} / "
          f"{one['decode']['lower_s']} s | {card}")
    out = {"cells": cells, "one_card": {"predicted": one, "measured": {
        "train": train_row, "serve": serve_row}, "ratios": ratios},
           "dryrun_s": dry_s, "phase_s": time.perf_counter() - t0, "card": card}
    print(f"dryrun: phase {out['phase_s']:.1f} s, the dry runs {dry_s:.1f} s (concurrent)")
    return out


#: phase 15: each twin and its arguments (the others at their defaults)
EXAMPLES = {"torch_quickstart.py": (), "torch_serve_lm.py": (),
            "torch_train_lm.py": ("--steps", "4"), "torch_chip_design_space.py": (),
            "torch_rasa_design_space.py": ()}


def examples_phase(torch, card: str) -> dict:
    """Phase 15: the five examples' twins on the card, each a subprocess
    (all at once), each at its defaults but the train twin (4 steps, its
    checkpoints under build/); any exit other than 0 fails the phase."""
    import shutil
    import tempfile
    torch.cuda.empty_cache()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    (ROOT / "build").mkdir(exist_ok=True)
    ckpt = tempfile.mkdtemp(prefix="train-lm-", dir=ROOT / "build")
    t0 = time.perf_counter()
    procs = {}
    try:
        for script, args in EXAMPLES.items():
            extra = ("--ckpt", ckpt) if script == "torch_train_lm.py" else ()
            procs[script] = (time.perf_counter(), subprocess.Popen(
                [sys.executable, str(ROOT / "examples" / script), *args, *extra], cwd=ROOT,
                env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        rows = {}
        for script, (started, proc) in procs.items():
            out = finish_process(f"examples {script}", proc)
            rows[script] = {"s": time.perf_counter() - started, "stdout": out}
            print(f"examples {script} ({time.perf_counter() - started:.1f} s):\n"
                  + "\n".join("  " + line for line in out.strip().splitlines()[-12:]))
    finally:
        stop_processes(proc for _, proc in procs.values())
        shutil.rmtree(ckpt, ignore_errors=True)
    phase_s = time.perf_counter() - t0
    print(f"examples: {len(rows)} twins exited 0 on the card in {phase_s:.1f} s | {card}")
    return {"scripts": {k: v["s"] for k, v in rows.items()}, "phase_s": phase_s, "card": card}


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
    # each kernel's registers, stack and spill bytes from ptxas (the rows of
    # phases 11 and 12 carry their kernels'); empty where nothing was built
    ptxas = {name: ptxas_summary(report) for name, report in _build.reports.items()}
    for name, summary in ptxas.items():
        print(f"build report {name}.cu (-Xptxas -v): {json.dumps(summary)}")

    phase = lambda name: print(f"phase {name} at {time.perf_counter() - t_start:.1f} s")
    if sys.argv[1:] == ["simulate"]:          # the build and phase 11 alone
        phase("simulate")
        kernels = simulate_phase(torch, card, ptxas)
        return finish(torch, t_start, kernels, card, kind, phases=PARTIAL_PHASES)
    if sys.argv[1:] == ["batcher"]:           # the build and phase 12 alone
        phase("batcher")
        kernels = batcher_phase(torch, card, ptxas)
        return finish(torch, t_start, kernels, card, kind, phases=BATCHER_PHASES)
    if sys.argv[1:] == ["launch"]:            # the build and phase 13 alone
        phase("launch")
        launched = launch_phase(torch, rk, card)
        return finish(torch, t_start, [launch_kernel_row(torch, rk, launched)], card, kind,
                      phases=LAUNCH_PHASES)
    if sys.argv[1:] == ["dryrun"]:            # the build and phase 14 alone
        phase("dryrun")
        print("dryrun: " + json.dumps(dryrun_phase(torch, card)))
        return finish(torch, t_start, [], card, kind, phases=DRYRUN_PHASES)
    if sys.argv[1:] == ["examples"]:          # the build and phase 15 alone
        phase("examples")
        print("examples: " + json.dumps(examples_phase(torch, card)))
        return finish(torch, t_start, [], card, kind, phases=EXAMPLES_PHASES)
    qwen, mamba, zamba = (get_config(a) for a in ("qwen3-1.7b", "mamba2-130m",
                                                  "zamba2-2.7b"))
    print("prediction (written before the first run of the graphed session): " + PREDICTION)
    print("prediction (written before the first run of phases 8 and 9): " + PREDICTION_FAMILIES)
    print("prediction (written before the first run of phase 10): " + PREDICTION_TRAIN)
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
    phase("simulate")
    simulated = simulate_phase(torch, card, ptxas)
    phase("batcher")
    batched = batcher_phase(torch, card, ptxas)
    phase("launch")
    launched = launch_phase(torch, rk, card)
    phase("dryrun")
    qwen_train = trained[DRYRUN_ARCH]
    dried = dryrun_phase(
        torch, card,
        train_row={"argument_bytes": qwen_train["argument_bytes"],
                   "step_ms": qwen_train["median_step_ms"],
                   "peak_bytes": qwen_train["peak_bytes_steps_0_3"]},
        serve_row={"argument_bytes": results["xla"]["argument_bytes"],
                   "decode_ms": results["xla"]["graphed"]["decode_ms_per_step"],
                   "peak_bytes": results["xla"]["max_memory_bytes"]})
    print("dryrun: " + json.dumps(dried))
    phase("examples")
    print("examples: " + json.dumps(examples_phase(torch, card)))
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
            "launch_launches": launched["serve"]["launches"] if s == "wls" else 0,
            "launch_launches_note": "phase 13: launch.serve's main path under the (1, 1) "
                                    "DeviceMesh, the counts set to 0 just before it",
            "launch_replayed_launches_per_decode_step": {
                side: (launched["serve"][side]["trace"]["decode"]["gemm_records_per_call"]
                       if s == "wls" else 0) for side in ("meshed", "unmeshed")},
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
    return finish(torch, t_start, kernels + simulated + batched, card, kind)


def finish(torch, t_start: float, kernels: list, card: str, kind: str,
           phases: tuple | None = None) -> int:
    """The last three lines: the kernels' summary, the card, the result.
    A partial run names the phases it ran in both JSON lines."""
    partial = {} if phases is None else {"phases": list(phases)}
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels, **partial}))
    print(card)
    print(json.dumps(result_line(kind, torch.cuda.device_count(), phases)))
    return 0


def result_line(kind: str, count: int, phases: tuple | None = None) -> dict:
    """The last line: a full run's result, or a partial run's with the
    phases it ran (and none of the others)."""
    line = {"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}
    if phases is not None:
        line["phases"] = list(phases)
    return line


if __name__ == "__main__":
    sys.exit(main())
