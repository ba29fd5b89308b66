"""The serving driver: one client, closed loop, through the port's
``ServeSession`` (CUDA graphs of prefill and decode on the card).

Each request is a static batch of prompts of one length.  The client
sends the prompts, takes the first token to the host (the time to first
token), then calls ``decode_step`` with each greedy token until the
request's output length, and takes the tokens to the host at its end.
The window sends requests while it is open, each whole; it closes when
the last one ends, and every rate is over that time.  The served tokens
of a sample drawn from the seed are then checked against the
configuration's plain reference.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from .. import counts, harness, traffic, weights
from ..tracing import LEAD, Spans, is_gemm, profile


def prefill_call(batch: int, prompt_len: int) -> tuple[str, dict]:
    """A prefill's span: its engine rows, head rows and prompt tokens."""
    return "prefill", {"rows": batch * prompt_len, "head_rows": batch,
                       "tokens": batch * prompt_len}


def decode_call(batch: int) -> tuple[str, dict]:
    return "decode_step", {"rows": batch, "head_rows": batch}


def serve_request(session, req, prompts, spans: Spans) -> tuple[np.ndarray, float]:
    """Serve one request: (the served tokens [B, out_len] on the host, the
    seconds from the request's start to its first token on the host)."""
    t0 = time.perf_counter()
    with spans.span(*prefill_call(req.batch, req.prompt_len)):
        logits = session.prefill(prompts)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    out = torch.empty((req.batch, req.out_len), dtype=torch.int32, device=prompts.device)
    out[:, 0] = tok
    tok.cpu()
    ttft = time.perf_counter() - t0
    for j in range(1, req.out_len):
        with spans.span(*decode_call(req.batch)):
            logits = session.decode_step(tok)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        out[:, j] = tok
    return out.cpu().numpy(), ttft


def build(ctx: harness.Context):
    """(params, model, session) of the cell, the kernels loaded."""
    from repro_torch.models import model_of
    from repro_torch.serving import ServeSession
    cfg = harness.port_config(ctx.cell.config, "serve", ctx.model)
    if ctx.device.type == "cuda" and cfg.engine.kind == "pallas_rasa":
        from repro_torch.kernels import _build
        _build.load("rasa_gemm")
    params = weights.draw(ctx.spec, ctx.seed, ctx.device)
    model = model_of(cfg, params)
    return params, model, ServeSession(model, max_seq=ctx.cell.traffic["max_seq"],
                                       device=ctx.device)


def warm_up(session, mix: dict, device) -> None:
    """Capture (and run once) each prompt length's prefill and the decode
    step at the mix's batch: every shape the window uses."""
    b = mix["batch"]
    for s in sorted({p for p, _ in traffic.cycle(mix)}):
        logits = session.prefill(torch.zeros((b, s), dtype=torch.int32, device=device))
        session.decode_step(torch.argmax(logits, dim=-1).to(torch.int32))
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def window(ctx: harness.Context, session, spans: Spans) -> tuple[list, float]:
    """Requests until ``ctx.seconds`` have passed (with ``until_longest``,
    also until the mix's longest request is done): [(request, served
    tokens, ttft s, request s)], and the window's seconds."""
    mix, vocab = ctx.cell.traffic, ctx.spec["vocab"]
    longest = traffic.longest(mix)
    done, t0 = [], time.perf_counter()
    for req in traffic.requests(mix, ctx.seed):
        if time.perf_counter() - t0 >= ctx.seconds and not (
                ctx.until_longest and not any((r.prompt_len, r.out_len) == longest
                                              for r, *_ in done)):
            break
        t1 = time.perf_counter()
        prompts = traffic.prompt(req, vocab, ctx.seed, ctx.device)
        served, ttft = serve_request(session, req, prompts, spans)
        done.append((req, served, ttft, time.perf_counter() - t1))
    return done, time.perf_counter() - t0


def traced_segment(ctx: harness.Context, session) -> tuple[dict, list]:
    """The trace of the mix's ``trace`` plan, after a warm-up request of its
    first prompt length: with ``prefill``, a request of each prompt length
    (at most ``decode_steps`` decode steps each); without, ``decode_steps``
    decode steps that continue the warm-up request, so that the segment is
    made of the steps that take most of such a window.  Either begins with
    one lead decode step of the warm-up request, outside the traced window.
    Returns (the reduced trace, the calls in order)."""
    mix, vocab = ctx.cell.traffic, ctx.spec["vocab"]
    plan, b = mix["trace"], mix["batch"]
    steps = plan["decode_steps"]
    reqs = [traffic.Request(-1 - i, b, p, steps + 1) for i, p in enumerate(plan["prompt_lens"])]
    prompts = [traffic.prompt(r, vocab, ctx.seed, ctx.device) for r in reqs]
    decode = decode_call(b)
    last = {}

    def warm():
        served, _ = serve_request(session, traffic.Request(-1, b, reqs[0].prompt_len, 2),
                                  prompts[0], Spans(False))
        last["tok"] = torch.as_tensor(served[:, -1], device=ctx.device)

    spans = Spans(True)

    def lead():
        with spans.span(LEAD):
            logits = session.decode_step(last["tok"])
        return torch.argmax(logits, dim=-1).to(torch.int32)

    if plan["prefill"]:
        calls = []
        for r in reqs:
            calls += [prefill_call(b, r.prompt_len)] + [decode] * steps

        def work():
            lead()
            for r, p in zip(reqs, prompts):
                serve_request(session, r, p, spans)
    else:
        calls = [decode] * steps

        def work():
            tok = lead()
            for _ in range(steps):
                with spans.span(*decode):
                    logits = session.decode_step(tok)
                tok = torch.argmax(logits, dim=-1).to(torch.int32)

    want = counts.engine_calls(ctx.spec)

    def complete(record):
        """Every call traced, each with all of its GEMM records."""
        per_span = {}
        for r in record["records"]:
            if r["span"] is not None and is_gemm(r["name"]):
                per_span[r["span"]] = per_span.get(r["span"], 0) + 1
        return ([s["kind"] for s in record["spans"]] == [k for k, _ in calls]
                and all(per_span.get(i, 0) == want for i in range(len(calls))))

    return profile(work, warm, ctx.trace_path, complete), calls


def check(ctx: harness.Context, params: dict, done: list,
          control: bool = False) -> tuple[dict, dict]:
    """The served tokens of a sample of the finished requests against the
    reference: the widest gap by which a served token's logit lies below
    the reference's best, and the mean gap, each compared where the cell's
    limits name it.  Returns ({name: (value, limit)}, details).
    ``control`` also reads the control: the reference in fp8 in the
    program's place, teacher-forced on the same tokens, its first choice
    at each position read against the reference (``control_max_gap``)."""
    ref_mod = harness.reference(ctx.cell.config)
    mix, vocab = ctx.cell.traffic, ctx.spec["vocab"]
    rng = np.random.default_rng(weights.sub_seed(ctx.seed, traffic.SAMPLE_STREAM))
    lengths = [r.prompt_len + r.out_len for r, *_ in done]
    top = [i for i, n in enumerate(lengths) if n == max(lengths)]
    first = int(rng.choice(top))
    if ref_mod.STEP_BY_STEP:
        # whole requests, since the MoE's groups couple a call's rows: the
        # longest, and one of each other prompt length, so that every
        # prefill graph and the decode steps after it are compared
        picks = {first: list(range(done[first][0].batch))}
        for s in sorted({r.prompt_len for r, *_ in done} - {done[first][0].prompt_len}):
            i = int(rng.choice([i for i, (r, *_) in enumerate(done) if r.prompt_len == s]))
            picks[i] = list(range(done[i][0].batch))
    else:
        pairs = [(i, r) for i in range(len(done)) for r in range(done[i][0].batch)]
        chosen = [(first, int(rng.integers(done[first][0].batch)))]
        rest = [p for p in pairs if p != chosen[0]]
        want = min(mix["sample_rows"] - 1, len(rest))
        chosen += [rest[j] for j in rng.choice(len(rest), size=want, replace=False)]
        picks = {}
        for i, r in chosen:
            picks.setdefault(i, []).append(r)
    ref = ref_mod.Reference(ctx.spec, params)
    low = ref_mod.Reference(ctx.spec, params, quant="fp8") if control else None
    gaps, low_gaps = [], []
    for i, rows in sorted(picks.items()):
        req, served, *_ = done[i]
        prompts = traffic.prompt(req, vocab, ctx.seed, ctx.device)[rows]
        toks = torch.as_tensor(served[rows], device=ctx.device)
        logits = ref_mod.served_logits(ref, prompts, toks, ref_mod.STEP_BY_STEP)
        gaps.append(ref_mod.token_gaps(logits, toks).flatten())
        if low is not None:
            first = ref_mod.served_logits(low, prompts, toks, ref_mod.STEP_BY_STEP).argmax(-1)
            low_gaps.append(ref_mod.token_gaps(logits, first).flatten())
        del logits
    found = gap_stats(torch.cat(gaps))
    details = {"tokens_compared": int(torch.cat(gaps).numel()), "requests": len(picks),
               **found}
    if low is not None:
        details.update({f"control_{k}": v for k, v in gap_stats(torch.cat(low_gaps)).items()})
    limits = ctx.cell.limits
    return {k: (v, limits[k]) for k, v in found.items() if k in limits}, details


def gap_stats(gaps: torch.Tensor) -> dict[str, float]:
    """The widest gap, the mean gap, and the share of tokens off the best."""
    return {"max_gap": float(gaps.max()), "mean_gap": float(gaps.mean()),
            "share_off_best": float((gaps > 0).float().mean())}


def run(ctx: harness.Context) -> harness.Outcome:
    mix = ctx.cell.traffic
    on_card = ctx.device.type == "cuda"
    params, model, session = build(ctx)
    warm_up(session, mix, ctx.device)
    setup_s = time.time() - ctx.t_start
    spans = Spans(ctx.trace and on_card)
    done, seconds = window(ctx, session, spans)
    record = {"spec": ctx.spec, "spans": spans.resolve() if spans.enabled else {}}
    if ctx.trace and on_card:
        record["trace"], record["calls"] = traced_segment(ctx, session)
    peak = torch.cuda.max_memory_allocated(ctx.device) if on_card else 0
    gen = sum(r.batch * r.out_len for r, *_ in done)
    prompt_tokens = sum(r.batch * r.prompt_len for r, *_ in done)
    flops = sum(counts.generation_flops(ctx.spec, r.batch, r.prompt_len, r.out_len)
                for r, *_ in done)
    ttft = [d[2] for d in done]
    record["window"] = {"seconds": seconds, "flops": flops, "requests": len(done),
                        "gen_tokens": gen, "prompt_tokens": prompt_tokens}
    e2e = {"setup_s": setup_s, "gen_tokens_per_s": gen / seconds,
           "prompt_tokens_per_s": prompt_tokens / seconds,
           "ttft_ms_p95": float(np.percentile(ttft, 95)) * 1e3}
    del session, model
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    checks, details = check(ctx, params, done)
    details["request_s"] = [[r.prompt_len, r.out_len, round(d, 4)] for r, _, _, d in done]
    return harness.Outcome(e2e, record, attempted=sum(r.batch for r, *_ in done),
                           failed=0, checks=checks,
                           memory_peak=peak, extra=details)


def calibrate(ctx: harness.Context, control: bool) -> dict:
    """One seed's readings for the limits: the check a run makes after a
    short window, and with ``control`` the control's reading beside it."""
    params, model, session = build(ctx)
    warm_up(session, ctx.cell.traffic, ctx.device)
    done, seconds = window(ctx, session, Spans(False))
    del session, model
    gc.collect()
    torch.cuda.empty_cache()
    _, details = check(ctx, params, done, control=control)
    return {"window_s": seconds, "requests": len(done), **details}
