"""The training driver: the port's train step (``training.step``) on its
own state, fed from the seed.

Set-up builds one object, the step with its model and AdamW state, and
drives it through the mix's first ``checked_steps`` steps with the
window's own call and feed (each step's batch drawn on the host and copied
to the device, as an input pipeline does); the window then continues the
same object for ``--seconds``, each step whole.  Once the window has
closed and the program's state is freed, the reference follows the first
steps from the same weights and batches in fp32, and the two are compared:
each step's loss, each leaf's first gradient as the optimizer took it,
and each leaf's change over the checked steps.
"""

from __future__ import annotations

import dataclasses
import gc
import statistics
import time

import torch

from .. import counts, harness, traffic, weights
from ..reference.common import flat_leaves
from ..tracing import Spans, profile


def build(ctx: harness.Context):
    """(model, state, step) of the cell."""
    from repro_torch.models import model_of
    from repro_torch.training import build_train_step, init_train_state
    mix = ctx.cell.traffic
    cfg = harness.port_config(ctx.cell.config, "train", ctx.model)
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, global_batch=mix["rows"], seq_len=mix["seq_len"]))
    model = model_of(cfg, weights.draw(ctx.spec, ctx.seed, ctx.device))
    state = init_train_state(model)
    return model, state, build_train_step(model)


def feed(ctx: harness.Context, step: int) -> dict:
    """Step ``step``'s batch, drawn on the host and copied to the device."""
    host = traffic.train_batch(ctx.cell.traffic, ctx.spec["vocab"], ctx.seed, step)
    return {k: torch.from_numpy(v).to(ctx.device) for k, v in host.items()}


def leaf_norms(tensors: dict, scale: float = 1.0) -> dict[str, float]:
    return {n: torch.linalg.vector_norm(t.detach().float()).item() * scale
            for n, t in tensors.items()}


def checked_steps(ctx: harness.Context, state, step_fn, spans: Spans) -> dict:
    """The first steps, through the window's call and feed: each step's
    loss, the first gradient's norm by leaf as the optimizer took it
    (its first moment after one step over 1 - b1), and each leaf's change
    over the steps, as the next step finds them."""
    b1 = harness.port_config(ctx.cell.config, "train", ctx.model).train.b1
    losses, first = [], None
    for k in range(ctx.cell.traffic["checked_steps"]):
        with spans.span("train_step"):
            state, metrics = step_fn(state, feed(ctx, k))
        losses.append(metrics["loss"].item())
        if first is None:
            first = leaf_norms(state.opt.m, 1 / (1 - b1))
            first_vec = {n: (m / (1 - b1)).to("cpu") for n, m in state.opt.m.items()}
    start = flat_leaves(weights.draw(ctx.spec, ctx.seed, ctx.device))
    with torch.no_grad():
        change = {n: torch.linalg.vector_norm(p.float() - start[n].float()).item()
                  for n, p in state.params.items()}
    del start
    return {"losses": losses, "first_grad": first, "change": change, "first_vec": first_vec}


def gaps(prog: dict, ref: dict) -> dict[str, float]:
    """The numbers compared: the widest relative gap of a step's loss; by
    the worst leaf, the gap between the program's norm and the reference's,
    over the larger of the reference's norm of that leaf and of the median
    leaf, for the first gradient and for the change (leaves whose reference
    gradient is under a thousandth of the median leaf's left out of the
    change: Adam moves them by round-off alone); and, by the worst leaf on
    the same scale, the norm of the first gradients' difference
    (``grad_diff``), which an error that averages out of a norm still shows."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"]))
    med_g = statistics.median(ref["first_grad"].values())
    diff = max(torch.linalg.vector_norm(prog["first_vec"][n] - g).item()
               / max(ref["first_grad"][n], med_g) for n, g in ref["first_vec"].items())
    med_c = statistics.median(ref["change"].values())
    grad = max(abs(prog["first_grad"][n] - g) / max(g, med_g)
               for n, g in ref["first_grad"].items())
    moved = [n for n, g in ref["first_grad"].items() if g >= 1e-3 * med_g]
    change = max(abs(prog["change"][n] - ref["change"][n]) / max(ref["change"][n], med_c)
                 for n in moved)
    return {"loss_gap": loss, "grad_norm_gap": grad, "change_norm_gap": change,
            "grad_diff": diff}


def reference_steps(ctx: harness.Context, quant: str | None = None) -> dict:
    """The reference over the checked steps, from the seed's weights and
    batches (drawn again here)."""
    ref_mod = harness.reference(ctx.cell.config)
    tr = harness.port_config(ctx.cell.config, "train", ctx.model).train
    opt = {"lr": tr.lr, "warmup_steps": tr.warmup_steps, "total_steps": tr.total_steps,
           "weight_decay": tr.weight_decay, "grad_clip": tr.grad_clip, "b1": tr.b1,
           "b2": tr.b2}
    params = weights.draw(ctx.spec, ctx.seed, ctx.device)
    batches = [feed(ctx, k) for k in range(ctx.cell.traffic["checked_steps"])]
    return ref_mod.train_steps(ctx.spec, params, batches, opt, quant=quant)


def free() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def run(ctx: harness.Context) -> harness.Outcome:
    mix = ctx.cell.traffic
    on_card = ctx.device.type == "cuda"
    model, state, step_fn = build(ctx)
    spans = Spans(ctx.trace and on_card)
    prog = checked_steps(ctx, state, step_fn, spans)
    if on_card:
        torch.cuda.synchronize(ctx.device)
    setup_s = time.time() - ctx.t_start
    k, t0 = mix["checked_steps"], time.perf_counter()
    while time.perf_counter() - t0 < ctx.seconds or k == mix["checked_steps"]:
        with spans.span("train_step"):
            state, metrics = step_fn(state, feed(ctx, k))
        k += 1
    last_loss = metrics["loss"].item()
    seconds = time.perf_counter() - t0
    steps = k - mix["checked_steps"]
    record = {"spec": ctx.spec, "spans": spans.resolve() if spans.enabled else {},
              "window": {"seconds": seconds, "steps": steps,
                         "flops": steps * counts.train_flops(ctx.spec, mix["rows"],
                                                             mix["seq_len"])}}
    if ctx.trace and on_card:
        def work():
            with Spans(True).span("train_step"):
                step_fn(state, feed(ctx, k))
        warm = lambda: torch.ones(1, device=ctx.device).add_(1)
        record["trace"] = profile(work, warm, ctx.trace_path)
        record["calls"] = [("train_step", {})]
    peak = torch.cuda.max_memory_allocated(ctx.device) if on_card else 0
    tokens = steps * mix["rows"] * mix["seq_len"]
    e2e = {"setup_s": setup_s, "train_tokens_per_s": tokens / seconds}
    del model, state, step_fn, metrics
    free()
    ref = reference_steps(ctx)
    found = gaps(prog, ref)
    limits = ctx.cell.limits
    checks = {name: (v, limits[name]) for name, v in found.items() if name in limits}
    extra = {"losses": prog["losses"], "ref_losses": ref["losses"], "window_last_loss": last_loss,
             **{f"reading_{n}": v for n, v in found.items()}}
    return harness.Outcome(e2e, record, attempted=steps, failed=0, checks=checks,
                           memory_peak=peak, extra=extra)


def program_steps(ctx: harness.Context, half: bool = False) -> dict:
    """``checked_steps`` of a fresh object; ``half`` leaves half of each
    batch out (the mean taken over the rest), a planted fault."""
    model, state, step_fn = build(ctx)
    fn = step_fn
    if half:
        fn = lambda st, batch: step_fn(st, {k: v[:len(v) // 2] for k, v in batch.items()})
    return checked_steps(ctx, state, fn, Spans(False))


def calibrate(ctx: harness.Context, control: bool) -> dict:
    """One seed's readings for the limits: the program's checked steps
    against the reference; with ``control``, also the control (the
    reference in fp8 in the program's place) and the program with half of
    each batch left out against it."""
    prog = program_steps(ctx)
    free()
    faulty = None
    if control:
        faulty = program_steps(ctx, half=True)
        free()
    ref = reference_steps(ctx)
    out = {f"program_{k}": v for k, v in gaps(prog, ref).items()}
    out["losses"], out["ref_losses"] = prog["losses"], ref["losses"]
    if control:
        out.update({f"half_batch_{k}": v for k, v in gaps(faulty, ref).items()})
        low = reference_steps(ctx, quant="fp8")
        out.update({f"control_{k}": v for k, v in gaps(low, ref).items()})
    return out
