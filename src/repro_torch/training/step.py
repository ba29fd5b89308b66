"""The train step: loss -> gradients (optional microbatching) -> AdamW.

Counterpart of the JAX package's ``training/step.py``.  The state is the
model's own parameters (by name), the AdamW moments and the step count;
the step updates it in place and returns it, as the port's serving steps
do with their decode state.  Under a mesh context the state is sharded:
``init_train_state`` distributes the parameters by their rules
(``distributed.shardings_for``; FSDP x TP) and the moments take their
layout; ``jit_train_step`` is the reference's jit with shardings and
donation: a step that places the batch (``batch_shardings``) and updates
the DTensor state in place.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..distributed.sharding import (MeshContext, NamedSharding, activation_spec,
                                    current_ctx, distribute, full, laid_out, param_spec,
                                    placements, shardings_for)
from ..kernels.ops import FORWARD_ONLY
from ..models import Model
from ..optim import adamw_init, adamw_update, linear_warmup_cosine
from ..optim.adamw import AdamWState


class TrainState(NamedTuple):
    params: dict[str, torch.Tensor]    # the model's parameters, by name
    opt: AdamWState
    step: torch.Tensor                 # int32 0-d, on the model's device


def init_train_state(model: Model) -> TrainState:
    """Make the model's parameters trainable (``requires_grad``; serving's
    steps run under ``torch.no_grad()`` and are not affected) and give them
    AdamW moments of ``ParallelConfig.opt_state_dtype`` and a step count.
    Under a mesh context the parameters are distributed first (in place,
    ``shardings_for``) and the moments share their placements."""
    if current_ctx() is not None:
        shardings_for(model)
    model.requires_grad_(True)
    params = dict(model.named_parameters())
    return TrainState(params=params,
                      opt=adamw_init(params, model.cfg.parallel.opt_state_dtype),
                      step=torch.zeros((), dtype=torch.int32, device=model.device))


def build_train_step(model: Model) -> Callable[[TrainState, dict], tuple[TrainState, dict]]:
    """Returns step(state, batch) -> (state, metrics), for a state of
    ``init_train_state(model)``.  The batch (tensors or numpy arrays, on any
    device) is split along B into ``TrainConfig.microbatches`` parts whose
    gradients are accumulated in fp32 and averaged, as the reference does.
    Metrics (0-d tensors on the device; nothing syncs with the host): loss,
    ce, aux_loss and n_valid (ce and aux_loss averaged over microbatches,
    n_valid summed), grad_norm (before clipping) and lr.  The step counter
    advances before the in-place update begins.  Raises up front under the
    ``pallas_rasa`` engine, whose GEMM has no backward."""
    cfg = model.cfg
    tr = cfg.train
    if cfg.engine.kind == "pallas_rasa":
        raise ValueError(f"cannot build a train step: {FORWARD_ONLY}")
    mb = tr.microbatches

    def lr_at(step):
        return linear_warmup_cosine(step, peak_lr=tr.lr, warmup_steps=tr.warmup_steps,
                                    total_steps=tr.total_steps)

    def grads_of(params: dict, batch: dict):
        loss, metrics = model.loss(batch)
        # a parameter the loss does not reach (the hybrid's shared block with
        # no layer to follow) gets zeros, as jax.grad gives it
        grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True,
                                    materialize_grads=True)
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                dict(zip(params, grads)))

    def step_fn(state: TrainState, batch: dict) -> tuple[TrainState, dict]:
        if mb > 1:
            rows = len(batch["tokens"])
            if rows % mb:
                raise ValueError(f"batch of {rows} does not split into {mb} microbatches")
            n = rows // mb
            grads = {name: torch.zeros_like(p, dtype=torch.float32)
                     for name, p in state.params.items()}
            loss, metrics = 0.0, {}
            for i in range(mb):
                loss_i, metrics_i, g = grads_of(
                    state.params, {k: v[i * n:(i + 1) * n] for k, v in batch.items()})
                for name, acc in grads.items():
                    acc.add_(g[name])
                del g
                loss = loss + loss_i
                for k, v in metrics_i.items():
                    metrics[k] = metrics.get(k, 0) + v
            for acc in grads.values():
                acc.div_(mb)
            loss = loss / mb
            metrics["ce"], metrics["aux_loss"] = metrics["ce"] / mb, metrics["aux_loss"] / mb
        else:
            loss, metrics, grads = grads_of(state.params, batch)
        lr = lr_at(state.opt.step)
        state.step.add_(1)
        _, _, opt_metrics = adamw_update(
            state.params, grads, state.opt, lr=lr, b1=tr.b1, b2=tr.b2,
            weight_decay=tr.weight_decay, grad_clip=tr.grad_clip)
        return state, {"loss": loss, **metrics, **opt_metrics, "lr": lr}

    return step_fn


def state_shardings(model: Model, state: TrainState,
                    ctx: MeshContext | None = None) -> TrainState:
    """A TrainState of NamedShardings: each parameter and both its moments
    by the parameter's rule (``param_spec``), the step counts replicated."""
    ctx = ctx or current_ctx()
    params = {name: NamedSharding(ctx.mesh, param_spec(name, p.shape, ctx))
              for name, p in state.params.items()}
    rep = NamedSharding(ctx.mesh, placements((), ctx))
    return TrainState(params=params, opt=AdamWState(step=rep, m=params, v=params), step=rep)


def batch_shardings(batch_specs: dict, ctx: MeshContext | None = None) -> dict:
    """{name: NamedSharding} of a batch's tensors (or anything with a
    ``shape``): tokens and labels [B, S] as "tokens" (batch over DP), the
    audio family's [B, S, cb] and the vlm's patch_embeds [B, P, D] as
    "btd", each axis that does not divide its dim dropped."""
    ctx = ctx or current_ctx()
    out = {}
    for name, v in batch_specs.items():
        kind = "tokens" if len(v.shape) == 2 and name != "patch_embeds" else "btd"
        out[name] = NamedSharding(ctx.mesh, activation_spec(kind, ctx, tuple(v.shape)))
    return out


def jit_train_step(model: Model, state_template: TrainState, batch_specs: dict,
                   ctx: MeshContext | None = None):
    """The reference's jit with in/out shardings and state donation: a
    step(state, batch) -> (state, metrics) over the state of
    ``init_train_state`` under ``ctx`` (distributed; updated in place), each
    batch placed by ``batch_shardings`` (every rank holds the whole batch,
    from the step-indexed pipeline, and keeps its shard) and the metrics
    gathered into plain tensors."""
    ctx = ctx or current_ctx()
    want = state_shardings(model, state_template, ctx)
    for name, p in state_template.params.items():
        if not laid_out(p, want.params[name]):
            raise ValueError(f"{name} is not laid out for this mesh: build the state with "
                             "init_train_state inside mesh_context")
    step_fn = build_train_step(model)
    b_sh = batch_shardings(batch_specs, ctx)

    def step(state: TrainState, batch: dict):
        placed = {k: distribute(torch.as_tensor(v, device=model.device), b_sh[k])
                  for k, v in batch.items()}
        state, metrics = step_fn(state, placed)
        return state, {k: full(v) for k, v in metrics.items()}

    return step
