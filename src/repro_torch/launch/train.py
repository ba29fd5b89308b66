"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [--smoke]``.

Counterpart of the JAX package's ``launch/train.py``: config -> mesh ->
``mesh_context`` -> sharded train state (the model's parameters
distributed FSDP x TP, random weights from a ``torch.Generator`` seeded
``TrainConfig.seed``) -> ``jit_train_step`` -> the fault-tolerant
``TrainLoop`` (checkpoints, restore onto the current shardings, SIGTERM
handling).  Runs on the card (NCCL) unless given ``--device cpu`` (gloo).
"""

from __future__ import annotations

import argparse
import dataclasses

from ..config import RunConfig
from ..configs import get_config
from ..data import SyntheticLMDataset
from ..distributed.sharding import mesh_context
from ..models import build_model
from ..training import LoopConfig, TrainLoop, init_train_state
from ..training.step import jit_train_step, state_shardings
from .mesh import init_distributed, make_host_mesh, make_mesh_for


def run_config(cfg: RunConfig, *, steps: int, global_batch: int, seq_len: int, lr: float,
               checkpoint_every: int, checkpoint_dir: str) -> RunConfig:
    """``cfg`` with the launcher's TrainConfig: the flags' fields, warm-up a
    tenth of the steps (at least one), the rest of ``cfg.train`` kept."""
    return dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, global_batch=global_batch, seq_len=seq_len, lr=lr, total_steps=steps,
        warmup_steps=max(steps // 10, 1), checkpoint_every=checkpoint_every,
        checkpoint_dir=checkpoint_dir))


def main(argv=None, *, cfg: RunConfig | None = None) -> TrainLoop:
    """Parse ``argv`` and train; returns the loop (its ``state`` the final
    state, its ``metrics_history`` each step's loss and seconds).  ``cfg``
    replaces ``--arch``'s config when given (its TrainConfig fields other
    than the flags', e.g. microbatches, are kept)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--checkpoint-dir", default="repro_ckpt")
    ap.add_argument("--checkpoint-every", type=int, default=20)
    ap.add_argument("--production-mesh", action="store_true",
                    help="the mesh of the config's ParallelConfig (16x16 ranks)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = run_config(cfg or get_config(args.arch, smoke=args.smoke), steps=args.steps,
                     global_batch=args.global_batch, seq_len=args.seq_len, lr=args.lr,
                     checkpoint_every=args.checkpoint_every,
                     checkpoint_dir=args.checkpoint_dir)

    init_distributed(args.device)
    mesh = (make_mesh_for(cfg.parallel, device=args.device) if args.production_mesh
            else make_host_mesh(device=args.device))
    data = SyntheticLMDataset(cfg.model, seq_len=args.seq_len, global_batch=args.global_batch)

    with mesh_context(mesh, cfg.parallel) as ctx:
        model = build_model(cfg, device=args.device, seed=cfg.train.seed)
        state = init_train_state(model)
        step_fn = jit_train_step(model, state, data.batch(0), ctx)
        loop = TrainLoop(
            step_fn=step_fn, state=state, batch_fn=data.batch,
            cfg=LoopConfig(total_steps=args.steps, checkpoint_every=args.checkpoint_every,
                           checkpoint_dir=args.checkpoint_dir, handle_sigterm=True),
            state_shardings=state_shardings(model, state, ctx))
        loop.run()
        losses = [m["loss"] for m in loop.metrics_history]
        print(f"[train] done: {len(losses)} steps, "
              + (f"loss {losses[0]:.3f} -> {losses[-1]:.3f}, " if losses else "")
              + f"stragglers flagged: {loop.straggler.flagged} on mesh {tuple(mesh.shape)}")
    return loop


if __name__ == "__main__":
    main()
