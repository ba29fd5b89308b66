"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id> [--smoke]``.

Counterpart of the JAX package's ``launch/serve.py``: config -> mesh ->
``mesh_context`` -> model (random weights from a ``torch.Generator``
seeded 0) -> batched greedy decode through ``ServeSession.generate``,
sharded by the session's steps under the mesh.  Runs on the card (a process
group of NCCL) unless given ``--device cpu`` (gloo).  One generation
warms the session up (on the card it captures the CUDA graphs); the
timed one follows, after a timed prefill.
"""

from __future__ import annotations

import argparse
import time
from typing import NamedTuple

import numpy as np
import torch

from ..config import RunConfig
from ..configs import get_config
from ..distributed.sharding import mesh_context
from ..models import build_model
from ..models.transformer import prompt_shape
from ..serving import ServeSession
from .mesh import init_distributed, make_host_mesh


class ServeRun(NamedTuple):
    tokens: torch.Tensor          # [B, steps] (audio: [B, steps, n_codebooks])
    prefill_ms: float             # host clock, synchronised
    decode_ms_per_step: float     # (generate - prefill) / steps
    mesh: object                  # the DeviceMesh it served on
    session: ServeSession         # bound to that mesh by its first step


def prompts_for(cfg: RunConfig, batch: int, prompt_len: int) -> np.ndarray:
    """The launcher's prompts: int32 [B, S] (audio: [B, S, n_codebooks])
    drawn from numpy's generator seeded 0."""
    rng = np.random.default_rng(0)
    return rng.integers(0, cfg.model.vocab, prompt_shape(
        cfg.model, batch, prompt_len)).astype(np.int32)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def timed_generate(session: ServeSession, prompts, steps: int) -> tuple:
    """One warm-up generation (on the card it captures the steps' graphs),
    then a timed prefill and a timed generation: (tokens, prefill ms,
    decode ms a step), host clock, synchronised."""
    session.generate(prompts, steps)
    _sync(session.device)
    t0 = time.perf_counter()
    session.prefill(prompts)
    _sync(session.device)
    t1 = time.perf_counter()
    out = session.generate(prompts, steps)
    _sync(session.device)
    t2 = time.perf_counter()
    prefill = t1 - t0
    return out, prefill * 1e3, (t2 - t1 - prefill) * 1e3 / max(steps, 1)


def main(argv=None, *, cfg: RunConfig | None = None) -> ServeRun:
    """Parse ``argv`` and serve; ``cfg`` replaces ``--arch``'s config (a
    caller's engine or dtype) when given."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = cfg or get_config(args.arch, smoke=args.smoke)
    init_distributed(args.device)
    mesh = make_host_mesh(device=args.device)

    with mesh_context(mesh, cfg.parallel):
        model = build_model(cfg, device=args.device, seed=0)
        session = ServeSession(model, max_seq=args.prompt_len + args.steps + 8,
                               device=args.device)
        out, prefill, decode = timed_generate(
            session, prompts_for(cfg, args.batch, args.prompt_len), args.steps)
    dt = (prefill + decode * args.steps) / 1e3
    print(f"[serve] {args.batch} seqs x {args.steps} tokens in {dt:.2f}s "
          f"({args.batch * args.steps / dt:.1f} tok/s); prefill {prefill:.3f} ms, "
          f"decode {decode:.3f} ms/step on mesh {tuple(mesh.shape)}; "
          f"sample: {out[0].cpu().numpy()[:8].tolist()}")
    return ServeRun(out, prefill, decode, mesh, session)


if __name__ == "__main__":
    main()
