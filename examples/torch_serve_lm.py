"""Serve a small model with batched requests on the PyTorch port: prefill
+ greedy decode through ``ServeSession`` (CUDA graphs on the card).

    PYTHONPATH=src python examples/torch_serve_lm.py --arch gemma-2b --batch 4 [--device cpu]
"""

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.serving import ServeSession


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma-2b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--steps", type=int, default=24)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=True)
    model = build_model(cfg, device=args.device, seed=0)
    session = ServeSession(model, max_seq=args.prompt_len + args.steps + 8,
                           device=args.device)

    rng = np.random.default_rng(0)
    shape = (args.batch, args.prompt_len)
    if cfg.model.family == "audio":
        shape += (cfg.model.n_codebooks,)
    prompts = torch.as_tensor(rng.integers(0, cfg.model.vocab, shape), dtype=torch.int32)

    t0 = time.perf_counter()
    out = session.generate(prompts, args.steps)
    if session.device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    print(f"decoded {args.batch} x {args.steps} tokens in {dt:.2f}s "
          f"({args.batch * args.steps / dt:.1f} tok/s)")
    print("first sequence:", out[0][:12].tolist())


if __name__ == "__main__":
    main()
