"""Quickstart on the PyTorch port: the paper in five minutes.

1. Reproduce the RASA cycle model's headline numbers (L=95, 16/95).
2. Run a GEMM through the functional RASA engine and the hand-written
   CUDA kernel (wlbp schedule), each against the oracle, and the kernel
   against its plain PyTorch version.
3. Train a tiny LM for a few steps with the port.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cuda|cpu]

On the card the simulator runs its ``cuda`` backend and the GEMM its
kernel; with ``--device cpu`` the simulator runs the numpy lane and the
GEMM its plain version (equal by construction there).
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np
import torch


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    backend = "cuda" if device.type == "cuda" else "numpy"

    # --- 1. the paper's numbers -------------------------------------------
    from repro_torch.core import TABLE_I, get_design, normalized_runtime, simulate
    sim = dict(backend=backend, device=args.device)
    base = get_design("BASE")
    print(f"L_baseline = {base.serial_latency(16)} cycles (paper: 95)")
    for design in ("RASA-PIPE", "RASA-WLBP", "RASA-DMDB-WLS"):
        r = normalized_runtime(TABLE_I["DLRM-2"], design, **sim)
        print(f"{design:16s} normalized runtime on DLRM-2: {r:.3f}")
    rep = simulate(TABLE_I["DLRM-2"], "RASA-DMDB-WLS", **sim)
    print(f"RASA-DMDB-WLS utilization: {rep.utilization:.1%} "
          f"(BASE: {simulate(TABLE_I['DLRM-2'], 'BASE', **sim).utilization:.1%})")

    # --- 2. numerics: functional engine == CUDA kernel == oracle ----------
    from repro_torch.core.engine import reference_gemm, run_gemm
    from repro_torch.kernels import GemmBlocks, rasa_matmul
    from repro_torch.kernels.rasa_gemm import rasa_gemm_plain
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.normal(size=(64, 96)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(96, 48)).astype(np.float32))
    c = torch.zeros((64, 48), dtype=torch.float32)
    cpu_engine = run_gemm(a, b, c)
    a16, b16 = (x.to(torch.bfloat16).to(device) for x in (a, b))
    gemm = dict(schedule="wlbp", blocks=GemmBlocks(128, 128, 128))
    kernel = rasa_matmul(a16, b16, **gemm).cpu()
    plain = rasa_gemm_plain(a16, b16, **gemm).cpu()
    oracle = reference_gemm(a, b, c)
    print(f"functional-engine max err: {(cpu_engine - oracle).abs().max():.2e}")
    print(f"rasa-kernel      max err: {(kernel - oracle).abs().max():.2e} ({device.type})")
    rel = ((kernel - plain).abs().max() / plain.abs().max()).item()
    if not rel < 1e-5:                       # the GEMM's tolerance (tests/test_kernels.py)
        raise AssertionError(f"the kernel differs from its plain version: rel_err {rel}")
    print(f"kernel vs plain version rel_err: {rel:.2e}")

    # --- 3. train a tiny model --------------------------------------------
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.models import build_model
    from repro_torch.training import build_train_step, init_train_state
    cfg = get_config("qwen3-1.7b", smoke=True)
    model = build_model(cfg, device=device, seed=0)
    data = SyntheticLMDataset(cfg.model, seq_len=32, global_batch=4)
    state = init_train_state(model)
    step = build_train_step(model)
    for s in range(10):
        state, metrics = step(state, data.batch(s))
        if s % 3 == 0:
            print(f"step {s}: loss {float(metrics['loss']):.3f}")
    print("quickstart OK")


if __name__ == "__main__":
    main()
