"""Explore the RASA design space beyond the paper, on the PyTorch port.

1. Register-allocation policies: WLBP hit rate vs policy (the
   "register-aware" lever the paper fixes at Algorithm 1's 2x2 block).
2. AMX-tilecfg exact edge tiles (beyond-paper FF shortening).
3. Load-latency sensitivity (where the engine becomes memory-bound).

    PYTHONPATH=src python examples/torch_rasa_design_space.py [--device cpu]

On the card the simulator runs its ``cuda`` backend (the port's default);
with ``--device cpu`` its numpy lane, equal to it bit for bit.
"""

import argparse
import dataclasses
import functools
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core import GemmSpec, RegPolicy, TABLE_I, get_design, stream_stats
from repro_torch.core import normalized_runtime as _normalized_runtime
from repro_torch.core import simulate as _simulate


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    device = ap.parse_args(argv).device
    backend = "cuda" if device.startswith("cuda") else "numpy"
    simulate = functools.partial(_simulate, backend=backend, device=device)
    normalized_runtime = functools.partial(_normalized_runtime, backend=backend,
                                           device=device)
    spec = TABLE_I["BERT-1"]

    print("== register policy design space (RASA-WLBP on BERT-1) ==")
    policies = {
        "alg1 2x2 (paper)": RegPolicy(mc=2, nc=2, a_regs=2, b_regs=2),
        "tall 4x1": RegPolicy(mc=4, nc=1, a_regs=2, b_regs=1),
        "max-reuse 5x1": RegPolicy(mc=5, nc=1, a_regs=2, b_regs=1),
        "wide 1x4": RegPolicy(mc=1, nc=4, a_regs=1, b_regs=2),
        "reuse-hostile": RegPolicy(mc=2, nc=2, a_regs=2, b_regs=2,
                                   mm_order="m_outer"),
    }
    for name, pol in policies.items():
        stats = stream_stats(spec, pol)
        r = normalized_runtime(spec, "RASA-WLBP", pol)
        print(f"  {name:20s} wlbp_rate={stats['wlbp_rate']:.2f} "
              f"norm_runtime={r:.3f}")

    print("\n== tilecfg exact tiles (batch 3 FC layer) ==")
    small = GemmSpec("fc-b3", 3, 1024, 1024)
    padded = simulate(small, "RASA-DMDB-WLS", RegPolicy())
    exact = simulate(small, "RASA-DMDB-WLS", RegPolicy(pad_tiles=False))
    print(f"  padded tiles: {padded.cycles:.0f} cycles; "
          f"exact tiles: {exact.cycles:.0f} cycles "
          f"({1 - exact.cycles / padded.cycles:.1%} faster)")

    print("\n== load-latency sensitivity (RASA-DMDB-WLS, DLRM-2) ==")
    for lat in (2, 5, 10, 20, 40, 80):
        cfg = dataclasses.replace(get_design("RASA-DMDB-WLS"),
                                  load_latency=lat)
        rep = simulate(TABLE_I["DLRM-2"], cfg)
        print(f"  load_latency={lat:3d} engine cycles -> "
              f"util={rep.utilization:.1%}")


if __name__ == "__main__":
    main()
