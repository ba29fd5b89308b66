"""Chip-level design-space walkthrough on the PyTorch port: from one RASA
engine to a CMP.

Three questions a chip architect would ask before committing to a RASA CMP,
answered with the :mod:`repro_torch.multicore` subsystem:

  1. How should one GEMM be split across cores?   (partitioner comparison)
  2. How much memory bandwidth does the chip need? (bandwidth sweep)
  3. How should a model's layers be placed?        (scheduler comparison)

Run:  python examples/torch_chip_design_space.py [--device cpu]

On the card the chip runs the simulator's ``cuda`` backend (the port's
default); with ``--device cpu`` its numpy lane, equal to it bit for bit.
"""

import argparse
import math
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core import TABLE_I
from repro_torch.multicore import ChipConfig, simulate_chip

SPEC = TABLE_I["BERT-1"]


def partitioner_comparison(backend: str) -> None:
    print(f"== 1. Partitioning {SPEC.name} ({SPEC.M}x{SPEC.K}x{SPEC.N}) "
          "across 16 cores (RASA-DMDB-WLS, 256 B/cyc) ==")
    for part in ("m_split", "n_split", "block2d"):
        rep = simulate_chip(SPEC, ChipConfig(n_cores=16, backend=backend), partition=part)
        print(f"  {part:<9} cycles={rep.cycles:>9.0f}  eff={rep.efficiency:.3f}"
              f"  bw-stall={rep.bw_stall_share:.1%}")
    print("  -> m_split re-streams all of B on every core; the 4x4 block-"
          "cyclic grid\n     loads each B panel on only 4 cores and wins "
          "once bandwidth binds.\n")


def bandwidth_sweep(backend: str) -> None:
    print("== 2. Bandwidth needed for 8 cores of RASA-DMDB-WLS ==")
    for bw in (64.0, 128.0, 256.0, 512.0, 1024.0, math.inf):
        chip = ChipConfig(n_cores=8, bw_bytes_per_cycle=bw, backend=backend)
        rep = simulate_chip(SPEC, chip, partition="block2d")
        label = "inf" if math.isinf(bw) else f"{bw:.0f}"
        print(f"  {label:>5} B/cyc  speedup={rep.speedup:5.2f}"
              f"  eff={rep.efficiency:.3f}  bw-stall={rep.bw_stall_share:.1%}")
    print("  -> eight RASA-DMDB-WLS cores need ~512 B/cyc (64 per core) to "
          "scale;\n     the ~6x per-core engine speedup multiplies the "
          "chip's bandwidth\n     appetite by the same factor -- BASE cores "
          "get by on a sixth of that.\n")


def scheduler_comparison(backend: str) -> None:
    wl = [TABLE_I["DLRM-2"], TABLE_I["BERT-1"], TABLE_I["DLRM-2"],
          TABLE_I["BERT-1"], TABLE_I["DLRM-2"], TABLE_I["DLRM-2"]]
    print("== 3. Placing a 6-layer workload on 4 cores (RASA-WLBP) ==")
    for sched in ("round_robin", "work_queue", "lpt", "gang"):
        chip = ChipConfig(n_cores=4, design="RASA-WLBP", backend=backend)
        rep = simulate_chip(wl, chip, scheduler=sched)
        lens = "/".join(str(len(g)) for g in rep.per_core_gemms)
        print(f"  {sched:<12} makespan={rep.cycles:>9.0f}"
              f"  speedup={rep.speedup:.2f}  gemms-per-core={lens}")
    print("  -> round-robin is blind to the 16x size skew between BERT-1 "
          "and DLRM-2;\n     the dynamic queue fills the gaps.")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    backend = "cuda" if ap.parse_args().device.startswith("cuda") else "numpy"
    partitioner_comparison(backend)
    bandwidth_sweep(backend)
    scheduler_comparison(backend)
