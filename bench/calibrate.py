"""Readings that the correctness limits are set from, on the card, at a
cell's own sizes (never run by the benchmark's runs):

    python3 bench/calibrate.py --workload <cell> --seeds 11,12,13 --control 11,12,13

For each seed, in one process: the cell's set-up and a short window at its
own load, kept open until the mix's longest request is done; then the
check a run makes (the program's reading) and, on the ``--control`` seeds,
the control's reading: the reference in fp8 put in the program's place.
One JSON line a seed, and all of them in ``--out``.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", default="")
    ap.add_argument("--seconds", type=float, default=0.0)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from bench import harness
    harness.set_cache_env()
    import torch
    cell = harness.resolve(harness.manifest(), args.workload)
    device = torch.device("cuda", 0)
    control = {int(s) for s in args.control.split(",") if s}
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.time()
        ctx = harness.Context(cell, harness.spec_of(cell.config), seed, args.seconds, False,
                              device, t0, until_longest=True)
        drv = harness.driver(cell.traffic)
        row = {"workload": args.workload, "seed": seed, **drv.calibrate(ctx, seed in control)}
        row["seconds"] = time.time() - t0
        print(json.dumps(row), flush=True)
        rows.append(row)
        gc.collect()
        torch.cuda.empty_cache()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
