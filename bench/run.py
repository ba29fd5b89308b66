"""Run one cell of BENCHMARK.json once, on the machine it is started on:

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (the kernels' build on a checkout's first run, the weights drawn
from the seed on the card, every shape of the cell warmed up and captured),
then the measured window of ``--seconds``, then the check of what the
window served against the configuration's plain reference.  The last line
of standard output is the result's JSON; the numbers compared for
``correct`` are the last lines of standard error too.  Exits non-zero with
no result without enough CUDA devices, or when jax or the JAX package is
loaded once the window has closed.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from bench import harness
    t_start = harness.process_start()
    harness.set_cache_env()
    cell = harness.resolve(harness.manifest(), args.workload)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"bench: {args.workload} needs {cell.chips} CUDA device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    ctx = harness.Context(cell, harness.spec_of(cell.config), args.seed, args.seconds,
                          bool(args.trace), device, t_start)
    out = harness.driver(cell.traffic).run(ctx)
    line = harness.result(cell, out, bool(args.trace), torch.cuda.get_device_name(device),
                          cell.chips)
    bad = harness.loaded_forbidden()
    if bad:
        print(f"bench: modules of jax or the JAX package are loaded: {bad}", file=sys.stderr)
        return 3
    print(json.dumps({"details": out.extra}), file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
