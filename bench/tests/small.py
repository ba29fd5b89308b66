"""Cells of BENCHMARK.json at a size a CPU test holds: the port's SMOKE
model of the cell's configuration and the cell's traffic cut down, driven
by the harness as a run drives it."""

from __future__ import annotations

import dataclasses
import time

import torch

from bench import harness

#: the traffic of each driver kind, cut to the CPU
SMALL_TRAFFIC = {
    "serve": {"batch": 4, "prompt_len": {"8": 1, "16": 1}, "output_len": {"3": 1, "6": 1},
              "max_seq": 24, "sample_rows": 3,
              "trace": {"prompt_lens": [16], "decode_steps": 2, "prefill": False}},
    "train": {"rows": 8, "seq_len": 32, "checked_steps": 3},
}


#: limits of the cells whose full-size limits do not hold at the small size:
#: the training readings of a sound small run on the CPU are loss 2e-4, first
#: gradient 2e-3, change 1.1e-2 (a leaf of 64 elements rounds coarsely) and
#: gradient difference 0.015; half of each batch left out reads 1.8e-2, 0.23,
#: 0.29 and 0.84
SMALL_LIMITS = {"qwen3-train": {"loss_gap": 2e-3, "grad_norm_gap": 0.05, "change_norm_gap": 0.05,
                               "grad_diff": 0.1}}


def small_model(config: dict, kind: str):
    from repro_torch.configs import get_config
    m = get_config(config["arch"], smoke=True).model
    if kind == "train":
        m = dataclasses.replace(m, dtype=config["torch_dtype"])
    return m


def context(workload: str, seed: int = 1234, seconds: float = 0.0, **kw) -> harness.Context:
    cell = harness.resolve(harness.manifest(), workload)
    kind = cell.traffic["driver"]
    cell.traffic = {**cell.traffic, **SMALL_TRAFFIC[kind]}
    cell.limits = SMALL_LIMITS.get(workload, cell.limits)
    model = small_model(cell.config, kind)
    return harness.Context(cell, harness.spec_of_model(model), seed, seconds, False,
                           torch.device("cpu"), time.time(), model=model, **kw)


def run(workload: str, **kw) -> tuple[harness.Outcome, dict]:
    ctx = context(workload, **kw)
    out = harness.driver(ctx.cell.traffic).run(ctx)
    return out, harness.result(ctx.cell, out, False, "cpu", 1)
