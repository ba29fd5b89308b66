"""The control, the reference in fp8 put in the program's place, comes out
not correct: on the card at each cell's own size against the cell's limits
(``cuda``: the calibration the limits were set from, on one seed), and
on the CPU at a small size, where it reads above the program."""

import pytest
import torch

from bench import harness
from bench.tests import small

SERVE_CELLS = ["qwen3-decode", "granite-moe-decode", "qwen3-prefill"]
CELLS = SERVE_CELLS + ["qwen3-train"]


def compared(cell, readings: dict, prefix: str) -> dict:
    return {k: readings[f"{prefix}{k}"] for k in cell.limits if k != "readings"}


@pytest.mark.parametrize("workload", SERVE_CELLS)
def test_serving_control_reads_above_the_program(workload):
    ctx = small.context(workload, until_longest=True)
    r = harness.driver(ctx.cell.traffic).calibrate(ctx, True)
    assert r["control_mean_gap"] > max(r["mean_gap"], 1e-6)
    assert r["control_max_gap"] > r["max_gap"]


def test_train_control_and_fault_read_above_the_program():
    ctx = small.context("qwen3-train")
    r = harness.driver(ctx.cell.traffic).calibrate(ctx, True)
    for k in ("loss_gap", "grad_norm_gap", "change_norm_gap", "grad_diff"):
        assert r[f"control_{k}"] > r[f"program_{k}"]
        assert r[f"half_batch_{k}"] > r[f"program_{k}"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_the_cell_at_its_size(workload, card):
    import time
    harness.set_cache_env()
    cell = harness.resolve(harness.manifest(), workload)
    ctx = harness.Context(cell, harness.spec_of(cell.config), 2**31 + 77, 0.0, False, card,
                          time.time(), until_longest=True)
    r = harness.driver(cell.traffic).calibrate(ctx, True)
    serve = cell.traffic["driver"] == "serve"
    program = compared(cell, r, "" if serve else "program_")
    control = compared(cell, r, "control_")
    assert all(v <= cell.limits[k] for k, v in program.items()), program
    assert any(v > cell.limits[k] for k, v in control.items()), control
