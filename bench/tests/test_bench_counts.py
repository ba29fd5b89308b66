"""bench/counts.py against torch.utils.flop_counter.FlopCounterMode on the
port's SMOKE models (CPU, xla engine): the engine's products exactly, and
the model FLOPs never above what the port executes."""

import dataclasses

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from bench import counts, harness, weights

from repro_torch.config import TrainConfig
from repro_torch.configs import get_config
from repro_torch.models import model_of
from repro_torch.serving import ServeSession

ARCHS = ["qwen3-1.7b", "granite-moe-3b-a800m"]


def setup(arch):
    run = get_config(arch, smoke=True)
    run = dataclasses.replace(run, model=dataclasses.replace(run.model, dtype="float32"),
                              engine=dataclasses.replace(run.engine, kind="xla"))
    spec = harness.spec_of_model(run.model)
    return run, spec, model_of(run, weights.draw(spec, 4, "cpu", dtype=torch.float32))


def counted(fn) -> tuple[int, int]:
    """(aten.mm FLOPs, all FLOPs) that FlopCounterMode counts in fn()."""
    with FlopCounterMode(display=False) as fc:
        fn()
    by_op = fc.get_flop_counts()["Global"]
    mm = sum(v for k, v in by_op.items() if str(k).split(".")[-1] == "mm" or str(k) == "aten.mm")
    return mm, fc.get_total_flops()


def router_flops(spec, rows):
    moe = spec["moe"]
    return 2 * rows * spec["d_model"] * moe["n_experts"] * spec["n_layers"] if moe else 0


@pytest.mark.parametrize("arch", ARCHS)
def test_serving_products(arch):
    run, spec, model = setup(arch)
    b, s = 4, 16
    session = ServeSession(model, max_seq=24, device="cpu")
    prompts = torch.randint(0, spec["vocab"], (b, s), dtype=torch.int32)
    mm, total = counted(lambda: session.prefill(prompts))
    engine = sum(g.flops for g in counts.engine_gemms(spec, b * s, b))
    assert mm == engine + router_flops(spec, b * s)
    assert counts.forward_flops(spec, b, 0, s, b) <= total
    tok = torch.zeros(b, dtype=torch.int32)
    mm, total = counted(lambda: session.decode_step(tok))
    assert mm == sum(g.flops for g in counts.engine_gemms(spec, b, b)) + router_flops(spec, b)
    assert counts.forward_flops(spec, b, s, 1, b) <= total


def test_train_step():
    run, spec, model = setup("qwen3-1.7b")
    b, s = 2, 32
    model.requires_grad_(True)
    batch = {"tokens": torch.randint(0, spec["vocab"], (b, s), dtype=torch.int32),
             "labels": torch.randint(0, spec["vocab"], (b, s), dtype=torch.int32)}
    params = list(model.parameters())
    mm, total = counted(lambda: torch.autograd.grad(model.loss(batch)[0], params))
    engine = sum(g.flops for g in counts.engine_gemms(spec, b * s, b * s))
    head = counts.engine_gemms(spec, b * s, b * s)[-1].flops
    assert 3 * engine <= mm <= 4 * engine       # the layers and the CE recompute under remat
    assert counts.train_flops(spec, b, s) == 3 * counts.forward_flops(spec, b, 0, s, b * s)
    assert counts.train_flops(spec, b, s) <= total + head


def test_bounds():
    g = counts.Gemm("x", 64, 2048, 6144)
    assert g.bytes == 64 * 2048 * 2 + 2048 * 6144 * 2 + 64 * 6144 * 4
    assert g.bound_s() == pytest.approx(g.bytes / counts.HBM_BYTES_PER_S)
    big = counts.Gemm("y", 16384, 2048, 6144)
    assert big.bound_s() == pytest.approx(big.flops / counts.PEAK_BF16_FLOPS)
