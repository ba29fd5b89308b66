"""A run with its timed path broken underneath comes out not correct: the
harness's look for a card skipped, a cell's run driven on the CPU at a
small size (tests/small.py), with the cell's own limits.  Serving: each
token altered where it is produced.  Training: a step that returns its
state unchanged, and half of each batch left out (the mean taken over the
rest).  One chip, so no exchange between chips can be left out."""

import pytest
import torch

from bench.drivers import train
from bench.tests import small

from repro_torch.serving import ServeSession

SERVE_CELLS = ["qwen3-decode", "granite-moe-decode", "qwen3-prefill"]


@pytest.mark.parametrize("cell", SERVE_CELLS)
def test_sound_serving_run_is_correct(cell):
    _, line = small.run(cell, seconds=0.0, until_longest=True)
    assert line["correct"] is True, line["checks"]


@pytest.mark.parametrize("cell", SERVE_CELLS)
@pytest.mark.parametrize("call", ["prefill", "decode_step"])
def test_altered_tokens_fail(cell, call, monkeypatch):
    real = getattr(ServeSession, call)
    monkeypatch.setattr(ServeSession, call,
                        lambda self, x: torch.roll(real(self, x), 1, dims=-1))
    _, line = small.run(cell, seconds=0.0, until_longest=True)
    assert line["correct"] is False, line["checks"]


def test_sound_train_run_is_correct():
    _, line = small.run("qwen3-train", seconds=0.0)
    assert line["correct"] is True, line["checks"]


def broken_build(fault):
    real = train.build

    def build(ctx):
        model, state, step_fn = real(ctx)
        if fault == "unchanged":
            def step(st, batch):
                loss, _ = model.loss(batch)
                return st, {"loss": loss.detach()}
        else:
            def step(st, batch):
                return step_fn(st, {k: v[:len(v) // 2] for k, v in batch.items()})
        return model, state, step
    return build


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_broken_train_step_fails(fault, monkeypatch):
    monkeypatch.setattr(train, "build", broken_build(fault))
    _, line = small.run("qwen3-train", seconds=0.0)
    assert line["correct"] is False, line["checks"]
