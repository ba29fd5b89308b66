"""The port's fault-tolerant training loop on the CPU, after
tests/test_training_loop.py: learning, microbatching, recovery from
injected faults, restart from a checkpoint (bit for bit against a run that
was never interrupted), SIGTERM, the straggler watch, and a fault after the
step's in-place update began."""

import dataclasses
import os
import signal

import pytest
import torch

from repro_torch.checkpoint import latest_step
from repro_torch.config import TrainConfig
from repro_torch.configs import get_config
from repro_torch.data import SyntheticLMDataset
from repro_torch.models import build_model
from repro_torch.serving import ServeSession
from repro_torch.training import (LoopConfig, TrainLoop, build_train_step,
                                  init_train_state)
from repro_torch.training.loop import StragglerMonitor

QUIET = dict(log_fn=lambda *_: None)


def _setup(steps=8, batch=4, seq=32, micro=1, arch="qwen3-1.7b"):
    cfg = get_config(arch, smoke=True)
    cfg = dataclasses.replace(cfg, train=TrainConfig(
        global_batch=batch, seq_len=seq, lr=1e-3, total_steps=steps, warmup_steps=2,
        microbatches=micro))
    model = build_model(cfg, device="cpu", seed=0)
    data = SyntheticLMDataset(cfg.model, seq_len=seq, global_batch=batch, seed=1)
    return model, data, init_train_state(model), build_train_step(model)


def _leaves(state):
    return [*state.params.values(), *state.opt.m.values(), *state.opt.v.values(),
            state.opt.step, state.step]


def _assert_states_equal(a, b):
    for x, y in zip(_leaves(a), _leaves(b), strict=True):
        assert torch.equal(x, y)


def test_loss_decreases():
    _, data, state, step = _setup(steps=30)
    losses = [float(step(state, data.batch(s))[1]["loss"]) for s in range(30)]
    assert losses[-1] < losses[0] - 0.2, f"no learning: {losses[0]} -> {losses[-1]}"


def test_microbatching_matches_full_batch():
    """Gradient accumulation in fp32 is close to the full batch."""
    _, data, s1, step1 = _setup(micro=1)
    _, _, s2, step2 = _setup(micro=2)
    batch = data.batch(0)
    for _ in range(2):                       # lr is 0 at step 0
        _, m1 = step1(s1, batch)
        _, m2 = step2(s2, batch)
    torch.testing.assert_close(m1["loss"], m2["loss"], rtol=5e-2, atol=0)
    for a, b in zip(s1.params.values(), s2.params.values()):
        torch.testing.assert_close(a.float(), b.float(), atol=5e-2, rtol=0)


def test_loop_recovers_from_injected_faults(tmp_path):
    """Kill the step twice mid-run; the loop restores from checkpoint and
    still finishes every step, equal to a run without faults."""
    _, data, state, step_fn = _setup(steps=12)
    boom_at = {4, 9}

    def fault_hook(step):
        if step in boom_at:
            boom_at.remove(step)
            raise RuntimeError("injected node failure")

    loop = TrainLoop(step_fn, state, data.batch,
                     LoopConfig(total_steps=12, checkpoint_every=3,
                                checkpoint_dir=str(tmp_path / "a"), max_restarts=5,
                                log_every=100), fault_hook=fault_hook, **QUIET)
    final = loop.run()
    assert int(final.step) == 12 and loop.restarts == 2
    assert loop.metrics_history[-1]["step"] == 11
    _, _, clean, clean_fn = _setup(steps=12)
    TrainLoop(clean_fn, clean, data.batch,
              LoopConfig(total_steps=12, checkpoint_every=100,
                         checkpoint_dir=str(tmp_path / "b")), **QUIET).run()
    _assert_states_equal(final, clean)


def test_loop_restart_resumes_from_checkpoint(tmp_path):
    """A second job with a fresh state restores the first one's newest
    checkpoint and continues; its state equals a never-interrupted run's,
    bit for bit."""
    _, data, ref, ref_fn = _setup(steps=10)
    for s in range(10):
        ref_fn(ref, data.batch(s))
    _, _, state1, step1 = _setup(steps=10)
    TrainLoop(step1, state1, data.batch,
              LoopConfig(total_steps=6, checkpoint_every=3, checkpoint_dir=str(tmp_path),
                         log_every=100), **QUIET).run()
    assert latest_step(tmp_path) == 6
    model2, _, state2, step2 = _setup(steps=10)
    loop2 = TrainLoop(step2, state2, data.batch,
                      LoopConfig(total_steps=10, checkpoint_every=100,
                                 checkpoint_dir=str(tmp_path), log_every=100), **QUIET)
    final = loop2.run()
    assert int(final.step) == 10 and loop2.metrics_history[0]["step"] == 6
    assert all(p is final.params[n] for n, p in model2.named_parameters())
    _assert_states_equal(final, ref)


def test_fault_after_the_update_began(tmp_path):
    """A fault after the in-place update began cannot be retried from the
    state: with no checkpoint the loop raises; with one it restores it and
    the run ends equal to one without the fault."""
    def flaky(step_fn, fail_after: set):
        def step(st, batch):
            out = step_fn(st, batch)
            if int(st.step) in fail_after:
                fail_after.remove(int(st.step))
                raise RuntimeError("device fault after the update")
            return out
        return step

    _, data, state, step_fn = _setup(steps=6)
    loop = TrainLoop(flaky(step_fn, {2}), state, data.batch,
                     LoopConfig(total_steps=6, checkpoint_every=100,
                                checkpoint_dir=str(tmp_path / "none")), **QUIET)
    with pytest.raises(RuntimeError, match="no checkpoint exists"):
        loop.run()

    _, _, state, step_fn = _setup(steps=6)
    loop = TrainLoop(flaky(step_fn, {5}), state, data.batch,
                     LoopConfig(total_steps=6, checkpoint_every=3,
                                checkpoint_dir=str(tmp_path / "ckpt")), **QUIET)
    final = loop.run()
    assert loop.restarts == 1 and int(final.step) == 6
    assert [h["step"] for h in loop.metrics_history] == [0, 1, 2, 3, 3, 4, 5]
    _, _, clean, clean_fn = _setup(steps=6)
    for s in range(6):
        clean_fn(clean, data.batch(s))
    _assert_states_equal(final, clean)


def test_sigterm_checkpoints_and_exits(tmp_path):
    _, data, state, step_fn = _setup(steps=10)
    previous = signal.getsignal(signal.SIGTERM)

    def preempt(step):
        if step == 3:
            os.kill(os.getpid(), signal.SIGTERM)

    try:
        loop = TrainLoop(step_fn, state, data.batch,
                         LoopConfig(total_steps=10, checkpoint_every=100,
                                    checkpoint_dir=str(tmp_path), handle_sigterm=True),
                         fault_hook=preempt, **QUIET)
        final = loop.run()
    finally:
        signal.signal(signal.SIGTERM, previous)
    assert int(final.step) == 4 and latest_step(tmp_path) == 4


def test_straggler_monitor_flags_slow_steps():
    mon = StragglerMonitor(factor=2.0)
    for _ in range(20):
        assert not mon.observe(0.1)
    assert mon.observe(0.5)
    assert mon.flagged == 1


def test_training_leaves_serving_as_it_was():
    """init_train_state makes the parameters trainable; serving's steps
    still run under no_grad and give the same tokens, and after a train
    step they serve the updated weights."""
    model, data, _, _ = _setup()
    prompts = torch.from_numpy(data.batch(0)["tokens"][:, :8])
    before = ServeSession(model, max_seq=32, device="cpu").generate(prompts, 4)
    state = init_train_state(model)
    session = ServeSession(model, max_seq=32, device="cpu")
    assert torch.equal(session.generate(prompts, 4), before)
    logits = session.prefill(prompts).clone()
    assert not logits.requires_grad and logits.grad_fn is None
    step = build_train_step(model)
    for s in range(2):                       # lr is 0 at step 0
        step(state, data.batch(s))
    assert not torch.equal(session.prefill(prompts), logits)
