"""The port's train step against the reference's jitted one, and the RASA
engine's place in training.

Three steps of ``build_train_step`` (AdamW, warm-up + cosine, global-norm
clipping, microbatches 1 and 2 with fp32 accumulation) in f32 from the
reference's weights, on the reference's batches, against
``jax.jit(repro.training.step.build_train_step(api))``: after each step the
loss and grad_norm within rel_err 1e-5, the lr within 1e-6 (the schedule's
cosine, see test_torch_train_substrate.py), and every parameter and both
moments within rel_err 5e-5 (Adam divides m by sqrt(v), which carries the
gradients' 1e-6 differences into the update at a few times their size; the
largest seen was 2.6e-5, granite's parameters).

The RASA engine is forward-only, as the reference's Pallas engine is: a
backward through it raises on the CPU (the card's case is in
test_torch_cuda_train.py), a train step under it is refused, and the
forward loss under it agrees with the xla engine's
(test_pallas_engine_integration's tolerance, 0.02).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from _torch_parity import (port_train_model, rel_err, stacked, train_batch,
                           with_dtype)
from repro.config import TrainConfig as JTrain
from repro.configs import get_config as j_get_config
from repro.models import build_model as j_build_model
from repro.training import init_train_state as j_init_train_state
from repro.training.step import build_train_step as j_build_train_step
from repro_torch.kernels import rasa_matmul
from repro_torch.kernels.ops import FORWARD_ONLY
from repro_torch.training import build_train_step, init_train_state

STEPS, TRAIN = 3, dict(global_batch=4, seq_len=32, lr=1e-2, warmup_steps=1, total_steps=3)
STATE_TOL = 5e-5


@pytest.mark.parametrize("arch,micro", [("qwen3-1.7b", 1), ("qwen3-1.7b", 2),
                                        ("granite-moe-3b-a800m", 1), ("mamba2-130m", 2)])
def test_three_train_steps_match_reference(arch, micro):
    cfg = dataclasses.replace(with_dtype(j_get_config(arch, smoke=True), "float32"),
                              train=JTrain(microbatches=micro, **TRAIN))
    api = j_build_model(cfg)
    state = j_init_train_state(api, jax.random.key(0))
    model = port_train_model(arch, "float32", jax.tree.map(np.asarray, state.params),
                             microbatches=micro, **TRAIN)
    port = init_train_state(model)
    step, port_step = jax.jit(j_build_train_step(api)), build_train_step(model)
    for s in range(STEPS):
        batch = train_batch(cfg.model, s, TRAIN["global_batch"], TRAIN["seq_len"])
        state, metrics = step(state, batch)
        port, got = port_step(port, batch)
        for key, tol in (("loss", 1e-5), ("grad_norm", 1e-5), ("lr", 1e-6)):
            assert rel_err(got[key], metrics[key]) < tol, (s, key)
        assert int(port.step) == int(state.step) == int(port.opt.step) == s + 1
        for what, tree, have in (("params", state.params, port.params),
                                 ("m", state.opt.m, port.opt.m),
                                 ("v", state.opt.v, port.opt.v)):
            for name, want, got_leaf in stacked(tree, have):
                assert rel_err(got_leaf, want) < STATE_TOL, (s, what, name)


def test_step_updates_the_models_own_parameters():
    """The state is the model's parameters, updated in place: the model's
    next loss sees the step."""
    tree = jax.tree.map(np.asarray, j_build_model(j_get_config(
        "qwen3-1.7b", smoke=True)).init(jax.random.key(0)))
    model = port_train_model("qwen3-1.7b", "float32", tree, **TRAIN)
    state = init_train_state(model)
    assert all(p is state.params[n] for n, p in model.named_parameters())
    assert all(p.requires_grad for p in model.parameters())
    batch = train_batch(model.model, 0, TRAIN["global_batch"], TRAIN["seq_len"])
    before = model.embedding.detach().clone()
    step = build_train_step(model)
    step(state, batch)                      # lr 0 at step 0
    assert torch.equal(model.embedding, before)
    _, metrics = step(state, batch)
    assert not torch.equal(model.embedding, before)
    assert set(metrics) == {"loss", "ce", "aux_loss", "n_valid", "grad_norm", "lr"}


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "granite-moe-3b-a800m", "zamba2-2.7b"])
def test_remat_changes_no_gradient(arch):
    """remat full, dots and none give the same loss and gradients, bit for
    bit."""
    tree = jax.tree.map(np.asarray, j_build_model(j_get_config(
        arch, smoke=True)).init(jax.random.key(0)))
    batch = train_batch(j_get_config(arch, smoke=True).model)
    results = {}
    for policy in ("full", "dots", "none"):
        model = port_train_model(arch, "float32", tree, remat=policy)
        model.requires_grad_(True)
        loss, _ = model.loss(batch)
        results[policy] = (loss, torch.autograd.grad(loss, list(model.parameters())))
    for policy in ("dots", "none"):
        assert torch.equal(results[policy][0], results["full"][0])
        for a, b in zip(results[policy][1], results["full"][1], strict=True):
            assert torch.equal(a, b), policy


def test_rasa_backward_raises_on_cpu():
    """A backward through the RASA GEMM raises: its plain version on the CPU
    would give a gradient the card's kernel cannot (the kernel's output has
    no derivative), and the reference's Pallas engine has none."""
    a = torch.randn(8, 16, requires_grad=True)
    b = torch.randn(16, 4, requires_grad=True)
    out = rasa_matmul(a, b, schedule="wls")
    with pytest.raises(RuntimeError, match="forward-only"):
        out.sum().backward()
    with torch.no_grad():                   # serving's steps build no graph
        assert rasa_matmul(a, b).grad_fn is None


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "granite-moe-3b-a800m", "mamba2-130m"])
def test_pallas_rasa_loss_matches_xla(arch):
    """Model.loss under pallas_rasa (wlbp, blocks 128, as the reference's
    test_pallas_engine_integration) under torch.no_grad() against xla's:
    rtol = atol = 0.02.  Under autograd the loss builds, and its backward
    raises."""
    m = j_get_config(arch, smoke=True)
    tree = jax.tree.map(np.asarray, j_build_model(m).init(jax.random.key(0)))
    batch = train_batch(m.model, 1)
    with torch.no_grad():
        want, _ = port_train_model(arch, "bfloat16", tree).loss(batch)
        rasa = port_train_model(arch, "bfloat16", tree, kind="pallas_rasa", schedule="wlbp")
        got, _ = rasa.loss(batch)
    np.testing.assert_allclose(float(got), float(want), rtol=0.02, atol=0.02)
    rasa.requires_grad_(True)
    loss, _ = rasa.loss(batch)
    with pytest.raises(RuntimeError, match="forward-only"):
        torch.autograd.grad(loss, list(rasa.parameters()))


def test_pallas_rasa_train_step_refused():
    tree = jax.tree.map(np.asarray, j_build_model(j_get_config(
        "qwen3-1.7b", smoke=True)).init(jax.random.key(0)))
    model = port_train_model("qwen3-1.7b", "float32", tree, kind="pallas_rasa")
    with pytest.raises(ValueError, match="forward-only"):
        build_train_step(model)
    assert "xla" in FORWARD_ONLY
