"""Training parity, dense family: the port's Model.loss and its gradient
with respect to every parameter against jax.value_and_grad of the
reference's loss on the reference's smoke weights (f32: rel_err < 1e-5 on
the loss and each gradient leaf; bf16: the loss within 2e-2)."""

import pytest

from _torch_parity import assert_bf16_loss, assert_loss_and_grads

ARCHS = ["qwen3-1.7b", "gemma-2b", "gemma-7b", "nemotron-4-15b"]


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_f32(arch):
    assert_loss_and_grads(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_bf16(arch):
    assert_bf16_loss(arch)
