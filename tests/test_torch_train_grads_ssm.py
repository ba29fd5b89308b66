"""Training parity, the ssm and hybrid families: the port's stateless
backbone and Model.loss, and its gradient with respect to every parameter,
against jax.value_and_grad of the reference's loss on the reference's smoke
weights (f32: rel_err < 1e-5; bf16: the loss within 2e-2)."""

import pytest

from _torch_parity import assert_bf16_loss, assert_loss_and_grads

ARCHS = ["mamba2-130m", "zamba2-2.7b"]


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_f32(arch):
    assert_loss_and_grads(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_bf16(arch):
    assert_bf16_loss(arch)
