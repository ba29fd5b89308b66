"""The port's MoE block against the JAX package's, on the same numpy inputs.

granite-moe (40 experts at full size; smoke 8, top-4) and grok (smoke 4,
top-2), each with the gate/up weights apart and fused ([E, D, 2, Fe]), at
the smoke configs' capacity factor (4.0: nothing dropped at these sizes)
and at 1.0 on 2 x 64 tokens, where tokens are dropped and the capacity
decides which.

Tolerances (rel_err = max abs difference over max abs reference): f32 1e-5
(fp32 on both sides, sums in another order); bf16 2e-2 (the reference's
bf16 tolerance, tests/test_kernels.py:112).  The auxiliary loss is fp32 on
both sides in either dtype: 1e-5.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import EngineConfig as JEngine
from repro.models import moe as jm
from repro_torch.models import moe as tm

from _torch_parity import (TOL, model_cfg, normal, port_model_cfg, rel_err, to_np,
                          to_torch)

AUX_TOL = 1e-5


def moe_params(m, dtype, rng) -> dict:
    e, d, fe = m.moe.n_experts, m.d_model, m.moe.d_ff_expert
    p = {"router": normal(rng, (d, e), dtype, d ** -0.5),
         "experts_w_down": normal(rng, (e, fe, d), dtype, fe ** -0.5)}
    if m.fuse_gate_up:
        p["experts_w_gate_up"] = normal(rng, (e, d, 2, fe), dtype, d ** -0.5)
    else:
        p["experts_w_gate"] = normal(rng, (e, d, fe), dtype, d ** -0.5)
        p["experts_w_up"] = normal(rng, (e, d, fe), dtype, d ** -0.5)
    return p


CASES = [  # (arch, fused, capacity factor or None for the config's, batch, seq)
    ("granite-moe-3b-a800m", False, None, 2, 5),
    ("granite-moe-3b-a800m", True, None, 2, 5),
    ("granite-moe-3b-a800m", False, 1.0, 2, 64),
    ("granite-moe-3b-a800m", True, 1.0, 2, 64),
    ("grok-1-314b", False, None, 2, 5),
    ("grok-1-314b", True, None, 1, 1),
    ("grok-1-314b", False, 1.0, 2, 64),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch,fused,cf,batch,seq", CASES)
def test_moe_block(arch, fused, cf, batch, seq, dtype):
    m, t = model_cfg(arch, dtype, fuse_gate_up=fused)
    if cf is not None:
        m = dataclasses.replace(m, moe=dataclasses.replace(m.moe, capacity_factor=cf))
        t = port_model_cfg(m)
    rng = np.random.default_rng(7)
    p = moe_params(m, dtype, rng)
    x = normal(rng, (batch, seq, m.d_model), dtype)
    want, want_aux = jm.moe_block({n: jnp.asarray(a) for n, a in p.items()},
                                  jnp.asarray(x), m, JEngine())
    tp = {n: to_torch(a) for n, a in p.items()}
    got, routing = tm.moe_forward(tp, to_torch(x), t)
    got_aux = tm.moe_block(tp, to_torch(x), t)[1]
    assert got.dtype == getattr(torch, dtype) and got.shape == x.shape
    assert rel_err(to_np(got), want) < TOL[dtype]
    assert rel_err(to_np(got_aux), want_aux) < AUX_TOL
    if cf == 1.0:
        assert not routing.keep.all()        # the capacity dropped tokens


@pytest.mark.parametrize("t,requested", [(1, 16), (4, 16), (8, 16), (10, 16), (256, 16),
                                         (512, 16), (12, 8), (7, 4), (36, 16)])
def test_group_count(t, requested):
    assert tm._group_count(t, requested) == jm._group_count(t, requested)


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "grok-1-314b"])
def test_decode_and_prefill_shapes_are_static(arch):
    """The group count and the capacity follow from the config and the
    token count alone; at decode (4 tokens) every group holds one token and
    one slot per expert."""
    from repro_torch.configs import get_config
    m = get_config(arch).model
    assert tm._group_count(4, m.moe.dispatch_groups) == 4 and tm.capacity(1, m) == 1
    assert tm._group_count(4 * 128, m.moe.dispatch_groups) == 16
    want = max(int(32 * m.moe.top_k / m.moe.n_experts * m.moe.capacity_factor) + 1, 1)
    assert tm.capacity(32, m) == want
