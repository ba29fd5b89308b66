"""Serving parity, gemma-2b smoke (dense, MQA kv=1, GeGLU, tied head): the
port's prefill logits, teacher-forced decode logits and ServeSession tokens
against the reference's, with the reference's weights carried over through
params_from_jax.  The analogue of tests/test_arch_smoke.py:53-105.

Tolerances: f32 logits rel_err < 1e-5 (fp32 on both sides, sums in another
order) and identical greedy tokens; bf16 logits within the reference's
decode-vs-prefill tolerance, rtol = atol = 0.15 (test_arch_smoke.py:83).
"""

import numpy as np
import pytest

from _torch_parity import (ENGINES, port_model, port_outputs, reference,
                           rel_err)

ARCH = "gemma-2b"
F32_TOL = 1e-5
BF16_TOL = 0.15


@pytest.fixture(scope="module")
def ref32():
    return reference(ARCH, "float32")


@pytest.fixture(scope="module")
def ref16():
    return reference(ARCH, "bfloat16")


_outputs = {}


def outputs(ref, dtype, kind, schedule):
    """The port's outputs under one engine, computed once per module."""
    key = (dtype, kind, schedule)
    if key not in _outputs:
        _outputs[key] = port_outputs(
            port_model(ARCH, dtype, ref["tree"], kind, schedule), ref["tokens_in"])
    return _outputs[key]


@pytest.mark.parametrize("name,kind,schedule", ENGINES)
def test_f32_prefill_and_decode_logits(ref32, name, kind, schedule):
    out = outputs(ref32, "float32", kind, schedule)
    assert rel_err(out["prefill"], ref32["prefill"]) < F32_TOL
    for got, want in zip(out["decode"], ref32["decode"]):
        assert rel_err(got, want) < F32_TOL


@pytest.mark.parametrize("name,kind,schedule", ENGINES)
def test_f32_greedy_tokens(ref32, name, kind, schedule):
    out = outputs(ref32, "float32", kind, schedule)
    np.testing.assert_array_equal(out["tokens"], ref32["generate"]["xla"])
    np.testing.assert_array_equal(out["tokens"], ref32["generate"]["pallas_rasa"])


@pytest.mark.parametrize("name,kind,schedule", ENGINES)
def test_bf16_logits(ref16, name, kind, schedule):
    out = outputs(ref16, "bfloat16", kind, schedule)
    np.testing.assert_allclose(out["prefill"], ref16["prefill"],
                               rtol=BF16_TOL, atol=BF16_TOL)
    for got, want in zip(out["decode"], ref16["decode"]):
        np.testing.assert_allclose(got, want, rtol=BF16_TOL, atol=BF16_TOL)
    # the port's own decode path reproduces its prefill (cache correctness)
    np.testing.assert_allclose(out["decode"][-1], out["prefill"],
                               rtol=BF16_TOL, atol=BF16_TOL)


def test_bf16_schedules_bit_identical(ref16):
    outs = [outputs(ref16, "bfloat16", "pallas_rasa", s)
            for s in ("wls", "wlbp", "base")]
    for out in outs[1:]:
        np.testing.assert_array_equal(out["prefill"], outs[0]["prefill"])
        np.testing.assert_array_equal(out["tokens"], outs[0]["tokens"])
