"""The serving batcher's whole-trace program (``multicore/jitarb.py``, its
plain PyTorch version on a ``torch`` chip) against the JAX package's numpy
client, bit for bit, every field of ``BatchReport``: all eight designs,
with equal and with demand-weighted shares (the domain table of the
reference's ``tests/test_online_jax.py``, first part)."""

import pytest

from _torch_program import ALL_DESIGNS, assert_program, chip_pair, in_domain, trace


@pytest.mark.parametrize("design", ALL_DESIGNS)
def test_all_designs_bit_identical(design):
    ref, port = chip_pair(design=design)
    requests = trace(6, seed=3)
    in_domain(requests, port)
    assert_program(requests, ref, port)


@pytest.mark.parametrize("design", ALL_DESIGNS)
def test_demand_shares_bit_identical(design):
    """Demand-weighted float weights fold in the host arbiter's span order,
    so every design agrees bit for bit."""
    ref, port = chip_pair(design=design, share_policy="demand")
    requests = trace(6, seed=7, mean_gap=1)
    in_domain(requests, port)
    assert_program(requests, ref, port)
