"""The whole-trace program on a ``torch`` chip against the JAX package's
numpy client, bit for bit (second part of the reference's domain table):
core counts and starved bandwidth, burst arrivals, the reactive
policies, ``fixed`` at larger batches, and mixed chips."""

import pytest

from _torch_program import (REACTIVE, assert_program, chip_pair, hetero_pair, in_domain,
                            trace)


@pytest.mark.parametrize("kw", [
    dict(n_cores=1),
    dict(n_cores=3, bw_bytes_per_cycle=48.0),
    dict(n_cores=4, bw_bytes_per_cycle=16.0),   # bandwidth-starved
], ids=["one-core", "three-core", "starved"])
def test_shapes_and_contention_bit_identical(kw):
    ref, port = chip_pair(**kw)
    assert_program(trace(8, seed=4, mean_gap=1), ref, port)


def test_burst_arrivals_bit_identical():
    """All requests in one epoch: every boundary coincides."""
    ref, port = chip_pair(n_cores=2)
    assert_program(trace(8, seed=6, mean_gap=0), ref, port)


@pytest.mark.parametrize("policy", REACTIVE)
def test_reactive_admission_bit_identical(policy):
    """Headroom, occupancy, soonest-free placement and work conservation
    replayed inside the program agree with the host driver, admit epochs
    included."""
    ref, port = chip_pair(n_cores=2)
    requests = trace(8, seed=12, mean_gap=1)
    in_domain(requests, port, policy=policy)
    assert_program(requests, ref, port, policy=policy)


@pytest.mark.parametrize("batch_size", (2, 3, 8))
def test_fixed_batch_sizes_bit_identical(batch_size):
    ref, port = chip_pair(n_cores=2)
    requests = trace(9, seed=13, mean_gap=1)
    in_domain(requests, port, batch_size=batch_size)
    assert_program(requests, ref, port, batch_size=batch_size)


@pytest.mark.parametrize("policy", ("fixed", "bandwidth"))
def test_heterogeneous_mix_bit_identical(policy):
    ref, port = hetero_pair()
    requests = trace(8, seed=8, mean_gap=1)
    in_domain(requests, port, policy=policy)
    assert_program(requests, ref, port, policy=policy)


def test_hetero_rasa_mix_bit_identical():
    """Per-core tiling policies compile distinct trace rows for one request
    shape; the (shape, core) row table routes each lane to its own."""
    ref, port = hetero_pair(cores=("RASA-WLBP", "RASA-PIPE"))
    requests = trace(6, seed=14)
    in_domain(requests, port)
    assert_program(requests, ref, port)
