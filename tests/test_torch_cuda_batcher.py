"""The serving batcher's whole-trace arbitration kernel (csrc/jitarb.cu)
against its plain PyTorch version and against the port's numpy client, on
the card.

Marked ``cuda``; each test decides inside itself whether a CUDA device is
present and skips without one (the test of the refusal runs only where
there is none).  This file imports no jax and nothing of the JAX package,
so it also runs on a GPU host that has neither:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_batcher.py
"""

import dataclasses

import pytest
import torch

from repro_torch.kernels import jitarb as kj
from repro_torch.multicore import ChipConfig, jitarb
from repro_torch.serving.simbatch import report_from_finishes, run_batcher, synthetic_trace

pytestmark = pytest.mark.cuda


def need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def trace(n, seed, mean_gap=1):
    return synthetic_trace(n, seed=seed, mean_gap=mean_gap, d_model=128,
                           prompt_lens=(16, 32), decode_steps=(1, 2), decode_batch=8)


def traffic(requests):
    return [(r.arrival_epoch, r.specs) for r in requests]


CASES = {
    "fixed-demand": (dict(n_cores=2, share_policy="demand"), "fixed", 12, 3),
    "occupancy-4core": (dict(n_cores=4, bw_bytes_per_cycle=16.0), "occupancy", 14, 4),
    "bandwidth-mixed": (dict(n_cores=None, design=None, cores=("BASE", "RASA-WLBP")),
                        "bandwidth", 10, 8),
    "predicted-3core": (dict(n_cores=3, bw_bytes_per_cycle=48.0), "predicted", 10, 12),
}


@pytest.mark.parametrize("case", list(CASES))
def test_kernel_equals_plain_and_numpy(case):
    """Finish and admit epochs of the kernel equal the plain version's on
    the same inputs (and on the card), and the numpy client's BatchReport
    bit for bit; the kernel launches once."""
    need_cuda()
    kw, policy, n, seed = CASES[case]
    kw = {"design": "RASA-WLBP", "bw_bytes_per_cycle": 32.0, **kw}
    requests = trace(n, seed)
    chip = ChipConfig(backend="cuda", **kw)
    p, why = jitarb.plan_ex(traffic(requests), chip, policy=policy)
    assert p is not None, why
    args, akw = jitarb._inputs([p])
    before = kj.launches["jitarb"]
    fin, adm, st = kj.jitarb_cuda(*args, **akw)
    assert kj.launches["jitarb"] == before + 1
    pfin, padm, pst = kj.jitarb_plain(*args, **akw)
    assert torch.equal(fin, pfin) and torch.equal(adm, padm)
    assert torch.equal(st, pst)
    got = run_batcher(requests, chip, policy=policy, batch_size=1)
    want = run_batcher(requests, dataclasses.replace(chip, backend="numpy"), policy=policy,
                       batch_size=1)
    assert got == want and got.jit_gate is None


def test_sweep_one_launch_equals_sequential():
    """plan_many's arrival-rate sweep settles as one launch of three CTAs
    and equals per-variant numpy-client runs."""
    need_cuda()
    base = trace(10, 5, mean_gap=3)
    chip = ChipConfig(backend="cuda", n_cores=2, design="RASA-WLBP", bw_bytes_per_cycle=32.0)
    variants = [[dataclasses.replace(r, arrival_epoch=int(r.arrival_epoch * f)) for r in base]
                for f in (1.0, 0.5, 0.25)]
    plans = jitarb.plan_many([traffic(v) for v in variants], chip)
    assert plans is not None
    before = kj.launches["jitarb"]
    outs = jitarb.finish_times_many(plans)
    assert kj.launches["jitarb"] == before + 1
    np_chip = dataclasses.replace(chip, backend="numpy")
    for v, fin in zip(variants, outs):
        assert report_from_finishes(v, chip, fin) == run_batcher(v, np_chip, policy="fixed",
                                                                 batch_size=1)


def test_torch_chip_on_the_card_runs_the_plain_program():
    """A ``torch`` chip whose device is the card settles the trace with the
    plain program there: no kernel launches, the numpy client's report."""
    need_cuda()
    from repro_torch.kernels import fastsim_scan as fsk
    requests = trace(4, 7)
    chip = ChipConfig(backend="torch", device="cuda", n_cores=2, design="RASA-WLBP",
                      bw_bytes_per_cycle=32.0)
    before = (kj.launches["jitarb"], dict(fsk.launches))
    got = run_batcher(requests, chip, policy="occupancy", batch_size=1)
    assert (kj.launches["jitarb"], fsk.launches) == before
    want = run_batcher(requests, dataclasses.replace(chip, backend="numpy"),
                       policy="occupancy", batch_size=1)
    assert got == want and got.jit_gate is None


def test_cuda_chip_without_card_raises():
    """A cuda chip (the default) refuses to run where there is no card:
    no fallback to the CPU or to the plain version."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert ChipConfig().backend == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_batcher(trace(3, 1), ChipConfig(n_cores=2))
