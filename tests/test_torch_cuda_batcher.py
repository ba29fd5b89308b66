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

from repro_torch.kernels import fastsim_scan as fsk
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


def planned(n, seed, cores, prompt_lens=(16, 32), policy="occupancy"):
    """The program's inputs for n requests on a cuda chip of `cores`
    RASA-WLBP cores."""
    requests = synthetic_trace(n, seed=seed, mean_gap=1, d_model=128, prompt_lens=prompt_lens,
                               decode_steps=(1, 2), decode_batch=8)
    chip = ChipConfig(backend="cuda", n_cores=cores, design="RASA-WLBP",
                      bw_bytes_per_cycle=32.0)
    p, why = jitarb.plan_ex(traffic(requests), chip, policy=policy)
    assert p is not None, why
    return jitarb._inputs([p])


def kernel_equals_plain(args, akw):
    """The kernel on the card and the plain version on the host's CPU, the
    same inputs: every output equal.  Returns the launch's path."""
    kj.reset_launches()
    got = kj.jitarb_cuda(*args, **akw)
    want = kj.jitarb_plain(*(a.cpu() for a in args), **akw)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    (path,) = kj.launch_paths
    return path


def test_resume_from_a_snapshot_mid_trace():
    """Relaxation rounds that resume lanes from snapshots in the middle of
    their traces (rows of up to ~6 ring chunks; the plain version records
    the resumes), bit for bit equal to the plain version."""
    need_cuda()
    args, akw = planned(6, 3, 2, prompt_lens=(128, 256))
    assert int(args[2].max()) > 4 * 256
    resumes = []
    real = kj._Variant._resim

    def spy(self, row_t, nblk, shares, n_sh, tail, sim, fc, cutoff):
        before = list(self.lane_blocks)
        out = real(self, row_t, nblk, shares, n_sh, tail, sim, fc, cutoff)
        resumes.extend(nblk[c] - (self.lane_blocks[c] - before[c])
                       for c in range(self.C) if sim[c])
        return out

    kj._Variant._resim = spy
    try:
        assert kernel_equals_plain(args, akw) == ("shared", "all")
    finally:
        kj._Variant._resim = real
    assert any(0 < k0 for k0 in resumes)


def test_eight_cores_at_the_largest_shared_table():
    """C = 8 with the window S whose C x S shares just fill the shared
    memory beside the eight warps' rings, and one epoch more (the shares
    then live in device memory): both equal the plain version."""
    need_cuda()
    args, akw = planned(8, 3, 8)
    s_max = kj.share_capacity(8) // 8
    assert s_max >= akw["S"]
    assert kernel_equals_plain(args, {**akw, "S": s_max})[0] == "shared"
    assert kernel_equals_plain(args, {**akw, "S": s_max + 1})[0] == "global"


def test_slow_divisions():
    """An issue rate of 3: the division on the card, taken a step ahead,
    equals the plain version's.  (The epoch is always a power of two: the
    planner takes no other and the wrapper refuses one.)"""
    need_cuda()
    args, akw = planned(6, 3, 2, prompt_lens=(32, 64))

    def with_lanes(**fields):
        lane_f = args[6].clone()
        for name, x in fields.items():
            lane_f[:, fsk.LANE_FIELDS.index(name)] = x
        return args[:6] + (lane_f,) + args[7:]

    slow_issue = with_lanes(issue=3.0, issue_pow2=0.0)
    assert kernel_equals_plain(slow_issue, akw)[1] == "none"
