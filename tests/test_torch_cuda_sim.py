"""The simulator's CUDA scan kernels against the port's numpy lane and
their plain PyTorch versions, on the card.

Marked ``cuda``; each test decides inside itself whether a CUDA device is
present and skips without one.  This file imports no jax and nothing of
the JAX package, so it also runs on a GPU host that has neither:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_sim.py
"""

import dataclasses
import math
import random

import numpy as np
import pytest
import torch

from _sim_streams import random_stream
from repro_torch.core import DESIGNS, TABLE_I, GemmSpec, isa
from repro_torch.core import fastsim
from repro_torch.core import simulator as sim
from repro_torch.core.trace import compile_stream
from repro_torch.kernels import fastsim_scan as fsk

pytestmark = pytest.mark.cuda
NAMES = sorted(DESIGNS)
CFGS = [DESIGNS[n] for n in NAMES]
P = fastsim.StreamModelParams
PARAMS = {"port_stores": P(2, 1),
          "epoch": P(2, 1, (8.0, 16.0, 48.0), 256.0, 64.0, 2048.0, True),
          "static": P(2, 1, (), math.inf, 12.0, 1024.0, True)}


def need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def traces(seeds, n=300):
    return [compile_stream(random_stream(random.Random(s), n, isa)) for s in seeds]


def key(res, last_grant=None):
    k = (res.cycles, res.n_mm, res.n_tl, res.n_ts, res.wl_skips, res.useful_macs,
         res.bw_stall_cycles)
    return k if last_grant is None else k + (last_grant,)


@pytest.mark.parametrize("model", list(PARAMS))
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scan_sweep_layout(seed, model):
    need_cuda()
    (tr,) = traces([seed])
    p = PARAMS[model]
    want = [fastsim._run_numpy_params(tr, c, p)[0] for c in CFGS]
    before = fsk.launches["scan"]
    got = fastsim.sweep_trace(tr, CFGS, p, backend="cuda")
    assert fsk.launches["scan"] == before + 1
    assert [key(g) for g in got] == [key(w) for w in want]
    lanes = [(0, c, p) for c in CFGS]
    kernel, _ = fastsim._scan([tr], lanes, "cuda", "cuda")
    plain, _ = fastsim._scan([tr], lanes, "torch", "cuda")
    np.testing.assert_array_equal(kernel, plain)


@pytest.mark.parametrize("model", list(PARAMS))
def test_scan_cores_layout(model):
    need_cuda()
    trs = traces([3, 4, 5, 6]) + traces([7], n=50)
    base = PARAMS[model]
    params = [P(2, 1, tuple(s * (k + 1) for s in base.shares), base.epoch_cycles,
                base.tail_share if math.isinf(base.tail_share) else base.tail_share + k,
                base.burst_bytes, base.charge_store_bytes) for k in range(len(trs))]
    cfg = DESIGNS["RASA-DMDB-WLS"]
    want = [fastsim._run_numpy_params(t, cfg, p) for t, p in zip(trs, params)]
    got = fastsim.run_cores(trs, cfg, params, backend="cuda")
    assert [key(r, lg) for r, lg in got] == [key(r, lg) for r, lg in want]
    lanes = [(k, cfg, p) for k, p in enumerate(params)]
    kernel, _ = fastsim._scan(trs, lanes, "cuda", "cuda")
    plain, _ = fastsim._scan(trs, lanes, "torch", "cuda")
    np.testing.assert_array_equal(kernel, plain)


@pytest.mark.parametrize("model", list(PARAMS))
def test_scan_packed_layout(model):
    need_cuda()
    trs = traces([8, 9, 10], n=200)
    p = PARAMS[model]
    want = [[fastsim._run_numpy_params(t, c, p)[0] for c in CFGS] for t in trs]
    got = fastsim.sweep_traces(trs, CFGS, p, backend="cuda")
    assert [[key(g) for g in row] for row in got] == [[key(w) for w in row] for row in want]
    packed, _, _ = fastsim._pack_lane(trs)
    lanes = [(0, c, p) for c in CFGS]
    _, kernel = fastsim._scan([packed], lanes, "cuda", "cuda", n_seg=3)
    _, plain = fastsim._scan([packed], lanes, "torch", "cuda", n_seg=3)
    np.testing.assert_array_equal(kernel, plain)


def test_mm_scan_gemms_and_random_streams():
    need_cuda()
    specs = [GemmSpec("small", 128, 256, 256), TABLE_I["DLRM-2"], GemmSpec("odd", 200, 96, 150)]
    want = sim.sweep_workload(specs, backend="numpy")
    before = fsk.launches["mm_scan"]
    got = sim.sweep_workload(specs, backend="cuda")
    assert fsk.launches["mm_scan"] == before + 1          # every (trace, design) lane at once
    assert got == want
    trs = traces([11, 12])
    want = [[fastsim._run_numpy_params(t, c, P.for_config(c))[0] for c in CFGS] for t in trs]
    got = fastsim.sweep_traces(trs, CFGS, backend="cuda")
    assert [[key(g) for g in row] for row in got] == [[key(w) for w in row] for row in want]


def test_mm_scan_kernel_equals_plain():
    need_cuda()
    trs = traces([13, 14, 15])
    calls = {}
    real = fsk.fastsim_mm_scan

    def spy(*args, **kw):
        calls["args"] = args
        return real(*args, **kw)

    fsk.fastsim_mm_scan = spy
    try:
        fastsim.sweep_traces(trs, CFGS, backend="cuda")
    finally:
        fsk.fastsim_mm_scan = real
    args = calls["args"]
    np.testing.assert_array_equal(fsk.fastsim_mm_scan_cuda(*args).cpu(),
                                  fsk.fastsim_mm_scan_plain(*args).cpu())


def test_unreachable_grant_raises_on_the_card():
    need_cuda()
    (tr,) = traces([2], n=60)
    p = P(2, 1, (8.0,), 64.0, 1.0, 512.0, True)
    object.__setattr__(p, "tail_share", 0.0)
    with pytest.raises(RuntimeError, match="can never be granted"):
        fastsim._run_numpy_params(tr, DESIGNS["RASA-WLBP"], p)
    with pytest.raises(RuntimeError, match="can never be granted"):
        fastsim.sweep_trace(tr, CFGS[:2], p, backend="cuda")


def test_wrappers_refuse_bad_inputs():
    need_cuda()
    dev = torch.device("cuda")
    lane_f = torch.zeros((1, len(fsk.LANE_FIELDS)), dtype=torch.float64, device=dev)
    lane_f[0, 3] = 16.0
    shares = torch.zeros(1, dtype=torch.float64, device=dev)
    val = torch.zeros(2, dtype=torch.float64, device=dev)
    bad_reg = torch.tensor([fsk.OP_TL | 9 << 4, fsk.OP_MM], dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="register ids"):
        fsk.fastsim_scan_cuda(bad_reg, val, lane_f, torch.tensor([[0, 2, 0, 0]], device=dev),
                              shares, bucket=False)
    ends = torch.tensor([fsk.OP_END, fsk.OP_END], dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="OP_END"):
        fsk.fastsim_scan_cuda(ends, val, lane_f, torch.tensor([[0, 2, 0, 0]], device=dev),
                              shares, bucket=False, n_seg=1)
    with pytest.raises(ValueError, match="outside"):
        fsk.fastsim_scan_cuda(ends, val, lane_f, torch.tensor([[0, 3, 0, 0]], device=dev),
                              shares, bucket=False, n_seg=2)
    with pytest.raises(TypeError):
        fsk.fastsim_scan_cuda(ends.long(), val, lane_f,
                              torch.tensor([[0, 2, 0, 0]], device=dev), shares, bucket=False)


def scan_both(args, bucket, n_seg=0):
    """The kernel and its plain version (on the card) on the same inputs."""
    kernel = fsk.fastsim_scan_cuda(*args, bucket=bucket, n_seg=n_seg)
    plain = fsk.fastsim_scan_plain(*args, bucket=bucket, n_seg=n_seg)
    for k, p in zip(kernel, plain):
        assert torch.equal(k.cpu(), p.cpu())
    return kernel


@pytest.mark.parametrize("model", list(PARAMS))
def test_scan_odd_lo_and_a_ragged_tail(model):
    """Lanes that start at odd positions of the columns (a first trace of
    odd length, a lane starting mid-trace), a trace of ~13 ring chunks, and
    columns whose length is not a multiple of 4 (the ring reads the last
    positions itself): the kernel equals its plain version, and the numpy
    lane on a whole trace; columns off a 16-byte edge are copied first."""
    need_cuda()
    short, = traces([21], n=293)
    long_, = traces([22], n=3300)
    p = PARAMS[model]
    cfgs = CFGS[:3]
    lanes = [(0, c, p) for c in cfgs] + [(1, c, p) for c in cfgs]
    args, bucket = fastsim.scan_inputs([short, long_], lanes, "cuda")
    n_col = args[0].numel()
    assert n_col % 4 and len(short) % 2 and args[3][3, 0] % 2
    args[3][0, 0] = 7                        # a lane from the middle of the first trace
    out, _ = scan_both(args, bucket)
    want = [fastsim._run_numpy_params(long_, c, p)[0] for c in cfgs]
    assert out[3:, 0].tolist() == [w.cycles for w in want]
    # the columns one position on (off their 16-byte edge), the lanes that
    # start past position 0
    keep = [0, 3, 4, 5]
    shifted = (args[0][1:], args[1][1:], args[2][keep],
               args[3][keep] - torch.tensor([1, 1, 0, 0], device="cuda"), args[4])
    assert args[0][1:].data_ptr() % 16
    kernel, _ = fsk.fastsim_scan_cuda(*shifted, bucket=bucket)
    assert torch.equal(kernel, out[keep])


def test_mm_scan_odd_lo_and_a_ragged_tail():
    """The MM-only kernel's ring at its edges: a lane that starts at an odd
    row in the middle of a block, a lane shorter than one chunk and one with
    no rows, a block of ~13 chunks that starts at an odd row, and columns
    whose row count is not a multiple of 4 (the thread reads the last rows
    itself): the kernel equals its plain version, and the numpy lane on
    whole traces; columns off a 16-byte edge are copied first."""
    need_cuda()
    short, long_ = traces([31], n=297) + traces([32], n=6050)
    cfgs = CFGS[:3]
    cols, where, _ = fastsim.mm_scan_inputs([short, long_], cfgs, None)
    args = tuple(torch.as_tensor(c, device="cuda") for c in cols)
    rows = args[3]
    n_short = int(rows[0, 1])
    assert args[0].numel() % 4 and n_short % 2 and n_short < 256
    assert [t for t, _, _ in where] == [0, 0, 0, 1, 1, 1]
    assert int(rows[3, 1] - rows[3, 0]) > 12 * 256
    rows[0, 0] = 7                           # from an odd row in the middle of a block
    rows[1] = torch.tensor([50, 50])         # no rows
    rows[4, 0] = n_short + 1000              # from an odd row in the middle of the long block
    kernel = fsk.fastsim_mm_scan_cuda(*args)
    assert torch.equal(kernel.cpu(), fsk.fastsim_mm_scan_plain(*args).cpu())
    assert kernel[1].tolist() == [0.0, 0.0]
    # the columns one row on (off their 16-byte edge), the lanes that start
    # past row 0
    keep = [0, 3, 4, 5]
    shifted = (args[0][1:], args[1][1:], args[2][keep], rows[keep] - 1)
    assert args[0][1:].data_ptr() % 16
    assert torch.equal(fsk.fastsim_mm_scan_cuda(*shifted), kernel[keep])
    want = [[fastsim._run_numpy_params(t, c, P.for_config(c))[0] for c in cfgs]
            for t in (short, long_)]
    got = fastsim.sweep_traces([short, long_], cfgs, backend="cuda")
    assert [[key(g) for g in row] for row in got] == [[key(w) for w in row] for row in want]


def test_scan_shares_past_the_shared_table():
    """A lane with more epoch shares than a CTA stages reads them from
    device memory (the launch reports it), beside a lane whose shares fit;
    both equal the plain version and the numpy lane."""
    need_cuda()
    tr, = traces([23], n=400)
    many = P(2, 1, tuple(8.0 + (k % 7) for k in range(10_000)), 16.0, 32.0, 1024.0, True)
    few = PARAMS["epoch"]
    cfg = DESIGNS["RASA-DMDB-WLS"]
    lanes = [(0, cfg, many), (0, cfg, few)]
    args, bucket = fastsim.scan_inputs([tr], lanes, "cuda")
    fsk.reset_launches()
    out, _ = scan_both(args, bucket)
    assert [path[1] for path in fsk.launch_paths] == ["mixed"]
    want = [fastsim._run_numpy_params(tr, cfg, p) for p in (many, few)]
    assert out[:, 0].tolist() == [w[0].cycles for w in want]
    assert out[:, 3].tolist() == [w[1] for w in want]
    fsk.reset_launches()
    got = fastsim.sweep_trace(tr, CFGS, many, backend="cuda")
    assert [path[1] for path in fsk.launch_paths] == ["global"]
    assert [key(g) for g in got] == [key(fastsim._run_numpy_params(tr, c, many)[0])
                                     for c in CFGS]


@pytest.mark.parametrize("layout", ["sweep", "packed"])
def test_scan_slow_divisions(layout):
    """An epoch of 1000 cycles and an issue rate of 3 (neither a power of
    two: py_floordiv and the division, taken a step ahead): the kernel
    equals its plain version and the numpy lane, and the launch reports the
    slow paths."""
    need_cuda()
    trs = traces([24, 25], n=250)
    p = P(2, 1, (8.0, 16.0, 48.0, 24.0), 1000.0, 64.0, 2048.0, True)
    cfgs = [dataclasses.replace(c, core_issue_width=3, core_clock_hz=c.engine_clock_hz)
            for c in CFGS[:4]]
    assert all(c.core_issue_width * c.core_clock_hz / c.engine_clock_hz == 3.0 for c in cfgs)
    fsk.reset_launches()
    if layout == "sweep":
        got = [fastsim.sweep_trace(t, cfgs, p, backend="cuda") for t in trs]
    else:
        got = fastsim.sweep_traces(trs, cfgs, p, backend="cuda")
    assert {path[2:] for path in fsk.launch_paths} == {("none", "none")}
    want = [[fastsim._run_numpy_params(t, c, p)[0] for c in cfgs] for t in trs]
    assert [[key(g) for g in row] for row in got] == [[key(w) for w in row] for row in want]
    packed, _, _ = fastsim._pack_lane(trs)
    args, bucket = fastsim.scan_inputs([packed], [(0, c, p) for c in cfgs], "cuda")
    scan_both(args, bucket, n_seg=len(trs))


def test_scan_packed_unequal_segments():
    """Packed segments of unequal lengths (one empty, one of ~10 chunks):
    one CTA a segment, each row equal to the plain version's and to the
    numpy lane's, the lane's walks the sum of its segments'."""
    need_cuda()
    trs = traces([26], n=40) + [compile_stream([])] + traces([27], n=2600) \
        + traces([28], n=150)
    p = PARAMS["epoch"]
    packed, _, _ = fastsim._pack_lane(trs)
    args, bucket = fastsim.scan_inputs([packed], [(0, c, p) for c in CFGS], "cuda")
    fsk.reset_launches()
    out, seg = scan_both(args, bucket, n_seg=len(trs))
    assert [path[0] for path in fsk.launch_paths] == [len(CFGS) * (len(trs) + 1)]
    assert torch.equal(out[:, 4], seg[:, :, 4].sum(0))
    got = fastsim.sweep_traces(trs, CFGS, p, backend="cuda")
    want = [[fastsim._run_numpy_params(t, c, p)[0] for c in CFGS] for t in trs]
    assert [[key(g) for g in row] for row in got] == [[key(w) for w in row] for row in want]


def test_scan_never_granted_in_a_middle_segment():
    """A packed lane whose middle segment outlives a schedule with no tail
    share raises the numpy lane's error on the card, though the segments
    around it run to their ends."""
    need_cuda()
    p = P(2, 1, (64.0,) * 16, 64.0, 1.0, 512.0, True)
    object.__setattr__(p, "tail_share", 0.0)
    cfg = DESIGNS["RASA-WLBP"]
    first, middle, last = traces([20], n=20) + traces([300], n=300) + traces([40], n=40)
    fastsim._run_numpy_params(first, cfg, p)
    fastsim._run_numpy_params(last, cfg, p)
    with pytest.raises(RuntimeError, match="can never be granted"):
        fastsim._run_numpy_params(middle, cfg, p)
    with pytest.raises(RuntimeError, match="can never be granted"):
        fastsim.sweep_traces([first, middle, last], [cfg], p, backend="cuda")
