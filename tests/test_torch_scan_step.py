"""The host side of the simulator's scan step on the card: the exact floor
division the kernels take for power-of-two epochs, the flags that select
it, the chain table that runs each packed segment on a CTA of its own, and
how the chains' results compose into a lane's (all on the CPU, through the
plain versions; the kernels themselves run in tests/test_torch_cuda_sim.py
and tests/test_torch_cuda_batcher.py)."""

import dataclasses
import math
import random

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from _sim_streams import random_stream
from repro.core import fastsim as ref_fastsim
from repro_torch.core import DESIGNS, fastsim, isa
from repro_torch.core.trace import compile_stream
from repro_torch.kernels import fastsim_scan as fsk
from repro_torch.kernels import jitarb as kj
from repro_torch.multicore import ChipConfig, jitarb
from repro_torch.serving.simbatch import synthetic_trace

P = fastsim.StreamModelParams
EPOCHS = [2.0 ** k for k in range(-4, 21)] + [math.inf]


def bits(x: float) -> bytes:
    return np.float64(x).tobytes()


@settings(max_examples=400, deadline=None)
@given(t=st.floats(min_value=0.0, allow_infinity=False, allow_nan=False),
       e=st.sampled_from(EPOCHS))
def test_floor_division_identity(t, e):
    """For a finite t >= 0 and E a power of two or inf, Python's t // E is
    floor(t * (1 / E)) bit for bit: the product the kernels take (and
    inf on both sides where t / E overflows)."""
    with np.errstate(over="ignore"):
        assert bits(np.floor(np.float64(t) * (1.0 / np.float64(e)))) == bits(t // e)


@given(t=st.integers(min_value=0, max_value=2 ** 40).map(float) | st.floats(0.0, 1e7))
def test_floor_division_identity_at_the_chips_epoch(t):
    """The same at the chip's own epoch of 1024 cycles, on whole and
    fractional cycle counts."""
    assert bits(np.floor(t * (1.0 / 1024.0))) == bits(t // 1024.0)


@pytest.mark.parametrize("x,want", [
    (1024.0, True), (math.inf, True), (4.0, True), (16.0, True), (0.0625, True),
    (1000.0, False), (3.0, False), (0.0, False), (-4.0, False), (-math.inf, False),
    (math.nan, False), (5e-324, False), (2.0 ** 1023, True), (2.0 ** -1022, True)])
def test_pow2_or_inf(x, want):
    assert fsk.pow2_or_inf(x) is want


@pytest.mark.parametrize("epoch,issue_width,flags", [
    (1024.0, 4, (1.0, 1.0)), (math.inf, 4, (1.0, 1.0)), (1000.0, 4, (0.0, 1.0)),
    (1024.0, 3, (1.0, 0.0))])
def test_lane_rows_carry_the_flags(epoch, issue_width, flags):
    """A lane row's last two fields flag its epoch and its issue rate
    (issue width x core clock / engine clock: 16, or 12 at width 3)."""
    cfg = dataclasses.replace(DESIGNS["RASA-WLBP"], core_issue_width=issue_width)
    shares = () if math.isinf(epoch) else (8.0, 16.0)
    row = fastsim._lane_row(cfg, P(2, 1, shares, epoch, 32.0, 1024.0, True))
    f = dict(zip(fsk.LANE_FIELDS, row))
    assert (f["epoch_pow2"], f["issue_pow2"]) == flags
    assert len(row) == len(fsk.LANE_FIELDS)


def empty():
    """A segment of no instructions (random_stream starts with 8 loads)."""
    return compile_stream([])


def packed_lane(rng: random.Random, n_seg: int, trailing: int):
    """A packed lane of n_seg random segments (some empty), then `trailing`
    instructions after its last marker; its code column and the marker
    positions _pack_lane reports."""
    segs = [empty() if rng.random() < 0.3 else
            compile_stream(random_stream(random.Random(rng.randrange(10 ** 6)),
                                         rng.choice([0, 3, 17, 40]), isa))
            for _ in range(n_seg)]
    code, ends = np.zeros(0, np.int32), []         # no segment: a lane with no marker
    if segs:
        packed, _, ends = fastsim._pack_lane(segs)
        code, _ = fastsim._trace_columns(packed)
    if trailing:
        tail = compile_stream(random_stream(random.Random(rng.randrange(10 ** 6)), trailing,
                                            isa))
        code = np.concatenate([code, fastsim._trace_columns(tail)[0]])
    return code, ends


def markers_of(code: np.ndarray) -> np.ndarray:
    return np.flatnonzero((code & 7) == fsk.OP_END)


@pytest.mark.parametrize("seed", range(8))
def test_chain_table_splits_at_pack_lanes_ends(seed):
    """Random packed lanes, each at its own offset in one column: every
    lane's chains are its segments, in order, bounded by _pack_lane's
    marker positions (empty segments included), then its trailing part."""
    rng = random.Random(seed)
    cols, ranges, want = [], [], []
    off = 0
    for lane in range(4):
        n_seg, trailing = rng.randrange(0, 5), rng.choice([0, 0, 5])
        code, ends = packed_lane(rng, n_seg, trailing)
        pad = rng.randrange(0, 3)           # a lane need not start at the column's start
        cols += [np.zeros(pad, np.int32), code]
        lo = off + pad
        hi = lo + len(code)
        ranges.append((lo, hi))
        starts = [lo] + [lo + e + 1 for e in ends]
        stops = [lo + e for e in ends] + [hi]
        want += [(lane, a, b, k if k < n_seg else -1)
                 for k, (a, b) in enumerate(zip(starts, stops))]
        off = hi
    column = np.concatenate(cols)
    got = fsk.chain_table(np.asarray(ranges), markers_of(column))
    assert got.dtype == np.int64 and got.shape == (len(want), 4)
    assert [tuple(r) for r in got.tolist()] == want


def test_chain_table_edge_cases():
    """An empty segment between two markers, a lane with no marker in its
    range, a trailing part after the last marker, and lanes that do not
    emit (one chain each, segment -1)."""
    code = np.array([0, fsk.OP_END, fsk.OP_END, 2, 2, 0], dtype=np.int32)
    got = fsk.chain_table(np.array([[0, 6], [3, 6], [2, 2]]), markers_of(code))
    assert got.tolist() == [[0, 0, 1, 0], [0, 2, 2, 1], [0, 3, 6, -1],
                            [1, 3, 6, -1], [2, 2, 2, -1]]
    got = fsk.chain_table(np.array([[0, 6], [3, 5]]), None)
    assert got.tolist() == [[0, 0, 6, -1], [1, 3, 5, -1]]
    assert fsk.chain_table(np.zeros((0, 2), np.int64), markers_of(code)).shape == (0, 4)


def chains_through_the_plain_version(args, bucket, n_seg):
    """The kernel's composition, each chain through the plain version as a
    lane of its own: a segment's row from its chain, the lane's row from its
    trailing part, the lane's walks the sum over its chains."""
    code, val, lane_f, lane_i, shares = args
    markers = markers_of(code.numpy()) if n_seg else None
    chains = fsk.chain_table(lane_i[:, :2].numpy(), markers)
    lane = torch.as_tensor(chains[:, 0])
    c_lane_i = torch.cat([torch.as_tensor(chains[:, 1:3]), lane_i[lane, 2:]], 1)
    c_out, _ = fsk.fastsim_scan_plain(code, val, lane_f[lane], c_lane_i, shares, bucket=bucket)
    n = lane_f.shape[0]
    out = torch.zeros((n, len(fsk.OUT_FIELDS)), dtype=torch.float64)
    seg_out = torch.zeros((n_seg, n, len(fsk.OUT_FIELDS)), dtype=torch.float64)
    for (ln, _, _, seg), row in zip(chains.tolist(), c_out):
        if seg >= 0:
            seg_out[seg, ln] = row
        else:
            out[ln, :4] = row[:4]
        out[ln, 4] += row[4]
    return out, seg_out


@pytest.mark.parametrize("model", ["epoch", "static", "port"])
def test_chains_compose_to_the_packed_lane(model):
    """Running a packed lane's segments as independent chains and composing
    their rows gives the sequential lane's rows bit for bit: the split the
    kernel launches changes no output (unequal segments, one of them empty,
    and a trailing part)."""
    p = {"epoch": P(2, 1, (8.0, 16.0, 48.0), 256.0, 64.0, 2048.0, True),
         "static": P(2, 1, (), math.inf, 12.0, 1024.0, True),
         "port": P(2, 1)}[model]
    rng = random.Random(5)
    segs = [compile_stream(random_stream(random.Random(s), n, isa))
            for s, n in ((1, 70), (3, 25), (4, 120))]
    segs.insert(1, empty())
    packed, _, _ = fastsim._pack_lane(segs)
    tail = compile_stream(random_stream(rng, 30, isa))
    cfgs = [DESIGNS[n] for n in ("BASE", "RASA-WLBP", "RASA-DMDB-WLS")]
    lanes = [(0, c, p) for c in cfgs] + [(1, cfgs[0], p)]
    args, bucket = fastsim.scan_inputs([packed, tail], lanes, "cpu")
    # the first three lanes: the packed segments, then the tail's instructions
    args[3][:3, 1] = args[3][3, 1]
    want = fsk.fastsim_scan_plain(*args, bucket=bucket, n_seg=len(segs))
    got = chains_through_the_plain_version(args, bucket, len(segs))
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=0)


def test_lane_errors_keep_the_first_chain_in_order():
    """err_out keeps the least (chain order * 4 + code) of a lane's chains:
    the wrapper reads the code of its first failing chain, and 0 for a lane
    with none, as the sequential lane stopped at its first error."""
    none = fsk._NO_ERROR
    slots = torch.tensor([none, 1 * 4 + fsk.ERR_NO_PROGRESS, 0 * 4 + fsk.ERR_NEVER_GRANTED,
                          (1 << 28) * 4 + fsk.ERR_NO_PROGRESS], dtype=torch.int32)
    assert fsk._lane_errors(slots).tolist() == [0, fsk.ERR_NO_PROGRESS,
                                                fsk.ERR_NEVER_GRANTED, fsk.ERR_NO_PROGRESS]


def test_program_results_do_not_depend_on_a_larger_window():
    """The program's results and counters with its window S doubled equal
    those at the planned S (the card tests widen S to fill or overflow the
    shared-memory share table)."""
    reqs = synthetic_trace(4, seed=2, mean_gap=1, d_model=128, prompt_lens=(16,),
                           decode_steps=(1,), decode_batch=8)
    chip = ChipConfig(backend="torch", device="cpu", n_cores=2, design="RASA-WLBP",
                      bw_bytes_per_cycle=32.0)
    plan, why = jitarb.plan_ex([(r.arrival_epoch, r.specs) for r in reqs], chip,
                               policy="occupancy")
    assert plan is not None, why
    args, kw = jitarb._inputs([plan])
    want = kj.jitarb_plain(*args, **kw)
    got = kj.jitarb_plain(*args, **{**kw, "S": 2 * kw["S"]})
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.parametrize("E,refused", [(1000.0, True), (3.0, True), (0.0, True),
                                       (1024.0, False), (math.inf, False)])
def test_program_wrapper_takes_power_of_two_epochs_only(E, refused):
    """The kernel's epoch index is floor(t * (1 / E)) without a flag: its
    wrapper refuses an E that is not a power of two or inf before anything
    else (an accepted E goes on to the device check, which CPU tensors
    fail)."""
    reqs = synthetic_trace(3, seed=2, mean_gap=1, d_model=128, prompt_lens=(16,),
                           decode_steps=(1,), decode_batch=8)
    chip = ChipConfig(backend="torch", device="cpu", n_cores=2, design="RASA-WLBP",
                      bw_bytes_per_cycle=32.0)
    plan, why = jitarb.plan_ex([(r.arrival_epoch, r.specs) for r in reqs], chip,
                               policy="occupancy")
    assert plan is not None, why
    args, kw = jitarb._inputs([plan])
    match = "not a power of two" if refused else "needs tensors on one CUDA device"
    with pytest.raises(ValueError, match=match):
        kj.jitarb_cuda(*args, **{**kw, "E": E})


def test_pack_lane_ends_match_the_reference():
    """The port's _pack_lane puts its markers where the JAX package's does
    (the chain table's segments follow them)."""
    rng = random.Random(9)
    lens = [rng.choice([0, 4, 33]) for _ in range(5)]
    port = [compile_stream(random_stream(random.Random(k), n, isa)) for k, n in enumerate(lens)]
    from repro.core import isa as ref_isa
    from repro.core.trace import compile_stream as ref_compile
    ref = [ref_compile(random_stream(random.Random(k), n, ref_isa))
           for k, n in enumerate(lens)]
    assert fastsim._pack_lane(port)[2] == ref_fastsim._pack_lane(ref)[2]
