"""Pure helpers of chip_smoke.py, on the CPU."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402


@pytest.mark.parametrize("spans,want", [
    ([], 0.0),
    ([(0.0, 10.0)], 10.0),
    ([(0.0, 10.0), (20.0, 25.0)], 15.0),              # apart: the sum
    ([(0.0, 10.0), (5.0, 12.0), (20.0, 25.0)], 17.0),  # overlapping: counted once
    ([(5.0, 12.0), (0.0, 10.0)], 12.0),              # any order
    ([(0.0, 10.0), (2.0, 3.0)], 10.0),               # nested
])
def test_busy_us_is_the_union_of_intervals(spans, want):
    assert chip_smoke.busy_us(spans) == want


@pytest.mark.parametrize("records,want", [
    (set(), []),
    ({"void (anonymous namespace)::tc::flash_fwd_tc<128, 2>(...)"}, ["flash_fwd_tc"]),
    ({"void (anonymous namespace)::flash_fwd_kernel<8>(...)", "Memset (Device)"},
     ["flash_fwd_kernel"]),
    ({"flash_fwd_tc<64, 1>", "flash_fwd_kernel<4>"},
     ["flash_fwd_kernel", "flash_fwd_tc"]),
])
def test_timed_kernels_reads_record_names(records, want):
    assert chip_smoke.timed_kernels(records, ("flash_fwd_tc", "flash_fwd_kernel")) == want


GEMM = ("decode_kernel", "tile_kernel")


@pytest.mark.parametrize("records,calls,want", [
    ({}, 1, {"kernels": 0.0, "other": {}}),
    ({"void (anonymous namespace)::dec::decode_kernel<false, __nv_bfloat16>(...)": 0.6},
     3, {"kernels": 0.2, "other": {}}),
    # a wrapper's fill is its own record; two kernel names add up
    ({"decode_kernel<true, float>": 0.4, "tile_kernel<128>": 0.2,
      "void at::native::vectorized_elementwise_kernel<...>": 0.1},
     2, {"kernels": 0.3, "other": {"void at::native::vectorized_elementwise_kernel<...>": 0.05}}),
    # CUDA-event fallback: names without times
    ({"decode_kernel<false, float>": None, "Memset (Device)": None},
     1, {"kernels": None, "other": {"Memset (Device)": None}}),
])
def test_record_split_groups_kernel_and_other_records(records, calls, want):
    got = chip_smoke.record_split(records, GEMM, calls)
    assert got.keys() == want.keys() and got["other"].keys() == want["other"].keys()
    if want["kernels"] is None:
        assert got == want
    else:
        assert got["kernels"] == pytest.approx(want["kernels"])
        for k, v in want["other"].items():
            assert got["other"][k] == pytest.approx(v)


@pytest.mark.parametrize("byte_ms,ms,want", [(0.186, 0.186, 1.0), (0.186, 0.372, 0.5),
                                             (2.5e-3, 1e-2, 0.25)])
def test_hbm_share_is_bytes_time_over_time(byte_ms, ms, want):
    assert chip_smoke.hbm_share(byte_ms, ms) == pytest.approx(want)
