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
