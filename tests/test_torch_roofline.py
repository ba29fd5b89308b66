"""The port's roofline (``roofline/analysis.py``) against the reference's.

Under the reference's hardware (``V5E``) every field of ``analyze_cell``,
``analyze_all`` and ``format_report`` equals the reference's on the
synthetic artifacts of tests/test_roofline.py (``analyze_all`` reads them
from a directory); ``model_flops_for`` equals the reference's for all 40
(arch, shape) pairs; and a cell finalized with the default ``H100``
divides its MFU by 989 TFLOP/s (the reference divides by v5e's peak
whatever the cell was finalized with).
"""

import dataclasses
import json

import pytest

from repro.roofline import analysis as ref
from repro_torch.configs import ARCH_NAMES, SHAPES
from repro_torch.roofline import analysis as port

FIELDS = [f.name for f in dataclasses.fields(ref.CellRoofline)]
PROPERTIES = ("dominant", "step_time_s", "mfu", "useful_flops_ratio")


def _cell(flops=1e12, byts=1e11, coll=1e9, devices=256, unit=1, total=10,
          arch="qwen3-1.7b", shape="train_4k"):
    """tests/test_roofline.py's synthetic artifact."""
    return {
        "arch": arch, "shape": shape, "devices": devices,
        "unit_layers": unit, "total_layers": total,
        "cost_per_device": {"flops": flops, "bytes_accessed": byts},
        "collectives_per_device_bytes": {"all-reduce": coll, "all-reduce_count": 4},
        "memory": {"peak_bytes_per_device": 8 * 2**30},
    }


def assert_same(got, want):
    for name in FIELDS:
        assert getattr(got, name) == getattr(want, name), name
    for name in PROPERTIES:
        assert getattr(got, name) == getattr(want, name), name


CASES = {
    "compute": dict(cell=_cell(flops=1e14)),
    "memory": dict(cell=_cell(flops=1e9, byts=1e12)),
    "collective": dict(cell=_cell(flops=1e9, byts=1e9, coll=1e12)),
    "extrapolated": dict(cell=_cell(), d0=_cell(flops=2e10, byts=1e9, coll=1e8),
                         du=_cell(flops=3e10, byts=2e9, coll=3e8)),
    "hybrid_unit": dict(cell=_cell(arch="zamba2-2.7b", shape="long_500k", unit=6, total=54,
                                   devices=512),
                        d0=_cell(flops=5e9), du=_cell(flops=4e11, byts=3e10, coll=2e9)),
    "moe_decode": dict(cell=_cell(arch="grok-1-314b", shape="decode_32k", flops=7e12)),
}


@pytest.mark.parametrize("case", CASES)
def test_analyze_cell_equals_reference_under_v5e(case):
    kw = CASES[case]
    want = ref.analyze_cell(kw["cell"], ref.V5E, d0=kw.get("d0"), du=kw.get("du"))
    got = port.analyze_cell(kw["cell"], port.V5E, d0=kw.get("d0"), du=kw.get("du"))
    assert_same(got, want)
    assert got.hw == port.V5E


def _write_results(path):
    cells = {("qwen3-1.7b", "train_4k"): _cell(flops=1e14),
             ("gemma-2b", "decode_32k"): _cell(arch="gemma-2b", shape="decode_32k",
                                               flops=1e9, byts=1e12),
             ("zamba2-2.7b", "long_500k"): _cell(arch="zamba2-2.7b", shape="long_500k",
                                                 unit=6, total=54)}
    for (arch, shape), cell in cells.items():
        for pod in ("pod1", "pod2"):
            (path / f"{arch}__{shape}__{pod}.json").write_text(json.dumps(cell))
    # layer-cost artifacts of one cell (the extrapolation), a skipped cell
    (path / "qwen3-1.7b__train_4k__pod1__d0.json").write_text(json.dumps(_cell(flops=2e10)))
    (path / "qwen3-1.7b__train_4k__pod1__d1.json").write_text(json.dumps(_cell(flops=3e10)))
    (path / "gemma-2b__long_500k__pod1.json").write_text(json.dumps(
        {"arch": "gemma-2b", "shape": "long_500k", "skipped": True, "reason": "x"}))


@pytest.mark.parametrize("multi_pod", [False, True])
def test_analyze_all_and_report_equal_reference_under_v5e(tmp_path, multi_pod):
    _write_results(tmp_path)
    want = ref.analyze_all(tmp_path, multi_pod)
    got = port.analyze_all(tmp_path, multi_pod, hw=port.V5E)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert_same(g, w)
    assert got[0].extrapolated                    # the single-pod d0 / d1 serve both meshes
    assert port.format_report(got, port.V5E) == ref.format_report(want, ref.V5E)


def test_port_artifacts_are_taken_as_totals(tmp_path):
    """An artifact of the port's dry run counts every layer: analyze_all
    takes its numbers and leaves its layer-cost artifacts aside."""
    _write_results(tmp_path)
    cell = {**_cell(flops=1e14), "counts_every_layer": True}
    (tmp_path / "qwen3-1.7b__train_4k__pod1.json").write_text(json.dumps(cell))
    got = port.analyze_all(tmp_path)[0]
    assert (got.flops_per_device, got.extrapolated) == (1e14, False)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_model_flops_equal_reference(arch):
    for shape in SHAPES:
        assert port.model_flops_for(arch, shape) == ref.model_flops_for(arch, shape)


def test_h100_is_the_default_and_its_mfu_divides_by_its_peak():
    assert (port.H100.peak_flops, port.H100.hbm_bw, port.H100.ici_bw,
            port.H100.hbm_bytes) == (989e12, 3.35e12, 450e9, 80e9)
    assert dataclasses.astuple(port.V5E) == dataclasses.astuple(ref.V5E)
    assert port.COLL_OPS == ref.COLL_OPS
    r = port.analyze_cell(_cell(flops=1e14))
    assert r.hw == port.H100
    assert r.compute_s == 1e14 / 989e12 and r.memory_s == 1e11 / 3.35e12
    assert r.collective_s == 1e9 / 450e9
    assert r.mfu == r.model_flops / (r.step_time_s * r.devices * 989e12)
    # the reference divides by v5e's peak whatever the cell was finalized with
    w = ref.analyze_cell(_cell(flops=1e14), ref.HW(peak_flops=989e12))
    assert w.mfu == w.model_flops / (w.step_time_s * w.devices * ref.V5E.peak_flops)
