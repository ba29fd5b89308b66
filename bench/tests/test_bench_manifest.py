"""BENCHMARK.json against the benchmark's contract, on the CPU: every
cell's files are found by name, names and units use the allowed
characters, every per-layer metric's cells report the end-to-end metric it
moves, every cell runs on one chip, and the result's line is formed as the
contract says."""

import json
import re
from pathlib import Path

import pytest

from bench import harness

ROOT = Path(__file__).resolve().parents[2]
MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in MAN["workloads"]]


def test_top_level_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert MAN["paths"] == ["bench"] and MAN["command"] == ["python3", "bench/run.py"]
    assert isinstance(MAN["run_seconds"], int) and 1 <= MAN["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_and_units():
    names = [e["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for e in MAN[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for w in MAN["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"] and "\t" not in w["why"]
    for c in MAN["configs"]:
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")


def test_entry_keys():
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in MAN["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MAN["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    c = harness.resolve(MAN, cell, ROOT)
    assert c.chips == 1
    assert (ROOT / "bench" / "drivers" / f"{c.traffic['driver']}.py").exists()
    assert (ROOT / "bench" / "reference" / f"{c.config['reference']}.py").exists()
    for m in c.per_layer:
        assert (ROOT / "bench" / "metrics" / f"{m['name']}.py").exists()
        assert callable(harness.metric_reader(m["name"]))
    assert c.limits and all(isinstance(v, float) for k, v in c.limits.items()
                            if k != "readings")
    e2e = {m["name"] for m in c.e2e}
    assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer
    for m in c.per_layer:
        assert m["moves"] in e2e, (cell, m["name"])


def test_configs_files():
    files = [c["file"] for c in MAN["configs"]]
    assert len(files) == len(set(files))
    for c in MAN["configs"]:
        assert c["file"].startswith("bench/")
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert cfg["source"] == c["source"]
        harness.check_sizes(cfg, __import__("repro_torch.configs", fromlist=["x"])
                            .get_config(cfg["arch"]).model)
    used = {w["config"] for w in MAN["workloads"]}
    assert used == {c["name"] for c in MAN["configs"]}


def test_result_line_from_a_fake_record():
    cell = harness.resolve(MAN, "qwen3-decode", ROOT)
    spec = harness.spec_of(cell.config)
    g = sum(x.count for x in __import__("bench.counts", fromlist=["x"]).engine_gemms(spec, 1, 1))
    recs = ([{"name": "void (anonymous namespace)::tc::tile_kernel<64>(x)", "t0": 0.0,
              "t1": 1e-5, "span": 0}] * g + [{"name": "elementwise", "t0": 0.0, "t1": 1e-6,
                                             "span": 0}])
    record = {"spec": spec, "spans": {"decode_step": [(12.5, {}), (13.5, {})]},
              "calls": [("decode_step", {"rows": 64, "head_rows": 64})],
              "trace": {"spans": [{"kind": "decode_step", "t0": 0.0, "t1": 0.02}],
                        "records": recs, "window_s": 0.02, "busy_s": 0.015,
                        "gaps": [["between calls > cudaStreamSynchronize", 0.005]]},
              "window": {"seconds": 30.0, "flops": 1e15}}
    out = harness.Outcome({"setup_s": 20.0, "gen_tokens_per_s": 3000.0}, record, 640, 0,
                          {"max_gap": (0.05, 0.1)}, 123)
    line = harness.result(cell, out, True, "NVIDIA H100 80GB HBM3", 1)
    assert list(line)[-1] == "checks" and line["correct"] is True
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert line["device"]["busy_s"] == 0.015 and line["device"]["window_s"] == 0.02
    assert set(line["metrics"]) == {m["name"] for m in cell.per_layer}
    assert line["metrics"]["decode_step_ms"]["value"] == 13.0
    assert line["metrics"]["kernels_per_step.decode"]["value"] == g + 1
    assert 0 < line["metrics"]["gemm_roofline.decode"]["value"] <= 100
    assert len(line["breakdown"]["device_ops"]) <= 10
    json.dumps(line)
    plain = harness.result(cell, out, False, "NVIDIA H100 80GB HBM3", 1)
    assert set(plain["metrics"]) == {"setup_s", "gen_tokens_per_s"}
    bad = harness.Outcome(out.e2e, record, 640, 0, {"max_gap": (0.2, 0.1)}, 123)
    assert harness.result(cell, bad, False, "x", 1)["correct"] is False
