"""The reduction of a Chrome trace (bench/tracing.py) on a synthetic one:
device records go to the span whose host interval holds their launch (a
graph launch's many kernels share its correlation id), the window runs
from the first device record to the last, busy time is the union of the
records, and the idle gaps carry what the host was doing."""

from bench import tracing


def x(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


EVENTS = [
    x("user_annotation", "bench.prefill", 0, 50),
    x("cuda_runtime", "cudaGraphLaunch", 10, 2, corr=1),
    x("user_annotation", "bench.decode_step", 60, 10),
    x("cuda_runtime", "cudaGraphLaunch", 62, 2, corr=2),
    x("cpu_op", "aten::argmax", 80, 30),
    x("kernel", "void (anonymous namespace)::tc::tile_kernel<128>(float*)", 20, 30, corr=1),
    x("kernel", "elementwise", 45, 10, corr=1),
    x("kernel", "void (anonymous namespace)::tc::tile_kernel<64>(float*)", 70, 10, corr=2),
    x("kernel", "elementwise", 100, 25, corr=2),
    x("gpu_memcpy", "Memcpy DtoH", 130, 5, corr=99),
]


def test_reduce():
    r = tracing.reduce(EVENTS)
    assert [s["kind"] for s in r["spans"]] == ["prefill", "decode_step"]
    assert [rec["span"] for rec in r["records"]] == [0, 0, 1, 1, None]
    assert r["window_s"] == 115e-6                      # 20 .. 135
    assert abs(r["busy_s"] - 75e-6) < 1e-12               # 20-55, 70-80, 100-125, 130-135
    labels = dict((round(s * 1e6), label) for label, s in r["gaps"])
    assert labels[20] == "between calls > aten::argmax"   # 80 .. 100
    assert [len(s) for s in (tracing.span_records(r, "prefill"),
                             tracing.span_records(r, "decode_step"))] == [1, 1]
    assert len(tracing.span_records(r, "decode_step")[0]) == 2
    assert sum(tracing.is_gemm(rec["name"]) for rec in r["records"]) == 2


def test_breakdown_and_names():
    b = tracing.breakdown(tracing.reduce(EVENTS))
    assert b["device_ops"][0][0] == "elementwise" and len(b["device_ops"]) == 4
    assert tracing.short_name(EVENTS[5]["name"]) == "anon::tc::tile_kernel<128>"
    assert b["idle_gaps"][0][1] >= b["idle_gaps"][-1][1]


def test_lead_calls_lie_outside_the_window():
    """A lead span's records, the pause before them and the records after
    it that no span holds are left out: the window opens at the first
    record of the first span after the lead."""
    lead = [x("user_annotation", "bench.lead", -200, 20),
            x("cuda_runtime", "cudaGraphLaunch", -195, 2, corr=7),
            x("kernel", "elementwise", -150, 40, corr=7),
            x("kernel", "argmax", -5, 3, corr=8)]
    r = tracing.reduce(lead + EVENTS)
    base = tracing.reduce(EVENTS)
    assert [s["kind"] for s in r["spans"]] == ["prefill", "decode_step"]
    assert r["window_s"] == base["window_s"] and r["busy_s"] == base["busy_s"]
    assert [rec["span"] for rec in r["records"]] == [0, 0, 1, 1, None]


def test_empty_trace():
    r = tracing.reduce([x("user_annotation", "bench.decode_step", 0, 10)])
    assert r["busy_s"] == 0.0 and r["records"] == []
