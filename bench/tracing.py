"""The benchmark's own spans around each call into the port, and the
``torch.profiler`` trace of a short traced segment, reduced to a record
that the per-layer readers (``bench/metrics/<name>.py``) take their
numbers from.

Spans: a pair of CUDA events around every call (its device time, read
after the window) and a ``record_function`` range named ``bench.<kind>``
(its host interval in a trace).  A device record belongs to the span
whose host interval holds the launch it came from, matched by the
profiler's correlation id; a replayed CUDA graph's kernels all carry the
id of its one ``cudaGraphLaunch``.

A traced segment may begin with calls in ``bench.lead`` spans: the
profiler's own start-up (a pause of some milliseconds at its first graph
launch) falls there, and the traced window opens only at the first device
record of the first span after them.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import re
from pathlib import Path

import torch

#: device records that are work on the device
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
#: the kind of the spans that open a traced segment and lie outside its window
LEAD = "lead"
#: the RASA GEMM's kernels (``csrc/rasa_gemm.cu``): tensor-core, SIMT and
#: streaming decode paths
GEMM_RE = re.compile(r"\b(tc|simt|dec)::(tile_kernel|wlbp_kernel|sgemm_tile|sgemm_wlbp"
                     r"|decode_kernel)\b")


class Spans:
    """CUDA-event spans by kind; off unless ``enabled``."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.pending: dict[str, list] = {}

    @contextlib.contextmanager
    def span(self, kind: str, info=None):
        if not self.enabled:
            yield
            return
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with torch.profiler.record_function(f"bench.{kind}"):
            start.record()
            yield
            end.record()
        self.pending.setdefault(kind, []).append((start, end, info))

    def resolve(self) -> dict[str, list]:
        """{kind: [(device ms, info), ...]} of every span so far."""
        torch.cuda.synchronize()
        return {kind: [(a.elapsed_time(b), info) for a, b, info in rows]
                for kind, rows in self.pending.items()}


def short_name(name: str, width: int = 96) -> str:
    """A kernel's name without its parameter list, at most ``width`` long."""
    depth, out = 0, []
    for ch in name.replace("(anonymous namespace)", "anon"):
        if ch == "(" and depth == 0 and out:
            break
        depth += ch == "<"
        depth -= ch == ">"
        out.append(ch)
    name = "".join(out).removeprefix("void ").strip()
    return name if len(name) <= width else name[:width - 3] + "..."


def union_s(intervals) -> float:
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def profile(work, warm, path: Path, complete=lambda record: True, tries: int = 3) -> dict:
    """Trace ``work()`` under torch.profiler, after ``warm()`` traced as the
    profiler's warm-up and thrown away, and reduce the trace (written to
    ``path`` as Chrome JSON) to a record.  The profiler can drop device
    records: a trace that ``complete`` refuses is taken again, up to
    ``tries`` times, and the last one is kept."""
    from torch.profiler import ProfilerActivity, schedule
    path.parent.mkdir(parents=True, exist_ok=True)
    for _ in range(tries):
        path.unlink(missing_ok=True)
        with torch.profiler.profile(
                activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                schedule=schedule(wait=0, warmup=1, active=1),
                on_trace_ready=lambda p: p.export_chrome_trace(str(path))) as prof:
            for run in (warm, work):
                run()
                torch.cuda.synchronize()
                prof.step()
        record = reduce(json.loads(path.read_text())["traceEvents"])
        if complete(record):
            break
    return record


def reduce(events: list[dict]) -> dict:
    """The record of a trace: the bench spans (host intervals), the device
    records each with the span it belongs to, the traced window (the first
    device record of a span other than a lead to the last record), the
    device's busy time in it, and the idle gaps with what the host was
    doing.  Times in seconds from the window's start."""
    xs = [e for e in events if e.get("ph") == "X"]
    spans = sorted((e["ts"], e["ts"] + e["dur"], e["name"][len("bench."):]) for e in xs
                   if e.get("cat") == "user_annotation" and e["name"].startswith("bench.")
                   and e["name"] != f"bench.{LEAD}")
    launches = {}
    for e in xs:
        if e.get("cat") in ("cuda_runtime", "cuda_driver") and "correlation" in e.get("args", {}):
            launches[e["args"]["correlation"]] = e["ts"]
    starts = [s[0] for s in spans]

    def span_of(ts):
        i = bisect.bisect_right(starts, ts) - 1
        return i if i >= 0 and ts <= spans[i][1] else None

    records = []
    for e in xs:
        if e.get("cat") in DEVICE_CATS:
            corr = e.get("args", {}).get("correlation")
            at = launches.get(corr)
            records.append((e["ts"], e["ts"] + e["dur"], e["name"],
                            None if at is None else span_of(at)))
    # the traced window opens at the first record of a span, so that the
    # profiler's start-up and the lead calls are not the program's idle time
    in_span = [r[0] for r in records if r[3] is not None]
    if in_span:
        records = [r for r in records if r[0] >= min(in_span)]
    if not records:
        return {"spans": [], "records": [], "window_s": 0.0, "busy_s": 0.0, "gaps": []}
    t0 = min(r[0] for r in records)
    t1 = max(r[1] for r in records)
    busy = union_s((a, b) for a, b, _, _ in records)
    host = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in xs
                  if e.get("cat") in HOST_CATS)
    return {"spans": [{"kind": k, "t0": (a - t0) / 1e6, "t1": (b - t0) / 1e6}
                      for a, b, k in spans],
            "records": [{"name": n, "t0": (a - t0) / 1e6, "t1": (b - t0) / 1e6, "span": s}
                        for a, b, n, s in records],
            "window_s": (t1 - t0) / 1e6, "busy_s": busy / 1e6,
            "gaps": idle_gaps(records, host, spans, t0, t1)}


def idle_gaps(records, host, spans, t0, t1, top: int = 10) -> list[tuple[str, float]]:
    """The ``top`` longest stretches of the window with no device record,
    longest first, each labelled by the bench span and the innermost host
    event at its start."""
    gaps, end = [], t0
    for a, b, _, _ in sorted(records):
        if a > end:
            gaps.append((end, a))
        end = max(end, b)
    if t1 > end:
        gaps.append((end, t1))
    out = []
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:top]:
        inner = [h for h in host if h[0] <= a < h[1]]
        where = next((k for s0, s1, k in spans if s0 <= a < s1), None)
        what = min(inner, key=lambda h: h[1] - h[0])[2] if inner else "no host event"
        out.append((f"{'bench.' + where if where else 'between calls'} > {what}",
                    (b - a) / 1e6))
    return out


def breakdown(record: dict, top: int = 10) -> dict:
    """The device operations that took the most time, by short name, and
    the longest idle gaps with what the host was doing."""
    ops = {}
    for r in record["records"]:
        name = short_name(r["name"])
        ops[name] = ops.get(name, 0.0) + r["t1"] - r["t0"]
    return {"device_ops": [[k, v] for k, v in sorted(ops.items(), key=lambda kv: -kv[1])[:top]],
            "idle_gaps": [[k, v] for k, v in record["gaps"][:top]]}


def span_records(record: dict, kind: str) -> list[list[dict]]:
    """The device records of each span of ``kind``, span by span."""
    index = [i for i, s in enumerate(record["spans"]) if s["kind"] == kind]
    by = {i: [] for i in index}
    for r in record["records"]:
        if r["span"] in by:
            by[r["span"]].append(r)
    return [by[i] for i in index]


def is_gemm(name: str) -> bool:
    return GEMM_RE.search(name) is not None
