"""Arithmetic the per-layer readers share (each reader is its own file
under ``bench/metrics/``)."""

from __future__ import annotations

from . import counts
from .tracing import is_gemm, span_records


def gemm_roofline(record: dict, kind: str) -> float | None:
    """Sum of the engine products' least times over the device time of the
    GEMM records, over the ``kind`` calls whose GEMM records are complete."""
    trace = record.get("trace")
    if not trace:
        return None
    infos = [info for k, info in record["calls"] if k == kind]
    want = counts.engine_calls(record["spec"])
    bound = device = 0.0
    for info, recs in zip(infos, span_records(trace, kind)):
        gemms = [r for r in recs if is_gemm(r["name"])]
        if len(gemms) != want:
            continue
        bound += counts.engine_bound_s(record["spec"], info["rows"], info["head_rows"])
        device += sum(r["t1"] - r["t0"] for r in gemms)
    return 100 * bound / device if device else None


def idle_share(record: dict) -> float | None:
    trace = record.get("trace")
    if not trace or not trace["window_s"]:
        return None
    return 100 * (1 - trace["busy_s"] / trace["window_s"])


def mfu(record: dict) -> float | None:
    w = record.get("window")
    if not w or not w["seconds"]:
        return None
    return 100 * w["flops"] / (w["seconds"] * counts.PEAK_BF16_FLOPS)
