"""Chrome ``trace_event`` JSON export (Perfetto-viewable).

One process per chip, one thread track per core (plus a queue track and,
with stage events recorded, a stage track per core).  Counter tracks
carry the arbiter's per-epoch share and the in-flight core count.

Timestamps are engine cycles mapped 1:1 onto the format's microsecond
unit -- read "1 us" in the viewer as "1 cycle".  Load the file at
https://ui.perfetto.dev (or ``chrome://tracing``) via "Open trace file".

Counterpart of the JAX package's ``obs/perfetto.py``.
"""

from __future__ import annotations

import json
from pathlib import Path

from .timeline import ChipTelemetry

#: tid layout: per-core tracks at fixed offsets so mixed exports diff
#: cleanly.  Core run track = core index; the rest are offset blocks.
QUEUE_TID = 1000
STAGE_TID = 2000
MEM_TID = 3000


def _meta(pid: int, tid: int, name: str, sort: int) -> list[dict]:
    return [
        {"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
         "args": {"name": name}},
        {"ph": "M", "name": "thread_sort_index", "pid": pid, "tid": tid,
         "args": {"sort_index": sort}},
    ]


def to_trace_events(tele: ChipTelemetry) -> dict:
    """Render telemetry as a ``trace_event`` JSON document (dict form)."""
    pid = 0
    ev: list[dict] = [
        {"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
         "args": {"name": f"rasa-chip {tele.design} [{tele.kind}]"}},
    ]
    used_queue = any(s.start_time > s.submit_time for s in tele.segments)
    has_stages = any(s.events is not None for s in tele.segments)
    for c in range(tele.n_cores):
        ev += _meta(pid, c, f"core {c}", 10 * c)
        if used_queue:
            ev += _meta(pid, QUEUE_TID + c, f"core {c} queue", 10 * c + 1)
        if has_stages:
            ev += _meta(pid, STAGE_TID + c, f"core {c} stages", 10 * c + 2)
            ev += _meta(pid, MEM_TID + c, f"core {c} mem", 10 * c + 3)

    # -- run + queue slices, async request lifetimes ----------------------
    for s in tele.segments:
        args = {"sid": s.sid, "compute_cycles": s.compute_cycles,
                "bw_stall_cycles": s.bw_stall_cycles,
                "arb_delay_cycles": s.arb_delay_cycles,
                "queue_cycles": s.queue_cycles,
                "n_mm": s.n_mm, "n_tl": s.n_tl, "n_ts": s.n_ts,
                "wl_skips": s.wl_skips}
        if s.fault_lost_cycles:
            # keyed in only on preempted instances: fault-free exports
            # stay byte-identical to the pre-fault schema
            args["fault_lost_cycles"] = s.fault_lost_cycles
        ev.append({
            "ph": "X", "name": s.name, "cat": "segment", "pid": pid,
            "tid": s.core, "ts": s.start_time, "dur": s.busy_cycles,
            "args": args})
        if s.start_time > s.submit_time:
            ev.append({
                "ph": "X", "name": f"queued {s.name}", "cat": "queue",
                "pid": pid, "tid": QUEUE_TID + s.core,
                "ts": s.submit_time, "dur": s.start_time - s.submit_time,
                "args": {"sid": s.sid}})
        if tele.kind == "online":
            ev.append({"ph": "b", "cat": "request", "id": s.sid,
                       "name": s.name, "pid": pid, "tid": s.core,
                       "ts": s.submit_time, "args": {}})
            ev.append({"ph": "e", "cat": "request", "id": s.sid,
                       "name": s.name, "pid": pid, "tid": s.core,
                       "ts": s.finish_time, "args": {}})

    # -- per-instruction stage events (capped) ----------------------------
    budget = tele.config.max_stage_events
    dropped = 0

    def stage(items):
        nonlocal budget, dropped
        for e in items:
            if budget <= 0:
                dropped += 1
                continue
            budget -= 1
            ev.append(e)

    for s in tele.segments:
        if s.events is None:
            continue
        t0 = s.start_time
        evs = s.events
        tid = STAGE_TID + s.core
        for k in range(len(evs.mm_index)):
            wl0 = float(evs.mm_wl_start[k])
            ff0 = float(evs.mm_ff_start[k])
            ff1 = float(evs.mm_ff_end[k])
            fs1 = float(evs.mm_fs_end[k])
            dr1 = float(evs.mm_dr_end[k])
            items = []
            if not bool(evs.mm_skip[k]) and ff0 > wl0:
                items.append({"ph": "X", "name": "WL", "cat": "stage",
                              "pid": pid, "tid": tid, "ts": t0 + wl0,
                              "dur": ff0 - wl0})
            items.append({"ph": "X", "name": "FF", "cat": "stage",
                          "pid": pid, "tid": tid, "ts": t0 + ff0,
                          "dur": ff1 - ff0})
            if fs1 > ff1:
                items.append({"ph": "X", "name": "FS", "cat": "stage",
                              "pid": pid, "tid": tid, "ts": t0 + ff1,
                              "dur": fs1 - ff1})
            if dr1 > fs1:
                items.append({"ph": "X", "name": "DR", "cat": "stage",
                              "pid": pid, "tid": tid, "ts": t0 + fs1,
                              "dur": dr1 - fs1})
            stage(items)
        mtid = MEM_TID + s.core
        for k in range(len(evs.tl_index)):
            start = float(evs.tl_start[k])
            stall = float(evs.tl_stall[k])
            items = [{"ph": "X", "name": "TL", "cat": "mem", "pid": pid,
                      "tid": mtid, "ts": t0 + start, "dur": 1.0,
                      "args": {"bytes": float(evs.tl_bytes[k])}}]
            if stall > 0.0:
                items.insert(0, {
                    "ph": "X", "name": "bw-throttle", "cat": "stall",
                    "pid": pid, "tid": mtid, "ts": t0 + start - stall,
                    "dur": stall})
            stage(items)
        for k in range(len(evs.ts_index)):
            stall = float(evs.ts_stall[k])
            start = float(evs.ts_start[k])
            items = [{"ph": "X", "name": "TS", "cat": "mem", "pid": pid,
                      "tid": mtid, "ts": t0 + start, "dur": 1.0}]
            if stall > 0.0:
                items.insert(0, {
                    "ph": "X", "name": "bw-throttle", "cat": "stall",
                    "pid": pid, "tid": mtid, "ts": t0 + start - stall,
                    "dur": stall})
            stage(items)

    # -- counter tracks ---------------------------------------------------
    if tele.config.counters and tele.epoch_cycles > 0:
        E = tele.epoch_cycles
        for e, share in enumerate(tele.share_trace):
            ev.append({"ph": "C", "name": "bw share (B/cyc/weight)",
                       "pid": pid, "tid": 0, "ts": e * E,
                       "args": {"share": share}})
        for e, n in enumerate(tele.active_trace):
            ev.append({"ph": "C", "name": "active cores", "pid": pid,
                       "tid": 0, "ts": e * E, "args": {"active": n}})

    # -- labeled instants (arrivals, admissions) --------------------------
    for t, label in tele.marks:
        ev.append({"ph": "i", "name": label, "cat": "mark", "pid": pid,
                   "tid": 0, "ts": t, "s": "p"})

    out = {
        "traceEvents": ev,
        "displayTimeUnit": "ms",
        "otherData": {
            "schema": "rasa-trace/1",
            "time_unit": "1 us == 1 engine cycle",
            "design": tele.design, "kind": tele.kind,
            "n_cores": tele.n_cores, "window_cycles": tele.window,
            "attribution": {
                b: tele.attribution.total(b)
                for b in ("compute", "fill_drain", "bw_stall",
                          "queue_wait", "idle")},
        },
    }
    fault_lost = tele.attribution.total("fault_lost")
    if fault_lost:
        out["otherData"]["attribution"]["fault_lost"] = fault_lost
    if dropped:
        out["otherData"]["stage_events_dropped"] = dropped
    return out


def write_trace(tele: ChipTelemetry, path: str | Path) -> Path:
    """Write the Perfetto-loadable trace JSON; returns the path."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(to_trace_events(tele), indent=1,
                               sort_keys=True))
    return path
