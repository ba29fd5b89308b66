"""Plain-text timeline renderer (docs, tests, CLI output).

One bar per core over the run window: ``#`` busy, ``-`` queued work
waiting on the core, ``.`` idle.  Below the bars, the stall-attribution
table.  Deliberately dependency-free so benchmark scripts can print it.

Counterpart of the JAX package's ``obs/render.py``.
"""

from __future__ import annotations

from .timeline import ChipTelemetry


def render_timeline(tele: ChipTelemetry, width: int = 72) -> str:
    """ASCII chip timeline + attribution table."""
    window = tele.window
    lines = [f"{tele.design} [{tele.kind}] {tele.n_cores} cores, "
             f"window {window:.0f} cycles "
             f"({'1 char = %.0f cyc' % (window / width) if window else ''})"]
    if window <= 0:
        return lines[0]
    scale = width / window

    def col(t: float) -> int:
        return min(width - 1, max(0, int(t * scale)))

    for c in range(tele.n_cores):
        row = ["."] * width
        for s in tele.segments:
            if s.core != c:
                continue
            if s.start_time > s.submit_time:
                for k in range(col(s.submit_time), col(s.start_time) + 1):
                    if row[k] == ".":
                        row[k] = "-"
            for k in range(col(s.start_time), col(s.finish_time) + 1):
                row[k] = "#"
        lines.append(f"core {c:>2} |{''.join(row)}|")
    lines.append("        (# busy  - queued  . idle)")
    lines.append("")
    lines.append(tele.attribution.table())
    return "\n".join(lines)
