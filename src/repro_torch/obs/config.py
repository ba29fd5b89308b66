"""Telemetry opt-in configuration.

Counterpart of the JAX package's ``obs/config.py``.  The rest of the JAX
package's ``obs/`` (attribution, event replay, timelines, the Perfetto and
text exporters) is not ported yet (ROADMAP queue 1, item 16): until it is,
every entry point given ``TelemetryConfig(enabled=True)`` raises
:class:`NotImplementedError` through :func:`require_off` instead of running
without telemetry.

This module deliberately imports nothing from the simulator layers so
that ``core``/``multicore``/``serving`` modules can take a
:class:`TelemetryConfig` parameter without an import cycle.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class TelemetryConfig:
    """What the run records; the default records nothing.

    ``enabled=False`` is the zero-cost path: runs carry no telemetry
    state, reports get ``telemetry=None``, and the simulation loops are
    byte-for-byte the same code path as before the subsystem existed.

    With ``enabled=True`` the chip/batch drivers retain enough of each
    finished run (compiled traces, the exact share-schedule parameters
    each segment was simulated under) to assemble a
    ``ChipTelemetry`` after the fact (not ported yet: see the module
    docs).
    """

    enabled: bool = False
    #: also replay per-instruction stage events (TL/TS grants, MM
    #: FF/FS/DR windows) for every segment -- needed for stage tracks in
    #: the Perfetto export, costs one extra numpy replay per segment.
    stages: bool = False
    #: emit counter tracks (per-epoch bandwidth share, in-flight cores)
    #: in the exporters.
    counters: bool = True
    #: cap on stage events exported per trace file (a multi-million
    #: instruction run would otherwise produce an unloadable JSON).
    max_stage_events: int = 200_000

    def __post_init__(self):
        if self.max_stage_events < 0:
            raise ValueError("max_stage_events must be >= 0")


#: the shared "telemetry off" default (frozen, so safe to share).
OFF = TelemetryConfig()


def require_off(what: str, telemetry: TelemetryConfig | None = None) -> None:
    """Raise for ``what`` when it needs the unported part of ``obs/``: a
    run asked for telemetry (``telemetry.enabled``), or, with no
    ``telemetry`` given, a query that always needs it."""
    if telemetry is None or telemetry.enabled:
        raise NotImplementedError(
            f"{what} needs the telemetry layers of obs/ (attribution, record, "
            f"timeline, perfetto, render), not ported yet (ROADMAP queue 1, "
            f"item 16)")
