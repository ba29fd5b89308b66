"""Telemetry opt-in configuration.

Counterpart of the JAX package's ``obs/config.py``.

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
    :class:`repro_torch.obs.timeline.ChipTelemetry` after the fact.
    """

    enabled: bool = False
    #: also replay per-instruction stage events (TL/TS grants, MM
    #: FF/FS/DR windows) for every segment -- needed for stage tracks in
    #: the Perfetto export, costs one batched replay of the run's segments
    #: on the chip's backend (:func:`repro_torch.obs.record.replay_many`).
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

