"""Telemetry: per-core timelines, stall attribution, Perfetto export.

Counterpart of the JAX package's ``obs/``.  The subsystem is strictly
*post-hoc*: nothing in here adds hooks to the simulation loops.  Events are
derived after the fact by replaying a compiled trace against the exact
stream-model parameters a run used, so the simulation lanes pay nothing
when telemetry is off.  The replay follows the chip's backend
(:func:`repro_torch.obs.record.replay_many`): the event-recording scan
kernel on ``cuda``, its plain version on ``torch``, the Python copy of the
reference's loop (:func:`repro_torch.obs.record.replay_events`) on the
CPU backends.

Layers, bottom up:

- :mod:`repro_torch.obs.config` -- the :class:`TelemetryConfig` opt-in knob.
- :mod:`repro_torch.obs.record` -- per-instruction event replay (grant
  times, MM sub-stage windows) over a
  :class:`repro_torch.core.trace.CompiledTrace`.
- :mod:`repro_torch.obs.attribution` -- {compute, fill/drain,
  bandwidth-stall, fault-lost, queue-wait, idle} bucket decomposition with
  exact conservation.
- :mod:`repro_torch.obs.timeline` -- chip-level assembly: one
  :class:`SegmentTimeline` per (core, segment) plus the share/occupancy
  traces, built from a finished closed-batch or online run.
- :mod:`repro_torch.obs.perfetto` / :mod:`repro_torch.obs.render` --
  exporters: Chrome ``trace_event`` JSON (Perfetto-viewable) and a
  plain-text timeline for docs/tests.
"""

from .attribution import (CoreAttribution, StallAttribution,
                          attribute_segments, simreport_attribution,
                          workload_compute_cycles)
from .config import OFF, TelemetryConfig
from .perfetto import to_trace_events, write_trace
from .record import StreamEvents, replay_events
from .render import render_timeline
from .timeline import (ChipTelemetry, SegmentTimeline, build_chip_telemetry,
                       build_online_telemetry)

__all__ = [
    "TelemetryConfig", "OFF",
    "StreamEvents", "replay_events",
    "CoreAttribution", "StallAttribution", "attribute_segments",
    "simreport_attribution", "workload_compute_cycles",
    "SegmentTimeline", "ChipTelemetry",
    "build_chip_telemetry", "build_online_telemetry",
    "to_trace_events", "write_trace", "render_timeline",
]
