"""Telemetry of the chip model: for now only its opt-in knob.

- :mod:`repro_torch.obs.config` -- :class:`TelemetryConfig` and ``OFF``;
  the timelines, stall attribution and exporters of the JAX package's
  ``obs/`` come with ROADMAP queue 1, item 16 (until then an enabled
  config raises ``NotImplementedError``).
"""

from .config import OFF, TelemetryConfig, require_off

__all__ = ["TelemetryConfig", "OFF", "require_off"]
