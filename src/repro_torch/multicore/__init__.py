"""Multi-core RASA chip: the load models of the shared memory system.

- :mod:`repro_torch.multicore.chip` -- ``EpochBandwidthLoadModel`` and
  ``SharedBandwidthLoadModel``; the chip model itself (``ChipConfig``,
  ``CoreCluster``, ``simulate_chip``) comes with ROADMAP queue 1, item 14
"""

from .chip import EpochBandwidthLoadModel, SharedBandwidthLoadModel

__all__ = ["EpochBandwidthLoadModel", "SharedBandwidthLoadModel"]
