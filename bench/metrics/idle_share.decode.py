"""The device's idle share over the traced decode steps (from the first
step's first device record, after the segment's lead step, to the last
record): 1 - (union of the device records) / (that window), in %."""

from bench.metrics_common import idle_share


def read(record):
    return idle_share(record)
