"""The whole train work's share of the chip's bf16 peak: the model FLOPs of
all the work the window completed (``bench/counts.py``) over the window's
seconds times 989 TFLOP/s, in %."""

from bench.metrics_common import mfu


def read(record):
    return mfu(record)
