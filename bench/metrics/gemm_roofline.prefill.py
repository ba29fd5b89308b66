"""The RASA GEMM's share of its roofline in the prefill calls of the traced
segment: the least time of every engine product those calls make
(``bench/counts.py``: each call's larger of 2MKN over 989 TFLOP/s and its
operand and output bytes over 3.35 TB/s) over the device time of the GEMM
kernels' records launched inside the calls' ``bench.prefill`` spans.
Only calls whose GEMM records are all in the trace count."""

from bench.metrics_common import gemm_roofline


def read(record):
    return gemm_roofline(record, "prefill")
