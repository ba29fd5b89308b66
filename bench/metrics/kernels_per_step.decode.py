"""Device records (kernels, copies, fills) per decode step in the traced
segment: the records whose launch lies inside a ``bench.decode_step`` span,
over the spans' count."""

from bench.tracing import span_records


def read(record):
    steps = span_records(record["trace"], "decode_step") if record.get("trace") else []
    return sum(len(s) for s in steps) / len(steps) if steps else None
