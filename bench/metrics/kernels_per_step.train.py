"""Device records (kernels, copies, fills) per train step in the traced
segment: the records whose launch lies inside a ``bench.train_step`` span,
over the spans' count."""

from bench.tracing import span_records


def read(record):
    steps = span_records(record["trace"], "train_step") if record.get("trace") else []
    return sum(len(s) for s in steps) / len(steps) if steps else None
