"""Device time of a decode step: the benchmark's CUDA events around every
``ServeSession.decode_step`` call of the window, summed over their count."""


def read(record):
    rows = record["spans"].get("decode_step")
    return sum(ms for ms, _ in rows) / len(rows) if rows else None
