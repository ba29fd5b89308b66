"""Device time of prefill a thousand prompt tokens: the benchmark's CUDA
events around every ``ServeSession.prefill`` call of the window, over the
prompt tokens those calls took."""


def read(record):
    rows = record["spans"].get("prefill")
    if not rows:
        return None
    return sum(ms for ms, _ in rows) / sum(info["tokens"] for _, info in rows) * 1e3
