"""Executor admission (``exec/executor.py``): the mean wait for one of the
executor's query slots, from its ``query_queue_wait_seconds`` histogram
over the window (one observation per query)."""

UNIT = "ms"


def read(ctx):
    h = ctx["hist"].get("query_queue_wait_seconds")
    if not h or h["count"] <= 0:
        return None
    return 1000.0 * h["sum"] / h["count"]
