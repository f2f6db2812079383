"""Batcher (``exec/batcher.py``): the mean items per launch window, from
its ``batcher_window_items`` histogram over the window."""

UNIT = "items"


def read(ctx):
    h = ctx["hist"].get("batcher_window_items")
    if not h or h["count"] <= 0:
        return None
    return h["sum"] / h["count"]
