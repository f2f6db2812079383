"""Device: the share of the traced window in which no kernel, copy or
set ran on the card (one minus the union of their intervals)."""

UNIT = "%"


def read(ctx):
    t = ctx.get("trace")
    if not t or t["window_s"] <= 0 or t["records"] == 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
