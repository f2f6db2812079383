"""Query programs (``exec/groupby.py``, ``engine/bsi.py``, ``exec/tree.py``,
``exec/fused.py``): CUDA kernels in the traced window (copies and sets
left out) per request that returned in it."""

UNIT = "kernels/req"


def read(ctx):
    t = ctx.get("trace")
    if not t or not ctx["completed"] or t["kernels"] <= 0:
        return None
    return t["kernels"] / ctx["completed"]
