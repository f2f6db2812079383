"""Kernels (``engine/cuda_kernels.py``, ``engine/csrc/popcount.cu``): the
least time the window's work needs, each returned request's least bytes
(``benchmark.roofline``) at the H100 SXM's 3.35 TB/s, as a share of the
device's busy time in the trace."""

from benchmark.roofline import HBM_BYTES_PER_S

UNIT = "%"


def read(ctx):
    t = ctx.get("trace")
    if not t or t["busy_s"] <= 0 or not ctx["request_bytes"]:
        return None
    least_s = sum(ctx["request_bytes"]) / HBM_BYTES_PER_S
    return 100.0 * least_s / t["busy_s"]
