"""The yardstick of the kernels layer: the least bytes a request's work
has to read from device memory, from its calls and the configuration's
shapes alone, and the card's published peak.

A set field's row and a BSI field's bit plane are each one row of 2^20
bits (128 KiB) per shard.  A request reads, once each, the union over its
calls of: the rows an equality or ``in`` term names; every row of a field
it groups by or ranks (only the named ones where a term also restricts
that field); the existence row and the bit planes of a field in a range
term or under a Sum (and the sign row where the field holds negative
values).  Nothing is taken from launches, so the same work reads the same
bytes whatever implements it."""

from __future__ import annotations

# NVIDIA H100 SXM data sheet: HBM3 bandwidth, bytes per second
HBM_BYTES_PER_S = 3.35e12
ROW_BYTES = (1 << 20) // 8


def bsi_planes(depth: int, signed: bool) -> int:
    return depth + 1 + int(signed)


def request_rows(calls: list, fields: dict, bsi: dict) -> int:
    """Distinct device rows per shard that the calls need; ``bsi`` maps an
    int field to ``(depth, signed)``."""
    need: set = set()
    for c in calls:
        named: dict = {}
        for t in c["filter"]:
            f = t["field"]
            if "eq" in t or "in" in t:
                vals = [t["eq"]] if "eq" in t else t["in"]
                named.setdefault(f, set()).update(vals)
            else:
                need.update((f, p) for p in range(bsi_planes(*bsi[f])))
        grouped = list(c.get("rows", []))
        if c["call"] == "topn":
            grouped.append(c["field"])
        for f in grouped:
            rows = named.get(f, range(fields[f]["rows"]))
            need.update((f, r) for r in rows)
        for f, rows in named.items():
            need.update((f, r) for r in rows)
        agg = c["field"] if c["call"] == "sum" else c.get("sum")
        if agg:
            need.update((agg, p) for p in range(bsi_planes(*bsi[agg])))
    return len(need)


def request_bytes(calls: list, fields: dict, bsi: dict, shards: int) -> int:
    return request_rows(calls, fields, bsi) * shards * ROW_BYTES
