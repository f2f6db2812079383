"""Every call of every request answered from data cubes in NumPy.

Calls that read the same fields share one cube: one ``np.bincount`` over
the rows' combined key of those fields, counting rows (and summing the
aggregated field, where the calls ask for a Sum).  A range term's field
enters the key by the bucket its value falls in between the bounds that
the calls name, so ``total_amount >= a`` for every ``a`` of a window
costs one cube.  A call is then a sum over a box of its cube: one index
of each equality term, the listed indices of an ``in`` term, the buckets
inside each range (prefix sums along the range axes), every index of a
grouped field.  A cube is counted over blocks of rows on a few threads
and the blocks' counts added; a row's bucket is read from a table over
the field's whole domain where that is small.

The result has the shapes ``API.query`` answers in:
a Sum ``{"value", "count"}``, a TopN its non-zero
``{"id", "count"}`` pairs by count, a GroupBy its non-empty groups in row
order, each ``{"group": [{"field", "rowID"}, ...], "count"[, "agg"]}``."""

from __future__ import annotations

import itertools
from concurrent.futures import ThreadPoolExecutor

import numpy as np

EXACT_MAX = 1 << 53  # float64 sums of integers are exact below this
BLOCK_ROWS = 1 << 24
THREADS = 8
TABLE_MAX = 1 << 24  # the widest domain whose buckets come from a table


def _set_fields(call: dict) -> list:
    out = list(call.get("rows", []))
    if call["call"] == "topn":
        out.append(call["field"])
    out += [t["field"] for t in call["filter"] if "eq" in t or "in" in t]
    return out


def _range(term: dict) -> tuple:
    """A range term as a half-open value interval (None: unbounded)."""
    if "ge" in term:
        return term["ge"], None
    if "lt" in term:
        return None, term["lt"]
    lo, hi = term["between"]
    return lo, hi + 1


def _signature(call: dict) -> tuple:
    sets = tuple(sorted(set(_set_fields(call))))
    ranges = tuple(sorted({t["field"] for t in call["filter"]
                           if "eq" not in t and "in" not in t}))
    agg = call["field"] if call["call"] == "sum" else call.get("sum")
    return sets, ranges, agg


def _bucketer(spec: dict, b: np.ndarray):
    """``values -> bucket``: how many of the sorted bounds ``b`` lie at or
    below each value."""
    lo, hi = spec.get("min"), spec.get("max")
    if lo is None or hi is None or hi - lo >= TABLE_MAX:
        return lambda v: np.searchsorted(b, v, side="right")
    table = np.searchsorted(b, np.arange(lo, hi + 1), side="right")
    return lambda v: table[v - lo] if lo else table[v]


class _Cube:
    def __init__(self, columns, fields, sets, ranges, agg, bounds):
        self.sets, self.ranges, self.bounds = sets, ranges, bounds
        shape = ([fields[f]["rows"] for f in sets]
                 + [len(bounds[f]) + 1 for f in ranges])
        size = int(np.prod(shape))
        bucket = {f: _bucketer(fields[f], bounds[f]) for f in ranges}
        n = len(next(iter(columns.values())))

        def block(lo: int):
            hi = min(lo + BLOCK_ROWS, n)
            key = np.zeros(hi - lo, np.int64)
            for f in sets:
                key *= fields[f]["rows"]
                key += columns[f][lo:hi]
            for f in ranges:
                key *= len(bounds[f]) + 1
                key += bucket[f](columns[f][lo:hi])
            counts = np.bincount(key, minlength=size)
            if agg is None:
                return counts, None
            s = np.bincount(key, weights=columns[agg][lo:hi], minlength=size)
            if np.abs(s).sum() >= EXACT_MAX:
                raise ValueError(f"sum of {agg} past exact float64")
            return counts, np.rint(s).astype(np.int64)

        counts = np.zeros(size, np.int64)
        sums = None if agg is None else np.zeros(size, np.int64)
        with ThreadPoolExecutor(THREADS) as pool:
            for c, s in pool.map(block, range(0, n, BLOCK_ROWS)):
                counts += c
                if s is not None:
                    sums += s
        self.counts = self._prefix(counts.reshape(shape))
        self.sums = None if sums is None else self._prefix(sums.reshape(shape))

    def _prefix(self, a):
        """Prefix sums along each range axis, a zero plane in front."""
        for i in range(len(self.sets), a.ndim):
            pad = [(0, 0)] * a.ndim
            pad[i] = (1, 0)
            a = np.pad(np.cumsum(a, axis=i, dtype=a.dtype), pad)
        return a

    def box(self, a, call):
        """The call's sum of ``a`` over its range box: an array over the
        cube's set axes."""
        spans = []
        for f in self.ranges:
            b = self.bounds[f]
            lo, hi = None, None
            for t in call["filter"]:
                if t["field"] == f and "eq" not in t and "in" not in t:
                    tlo, thi = _range(t)
                    lo = tlo if lo is None or (tlo is not None and tlo > lo) else lo
                    hi = thi if hi is None or (thi is not None and thi < hi) else hi
            s = 0 if lo is None else int(np.searchsorted(b, lo)) + 1
            e = len(b) + 1 if hi is None else int(np.searchsorted(b, hi)) + 1
            spans.append((s, max(s, e)))
        out = 0
        for corner in itertools.product((0, 1), repeat=len(spans)):
            idx = tuple(sp[1] if c else sp[0] for sp, c in zip(spans, corner))
            sign = (-1) ** (len(spans) - sum(corner))
            out = out + sign * a[(Ellipsis,) + idx]
        return out


def _select(a, sets, call, fields):
    """Apply the call's equality and ``in`` terms to the set axes of
    ``a``; keep (masked) the axes the call groups by, sum the rest."""
    keep = set(call.get("rows", []))
    if call["call"] == "topn":
        keep.add(call["field"])
    for i, f in enumerate(sets):
        mask = np.ones(fields[f]["rows"], bool)
        for t in call["filter"]:
            if t["field"] != f:
                continue
            vals = [t["eq"]] if "eq" in t else t.get("in", [])
            m = np.zeros_like(mask)
            m[[v for v in vals if 0 <= v < len(m)]] = True
            mask &= m
        shape = [1] * a.ndim
        shape[i] = len(mask)
        a = a * mask.reshape(shape)
    axes = tuple(i for i, f in enumerate(sets) if f not in keep)
    a = a.sum(axis=axes, dtype=a.dtype) if axes else a
    kept = [f for f in sets if f in keep]
    return a, kept


def _answer(cube: _Cube, call: dict, fields):
    counts, kept = _select(cube.box(cube.counts, call), cube.sets, call,
                           fields)
    sums = None
    if cube.sums is not None:
        sums, _ = _select(cube.box(cube.sums, call), cube.sets, call, fields)
    kind = call["call"]
    if kind == "sum":
        return {"value": int(sums), "count": int(counts)}
    if kind == "topn":
        c = counts
        rows = np.flatnonzero(c > 0)
        order = sorted(rows.tolist(), key=lambda r: (-c[r], r))
        return [{"id": r, "count": int(c[r])} for r in order]
    order = [kept.index(f) for f in call["rows"]]
    c = np.transpose(counts, order)
    s = None if sums is None else np.transpose(sums, order)
    out = []
    for idx in zip(*np.nonzero(c > 0)):
        g = {"group": [{"field": f, "rowID": int(r)}
                       for f, r in zip(call["rows"], idx)],
             "count": int(c[idx])}
        if s is not None:
            g["agg"] = int(s[idx])
        out.append(g)
    return out


def answer(columns: dict, fields: dict, requests: list) -> list:
    """Each request's list of call answers."""
    by_sig: dict = {}
    for ri, req in enumerate(requests):
        for ci, call in enumerate(req["calls"]):
            by_sig.setdefault(_signature(call), []).append((ri, ci, call))
    out = [[None] * len(r["calls"]) for r in requests]
    for (sets, ranges, agg), calls in by_sig.items():
        bounds = {f: np.unique([v for _, _, c in calls for t in c["filter"]
                                if t["field"] == f and "eq" not in t
                                and "in" not in t
                                for v in _range(t) if v is not None])
                  for f in ranges}
        cube = _Cube(columns, fields, sets, ranges, agg, bounds)
        for ri, ci, call in calls:
            out[ri][ci] = _answer(cube, call, fields)
    return out
