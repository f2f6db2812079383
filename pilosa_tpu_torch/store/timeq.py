"""Time quantum views: names and minimal range covers.

The port's copy of ``pilosa_tpu.store.timeq``: ``views_by_time`` (the
granularity views a timestamped write lands in) and
``views_by_time_range`` (the minimal set of views covering a query
range), with view names such as ``standard_2017``, ``standard_201701``,
``standard_20170102`` and ``standard_2017010203``.

Quantum strings are contiguous subsets of ``"YMDH"``: ``Y, M, D, H, YM,
MD, DH, YMD, MDH, YMDH``.

Ranges are ``[from, to)`` with both endpoints truncated down to the
quantum's finest unit.  The cover uses the smallest units at the edges
and the largest in the middle, and covers the truncated range exactly.
Timestamps are naive datetimes in UTC.
"""

from __future__ import annotations

from datetime import datetime, timedelta

UNITS = "YMDH"
_FMT = {"Y": "%Y", "M": "%Y%m", "D": "%Y%m%d", "H": "%Y%m%d%H"}


def validate_quantum(q: str) -> str:
    q = q.upper()
    if q and q in UNITS or q in ("YM", "MD", "DH", "YMD", "MDH", "YMDH"):
        return q
    raise ValueError(f"invalid time quantum {q!r}")


def view_name(base: str, t: datetime, unit: str) -> str:
    return f"{base}_{t.strftime(_FMT[unit])}"


def views_by_time(base: str, t: datetime, quantum: str) -> list[str]:
    """Every granularity view a timestamped write lands in."""
    return [view_name(base, t, u) for u in quantum]


def _floor(t: datetime, unit: str) -> datetime:
    if unit == "Y":
        return t.replace(month=1, day=1, hour=0, minute=0, second=0,
                         microsecond=0)
    if unit == "M":
        return t.replace(day=1, hour=0, minute=0, second=0, microsecond=0)
    if unit == "D":
        return t.replace(hour=0, minute=0, second=0, microsecond=0)
    return t.replace(minute=0, second=0, microsecond=0)


def _next(t: datetime, unit: str) -> datetime:
    if unit == "Y":
        return t.replace(year=t.year + 1)
    if unit == "M":
        return t.replace(year=t.year + (t.month == 12), month=t.month % 12 + 1)
    if unit == "D":
        return t + timedelta(days=1)
    return t + timedelta(hours=1)


def _ceil(t: datetime, unit: str) -> datetime:
    f = _floor(t, unit)
    return f if f == t else _next(f, unit)


def views_by_time_range(base: str, start: datetime, end: datetime,
                        quantum: str) -> list[str]:
    """Minimal exact cover of ``[start, end)`` with the quantum's units."""
    quantum = validate_quantum(quantum)
    finest = quantum[-1]
    start, end = _floor(start, finest), _floor(end, finest)

    def cover(lo: datetime, hi: datetime, units: str) -> list[str]:
        if lo >= hi:
            return []
        u = units[0]
        if len(units) == 1:
            out, t = [], _floor(lo, u)
            while t < hi:
                out.append(view_name(base, t, u))
                t = _next(t, u)
            return out
        a1, a2 = _ceil(lo, u), _floor(hi, u)
        if a1 >= a2:
            return cover(lo, hi, units[1:])
        mid, t = [], a1
        while t < a2:
            mid.append(view_name(base, t, u))
            t = _next(t, u)
        return cover(lo, a1, units[1:]) + mid + cover(a2, hi, units[1:])

    return cover(start, end, quantum)


_SUFFIX_UNIT = {4: "Y", 6: "M", 8: "D", 10: "H"}


def parse_view_time(suffix: str) -> tuple[datetime, str]:
    """Inverse of :func:`view_name`'s suffix: ``"201701"`` ->
    ``(2017-01-01, "M")``.  Raises ValueError for non-time suffixes."""
    unit = _SUFFIX_UNIT.get(len(suffix))
    if unit is None or not suffix.isdigit():
        raise ValueError(f"not a time view suffix: {suffix!r}")
    return datetime.strptime(suffix, _FMT[unit]), unit


def view_span(suffix: str) -> tuple[datetime, datetime]:
    """The ``[start, end)`` period a time view covers."""
    t, unit = parse_view_time(suffix)
    return t, _next(t, unit)


def parse_pql_time(s: str) -> datetime:
    """A PQL timestamp literal: ``2017-01-02T03:04`` (seconds optional) or
    ``2017-01-02``."""
    for fmt in ("%Y-%m-%dT%H:%M:%S", "%Y-%m-%dT%H:%M", "%Y-%m-%d"):
        try:
            return datetime.strptime(s, fmt)
        except ValueError:
            continue
    raise ValueError(f"cannot parse timestamp {s!r}")
