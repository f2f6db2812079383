"""Query result types of the ported calls, with the REST JSON shapes of
``pilosa_tpu.exec.result``."""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field

import numpy as np


@dataclass
class RowResult:
    """Set of absolute column ids (one bitmap call's result); on a keyed
    index ``keys`` holds the columns' keys instead."""

    columns: np.ndarray = dc_field(
        default_factory=lambda: np.empty(0, np.uint64))
    keys: list[str] | None = None
    attrs: dict | None = None      # column attributes (Options columnAttrs=)
    row_attrs: dict | None = None  # the queried row's attributes

    def to_json(self):
        out = ({"keys": self.keys} if self.keys is not None
               else {"columns": [int(c) for c in self.columns]})
        if self.attrs is not None:
            out["attrs"] = {str(k): v for k, v in self.attrs.items()}
        if self.row_attrs is not None:
            out["rowAttrs"] = self.row_attrs
        return out


@dataclass
class Pair:
    id: int = 0
    key: str | None = None
    count: int = 0

    def to_json(self):
        if self.key is not None:
            return {"key": self.key, "count": self.count}
        return {"id": self.id, "count": self.count}


@dataclass
class PairsResult:
    """TopN result."""

    pairs: list[Pair]

    def to_json(self):
        return [p.to_json() for p in self.pairs]


@dataclass
class ValCount:
    """Sum/Min/Max/Percentile result: the value and the count of columns
    behind it."""

    value: int | float = 0
    count: int = 0

    def to_json(self):
        return {"value": self.value, "count": self.count}


@dataclass
class DistinctResult:
    """``Distinct()`` result: the sorted distinct values of a BSI field."""

    values: list

    def to_json(self):
        return {"values": self.values}


@dataclass
class RowIdsResult:
    """``Rows()`` result: the sorted row ids of a field, or their keys on
    a keyed field."""

    rows: np.ndarray = dc_field(
        default_factory=lambda: np.empty(0, np.uint64))
    keys: list[str] | None = None

    def to_json(self):
        if self.keys is not None:
            return {"keys": self.keys}
        return {"rows": [int(r) for r in self.rows]}


@dataclass
class FieldRow:
    field: str
    row_id: int = 0
    row_key: str | None = None

    def to_json(self):
        if self.row_key is not None:
            return {"field": self.field, "rowKey": self.row_key}
        return {"field": self.field, "rowID": self.row_id}


@dataclass
class GroupCount:
    group: list[FieldRow]
    count: int
    agg: int | None = None  # the aggregate's value when GroupBy has one

    def to_json(self):
        out = {"group": [g.to_json() for g in self.group],
               "count": self.count}
        if self.agg is not None:
            out["agg"] = self.agg
        return out


class GroupCountsResult:
    """GroupBy result held columnar, with :class:`GroupCount` objects
    made only when ``groups`` is read.

    ``fields`` names one field per Rows level; ``row_ids`` uint64[G, L];
    ``row_keys``, when a level is keyed, one list of G keys per level
    (None for an unkeyed level); ``counts`` int64[G]; optional ``aggs``
    [G] (int64, or object for big ints) and ``agg_mask`` bool[G], which
    groups carry an aggregate value."""

    __slots__ = ("_groups", "fields", "row_ids", "row_keys", "counts",
                 "aggs", "agg_mask")

    def __init__(self, groups: list[GroupCount] | None = None, *,
                 fields: list[str] | None = None, row_ids=None,
                 row_keys: list | None = None, counts=None, aggs=None,
                 agg_mask=None):
        self._groups = groups
        self.fields = fields or []
        self.row_ids = row_ids
        self.row_keys = row_keys
        self.counts = counts
        self.aggs = aggs
        self.agg_mask = agg_mask

    @property
    def groups(self) -> list[GroupCount]:
        if self._groups is None:
            self._groups = [
                GroupCount([FieldRow(f, row_key=k) if k is not None
                            else FieldRow(f, row_id=r)
                            for f, r, k in zip(self.fields, rows, keys)],
                           count, agg)
                for rows, keys, count, agg in self._iter_columns()]
        return self._groups

    def _iter_columns(self):
        """(row ids, row keys, count, agg | None) per group, as Python
        ints."""
        ids = self.row_ids.tolist()
        counts = self.counts.tolist()
        by_level = self.row_keys or [None] * len(self.fields)
        aggs = mask = None
        if self.aggs is not None:
            aggs = self.aggs.tolist()
            mask = (self.agg_mask.tolist() if self.agg_mask is not None
                    else [True] * len(aggs))
        for i, (rows, count) in enumerate(zip(ids, counts)):
            keys = [kl[i] if kl is not None else None for kl in by_level]
            yield rows, keys, count, (aggs[i] if aggs is not None and mask[i]
                                      else None)

    def to_json(self):
        if self._groups is not None:
            return [g.to_json() for g in self._groups]
        out = []
        for rows, keys, count, agg in self._iter_columns():
            g = {"group": [{"field": f, "rowKey": k} if k is not None
                           else {"field": f, "rowID": r}
                           for f, r, k in zip(self.fields, rows, keys)],
                 "count": count}
            if agg is not None:
                g["agg"] = agg
            out.append(g)
        return out


@dataclass
class ExtractResult:
    """``Extract()`` result: per selected column, each requested field's
    value (a set field's row list, a mutex field's row, a bool field's
    flag, a BSI field's value; None where the column holds none; keys for
    the rows of a keyed field).  A keyed index's columns are keys."""

    field_specs: list[tuple[str, str]]  # (name, type)
    columns: list  # (column id | key, [per-field value])

    def to_json(self):
        return {
            "fields": [{"name": n, "type": t} for n, t in self.field_specs],
            "columns": [
                ({"key": c, "rows": vals} if isinstance(c, str)
                 else {"column": int(c), "rows": vals})
                for c, vals in self.columns],
        }


def result_to_json(r):
    """Any handler result -> JSON-able value (bool/int pass through)."""
    if hasattr(r, "to_json"):
        return r.to_json()
    return r
