"""Query result types of the ported calls, with the REST JSON shapes of
``pilosa_tpu.exec.result``."""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field

import numpy as np


@dataclass
class RowResult:
    """Set of absolute column ids (one bitmap call's result)."""

    columns: np.ndarray = dc_field(
        default_factory=lambda: np.empty(0, np.uint64))

    def to_json(self):
        return {"columns": [int(c) for c in self.columns]}


@dataclass
class Pair:
    id: int = 0
    count: int = 0

    def to_json(self):
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


def result_to_json(r):
    """Any handler result -> JSON-able value (bool/int pass through)."""
    if hasattr(r, "to_json"):
        return r.to_json()
    return r
