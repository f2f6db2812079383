"""Field: a typed attribute group within an index.

The port serves ``set`` fields.  ``FieldOptions`` carries every option of
``pilosa_tpu.store.field.FieldOptions`` in the same order, so the
``.meta`` JSON round-trips between the two packages byte for byte; a
field of another type opens (its options load) but takes no writes here.
"""

from __future__ import annotations

import json
import os
import threading
from dataclasses import asdict, dataclass

import numpy as np

from pilosa_tpu_torch.engine.words import SHARD_WIDTH
from pilosa_tpu_torch.store.view import VIEW_STANDARD, View

TYPE_SET = "set"
FIELD_TYPES = ("set", "int", "time", "mutex", "bool", "decimal",
               "timestamp")
BSI_TYPES = ("int", "decimal", "timestamp")


@dataclass
class FieldOptions:
    type: str = TYPE_SET
    keys: bool = False
    cache_type: str = "ranked"
    cache_size: int = 50000
    time_quantum: str = ""
    min: int | None = None
    max: int | None = None
    base: int = 0
    bit_depth: int = 0
    scale: int = 0
    epoch: str = ""
    time_unit: str = "s"
    created_at: float = 0.0

    def __post_init__(self):
        if self.type not in FIELD_TYPES:
            raise ValueError(f"invalid field type {self.type!r}")


class Field:
    def __init__(self, path: str, index_name: str, name: str,
                 options: FieldOptions | None = None, *,
                 fsync: bool = False):
        self.path = path
        self.index_name = index_name
        self.name = name
        self.options = options or FieldOptions()
        self.fsync = fsync
        self.views: dict[str, View] = {}
        self._lock = threading.RLock()

    def open(self) -> "Field":
        meta = os.path.join(self.path, ".meta")
        if os.path.exists(meta):
            with open(meta) as f:
                self.options = FieldOptions(**json.load(f))
        views_dir = os.path.join(self.path, "views")
        if os.path.isdir(views_dir):
            for name in sorted(os.listdir(views_dir)):
                self.views[name] = View(os.path.join(views_dir, name), name,
                                        fsync=self.fsync).open()
        return self

    def save_meta(self) -> None:
        os.makedirs(self.path, exist_ok=True)
        tmp = os.path.join(self.path, ".meta.tmp")
        with open(tmp, "w") as f:
            json.dump(asdict(self.options), f)
        os.replace(tmp, os.path.join(self.path, ".meta"))

    def close(self) -> None:
        for v in self.views.values():
            v.close()

    def view(self, name: str, create: bool = False) -> View | None:
        with self._lock:
            v = self.views.get(name)
            if v is None and create:
                v = View(os.path.join(self.path, "views", name), name,
                         fsync=self.fsync).open()
                self.views[name] = v
            return v

    def standard_view(self, create: bool = False) -> View | None:
        return self.view(VIEW_STANDARD, create)

    def available_shards(self) -> list[int]:
        shards: set[int] = set()
        with self._lock:
            for v in self.views.values():
                shards.update(v.available_shards())
        return sorted(shards)

    def _require_set(self, what: str) -> None:
        if self.options.type != TYPE_SET:
            raise ValueError(f"field {self.name}: {what} on a "
                             f"{self.options.type!r} field is not "
                             "supported by this port")

    def set_bit(self, row_id: int, col: int) -> bool:
        return self.import_bits(np.array([row_id], np.uint64),
                                np.array([col], np.uint64)) > 0

    def clear_bit(self, row_id: int, col: int) -> bool:
        self._require_set("Clear")
        view = self.standard_view()
        frag = view.fragment(col // SHARD_WIDTH) if view else None
        if frag is None:
            return False
        return frag.clear_bits(np.array([row_id], np.uint64),
                               np.array([col % SHARD_WIDTH], np.uint64)) > 0

    def import_bits(self, row_ids: np.ndarray, cols: np.ndarray) -> int:
        """Bulk (row, col) writes into the standard view, one batch per
        shard; returns the number of newly set bits."""
        self._require_set("Set")
        view = self.standard_view(create=True)
        changed = 0
        for shard, rows, offs in _by_shard(row_ids, cols, "import_bits"):
            frag = view.fragment(shard, create=True)
            changed += frag.set_bits(rows, offs)
        return changed

    def clear_import(self, row_ids: np.ndarray, cols: np.ndarray) -> int:
        """Bulk clear of (row, col) pairs in the standard view, one batch
        per shard (the ``clear`` half of the import endpoint); returns the
        number of bits cleared."""
        self._require_set("Clear")
        view = self.standard_view()
        changed = 0
        for shard, rows, offs in _by_shard(row_ids, cols, "clear_import"):
            frag = view.fragment(shard) if view is not None else None
            if frag is not None:
                changed += frag.clear_bits(rows, offs)
        return changed


def _by_shard(row_ids, cols, what: str):
    """``(shard, row_ids, column offsets)`` per shard of a pair batch: one
    sort and boundary slices, not a mask per shard."""
    row_ids = np.asarray(row_ids, np.uint64)
    cols = np.asarray(cols, np.uint64)
    if len(row_ids) != len(cols):
        raise ValueError(
            f"{what}: {len(row_ids)} rows vs {len(cols)} columns")
    shards = cols // np.uint64(SHARD_WIDTH)
    order = np.argsort(shards, kind="stable")
    shards, row_ids, cols = shards[order], row_ids[order], cols[order]
    uniq = np.unique(shards)
    bounds = np.append(np.searchsorted(shards, uniq), len(shards))
    offs = cols % np.uint64(SHARD_WIDTH)
    for i, shard in enumerate(uniq.tolist()):
        lo, hi = bounds[i], bounds[i + 1]
        yield int(shard), row_ids[lo:hi], offs[lo:hi]
