"""Field: a typed attribute group within an index.

The port serves every field type of ``pilosa_tpu.store.field``: ``set``,
``time``, ``mutex`` and ``bool`` (plain bit rows of the standard view)
and the bit-sliced integer (BSI) types ``int``, ``decimal`` and
``timestamp``.  ``FieldOptions`` carries every option of
``pilosa_tpu.store.field.FieldOptions`` in the same order, with the same
derivation of ``base`` and ``bit_depth`` from ``min``/``max``, so the
``.meta`` JSON round-trips between the two packages byte for byte.

A mutex field holds at most one row per column and a bool field is a
mutex of rows 0 (false) and 1 (true): a write of (row, column) clears the
column in every other row first (:meth:`Field._set_mutex`).

A BSI field keeps one view, ``bsi_<name>``, whose rows are the layout of
:mod:`pilosa_tpu_torch.engine.bsi`: the exists row, the sign row, then
one row per magnitude bit of ``stored - base``.  ``bit_depth`` grows as
larger values arrive and is persisted in the field meta.

A time field keeps its bits in the standard view, and a timestamped write
also lands in one view per unit of its quantum (``standard_2021``,
``standard_202102``, ``standard_20210203``: :mod:`.timeq`).  Clears
reach every view.
"""

from __future__ import annotations

import json
import os
import threading
from dataclasses import asdict, dataclass
from datetime import datetime, timezone

import numpy as np

from pilosa_tpu_torch.engine.bsi import EXISTS_ROW, OFFSET_ROW, SIGN_ROW
from pilosa_tpu_torch.engine.words import SHARD_WIDTH
from pilosa_tpu_torch.store import timeq
from pilosa_tpu_torch.store.attrs import AttrStore
from pilosa_tpu_torch.store.timeq import parse_pql_time
from pilosa_tpu_torch.store.view import VIEW_BSI_PREFIX, VIEW_STANDARD, View

TYPE_SET = "set"
TYPE_INT = "int"
TYPE_TIME = "time"
TYPE_MUTEX = "mutex"
TYPE_BOOL = "bool"
TYPE_DECIMAL = "decimal"
TYPE_TIMESTAMP = "timestamp"
FIELD_TYPES = ("set", "int", "time", "mutex", "bool", "decimal",
               "timestamp")
BSI_TYPES = (TYPE_INT, TYPE_DECIMAL, TYPE_TIMESTAMP)
# the types whose rows are plain bit rows of the standard view
ROW_TYPES = (TYPE_SET, TYPE_TIME, TYPE_MUTEX, TYPE_BOOL)

_UNIX_EPOCH = datetime(1970, 1, 1, tzinfo=timezone.utc)
_TS_UNITS = {"s": 1, "ms": 10**3, "us": 10**6, "ns": 10**9}


class BoolRowError(ValueError):
    """A bool field written a row other than 0 or 1 (the REST import
    answers it with a 500, as the reference does)."""


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
        if self.type == TYPE_TIME and self.time_quantum:
            self.time_quantum = timeq.validate_quantum(self.time_quantum)
        if self.type == TYPE_TIMESTAMP and self.time_unit not in _TS_UNITS:
            raise ValueError(f"invalid timestamp unit {self.time_unit!r}")
        if (self.type in BSI_TYPES and self.min is not None
                and self.max is not None):
            if self.min > self.max:
                raise ValueError("field min > max")
            # base minimizes the stored magnitudes
            if self.base == 0:
                if self.min > 0:
                    self.base = self.min
                elif self.max < 0:
                    self.base = self.max
            if self.bit_depth == 0:
                span = max(abs(self.min - self.base),
                           abs(self.max - self.base))
                self.bit_depth = max(1, int(span).bit_length())
        if self.type in BSI_TYPES and self.bit_depth == 0:
            self.bit_depth = 1


class Field:
    def __init__(self, path: str, index_name: str, name: str,
                 options: FieldOptions | None = None, *,
                 fsync: bool = False, snapshot_submit=None, health=None):
        self.path = path
        self.index_name = index_name
        self.name = name
        self.options = options or FieldOptions()
        self.fsync = fsync
        self.snapshot_submit = snapshot_submit
        self.health = health  # the holder's StorageHealth
        self.views: dict[str, View] = {}
        self._row_attrs = None
        self._lock = threading.RLock()
        # set once the field is deleted: a plane built from it afterwards
        # is never cached
        self.deleted = False

    def open(self) -> "Field":
        meta = os.path.join(self.path, ".meta")
        if os.path.exists(meta):
            with open(meta) as f:
                self.options = FieldOptions(**json.load(f))
        views_dir = os.path.join(self.path, "views")
        if os.path.isdir(views_dir):
            for name in sorted(os.listdir(views_dir)):
                self.views[name] = View(
                    os.path.join(views_dir, name), name, fsync=self.fsync,
                    snapshot_submit=self.snapshot_submit,
                    health=self.health).open()
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
        self._close_attrs()

    def discard(self) -> None:
        """Close a field that is being deleted: marked deleted, every view
        closed without compacting, and the attribute store closed so its
        file's space is freed when the directory goes."""
        self.deleted = True
        with self._lock:
            views = list(self.views.values())
        for v in views:
            v.discard()
        self._close_attrs()

    def _close_attrs(self) -> None:
        with self._lock:
            if self._row_attrs is not None:
                self._row_attrs.close()
                self._row_attrs = None

    @property
    def row_attrs(self) -> AttrStore:
        """The row attribute store ``<field>/_attrs.db``, created on
        first use."""
        with self._lock:
            if self._row_attrs is None:
                self._row_attrs = AttrStore(
                    os.path.join(self.path, "_attrs.db"))
            return self._row_attrs

    @property
    def has_row_attrs(self) -> bool:
        """Whether a row attribute store exists, without creating one: a
        read never writes a store into the data directory."""
        with self._lock:
            if self._row_attrs is not None:
                return True
        return os.path.exists(os.path.join(self.path, "_attrs.db"))

    def view(self, name: str, create: bool = False) -> View | None:
        with self._lock:
            v = self.views.get(name)
            if v is None and create:
                v = View(os.path.join(self.path, "views", name), name,
                         fsync=self.fsync,
                         snapshot_submit=self.snapshot_submit,
                         health=self.health).open()
                self.views[name] = v
            return v

    def standard_view(self, create: bool = False) -> View | None:
        return self.view(VIEW_STANDARD, create)

    @property
    def bsi_view_name(self) -> str:
        return VIEW_BSI_PREFIX + self.name

    def bsi_view(self, create: bool = False) -> View | None:
        return self.view(self.bsi_view_name, create)

    def available_shards(self) -> list[int]:
        shards: set[int] = set()
        with self._lock:
            for v in self.views.values():
                shards.update(v.available_shards())
        return sorted(shards)

    def _require_rows(self, what: str) -> None:
        if self.options.type not in ROW_TYPES:
            raise ValueError(f"field {self.name}: {what} on a "
                             f"{self.options.type!r} field is not "
                             "supported by this port")

    def set_bit(self, row_id: int, col: int,
                timestamp: datetime | None = None) -> bool:
        return self.import_bits(np.array([row_id], np.uint64),
                                np.array([col], np.uint64),
                                [timestamp] if timestamp else None) > 0

    def clear_bit(self, row_id: int, col: int) -> bool:
        """Clear one bit in every view (a time view's copy left set would
        come back in range queries)."""
        self._require_rows("Clear")
        shard, off = col // SHARD_WIDTH, col % SHARD_WIDTH
        changed = 0
        with self._lock:
            views = list(self.views.values())
        for v in views:
            frag = v.fragment(shard)
            if frag is not None:
                changed += frag.clear_bits(np.array([row_id], np.uint64),
                                           np.array([off], np.uint64))
        return changed > 0

    def import_bits(self, row_ids: np.ndarray, cols: np.ndarray,
                    timestamps: list | None = None, sync_batch=None) -> int:
        """Bulk (row, col[, timestamp]) writes: one batch per shard into
        the standard view (through :meth:`_set_mutex` on a mutex or bool
        field); on a time field each timestamped pair also lands in every
        view of the quantum, one write per pair and view as in the
        reference, so fragments and their journals match it.  Returns
        the number of bits changed in the standard view.  ``sync_batch``
        (an :class:`~.oplog.SyncBatch`) defers every op-log fsync to the
        batch's flush: one per touched fragment."""
        self._require_rows("Set")
        opts = self.options
        row_ids = np.asarray(row_ids, np.uint64)
        if (opts.type == TYPE_BOOL and len(row_ids)
                and int(row_ids.max()) > 1):
            raise BoolRowError("bool field rows must be 0 or 1")
        mutex = opts.type in (TYPE_MUTEX, TYPE_BOOL)
        stamped = (opts.type == TYPE_TIME and timestamps is not None
                   and bool(opts.time_quantum))
        view = self.standard_view(create=True)
        changed = 0
        for shard, rows, offs, idx in _by_shard(row_ids, cols,
                                                "import_bits"):
            frag = view.fragment(shard, create=True)
            if mutex:
                changed += self._set_mutex(frag, rows, offs, sync_batch)
                continue
            changed += frag.set_bits(rows, offs, sync_batch=sync_batch)
            if not stamped:
                continue
            for r, c, i in zip(rows.tolist(), offs.tolist(), idx.tolist()):
                ts = timestamps[i] if i < len(timestamps) else None
                if ts is None:
                    continue
                for vname in timeq.views_by_time(VIEW_STANDARD, ts,
                                                 opts.time_quantum):
                    self.view(vname, create=True).fragment(
                        shard, create=True).set_bits(
                            np.array([r], np.uint64),
                            np.array([c], np.uint64), sync_batch=sync_batch)
        return changed

    def clear_import(self, row_ids: np.ndarray, cols: np.ndarray,
                     sync_batch=None) -> int:
        """Bulk clear of (row, col) pairs in every view, one batch per
        shard and view (the ``clear`` half of the import endpoint);
        returns the number of bits cleared in the standard view."""
        self._require_rows("Clear")
        with self._lock:
            views = list(self.views.values())
        changed = 0
        for shard, rows, offs, _ in _by_shard(row_ids, cols,
                                              "clear_import"):
            for v in views:
                frag = v.fragment(shard)
                if frag is not None:
                    n = frag.clear_bits(rows, offs, sync_batch=sync_batch)
                    if v.name == VIEW_STANDARD:
                        changed += n
        return changed

    @staticmethod
    def _set_mutex(frag, row_ids: np.ndarray, cols: np.ndarray,
                   sync_batch=None) -> int:
        """One shard's mutex batch, record for record the reference's
        ``_set_mutex``: the last write of a column in the batch wins;
        then, for each existing row in id order, one clear of the batch
        columns it holds but is not being set in; then one set of the
        batch.  Which columns the rows hold comes from one probe of just
        those columns in every row (:meth:`Fragment.rows_contain`), not
        each row's column list; a row's clears touch no other row, so the
        probe taken before the first clear holds for every row.  Returns
        the bits changed."""
        _, last = np.unique(cols[::-1], return_index=True)
        keep = len(cols) - 1 - last
        row_ids = row_ids[keep].astype(np.uint64)
        cols = cols[keep].astype(np.uint32)
        changed = 0
        with frag.lock:
            existing = frag.row_ids()
            held = frag.rows_contain(existing, cols)
            for r, has in zip(existing, held):
                to_clear = cols[has & (row_ids != r)]
                if len(to_clear):
                    changed += frag.clear_bits(
                        np.full(len(to_clear), r, np.uint64), to_clear,
                        sync_batch=sync_batch)
            changed += frag.set_bits(row_ids, cols, sync_batch=sync_batch)
        return changed

    # -- BSI value writes ---------------------------------------------------

    def _require_bsi(self, what: str) -> None:
        if self.options.type not in BSI_TYPES:
            raise ValueError(f"field {self.name}: {what} on non-BSI field")

    def to_stored(self, value) -> int:
        """API value -> stored integer (decimal scaling, timestamp epoch)."""
        opts = self.options
        if opts.type == TYPE_DECIMAL:
            return int(round(float(value) * 10**opts.scale))
        if opts.type == TYPE_TIMESTAMP:
            if isinstance(value, str):
                value = parse_pql_time(value).replace(tzinfo=timezone.utc)
            if isinstance(value, datetime):
                epoch = (datetime.fromisoformat(opts.epoch)
                         if opts.epoch else _UNIX_EPOCH)
                if value.tzinfo is None:
                    value = value.replace(tzinfo=timezone.utc)
                return int((value - epoch).total_seconds()
                           * _TS_UNITS[opts.time_unit])
            return int(value)
        return int(value)

    def _to_stored_batch(self, values) -> np.ndarray:
        """Vectorized :meth:`to_stored` for bulk imports."""
        opts = self.options
        if opts.type == TYPE_INT:
            return np.asarray(values, dtype=np.int64)
        if opts.type == TYPE_DECIMAL and not any(
                isinstance(v, str) for v in values[:1]):
            return np.round(np.asarray(values, dtype=np.float64)
                            * 10**opts.scale).astype(np.int64)
        return np.array([self.to_stored(v) for v in values], dtype=np.int64)

    def from_stored(self, stored: int):
        if self.options.type == TYPE_DECIMAL:
            return stored / 10**self.options.scale
        return stored

    def set_value(self, col: int, value) -> bool:
        return self.import_values(np.array([col], np.uint64), [value]) > 0

    def import_values(self, cols: np.ndarray, values) -> int:
        """Bulk BSI writes, one grouped set and one grouped clear per shard
        (every bit row written, so an overwrite needs no read-back); a
        value past the bit depth grows it and saves the meta.  Returns
        the bits changed."""
        self._require_bsi("value import")
        opts = self.options
        cols = np.asarray(cols, np.uint64)
        stored = self._to_stored_batch(values)
        if len(stored) != len(cols):
            raise ValueError(f"import_values: {len(cols)} columns vs "
                             f"{len(stored)} values")
        if opts.min is not None and (stored < self.to_stored(opts.min)).any():
            raise ValueError(f"value below field min {opts.min}")
        if opts.max is not None and (stored > self.to_stored(opts.max)).any():
            raise ValueError(f"value above field max {opts.max}")
        offs = stored - np.int64(opts.base)
        mag = np.abs(offs).astype(np.uint64)
        need = max(1, int(mag.max()).bit_length()) if len(mag) else 1
        if need > opts.bit_depth:
            opts.bit_depth = need
            self.save_meta()
        depth = opts.bit_depth
        changed = 0
        for shard, idx, c, _ in _by_shard(
                np.arange(len(cols), dtype=np.uint64), cols,
                "import_values"):
            o, g = offs[idx.astype(np.intp)], mag[idx.astype(np.intp)]
            frag = self.bsi_view(create=True).fragment(shard, create=True)
            # the last write of a column in the batch wins
            _, last = np.unique(c[::-1], return_index=True)
            keep = len(c) - 1 - last
            c, o, g = c[keep], o[keep], g[keep]
            neg = o < 0
            set_groups = [(EXISTS_ROW, c), (SIGN_ROW, c[neg])]
            clr_groups = [(SIGN_ROW, c[~neg])]
            for b in range(depth):
                hit = (g >> np.uint64(b)) & np.uint64(1) != 0
                set_groups.append((OFFSET_ROW + b, c[hit]))
                clr_groups.append((OFFSET_ROW + b, c[~hit]))
            changed += frag.set_bits_grouped(set_groups)
            changed += frag.clear_bits_grouped(clr_groups)
        return changed

    def value(self, col: int) -> tuple:
        """One column's BSI value: ``(value, exists)``."""
        view = self.bsi_view()
        frag = view.fragment(col // SHARD_WIDTH) if view else None
        if frag is None:
            return 0, False
        off = col % SHARD_WIDTH
        word, bit = off >> 5, np.uint32(1) << np.uint32(off & 31)

        def has(row: int) -> bool:
            return bool(frag.row_words(row, [word])[0] & bit)

        if not has(EXISTS_ROW):
            return 0, False
        mag = sum(1 << b for b in range(self.options.bit_depth)
                  if has(OFFSET_ROW + b))
        if has(SIGN_ROW):
            mag = -mag
        return self.from_stored(mag + self.options.base), True

    def clear_value(self, col: int) -> bool:
        """Remove a column's BSI value entirely."""
        self._require_bsi("value clear")
        view = self.bsi_view()
        frag = view.fragment(col // SHARD_WIDTH) if view else None
        if frag is None:
            return False
        rows = np.arange(OFFSET_ROW + self.options.bit_depth, dtype=np.uint64)
        return frag.clear_bits(rows, np.full(len(rows), col % SHARD_WIDTH,
                                             np.uint64)) > 0


def _by_shard(row_ids, cols, what: str):
    """``(shard, row_ids, column offsets, batch positions)`` per shard of
    a pair batch: one sort and boundary slices, not a mask per shard."""
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
        yield int(shard), row_ids[lo:hi], offs[lo:hi], order[lo:hi]
