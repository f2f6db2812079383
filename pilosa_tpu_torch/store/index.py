"""Index: a collection of fields over one column space.  With existence
tracking on, the internal ``_exists`` field (row 0) records every written
column, which ``Not`` and ``All`` read.  Column attributes live in
``<index>/_attrs.db`` and, on a keyed index, column and row keys in
``<index>/_keys/`` (:mod:`.translate`)."""

from __future__ import annotations

import json
import os
import shutil
import threading
import time

import numpy as np

from pilosa_tpu_torch.store.attrs import AttrStore
from pilosa_tpu_torch.store.field import TYPE_SET, Field, FieldOptions

EXISTENCE_FIELD = "_exists"


class Index:
    def __init__(self, path: str, name: str, *, keys: bool = False,
                 track_existence: bool = True, fsync: bool = False,
                 created_at: float = 0.0, snapshot_submit=None, health=None):
        self.path = path
        self.name = name
        self.keys = keys
        self.track_existence = track_existence
        self.created_at = created_at
        self.fsync = fsync
        self.snapshot_submit = snapshot_submit
        self.health = health  # the holder's StorageHealth
        self.fields: dict[str, Field] = {}
        self._column_attrs = None
        self._lock = threading.RLock()

    def open(self) -> "Index":
        meta = os.path.join(self.path, ".meta")
        if os.path.exists(meta):
            with open(meta) as f:
                opts = json.load(f)
            self.keys = opts.get("keys", False)
            self.track_existence = opts.get("track_existence", True)
            self.created_at = opts.get("created_at", 0.0)
        entries = sorted(os.listdir(self.path)) \
            if os.path.isdir(self.path) else []
        for entry in entries:
            fpath = os.path.join(self.path, entry)
            if os.path.isdir(fpath) and not entry.startswith("."):
                self.fields[entry] = Field(
                    fpath, self.name, entry, fsync=self.fsync,
                    snapshot_submit=self.snapshot_submit,
                    health=self.health).open()
        if self.track_existence and EXISTENCE_FIELD not in self.fields:
            self.create_field(EXISTENCE_FIELD, FieldOptions(type=TYPE_SET))
        return self

    def save_meta(self) -> None:
        os.makedirs(self.path, exist_ok=True)
        tmp = os.path.join(self.path, ".meta.tmp")
        with open(tmp, "w") as f:
            json.dump({"keys": self.keys,
                       "track_existence": self.track_existence,
                       "created_at": self.created_at}, f)
        os.replace(tmp, os.path.join(self.path, ".meta"))

    def close(self) -> None:
        for f in self.fields.values():
            f.close()
        self._close_attrs()

    def discard(self) -> None:
        """Close an index that is being deleted: every field discarded
        (:meth:`Field.discard`) and the column attribute store closed."""
        with self._lock:
            fields = list(self.fields.values())
        for f in fields:
            f.discard()
        self._close_attrs()

    def _close_attrs(self) -> None:
        with self._lock:
            if self._column_attrs is not None:
                self._column_attrs.close()
                self._column_attrs = None

    def create_field(self, name: str,
                     options: FieldOptions | None = None) -> Field:
        with self._lock:
            if name in self.fields:
                raise ValueError(f"field {name!r} already exists")
            options = options or FieldOptions()
            if not options.created_at:
                options.created_at = time.time()
            f = Field(os.path.join(self.path, name), self.name, name,
                      options, fsync=self.fsync,
                      snapshot_submit=self.snapshot_submit, health=self.health)
            os.makedirs(f.path, exist_ok=True)
            f.save_meta()
            self.fields[name] = f
            return f

    def field(self, name: str) -> Field | None:
        return self.fields.get(name)

    def delete_field(self, name: str, release=None) -> None:
        """Remove a field and its directory (``KeyError`` when absent).
        Its fragments are discarded, not compacted, and ``release(path)``
        (the caller's, to drop what else holds the field) runs before the
        directory is removed."""
        with self._lock:
            f = self.fields.pop(name, None)
            if f is None:
                raise KeyError(name)
            f.discard()
            if release is not None:
                release(f.path)
            shutil.rmtree(f.path, ignore_errors=True)

    @property
    def column_attrs(self) -> AttrStore:
        """The column attribute store ``<index>/_attrs.db``, created on
        first use."""
        with self._lock:
            if self._column_attrs is None:
                self._column_attrs = AttrStore(
                    os.path.join(self.path, "_attrs.db"))
            return self._column_attrs

    @property
    def existence_field(self) -> Field | None:
        return self.fields.get(EXISTENCE_FIELD)

    def note_columns(self, cols: np.ndarray, sync_batch=None) -> None:
        """Record columns in the existence field (row 0)."""
        ef = self.existence_field
        if ef is not None and len(cols):
            ef.import_bits(np.zeros(len(cols), np.uint64),
                           np.asarray(cols, np.uint64),
                           sync_batch=sync_batch)

    def set_value(self, field: str, col: int, value) -> bool:
        """Write one BSI value and record the column's existence."""
        f = self.fields.get(field)
        if f is None:
            raise KeyError(f"field {field!r} not found")
        changed = f.set_value(col, value)
        self.note_columns(np.array([col], np.uint64))
        return changed

    def available_shards(self) -> list[int]:
        shards: set[int] = set()
        # a copy: a field created meanwhile must not break the iteration
        for f in list(self.fields.values()):
            shards.update(f.available_shards())
        return sorted(shards)
