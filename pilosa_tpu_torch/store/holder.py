"""Holder: root of the storage tree, the same layout as
``pilosa_tpu.store.holder``::

    <data>/<index>/.meta
    <data>/<index>/<field>/.meta
    <data>/<index>/<field>/views/<view>/fragments/<shard>[.oplog|.dense]

With ``async_snapshots`` (the default, as in the reference) a fragment
past its op-log threshold is compacted by the holder's
:class:`SnapshotQueue` on a background thread, off the write path.
"""

from __future__ import annotations

import logging
import os
import re
import shutil
import threading
import time
from concurrent.futures import ThreadPoolExecutor

from pilosa_tpu_torch.store.field import FieldOptions
from pilosa_tpu_torch.store.health import StorageHealth
from pilosa_tpu_torch.store.index import Index

_log = logging.getLogger("pilosa_tpu_torch.store")


class SnapshotQueue:
    """Background op-log compaction (``pilosa_tpu.store.holder``'s): the
    write path hands fragments past their threshold here.  Deduped by
    fragment; the worker thread starts on the first submit."""

    def __init__(self):
        self._pending: list = []
        self._inq: set[int] = set()
        self._cv = threading.Condition()
        self._stop = False
        self._thread: threading.Thread | None = None
        self._active = 0
        self._current = None  # the fragment being compacted
        self.compactions = 0
        self.last_compaction_seconds = 0.0
        self.last_compaction_span: tuple[float, float] | None = None

    def submit(self, frag) -> None:
        with self._cv:
            if not self._stop:
                if id(frag) in self._inq:
                    return
                self._inq.add(id(frag))
                self._pending.append(frag)
                if self._thread is None:
                    self._thread = threading.Thread(
                        target=self._loop, name="pilosa-snapshot",
                        daemon=True)
                    self._thread.start()
                self._cv.notify()
                return
        self._compact(frag)  # queue closed: compact inline

    def _compact(self, frag) -> None:
        t0 = time.perf_counter()
        before = frag.op_n
        try:
            frag.maybe_snapshot()
        except Exception:  # noqa: BLE001 — the op-log stays the truth
            _log.exception("background snapshot failed for %s", frag.path)
            return
        if frag.op_n < before:
            t1 = time.perf_counter()
            with self._cv:
                self.compactions += 1
                self.last_compaction_seconds = t1 - t0
                self.last_compaction_span = (t0, t1)  # perf_counter

    def _loop(self) -> None:
        while True:
            with self._cv:
                while not self._pending and not self._stop:
                    self._cv.wait()
                if self._stop and not self._pending:
                    return
                frag = self._pending.pop(0)
                self._inq.discard(id(frag))
                self._active += 1
                self._current = frag
            try:
                self._compact(frag)
            finally:
                with self._cv:
                    self._active -= 1
                    self._current = None
                    self._cv.notify_all()

    def forget(self, path: str) -> None:
        """Drop the queued fragments under ``path`` (a directory being
        deleted) and wait out a compaction of one of them in progress."""
        prefix = os.path.join(path, "")
        with self._cv:
            self._pending = [f for f in self._pending
                             if not f.path.startswith(prefix)]
            self._inq = {id(f) for f in self._pending}
            self._cv.wait_for(lambda: self._current is None
                              or not self._current.path.startswith(prefix))

    def pending(self) -> int:
        """Fragments queued or being compacted."""
        with self._cv:
            return len(self._pending) + self._active

    def wait_idle(self, timeout: float | None = None) -> bool:
        """Wait until nothing is queued or being compacted; False on
        timeout."""
        with self._cv:
            return self._cv.wait_for(
                lambda: not self._pending and not self._active, timeout)

    def close(self) -> None:
        """Stop taking work and drain the backlog; anything left after
        the bounded join compacts inline here."""
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=30)
        with self._cv:
            leftover, self._pending = self._pending, []
            self._inq.clear()
        for frag in leftover:
            self._compact(frag)


class Holder:
    # indexes opened at once: each open reads and crc-checks its snapshots
    # and replays its op-logs; mmap reads and crc32 release the lock
    OPEN_WORKERS = 8

    def __init__(self, path: str, *, fsync: bool = False,
                 async_snapshots: bool = True):
        self.path = path
        self.fsync = fsync
        self.indexes: dict[str, Index] = {}
        self._lock = threading.RLock()
        self.snapshot_queue = SnapshotQueue() if async_snapshots else None
        # the tree's disk-health governor and quarantine registry, shared
        # by every fragment (the server configures it before open)
        self.storage_health = StorageHealth(base=path)

    @property
    def _submit(self):
        q = self.snapshot_queue
        return q.submit if q is not None else None

    def open(self) -> "Holder":
        """Open every index of the tree, several at once."""
        os.makedirs(self.path, exist_ok=True)
        entries = [e for e in sorted(os.listdir(self.path))
                   if os.path.isdir(os.path.join(self.path, e))
                   and not e.startswith(".")]

        def one(entry: str) -> Index:
            return Index(os.path.join(self.path, entry), entry,
                         fsync=self.fsync,
                         snapshot_submit=self._submit,
                         health=self.storage_health).open()

        if len(entries) <= 1:
            opened = map(one, entries)
        else:
            with ThreadPoolExecutor(
                    max_workers=min(self.OPEN_WORKERS, len(entries))) as pool:
                opened = list(pool.map(one, entries))
        for entry, idx in zip(entries, opened):
            self.indexes[entry] = idx
        return self

    def close(self) -> None:
        """Drain the background compactions, then close every index,
        which compacts every fragment with op-log records left."""
        if self.snapshot_queue is not None:
            self.snapshot_queue.close()
        with self._lock:
            for idx in self.indexes.values():
                idx.close()
            self.indexes.clear()
        self.storage_health.close()

    def create_index(self, name: str, *, keys: bool = False,
                     track_existence: bool = True,
                     created_at: float = 0.0) -> Index:
        with self._lock:
            if name in self.indexes:
                raise ValueError(f"index {name!r} already exists")
            if not re.fullmatch(r"[a-z][a-z0-9_-]{0,229}", name):
                raise ValueError(f"invalid name {name!r}")
            idx = Index(os.path.join(self.path, name), name, keys=keys,
                        track_existence=track_existence, fsync=self.fsync,
                        created_at=created_at or time.time(),
                        snapshot_submit=self._submit,
                        health=self.storage_health)
            os.makedirs(idx.path, exist_ok=True)
            idx.save_meta()
            idx.open()
            self.indexes[name] = idx
            return idx

    def index(self, name: str) -> Index | None:
        return self.indexes.get(name)

    def delete_index(self, name: str, release=None) -> None:
        """Remove an index and its directory (``KeyError`` when absent).
        The reference closes it first, which compacts every dirty
        fragment only for the files to be removed; the port discards
        them instead (:meth:`Index.discard`), drops its queued
        compactions, and runs ``release(path)`` (the caller's, to close
        the key stores and drop the cached planes) before the removal."""
        with self._lock:
            idx = self.indexes.pop(name, None)
            if idx is None:
                raise KeyError(name)
            idx.discard()
            self.forget_path(idx.path)
            if release is not None:
                release(idx.path)
            shutil.rmtree(idx.path, ignore_errors=True)

    def forget_path(self, path: str) -> None:
        """Drop the background compactions queued under ``path``."""
        if self.snapshot_queue is not None:
            self.snapshot_queue.forget(path)

    def schema(self) -> list[dict]:
        """JSON-able schema dump, the shape ``pilosa_tpu`` returns."""
        out = []
        with self._lock:
            for iname, idx in sorted(self.indexes.items()):
                fields = []
                for fname, f in sorted(idx.fields.items()):
                    if fname.startswith("_"):
                        continue
                    o = f.options
                    fields.append({
                        "name": fname,
                        "options": {
                            "type": o.type, "keys": o.keys,
                            "cacheType": o.cache_type,
                            "cacheSize": o.cache_size,
                            "timeQuantum": o.time_quantum,
                            "min": o.min, "max": o.max, "base": o.base,
                            "bitDepth": o.bit_depth, "scale": o.scale,
                            "epoch": o.epoch, "timeUnit": o.time_unit,
                        },
                        "createdAt": o.created_at,
                    })
                out.append({"name": iname,
                            "options": {"keys": idx.keys,
                                        "trackExistence":
                                            idx.track_existence},
                            "createdAt": idx.created_at,
                            "fields": fields})
        return out

    def apply_schema(self, schema: list[dict]) -> None:
        """Create the indexes and fields of a schema dump that are
        missing (the reference's restore and schema sync)."""
        for ispec in schema:
            idx = self.indexes.get(ispec["name"])
            if idx is None:
                opts = ispec.get("options", {})
                idx = self.create_index(
                    ispec["name"], keys=opts.get("keys", False),
                    track_existence=opts.get("trackExistence", True),
                    created_at=ispec.get("createdAt", 0.0))
            for fspec in ispec.get("fields", []):
                if fspec["name"] in idx.fields:
                    continue
                o = fspec.get("options", {})
                idx.create_field(fspec["name"], FieldOptions(
                    type=o.get("type", "set"), keys=o.get("keys", False),
                    cache_type=o.get("cacheType", "ranked"),
                    cache_size=o.get("cacheSize", 50000),
                    time_quantum=o.get("timeQuantum", ""),
                    min=o.get("min"), max=o.get("max"),
                    base=o.get("base", 0), bit_depth=o.get("bitDepth", 0),
                    scale=o.get("scale", 0), epoch=o.get("epoch", ""),
                    time_unit=o.get("timeUnit", "s"),
                    created_at=fspec.get("createdAt", 0.0)))
