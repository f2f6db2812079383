"""String key <-> uint64 id translation stores, in the on-disk format of
``pilosa_tpu.store.translate``: one sqlite database per key log, table
``keys(id INTEGER PRIMARY KEY, key TEXT NOT NULL UNIQUE)``, so either
package opens the other's stores and reads the same ids.

- ids are sequential from 1 (0 never maps to a key, so a zero result
  cannot be mistranslated); ``len(store)`` is the high-water id;
- opening is O(1): no replay, ``max(id)`` comes from the index;
- two bounded LRU read caches (key -> id, id -> key) sit in front of the
  database instead of the whole mapping;
- ``translate`` and ``append_replicated`` write a whole batch in one
  commit (WAL, ``synchronous=FULL``: one fsync per batch); lookups run
  chunked ``IN`` queries.

``partition_of`` places a key in one of 256 hash partitions (FNV-1a 64),
as the reference's cluster layer does; ``append_replicated`` and
``tail`` stream a store's log to a replica.

Legacy migration: an older layout kept a CRC-framed append-only
``.keys`` log.  On first open of an empty sqlite store next to such a
log, the log is replayed once into sqlite (same ids) and renamed to
``.keys.migrated``; nothing is deleted.
"""

from __future__ import annotations

import logging
import os
import sqlite3
import struct
import threading
import zlib
from collections import OrderedDict

import numpy as np

PARTITION_N = 256  # the cluster-wide partition count

# default LRU capacity per direction (entries); override per store with
# the ``cache_size`` argument
DEFAULT_CACHE_SIZE = 1 << 19

_SQL_CHUNK = 3000  # bound variables per IN query (sqlite caps at 32766)

_log = logging.getLogger(__name__)


def fnv1a64(data: bytes) -> int:
    """FNV-1a 64-bit: the key hash of partition placement."""
    h = 0xCBF29CE484222325
    for b in data:
        h ^= b
        h = (h * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h


def partition_of(key: str, n: int = PARTITION_N) -> int:
    return fnv1a64(key.encode()) % n


def _read_legacy_log(path: str):
    """Yield the keys of a CRC-framed ``.keys`` log, stopping at the
    first torn or corrupt record (everything before it is good)."""
    with open(path, "rb") as f:
        buf = f.read()
    pos = 0
    while pos + 8 <= len(buf):
        crc, ln = struct.unpack_from("<II", buf, pos)
        end = pos + 8 + ln
        if end > len(buf) or zlib.crc32(buf[pos + 4:end]) != crc:
            return
        yield buf[pos + 8:end].decode()
        pos = end


class _LRU:
    """Bounded LRU map (OrderedDict move-to-end)."""

    __slots__ = ("cap", "_d")

    def __init__(self, cap: int):
        self.cap = cap
        self._d: OrderedDict = OrderedDict()

    def get(self, k):
        d = self._d
        v = d.get(k)
        if v is not None:
            d.move_to_end(k)
        return v

    def put(self, k, v) -> None:
        d = self._d
        d[k] = v
        d.move_to_end(k)
        if len(d) > self.cap:
            d.popitem(last=False)

    def __len__(self) -> int:
        return len(self._d)


class KeyStore:
    """One persistent key store with sequential ids: the id of the i-th
    created key is ``i + 1``.  Every method is safe under concurrent
    callers (one RLock, one connection)."""

    def __init__(self, path: str, cache_size: int = DEFAULT_CACHE_SIZE):
        self.path = path
        self._lock = threading.RLock()
        self._key2id = _LRU(cache_size)
        self._id2key = _LRU(cache_size)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._db = sqlite3.connect(path, check_same_thread=False)
        self._db.execute("PRAGMA journal_mode=WAL")
        self._db.execute("PRAGMA synchronous=FULL")
        # a ceiling, not an allocation: random-order inserts churn the
        # UNIQUE btree, and sqlite's 2 MB default cache slows creation
        # once the tree outgrows it
        self._db.execute("PRAGMA cache_size=-131072")
        self._db.execute(
            "CREATE TABLE IF NOT EXISTS keys"
            "(id INTEGER PRIMARY KEY, key TEXT NOT NULL UNIQUE)")
        self._db.commit()
        row = self._db.execute("SELECT max(id) FROM keys").fetchone()
        self._n = int(row[0] or 0)
        self._migrate_legacy()

    def _migrate_legacy(self) -> None:
        legacy = (self.path[:-len(".sqlite")] + ".keys"
                  if self.path.endswith(".sqlite") else self.path + ".keys")
        if self._n or not os.path.exists(legacy):
            return
        batch: list[tuple[int, str]] = []
        for key in _read_legacy_log(legacy):
            self._n += 1
            batch.append((self._n, key))
            if len(batch) >= 65536:
                self._db.executemany(
                    "INSERT INTO keys(id, key) VALUES(?, ?)", batch)
                batch.clear()
        if batch:
            self._db.executemany(
                "INSERT INTO keys(id, key) VALUES(?, ?)", batch)
        self._db.commit()
        os.rename(legacy, legacy + ".migrated")

    # -- lookups ------------------------------------------------------------

    def _fetch_ids(self, keys: list[str]) -> dict[str, int]:
        """Database lookup of ``keys`` (no cache check); fills the
        cache."""
        found: dict[str, int] = {}
        for i in range(0, len(keys), _SQL_CHUNK):
            chunk = keys[i:i + _SQL_CHUNK]
            q = ("SELECT key, id FROM keys WHERE key IN (%s)"
                 % ",".join("?" * len(chunk)))
            for k, kid in self._db.execute(q, chunk):
                found[k] = kid
                self._key2id.put(k, kid)
        return found

    def _fetch_keys(self, ids: list[int]) -> dict[int, str]:
        found: dict[int, str] = {}
        for i in range(0, len(ids), _SQL_CHUNK):
            chunk = ids[i:i + _SQL_CHUNK]
            q = ("SELECT id, key FROM keys WHERE id IN (%s)"
                 % ",".join("?" * len(chunk)))
            for kid, k in self._db.execute(q, chunk):
                found[kid] = k
                self._id2key.put(kid, k)
        return found

    def _insert(self, rows: list[tuple[int, str]], n0: int) -> None:
        """Commit ``rows`` in one transaction.  A failed commit rolls
        back and restores the high-water id ``n0``: replication arithmetic
        reads ``len(store)``, and a counter ahead of the database would
        give a later key another id than a replica gives it."""
        try:
            self._db.executemany(
                "INSERT INTO keys(id, key) VALUES(?, ?)", rows)
            self._db.commit()
        except sqlite3.Error:
            self._db.rollback()
            self._n = n0
            raise
        for kid, k in rows:
            self._key2id.put(k, kid)

    # -- api ----------------------------------------------------------------

    def translate(self, keys: list[str],
                  create: bool = False) -> list[int | None]:
        """Keys -> ids; an unknown key gets a new id with ``create``, else
        None.  A key repeated within the batch gets one id, and the whole
        created tail commits in one transaction."""
        out: list[int | None] = [None] * len(keys)
        with self._lock:
            misses: list[int] = []
            for i, k in enumerate(keys):
                kid = self._key2id.get(k)
                if kid is None:
                    misses.append(i)
                else:
                    out[i] = kid
            if misses:
                found = self._fetch_ids(
                    list({keys[i]: None for i in misses}))
                new: dict[str, int] = {}
                rows: list[tuple[int, str]] = []
                n0 = self._n
                for i in misses:
                    k = keys[i]
                    kid = found.get(k)
                    if kid is None:
                        kid = new.get(k)
                        if kid is None and create:
                            self._n += 1
                            kid = new[k] = self._n
                            rows.append((kid, k))
                    out[i] = kid
                if rows:
                    self._insert(rows, n0)
        return out

    def append_replicated(self, start_id: int, keys: list[str]) -> None:
        """Apply a replicated batch whose ids the coordinator assigned from
        ``start_id``.  A batch may overlap what the store holds (applied
        once); a gap means a batch was missed and the tail must be pulled
        first."""
        with self._lock:
            if start_id > self._n + 1:
                raise KeyError(
                    f"translate gap: have {self._n} keys, batch starts at "
                    f"{start_id}")
            skip = self._n + 1 - start_id
            rows = []
            n0 = self._n
            for k in keys[skip:]:
                self._n += 1
                rows.append((self._n, k))
            if rows:
                self._insert(rows, n0)

    def tail(self, after_id: int, limit: int | None = None) -> list[str]:
        """Keys with ids > ``after_id`` in id order, at most ``limit``."""
        with self._lock:
            if limit is None:
                cur = self._db.execute(
                    "SELECT key FROM keys WHERE id > ? ORDER BY id",
                    (after_id,))
            else:
                cur = self._db.execute(
                    "SELECT key FROM keys WHERE id > ? ORDER BY id "
                    "LIMIT ?", (after_id, limit))
            return [r[0] for r in cur]

    def key_of(self, kid: int) -> str | None:
        with self._lock:
            if not 1 <= kid <= self._n:
                return None
            k = self._id2key.get(kid)
            if k is None:
                row = self._db.execute(
                    "SELECT key FROM keys WHERE id = ?", (kid,)).fetchone()
                if row is None:
                    return None
                k = row[0]
                self._id2key.put(kid, k)
            return k

    def keys_of(self, ids, strict: bool = True) -> list:
        """Ids -> keys under one lock acquisition.  ``strict`` raises
        ``KeyError`` on an id with no key; otherwise such an id yields
        None."""
        with self._lock:
            out: list[str | None] = [None] * len(ids)
            misses: list[int] = []
            for i, kid in enumerate(ids):
                k = self._id2key.get(int(kid))
                if k is None:
                    misses.append(i)
                out[i] = k
            if misses:
                found = self._fetch_keys(
                    list({int(ids[i]): None for i in misses}))
                for i in misses:
                    out[i] = found.get(int(ids[i]))
            if strict:
                for i, k in enumerate(out):
                    if k is None:
                        raise KeyError(f"no key for id {int(ids[i])}")
            return out

    def __len__(self) -> int:
        with self._lock:
            return self._n

    def cache_info(self) -> dict:
        """Resident cache entries per direction, the cap and the
        high-water id."""
        with self._lock:
            return {"key2id": len(self._key2id), "id2key": len(self._id2key),
                    "cap": self._key2id.cap, "n": self._n}

    def close(self) -> None:
        with self._lock:
            if self._db is not None:
                self._db.commit()
                self._db.close()
                self._db = None


class TranslateStore:
    """Every key store of one holder, opened on first use:
    ``<data>/<index>/_keys/_columns.sqlite`` for an index's column keys
    and ``<data>/<index>/_keys/<field>.sqlite`` for a field's row keys."""

    def __init__(self, holder_path: str,
                 cache_size: int = DEFAULT_CACHE_SIZE):
        self.holder_path = holder_path
        self.cache_size = cache_size
        self._logs: dict[tuple[str, str | None], KeyStore] = {}
        self._lock = threading.Lock()

    def _log(self, index: str, field: str | None) -> KeyStore:
        with self._lock:
            log = self._logs.get((index, field))
            if log is None:
                name = "_columns" if field is None else field
                path = os.path.join(self.holder_path, index, "_keys",
                                    f"{name}.sqlite")
                log = self._logs[(index, field)] = KeyStore(
                    path, cache_size=self.cache_size)
            return log

    def columns(self, index: str) -> KeyStore:
        return self._log(index, None)

    def rows(self, index: str, field: str) -> KeyStore:
        return self._log(index, field)

    def list_stores(self) -> list[tuple[str, str | None]]:
        """Every ``(index, field | None)`` key store of the holder: the
        ones open in this process and the ones on disk."""
        seen: set[tuple[str, str | None]] = set()
        with self._lock:
            seen.update(self._logs)
        try:
            for index in os.listdir(self.holder_path):
                kdir = os.path.join(self.holder_path, index, "_keys")
                if not os.path.isdir(kdir):
                    continue
                for fn in os.listdir(kdir):
                    if fn.endswith(".sqlite"):
                        name = fn[:-len(".sqlite")]
                        seen.add((index,
                                  None if name == "_columns" else name))
        except FileNotFoundError:
            pass  # a fresh holder: the open stores are the answer
        except OSError as e:
            # persisted stores may be hidden: answer with what is known
            _log.warning("listing key stores under %s: %s",
                         self.holder_path, e)
        return sorted(seen, key=lambda t: (t[0], t[1] or ""))

    def _paths(self, index: str, name: str) -> list[str]:
        base = os.path.join(self.holder_path, index, "_keys", name)
        return [base + s for s in
                (".sqlite", ".sqlite-wal", ".sqlite-shm",
                 ".keys", ".keys.migrated")]

    def drop(self, index: str, field: str | None = None,
             remove_files: bool = False) -> None:
        """Forget the open stores of a deleted index (all of them) or of
        one field, so a recreated index or field starts with no keys;
        ``remove_files`` also deletes that field's files."""
        with self._lock:
            if field is not None:
                log = self._logs.pop((index, field), None)
                if log is not None:
                    log.close()
                if remove_files:
                    for path in self._paths(index, field):
                        try:
                            os.remove(path)
                        except FileNotFoundError:
                            pass  # the wal, shm and legacy files are optional
                        except OSError as e:
                            # the dead field's keys would outlive it
                            _log.warning("removing %s: %s", path, e)
                return
            for key in [k for k in self._logs if k[0] == index]:
                self._logs.pop(key).close()

    def close(self) -> None:
        with self._lock:
            for log in self._logs.values():
                log.close()
            self._logs.clear()
