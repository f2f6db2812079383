"""AttrStore: key/value attributes per row or column, in the on-disk format
of ``pilosa_tpu.store.attrs``: one sqlite database per index (column
attributes) and per field (row attributes), table ``attrs(id INTEGER
PRIMARY KEY, data TEXT NOT NULL)`` holding one JSON object per id
(``sort_keys=True``).  A write merges into the id's map and a ``None``
value deletes a key.

Block checksums (``HASH_BLOCK_SIZE`` ids per block) and the block
read/merge calls serve anti-entropy between replicas.
"""

from __future__ import annotations

import json
import os
import sqlite3
import threading
import zlib

HASH_BLOCK_SIZE = 100

_UPSERT = ("INSERT INTO attrs(id, data) VALUES(?, ?) "
           "ON CONFLICT(id) DO UPDATE SET data=excluded.data")


class AttrStore:
    """One attribute store; each thread reads through a connection of its
    own, writes go under one lock."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path), exist_ok=True)
        self._local = threading.local()
        self._lock = threading.Lock()
        self._conn().execute("CREATE TABLE IF NOT EXISTS attrs ("
                             "id INTEGER PRIMARY KEY, data TEXT NOT NULL)")

    def _conn(self) -> sqlite3.Connection:
        conn = getattr(self._local, "conn", None)
        if conn is None:
            conn = sqlite3.connect(self.path)
            conn.isolation_level = None  # autocommit: each write is atomic
            self._local.conn = conn
        return conn

    def _current(self, conn, item_id: int) -> dict:
        row = conn.execute("SELECT data FROM attrs WHERE id=?",
                           (item_id,)).fetchone()
        return json.loads(row[0]) if row else {}

    # -- api ----------------------------------------------------------------

    def set_attrs(self, item_id: int, attrs: dict) -> dict:
        """Merge ``attrs`` into the item's map (a ``None`` value deletes
        the key); returns the resulting map."""
        with self._lock:
            conn = self._conn()
            current = self._current(conn, item_id)
            for k, v in attrs.items():
                if v is None:
                    current.pop(k, None)
                else:
                    current[k] = v
            if current:
                conn.execute(_UPSERT, (item_id,
                                       json.dumps(current, sort_keys=True)))
            else:
                conn.execute("DELETE FROM attrs WHERE id=?", (item_id,))
            return current

    def attrs(self, item_id: int) -> dict:
        return self._current(self._conn(), item_id)

    def attrs_many(self, ids) -> list[dict]:
        return [self.attrs(int(i)) for i in ids]

    def find_ids(self, name: str, value) -> list[int]:
        """Ids whose attribute ``name`` equals ``value`` (TopN's
        ``attrName=`` / ``attrValue=`` filter)."""
        cur = self._conn().execute("SELECT id, data FROM attrs")
        return [int(item_id) for item_id, data in cur.fetchall()
                if json.loads(data).get(name) == value]

    # -- anti-entropy -------------------------------------------------------

    def blocks(self) -> dict[int, int]:
        """CRC of each block's (id, JSON) pairs, by block."""
        out: dict[int, int] = {}
        cur = self._conn().execute("SELECT id, data FROM attrs ORDER BY id")
        for item_id, data in cur.fetchall():
            blk = int(item_id) // HASH_BLOCK_SIZE
            out[blk] = zlib.crc32(f"{item_id}:{data}".encode(),
                                  out.get(blk, 0))
        return out

    def block_items(self, block: int) -> dict[int, dict]:
        lo, hi = block * HASH_BLOCK_SIZE, (block + 1) * HASH_BLOCK_SIZE
        cur = self._conn().execute(
            "SELECT id, data FROM attrs WHERE id>=? AND id<?", (lo, hi))
        return {int(i): json.loads(d) for i, d in cur.fetchall()}

    def merge_items(self, items: dict[int, dict]) -> int:
        """Union-merge a peer's maps: its keys fill in what is missing and
        local keys win conflicts, so two replicas converge either way.
        Returns the items changed."""
        changed = 0
        for item_id, attrs in items.items():
            with self._lock:
                conn = self._conn()
                current = self._current(conn, item_id)
                merged = {**attrs, **current}
                if merged != current:
                    conn.execute(_UPSERT, (item_id,
                                           json.dumps(merged,
                                                      sort_keys=True)))
                    changed += 1
        return changed

    def close(self) -> None:
        conn = getattr(self._local, "conn", None)
        if conn is not None:
            conn.close()
            self._local.conn = None
