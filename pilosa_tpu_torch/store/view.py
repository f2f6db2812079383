"""View: the fragments of one flavor of one field, created per shard on
demand (the ``standard`` view for set and time fields, ``standard_<time>``
for a time field's quantum views, ``bsi_<field>`` for the bit-sliced rows
of an integer field)."""

from __future__ import annotations

import os
import threading

from pilosa_tpu_torch.store.fragment import Fragment

VIEW_STANDARD = "standard"
VIEW_BSI_PREFIX = "bsi_"


class View:
    def __init__(self, path: str, name: str, *, fsync: bool = False,
                 snapshot_submit=None, health=None):
        self.path = path  # <field>/views/<name>
        self.name = name
        self.fsync = fsync
        self.snapshot_submit = snapshot_submit
        self.health = health  # the holder's StorageHealth
        self.fragments: dict[int, Fragment] = {}
        self._lock = threading.RLock()

    def open(self) -> "View":
        frag_dir = os.path.join(self.path, "fragments")
        if os.path.isdir(frag_dir):
            # a fragment exists if either its snapshot or its op-log does
            shards: set[int] = set()
            for entry in os.listdir(frag_dir):
                if entry.isdigit():
                    shards.add(int(entry))
                elif entry.endswith(".oplog") and entry[:-6].isdigit():
                    shards.add(int(entry[:-6]))
            for shard in sorted(shards):
                self.fragments[shard] = Fragment(
                    os.path.join(frag_dir, str(shard)), shard,
                    fsync=self.fsync,
                    snapshot_submit=self.snapshot_submit,
                    health=self.health).open()
        return self

    def fragment(self, shard: int, create: bool = False) -> Fragment | None:
        with self._lock:
            frag = self.fragments.get(shard)
            if frag is None and create:
                path = os.path.join(self.path, "fragments", str(shard))
                os.makedirs(os.path.dirname(path), exist_ok=True)
                frag = Fragment(path, shard, fsync=self.fsync,
                                snapshot_submit=self.snapshot_submit,
                                health=self.health).open()
                self.fragments[shard] = frag
            return frag

    def available_shards(self) -> list[int]:
        with self._lock:
            return sorted(s for s, f in self.fragments.items() if f.present)

    def generations(self, shards) -> tuple:
        """Fragment generation per shard (-1 = absent)."""
        with self._lock:
            frags = self.fragments
            return tuple(frags[s].generation if s in frags else -1
                         for s in shards)

    def generations_fast(self, shards) -> tuple:
        """:meth:`generations` without the view lock: dict lookups and int
        reads are atomic under the interpreter lock, and fragments bump
        their generation under their own lock anyway.  A read torn by a
        concurrent fragment creation only gives a conservative mismatch
        (the caller revalidates under the locks), never a stale hit."""
        frags = self.fragments
        out = []
        for s in shards:
            f = frags.get(s)
            out.append(f.generation if f is not None else -1)
        return tuple(out)

    def close(self) -> None:
        with self._lock:
            for frag in self.fragments.values():
                frag.close()

    def discard(self) -> None:
        """Close every fragment without compacting it (:meth:`Fragment.
        discard`): the view's files are about to be removed."""
        with self._lock:
            for frag in self.fragments.values():
                frag.discard()
