"""A bound on live snapshot maps (``pilosa_tpu.store.syswrap``'s
``MapPool``, the reference's mmap-to-heap fallback).

Every open fragment maps its snapshot, and on Unix each ``mmap`` holds a
duplicate of its file descriptor.  A holder of tens of thousands of
fragments (a time field keeps one view per quantum unit per shard) would
exhaust the process's descriptors.  :data:`GLOBAL` tracks live maps in
open order; past its cap the oldest holder is DEMOTED: its directory is
re-parsed over a heap copy of the blob and the map is released, so every
read keeps working and memory is traded for descriptors.  The cap is
half the descriptor limit (at most the reference's 32768): the rest stays
for op-log appends, sockets and the CUDA driver.
"""

from __future__ import annotations

import os
import resource
import threading
import weakref
from collections import OrderedDict

from pilosa_tpu_torch import fault

MAX_MAPS = 32768  # the reference's cap (under Linux's vm.max_map_count)


def checked_write(f, data: bytes) -> int:
    """``f.write`` through the ``sys.write`` failpoint: ``error`` raises
    :class:`~pilosa_tpu_torch.fault.FaultError` (an OSError: a disk write
    failure), ``torn_write`` persists the first ``args.offset`` bytes and
    raises (a crash mid-write).  Durable writers (op-logs, snapshots, hint
    logs, the disk probe) write through it."""
    if fault.ACTIVE:
        spec = fault.fire("sys.write", path=getattr(f, "name", ""))
        if spec is not None and spec["action"] == "torn_write":
            fault.torn_write(f, data, spec)
    return f.write(data)


def checked_fsync(f) -> None:
    """``os.fsync`` through the ``sys.fsync`` failpoint (``error`` raises,
    ``delay`` is a stalling disk)."""
    if fault.ACTIVE:
        fault.fire("sys.fsync", path=getattr(f, "name", ""))
    os.fsync(f.fileno())


def default_max_maps() -> int:
    soft, _ = resource.getrlimit(resource.RLIMIT_NOFILE)
    if soft == resource.RLIM_INFINITY:
        return MAX_MAPS
    return max(16, min(MAX_MAPS, soft // 2))


class MapPool:
    def __init__(self, max_maps: int | None = None):
        self.max_maps = default_max_maps() if max_maps is None else max_maps
        self._lock = threading.Lock()
        self._order: OrderedDict = OrderedDict()  # id -> weakref(fragment)

    def set_max(self, n: int) -> None:
        """Cap live maps at ``n`` (the ``max_map_count`` config key),
        never past half the descriptor limit."""
        self.max_maps = max(1, min(int(n), default_max_maps()))

    @property
    def live(self) -> int:
        with self._lock:
            return len(self._order)

    def register(self, frag) -> None:
        """Track ``frag``'s new map; past the cap, demote the oldest
        holders to heap copies.  Demotion takes the victim's own lock with
        a timeout, outside this pool's lock: on contention the victim
        keeps its map and stays tracked (the cap is soft for it) rather
        than risk a lock-order deadlock between two opening fragments.
        The ``sys.mmap`` failpoint's ``error`` is a map slot or descriptor
        running out at registration."""
        if fault.ACTIVE:
            fault.fire("sys.mmap", path=getattr(frag, "path", ""))
        victims = []
        with self._lock:
            while len(self._order) >= self.max_maps:
                _, ref = self._order.popitem(last=False)
                v = ref()
                if v is not None:
                    victims.append(v)
            self._order[id(frag)] = weakref.ref(frag)
        for v in victims:
            if not v._demote_map():
                with self._lock:
                    self._order[id(v)] = weakref.ref(v)
                    self._order.move_to_end(id(v), last=False)

    def release(self, frag) -> None:
        with self._lock:
            self._order.pop(id(frag), None)


GLOBAL = MapPool()
