"""Append-only operation log for fragment durability.

A copy of the record format of ``pilosa_tpu.store.oplog``, so the port
replays logs the JAX package wrote and writes logs it replays.  Record
layout (little-endian):

    u32 crc32 (of everything after this field)
    u8  op     (1=SET_BITS, 2=CLEAR_BITS, 3=CLEAR_ROW, 4=SET_ROW;
                high bit 0x80 = payload is raw u64 positions)
    u64 aux    (row id for CLEAR_ROW/SET_ROW, else 0)
    u32 len    payload byte length
    payload    roaring-serialized (or raw) bit positions

Replay stops at, and truncates, the first torn or corrupt record.

A :class:`SyncBatch` (``pilosa_tpu.store.oplog``'s) makes an import batch
the unit of durability: a log that fsyncs notes itself on the batch at
each append, and the batch's :meth:`SyncBatch.flush` fsyncs each noted
log once.
"""

from __future__ import annotations

import os
import struct
import threading
import zlib
from typing import Iterator

import numpy as np

from pilosa_tpu_torch.store import roaring

OP_SET_BITS = 1
OP_CLEAR_BITS = 2
OP_CLEAR_ROW = 3
OP_SET_ROW = 4

_HEADER = struct.Struct("<IBQI")

RAW_FLAG = 0x80           # op-byte flag: payload is raw <u8 positions
RAW_MAX_POSITIONS = 4096  # beyond this, roaring wins on size


def _clean_prefix_end(buf: bytes) -> int:
    """Byte offset where the whole-record prefix of ``buf`` ends."""
    pos = 0
    while pos + _HEADER.size <= len(buf):
        crc, _, _, plen = _HEADER.unpack_from(buf, pos)
        end = pos + _HEADER.size + plen
        if end > len(buf) or zlib.crc32(buf[pos + 4:end]) != crc:
            break
        pos = end
    return pos


class SyncBatch:
    """Fsync coalescer for one import batch: every append inside the
    batch to a log with ``fsync`` on notes the log here instead of
    fsyncing, and :meth:`flush` fsyncs each noted log once, at the batch
    boundary.  A crash before the flush may lose the batch's unsynced
    tail; replay still recovers a record-boundary prefix."""

    def __init__(self):
        self._logs: dict[int, "OpLog"] = {}
        self._lock = threading.Lock()

    def note(self, log: "OpLog") -> None:
        with self._lock:
            self._logs[id(log)] = log

    def flush(self) -> int:
        """Fsync every noted log once; returns how many were synced."""
        with self._lock:
            logs, self._logs = list(self._logs.values()), {}
        for log in logs:
            log.sync()
        return len(logs)


class OpLog:
    """One fragment's op log.  Not thread-safe; the fragment serializes.
    The file is opened for each append, not held: a holder has one log
    per fragment, tens of thousands with time views."""

    def __init__(self, path: str, fsync: bool = False):
        self.path = path
        self.fsync = fsync

    def append(self, op: int, aux: int = 0,
               positions: np.ndarray | None = None,
               sync_batch: SyncBatch | None = None) -> None:
        """Append one record; with ``fsync`` on it is synced before the
        call returns, or, given ``sync_batch``, at the batch's flush."""
        if positions is None:
            payload = b""
        elif len(positions) <= RAW_MAX_POSITIONS:
            payload = np.asarray(positions, "<u8").tobytes()
            op |= RAW_FLAG
        else:
            payload = roaring.serialize(positions)
        body = struct.pack("<BQI", op, aux, len(payload)) + payload
        record = struct.pack("<I", zlib.crc32(body)) + body
        try:
            with open(self.path, "ab") as f:
                f.write(record)
                f.flush()
                if self.fsync:
                    if sync_batch is not None:
                        sync_batch.note(self)
                    else:
                        os.fsync(f.fileno())
        except OSError:
            # a short write leaves partial bytes: cut back to the last
            # whole record so the next append lands on a boundary
            with open(self.path, "rb") as f:
                end = _clean_prefix_end(f.read())
            with open(self.path, "r+b") as f:
                f.truncate(end)
            raise

    def replay(self) -> Iterator[tuple[int, int, np.ndarray | None]]:
        """Yield (op, aux, positions) for every whole record."""
        if not os.path.exists(self.path):
            return
        with open(self.path, "rb") as f:
            buf = f.read()
        end = _clean_prefix_end(buf)
        pos = 0
        while pos < end:
            _, op, aux, plen = _HEADER.unpack_from(buf, pos)
            payload = buf[pos + _HEADER.size:pos + _HEADER.size + plen]
            if op & RAW_FLAG:
                positions = np.frombuffer(payload, "<u8").astype(np.uint64)
                op &= ~RAW_FLAG
            else:
                positions = roaring.deserialize(payload) if plen else None
            yield op, aux, positions
            pos += _HEADER.size + plen
        if end < len(buf):
            with open(self.path, "r+b") as f:
                f.truncate(end)

    def sync(self) -> None:
        """Fsync the log if durability is on: the deferred half of a
        batched append.  The file is opened again for it; on Linux an
        fsync through any descriptor flushes the file's data."""
        if not self.fsync:
            return
        try:
            fd = os.open(self.path, os.O_RDONLY)
        except FileNotFoundError:
            return  # never written, or compacted away since
        try:
            os.fsync(fd)
        finally:
            os.close(fd)

    def size(self) -> int:
        try:
            return os.path.getsize(self.path)
        except OSError:
            return 0

    def truncate(self) -> None:
        """Discard the log (after a snapshot compaction)."""
        with open(self.path, "wb"):
            pass

    def close(self) -> None:
        """Nothing to release: each append opens and closes the file."""
