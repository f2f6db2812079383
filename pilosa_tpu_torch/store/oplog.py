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
Appends go through the ``oplog.append`` failpoint (a ``torn_write``
relative to the record) and :func:`~.syswrap.checked_write`.

:class:`IdWindow` is the durable dedup window of applied operation ids
(the reference's, byte for byte): a replayed or re-sent hint, or a
forwarded import batch, whose id it holds is a no-op.

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
from collections import OrderedDict
from typing import Iterator

import numpy as np

from pilosa_tpu_torch import fault
from pilosa_tpu_torch.store import roaring, syswrap

OP_SET_BITS = 1
OP_CLEAR_BITS = 2
OP_CLEAR_ROW = 3
OP_SET_ROW = 4

_HEADER = struct.Struct("<IBQI")

RAW_FLAG = 0x80           # op-byte flag: payload is raw <u8 positions
RAW_MAX_POSITIONS = 4096  # beyond this, roaring wins on size


def _clean_prefix_end(buf: bytes, header: struct.Struct = _HEADER) -> int:
    """Byte offset where the whole-record prefix of ``buf`` ends.  Every
    CRC-framed log here (op-log, hint log) has one shape: a crc32 of
    everything after it first, the payload length last in ``header``."""
    pos = 0
    while pos + header.size <= len(buf):
        fields = header.unpack_from(buf, pos)
        end = pos + header.size + fields[-1]
        if end > len(buf) or zlib.crc32(buf[pos + 4:end]) != fields[0]:
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
               sync_batch: SyncBatch | None = None,
               serialized: bytes | None = None) -> None:
        """Append one record; with ``fsync`` on it is synced before the
        call returns, or, given ``sync_batch``, at the batch's flush.
        ``serialized``: ``roaring.serialize(positions)``, already made by
        the caller."""
        if positions is None:
            payload = b""
        elif len(positions) <= RAW_MAX_POSITIONS:
            payload = np.asarray(positions, "<u8").tobytes()
            op |= RAW_FLAG
        else:
            payload = (serialized if serialized is not None
                       else roaring.serialize(positions))
        body = struct.pack("<BQI", op, aux, len(payload)) + payload
        record = struct.pack("<I", zlib.crc32(body)) + body
        try:
            with open(self.path, "ab") as f:
                if fault.ACTIVE:
                    # a torn tail relative to THIS record: replay must
                    # recover the clean prefix whatever the offset
                    spec = fault.fire("oplog.append", path=self.path, op=op)
                    if spec is not None and spec["action"] == "torn_write":
                        fault.torn_write(f, record, spec)
                syswrap.checked_write(f, record)
                f.flush()
                if self.fsync:
                    if sync_batch is not None:
                        sync_batch.note(self)
                    else:
                        syswrap.checked_fsync(f)
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
            if fault.ACTIVE:
                fault.fire("sys.fsync", path=self.path)
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


class IdWindow:
    """Durable bounded set of applied operation ids: the receiver's dedup
    window behind hint replay and forwarded imports (a re-delivered batch
    must be a no-op, or a replayed ``Clear`` could land after a newer
    direct ``Set``).  CRC-framed appends through
    :func:`~.syswrap.checked_write`, clean-prefix replay on open.  Record
    layout::

        u32 crc32 (of everything after this field)
        u8  len   id byte length
        id        utf-8 op id

    The newest ``cap`` ids are held in memory; once the file carries more
    than ``2 * cap`` records it is rewritten (tmp + rename) down to them.
    """

    _HEAD = struct.Struct("<IB")

    def __init__(self, path: str, cap: int = 8192):
        self.path = path
        self.cap = int(cap)
        self._lock = threading.Lock()
        self._ids: OrderedDict[str, None] = OrderedDict()
        self._f = None
        self._file_records = 0
        self._load()

    def _load(self) -> None:
        if not os.path.exists(self.path):
            return
        with open(self.path, "rb") as f:
            buf = f.read()
        pos = 0
        while pos + self._HEAD.size <= len(buf):
            crc, ln = self._HEAD.unpack_from(buf, pos)
            end = pos + self._HEAD.size + ln
            if end > len(buf) or zlib.crc32(buf[pos + 4:end]) != crc:
                break
            try:
                op_id = buf[pos + self._HEAD.size:end].decode()
            except UnicodeDecodeError:
                break
            self._ids[op_id] = None
            self._ids.move_to_end(op_id)
            self._file_records += 1
            pos = end
        if pos < len(buf):
            with open(self.path, "r+b") as f:
                f.truncate(pos)
        while len(self._ids) > self.cap:
            self._ids.popitem(last=False)

    @staticmethod
    def _record(op_id: str) -> bytes:
        raw = op_id.encode()
        body = struct.pack("<B", len(raw)) + raw
        return struct.pack("<I", zlib.crc32(body)) + body

    def __contains__(self, op_id: str) -> bool:
        with self._lock:
            return op_id in self._ids

    def add(self, op_id: str) -> bool:
        """Record one applied id durably; False when already held."""
        with self._lock:
            if op_id in self._ids:
                return False
            if self._f is None:
                d = os.path.dirname(self.path)
                if d:
                    os.makedirs(d, exist_ok=True)
                self._f = open(self.path, "ab")
            syswrap.checked_write(self._f, self._record(op_id))
            self._f.flush()
            self._ids[op_id] = None
            self._file_records += 1
            while len(self._ids) > self.cap:
                self._ids.popitem(last=False)
            if self._file_records > 2 * self.cap:
                self._compact()
            return True

    def _compact(self) -> None:
        """Rewrite the file down to the in-memory window (the caller
        holds the lock); a crash leaves either file, both recover."""
        if self._f is not None:
            self._f.close()
            self._f = None
        tmp = self.path + ".tmp"
        with open(tmp, "wb") as f:
            for op_id in self._ids:
                f.write(self._record(op_id))
        os.replace(tmp, self.path)
        self._file_records = len(self._ids)

    def __len__(self) -> int:
        with self._lock:
            return len(self._ids)

    def close(self) -> None:
        with self._lock:
            if self._f is not None:
                self._f.close()
                self._f = None
