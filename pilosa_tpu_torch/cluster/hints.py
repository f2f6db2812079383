"""Durable hinted handoff: the write-path availability layer
(``pilosa_tpu.cluster.hints``'s; its log files are byte-equal).

Cassandra/Riak-style hinted handoff over the op-log discipline
(CRC-framed records, clean-prefix crash recovery, the torn-write
failpoint of :mod:`pilosa_tpu_torch.store.oplog`).

When a write (strict or best-effort) finds a replica down — breaker
open, suspect, or transport-failed mid-apply — the coordinator appends
the already-translated op to a crash-safe on-disk **hint log** for
that peer and keeps serving on the live replicas.  On peer rejoin (or
breaker close) a replay worker drains the log to the peer through the
idempotent ``POST /internal/hints/replay`` endpoint (receiver dedup by
unique op id), in append order.

Ordering rules that make this exact for Clear-family ops (which have
no tombstones in bit data — a missed clear would otherwise be
resurrected by union-merge anti-entropy):

- a peer with pending hints is **not write-reachable**: new writes to
  it append behind the older hints (one ordered stream per peer)
  until the drain empties the log;
- **AAE defers union-merge** for any fragment sync with a peer that
  has pending hints anywhere in the cluster.  Pending-ness propagates
  on every heartbeat (``hintsFor``) and in the join response, so the
  rejoined stale peer and every up-to-date replica both stop syncing
  with each other before the first AAE tick can run — a replayed
  Clear can never be resurrected by a concurrent sync.

Boundedness: hints older than ``hint_max_age`` flip the op class back
to loud refusal (HTTP 503 + ``Retry-After``) — the log cannot grow
without bound and divergence cannot outlive the age cap + one AAE
round.

On-disk layout: ``<data-dir>/_hints/<peer-utf8-hex>.hints``, one log
per peer.  Record frame (little-endian)::

    u32 crc32 (of everything after this field)
    u64 seq   monotonic per peer (and therefore per (peer, fragment))
    f64 ts    wall-clock append time (drives hint_oldest_seconds)
    u32 len   payload byte length
    payload   JSON op: {"id", "index", "pql", "shards", "field", "op"}

Appends ride :func:`syswrap.checked_write` plus a record-relative
``hints.append`` failpoint (same contract as ``oplog.append``), so
chaos schedules can tear a hint at any byte offset; recovery yields
the clean prefix and truncates the tail.  Ack-compaction rewrites the
log atomically (tmp + rename): a crash mid-ack re-sends at most one
batch, which the receiver's op-id window dedups.
"""

from __future__ import annotations

import json
import os
import struct
import threading
import time
import zlib

from pilosa_tpu_torch import fault
from pilosa_tpu_torch.store import syswrap

_FRAME = struct.Struct("<IQdI")


def _peer_filename(peer: str) -> str:
    return peer.encode().hex() + ".hints"


def _peer_of_filename(name: str) -> str | None:
    if not name.endswith(".hints"):
        return None
    try:
        return bytes.fromhex(name[: -len(".hints")]).decode()
    except ValueError:
        return None


class HintLog:
    """One peer's append-only hint log.  Callers (HintBoard) hold the
    per-peer lock; this class owns only file framing + recovery."""

    def __init__(self, path: str, fsync: bool = False):
        self.path = path
        self.fsync = fsync
        self._f = None
        self._poisoned = False
        # (seq, ts, payload-dict), append order; seq strictly increases
        self.records: list[tuple[int, float, dict]] = []
        self.next_seq = 1
        self._recover()

    def _recover(self) -> None:
        """Clean-prefix recovery, oplog-style: stop at the first torn/
        corrupt record and physically truncate it away."""
        if not os.path.exists(self.path):
            return
        with open(self.path, "rb") as f:
            buf = f.read()
        pos = 0
        good_end = 0
        while pos + _FRAME.size <= len(buf):
            crc, seq, ts, plen = _FRAME.unpack_from(buf, pos)
            end = pos + _FRAME.size + plen
            if end > len(buf):
                break
            body = buf[pos + 4:end]
            if zlib.crc32(body) != crc:
                break
            try:
                payload = json.loads(buf[pos + _FRAME.size:end])
            except ValueError:
                break  # CRC passed but payload unparsable: treat as torn
            self.records.append((seq, ts, payload))
            self.next_seq = max(self.next_seq, seq + 1)
            pos = end
            good_end = end
        if good_end < len(buf):
            with open(self.path, "r+b") as f:
                f.truncate(good_end)

    def _file(self):
        if self._f is None:
            os.makedirs(os.path.dirname(self.path), exist_ok=True)
            self._f = open(self.path, "ab")
        return self._f

    def append(self, payload: dict) -> int:
        """Durably append one op; returns its seq.  Raises (and
        persists nothing past the tear) on injected/real write faults —
        the caller must fail the write op, not ack it.

        A failed append TRUNCATES the file back to its pre-append
        length before re-raising: the process keeps serving after a
        torn write (fault injection, ENOSPC, transient I/O error), and
        a later GOOD append landing BEHIND torn bytes would be
        silently discarded — along with every acked hint after it — by
        clean-prefix recovery on the next boot.  If even the truncate
        fails the log is poisoned: every further append refuses until
        reopen (losing availability, never an acked hint)."""
        if self._poisoned:
            raise OSError(f"hint log {self.path} has a torn tail that "
                          "could not be truncated; refusing to append "
                          "behind it")
        seq = self.next_seq
        ts = time.time()
        body_payload = json.dumps(payload, separators=(",", ":")).encode()
        body = struct.pack("<QdI", seq, ts, len(body_payload)) + body_payload
        record = struct.pack("<I", zlib.crc32(body)) + body
        f = self._file()
        clean_len = f.tell()
        try:
            if fault.ACTIVE:
                # record-relative torn tail, same contract as
                # oplog.append: persist only args.offset bytes of THIS
                # record then crash
                spec = fault.fire("hints.append", path=self.path,
                                  peer=payload.get("peer", ""))
                if spec is not None and spec["action"] == "torn_write":
                    fault.torn_write(f, record, spec)
            syswrap.checked_write(f, record)
            f.flush()
        except BaseException:
            try:
                f.truncate(clean_len)
                f.seek(clean_len)
            except OSError:
                self._poisoned = True
                self.close()
            raise
        if self.fsync:
            syswrap.checked_fsync(f)
        self.records.append((seq, ts, payload))
        self.next_seq = seq + 1
        return seq

    def ack(self, through_seq: int) -> int:
        """Drop records with seq <= through_seq (delivered) and compact
        the file atomically.  A crash mid-compaction leaves either the
        old or the new file — re-sent records dedup on the receiver."""
        keep = [r for r in self.records if r[0] > through_seq]
        dropped = len(self.records) - len(keep)
        if not dropped:
            return 0
        self.close()
        tmp = self.path + ".tmp"
        with open(tmp, "wb") as f:
            for seq, ts, payload in keep:
                pb = json.dumps(payload, separators=(",", ":")).encode()
                body = struct.pack("<QdI", seq, ts, len(pb)) + pb
                f.write(struct.pack("<I", zlib.crc32(body)) + body)
            f.flush()
            if self.fsync:
                syswrap.checked_fsync(f)
        os.replace(tmp, self.path)
        self.records = keep
        self._poisoned = False  # the rewrite replaced any torn tail
        return dropped

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None


class HintBoard:
    """Every peer's hint log plus the bookkeeping the write path, the
    replay worker, and AAE gating consult.  Thread-safe."""

    def __init__(self, directory: str, max_age: float = 300.0,
                 fsync: bool = False, stats=None, logger=None):
        self.dir = directory
        self.max_age = float(max_age)
        self.fsync = fsync
        self._stats = stats
        self._logger = logger
        self._lock = threading.Lock()          # guards the maps
        self._logs: dict[str, HintLog] = {}
        self._peer_locks: dict[str, threading.Lock] = {}
        self._drain_locks: dict[str, threading.Lock] = {}
        # fragment-coverage summary for gated_fragment, rebuilt lazily
        # after any add/ack (None = stale): an AAE round issues one
        # merge POST per differing block, and re-walking the full
        # backlog per request is O(backlog x merges) exactly when the
        # node is degraded
        self._coverage: dict[str, list] | None = None
        os.makedirs(self.dir, exist_ok=True)
        # boot recovery: reload every peer's surviving log (clean
        # prefix; torn tails truncate) so a crashed coordinator's
        # hints replay after restart
        for name in sorted(os.listdir(self.dir)):
            peer = _peer_of_filename(name)
            if peer is None:
                continue
            log = HintLog(os.path.join(self.dir, name), fsync=fsync)
            if log.records:
                self._logs[peer] = log
                if logger is not None:
                    logger.info("hints: recovered %d pending op(s) "
                                "for %s", len(log.records), peer)
            else:
                log.close()
        self._export()

    # -- internal ------------------------------------------------------------

    def _peer_lock(self, peer: str) -> threading.Lock:
        with self._lock:
            lock = self._peer_locks.get(peer)
            if lock is None:
                lock = self._peer_locks[peer] = threading.Lock()
            return lock

    def _log(self, peer: str, create: bool = False) -> HintLog | None:
        with self._lock:
            log = self._logs.get(peer)
            if log is None and create:
                log = self._logs[peer] = HintLog(
                    os.path.join(self.dir, _peer_filename(peer)),
                    fsync=self.fsync)
            return log

    def _export(self) -> None:
        if self._stats is None:
            return
        with self._lock:
            peers = list(self._logs)
        for peer in peers:
            self._export_peer(peer)

    def _export_peer(self, peer: str) -> None:
        """Refresh ONE peer's backlog gauges — the write path calls
        this per hinted op, and paying O(all peers) there would
        serialize exactly when hint volume peaks (failure windows)."""
        if self._stats is None:
            return
        log = self._log(peer)
        n = len(log.records) if log is not None else 0
        self._stats.gauge("hint_backlog_ops", n, peer=peer)
        self._stats.gauge("hint_oldest_seconds",
                          round(self.oldest_age(peer), 3), peer=peer)

    # -- write path ----------------------------------------------------------

    def add(self, peer: str, payload: dict) -> int:
        """Durably hint one op for ``peer`` (appended in write order).
        Raises on persistence failure — the caller must NOT ack the
        write if its hint could not be made durable."""
        with self._peer_lock(peer):
            seq = self._log(peer, create=True).append(payload)
        with self._lock:
            self._coverage = None
        if self._stats is not None:
            self._stats.count("hint_appended_total", 1, peer=peer)
        self._export_peer(peer)
        return seq

    def pending_peers(self) -> set[str]:
        with self._lock:
            return {p for p, lg in self._logs.items() if lg.records}

    def has_pending(self, peer: str) -> bool:
        log = self._log(peer)
        return log is not None and bool(log.records)

    def pending_ops(self, peer: str | None = None) -> int:
        with self._lock:
            logs = ([self._logs[peer]] if peer is not None
                    and peer in self._logs else
                    list(self._logs.values()) if peer is None else [])
        return sum(len(lg.records) for lg in logs)

    def oldest_age(self, peer: str | None = None,
                   now: float | None = None) -> float:
        """Age (seconds) of the oldest pending hint — 0.0 when none."""
        now = time.time() if now is None else now
        with self._lock:
            logs = ([self._logs[peer]] if peer is not None
                    and peer in self._logs else
                    list(self._logs.values()) if peer is None else [])
        ts = [lg.records[0][1] for lg in logs if lg.records]
        return max(0.0, now - min(ts)) if ts else 0.0

    def overflowed(self, peer: str) -> bool:
        """The boundedness rule: once this peer's oldest pending hint
        outlives ``hint_max_age``, strict writes flip back to loud
        refusal and best-effort writes stop hinting (legacy AAE
        repair), so the log can never grow without bound."""
        return self.max_age > 0 and self.oldest_age(peer) > self.max_age

    # -- AAE gating ----------------------------------------------------------

    def gated_fragment(self, index: str, field: str, shard: int) -> bool:
        """True when any peer's pending hints cover this fragment — a
        union-merge into it could resurrect a clear the hinted peer has
        not replayed yet (receiver-side defense; the sender-side skip
        is peer-level via Cluster.hinted_peers).  ``field`` is the
        fragment's field name (always a string at the merge endpoint);
        answered from a lazily-rebuilt coverage summary so one AAE
        round's many merge requests don't each re-walk the backlog."""
        with self._lock:
            cov = self._coverage
            if cov is None:
                cov = self._coverage = self._build_coverage()
        c = cov.get(index)
        if c is None:
            return False
        all_fields, anyfield_shards, field_all_shards, field_shards = c
        return (all_fields or shard in anyfield_shards
                or field in field_all_shards
                or (field, shard) in field_shards)

    def _build_coverage(self) -> dict[str, list]:
        """index -> [matches-every-fragment, {shard} (any field),
        {field} (any shard), {(field, shard)}] over every pending
        record, decomposing the record predicate: a hint with field
        None covers every field, shards None covers every shard —
        conservative, never unsound.  Caller holds ``_lock``."""
        cov: dict[str, list] = {}
        for lg in self._logs.values():
            for _seq, _ts, p in lg.records:
                idx = p.get("index")
                if idx is None:
                    continue
                c = cov.get(idx)
                if c is None:
                    c = cov[idx] = [False, set(), set(), set()]
                pf = p.get("field")
                shards = p.get("shards")
                if pf is None and shards is None:
                    c[0] = True
                elif pf is None:
                    c[1].update(shards)
                elif shards is None:
                    c[2].add(pf)
                else:
                    c[3].update((pf, s) for s in shards)
        return cov

    # -- replay --------------------------------------------------------------

    def peek(self, peer: str, limit: int) -> list[tuple[int, dict]]:
        with self._peer_lock(peer):
            log = self._log(peer)
            if log is None:
                return []
            return [(seq, payload)
                    for seq, _ts, payload in log.records[:limit]]

    def ack(self, peer: str, through_seq: int) -> int:
        with self._peer_lock(peer):
            log = self._log(peer)
            dropped = log.ack(through_seq) if log is not None else 0
        if dropped:
            with self._lock:
                self._coverage = None
        self._export_peer(peer)
        return dropped

    def drain_lock(self, peer: str) -> threading.Lock:
        """Single-flight lock per peer for the replay worker."""
        with self._lock:
            lock = self._drain_locks.get(peer)
            if lock is None:
                lock = self._drain_locks[peer] = threading.Lock()
            return lock

    # -- introspection -------------------------------------------------------

    def summary(self) -> dict:
        """The ``writeHealth`` body: total backlog, oldest age, and the
        per-peer breakdown an operator needs to see which peer a stuck
        drain is waiting on."""
        now = time.time()
        with self._lock:
            items = [(p, list(lg.records)) for p, lg in self._logs.items()
                     if lg.records]
        peers = []
        for peer, records in sorted(items):
            age = now - records[0][1]
            bulk = sum(1 for _seq, _ts, rec in records
                       if rec.get("kind") == "import")
            peers.append({"id": peer, "pendingOps": len(records),
                          "bulkOps": bulk,
                          "oldestSeconds": round(max(0.0, age), 3),
                          "overflowed": (self.max_age > 0
                                         and age > self.max_age)})
        self._export()
        return {"hintBacklogOps": sum(p["pendingOps"] for p in peers),
                "hintBulkOps": sum(p["bulkOps"] for p in peers),
                "hintOldestSeconds": (max(p["oldestSeconds"]
                                          for p in peers) if peers
                                      else 0.0),
                "peers": peers}

    def close(self) -> None:
        with self._lock:
            for log in self._logs.values():
                log.close()
