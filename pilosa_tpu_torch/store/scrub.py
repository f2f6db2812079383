"""Background storage scrubber (``pilosa_tpu.store.scrub``'s): low-priority
re-verification of every on-disk checksum, feeding the quarantine.

A single-flight walker re-reads, in paced chunks at a byte-rate budget,
every durable file that carries a checksum:

- fragment **snapshots** (the ``PSF1`` frame CRC; legacy unframed
  snapshots are parse-verified instead);
- fragment **op-logs** (CRC-framed records: a bad record mid-file is
  corruption, because replay truncates torn tails and a live log is a
  clean record sequence);
- dense **sidecars** (header CRC; a corrupt one is a broken cache, so it
  is unlinked and counted, never quarantined: the next build goes cold);
- a cluster node's **hint logs** (``<data dir>/_hints``, CRC-framed: a
  bad record is counted and logged loudly, the hinted writes past it are
  lost, and anti-entropy repairs the divergence once hint gating
  expires).

A corrupt snapshot or op-log QUARANTINES the fragment through
:class:`~pilosa_tpu_torch.store.health.StorageHealth` (a snapshot is also
poisoned: its map is dropped and its generation moves, so a resident
plane rebuilds) and is handed to ``on_corrupt`` when one is set (a
cluster node's ``repair_quarantined``).

Knobs: ``scrub_interval_seconds`` (pause between passes) and
``scrub_bytes_per_second`` (the read budget; 0 disables the scrubber:
no thread).  Progress is the ``storageHealth.scrub`` block of
``/status`` and ``storage_scrub_bytes_total``.
"""

from __future__ import annotations

import os
import threading
import time
import zlib

from pilosa_tpu_torch.store import roaring
from pilosa_tpu_torch.store.oplog import _clean_prefix_end

# paced-read chunk: the budget is enforced BETWEEN chunks, so one huge
# file cannot blow the byte rate in a single burst
_READ_CHUNK = 4 << 20


def _read_paced(path: str, pace=None) -> bytes:
    """A whole file read in chunks, ``pace(nbytes)`` (the scrubber's
    token bucket) called after each; None reads unpaced."""
    parts = []
    with open(path, "rb") as f:
        while True:
            chunk = f.read(_READ_CHUNK)
            if not chunk:
                break
            parts.append(chunk)
            if pace is not None:
                pace(len(chunk))
    return b"".join(parts)


# -- per-file verifiers -------------------------------------------------------


def verify_snapshot_file(path: str, pace=None) -> tuple[str | None, int]:
    """(problem or None, bytes read).  A framed snapshot verifies its
    length and CRC; a legacy unframed one must parse."""
    from pilosa_tpu_torch.store.fragment import Fragment
    try:
        buf = _read_paced(path, pace)
    except FileNotFoundError:
        return None, 0
    except OSError as e:
        return f"unreadable: {e}", 0
    if not buf:
        return None, 0
    hdr_s = Fragment._SNAP_HDR
    if buf[:4] == Fragment.SNAP_MAGIC:
        if len(buf) < hdr_s.size:
            return "truncated frame header", len(buf)
        _m, ver, _r, blen, crc = hdr_s.unpack_from(buf)
        blob = memoryview(buf)[hdr_s.size:]
        if ver != Fragment.SNAP_VERSION:
            return f"unknown frame version {ver}", len(buf)
        if len(blob) != blen:
            return (f"length mismatch: header says {blen}, "
                    f"file has {len(blob)}", len(buf))
        if zlib.crc32(blob) != crc:
            return "crc mismatch", len(buf)
        return None, len(buf)
    try:
        roaring.deserialize(buf)
    except Exception as e:  # noqa: BLE001 — any parse failure is corrupt
        return f"legacy snapshot unparsable: {e}", len(buf)
    return None, len(buf)


def verify_oplog_file(path: str, pace=None) -> tuple[str | None, int]:
    """A clean op-log is a whole-record prefix covering the file; on a
    settled file a mid-file CRC or frame mismatch is byte corruption.
    (:func:`verify_fragment` withholds the verdict when an append raced
    the read.)"""
    try:
        buf = _read_paced(path, pace)
    except FileNotFoundError:
        return None, 0
    except OSError as e:
        return f"unreadable: {e}", 0
    pos = _clean_prefix_end(buf)
    if pos < len(buf):
        return (f"corrupt record at byte {pos} "
                f"({len(buf) - pos} trailing bytes)", len(buf))
    return None, len(buf)


def verify_sidecar_file(path: str, pace=None) -> tuple[str | None, int]:
    """A ``.dense`` sidecar's header-declared CRC and length.  A stale
    stamp is not corruption (every write stales it by design)."""
    from pilosa_tpu_torch.store.fragment import Fragment
    hdr_s = Fragment._DENSE_HDR
    try:
        buf = _read_paced(path, pace)
    except FileNotFoundError:
        return None, 0
    except OSError as e:
        return f"unreadable: {e}", 0
    if len(buf) < hdr_s.size:
        return "truncated header", len(buf)
    magic, ver, _, _s0, _s1, _s2, blen, crc = hdr_s.unpack_from(buf)
    if magic != Fragment.DENSE_MAGIC or ver != Fragment.DENSE_VERSION:
        return "bad magic/version", len(buf)
    blob = memoryview(buf)[hdr_s.size:]
    if len(blob) != blen:
        return f"length mismatch ({len(blob)} != {blen})", len(buf)
    if zlib.crc32(blob) != crc:
        return "crc mismatch", len(buf)
    return None, len(buf)


def verify_hintlog_file(path: str, pace=None) -> tuple[str | None, int]:
    """A hint log's frame scan (the op-log's rule: a live log is whole
    records, its tears truncated at recovery and at failed appends)."""
    from pilosa_tpu_torch.cluster.hints import _FRAME
    try:
        buf = _read_paced(path, pace)
    except FileNotFoundError:
        return None, 0
    except OSError as e:
        return f"unreadable: {e}", 0
    pos = _clean_prefix_end(buf, _FRAME)
    if pos < len(buf):
        return (f"corrupt record at byte {pos} "
                f"({len(buf) - pos} trailing bytes)", len(buf))
    return None, len(buf)


def _frag_stamp(frag) -> tuple:
    """(snapshot size, snapshot mtime_ns, op-log size): moves with every
    compaction and every append."""
    try:
        st = os.stat(frag.path)
        snap = (st.st_size, st.st_mtime_ns)
    except OSError:
        snap = (0, 0)
    try:
        osz = os.path.getsize(frag._oplog.path)
    except OSError:
        osz = 0
    return (snap[0], snap[1], osz)


def verify_fragment(frag, pace=None) -> tuple[dict[str, str] | None, int]:
    """Verify one fragment's snapshot and op-log WITHOUT its lock (a scrub
    must not stall serving behind a long read): the on-disk stamp is
    taken before and after, and a change (a compaction or an append raced
    the read) withholds the verdict: ``(None, bytes)``.  ``({}, bytes)``
    is verified clean."""
    before = _frag_stamp(frag)
    try:
        snap_p, snap_b = verify_snapshot_file(frag.path, pace)
        op_p, op_b = verify_oplog_file(frag._oplog.path, pace)
    except Exception:  # noqa: BLE001 — unreadable mid-swap: no verdict
        return None, 0
    if _frag_stamp(frag) != before:
        return None, snap_b + op_b
    problems: dict[str, str] = {}
    if snap_p:
        problems["snapshot"] = snap_p
    if op_p:
        problems["oplog"] = op_p
    return problems, snap_b + op_b


class Scrubber:
    """Single-flight background walker re-verifying every on-disk
    checksum at ``bytes_per_second``; corrupt fragments quarantine and go
    to ``on_corrupt`` (None on a single node)."""

    def __init__(self, holder, *, interval: float = 600.0,
                 bytes_per_second: int = 32 << 20, stats=None,
                 logger=None, on_corrupt=None):
        from pilosa_tpu_torch.obs import NopStats, get_logger
        self.holder = holder
        self.health = holder.storage_health
        self.interval = float(interval)
        self.bytes_per_second = int(bytes_per_second)
        self.stats = stats or NopStats()
        self.logger = logger or get_logger("pilosa_tpu_torch.store")
        # on_corrupt(entry): once per quarantined entry per pass
        self.on_corrupt = on_corrupt
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._flight = threading.Lock()
        # progress (the /status storageHealth.scrub block)
        self._passes = 0
        self._bytes_total = 0
        self._corruptions = 0
        self._last_pass_seconds = 0.0
        self._last_pass_at = 0.0
        self._pace_t0 = 0.0
        self._pace_bytes = 0

    @property
    def enabled(self) -> bool:
        """False: no thread, no re-verification."""
        return self.bytes_per_second > 0 and self.interval > 0

    def start(self) -> "Scrubber":
        if self.enabled and self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, name="pilosa-torch-scrub", daemon=True)
            self._thread.start()
        return self

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.run_once()
            except Exception as e:  # noqa: BLE001 — scrub must not die
                self.logger.warning("scrub pass failed: %s", e)

    # -- one pass -------------------------------------------------------------

    def _pace(self, nbytes: int) -> None:
        """Token-bucket budget: sleep so the pass's cumulative read rate
        stays at or under ``bytes_per_second``."""
        if self.bytes_per_second <= 0 or nbytes <= 0:
            return
        self._pace_bytes += nbytes
        ahead = (self._pace_bytes / self.bytes_per_second
                 - (time.monotonic() - self._pace_t0))
        if ahead > 0:
            self._stop.wait(min(ahead, 1.0))

    def run_once(self) -> dict:
        """One full verification pass (single-flight: a concurrent call
        returns without scanning); returns the pass summary."""
        if not self._flight.acquire(blocking=False):
            return {"skipped": "pass already running"}
        try:
            return self._run_once_locked()
        finally:
            self._flight.release()

    def _run_once_locked(self) -> dict:
        t0 = time.monotonic()
        self._pace_t0 = t0
        self._pace_bytes = 0
        scanned = corrupt = files = 0
        health = self.health
        for frag in self._fragments():
            if self._stop.is_set():
                break
            if health.is_quarantined(frag.path):
                continue
            problems, nbytes = verify_fragment(frag, pace=self._pace)
            scanned += nbytes
            files += 2
            if problems is None:
                continue  # raced a write or a compaction: next pass
            for artifact, problem in problems.items():
                corrupt += 1
                health.quarantine(frag.path, artifact, problem)
                if artifact == "snapshot":
                    # no pending row may expand from the corrupt blob
                    frag.poison_snapshot()
            side_p, side_b = verify_sidecar_file(frag.dense_path,
                                                 pace=self._pace)
            scanned += side_b
            if side_b:
                files += 1
            if side_p:
                corrupt += 1
                self.stats.count("storage_corruption_detected_total", 1,
                                 kind="sidecar")
                self.logger.warning(
                    "scrub: corrupt dense sidecar %s (%s) — unlinked, "
                    "next plane build goes cold",
                    frag.dense_path, side_p)
                try:
                    os.remove(frag.dense_path)
                except OSError:
                    pass
        hints_dir = os.path.join(self.holder.path, "_hints")
        if os.path.isdir(hints_dir):
            for name in sorted(os.listdir(hints_dir)):
                if not name.endswith(".hints"):
                    continue
                p = os.path.join(hints_dir, name)
                try:
                    before = os.path.getsize(p)
                except OSError:
                    continue
                problem, nbytes = verify_hintlog_file(p, pace=self._pace)
                scanned += nbytes
                files += 1
                try:
                    settled = os.path.getsize(p) == before
                except OSError:
                    settled = False
                if problem and not settled:
                    continue  # raced an append or an ack's rewrite
                if problem:
                    corrupt += 1
                    self.stats.count("storage_corruption_detected_total", 1,
                                     kind="hintlog")
                    self.logger.error(
                        "scrub: corrupt hint log %s (%s) — acked hinted "
                        "writes past the tear are LOST; anti-entropy "
                        "repairs the divergence after hint gating expires",
                        p, problem)
        repaired = 0
        if self.on_corrupt is not None:
            for entry in health.quarantined_entries():
                if self._stop.is_set():
                    break
                try:
                    if self.on_corrupt(entry):
                        repaired += 1
                except Exception as e:  # noqa: BLE001 — retried next pass
                    self.logger.warning(
                        "scrub: repair hook failed for %s: %s",
                        entry["path"], e)
        self._passes += 1
        self._bytes_total += scanned
        self._corruptions += corrupt
        self._last_pass_seconds = time.monotonic() - t0
        self._last_pass_at = time.time()
        if scanned:
            self.stats.count("storage_scrub_bytes_total", scanned)
        if corrupt:
            self.logger.warning(
                "scrub pass: %d corrupt artifact(s) in %d files "
                "(%d bytes, %.2fs)", corrupt, files, scanned,
                self._last_pass_seconds)
        return {"files": files, "bytes": scanned, "corrupt": corrupt,
                "repaired": repaired,
                "seconds": round(self._last_pass_seconds, 3)}

    def _fragments(self):
        for idx in list(self.holder.indexes.values()):
            for f in list(idx.fields.values()):
                for v in list(f.views.values()):
                    yield from list(v.fragments.values())

    def payload(self) -> dict:
        """The ``scrub`` sub-block of ``storageHealth`` on /status."""
        return {
            "enabled": self.enabled,
            "intervalSeconds": self.interval,
            "bytesPerSecond": self.bytes_per_second,
            "passes": self._passes,
            "bytesScanned": self._bytes_total,
            "corruptionsFound": self._corruptions,
            "lastPassSeconds": round(self._last_pass_seconds, 3),
            "lastPassAt": self._last_pass_at,
        }
