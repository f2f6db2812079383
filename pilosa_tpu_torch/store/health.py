"""Disk-health governor and corruption quarantine
(``pilosa_tpu.store.health``'s).

One :class:`StorageHealth` per holder tree watches the two ways a disk
betrays an index:

- **write-path OSErrors**, classified by errno at the op-log, snapshot
  and sidecar seams: ``ENOSPC``/``EDQUOT``/``EROFS`` flips the node to
  READ_ONLY (writes refuse with a structured 507
  ``writeUnavailable{reason: "disk_full"}``, reads keep serving), with a
  probe loop (statvfs headroom plus a real probe write) restoring HEALTHY
  once space frees.  Repeated ``EIO`` on one fragment quarantines that
  fragment alone;
- **corruption**, reported by checksum verification (snapshot frame CRCs
  at open and at map demotion, the background scrubber): the fragment is
  QUARANTINED.  A quarantined fragment serves empty locally (a loud
  quarantined empty beats silently wrong bits) and writes to it refuse
  with a structured 503 ``storageFault{path, kind}``; on a cluster node
  with replicas ``Cluster.repair_quarantined`` rewrites it from a
  healthy replica and lifts the quarantine.

The happy path is one plain bool read (``gate_active``) per mutation.
State is exported as ``disk_health_state`` (0 healthy, 1 read_only),
``storage_fragment_quarantined`` and
``storage_corruption_detected_total{kind}``; the ``storageHealth`` block
of ``/status`` carries the registry.
"""

from __future__ import annotations

import errno as _errno
import logging
import os
import threading
import time

from pilosa_tpu_torch.store import syswrap

HEALTHY = "healthy"
READ_ONLY = "read_only"

STATE_CODE = {HEALTHY: 0, READ_ONLY: 1}

# write-fault classes (by errno; FaultError carries an injected errno
# through the same path, so chaos schedules exercise real classification)
DISK_FULL = "disk_full"
IO_ERROR = "io_error"
OTHER = "other"

# consecutive EIO-class write failures on ONE fragment before that
# fragment (alone) is quarantined
EIO_QUARANTINE_THRESHOLD = 3

# suffixes that map an on-disk file back to its owning fragment's
# canonical (snapshot) path for quarantine identity
_FRAG_SUFFIXES = (".oplog", ".dense", ".tmp")

_LOG = logging.getLogger("pilosa_tpu_torch.store")

# (site, path) pairs already logged by note_os_error — "log once":
# a per-stat-call warning on a hot loop would flood the log with the
# very fault it reports
_logged_once: set[tuple[str, str]] = set()
_logged_lock = threading.Lock()


class StorageFaultError(OSError):
    """A write refused (or failed) because the storage layer is sick:
    the node is READ_ONLY (``kind == "disk_full"``), the target
    fragment is quarantined (``kind == "corrupt"``/``"io_error"``), or
    the underlying write just failed with a classified errno.  The API
    edges map this to a structured 507/503 (see
    ``ApiError.storage_fault``) — storage unavailability is never a
    generic 500."""

    def __init__(self, msg: str, *, path: str, kind: str,
                 retry_after: float = 1.0):
        super().__init__(msg)
        self.path = path
        self.kind = kind
        self.retry_after = retry_after


def classify_oserror(err: BaseException) -> str:
    """errno → fault class.  ``EDQUOT`` counts as disk-full (a quota
    is a full disk from this process's point of view); ``EROFS`` too
    (the kernel remounted the filesystem read-only — the ext4 response
    to metadata I/O errors)."""
    no = getattr(err, "errno", None)
    if no in (_errno.ENOSPC, _errno.EDQUOT, _errno.EROFS):
        return DISK_FULL
    if no == _errno.EIO:
        return IO_ERROR
    return OTHER


def frag_path_of(path: str) -> str:
    """Canonical fragment (snapshot) path for any of its on-disk
    files (op-log, dense sidecar, tmp)."""
    for suf in _FRAG_SUFFIXES:
        if path.endswith(suf):
            return path[: -len(suf)]
    return path


def note_os_error(site: str, path: str, err: OSError,
                  health: "StorageHealth | None" = None,
                  logger=None) -> None:
    """The satellite contract for previously-silent ``except OSError``
    sites: log ONCE per (site, path) with path+errno, and feed the
    disk-health governor's fault counter when a governor is in reach.
    ``ENOENT`` is exempt — an absent file is the DELIBERATE fallback
    at every call site that uses this helper (no snapshot yet, no
    sidecar to restamp, already-removed key files) and must stay
    silent."""
    if getattr(err, "errno", None) == _errno.ENOENT:
        return
    key = (site, path)
    with _logged_lock:
        first = key not in _logged_once
        if first:
            _logged_once.add(key)
    if first:
        (logger or _LOG).warning(
            "storage: OSError at %s (%s): %s [errno=%s]",
            site, path, err, getattr(err, "errno", None))
    if health is not None:
        health.note_fault(path, err, site=site)


class StorageHealth:
    """One holder tree's disk-health governor + quarantine registry.

    Constructed by :class:`~pilosa_tpu_torch.store.holder.Holder` and
    threaded down to every fragment (the same chain
    ``snapshot_submit`` rides); the server wires stats/logger/knobs via
    :meth:`configure` after boot."""

    def __init__(self, base: str = "", stats=None, logger=None,
                 min_free_bytes: int = 64 << 20,
                 probe_seconds: float = 5.0):
        from pilosa_tpu_torch.obs import NopStats
        self.base = base
        self._stats = stats or NopStats()
        self._logger = logger or _LOG
        self.min_free_bytes = int(min_free_bytes)
        self.probe_seconds = max(0.05, float(probe_seconds))
        # hot-path guard: plain bool, GIL-atomic reads.  True only when
        # the node is read-only OR at least one fragment is quarantined
        # — the healthy fast path is one attribute load + falsy branch.
        self.gate_active = False
        self.state = HEALTHY
        self._since = time.monotonic()
        self._lock = threading.Lock()
        # canonical fragment path -> {kind, detail, path, key, ts}
        self._quarantined: dict[str, dict] = {}
        # (index, shard) pairs with >=1 quarantined fragment (routing
        # reads them per query; maintained under the lock)
        self._bad_shards: dict[tuple[str, int], int] = {}
        self._eio_counts: dict[str, int] = {}
        self._faults: dict[str, int] = {}  # kind -> count (status block)
        self._probe_thread: threading.Thread | None = None
        self._stop = threading.Event()
        self._last_repair: dict | None = None

    # -- wiring ---------------------------------------------------------------

    def configure(self, base: str | None = None, stats=None, logger=None,
                  min_free_bytes: int | None = None,
                  probe_seconds: float | None = None) -> "StorageHealth":
        if base is not None:
            self.base = base
        if stats is not None:
            self._stats = stats
        if logger is not None:
            self._logger = logger
        if min_free_bytes is not None:
            self.min_free_bytes = int(min_free_bytes)
        if probe_seconds is not None:
            self.probe_seconds = max(0.05, float(probe_seconds))
        return self

    def close(self) -> None:
        self._stop.set()

    # -- quarantine registry --------------------------------------------------

    def key_of_path(self, path: str) -> tuple | None:
        """(index, field, view, shard) parsed from a fragment path
        under ``base`` (layout:
        ``<base>/<index>/<field>/views/<view>/fragments/<shard>``), or
        None when the path is not a fragment of this tree."""
        if not self.base:
            return None
        try:
            rel = os.path.relpath(frag_path_of(path), self.base)
        except ValueError:
            return None
        parts = rel.split(os.sep)
        if (len(parts) == 6 and parts[2] == "views"
                and parts[4] == "fragments" and parts[5].isdigit()):
            return (parts[0], parts[1], parts[3], int(parts[5]))
        return None

    def quarantine(self, path: str, kind: str, detail: str = "") -> dict:
        """Register one fragment as untrustworthy.  Reads route to a
        replica (``shard_quarantined``), local writes refuse
        (``check_write``), the scrubber's repair hook pulls a fresh
        copy.  Idempotent per path."""
        cpath = frag_path_of(path)
        key = self.key_of_path(cpath)
        with self._lock:
            if cpath in self._quarantined:
                return self._quarantined[cpath]
            entry = {"path": cpath, "kind": kind, "detail": detail,
                     "key": key, "ts": time.time()}
            self._quarantined[cpath] = entry
            if key is not None:
                ks = (key[0], key[3])
                self._bad_shards[ks] = self._bad_shards.get(ks, 0) + 1
            self.gate_active = True
            n = len(self._quarantined)
        self._stats.count("storage_corruption_detected_total", 1,
                          kind=kind)
        self._stats.gauge("storage_fragment_quarantined", n)
        self._logger.warning(
            "storage: fragment QUARANTINED (%s) %s%s — reads served "
            "from replicas, local writes refuse until repaired",
            kind, cpath, f": {detail}" if detail else "")
        return entry

    def unquarantine(self, path: str) -> bool:
        cpath = frag_path_of(path)
        with self._lock:
            entry = self._quarantined.pop(cpath, None)
            if entry is None:
                return False
            key = entry.get("key")
            if key is not None:
                ks = (key[0], key[3])
                left = self._bad_shards.get(ks, 1) - 1
                if left <= 0:
                    self._bad_shards.pop(ks, None)
                else:
                    self._bad_shards[ks] = left
            self._eio_counts.pop(cpath, None)
            self.gate_active = bool(self._quarantined) \
                or self.state != HEALTHY
            n = len(self._quarantined)
        self._stats.gauge("storage_fragment_quarantined", n)
        self._logger.info("storage: fragment un-quarantined %s", cpath)
        return True

    def note_repair(self, path: str, source: str) -> None:
        """Record a completed replica repair (status visibility +
        ``storage_repair_total{source}``)."""
        self._stats.count("storage_repair_total", 1, source=source)
        with self._lock:
            self._last_repair = {"path": frag_path_of(path),
                                 "source": source, "ts": time.time()}

    def is_quarantined(self, path: str) -> bool:
        if not self.gate_active:
            return False
        with self._lock:
            return frag_path_of(path) in self._quarantined

    def quarantined_entries(self) -> list[dict]:
        with self._lock:
            return [dict(e) for e in self._quarantined.values()]

    def shard_quarantined(self, index: str, shard: int) -> bool:
        """Any fragment of (index, shard) quarantined locally?  The
        read-routing check: when True and a live replica exists, this
        node's legs for the shard go to the replica instead."""
        if not self.gate_active:
            return False
        with self._lock:
            return (index, int(shard)) in self._bad_shards

    # -- write gate -----------------------------------------------------------

    def check_write(self, path: str | None = None) -> None:
        """Raise :class:`StorageFaultError` when a write must refuse:
        node read-only (disk full) or the target fragment quarantined.
        Called by fragment mutators BEFORE any in-memory mutation, so
        a refusal can never half-apply (``gate_active`` keeps the
        healthy path to one bool read)."""
        if not self.gate_active:
            return
        if self.state == READ_ONLY:
            raise StorageFaultError(
                "node is read-only: disk full (writes refuse until the "
                "space probe succeeds; reads keep serving)",
                path=path or self.base, kind=DISK_FULL,
                retry_after=self.probe_seconds)
        if path is not None:
            cpath = frag_path_of(path)
            with self._lock:
                entry = self._quarantined.get(cpath)
            if entry is not None:
                raise StorageFaultError(
                    f"fragment quarantined ({entry['kind']}): {cpath} "
                    "(reads serve from replicas; repair pending)",
                    path=cpath, kind=entry["kind"])

    # -- fault intake ---------------------------------------------------------

    def note_fault(self, path: str, err: BaseException,
                   site: str = "") -> str:
        """Classify + account one write-path OSError.  ``disk_full``
        flips the node READ_ONLY and starts the probe loop; repeated
        ``io_error`` on one fragment quarantines just that fragment.
        Returns the fault class."""
        kind = classify_oserror(err)
        with self._lock:
            self._faults[kind] = self._faults.get(kind, 0) + 1
        if kind == DISK_FULL:
            self._degrade(site or path, err)
        elif kind == IO_ERROR:
            cpath = frag_path_of(path)
            with self._lock:
                n = self._eio_counts.get(cpath, 0) + 1
                self._eio_counts[cpath] = n
            if n >= EIO_QUARANTINE_THRESHOLD:
                self.quarantine(cpath, IO_ERROR,
                                f"{n} consecutive EIO write failures")
        return kind

    def write_failed(self, path: str, err: BaseException,
                     site: str = "") -> StorageFaultError:
        """The raising form of :meth:`note_fault`: classify, account,
        and return a :class:`StorageFaultError` for the caller to
        ``raise ... from err`` — the single conversion every durable
        write seam (oplog append, snapshot) shares."""
        kind = self.note_fault(path, err, site=site)
        return StorageFaultError(
            f"storage write failed ({kind}) at {site or path}: {err}",
            path=path, kind=kind,
            retry_after=self.probe_seconds if kind == DISK_FULL else 1.0)

    def note_write_success(self, path: str) -> None:
        """A successful durable write resets the fragment's EIO streak
        (the quarantine trigger is CONSECUTIVE failures)."""
        if self._eio_counts:
            with self._lock:
                self._eio_counts.pop(frag_path_of(path), None)

    # -- read-only degradation + probe ---------------------------------------

    def _degrade(self, what: str, err: BaseException) -> None:
        with self._lock:
            if self.state == READ_ONLY:
                return
            self.state = READ_ONLY
            self._since = time.monotonic()
            self.gate_active = True
            # probe lifecycle: the thread unregisters ITSELF under
            # this lock right before exiting (_probe_loop), so either
            # a live probe observes this READ_ONLY flip and keeps
            # probing, or it has already unregistered and we start a
            # fresh one — a HEALTHY→READ_ONLY flip can never race an
            # exiting probe into a probeless read-only limbo
            start_probe = self._probe_thread is None
            if start_probe:
                self._probe_thread = threading.Thread(
                    target=self._probe_loop, name="pilosa-disk-probe",
                    daemon=True)
        self._stats.gauge("disk_health_state", STATE_CODE[READ_ONLY])
        self._logger.error(
            "storage: disk FULL at %s (%s) — node flips to READ-ONLY "
            "degraded serving; strict writes refuse with "
            "writeUnavailable{disk_full}, probe every %.1fs",
            what, err, self.probe_seconds)
        if start_probe:
            self._probe_thread.start()

    def _probe_loop(self) -> None:
        while not self._stop.wait(self.probe_seconds):
            with self._lock:
                if self.state != READ_ONLY:
                    # exit-and-unregister atomically: a concurrent
                    # _degrade either sees READ_ONLY observed by this
                    # loop (we keep probing) or finds _probe_thread
                    # already None and starts a fresh thread
                    self._probe_thread = None
                    return
            self.probe_once()
        with self._lock:
            self._probe_thread = None

    def probe_once(self) -> bool:
        """One recovery probe: statvfs headroom AND a real probe write
        (quota/remount failures don't
        show in statvfs — only an actual write proves the disk takes
        bytes again).  Success restores HEALTHY."""
        base = self.base or "."
        try:
            st = os.statvfs(base)
            if st.f_bavail * st.f_frsize < self.min_free_bytes:
                return False
        except OSError:
            return False
        probe = os.path.join(base, "_diskprobe")
        try:
            with open(probe, "wb") as f:
                syswrap.checked_write(f, b"pilosa-disk-probe")
                f.flush()
            os.remove(probe)
        except OSError:
            try:
                os.remove(probe)
            except OSError:
                pass
            return False
        with self._lock:
            self.state = HEALTHY
            self._since = time.monotonic()
            self.gate_active = bool(self._quarantined)
        self._stats.gauge("disk_health_state", STATE_CODE[HEALTHY])
        self._logger.warning(
            "storage: disk probe succeeded — node restored to HEALTHY "
            "serving (hinted writes drain via the peers' heartbeats)")
        return True

    # -- introspection --------------------------------------------------------

    def payload(self) -> dict:
        """The ``storageHealth`` block on ``/status`` (the scrubber
        adds its own progress sub-block)."""
        with self._lock:
            quarantined = [
                {"path": e["path"], "kind": e["kind"],
                 "detail": e["detail"],
                 "key": (None if e["key"] is None else {
                     "index": e["key"][0], "field": e["key"][1],
                     "view": e["key"][2], "shard": e["key"][3]})}
                for e in self._quarantined.values()]
            return {
                "state": self.state,
                "stateCode": STATE_CODE[self.state],
                "sinceSeconds": round(
                    time.monotonic() - self._since, 3),
                "minFreeBytes": self.min_free_bytes,
                "probeSeconds": self.probe_seconds,
                "faults": dict(self._faults),
                "quarantined": quarantined,
                "lastRepair": (dict(self._last_repair)
                               if self._last_repair else None),
            }
