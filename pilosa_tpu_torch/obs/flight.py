"""Pipeline flight recorder: always-on incident capture
(``pilosa_tpu.obs.flight``'s).

A lock-light fixed-size ring of structured lifecycle events (enqueue,
dispatch, readback and deliver per window, governor state transitions,
watchdog trips, window quarantines, plane evictions with their reason,
page-ins), each stamped with a monotonic timestamp and a global sequence
number.

Recording an event allocates nothing but Python's own float boxes: the
ring slots are preallocated lists written in place, the sequence counter
is an ``itertools.count`` (atomic under the interpreter lock), and the
record path takes no lock.  A racing wrap-around can tear one slot;
:meth:`FlightRecorder.snapshot` drops torn slots.

:meth:`FlightRecorder.incident` records the triggering event and dumps
the whole ring to a JSON file (rate-limited, bounded in count); the live
ring is served at ``GET /debug/flight``.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time

# ring capacity: at the observed healthy event rate (4 events per
# window, windows every few ms worst-case) 4096 slots hold the last
# several seconds of pipeline history — enough to see the run-up to a
# watchdog trip, small enough to dump in one write
DEFAULT_CAPACITY = 4096

# incident dumps kept on disk; older artifacts are unlinked so a
# flapping governor cannot fill the data dir
MAX_DUMPS = 8

# floor between dumps: a quarantine storm produces one artifact per
# interval, not one per window
DUMP_INTERVAL_SECONDS = 5.0

# slot layout (preallocated list, written in place on the hot path)
_SEQ, _TS, _KIND, _ENTITY, _DETAIL, _VALUE = range(6)


class FlightRecorder:
    """Fixed-size ring of pipeline lifecycle events + incident dumps.

    ``record`` is the hot-path entry: positional scalars only, no
    kwargs, no per-event allocation beyond float boxing.  ``incident``
    is the cold path: it records the trigger and dumps the ring.
    """

    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 dump_dir: str | None = None, stats=None):
        self.capacity = max(64, int(capacity))
        # slots are preallocated and reused; seq 0 marks "never
        # written" (the global counter starts at 1)
        self._ring = [[0, 0.0, "", "", "", 0.0]
                      for _ in range(self.capacity)]
        self._seq = itertools.count(1)
        self.dump_dir = dump_dir
        self._stats = stats
        self._dump_lock = threading.Lock()
        self._last_dump_t = 0.0
        self._dumps: list = []        # newest-last artifact paths
        self.enabled = True

    # -- hot path -----------------------------------------------------------

    def record(self, kind: str, entity: str = "", detail: str = "",
               value: float = 0.0) -> None:
        """Append one event.  Lock-free: a torn slot under wrap-around
        races is dropped at read time, never an error here."""
        if not self.enabled:
            return
        seq = next(self._seq)
        slot = self._ring[seq % self.capacity]
        # write seq last-ish is pointless without a memory barrier;
        # snapshot() instead validates monotonic seq per slot index
        slot[_SEQ] = seq
        slot[_TS] = time.monotonic()
        slot[_KIND] = kind
        slot[_ENTITY] = entity
        slot[_DETAIL] = detail
        slot[_VALUE] = value
        if self._stats is not None:
            self._stats.count("flight_events_total", 1)

    # -- incidents ----------------------------------------------------------

    def incident(self, reason: str, entity: str = "",
                 detail: str = "") -> str | None:
        """Record the triggering event and dump the ring to a JSON
        artifact.  Returns the artifact path (None when dumping is
        disabled or rate-limited away)."""
        self.record("incident", entity, reason if not detail
                    else f"{reason}: {detail}")
        if self._stats is not None:
            self._stats.count("flight_incidents_total", 1, reason=reason)
        if self.dump_dir is None:
            return None
        with self._dump_lock:
            now = time.monotonic()
            if now - self._last_dump_t < DUMP_INTERVAL_SECONDS:
                return self._dumps[-1] if self._dumps else None
            self._last_dump_t = now
            return self._dump(reason)

    def _dump(self, reason: str) -> str | None:
        """Write the current ring to ``flight-<seq>-<reason>.json``.
        Caller holds the dump lock."""
        snap = self.snapshot()
        snap["reason"] = reason
        snap["wallTime"] = time.time()
        tag = "".join(c if c.isalnum() or c in "-_" else "-"
                      for c in reason)[:48]
        path = os.path.join(self.dump_dir,
                            f"flight-{snap['lastSeq']}-{tag}.json")
        try:
            os.makedirs(self.dump_dir, exist_ok=True)
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(snap, f)
            os.replace(tmp, path)
        except OSError:
            # a full disk must not take the pipeline down with it
            return None
        self._dumps.append(path)
        while len(self._dumps) > MAX_DUMPS:
            old = self._dumps.pop(0)
            try:
                os.unlink(old)
            except OSError:
                pass
        if self._stats is not None:
            self._stats.count("flight_dumps_total", 1)
        return path

    @property
    def last_dump(self) -> str | None:
        return self._dumps[-1] if self._dumps else None

    # -- read side ----------------------------------------------------------

    def snapshot(self, limit: int | None = None) -> dict:
        """The ring as JSON-ready dicts, oldest first.  Torn slots
        (seq 0, or a seq that does not map back to its slot index —
        the signature of a mid-write wrap race) are dropped."""
        events = []
        last_seq = 0
        for idx, slot in enumerate(self._ring):
            seq = slot[_SEQ]
            if seq <= 0 or seq % self.capacity != idx:
                continue
            events.append({"seq": seq, "ts": slot[_TS],
                           "kind": slot[_KIND], "entity": slot[_ENTITY],
                           "detail": slot[_DETAIL],
                           "value": slot[_VALUE]})
            if seq > last_seq:
                last_seq = seq
        events.sort(key=lambda e: e["seq"])
        if limit is not None and len(events) > limit:
            events = events[-limit:]
        return {"events": events, "lastSeq": last_seq,
                "capacity": self.capacity,
                "dumps": list(self._dumps)}


class NullFlightRecorder:
    """Recorder-shaped nothing for contexts (benches with
    instrumentation off, tools) that want the seam without the ring."""

    enabled = False
    dump_dir = None
    last_dump = None

    def record(self, kind: str, entity: str = "", detail: str = "",
               value: float = 0.0) -> None:
        pass

    def incident(self, reason: str, entity: str = "",
                 detail: str = "") -> None:
        return None

    def snapshot(self, limit: int | None = None) -> dict:
        return {"events": [], "lastSeq": 0, "capacity": 0, "dumps": []}


NULL_FLIGHT = NullFlightRecorder()
