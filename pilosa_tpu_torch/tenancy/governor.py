"""Residency governor: the plane cache's eviction order and the tenant
byte quota (``pilosa_tpu.tenancy.governor``).

Each entry keeps decayed recent hits and its last build (or page-in)
seconds; eviction goes by *keep-score*, lowest first::

    keep = recent_hits x nbytes x max(build_seconds, floor)

An entry with no hits scores 0.0, so with no telemetry the order is the
cache's least-recently-used order exactly.  The tenant (index) byte
quota is checked by ``admit_bytes`` before a page-in spends device
memory.
"""

from __future__ import annotations

import time

# below this many seconds a build counts as free: the cost factor stops
# discriminating and recency of use orders the entries
_COST_FLOOR = 1e-3

# hit counts halve this often: "recent" means the last few minutes
DECAY_SECONDS = 120.0

# the telemetry maps are keyed by cache keys (user-controlled): past this
# many the cheapest half of the build costs is dropped (those entries
# score by recency again)
_MAX_KEYS = 4096


class ResidencyGovernor:
    """Per-entry hit/cost telemetry and per-tenant byte quotas.
    :meth:`note_hit` runs on the serving path with plain dict updates (a
    racing thread may lose a count, which a relative order never
    notices); :meth:`keep_score` runs under the owning cache's lock."""

    def __init__(self, byte_quota: int = 0,
                 decay_seconds: float = DECAY_SECONDS):
        self.byte_quota = int(byte_quota)   # per tenant, 0 = unlimited
        self.decay_seconds = float(decay_seconds)
        self._hits: dict = {}               # key -> decayed hit count
        self._build_s: dict = {}            # key -> last build seconds
        self._last_decay = time.monotonic()

    def note_hit(self, key) -> None:
        self._hits[key] = self._hits.get(key, 0.0) + 1.0

    def note_build(self, key, seconds: float) -> None:
        self._build_s[key] = float(seconds)
        if len(self._build_s) > _MAX_KEYS:
            self._prune()

    def note_evict(self, key) -> None:
        # the build cost stays (a re-admitted key costs the same); its
        # recency value resets
        self._hits.pop(key, None)

    def forget(self, index: str) -> None:
        """Drop the telemetry of one index's keys (its entries were
        invalidated: a recreated index starts cold)."""
        for d in (self._hits, self._build_s):
            for k in [k for k in list(d) if k[1] == index]:
                d.pop(k, None)

    def keep_score(self, key, nbytes: int) -> float:
        """Higher = more worth keeping; 0.0 without recorded hits."""
        self._maybe_decay()
        hits = self._hits.get(key)
        if not hits:
            return 0.0
        cost = max(self._build_s.get(key, 0.0), _COST_FLOOR)
        return hits * float(nbytes) * cost

    def _maybe_decay(self) -> None:
        now = time.monotonic()
        if now - self._last_decay < self.decay_seconds:
            return
        self._last_decay = now
        for k in list(self._hits):
            v = self._hits.get(k, 0.0) * 0.5
            if v < 0.25:
                self._hits.pop(k, None)
            else:
                self._hits[k] = v

    def _prune(self) -> None:
        keep = sorted(self._build_s.items(), key=lambda kv: -kv[1])
        self._build_s = dict(keep[:_MAX_KEYS // 2])

    def admit_bytes(self, resident_bytes: int, want_bytes: int) -> bool:
        """Whether a tenant holding ``resident_bytes`` may take
        ``want_bytes`` more (always, with the quota off)."""
        if self.byte_quota <= 0:
            return True
        return resident_bytes + want_bytes <= self.byte_quota
