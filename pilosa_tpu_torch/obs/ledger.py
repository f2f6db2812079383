"""Device-cost ledger: who spent the card's milliseconds
(``pilosa_tpu.obs.ledger``'s).

The batcher co-batches many tenants' queries into one window: one launch
per group, one packed read, one measured wall clock.  The ledger
apportions every window's measured cost to the items it served:

- **seconds**: the window's launch seconds plus its packed readback's
  wall, split by each item's bytes-scanned share (:func:`apportion`;
  equal split when the window scanned nothing).  Shares sum EXACTLY to
  the measured total, so per-tenant rollups re-add to the device totals.
- **bytes**: each item's share of its group's scan.
- **solo fast-lane** calls are charged whole to their one caller.
- :meth:`CostLedger.note_compile` keeps the reference's surface; the port
  compiles no per-shape program, so nothing calls it.

Attribution context rides a thread-local set by the executor at
admission (tenant = index name, the query's trace id) and refined where
a plane is resolved (``index/field``).  The batcher's items are built on
the caller's thread and stamp the context at construction, so the charge
rides the item to whichever thread launches it.

Rollups are bounded maps (the coldest half pruned on overflow) and the
Prometheus families ride the registry's label caps
(``metrics.BOUNDED_LABELS``).  Per-trace shares feed a profiled query's
root span (``deviceSeconds``), and the decayed per-tenant rate feeds the
QoS ``tenant_device_seconds_quota``.
"""

from __future__ import annotations

import threading

# rollup map bound (tenant/shape/plane keys are user-controlled):
# on overflow the cheapest half is dropped — the totals stay exact,
# only per-key detail for cold keys is forgotten
_MAX_KEYS = 512

# per-trace share retention (joins a profiled query's span tree):
# bounded FIFO — only traced queries land here, so the common case
# writes nothing
_MAX_TRACES = 1024

# decayed per-tenant device-seconds half-life: the QoS quota keys off
# the last minute or so of actual device use, not all-time totals
DECAY_SECONDS = 60.0

# -- attribution context (thread-local) ---------------------------------------

_ctx = threading.local()


def set_query_context(tenant: str = "", trace_id: str | None = None):
    """Executor admission hook: stamp the calling thread with the
    query's tenant (index name) and trace identity.  Cleared by
    :func:`clear_query_context` when the query leaves the executor."""
    _ctx.tenant = tenant
    _ctx.trace_id = trace_id
    _ctx.plane = ""


def set_plane_context(plane: str) -> None:
    """Refine the thread's context with the plane (``index/field``)
    the next dispatch will scan."""
    _ctx.plane = plane


def query_context() -> tuple:
    """(tenant, plane, trace_id) for the calling thread."""
    return (getattr(_ctx, "tenant", ""), getattr(_ctx, "plane", ""),
            getattr(_ctx, "trace_id", None))


def clear_query_context() -> None:
    _ctx.tenant = ""
    _ctx.trace_id = None
    _ctx.plane = ""


# -- exact apportionment ------------------------------------------------------


def apportion(total: float, weights) -> list[float]:
    """Split ``total`` proportionally to ``weights`` such that the
    shares sum EXACTLY (bit-for-bit, left-to-right float sum) to
    ``total``.  Zero/empty weights split equally.  The last share
    absorbs the floating-point remainder, with a fix-up loop for the
    last-bit rounding of the final addition."""
    n = len(weights)
    if n == 0:
        return []
    if n == 1:
        return [total]
    wsum = 0.0
    for w in weights:
        wsum += float(w)
    shares = []
    acc = 0.0
    for w in weights[:-1]:
        s = (total * (float(w) / wsum)) if wsum > 0.0 else total / n
        shares.append(s)
        acc += s
    shares.append(total - acc)
    # float addition is not associative at the last bit; nudge the
    # remainder share until a left-to-right re-sum reproduces total
    for _ in range(4):
        s = 0.0
        for x in shares:
            s += x
        if s == total:
            break
        shares[-1] += total - s
    return shares


class CostLedger:
    """Per-tenant / per-shape / per-plane device-cost attribution.

    Charging runs once per dispatch window on the readback worker (or
    once per solo fast-lane dispatch on the caller thread after the
    answer is already host-resident) — off the latency-critical path.
    One small lock guards the rollup maps."""

    def __init__(self, stats=None, decay_seconds: float = DECAY_SECONDS):
        from pilosa_tpu_torch.obs import NopStats
        self._stats = stats or NopStats()
        self.decay_seconds = max(1.0, float(decay_seconds))
        self._lock = threading.Lock()
        # key -> [seconds, bytes, items]
        self._tenants: dict[str, list] = {}
        self._shapes: dict[str, list] = {}
        self._planes: dict[str, list] = {}
        # tenant -> [decayed seconds, last decay stamp]
        self._recent: dict[str, list] = {}
        # trace id -> apportioned seconds (bounded FIFO)
        self._trace_s: dict[str, float] = {}
        self._trace_order: list[str] = []
        self.windows = 0
        self.solo_dispatches = 0
        self.total_seconds = 0.0
        self.total_bytes = 0
        self.compile_seconds = 0.0
        self.compile_count = 0

    # -- charging ------------------------------------------------------------

    def charge_window(self, wall_seconds: float, entries) -> None:
        """Apportion one window's measured wall-clock to the items it
        served.  ``entries``: sequence of
        ``(tenant, shape, plane, nbytes, trace_id)`` — one per
        delivered item; seconds split by bytes share, bytes charged
        as measured."""
        entries = list(entries)
        if not entries:
            return
        shares = apportion(float(wall_seconds),
                           [e[3] for e in entries])
        with self._lock:
            self.windows += 1
            for (tenant, shape, plane, nbytes, trace_id), sec in zip(
                    entries, shares):
                self._charge(tenant, shape, plane, sec, nbytes,
                             trace_id)

    def charge_solo(self, tenant: str, shape: str, plane: str,
                    wall_seconds: float, nbytes: int,
                    trace_id: str | None = None) -> None:
        """A solo fast-lane dispatch: one caller, charged whole."""
        with self._lock:
            self.solo_dispatches += 1
            self._charge(tenant, shape, plane, float(wall_seconds),
                         nbytes, trace_id)

    def _charge(self, tenant: str, shape: str, plane: str,
                seconds: float, nbytes: int,
                trace_id: str | None) -> None:
        """Caller holds the lock."""
        tenant = tenant or "unattributed"
        plane = plane or tenant
        self.total_seconds += seconds
        self.total_bytes += int(nbytes)
        for table, key in ((self._tenants, tenant),
                           (self._shapes, shape),
                           (self._planes, plane)):
            row = table.get(key)
            if row is None:
                if len(table) >= _MAX_KEYS:
                    self._prune(table)
                row = table[key] = [0.0, 0, 0]
            row[0] += seconds
            row[1] += int(nbytes)
            row[2] += 1
        # decayed per-tenant rate (the QoS device-seconds feed)
        rec = self._recent.get(tenant)
        now = _mono()
        if rec is None:
            if len(self._recent) >= _MAX_KEYS:
                self._recent.clear()
            self._recent[tenant] = [seconds, now]
        else:
            rec[0] = rec[0] * self._decay(now - rec[1]) + seconds
            rec[1] = now
        if trace_id is not None:
            if trace_id not in self._trace_s:
                self._trace_order.append(trace_id)
                if len(self._trace_order) > _MAX_TRACES:
                    self._trace_s.pop(self._trace_order.pop(0), None)
            self._trace_s[trace_id] = (
                self._trace_s.get(trace_id, 0.0) + seconds)
        # scrape families (label cardinality capped at registry level)
        st = self._stats
        st.count("tenant_device_seconds_total", seconds, tenant=tenant)
        st.count("tenant_device_bytes_total", nbytes, tenant=tenant)
        st.count("shape_device_seconds_total", seconds, shape=shape)
        st.count("plane_device_seconds_total", seconds, plane=plane)
        # the hottest shape's latency bucket carries a resolvable
        # trace id as its exemplar
        st.observe("query_device_seconds", seconds, trace_id=trace_id,
                   shape=shape)

    @staticmethod
    def _prune(table: dict) -> None:
        keep = sorted(table.items(), key=lambda kv: -kv[1][0])
        cut = dict(keep[:_MAX_KEYS // 2])
        table.clear()
        table.update(cut)

    def _decay(self, dt: float) -> float:
        if dt <= 0.0:
            return 1.0
        return 0.5 ** (dt / self.decay_seconds)

    # -- compile observability ----------------------------------------------

    def note_compile(self, family: str, seconds: float,
                     first: bool) -> None:
        """The reference books per-family compile seconds here.  The
        port's kernels are built once per process, not compiled per
        query shape, so there is nothing to book: a no-op counterpart,
        and ``compileSecondsTotal`` / ``compileCount`` stay 0."""

    # -- read side -----------------------------------------------------------

    def recent_seconds(self, tenant: str) -> float:
        """Decayed device-seconds for one tenant — what the QoS
        ``tenant_device_seconds_quota`` admits against."""
        with self._lock:
            rec = self._recent.get(tenant)
            if rec is None:
                return 0.0
            return rec[0] * self._decay(_mono() - rec[1])

    def trace_seconds(self, trace_id: str | None) -> float | None:
        """Apportioned device-seconds charged to one trace (None when
        the trace never reached the device or was never charged)."""
        if trace_id is None:
            return None
        with self._lock:
            return self._trace_s.get(trace_id)

    def payload(self, top_k: int = 5) -> dict:
        """The ``/status`` costs block: totals plus top-K rollups by
        device seconds with the long tail folded into ``other``."""
        with self._lock:
            return {
                "windows": self.windows,
                "soloDispatches": self.solo_dispatches,
                "deviceSecondsTotal": round(self.total_seconds, 6),
                "bytesScannedTotal": int(self.total_bytes),
                "compileSecondsTotal": round(self.compile_seconds, 6),
                "compileCount": self.compile_count,
                "tenants": self._top(self._tenants, top_k),
                "shapes": self._top(self._shapes, top_k),
                "planes": self._top(self._planes, top_k),
                "trackedTenants": len(self._tenants),
                "trackedShapes": len(self._shapes),
                "trackedPlanes": len(self._planes),
            }

    @staticmethod
    def _top(table: dict, top_k: int) -> dict:
        rows = sorted(table.items(), key=lambda kv: -kv[1][0])
        out = {}
        other = [0.0, 0, 0]
        for i, (key, (sec, nbytes, items)) in enumerate(rows):
            if i < top_k:
                out[key] = {"deviceSeconds": round(sec, 6),
                            "bytes": int(nbytes), "items": items}
            else:
                other[0] += sec
                other[1] += nbytes
                other[2] += items
        if other[2]:
            out["other"] = {"deviceSeconds": round(other[0], 6),
                            "bytes": int(other[1]), "items": other[2]}
        return out


def _mono() -> float:
    import time
    return time.monotonic()


class NullLedger:
    """Ledger-shaped nothing (instrumentation-off benches)."""

    windows = 0
    solo_dispatches = 0

    def charge_window(self, wall_seconds, entries) -> None:
        pass

    def charge_solo(self, *a, **k) -> None:
        pass

    def note_compile(self, *a, **k) -> None:
        pass

    def recent_seconds(self, tenant: str) -> float:
        return 0.0

    def trace_seconds(self, trace_id):
        return None

    def payload(self, top_k: int = 5) -> dict:
        return {"windows": 0, "soloDispatches": 0,
                "deviceSecondsTotal": 0.0, "bytesScannedTotal": 0,
                "compileSecondsTotal": 0.0, "compileCount": 0,
                "tenants": {}, "shapes": {}, "planes": {},
                "trackedTenants": 0, "trackedShapes": 0,
                "trackedPlanes": 0}


NULL_LEDGER = NullLedger()
