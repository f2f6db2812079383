"""Cross-request coalescing: the concurrent serving spine
(``pilosa_tpu.exec.batcher``).

Serving threads submit planned work items; a collector thread waits a
short window, groups what arrived by kind and plane, launches one family
call per group (:mod:`pilosa_tpu_torch.exec.fused`) and packs the
window's int32 outputs into ONE device tensor, read back with one copy:

- ``count``: Count runs of any planned tree, stacked into one
  ``run_count_batch``;
- ``rowcounts``: whole-plane row counts (same-field Count batches, dense
  TopN); items over the same plane and filter DEDUPE to one scan;
- ``rowcounts-delta``: the same over a plane with a delta overlay, one
  scan plus one adjustment per (plane, overlay, filter);
- ``selcounts``: selected-row Counts; the items over one (plane,
  overlay) pair gather the UNION of their slots once;
- ``tree``: compound Counts compiled whole; the items over one (plane,
  overlay) pair gather the union of their rows once and fold one
  postfix program each;
- ``sum`` / ``minmax`` / ``bsirange``: BSI Sum, Min/Max and range Counts;
  the items over one (bit plane, overlay) pair run in one family call
  that reads the plane once per item, and identical items (same filter,
  same predicate) DEDUPE to one;
- ``groupby``: one GroupBy combination block; identical blocks (same
  planes, filter, overlay, aggregate and combinations, by a digest of
  the combination slots) DEDUPE to one, and every caller gets the same
  host arrays;
- ``distinct``: BSI Distinct presence scans; identical items (same plane
  and filter) share ONE scan, different ones scan on their own threads
  (a scan is a loop of launches and reads, so it joins no packed read).

The window is adaptive: it stays at 0 while traffic is solo and doubles
(``ADAPT_MIN`` .. ``ADAPT_MAX``) while windows coalesce.  With no queue
pressure a request takes the solo fast lane: its family call runs on the
caller's thread, no window, no hand-off.  Readback is pipelined: the
collector copies a window's packed output into pinned host memory
(``non_blocking``), records a CUDA event and hands the window to a reader
thread, which waits on that event alone (never on the device as a
whole, which would wait on the next window's work) and delivers the
answers, while the collector forms the next window.  Every launch and
copy goes to the current stream.

Robustness (the reference's self-healing pipeline):

- **Deadlines.**  Every submit carries the query's ``time.monotonic()``
  deadline: an expired one is refused before it is queued or launched,
  and :meth:`CountBatcher.wait` blocks at most until it, then marks the
  item ABANDONED and raises ``QueryTimeoutError`` naming the item's
  stage (``queued`` / ``dispatch`` / ``readback``).  The window's shared
  finish skips an abandoned item; co-batched answers are untouched.
- **Watchdog and quarantine.**  A monitor thread ages each dispatched
  window's current stage against ``watchdog_s``.  A window past it is
  quarantined: its unanswered items fail with ``PipelineStalledError``
  naming the stage, its pipeline slot is reclaimed, and the stage's
  worker (collector or reader) is superseded by a fresh thread; the old
  one exits when its wait ends.  A launch returns at once, so a slow or
  stalled card ages a window in ``readback``.  The stage clock leaves
  out the interpreter's garbage-collection pauses (:func:`_stage_clock`):
  a full collection in a process with many live objects stops every
  thread for a quarter of a second or more, and no stage is stalled by
  it.  Launched work cannot be
  cancelled: a quarantined window's operands, packed output and pinned
  buffer stay referenced (``_limbo``) until its CUDA event completes,
  and its late answers are dropped, never delivered twice.  A window of
  several groups launches them on a pool and bounds each group's launch
  by the watchdog: a hung group fails alone.
- **Device health governor** (:mod:`pilosa_tpu_torch.exec.health`):
  consecutive launch faults, or one watchdog trip, degrade serving: the
  fast lane and pipelining are off and each window's items run one at a
  time, read back inline, through the same hand kernels.  A probe window
  after ``probe_after_s`` restores healthy.

**Instruments** (the reference's families, names, labels and buckets):
``batcher_*`` per window, ``kernel_dispatch_seconds{kind}`` per group
launch (enqueue only: CUDA launches are asynchronous, so device time
lands in the readback), ``kernel_bytes_scanned_total{kind}``,
``kernel_window_bytes`` and ``kernel_bandwidth_gbps`` (a window's bytes
over its launch seconds plus its packed readback's wall),
``pipeline_*``, ``readback_overlap_ratio`` and
``solo_fastlane_hits_total{kind}``.  The cost ledger is charged each
window's launch seconds plus its readback wall, apportioned over its
items by bytes; a fast-lane call is charged whole (its wall spans the
launch and the read).  Each item carries the tenant, plane and trace it
was built under on the caller's thread, whichever thread launches it.
The flight recorder rings enqueue, dispatch, readback, deliver, watchdog
trips and quarantines.

There is no fallback.  A group whose launch or readback raises delivers
that exception to every item of the group (and counts a governor fault),
a failing fast-lane call raises to its caller, and the collector serves
the next window.  The reference retries a failed fused launch item by
item; on CUDA a launch fault is sticky (the context is lost) or
deterministic (the launch is refused again), so a retry could only hide
it.
"""

from __future__ import annotations

import gc
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import wait as wait_futures
from concurrent.futures import TimeoutError as _FutTimeout

import numpy as np
import torch

from pilosa_tpu_torch import fault
from pilosa_tpu_torch.engine import bsi as bsik
from pilosa_tpu_torch.exec import groupby as gb
from pilosa_tpu_torch.exec.errors import (PipelineStalledError,
                                          QueryTimeoutError)
from pilosa_tpu_torch.exec.fused import shift_leaves
from pilosa_tpu_torch.exec.health import DeviceHealthGovernor
from pilosa_tpu_torch.exec.tree import assemble_items
from pilosa_tpu_torch.obs import NULL_FLIGHT, NULL_LEDGER, NopStats
from pilosa_tpu_torch.obs.ledger import query_context as _query_ctx
from pilosa_tpu_torch.obs.metrics import (BYTE_BUCKETS, COUNT_BUCKETS,
                                          RATIO_BUCKETS)


# [seconds the interpreter's garbage collector has paused so far, the
#  start of the collection in progress or None]
_GC_PAUSED: list = [0.0, None]


def _gc_clock(phase: str, _info: dict) -> None:
    if phase == "start":
        _GC_PAUSED[1] = time.monotonic()
    else:
        _GC_PAUSED[0] += time.monotonic() - _GC_PAUSED[1]
        _GC_PAUSED[1] = None


gc.callbacks.append(_gc_clock)


def _stage_clock() -> float:
    """``time.monotonic()`` less the garbage collector's pauses: the
    watchdog ages a window's stage by the time the host could move it.
    During a collection the clock stands at the collection's start: other
    threads can run then (finalizers release the interpreter lock).  (A
    gen-2 pass over a process that has imported every test module took
    240 ms on an 8-core host: past a 0.1 s bound in a stage whose own
    work takes a millisecond.)"""
    since = _GC_PAUSED[1]
    return (time.monotonic() if since is None else since) - _GC_PAUSED[0]


class _Pending:
    __slots__ = ("kind", "nodes", "leaves", "delta", "event", "result",
                 "error", "deadline", "abandoned", "stage", "delivered",
                 "tenant", "plane", "trace")

    def __init__(self, kind, nodes, leaves, delta=None, deadline=None):
        self.kind = kind      # "count" | "rowcounts" | "selcounts" | "tree"
        #                       | "sum" | "minmax" | "bsirange" | "groupby"
        #                       | "distinct"
        self.nodes = nodes    # count: plan trees; selcounts: plane row
        #                       slots; tree: (slots, prog, extras);
        #                       bsirange: (spec, operands, sig); groupby:
        #                       (args, (agg, meta), sig);
        #                       rowcounts, sum, minmax, distinct: None
        self.leaves = leaves  # count: plan leaves; others: plane[, filter]
        self.delta = delta    # the plane's DeltaOverlay (base+delta)
        self.event = threading.Event()
        self.result = None
        self.error: Exception | None = None
        # the query's time.monotonic() cutoff; on expiry the caller marks
        # the item abandoned and leaves.  ``stage`` says where the item is
        # (queued -> dispatch -> readback); ``delivered`` is True once an
        # answer or an error was stored (the event alone cannot tell an
        # answer from an acknowledged abandon)
        self.deadline = deadline
        self.abandoned = False
        self.stage = "queued"
        self.delivered = False
        # the cost ledger's charge context, stamped on the caller's
        # thread where the item is built: who pays for its share of the
        # window, which plane it scans, and the trace it belongs to
        self.tenant, self.plane, self.trace = _query_ctx()


class _Window:
    """One dispatched window: what the watchdog ages, quarantine fails and
    a pipeline slot belongs to.  ``pending`` holds ``(group, device out,
    finish)`` per launched group; ``packed`` / ``host`` / ``event`` are
    the packed output, its pinned host copy and the event recorded after
    the copy.  Holding them until the reader is done (or, for a
    quarantined window, until the event completes) keeps their memory
    from being reused under the copy."""

    __slots__ = ("wid", "items", "stage", "t0", "pending", "distinct_futs",
                 "slot_held", "inflight", "done", "faulted", "bounded",
                 "packed", "host", "event", "win_bytes", "charge",
                 "read_t")

    def __init__(self, wid: int, items: list, slot_held: bool):
        self.wid = wid
        self.items = items          # every item popped into this window
        self.stage = "dispatch"     # "dispatch" -> "readback"
        self.t0 = _stage_clock()  # the current stage's start
        self.pending: list = []
        self.distinct_futs: list = []
        self.slot_held = slot_held  # owns a _pipe_slots token
        self.inflight = False       # counted in _inflight_windows
        self.done = False           # finished or quarantined
        self.faulted = False        # a group of it raised
        # the collector bounds its group joins itself (a window of
        # several groups): the whole-window watchdog defers
        self.bounded = False
        self.packed = self.host = self.event = None
        self.win_bytes = 0  # bytes the window's launches read
        self.read_t = 0.0  # its launches done: its readback begins
        # the ledger's (tenant, shape, plane, byte share, trace) per item
        self.charge: list = []


class CountBatcher:
    """Coalesces concurrent requests' Count, row-count, selected-count,
    tree, BSI, GroupBy and Distinct items into one family call per
    (kind, plane) group and one packed read per window."""

    # adaptive-window bounds: below MIN the window snaps to 0 (solo
    # traffic does not wait); MAX bounds what a burst adds to its tail
    ADAPT_MIN = 0.0005
    ADAPT_MAX = 0.005

    # most items one window takes; at most ``pipeline_depth`` windows are
    # dispatched but not yet read (a slot is taken before a window
    # launches and given back when it is read or quarantined)
    MAX_BATCH = 64
    PIPELINE_DEPTH = 2

    # consecutive quiet watchdog ticks after which the monitor parks (the
    # next enqueue restarts it)
    WATCHDOG_IDLE_TICKS = 8

    def __init__(self, fused, window_s="adaptive",
                 pipeline_depth: int = PIPELINE_DEPTH,
                 solo_fastlane: bool = True, watchdog_s: float = 5.0,
                 probe_after_s: float = 5.0, tier: str = "cuda",
                 stats=None, ledger=None, flight=None, placement_key=None):
        self.fused = fused
        # the executor's placement identity (``MeshPlacement.key``), None
        # on one device: it ends every group key and marks a meshed
        # window for ``mesh_collective_seconds``
        self.placement_key = placement_key
        self.stats = stats or NopStats()
        # item counts and ratios, not latencies: their own buckets
        self.stats.set_buckets("batcher_window_items", COUNT_BUCKETS)
        self.stats.set_buckets("batcher_window_fill_ratio", RATIO_BUCKETS)
        self.stats.set_buckets("kernel_window_bytes", BYTE_BUCKETS)
        self.stats.set_buckets("readback_overlap_ratio", RATIO_BUCKETS)
        self.stats.set_buckets("pipeline_window_fill", COUNT_BUCKETS)
        self.ledger = ledger or NULL_LEDGER
        self.flight = flight or NULL_FLIGHT
        # per-group launch seconds, taken into the window's charge at
        # readback (id(group) keys: plain dict writes, no lock)
        self._disp_s: dict[int, float] = {}
        # when the reader's last wait on a window's copy returned: the
        # card is done with that window, and the next one's kernels run
        self._synced_t = 0.0
        self.adaptive = window_s == "adaptive"
        self.window_s = 0.0 if self.adaptive else float(window_s)
        self._win = self.window_s
        self._queue: list[_Pending] = []
        self._lock = threading.Lock()
        self._kick = threading.Event()
        self._thread: threading.Thread | None = None
        self._closed = False
        self._stop = threading.Event()  # wakes the watchdog on close
        self._busy = 0  # collector cycles between pop and window register
        # pipelined readback; depth <= 1 finishes every window inline
        self.pipeline_depth = max(1, int(pipeline_depth))
        self._readq: queue.Queue | None = (
            queue.Queue() if self.pipeline_depth > 1 else None)
        self._pipe_slots = threading.Semaphore(self.pipeline_depth)
        self._read_thread: threading.Thread | None = None
        self._pool: ThreadPoolExecutor | None = None
        # launches on the group pool not yet finished: close() joins them,
        # so a hung launch cannot reach a fault site or the device after
        # its batcher closed
        self._pool_futs: set = set()
        # the window registry the watchdog ages (0 disables the watchdog:
        # no monitor thread, unbounded group joins)
        self.watchdog_s = max(0.0, float(watchdog_s))
        self._pipe_lock = threading.Lock()
        self._windows: dict[int, _Window] = {}
        self._win_seq = 0
        self._inflight_windows = 0
        self._watchdog: threading.Thread | None = None
        # quarantined windows whose launched work has not completed
        self._limbo: dict[int, _Window] = {}
        self._trips = 0
        self._quarantined = 0
        self.governor = DeviceHealthGovernor(probe_after_s=probe_after_s,
                                             tier=tier, stats=self.stats,
                                             flight=self.flight)
        # solo fast lane: admitted only while no other fast-lane call is
        # in flight, so overlapping callers fall into the window (the
        # adaptive window's pressure signal)
        self.solo_fastlane = bool(solo_fastlane)
        self._fl_active = 0
        self._fl_lock = threading.Lock()
        # counters: windows/items/max/kinds by the collector alone, the
        # rest under _fl_lock
        self.windows = 0
        self.items = 0
        self.max_window_items = 0
        self.fastlane_hits = 0
        self.bsi_batch_hits = 0
        self.distinct_windows = 0
        self.distinct_scans = 0
        # per kind: [family calls (groups), items, largest group]
        self.kinds: dict[str, list[int]] = {}

    def stats_payload(self) -> dict:
        """The ``/status`` batcher block."""
        with self._fl_lock:
            hits, scans = self.fastlane_hits, self.distinct_scans
        return {"window": "adaptive" if self.adaptive else self.window_s,
                "currentWindowSeconds": self._win,
                "windows": self.windows, "items": self.items,
                "maxWindowItems": self.max_window_items,
                "fastLaneHits": hits,
                "inflightWindows": self._inflight_windows,
                "distinctWindows": self.distinct_windows,
                "distinctScans": scans,
                "kinds": {k: {"groups": g, "items": n, "maxItems": m}
                          for k, (g, n, m) in list(self.kinds.items())}}

    def health_payload(self) -> dict:
        """The ``/status`` deviceHealth block: the governor's state and
        counters, the watchdog's bound and the quarantine count."""
        out = self.governor.payload()
        out.update({"watchdogSeconds": self.watchdog_s,
                    "quarantinedWindows": self._quarantined,
                    "inflightWindows": self._inflight_windows,
                    "bsiBatchHits": self.bsi_batch_hits})
        return out

    def close(self, timeout: float = 30.0) -> None:
        """Stop the collector, the reader, the watchdog and the group
        pool, each joined within ``timeout`` (a launch still hung on the
        pool included); queued items fail."""
        with self._lock:
            self._closed = True
            batch = self._queue[:]
            self._queue.clear()
        self._kick.set()
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
        if self._readq is not None:
            self._readq.put(None)
        if self._read_thread is not None:
            self._read_thread.join(timeout)
        if self._watchdog is not None:
            self._watchdog.join(timeout)
        if self._pool is not None:
            self._pool.shutdown(wait=False)
            with self._lock:
                futs = list(self._pool_futs)
            wait_futures(futs, timeout)
        err = RuntimeError("batcher closed")
        for p in batch:
            self._deliver_error(p, err)

    # -- delivery --------------------------------------------------------
    #
    # Every answer and error goes through these two, so an item is never
    # finished twice (quarantine racing a late readback) and an abandoned
    # item is skipped without disturbing its neighbours.

    @staticmethod
    def _deliver(p: _Pending, value) -> None:
        if not (p.abandoned or p.event.is_set()):
            p.result = value
            p.delivered = True
        p.event.set()

    @staticmethod
    def _deliver_error(p: _Pending, err: Exception) -> None:
        if not (p.abandoned or p.event.is_set()):
            p.error = err
            p.delivered = True
        p.event.set()

    def _fail(self, group: list, err: Exception) -> None:
        for p in group:
            self._deliver_error(p, err)

    @staticmethod
    def _check_deadline(deadline: float | None,
                        stage: str = "dispatch") -> None:
        """Refuse work whose deadline already passed: before the fast
        lane launches, and before an item takes a window slot."""
        if deadline is not None and time.monotonic() > deadline:
            raise QueryTimeoutError(
                f"query deadline expired before {stage}", stage=stage)

    def wait(self, p: _Pending):
        """Block on an enqueued item (pairs with the ``enqueue_*``
        methods: a request enqueues all its items into one window before
        waiting on any).  An item with a deadline waits at most until it,
        is then marked abandoned and raises ``QueryTimeoutError`` naming
        its stage; an answer stored before the mark still returns."""
        if p.deadline is None:
            p.event.wait()
        else:
            remaining = p.deadline - time.monotonic()
            if remaining <= 0 or not p.event.wait(remaining):
                p.abandoned = True
                # a deliverer between the timeout and the mark either
                # stored the answer (delivered) or saw the mark and
                # stored nothing: only ``delivered`` tells them apart
                if not p.delivered:
                    raise QueryTimeoutError(
                        "query deadline expired in the dispatch pipeline "
                        f"(stage={p.stage})", stage=p.stage)
        if p.error is not None:
            raise p.error
        return p.result

    def _ensure_worker(self) -> None:
        # caller holds self._lock
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._run_collector, name="pilosa-torch-batcher",
                daemon=True)
            self._thread.start()
        self._ensure_watchdog()

    def _enqueue(self, p: _Pending) -> _Pending:
        self.flight.record("enqueue", p.tenant, p.kind)
        with self._lock:
            if self._closed:
                raise RuntimeError("batcher closed")
            self._queue.append(p)
            self._ensure_worker()
        self._kick.set()
        return p

    def _submit(self, p: _Pending):
        return self.wait(self._enqueue(p))

    # -- solo fast lane ----------------------------------------------------

    def _fl_try_enter(self) -> bool:
        """Admit ONE fast-lane call: the lane on, the card healthy, the
        adaptive window at 0 (solo traffic), nothing queued, no other
        fast-lane call in flight (checked and taken under one lock)."""
        if not (self.solo_fastlane and self.adaptive and self._win == 0.0
                and not self._queue and self.governor.fastlane_ok()):
            return False
        with self._fl_lock:
            if self._fl_active:
                return False
            self._fl_active += 1
        return True

    def _fastlane(self, p: _Pending, fn, *args):
        """``fn(*args)`` on the caller's thread when the lane admits it;
        :data:`_MISS` otherwise (then ``p`` goes to the window).  An
        exception counts a governor fault and reaches the caller.  The
        call's wall spans the launch and the host read, so it is the
        item's whole device charge."""
        if not self._fl_try_enter():
            return _MISS
        t0 = time.perf_counter()
        try:
            out = fn(*args)
        except Exception:
            self.governor.record_fault()
            raise
        finally:
            with self._fl_lock:
                self._fl_active -= 1
        wall = time.perf_counter() - t0
        with self._fl_lock:
            self.fastlane_hits += 1
        # no kernel_dispatch_seconds here: that family is the windowed
        # path's enqueue time, and this wall includes the read
        nbytes = _group_bytes(self._group_key(p)[0], [p])
        self.stats.count("solo_fastlane_hits_total", 1, kind=p.kind)
        if nbytes:
            self.stats.count("kernel_bytes_scanned_total", nbytes,
                             kind=p.kind)
        self.ledger.charge_solo(p.tenant, p.kind, p.plane, wall, nbytes,
                                trace_id=p.trace)
        return out

    def _fastlane_counts(self, nodes: tuple, leaves: tuple) -> list[int]:
        host = self.fused.run_count_batch(nodes, leaves).cpu().numpy()
        return [int(row.sum()) for row in host.astype(np.int64)]

    def _fastlane_selected(self, plane, slots: tuple, delta) -> np.ndarray:
        order = sorted(set(slots))
        pos = {s: i for i, s in enumerate(order)}
        out = self.fused.run_selected_counts(plane, tuple(order), delta)
        host = out.cpu().numpy().astype(np.int64)
        return host[[pos[s] for s in slots]]

    def _fastlane_rowcounts(self, plane, filter_words,
                            delta) -> np.ndarray:
        if delta is not None:
            out = self.fused.run_rowcounts_delta(plane, delta,
                                                 filter_words)
        else:
            leaves = ((plane,) if filter_words is None
                      else (plane, filter_words))
            out = self.fused.run_rowcounts_batch(
                (filter_words is not None,), leaves)[0]
        return out.cpu().numpy().astype(np.int64)

    def _fastlane_tree(self, plane, slots: tuple, prog: tuple,
                       extras: tuple, delta) -> int:
        out = self.fused.run_tree_counts(plane, tuple(slots), (prog,),
                                         tuple(extras), delta=delta)
        return int(out.cpu()[0])

    def _fastlane_agg(self, kind: str, plane, filter_words, delta):
        flags = (filter_words is not None,)
        filters = (filter_words,) if filter_words is not None else ()
        run, decode = self._AGG[kind]
        out = getattr(self.fused, run)(plane, flags, filters, delta=delta)
        return decode(out.cpu().numpy()[0])

    def _fastlane_bsirange(self, plane, spec: tuple, operands: tuple,
                           delta) -> int:
        out = self.fused.run_range_batch(plane, (spec,), tuple(operands),
                                         delta=delta)
        return int(out.cpu()[0])

    def _fastlane_groupby(self, args: tuple, agg_kind, meta: tuple) -> dict:
        out = self.fused.run_groupby_batch(*args[:5], agg_kind,
                                           delta=args[5])
        return gb.unflatten_block(out.cpu().numpy(), *meta, agg_kind)

    # -- submits -----------------------------------------------------------
    #
    # ``deadline``: the query's time.monotonic() cutoff (None: unbounded).

    def submit(self, node, leaves, deadline: float | None = None) -> int:
        """One Count tree over its planned leaves -> int64 total."""
        return self.submit_many((node,), leaves, deadline=deadline)[0]

    def submit_many(self, nodes, leaves,
                    deadline: float | None = None) -> list[int]:
        """A whole request's Count run as ONE item (the nodes share one
        leaf list)."""
        nodes, leaves = tuple(nodes), tuple(leaves)
        self._check_deadline(deadline)
        p = _Pending("count", nodes, leaves, deadline=deadline)
        out = self._fastlane(p, self._fastlane_counts, nodes, leaves)
        if out is not _MISS:
            return out
        return self._submit(p)

    def submit_rowcounts(self, plane, filter_words=None, delta=None,
                         deadline: float | None = None) -> np.ndarray:
        """Whole-plane per-row totals int64[R_pad] (the shard axis
        reduced on the device: callers gate on the int32-exact shard
        bound), base+delta when ``delta`` is set."""
        self._check_deadline(deadline)
        p = self._rowcounts_item(plane, filter_words, delta, deadline)
        out = self._fastlane(p, self._fastlane_rowcounts, plane,
                             filter_words, delta)
        if out is not _MISS:
            return out
        return self._submit(p)

    def enqueue_rowcounts(self, plane, filter_words=None, delta=None,
                          deadline: float | None = None) -> _Pending:
        self._check_deadline(deadline, stage="queued")
        return self._enqueue(self._rowcounts_item(plane, filter_words,
                                                  delta, deadline))

    @staticmethod
    def _rowcounts_item(plane, filter_words, delta, deadline) -> _Pending:
        leaves = (plane,) if filter_words is None else (plane, filter_words)
        return _Pending("rowcounts", None, leaves, delta, deadline=deadline)

    def submit_selected(self, plane, slots: tuple, delta=None,
                        deadline: float | None = None) -> np.ndarray:
        """Selected-row totals int64[len(slots)] in the caller's slot
        order; the window's items over one (plane, overlay) pair gather
        the union of their slots once."""
        self._check_deadline(deadline)
        p = _Pending("selcounts", tuple(slots), (plane,), delta,
                     deadline=deadline)
        out = self._fastlane(p, self._fastlane_selected, plane,
                             tuple(slots), delta)
        if out is not _MISS:
            return out
        return self._submit(p)

    def submit_tree(self, plane, slots: tuple, prog: tuple,
                    extras: tuple = (), delta=None,
                    deadline: float | None = None) -> int:
        """One compound-tree Count (``exec.tree`` operands) -> total."""
        self._check_deadline(deadline)
        p = self._tree_item(plane, slots, prog, extras, delta, deadline)
        out = self._fastlane(p, self._fastlane_tree, plane, slots, prog,
                             extras, delta)
        if out is not _MISS:
            return out
        return self._submit(p)

    def enqueue_tree(self, plane, slots: tuple, prog: tuple,
                     extras: tuple = (), delta=None,
                     deadline: float | None = None) -> _Pending:
        self._check_deadline(deadline, stage="queued")
        return self._enqueue(self._tree_item(plane, slots, prog, extras,
                                             delta, deadline))

    @staticmethod
    def _tree_item(plane, slots, prog, extras, delta, deadline) -> _Pending:
        return _Pending("tree", (tuple(slots), tuple(prog), tuple(extras)),
                        (plane,), delta, deadline=deadline)

    def submit_sum(self, plane, filter_words=None, delta=None,
                   deadline: float | None = None):
        """BSI Sum -> (sum of offsets, non-null count), host-finished.
        ``delta`` (a ``BsiOverlay``) merges the plane's pending write
        columns: base+delta."""
        return self._submit_agg("sum", plane, filter_words, delta,
                                deadline)

    def submit_minmax(self, plane, filter_words=None, delta=None,
                      deadline: float | None = None) -> list:
        """BSI Min/Max -> (min, min_cnt, max, max_cnt) per shard, plus one
        per overlay column (zero-count entries: the caller drops them)."""
        return self._submit_agg("minmax", plane, filter_words, delta,
                                deadline)

    def _submit_agg(self, kind: str, plane, filter_words, delta, deadline):
        self._check_deadline(deadline)
        leaves = (plane,) if filter_words is None else (plane, filter_words)
        p = _Pending(kind, None, leaves, delta, deadline=deadline)
        out = self._fastlane(p, self._fastlane_agg, kind, plane,
                             filter_words, delta)
        if out is not _MISS:
            return out
        return self._submit(p)

    def submit_bsirange(self, plane, spec: tuple, operands: tuple,
                        sig: tuple, delta=None,
                        deadline: float | None = None) -> int:
        """One BSI range Count (``spec`` = (op_keys, has_filter), see
        ``FusedCache.run_range_batch``); identical predicates (same
        ``sig``) in a window dedupe to one comparison chain."""
        self._check_deadline(deadline)
        p = self._bsirange_item(plane, spec, operands, sig, delta, deadline)
        out = self._fastlane(p, self._fastlane_bsirange, plane, spec,
                             operands, delta)
        if out is not _MISS:
            return out
        return self._submit(p)

    def enqueue_bsirange(self, plane, spec: tuple, operands: tuple,
                         sig: tuple, delta=None,
                         deadline: float | None = None) -> _Pending:
        self._check_deadline(deadline, stage="queued")
        return self._enqueue(self._bsirange_item(plane, spec, operands, sig,
                                                 delta, deadline))

    @staticmethod
    def _bsirange_item(plane, spec, operands, sig, delta,
                       deadline) -> _Pending:
        return _Pending("bsirange", (spec, tuple(operands), sig), (plane,),
                        delta, deadline=deadline)

    def submit_groupby(self, planes: tuple, combo_idx, last_plane,
                       filter_words, agg_plane, agg_kind, meta: tuple,
                       digest: bytes, delta=None,
                       deadline: float | None = None) -> dict:
        """One GroupBy combination block (``exec.groupby.groupby_out``'s
        arguments; ``combo_idx`` a host array) -> its parts as host arrays.
        ``meta`` = (combinations, innermost rows, depth) for the unflatten;
        ``digest`` hashes the combination slots, so identical concurrent
        blocks (same planes, filter, overlay, aggregate and combinations)
        dedupe to one call.  ``delta``: the bit plane's ``BsiOverlay``."""
        self._check_deadline(deadline)
        args = (tuple(planes), combo_idx, last_plane, filter_words,
                agg_plane, delta)
        sig = (tuple(id(p) for p in planes), id(last_plane),
               id(filter_words) if filter_words is not None else 0,
               id(agg_plane) if agg_plane is not None else 0,
               id(delta) if delta is not None else 0, agg_kind, digest)
        p = _Pending("groupby", (args, (agg_kind, meta), sig),
                     (last_plane,), deadline=deadline)
        out = self._fastlane(p, self._fastlane_groupby, args, agg_kind, meta)
        if out is not _MISS:
            return out
        return self._submit(p)

    def submit_distinct(self, plane, filter_words=None,
                        deadline: float | None = None):
        """BSI Distinct presence -> host (pos bool[2^d], neg bool[2^d]).
        Coalescing is deduplication only: identical concurrent items
        share one scan; the scan is a loop of launches and reads, so it
        never takes the fast lane or a packed read."""
        self._check_deadline(deadline)
        leaves = (plane,) if filter_words is None else (plane, filter_words)
        return self._submit(_Pending("distinct", None, leaves,
                                     deadline=deadline))

    # -- collector ---------------------------------------------------------

    def _superseded(self) -> bool:
        """A quarantine restart replaced this collector: stop touching
        the queue."""
        return self._thread is not threading.current_thread()

    def _run_collector(self) -> None:
        while not self._closed:
            if self._superseded():
                return
            try:
                self._collect_once()
            except Exception as e:  # noqa: BLE001 — the worker must survive
                self._fail_backlog(e)

    def _fail_backlog(self, exc: Exception) -> None:
        """A collector cycle failed outside any window: every queued item
        fails with a stall error naming the ``collect`` stage instead of
        waiting forever, and the same thread keeps serving."""
        with self._lock:
            batch = self._queue[:]
            self._queue.clear()
            self._kick.clear()
        err = PipelineStalledError(
            f"dispatch collector failed; {len(batch)} queued item(s) "
            f"aborted: {exc!r}", stage="collect")
        err.__cause__ = exc
        for p in batch:
            self._deliver_error(p, err)

    def _collect_once(self) -> None:
        self._kick.wait()
        if self._closed or self._superseded():
            return
        if self._win > 0:
            time.sleep(self._win)
        with self._lock:
            backlog = len(self._queue)
            batch = self._queue[: self.MAX_BATCH]
            del self._queue[: len(batch)]
            if not self._queue:
                self._kick.clear()
            if batch:
                self._busy += 1  # the idle watchdog waits for the window
        if not batch:
            return
        try:
            self._process_batch(batch, backlog)
        except Exception as e:  # noqa: BLE001 — answer, never strand
            self._fail(batch, e)
        finally:
            with self._lock:
                self._busy -= 1

    def _process_batch(self, batch: list, backlog: int) -> None:
        if self.adaptive:
            if len(batch) > 1 or backlog > len(batch):
                self._win = min(max(self._win * 2, self.ADAPT_MIN),
                                self.ADAPT_MAX)
            elif self._win:
                nxt = self._win / 2
                self._win = 0.0 if nxt < self.ADAPT_MIN else nxt
        self.windows += 1
        self.items += len(batch)
        self.max_window_items = max(self.max_window_items, len(batch))
        st = self.stats
        st.count("batcher_batches", 1)
        st.count("batcher_items", len(batch))
        st.gauge("batcher_window_seconds", self._win)
        st.observe("batcher_window_items", float(len(batch)))
        st.observe("batcher_window_fill_ratio", len(batch) / self.MAX_BATCH)
        groups: dict[tuple, list[_Pending]] = {}
        for p in batch:
            # the placement's identity ends every key, as in the
            # reference; one batcher serves one executor, so it never
            # separates two groups here
            groups.setdefault(self._group_key(p) + (self.placement_key,),
                              []).append(p)
        for key, group in groups.items():
            ks = self.kinds.setdefault(key[0], [0, 0, 0])
            ks[0] += 1
            ks[1] += len(group)
            ks[2] = max(ks[2], len(group))
            st.observe("pipeline_window_fill", float(len(group)),
                       kind=key[0])
            if key[0] in ("sum", "minmax", "bsirange") and len(group) > 1:
                st.count("bsi_batch_hits_total", len(group) - 1,
                         kind=key[0])
                self.bsi_batch_hits += len(group) - 1
        if any(key[0] == "distinct" for key in groups):
            self.distinct_windows += 1
        if not self.governor.admit():
            # DEGRADED: each item alone, read back inline, through the
            # same hand kernels; no pipeline, no shared readback to stall
            for p in batch:
                p.stage = "dispatch"
            for key, group in groups.items():
                if key[0] == "distinct":
                    self._run_distinct(group)
                else:
                    self._run_per_item(key[0], group)
            return
        self._dispatch_window(batch, groups)

    @staticmethod
    def _group_key(p: _Pending) -> tuple:
        """Kind plus what makes outputs shareable: counts stack by shard
        count; selcounts and trees share a gather, and BSI items a family
        call, per (plane, overlay) identity; rowcounts stack by plane
        shape (and dedupe by leaf identity), or share one base+delta scan
        per (plane, overlay, filter) identity; Distincts dedupe by leaf
        identity within their plane shape."""
        delta = id(p.delta) if p.delta is not None else 0
        if p.kind == "groupby":
            return ("groupby",) + p.nodes[2]
        if p.kind == "count":
            return ("count", p.leaves[0].shape[0])
        if p.kind in ("selcounts", "tree", "sum", "minmax", "bsirange"):
            return (p.kind, id(p.leaves[0]), delta)
        if p.kind == "distinct":
            return ("distinct", tuple(p.leaves[0].shape))
        if p.delta is not None:
            return ("rowcounts-delta", id(p.leaves[0]), delta,
                    id(p.leaves[1]) if len(p.leaves) == 2 else 0)
        return ("rowcounts", tuple(p.leaves[0].shape))

    def _pool_submit(self, fn, *args):
        """Run ``fn(*args)`` on the group pool, tracked until it ends."""
        if self._pool is None:
            self._pool = ThreadPoolExecutor(
                max_workers=8, thread_name_prefix="pilosa-torch-batch-group")
        fut = self._pool.submit(fn, *args)
        with self._lock:
            self._pool_futs.add(fut)
        fut.add_done_callback(self._pool_done)
        return fut

    def _pool_done(self, fut) -> None:
        with self._lock:
            self._pool_futs.discard(fut)

    def _dispatch_window(self, batch: list, groups: dict) -> None:
        """One launch per group, the window's outputs packed into one
        readback (handed to the reader while pipelining is on), the
        window registered with the watchdog from launch to delivery."""
        program_groups, distinct_groups = [], []
        for key, group in groups.items():
            (distinct_groups if key[0] == "distinct"
             else program_groups).append((key, group))
        slot_held = False
        if self._readq is not None and self.governor.pipelining_ok():
            self._pipe_slots.acquire()
            slot_held = True
        w = self._register_window(batch, slot_held)
        for p in batch:
            p.stage = "dispatch"
        distinct_futs = [self._pool_submit(self._run_distinct, g)
                         for _, g in distinct_groups]
        pending = []
        if len(program_groups) == 1:
            key, group = program_groups[0]
            try:
                pending.append((group,) + self._dispatch_group(key[0], group))
            except Exception as e:  # noqa: BLE001 — to its callers
                w.faulted = True
                self.governor.record_fault()
                self._fail(group, e)
        elif program_groups:
            # several groups launch on the pool and each join is bounded
            # by the watchdog: a hung group fails alone while the others
            # proceed (the whole-window watchdog defers meanwhile)
            futs = [(key, group, self._pool_submit(
                self._dispatch_group, key[0], group))
                for key, group in program_groups]
            bound = self.watchdog_s if self.watchdog_s > 0 else None
            w.bounded = True
            for key, group, fut in futs:
                try:
                    pending.append((group,) + fut.result(bound))
                except _FutTimeout:
                    self._fail_stalled_group(key, group, bound)
                    w.faulted = True
                except Exception as e:  # noqa: BLE001 — to its callers
                    w.faulted = True
                    self.governor.record_fault()
                    self._fail(group, e)
                w.t0 = _stage_clock()  # the bound is per stall, not total
            w.bounded = False
        w.read_t = time.perf_counter()
        if w.done:
            return  # quarantined meanwhile: its items already failed
        # the bytes the launches read (a group's items share one pass);
        # each item's ledger weight is its equal share of its group's
        for group, _, _ in pending:
            kind = self._group_key(group[0])[0]
            nbytes = _group_bytes(kind, group)
            if nbytes:
                self.stats.count("kernel_bytes_scanned_total", nbytes,
                                 kind=kind)
                w.win_bytes += nbytes
            share = nbytes / max(1, len(group))
            for p in group:
                w.charge.append((p.tenant, p.kind, p.plane, share, p.trace))
        w.pending = pending
        w.distinct_futs = distinct_futs
        if pending:
            try:
                self._start_read(w)
            except Exception as e:  # noqa: BLE001 — to its callers
                w.faulted = True
                self.governor.record_fault()
                for group, _, _ in pending:
                    self._fail(group, e)
                w.pending = []
        if not (w.pending or distinct_futs):
            if self._window_done(w):
                self._note_delivered(w)
            return
        with self._pipe_lock:
            w.stage = "readback"
            w.t0 = _stage_clock()
        self.flight.record("readback", f"w{w.wid}")
        for p in batch:
            p.stage = "readback"
        if slot_held:
            with self._pipe_lock:
                if w.done:
                    return
                overlapped = self._inflight_windows > 0
                self._inflight_windows += 1
                w.inflight = True
                depth = self._inflight_windows
            self.stats.observe("readback_overlap_ratio",
                               1.0 if overlapped else 0.0)
            self.stats.gauge("dispatch_pipeline_depth", depth)
            self._ensure_reader()
            self._readq.put(w)
            return
        err = None
        try:
            self._finish_window(w)
        except Exception as e:  # noqa: BLE001 — fail, never wedge, the window
            err = e
        if err is not None:
            self._fail_window_items(w, _wrap_readback_error(err))
        if self._window_done(w):
            self._note_delivered(w)
            if err is None and not w.faulted:
                self.governor.record_success()

    def _note_delivered(self, w: _Window) -> None:
        self.flight.record("deliver", f"w{w.wid}", "", float(len(w.items)))

    def _dispatch_group(self, kind: str, group: list):
        """One group's launch: ``(device out, finish)``.  Its seconds are
        observed per kind (``kernel_dispatch_seconds``) and kept for the
        window's charge."""
        t0 = time.perf_counter()
        if fault.ACTIVE:
            # a stalled launch (delay) and a refused one (error)
            fault.fire("exec.dispatch_hang", kind=kind)
            fault.fire("exec.dispatch_error", kind=kind)
        ret = self._dispatch_one(kind, group)
        elapsed = time.perf_counter() - t0
        self.stats.observe("kernel_dispatch_seconds", elapsed, kind=kind)
        self._disp_s[id(group)] = elapsed
        return ret

    def _dispatch_one(self, kind: str, group: list):
        if kind == "count":
            return self._dispatch_counts(group)
        if kind == "selcounts":
            return self._dispatch_selcounts(group)
        if kind == "tree":
            return self._dispatch_tree(group)
        if kind == "rowcounts-delta":
            return self._dispatch_rowcounts_delta(group)
        if kind in self._AGG:
            return self._dispatch_aggs(kind, group)
        if kind == "bsirange":
            return self._dispatch_bsirange(group)
        if kind == "groupby":
            return self._dispatch_groupby(group)
        return self._dispatch_rowcounts(group)

    def _run_per_item(self, kind: str, group: list) -> None:
        """Degraded serving: each live item launched alone (the same
        family call, hence the same hand kernels) and read back at once;
        its error goes to it alone."""
        for p in group:
            if p.abandoned or p.event.is_set():
                continue
            try:
                out, finish = self._dispatch_one(kind, [p])
                finish(out.cpu().numpy())
            except Exception as e:  # noqa: BLE001 — to its caller
                self._deliver_error(p, e)

    def _run_distinct(self, group: list) -> None:
        """The group's unique (plane, filter) items scan once each, on
        their own threads when there are several; every item gets its
        representative's host arrays."""
        t0 = time.perf_counter()
        items, assign = _dedupe(group)
        results: list = [None] * len(items)
        errors: list = [None] * len(items)

        def scan(i: int) -> None:
            p = items[i]
            try:
                flt = p.leaves[1] if len(p.leaves) == 2 else None
                pos, neg = bsik.distinct_presence(p.leaves[0], flt)
                results[i] = (pos.cpu().numpy(), neg.cpu().numpy())
            except Exception as e:  # noqa: BLE001 — to its callers
                errors[i] = e

        if len(items) == 1:
            scan(0)
        else:
            # plain threads, not the group pool this may itself run on
            ts = [threading.Thread(target=scan, args=(i,),
                                   name="pilosa-torch-distinct")
                  for i in range(len(items))]
            for t in ts:
                t.start()
            for t in ts:
                t.join()
        with self._fl_lock:
            self.distinct_scans += len(items)
        for p, slot in zip(group, assign):
            if errors[slot] is not None:
                self._deliver_error(p, errors[slot])
            else:
                self._deliver(p, results[slot])
        # a Distinct scan joins no packed read: its observation covers
        # the whole scan, read included
        self.stats.observe("kernel_dispatch_seconds",
                           time.perf_counter() - t0, kind="distinct")
        nbytes = _group_bytes("distinct", group)
        if nbytes:
            self.stats.count("kernel_bytes_scanned_total", nbytes,
                             kind="distinct")

    def _fail_stalled_group(self, key, group: list, bound: float) -> None:
        """One group's launch outlived the watchdog bound while the rest
        of its window proceeded: its items alone fail, naming the
        ``dispatch`` stage, and the governor degrades (the wedged pool
        worker finishes when the hang ends; its answer is dropped)."""
        self._trips += 1
        self._quarantined += 1
        self.stats.count("pipeline_watchdog_trips_total", 1,
                         stage="dispatch")
        self.stats.count("pipeline_quarantined_windows_total", 1)
        # recorded and dumped before the governor trips, so its degrade
        # incident cannot rate-limit this one away
        self.flight.record("watchdog_trip", key[0], "dispatch", bound)
        self.flight.record("quarantine", key[0], "dispatch", bound)
        self.flight.incident("quarantine", key[0], "dispatch")
        self.governor.record_trip()
        err = PipelineStalledError(
            f"{key[0]} dispatch stalled past the {bound:g}s watchdog bound "
            "and was quarantined (dispatch_watchdog_seconds)",
            stage="dispatch", elapsed=bound)
        self._fail(group, err)

    # -- window registry and watchdog --------------------------------------

    def _register_window(self, batch: list, slot_held: bool) -> _Window:
        with self._pipe_lock:
            self._win_seq += 1
            w = _Window(self._win_seq, batch, slot_held)
            if self.watchdog_s > 0:
                self._windows[w.wid] = w
        self.flight.record("dispatch", f"w{w.wid}", "", float(len(batch)))
        return w

    def _window_done(self, w: _Window) -> bool:
        """Close a window once: unregister it, give back its pipeline
        slot.  False when it was already closed (quarantined, or a
        superseded worker finishing late)."""
        with self._pipe_lock:
            if w.done:
                return False
            w.done = True
            self._windows.pop(w.wid, None)
            depth = None
            if w.inflight:
                w.inflight = False
                self._inflight_windows -= 1
                depth = self._inflight_windows
            slot = w.slot_held
            w.slot_held = False
        if depth is not None:
            self.stats.gauge("dispatch_pipeline_depth", depth)
        if slot:
            self._pipe_slots.release()
        # a quarantined window never reaches the charge: drop its groups'
        # launch seconds here
        for group, _, _ in w.pending:
            self._disp_s.pop(id(group), None)
        return True

    def _fail_window_items(self, w: _Window, err: Exception) -> None:
        """Fail every unanswered item of the window (answered and
        abandoned ones are skipped by the delivery guard)."""
        for p in w.items:
            self._deliver_error(p, err)

    def _ensure_watchdog(self) -> None:
        # caller holds self._lock
        if self.watchdog_s <= 0:
            return
        if self._watchdog is None or not self._watchdog.is_alive():
            self._watchdog = threading.Thread(
                target=self._watchdog_loop, name="pilosa-torch-watchdog",
                daemon=True)
            self._watchdog.start()

    def _watchdog_loop(self) -> None:
        """Age every registered window's stage; quarantine the overdue.
        Windows whose group joins the collector bounds itself
        (``bounded``) are skipped.  Quarantined windows leave ``_limbo``
        once their event completes.  Parks after ``WATCHDOG_IDLE_TICKS``
        quiet ticks (the next enqueue revives it)."""
        idle = 0
        while not self._closed:
            # re-derived per tick: a live change of watchdog_s applies
            if self._stop.wait(max(0.02, min(self.watchdog_s / 4.0, 1.0))
                               if self.watchdog_s > 0 else 0.25):
                return
            self._prune_limbo()
            if self.watchdog_s <= 0:
                with self._lock:
                    if self._watchdog is threading.current_thread():
                        self._watchdog = None
                return
            now = _stage_clock()
            with self._pipe_lock:
                stuck = [w for w in self._windows.values()
                         if not w.done and not w.bounded
                         and now - w.t0 > self.watchdog_s]
            for w in stuck:
                self._quarantine(w, now - w.t0)
            with self._lock:
                backlog = bool(self._queue)
                t = self._thread
                if (not self._queue and not self._busy and not self._windows
                        and not self._limbo):
                    idle += 1
                    if (idle >= self.WATCHDOG_IDLE_TICKS
                            and self._watchdog is threading.current_thread()):
                        self._watchdog = None
                        return
                else:
                    idle = 0
            if backlog and t is not None and not t.is_alive():
                self._restart_collector()

    def _prune_limbo(self) -> None:
        for wid, w in list(self._limbo.items()):
            try:
                finished = w.event is None or w.event.query()
            except Exception:  # noqa: BLE001 — a failed event is finished
                finished = True
            if finished:
                self._limbo.pop(wid, None)

    def _quarantine(self, w: _Window, age: float) -> None:
        """A window outlived the watchdog bound in ``w.stage``: fail its
        unanswered items with a stall error naming the stage, give back
        its slot, keep its operands until its event completes, and
        supersede the stage's worker so the queue keeps draining."""
        stage = w.stage
        # read before _window_done clears it: a window handed to the
        # reader wedges the reader, else the collector is finishing it
        handed = w.inflight
        if not self._window_done(w):
            return  # finished meanwhile: no trip
        self._trips += 1
        self._quarantined += 1
        if w.event is not None:
            self._limbo[w.wid] = w
        self.stats.count("pipeline_watchdog_trips_total", 1, stage=stage)
        self.stats.count("pipeline_quarantined_windows_total", 1)
        # the flight events name the stage the callers' error names
        self.flight.record("watchdog_trip", f"w{w.wid}", stage, age)
        self.flight.record("quarantine", f"w{w.wid}", stage, age)
        self.flight.incident("quarantine", f"w{w.wid}", stage)
        self.governor.record_trip()
        err = PipelineStalledError(
            f"dispatch-pipeline window stalled in {stage} for {age:.2f}s "
            f"(dispatch_watchdog_seconds={self.watchdog_s:g}); the window "
            "was quarantined and its pipeline slot reclaimed",
            stage=stage, elapsed=age)
        self._fail_window_items(w, err)
        if stage == "readback" and handed and self._readq is not None:
            self._restart_reader()
        else:
            self._restart_collector()

    def _restart_collector(self) -> None:
        with self._lock:
            self._thread = threading.Thread(
                target=self._run_collector, name="pilosa-torch-batcher",
                daemon=True)
            self._thread.start()
        # wake a superseded collector parked on the kick (it exits) and
        # hand any backlog to the new one
        self._kick.set()

    def _restart_reader(self) -> None:
        self._read_thread = threading.Thread(
            target=self._read_loop, name="pilosa-torch-readback",
            daemon=True)
        self._read_thread.start()
        self._readq.put(None)  # wakes a parked superseded reader

    # -- readback ----------------------------------------------------------

    def _ensure_reader(self) -> None:
        if self._read_thread is None or not self._read_thread.is_alive():
            self._read_thread = threading.Thread(
                target=self._read_loop, name="pilosa-torch-readback",
                daemon=True)
            self._read_thread.start()

    def _start_read(self, w: _Window) -> None:
        """Pack the window's outputs into one int32 tensor and start its
        copy into pinned host memory, recording an event after it."""
        outs = [out for _, out, _ in w.pending]
        packed = (outs[0].reshape(-1) if len(outs) == 1
                  else self.fused.run_readback_pack(tuple(outs)))
        if packed.device.type == "cuda":
            host = torch.empty(packed.shape, dtype=packed.dtype,
                               pin_memory=True)
            host.copy_(packed, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(packed.device))
        else:
            host, ev = packed, None
        w.packed, w.host, w.event = packed, host, ev

    def _read_loop(self) -> None:
        while True:
            if self._read_thread is not threading.current_thread():
                return  # superseded by a quarantine restart
            w = self._readq.get()
            if w is None:
                if self._closed:
                    return
                continue  # a wake-up
            if w.done:
                continue  # quarantined while queued
            err = None
            try:
                self._finish_window(w)
            except Exception as e:  # noqa: BLE001 — fail, never wedge
                err = e
            if err is not None:
                self._fail_window_items(w, _wrap_readback_error(err))
            if self._window_done(w):
                self._note_delivered(w)
                if err is None and not w.faulted:
                    self.governor.record_success()
            # the last window must not keep its planes alive while the
            # reader waits for the next one
            w = None

    def _finish_window(self, w: _Window) -> None:
        if fault.ACTIVE:
            fault.fire("exec.readback_hang")  # a stalled readback
        # the wall starts at the read, not at the launch: a pipelined
        # window's wait behind the previous one is not its device time,
        # and the read still blocks on the window's own kernels.  The
        # read begins once the launches are done (the packing, the
        # pinned copy and the wait are the reference's packed readback),
        # or, behind a previous window, when the card is done with it:
        # the card runs this window's kernels while the collector packs
        # it and the reader delivers the window before, and a clock
        # started after that host work would miss them
        t0 = time.perf_counter()
        if w.read_t:
            t0 = min(t0, max(w.read_t, self._synced_t))
        self._readback(w)
        wall = time.perf_counter() - t0
        if self.placement_key is not None and w.pending:
            # a meshed window: the read waits for the per-block launches,
            # the gathers onto the first device and the copy, so its wall
            # is the window's gather and readback cost
            self.stats.observe("mesh_collective_seconds", wall)
        disp = 0.0
        for group, _, _ in w.pending:
            disp += self._disp_s.pop(id(group), 0.0)
        if w.charge:
            self.ledger.charge_window(disp + wall, w.charge)
        if w.win_bytes:
            self.stats.observe("kernel_window_bytes", float(w.win_bytes))
            # over the window's charged seconds: its launches too, since
            # a kernel starts on an idle card as it is launched
            if disp + wall > 0:
                self.stats.gauge("kernel_bandwidth_gbps",
                                 round(w.win_bytes / (disp + wall) / 1e9,
                                       4))
        for f in w.distinct_futs:
            try:
                f.result()
            except Exception:  # noqa: BLE001 — _run_distinct delivers its own
                pass

    def _readback(self, w: _Window) -> None:
        """Wait for the window's copy, then slice each group's answers
        out of the one host array.  A failed wait reaches every item of
        the window, a failed finish its group."""
        if not w.pending:
            return
        try:
            if w.event is not None:
                w.event.synchronize()
                self._synced_t = time.perf_counter()
            flat = w.host.numpy()
            if len(w.pending) > 1:
                self.stats.count("batcher_readback_packed", 1)
                self.stats.count("batcher_readback_groups", len(w.pending))
        except Exception as e:  # noqa: BLE001 — to every item
            w.faulted = True
            self.governor.record_fault()
            for group, _, _ in w.pending:
                self._fail(group, e)
            return
        off = 0
        for group, out, finish in w.pending:
            n = out.numel()
            try:
                finish(flat[off:off + n].reshape(tuple(out.shape)))
            except Exception as e:  # noqa: BLE001 — to its callers
                w.faulted = True
                self.governor.record_fault()
                self._fail(group, e)
            off += n

    # -- families ----------------------------------------------------------

    def _dispatch_counts(self, group: list):
        all_nodes, all_leaves, spans = [], [], []
        for p in group:
            start, base = len(all_nodes), len(all_leaves)
            all_nodes.extend(shift_leaves(n, base) for n in p.nodes)
            all_leaves.extend(p.leaves)
            spans.append((start, len(all_nodes)))
        out = self.fused.run_count_batch(tuple(all_nodes),
                                         tuple(all_leaves))

        def finish(host: np.ndarray) -> None:
            host = host.astype(np.int64)
            for p, (a, b) in zip(group, spans):
                self._deliver(p, [int(row.sum()) for row in host[a:b]])
        return out, finish

    def _dispatch_selcounts(self, group: list):
        """One gather of the union of the items' slots (sorted: an
        ascending walk of the plane) over their shared (plane, overlay)
        pair."""
        order = sorted({s for p in group for s in p.nodes})
        pos = {s: i for i, s in enumerate(order)}
        out = self.fused.run_selected_counts(group[0].leaves[0],
                                             tuple(order), group[0].delta)

        def finish(host: np.ndarray) -> None:
            host = host.astype(np.int64)
            for p in group:
                self._deliver(p, host[[pos[s] for s in p.nodes]])
        return out, finish

    def _dispatch_tree(self, group: list):
        """The items' slots and extras unioned (``assemble_items``), one
        gather, one program per item."""
        slots, progs, extras = assemble_items([p.nodes for p in group])
        out = self.fused.run_tree_counts(group[0].leaves[0], slots, progs,
                                         extras, delta=group[0].delta)

        def finish(host: np.ndarray) -> None:
            for k, p in enumerate(group):
                self._deliver(p, int(host[k]))
        return out, finish

    def _dispatch_rowcounts_delta(self, group: list):
        """The group shares its (plane, overlay, filter): one base scan
        and one adjustment answer every item."""
        p0 = group[0]
        flt = p0.leaves[1] if len(p0.leaves) == 2 else None
        out = self.fused.run_rowcounts_delta(p0.leaves[0], p0.delta, flt)

        def finish(host: np.ndarray) -> None:
            for p in group:
                self._deliver(p, host.astype(np.int64))
        return out, finish

    def _dispatch_rowcounts(self, group: list):
        """Items over the same plane and filter dedupe to one scan.  No
        pow2 padding of the item count: it only bounded the reference's
        compiled shapes, and here each pad item would be another scan of
        the whole plane."""
        items, assign = _dedupe(group)
        flags = tuple(len(p.leaves) == 2 for p in items)
        leaves = tuple(a for p in items for a in p.leaves)
        out = self.fused.run_rowcounts_batch(flags, leaves)

        def finish(host: np.ndarray) -> None:
            for p, k in zip(group, assign):
                self._deliver(p, host[k].astype(np.int64))
        return out, finish

    # BSI aggregate kinds: (FusedCache family, host decode of one item)
    _AGG = {"sum": ("run_sum_plane_batch", bsik.decode_sum_packed),
            "minmax": ("run_minmax_plane_batch", bsik.decode_minmax_packed)}

    def _dispatch_aggs(self, kind: str, group: list):
        """The window's Sum (or Min/Max) items over one (plane, overlay)
        pair: items with the same filter dedupe, the rest run in one
        family call."""
        items, assign = _dedupe(group)
        flags = tuple(len(p.leaves) == 2 for p in items)
        filters = tuple(p.leaves[1] for p in items if len(p.leaves) == 2)
        run, decode = self._AGG[kind]
        out = getattr(self.fused, run)(group[0].leaves[0], flags, filters,
                                       delta=group[0].delta)

        def finish(host: np.ndarray) -> None:
            for p, k in zip(group, assign):
                self._deliver(p, decode(host[k]))
        return out, finish

    def _dispatch_bsirange(self, group: list):
        """The window's range Counts over one (plane, overlay) pair:
        identical predicates (same sig) dedupe, the rest run in one
        ``run_range_batch``."""
        uniq: dict[tuple, int] = {}
        items: list[_Pending] = []
        assign: list[int] = []
        for p in group:
            slot = uniq.setdefault(p.nodes[2], len(items))
            if slot == len(items):
                items.append(p)
            assign.append(slot)
        out = self.fused.run_range_batch(
            group[0].leaves[0], tuple(p.nodes[0] for p in items),
            tuple(a for p in items for a in p.nodes[1]),
            delta=group[0].delta)

        def finish(host: np.ndarray) -> None:
            for p, k in zip(group, assign):
                self._deliver(p, int(host[k]))
        return out, finish

    def _dispatch_groupby(self, group: list):
        """One GroupBy block per group (the key's signature dedupes
        identical blocks); its flat output joins the window's packed read
        and every item gets the same unflattened host arrays."""
        args, (agg_kind, meta), _ = group[0].nodes
        out = self.fused.run_groupby_batch(*args[:5], agg_kind,
                                           delta=args[5])

        def finish(host: np.ndarray) -> None:
            parts = gb.unflatten_block(host, *meta, agg_kind)
            for p in group:
                self._deliver(p, parts)
        return out, finish


def _nbytes(a) -> int:
    return int(getattr(a, "nbytes", 0) or 0) if a is not None else 0


def _group_bytes(kind: str, group: list) -> int:
    """Bytes one group's launch reads (``pilosa_tpu.exec.batcher``'s
    estimate): count leaves each enter the batch; selcounts and trees
    gather only the union of the requested rows (a tree also its extras
    once); the deduplicated kinds scan each unique plane[, filter] once
    however many items share it; an overlay adds its own bytes."""
    p0 = group[0]
    if kind == "selcounts":
        plane = p0.leaves[0]
        rows = {s for p in group for s in p.nodes}
        return (len(rows) * plane.shape[0] * plane.shape[-1] * 4
                + _nbytes(p0.delta))
    if kind == "tree":
        plane = p0.leaves[0]
        rows = {s for p in group for s in p.nodes[0]}
        extras = {id(a): a for p in group for a in p.nodes[2]}
        return (len(rows) * plane.shape[0] * plane.shape[-1] * 4
                + sum(_nbytes(a) for a in extras.values())
                + _nbytes(p0.delta))
    if kind == "rowcounts-delta":
        return sum(_nbytes(a) for a in p0.leaves) + _nbytes(p0.delta)
    if kind == "count":
        return sum(_nbytes(a) for p in group for a in p.leaves)
    if kind == "bsirange":
        return (len({p.nodes[2] for p in group}) * _nbytes(p0.leaves[0])
                + _nbytes(p0.delta))
    if kind == "groupby":
        planes, _ci, lp, fw, ap, dl = p0.nodes[0]
        return (sum(_nbytes(p) for p in planes) + _nbytes(lp) + _nbytes(fw)
                + _nbytes(ap) + _nbytes(dl))
    seen: set = set()
    total = 0
    for p in group:
        k = tuple(id(a) for a in p.leaves)
        if k in seen:
            continue
        seen.add(k)
        total += sum(_nbytes(a) for a in p.leaves)
    if kind in ("sum", "minmax"):
        total += _nbytes(p0.delta)
    return total


_MISS = object()  # the fast lane did not admit the call


def _dedupe(group: list):
    """Unique items by leaf identity, and the index of each item's
    representative: N requests over one resident plane compute once."""
    uniq: dict[tuple, int] = {}
    items: list[_Pending] = []
    assign: list[int] = []
    for p in group:
        k = tuple(id(a) for a in p.leaves)
        slot = uniq.get(k)
        if slot is None:
            slot = uniq[k] = len(items)
            items.append(p)
        assign.append(slot)
    return items, assign


def _wrap_readback_error(exc: Exception) -> Exception:
    """A failure escaping a window's finish outside its groups: a stall
    error naming the ``readback`` stage, so every unanswered item fails
    instead of waiting forever."""
    err = PipelineStalledError(f"window readback failed: {exc!r}",
                               stage="readback")
    err.__cause__ = exc
    return err
