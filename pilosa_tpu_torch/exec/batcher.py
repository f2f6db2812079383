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
  host arrays.

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

There is no fallback.  A group whose launch or readback raises delivers
that exception to every item of the group, a failing fast-lane call
raises to its caller, and the collector serves the next window.
"""

from __future__ import annotations

import queue
import threading
import time

import numpy as np
import torch

from pilosa_tpu_torch.engine import bsi as bsik
from pilosa_tpu_torch.exec import groupby as gb
from pilosa_tpu_torch.exec.fused import shift_leaves
from pilosa_tpu_torch.exec.tree import assemble_items


class _Pending:
    __slots__ = ("kind", "nodes", "leaves", "delta", "event", "result",
                 "error")

    def __init__(self, kind, nodes, leaves, delta=None):
        self.kind = kind      # "count" | "rowcounts" | "selcounts" | "tree"
        #                       | "sum" | "minmax" | "bsirange" | "groupby"
        self.nodes = nodes    # count: plan trees; selcounts: plane row
        #                       slots; tree: (slots, prog, extras);
        #                       bsirange: (spec, operands, sig); groupby:
        #                       (args, (agg, meta), sig);
        #                       rowcounts, sum, minmax: None
        self.leaves = leaves  # count: plan leaves; others: plane[, filter]
        self.delta = delta    # the plane's DeltaOverlay (base+delta)
        self.event = threading.Event()
        self.result = None
        self.error: Exception | None = None


class _Window:
    """One dispatched window: ``(group, device out, finish)`` per group,
    the packed output, its host copy and the event that copy records.
    Holding the device tensors until the reader is done keeps their
    memory from being reused under the copy."""

    __slots__ = ("pending", "packed", "host", "event")

    def __init__(self, pending: list):
        self.pending = pending
        self.packed = self.host = self.event = None


class CountBatcher:
    """Coalesces concurrent requests' Count, row-count, selected-count
    and tree items into one family call per (kind, plane) group and one
    packed read per window."""

    # adaptive-window bounds: below MIN the window snaps to 0 (solo
    # traffic does not wait); MAX bounds what a burst adds to its tail
    ADAPT_MIN = 0.0005
    ADAPT_MAX = 0.005

    # most items one window takes; at most PIPELINE_DEPTH windows are
    # dispatched but not yet read (a slot is taken before a window
    # launches and given back when the reader is done with it)
    MAX_BATCH = 64
    PIPELINE_DEPTH = 2

    def __init__(self, fused, window_s="adaptive"):
        self.fused = fused
        self.adaptive = window_s == "adaptive"
        self.window_s = 0.0 if self.adaptive else float(window_s)
        self._win = self.window_s
        self._queue: list[_Pending] = []
        self._lock = threading.Lock()
        self._kick = threading.Event()
        self._thread: threading.Thread | None = None
        self._closed = False
        self._readq: queue.Queue = queue.Queue()
        self._pipe_slots = threading.Semaphore(self.PIPELINE_DEPTH)
        self._read_thread: threading.Thread | None = None
        # solo fast lane: admitted only while no other fast-lane call is
        # in flight, so overlapping callers fall into the window (the
        # adaptive window's pressure signal)
        self._fl_active = 0
        self._fl_lock = threading.Lock()
        # counters: windows/items/max by the collector alone, the rest
        # under _fl_lock
        self.windows = 0
        self.items = 0
        self.max_window_items = 0
        self.fastlane_hits = 0
        self._inflight = 0
        # per kind: [family calls (groups), items, largest group]
        self.kinds: dict[str, list[int]] = {}

    def health_payload(self) -> dict:
        """The ``/status`` batcher block."""
        with self._fl_lock:
            hits, inflight = self.fastlane_hits, self._inflight
        return {"window": "adaptive" if self.adaptive else self.window_s,
                "currentWindowSeconds": self._win,
                "windows": self.windows, "items": self.items,
                "maxWindowItems": self.max_window_items,
                "fastLaneHits": hits, "inflightWindows": inflight,
                "kinds": {k: {"groups": g, "items": n, "maxItems": m}
                          for k, (g, n, m) in list(self.kinds.items())}}

    def close(self, timeout: float = 30.0) -> None:
        """Stop the collector and the reader; queued items fail."""
        with self._lock:
            self._closed = True
            batch = self._queue[:]
            self._queue.clear()
        self._kick.set()
        if self._thread is not None:
            self._thread.join(timeout)
        if self._read_thread is not None:
            self._readq.put(None)
            self._read_thread.join(timeout)
        err = RuntimeError("batcher closed")
        for p in batch:
            self._deliver_error(p, err)

    # -- delivery --------------------------------------------------------

    @staticmethod
    def _deliver(p: _Pending, value) -> None:
        if not p.event.is_set():
            p.result = value
            p.event.set()

    @staticmethod
    def _deliver_error(p: _Pending, err: Exception) -> None:
        if not p.event.is_set():
            p.error = err
            p.event.set()

    def _fail(self, group: list, err: Exception) -> None:
        for p in group:
            self._deliver_error(p, err)

    def wait(self, p: _Pending):
        """Block on an enqueued item (pairs with the ``enqueue_*``
        methods: a request enqueues all its items into one window before
        waiting on any)."""
        p.event.wait()
        if p.error is not None:
            raise p.error
        return p.result

    def _enqueue(self, p: _Pending) -> _Pending:
        with self._lock:
            if self._closed:
                raise RuntimeError("batcher closed")
            self._queue.append(p)
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(
                    target=self._run_collector, name="pilosa-torch-batcher",
                    daemon=True)
                self._thread.start()
        self._kick.set()
        return p

    # -- solo fast lane ----------------------------------------------------

    def _fl_try_enter(self) -> bool:
        """Admit ONE fast-lane call: adaptive window at 0 (solo
        traffic), nothing queued, no other fast-lane call in flight
        (checked and taken under one lock)."""
        if not (self.adaptive and self._win == 0.0 and not self._queue):
            return False
        with self._fl_lock:
            if self._fl_active:
                return False
            self._fl_active += 1
        return True

    def _fastlane(self, fn, *args):
        """``fn(*args)`` on the caller's thread when the lane admits it;
        :data:`_MISS` otherwise.  Exceptions reach the caller."""
        if not self._fl_try_enter():
            return _MISS
        try:
            out = fn(*args)
        finally:
            with self._fl_lock:
                self._fl_active -= 1
        with self._fl_lock:
            self.fastlane_hits += 1
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

    def submit(self, node, leaves) -> int:
        """One Count tree over its planned leaves -> int64 total."""
        return self.submit_many((node,), leaves)[0]

    def submit_many(self, nodes, leaves) -> list[int]:
        """A whole request's Count run as ONE item (the nodes share one
        leaf list)."""
        nodes, leaves = tuple(nodes), tuple(leaves)
        out = self._fastlane(self._fastlane_counts, nodes, leaves)
        if out is not _MISS:
            return out
        return self.wait(self._enqueue(_Pending("count", nodes, leaves)))

    def submit_rowcounts(self, plane, filter_words=None,
                         delta=None) -> np.ndarray:
        """Whole-plane per-row totals int64[R_pad] (the shard axis
        reduced on the device: callers gate on the int32-exact shard
        bound), base+delta when ``delta`` is set."""
        out = self._fastlane(self._fastlane_rowcounts, plane, filter_words,
                             delta)
        if out is not _MISS:
            return out
        return self.wait(self.enqueue_rowcounts(plane, filter_words, delta))

    def enqueue_rowcounts(self, plane, filter_words=None,
                          delta=None) -> _Pending:
        leaves = (plane,) if filter_words is None else (plane, filter_words)
        return self._enqueue(_Pending("rowcounts", None, leaves, delta))

    def submit_selected(self, plane, slots: tuple,
                        delta=None) -> np.ndarray:
        """Selected-row totals int64[len(slots)] in the caller's slot
        order; the window's items over one (plane, overlay) pair gather
        the union of their slots once."""
        out = self._fastlane(self._fastlane_selected, plane, tuple(slots),
                             delta)
        if out is not _MISS:
            return out
        return self.wait(self._enqueue(
            _Pending("selcounts", tuple(slots), (plane,), delta)))

    def submit_tree(self, plane, slots: tuple, prog: tuple,
                    extras: tuple = (), delta=None) -> int:
        """One compound-tree Count (``exec.tree`` operands) -> total."""
        out = self._fastlane(self._fastlane_tree, plane, slots, prog,
                             extras, delta)
        if out is not _MISS:
            return out
        return self.wait(self.enqueue_tree(plane, slots, prog, extras,
                                           delta))

    def enqueue_tree(self, plane, slots: tuple, prog: tuple,
                     extras: tuple = (), delta=None) -> _Pending:
        return self._enqueue(_Pending(
            "tree", (tuple(slots), tuple(prog), tuple(extras)), (plane,),
            delta))

    def submit_sum(self, plane, filter_words=None, delta=None):
        """BSI Sum -> (sum of offsets, non-null count), host-finished.
        ``delta`` (a ``BsiOverlay``) merges the plane's pending write
        columns: base+delta."""
        return self._submit_agg("sum", plane, filter_words, delta)

    def submit_minmax(self, plane, filter_words=None, delta=None) -> list:
        """BSI Min/Max -> (min, min_cnt, max, max_cnt) per shard, plus one
        per overlay column (zero-count entries: the caller drops them)."""
        return self._submit_agg("minmax", plane, filter_words, delta)

    def _submit_agg(self, kind: str, plane, filter_words, delta):
        out = self._fastlane(self._fastlane_agg, kind, plane, filter_words,
                             delta)
        if out is not _MISS:
            return out
        leaves = (plane,) if filter_words is None else (plane, filter_words)
        return self.wait(self._enqueue(_Pending(kind, None, leaves, delta)))

    def submit_bsirange(self, plane, spec: tuple, operands: tuple,
                        sig: tuple, delta=None) -> int:
        """One BSI range Count (``spec`` = (op_keys, has_filter), see
        ``FusedCache.run_range_batch``); identical predicates (same
        ``sig``) in a window dedupe to one comparison chain."""
        out = self._fastlane(self._fastlane_bsirange, plane, spec, operands,
                             delta)
        if out is not _MISS:
            return out
        return self.wait(self.enqueue_bsirange(plane, spec, operands, sig,
                                               delta))

    def enqueue_bsirange(self, plane, spec: tuple, operands: tuple,
                         sig: tuple, delta=None) -> _Pending:
        return self._enqueue(_Pending(
            "bsirange", (spec, tuple(operands), sig), (plane,), delta))

    def submit_groupby(self, planes: tuple, combo_idx, last_plane,
                       filter_words, agg_plane, agg_kind, meta: tuple,
                       digest: bytes, delta=None) -> dict:
        """One GroupBy combination block (``exec.groupby.groupby_out``'s
        arguments; ``combo_idx`` a host array) -> its parts as host arrays.
        ``meta`` = (combinations, innermost rows, depth) for the unflatten;
        ``digest`` hashes the combination slots, so identical concurrent
        blocks (same planes, filter, overlay, aggregate and combinations)
        dedupe to one call.  ``delta``: the bit plane's ``BsiOverlay``."""
        args = (tuple(planes), combo_idx, last_plane, filter_words,
                agg_plane, delta)
        out = self._fastlane(self._fastlane_groupby, args, agg_kind, meta)
        if out is not _MISS:
            return out
        sig = (tuple(id(p) for p in planes), id(last_plane),
               id(filter_words) if filter_words is not None else 0,
               id(agg_plane) if agg_plane is not None else 0,
               id(delta) if delta is not None else 0, agg_kind, digest)
        return self.wait(self._enqueue(_Pending(
            "groupby", (args, (agg_kind, meta), sig), (last_plane,))))

    # -- collector ---------------------------------------------------------

    def _run_collector(self) -> None:
        while not self._closed:
            try:
                self._collect_once()
            except Exception as e:  # noqa: BLE001 — the worker must survive
                self._fail_backlog(e)

    def _fail_backlog(self, exc: Exception) -> None:
        """A collector cycle failed outside any group: every queued item
        gets the exception instead of waiting forever."""
        with self._lock:
            batch = self._queue[:]
            self._queue.clear()
            self._kick.clear()
        for p in batch:
            self._deliver_error(p, exc)

    def _collect_once(self) -> None:
        self._kick.wait()
        if self._closed:
            return
        if self._win > 0:
            time.sleep(self._win)
        with self._lock:
            backlog = len(self._queue)
            batch = self._queue[: self.MAX_BATCH]
            del self._queue[: len(batch)]
            if not self._queue:
                self._kick.clear()
        if not batch:
            return
        try:
            self._process_batch(batch, backlog)
        except Exception as e:  # noqa: BLE001 — answer, never strand
            self._fail(batch, e)

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
        groups: dict[tuple, list[_Pending]] = {}
        for p in batch:
            groups.setdefault(self._group_key(p), []).append(p)
        for key, group in groups.items():
            st = self.kinds.setdefault(key[0], [0, 0, 0])
            st[0] += 1
            st[1] += len(group)
            st[2] = max(st[2], len(group))
        self._dispatch_window(groups)

    @staticmethod
    def _group_key(p: _Pending) -> tuple:
        """Kind plus what makes outputs shareable: counts stack by shard
        count; selcounts and trees share a gather, and BSI items a family
        call, per (plane, overlay) identity; rowcounts stack by plane
        shape (and dedupe by leaf identity), or share one base+delta scan
        per (plane, overlay, filter) identity."""
        delta = id(p.delta) if p.delta is not None else 0
        if p.kind == "groupby":
            return ("groupby",) + p.nodes[2]
        if p.kind == "count":
            return ("count", p.leaves[0].shape[0])
        if p.kind in ("selcounts", "tree", "sum", "minmax", "bsirange"):
            return (p.kind, id(p.leaves[0]), delta)
        if p.delta is not None:
            return ("rowcounts-delta", id(p.leaves[0]), delta,
                    id(p.leaves[1]) if len(p.leaves) == 2 else 0)
        return ("rowcounts", tuple(p.leaves[0].shape))

    def _dispatch_window(self, groups: dict) -> None:
        self._pipe_slots.acquire()
        handed = False
        try:
            pending = []
            for key, group in groups.items():
                try:
                    out, finish = self._dispatch_one(key[0], group)
                except Exception as e:  # noqa: BLE001 — to its callers
                    self._fail(group, e)
                    continue
                pending.append((group, out, finish))
            if not pending:
                return
            w = _Window(pending)
            try:
                self._start_read(w)
            except Exception as e:  # noqa: BLE001 — to its callers
                for group, _, _ in pending:
                    self._fail(group, e)
                return
            with self._fl_lock:
                self._inflight += 1
            if self._read_thread is None or not self._read_thread.is_alive():
                self._read_thread = threading.Thread(
                    target=self._read_loop, name="pilosa-torch-readback",
                    daemon=True)
                self._read_thread.start()
            self._readq.put(w)
            handed = True  # the reader gives the slot back
        finally:
            if not handed:
                self._pipe_slots.release()

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

    # -- readback ----------------------------------------------------------

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
            w = self._readq.get()
            if w is None:
                return
            try:
                self._finish_window(w)
            except Exception as e:  # noqa: BLE001 — answer, never strand
                for group, _, _ in w.pending:
                    self._fail(group, e)
            finally:
                with self._fl_lock:
                    self._inflight -= 1
                self._pipe_slots.release()
                # the last window must not keep its planes alive while
                # the reader waits for the next one
                w = None

    def _finish_window(self, w: _Window) -> None:
        """Wait for the window's copy, then slice each group's answers
        out of the one host array."""
        try:
            if w.event is not None:
                w.event.synchronize()
            flat = w.host.numpy()
        except Exception as e:  # noqa: BLE001 — to every item
            for group, _, _ in w.pending:
                self._fail(group, e)
            return
        off = 0
        for group, out, finish in w.pending:
            n = out.numel()
            try:
                finish(flat[off:off + n].reshape(tuple(out.shape)))
            except Exception as e:  # noqa: BLE001 — to its callers
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
