"""Executor: PQL AST -> hand-written kernels over resident planes.

The counterpart of ``pilosa_tpu.exec.executor.Executor``, in its default
serving configuration:

- ``count_batch_window="adaptive"``: concurrent requests coalesce in the
  :class:`~pilosa_tpu_torch.exec.batcher.CountBatcher` (one family call
  per kind and plane, one packed read per window; a solo request takes
  the fast lane).  A number of seconds fixes the window; ``"off"`` (or 0)
  runs each request alone;
- ``tree_fusion=True``: compound calls compile whole
  (:mod:`pilosa_tpu_torch.exec.tree`): one gather of their rows from the
  resident plane, one postfix fold;
- ``max_concurrent=8`` admission slots;
- a plan cache: a repeated all-Count query string skips parse and plan
  (same-field row Counts over the resident plane, simple BSI range
  Counts, compiled trees, and any other Count tree as a "generic" entry
  of leaf specs);
- ``plane_paging=True``: plain-row Counts over a plane past the budget
  (or the tenant's byte quota) are served in shard pages
  (:mod:`pilosa_tpu_torch.tenancy.paging`), resident pages on the card,
  the others from the host's row cardinalities;
- ``plane_sidecars=True``: plane builds read fragments' fresh ``.dense``
  images warm and write one after a cold expansion
  (:class:`~pilosa_tpu_torch.exec.planes.PlaneCache`);
- tenant quotas, all off by default: ``tenant_byte_quota`` (resident
  bytes per index), ``tenant_qps_quota`` and ``tenant_slot_quota`` (a
  query over quota is shed with :class:`~pilosa_tpu_torch.tenancy.
  TenantThrottledError` before it takes a slot).

``placement=`` (:mod:`pilosa_tpu_torch.parallel.mesh`) serves over several
devices: shard lists pad to the placement's width with all-zero
``PAD_SHARD`` shards, every plane is blocked over its devices, every hand
kernel launches per block and per-shard outputs gather onto the first
device; plane paging is off there.  Every call answers under a 1-D or a
2-D placement as it does unmeshed: ``Limit`` ranks from each block's
global base, ``Shift`` carries bits across word blocks, the Min/Max
descent sums each step over a shard's word blocks, ``Extract`` reads
only the blocks holding selected columns, and time planes are blocked
with their overlays.  A torch operation no path routes over a blocked
tensor raises :class:`~pilosa_tpu_torch.exec.errors.MeshNotSupported`.

``Executor(holder, count_batch_window="off", tree_fusion=False)`` serves
as the port's first slices did.  Every resident shard is one slice of a
batched device tensor, a run of consecutive Counts executes as one batch
with one host read, and cross-shard totals are a dense sum.  Writes since
a plane was built ride a device delta overlay (``delta_cells``, folded
in the background past ``delta_compact_fraction``): Counts and TopN
answer base+delta over the unchanged resident plane.

Served calls: ``Count``, ``Row`` / ``Range`` (set, time, mutex and bool
fields with integer rows; time ranges ``Row(t=1, from=, to=)`` and the legacy
positional ``Range(t=1, <from>, <to>)``; BSI conditions such as
``Row(amount > 5)`` and ``Row(-1 < amount < 1)``), ``Intersect``,
``Union``, ``Difference``, ``Xor``, ``Not``, ``All`` (with ``limit=`` /
``offset=`` paging), ``Shift``, ``Limit``, ``ConstRow``, ``UnionRows``,
``TopN(field[, filter], n=)`` (with ``tanimoto=`` and ``_rowCounts=``:
on the resident dense plane, which past ``SYNC_BUILD_MAX`` builds in the
background; from the host's row cardinalities when unfiltered; from a
sparse CSR residency of the field's bits when the dense plane exceeds the
budget and the sparse one fits; else by streaming row blocks through the
card), the BSI aggregates
``Sum``, ``Min``, ``Max``, ``Percentile`` and ``Distinct``, ``Rows`` and
``GroupBy`` (over rows planes of the selected rows, with ``filter=``, a
Count/Sum/Min/Max aggregate, ``having=``, ``limit=`` and ``previous=``;
``Rows(from=, to=)`` selects the rows seen in the range; blocks go
through the batcher's ``groupby`` kind), ``Extract`` (each selected
column's value in each field, gathered from the resident planes),
``IncludesColumn``, ``Options`` (``shards=`` and ``excludeColumns=``),
``Set`` (with a timestamp on a time field), ``Clear`` (values on BSI
fields), ``Store``, ``ClearRow``, ``SetRowAttrs`` and ``SetColumnAttrs``.
A time range is one
OR over the field's bucketed time plane (:mod:`pilosa_tpu_torch.timeviews`),
or, when the plane would exceed the budget, the union of the range's
cover views' rows.  Sum, Min, Max, simple range Counts and GroupBy
aggregates read the bit plane delta-aware (base+delta over a
``BsiOverlay``); Percentile, Distinct and BSI leaves inside bitmap calls
read it clean.

Keys: the executor owns a :class:`~pilosa_tpu_torch.store.translate.
TranslateStore`.  A string row on a keyed field and a string column on a
keyed index translate to ids (a read never creates a key: an unknown key
is an empty row; ``Set``, ``Store`` and the attribute writes create
them), and every answer of a keyed field or index carries keys where the
reference's does: bitmap columns, TopN pairs, ``Rows`` (with ``like=``),
GroupBy ``rowKey``s and Extract.  A plain ``Row`` result carries the
row's attributes (``excludeRowAttrs=true`` drops them), TopN filters by
``attrName=`` / ``attrValue=`` and ``Options(columnAttrs=true)`` attaches
column attributes.  Anything else raises :class:`ExecutionError`.
"""

from __future__ import annotations

import fnmatch
import gc
import hashlib
import re
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass

import numpy as np
import torch

from pilosa_tpu_torch import fault
from pilosa_tpu_torch.engine import bsi as bsik
from pilosa_tpu_torch.engine import kernels, resolve_device
from pilosa_tpu_torch.engine import sparse as sparsek
from pilosa_tpu_torch.engine.words import (SHARD_WIDTH, WORDS_PER_SHARD,
                                           unpack_columns)
from pilosa_tpu_torch.exec import groupby as gb
from pilosa_tpu_torch.exec.batcher import CountBatcher
from pilosa_tpu_torch.exec.errors import (ExecutionError, QueryTimeoutError,
                                          WriteUnavailableError)
from pilosa_tpu_torch.exec.fused import FusedCache, Unfusable
from pilosa_tpu_torch.exec.planes import (DEFAULT_BUDGET, PlaneCache,
                                          merge_row_cards)
from pilosa_tpu_torch.exec.result import (DistinctResult, ExtractResult,
                                          GroupCountsResult, Pair,
                                          PairsResult, RowIdsResult,
                                          RowResult, ValCount)
from pilosa_tpu_torch.exec.tree import (TREE_CALLS, assemble_items,
                                        fold_bool_call, is_not_bool,
                                        lower_count_tree)
from pilosa_tpu_torch.obs import (GLOBAL_TRACER, NULL_FLIGHT, NULL_LEDGER,
                                  CostLedger, FlightRecorder, NopStats,
                                  StageTimer)
from pilosa_tpu_torch.obs.ledger import (clear_query_context,
                                         set_query_context)
from pilosa_tpu_torch.obs.metrics import DEPTH_BUCKETS
from pilosa_tpu_torch.obs.tracing import current_trace_id
from pilosa_tpu_torch.parallel.mesh import (PAD_SHARD, PerBlock, blocks_of,
                                            gathered, whole)
from pilosa_tpu_torch.pql import parse_cached
from pilosa_tpu_torch.pql.ast import (BETWEEN_OPS, SCALAR_CMP_KEYS, Call,
                                      Condition, Query, between_cmp_ops)
from pilosa_tpu_torch.store.field import (BSI_TYPES, ROW_TYPES, TYPE_BOOL,
                                          TYPE_DECIMAL, TYPE_MUTEX, Field)
from pilosa_tpu_torch.store.holder import Holder
from pilosa_tpu_torch.store.index import Index
from pilosa_tpu_torch.store.timeq import (parse_pql_time, view_span,
                                          views_by_time_range)
from pilosa_tpu_torch.store.translate import TranslateStore
from pilosa_tpu_torch.store.view import VIEW_STANDARD
from pilosa_tpu_torch.tenancy import (PlanePager, ResidencyGovernor,
                                      TenantQos)

# option keys that are never field names in call args (reservation is per
# call: a field named "n" still works in Set(5, n=777))
RESERVED_KEYS = frozenset({
    "from", "to", "limit", "offset", "n", "field", "ids", "filter", "column",
    "like", "previous", "aggregate", "sort", "shards", "index",
    "attrName", "attrValue", "columnAttrs", "excludeColumns", "tanimoto",
    "excludeRowAttrs",
})

_CALL_RESERVED = {
    "Row": frozenset({"from", "to", "excludeRowAttrs"}),
    "Range": frozenset({"from", "to"}),
    "Set": frozenset(),
    "Clear": frozenset(),
    "ClearRow": frozenset(),
    "Store": frozenset(),
}

def reserved_for(call_name: str) -> frozenset:
    """The option keys of ``call_name`` that are never field names."""
    return _CALL_RESERVED.get(call_name, RESERVED_KEYS)


_BITMAP_CALLS = frozenset({"Row", "Range", "Intersect", "Union",
                           "Difference", "Xor", "Not", "All", "Shift",
                           "UnionRows", "ConstRow", "Limit"})


def _is_device_oom(e: Exception) -> bool:
    """Device-memory exhaustion, by type: ``torch.OutOfMemoryError``
    (``torch.cuda.OutOfMemoryError``), raised where an allocation on the
    card fails.  Never a string match: an error that merely quotes "out of
    memory" (a PQL key, a field name) must not drop the cache."""
    return isinstance(e, torch.OutOfMemoryError)


def _lex_gt(mat: np.ndarray, prev: tuple) -> np.ndarray:
    """Rows of ``mat`` lexicographically greater than ``prev`` (GroupBy
    ``previous=`` paging)."""
    gt = np.zeros(len(mat), bool)
    eq = np.ones(len(mat), bool)
    for lvl, p in enumerate(prev):
        col = mat[:, lvl]
        gt |= eq & (col > p)
        eq &= col == p
    return gt


class ExecutorSaturatedError(ExecutionError):
    """Every admission slot stayed taken for ``SLOT_TIMEOUT_S``."""

    retry_after = 1.0


def bsi_offset(field: Field, op_key: str, value):
    """``(offset, verdict)`` of one comparison against a BSI field: the
    base-relative stored offset, and None when it fits the bit depth, else
    the trivial answer: True for every non-null column, False for none
    (a predicate past the depth needs no kernel)."""
    opts = field.options
    offset = int(field.to_stored(value) - opts.base)
    bound = (1 << opts.bit_depth) - 1
    if offset > bound:
        return offset, op_key in ("lt", "le", "ne")
    if offset < -bound:
        return offset, op_key in ("gt", "ge", "ne")
    return offset, None


def bsi_cmp_pairs(cond: Condition) -> list:
    """A BSI condition as the ``(op_key, value)`` comparisons it ANDs: one,
    or a between's two."""
    if cond.op in BETWEEN_OPS:
        lo_op, hi_op = between_cmp_ops(cond.op)
        return [(lo_op, cond.value[0]), (hi_op, cond.value[1])]
    return [(SCALAR_CMP_KEYS[cond.op], cond.value)]


def bsi_signature(options) -> tuple:
    """Everything a baked BSI predicate depends on: a cached plan resolved
    its offsets and saturation against these options."""
    return (options.type, options.bit_depth, options.base, options.scale,
            options.epoch, options.time_unit)


def _has_time_args(call: Call) -> bool:
    return ("from" in call.args or "to" in call.args
            or "_timestamp" in call.args)


def _field_arg(call: Call):
    try:
        return call.field_arg(_CALL_RESERVED.get(call.name, RESERVED_KEYS))
    except ValueError as e:
        raise ExecutionError(str(e))


class _Ctx:
    def __init__(self, index: Index, shards: tuple[int, ...],
                 deadline: float | None = None):
        self.index = index
        self.shards = shards
        self.deadline = deadline  # time.monotonic() cutoff

    def check_deadline(self) -> None:
        if self.deadline is not None and time.monotonic() > self.deadline:
            raise QueryTimeoutError("query timeout exceeded")


def _parse_time(t: str):
    try:
        return parse_pql_time(t)
    except ValueError as e:
        raise ExecutionError(str(e))


def parse_window(window) -> float | str:
    """``count_batch_window``: "adaptive", seconds, or off (0, "off",
    "none", "false", "") -> "adaptive" or float seconds."""
    if isinstance(window, str):
        w = window.strip().lower()
        if w == "adaptive":
            return "adaptive"
        if w in ("", "0", "off", "none", "false"):
            return 0.0
        try:
            return float(w)
        except ValueError:
            raise ValueError(
                f"count_batch_window: expected 'adaptive', a number of "
                f"seconds, or 'off', got {window!r}")
    return float(window)


# negative plan-cache entry: this query string is outside the plan cache
_UNPLANNABLE = object()
_EXISTS_DEP = "\x00exists"


@dataclass
class _PlanEntry:
    """One cached serving plan for an all-Count query over unkeyed set
    fields.  ``kind`` "plane": a same-field plain-row Count batch, served
    over the resident plane (``row_ids`` are the literal row ids; slots
    come fresh from the PlaneSet on every hit).  ``kind`` "tree":
    compound Counts compiled whole (``tree_specs``).  ``kind``
    "bsirange": simple BSI range Counts (``range_items``: the field, op
    keys, offsets and host predicate operands).  ``kind`` "generic":
    any other Count tree the planner serves (``nodes`` over
    ``leaf_specs``: rows, the existence row, empty bitmaps and BSI
    conditions, each fetched through the plane cache on every hit),
    always ``checked``.  Nothing here is a
    tensor and nothing bakes data a write can stale: literal row ids
    re-resolve, the planes absorb writes into their overlays and extras
    re-fetch, so a hit checks only the shard set, that the
    ``set_fields`` are still row fields keyed as ``keyed_fields`` says,
    and that each BSI field still has the depth and base its predicates
    were resolved against (``bsi_sigs``).  A ``checked`` entry (a time
    range, whose cover may gain views a write creates, a volatile
    UnionRows row set, or a keyed row, whose key may be created later)
    also requires ``deps``' generations unchanged, else it is dropped and
    planned again.  ``deps``/``gens`` are the build-time snapshot the
    build-twice check compares."""

    kind: str
    shards: tuple
    deps: tuple            # ((field_name | _EXISTS_DEP, view_name), ...)
    gens: tuple            # per-dep generation tuples (None = no view)
    field_name: str | None = None
    row_ids: tuple = ()
    tree_specs: tuple = ()
    set_fields: tuple = ()
    keyed_fields: tuple = ()  # the set fields that were keyed
    range_items: tuple = ()  # ((field, op_keys, offsets, operands), ...)
    nodes: tuple = ()        # "generic": per-call node trees over
    leaf_specs: tuple = ()   # these leaf specs, re-materialized per hit
    bsi_sigs: tuple = ()     # ((field, bsi_signature), ...) pinned
    checked: bool = False    # a hit compares ``deps``' generations
    n_calls: int = 0         # the query's Count calls (span tag)


class _Walk:
    """What :meth:`Executor._plan` records while it walks a bitmap call:
    the hashable leaf specs in walk order, the ``(field, view)`` each
    depends on, the BSI signatures its predicates were resolved against,
    and whether every leaf may be plan-cached.  The specs become tensors
    in :meth:`Executor._leaves_from_specs`, on a planned request and on
    every plan-cache hit alike."""

    __slots__ = ("specs", "deps", "sigs", "cacheable")

    def __init__(self) -> None:
        self.specs: list = []
        self.deps: dict = {}
        self.sigs: dict = {}
        self.cacheable = True

    def leaf(self, spec: tuple, *deps) -> tuple:
        for dep in deps:
            self.deps[dep] = None
        self.specs.append(spec)
        return ("leaf", len(self.specs) - 1)

    def volatile(self, spec: tuple) -> tuple:
        """A leaf that reads data at materialization (a time range, whose
        cover may gain views, UnionRows' row set, a literal ConstRow,
        Limit's ranking): never plan-cached."""
        self.cacheable = False
        return self.leaf(spec)


class Executor:
    MAX_PLANS = 512  # plan-cache entries (user-controlled keys: bounded)
    SLOT_TIMEOUT_S = 180.0  # admission wait before refusing a query
    # cross-shard sums stay int32 on the device while
    # n_shards * 2^20 < 2^31
    _REDUCE_SHARD_MAX = (1 << 31) // SHARD_WIDTH - 1
    # selected-row gather when the request touches at most 1/4 of the
    # (padded) row axis; whole-plane row_counts otherwise
    _SELECTED_ROWS_FRACTION = 4

    def __init__(self, holder: Holder, device=None,
                 plane_budget: int = DEFAULT_BUDGET,
                 delta_cells: int = 65536,
                 delta_compact_fraction: float = 0.5,
                 count_batch_window: float | str = "adaptive",
                 tree_fusion: bool = True,
                 max_concurrent: int = 8,
                 translate: TranslateStore | None = None,
                 plane_paging: bool = True,
                 plane_page_bytes: int = 64 << 20,
                 tenant_byte_quota: int = 0,
                 tenant_qps_quota: float = 0.0,
                 tenant_slot_quota: int = 0,
                 tenant_device_seconds_quota: float = 0.0,
                 dispatch_pipeline_depth: int = 2,
                 solo_fastlane: bool = True,
                 dispatch_watchdog_seconds: float = 30.0,
                 device_health_probe_seconds: float = 5.0,
                 plane_sidecars: bool = True,
                 stats=None, tracer=None, cost_observability: bool = True,
                 placement=None):
        self.holder = holder
        # a mesh placement: planes blocked over its devices, shard lists
        # padded to its width (None: one device)
        self.placement = placement
        # the metrics registry (``NopStats``: none), the shared tracer a
        # query without its own runs under, and the device-cost ledger and
        # flight recorder (null objects with ``cost_observability`` off),
        # threaded into every layer that spends device time
        self.stats = stats or NopStats()
        self.tracer = tracer or GLOBAL_TRACER
        if cost_observability:
            self.ledger = CostLedger(stats=self.stats)
            self.flight = FlightRecorder(
                dump_dir=f"{holder.path}/_flight", stats=self.stats)
        else:
            self.ledger = NULL_LEDGER
            self.flight = NULL_FLIGHT
        # the key stores: this executor's own unless the caller shares its
        self._owns_translate = translate is None
        self.translate = translate or TranslateStore(holder.path)
        self.device = (placement.first if placement is not None
                       else resolve_device(device))
        # with no quota and no telemetry the governor's eviction order is
        # the cache's LRU order
        self.governor = ResidencyGovernor(byte_quota=tenant_byte_quota)
        self.planes = PlaneCache(
            self.device, budget_bytes=plane_budget, delta_cells=delta_cells,
            delta_compact_fraction=delta_compact_fraction,
            governor=self.governor, sidecars=plane_sidecars,
            stats=self.stats, flight=self.flight, placement=placement)
        # a page of a blocked plane has no meaning: no paging under a
        # placement
        self.pager = (PlanePager(self.planes, self.governor,
                                 page_bytes=plane_page_bytes,
                                 stats=self.stats, flight=self.flight)
                      if plane_paging and placement is None else None)
        self.qos = TenantQos(tenant_qps_quota, tenant_slot_quota,
                             stats=self.stats,
                             device_seconds_quota=tenant_device_seconds_quota,
                             ledger=self.ledger)
        self.fused = FusedCache()
        self.tree_fusion = bool(tree_fusion)
        self.stats.set_buckets("tree_fusion_depth", DEPTH_BUCKETS)
        window = parse_window(count_batch_window)
        self.batcher = (CountBatcher(
            self.fused, window_s=window,
            pipeline_depth=dispatch_pipeline_depth,
            solo_fastlane=solo_fastlane,
            watchdog_s=dispatch_watchdog_seconds,
            probe_after_s=device_health_probe_seconds,
            tier=self._kernel_tier(), stats=self.stats, ledger=self.ledger,
            flight=self.flight,
            placement_key=placement.key if placement is not None else None)
            if window == "adaptive" or window > 0 else None)
        # the devices the plane axis spans (1: single-device serving)
        self.stats.gauge("mesh_devices",
                         placement.n_devices * placement.words_size
                         if placement is not None else 1)
        # query-plan cache: (index, stripped PQL, shards) -> _PlanEntry
        self._plans: OrderedDict = OrderedDict()
        self._plans_lock = threading.Lock()
        self.plan_hits = 0
        self.plan_misses = 0
        # bounded concurrency: each executing query holds device scratch
        self.max_concurrent = max_concurrent
        self._exec_slots = (threading.BoundedSemaphore(max_concurrent)
                            if max_concurrent else None)
        # device-OOM recovery: one recovery at a time through the gate;
        # the in-flight count lets its exclusive stage drain the other
        # queries, and new arrivals park on _recovery_open meanwhile
        self._oom_gate = threading.Lock()
        self._inflight = 0
        self._inflight_cv = threading.Condition()
        self._recovery_open = threading.Event()
        self._recovery_open.set()
        self._tls = threading.local()
        self.device_oom_retries = 0
        self.device_oom_exclusive_retries = 0
        self.last_device_oom: dict | None = None
        # time ranges served off the time plane / by the cover views'
        # rows, and TopNs by each representation
        self._served_lock = threading.Lock()
        self.time_ranges_plane = 0
        self.time_ranges_span = 0
        self.topn_served = dict.fromkeys(
            ("dense", "host", "sparse", "streamed"), 0)

    def close(self) -> None:
        """Stop the batcher's threads and close the key stores this
        executor opened (a shared ``translate`` stays open)."""
        if self.batcher is not None:
            self.batcher.close()
        if self._owns_translate:
            self.translate.close()

    def serving_stats(self) -> dict:
        """The ``/status`` batcher block: the batcher's windows, items,
        fast-lane hits, current window and Distinct windows and scans, the
        plan cache's hits and misses, and the device-OOM recoveries (the
        last one's error and device memory at the moment it struck)."""
        out = (self.batcher.stats_payload() if self.batcher is not None
               else {"window": "off"})
        with self._plans_lock:
            out.update(planCacheHits=self.plan_hits,
                       planCacheMisses=self.plan_misses,
                       plans=len(self._plans))
        with self._served_lock:
            out["topnServed"] = dict(self.topn_served)
            out.update(deviceOomRetries=self.device_oom_retries,
                       deviceOomExclusiveRetries=(
                           self.device_oom_exclusive_retries),
                       lastDeviceOom=self.last_device_oom)
        return out

    def _kernel_tier(self) -> str:
        """What the count functions run: the hand kernels on a CUDA
        device, their plain versions on the CPU."""
        return "cuda" if self.device.type == "cuda" else "plain"

    def device_health(self) -> dict:
        """The ``/status`` deviceHealth block: the batcher's governor
        state, watchdog bound and quarantine counts (an executor without a
        batcher has no shared pipeline to stall: always healthy)."""
        if self.batcher is None:
            return {"state": "healthy", "stateCode": 0,
                    "watchdogSeconds": 0.0, "quarantinedWindows": 0,
                    "inflightWindows": 0, "consecutiveFaults": 0,
                    "watchdogTrips": 0, "kernelTier": self._kernel_tier()}
        return self.batcher.health_payload()

    def cost_status(self) -> dict:
        """The ``/status`` costs block: the ledger's measured device
        seconds and bytes per tenant, query shape and plane (top-K with an
        ``other`` fold)."""
        return self.ledger.payload()

    def _admission_path(self) -> str:
        """The path a query starts on: the batched pipeline, one request
        at a time (no batcher), or the degraded governor's per-item
        serving; refined down-stack (paged, row-directory oracle)."""
        if self.batcher is None:
            return "op-at-a-time fallback"
        if self.batcher.governor.state != "healthy":
            return "degraded governor"
        return "fused"

    def _note_path(self, path: str) -> None:
        self._tls.spath = path

    def serving_path(self) -> str:
        """The path that answered this thread's last query (the slow
        query log names it)."""
        return getattr(self._tls, "spath", "fused")

    def _mark(self, stage: str) -> None:
        """Charge the time since the last mark to ``stage`` on the
        serving thread's :class:`StageTimer` (none: nothing)."""
        timer = getattr(self._tls, "stage_timer", None)
        if timer is not None:
            timer.mark(stage)

    @property
    def slots_in_use(self) -> int:
        """Admitted queries executing now."""
        return self._inflight

    def _query_deadline(self) -> float | None:
        """The serving thread's query deadline (set by :meth:`execute`),
        which every batcher submit carries."""
        return getattr(self._tls, "deadline", None)

    # -- in-flight accounting (device-OOM recovery) -------------------------

    def _enter_inflight(self) -> None:
        with self._inflight_cv:
            self._inflight += 1

    def _leave_inflight(self) -> None:
        with self._inflight_cv:
            self._inflight -= 1
            self._inflight_cv.notify_all()

    def _drain_to_exclusive(self, timeout: float = 120.0) -> bool:
        """Wait until this query is the only one in flight (the others
        finish or park at the gate).  Bounded: on timeout the retry runs
        anyway, and may fail honestly."""
        with self._inflight_cv:
            end = time.monotonic() + timeout
            while self._inflight > 1:
                remaining = end - time.monotonic()
                if remaining <= 0:
                    return False
                self._inflight_cv.wait(remaining)
        return True

    def _note_oom(self, e: Exception, stage: int) -> None:
        dev = self._oom_device(e)
        mem = ({"device": str(dev),
                "allocated": torch.cuda.memory_allocated(dev),
                "reserved": torch.cuda.memory_reserved(dev)}
               if dev.type == "cuda" else {})
        self.stats.count("device_oom_retries" if stage == 1
                         else "device_oom_exclusive_retries", 1)
        with self._served_lock:
            if stage == 1:
                self.device_oom_retries += 1
            else:
                self.device_oom_exclusive_retries += 1
            self.last_device_oom = {"stage": stage, "error": str(e)[:300],
                                    **mem}

    def _attempt(self, fn, attempt: int):
        if fault.ACTIVE:
            # ``oom`` raises the torch.OutOfMemoryError this recovery
            # classifies: an injected OOM drives the real stages
            fault.fire("exec.oom", attempt=attempt)
        return fn()

    def _oom_device(self, e: Exception) -> torch.device:
        """The card that ran out: the one the allocator's message names
        ("GPU 2 has a total capacity ..."; under a placement a block on a
        card other than the first can run out), else the executor's."""
        hit = re.search(r"\bGPU (\d+)\b", str(e))
        if hit is None or self.device.type != "cuda":
            return self.device
        return torch.device("cuda", int(hit.group(1)))

    def _with_oom_retry(self, fn):
        """Run ``fn``; on a device OOM, recover in stages that coordinate
        across concurrent queries.

        Stage 1 (one recovery at a time, under the gate): evict the
        UNLEASED planes (a leased one frees nothing: its query holds the
        tensor), collect garbage, retry.  The caching allocator already
        gave its cached blocks back and retried before it raised, so only
        dropped cache entries free memory.

        Stage 2 (still under the gate): park new arrivals, drain to
        exclusivity, join the background builds (whose memory the cache
        cannot see yet), drop ALL residency and retry once more.

        At most three attempts per call.  Wraps every execute path: the
        Count batches, each call and each plan-cache hit."""
        try:
            return self._attempt(fn, 1)
        except Exception as e:  # noqa: BLE001 — filtered below
            if not _is_device_oom(e):
                raise
            self._note_oom(e, 1)
        # wait for the gate OUTSIDE the in-flight count: an active
        # recovery may be draining to exclusivity
        self._leave_inflight()
        try:
            with self._oom_gate:
                self._enter_inflight()
                try:
                    freed = self.planes.evict_unpinned(reason="oom")
                    with self._served_lock:
                        self.last_device_oom["evictedBytes"] = freed
                    gc.collect()
                    try:
                        return self._attempt(fn, 2)
                    except Exception as e:  # noqa: BLE001
                        if not _is_device_oom(e):
                            raise
                        self._note_oom(e, 2)
                    self._recovery_open.clear()  # park new arrivals
                    try:
                        self._drain_to_exclusive()
                        self.planes.wait_builds()
                        self.planes.invalidate()
                        gc.collect()
                        return self._attempt(fn, 3)
                    finally:
                        self._recovery_open.set()
                finally:
                    self._leave_inflight()
        finally:
            self._enter_inflight()

    def tenancy_status(self) -> dict:
        """The ``/status`` ``tenancy`` block: paging, the byte quota,
        evictions by reason, QoS state and per-tenant residency, page hits
        and sheds (the reference's shape)."""
        planes = self.planes
        with planes._lock:
            out = {"paging": self.pager is not None,
                   "tenantByteQuota": self.governor.byte_quota,
                   "evictions": planes.evictions,
                   "evictionsByReason": dict(planes._evictions_by_reason),
                   "qos": self.qos.payload()}
        if self.pager is not None:
            pg = self.pager.payload()
            tenants = pg.pop("tenants")
            out.update(pg)
        else:
            tenants = {}
            with planes._lock:
                for k, v in planes._entries.items():
                    d = tenants.setdefault(
                        k[1], {"residentBytes": 0, "residentPages": 0,
                               "residentEntries": 0})
                    d["residentBytes"] += v[2]
                    d["residentEntries"] += 1
        sheds = out["qos"]["sheds"]
        for t in sheds:
            tenants.setdefault(t, {"residentBytes": 0, "residentPages": 0,
                                   "residentEntries": 0})
        for t, d in tenants.items():
            d["sheds"] = sheds.get(t, 0)
        out["tenants"] = tenants
        return out

    def mesh_status(self) -> dict | None:
        """The ``/status`` ``mesh`` block: device count, shard axis,
        resident plane bytes per device and padding shards; None without
        a placement."""
        return self.planes.mesh_stats()

    def time_status(self) -> dict:
        """The ``/status`` ``timeViews`` block: the resident time planes,
        and how many time ranges each path served."""
        planes = self.planes.time_plane_status()
        with self._served_lock:
            served = {"plane": self.time_ranges_plane,
                      "span": self.time_ranges_span}
        return {"planes": planes,
                "residentBytes": sum(p["bytes"] for p in planes),
                "buckets": sum(p["buckets"] for p in planes),
                "rangesServed": served}

    # ------------------------------------------------------------------ api

    def execute(self, index_name: str, query: str | Query,
                shards: list[int] | None = None,
                deadline: float | None = None, tracer=None,
                translate_output: bool = True) -> list:
        """Run every top-level call; returns one result per call.
        ``deadline`` (a ``time.monotonic()`` cutoff) aborts with
        :class:`QueryTimeoutError` between calls, between streamed blocks
        and while the query waits on the batcher.  ``tracer`` overrides
        the shared one (a profiled query's own, so concurrent queries'
        spans never interleave).  ``translate_output=False`` is raw mode
        (a cluster node's partial): results keep row and column ids on
        keyed fields and indexes, and integer ids are taken there, as the
        cluster translates keys once at its edge.  Callers pass it, and
        the rest but the first three arguments, by keyword: the
        reference orders them differently."""
        index = self.holder.index(index_name)
        if index is None:
            raise ExecutionError(f"index {index_name!r} not found")
        # stage marks double as ``stage.*`` child spans of a traced query
        timer = StageTimer(self.stats, tracer=tracer or self.tracer)
        # the tenant's quotas first: a shed query never takes a slot
        qos_held = self.qos.enabled
        if qos_held:
            self.qos.admit(index_name)  # raises TenantThrottledError
        try:
            if self._exec_slots is not None:
                t_wait = time.perf_counter()
                acquired = self._exec_slots.acquire(
                    timeout=self.SLOT_TIMEOUT_S)
                self.stats.observe("query_queue_wait_seconds",
                                   time.perf_counter() - t_wait)
                if not acquired:
                    self.stats.count("query_shed_total", 1)
                    raise ExecutorSaturatedError(
                        f"executor at max concurrent queries "
                        f"({self.max_concurrent}) for "
                        f"{self.SLOT_TIMEOUT_S:.0f}s; retry later")
        except BaseException:
            if qos_held:
                self.qos.release(index_name)
            raise
        try:
            # park while a stage-2 OOM recovery drains to exclusivity
            # (bounded: a wedged recovery must not refuse service forever)
            self._recovery_open.wait(timeout=180.0)
            self._enter_inflight()
            # the planes this query is handed stay resident until it ends
            self.planes.begin_query()
        except BaseException:
            if self._exec_slots is not None:
                self._exec_slots.release()
            if qos_held:
                self.qos.release(index_name)
            raise
        timer.mark("admit")
        self._tls.stage_timer = timer
        self._tls.deadline = deadline
        self._tls.raw = not translate_output
        # the ledger's charge context: tenant and trace on this thread,
        # the plane filled in where the query resolves one
        set_query_context(index_name, trace_id=current_trace_id())
        self._tls.spath = self._admission_path()
        try:
            if fault.ACTIVE:
                fault.fire("exec.execute", index=index_name)
                timer.reset()  # an injected delay is no stage's time
            if isinstance(query, str):
                out = self._execute_planned(index, index_name, query, shards,
                                            tracer)
                if out is not None:
                    return out
                query = parse_cached(query)
                timer.mark("parse")
            return self._execute_calls(index, query, shards, deadline,
                                       tracer)
        finally:
            self._tls.stage_timer = None
            self._tls.deadline = None
            self._tls.raw = False
            clear_query_context()
            self.planes.end_query()
            self._leave_inflight()
            if self._exec_slots is not None:
                self._exec_slots.release()
            if qos_held:
                self.qos.release(index_name)

    def _execute_calls(self, index: Index, query: Query, shards,
                       deadline: float | None = None, tracer=None) -> list:
        # a span and a query_seconds observation per call (per Count run)
        tracer = tracer or self.tracer
        results = []
        calls = query.calls
        i = 0
        while i < len(calls):
            # runs of consecutive Counts execute as ONE batch with one
            # host read (consecutive only: a write between counts must
            # stay ordered)
            run_end = i
            while (run_end < len(calls) and calls[run_end].name == "Count"
                   and len(calls[run_end].children) == 1):
                run_end += 1
            ctx = _Ctx(index, self._shards_for(index, shards, calls[i]),
                       deadline)
            ctx.check_deadline()
            if run_end - i > 1:
                batch = calls[i:run_end]
                with tracer.span("executor.CountBatch",
                                 index=index.name, calls=run_end - i,
                                 shards=len(ctx.shards)):
                    t0 = time.perf_counter()
                    results.extend(self._with_oom_retry(
                        lambda: self._count_batch(ctx, batch)))
                    self.stats.timing("query_seconds",
                                      time.perf_counter() - t0,
                                      call="CountBatch")
                i = run_end
                continue
            call = calls[i]
            with tracer.span("executor." + call.name, index=index.name,
                             shards=len(ctx.shards)):
                t0 = time.perf_counter()
                results.append(self._with_oom_retry(
                    lambda: self._call(ctx, call)))
                self.stats.timing("query_seconds", time.perf_counter() - t0,
                                  call=call.name)
            i += 1
        return results

    # ------------------------------------------------------- Count batches

    def _count_batch(self, ctx: _Ctx, calls: list[Call]) -> list[int]:
        fast = self._count_batch_plane(ctx, calls)
        if fast is not None:
            return fast
        fast = self._count_batch_bsi(ctx, calls)
        if fast is not None:
            return fast
        fast = self._count_batch_tree(ctx, calls)
        if fast is not None:
            return fast
        walk = _Walk()
        nodes = tuple(self._plan(ctx, c.children[0], walk) for c in calls)
        leaves = self._leaves(ctx, walk)
        self._mark("plan")
        return self._dispatch_count_run(nodes, leaves)

    def _dispatch_count_run(self, nodes: tuple, leaves: tuple) -> list[int]:
        """One request's planned Count run -> per-call totals: ONE batcher
        item (concurrent requests share a launch and a read), or one
        batch and one read of its own."""
        if self.batcher is not None:
            out = self.batcher.submit_many(
                nodes, leaves, deadline=self._query_deadline())
            self._mark("read")
            return out
        per_shard = self.fused.run_count_batch(nodes, leaves)
        self._mark("dispatch")
        host = per_shard.cpu().numpy().astype(np.int64)  # one read
        self._mark("read")
        return [int(row.sum()) for row in host]

    # ------------------------------------------------------------ BSI range

    def _bsirange_item(self, ctx: _Ctx, child: Call):
        """``Count(Row(field op p))`` and the between forms as a batcher
        ``bsirange`` item ``(field, op_keys, offsets)``.  None = not a
        simple BSI range Count (compound children, time args, a non-BSI
        field, or a predicate past the depth, whose trivial answer the
        generic path gives without a kernel)."""
        if child.name not in ("Row", "Range") or child.children:
            return None
        hit = _field_arg(child)
        if hit is None:
            return None
        fname, value = hit
        field = ctx.index.field(str(fname))
        if field is None or field.options.type not in BSI_TYPES:
            return None
        if _has_time_args(child):
            return None
        cond = (value if isinstance(value, Condition)
                else Condition("==", value))
        if isinstance(cond.value, Call):
            return None
        op_keys, offsets = [], []
        for op_key, v in bsi_cmp_pairs(cond):
            offset, verdict = bsi_offset(field, op_key, v)
            if verdict is not None:
                return None
            op_keys.append(op_key)
            offsets.append(offset)
        return field, tuple(op_keys), tuple(offsets)

    @staticmethod
    def _bsirange_operands(field: Field, offsets: tuple) -> tuple:
        """Host predicate operands: each offset's masks and sign."""
        depth = field.options.bit_depth
        ops = []
        for offset in offsets:
            ops.append(bsik.predicate_masks(abs(offset), depth))
            ops.append(offset < 0)
        return tuple(ops)

    def _count_batch_bsi(self, ctx: _Ctx,
                         calls: list[Call]) -> list[int] | None:
        """A request of simple BSI range Counts through the batcher's
        ``bsirange`` kind over the delta-aware bit plane.  None = some
        call is not of this shape, or there is no batcher."""
        if self.batcher is None or not ctx.shards:
            return None
        if len(ctx.shards) > self._REDUCE_SHARD_MAX:
            return None  # the device int32 shard reduce must stay exact
        items = []
        for call in calls:
            it = self._bsirange_item(ctx, call.children[0])
            if it is None:
                return None
            field, op_keys, offsets = it
            items.append((field, op_keys, offsets,
                          self._bsirange_operands(field, offsets)))
        return self._run_bsirange_items(ctx, items)

    def _run_bsirange_items(self, ctx: _Ctx, items: list) -> list[int]:
        """Resolved ``(field, op_keys, offsets, operands)`` items through
        the batcher: one takes the fast lane, several enqueue ALL before
        waiting on any (one window).  Planes resolve first, so a failing
        resolution abandons no enqueued neighbour."""
        planes: dict = {}
        for field, *_ in items:
            if field.name not in planes:
                planes[field.name] = self.planes.bsi_plane_delta(
                    ctx.index.name, field, ctx.shards)
        self._mark("plan")
        deadline = self._query_deadline()
        if len(items) == 1:
            field, op_keys, offsets, operands = items[0]
            ps = planes[field.name]
            out = [self.batcher.submit_bsirange(
                ps.plane, (op_keys, False), operands, (op_keys, offsets, 0),
                delta=ps.delta, deadline=deadline)]
        else:
            handles = []
            for field, op_keys, offsets, operands in items:
                ps = planes[field.name]
                handles.append(self.batcher.enqueue_bsirange(
                    ps.plane, (op_keys, False), operands,
                    (op_keys, offsets, 0), delta=ps.delta,
                    deadline=deadline))
            out = [self.batcher.wait(h) for h in handles]
        self._mark("read")  # the coalesced wait: window, launch and read
        return out

    # ---------------------------------------------------------- whole trees

    def _count_batch_tree(self, ctx: _Ctx,
                          calls: list[Call]) -> list[int] | None:
        """Compound Count runs through the tree compiler: every child
        lowers to a :class:`~pilosa_tpu_torch.exec.tree.TreeSpec` and the
        request's trees go to the batcher as items of ONE window.  None =
        not a tree shape, or the anchor plane is not admitted (the
        generic planned path answers the same)."""
        if not self.tree_fusion or not ctx.shards:
            return None
        if not any(c.children[0].name in TREE_CALLS for c in calls):
            return None
        try:
            specs = [lower_count_tree(self, ctx, c.children[0])
                     for c in calls]
        except Unfusable:
            return None
        return self._run_tree_specs(ctx, specs)

    def _run_tree_specs(self, ctx: _Ctx, specs) -> list[int] | None:
        """Resolve lowered specs against the live planes (rows to slots
        fresh on every call, extras re-fetched, the anchor plane's overlay
        merged) and run them.  None = an anchor plane is not admitted."""
        resolved = []
        for spec in specs:
            hit = self._tree_item(ctx, spec)
            if hit is None:
                return None
            resolved.append(hit)
        for spec in specs:
            self.stats.observe("tree_fusion_depth", float(spec.depth))
            if spec.cse_hits:
                self.stats.count("tree_cse_hits_total", spec.cse_hits)
        self._mark("plan")
        if self.batcher is not None:
            deadline = self._query_deadline()
            if len(resolved) == 1:
                # a single tree may take the solo fast lane
                ps, item = resolved[0]
                out = [self.batcher.submit_tree(ps.plane, *item,
                                                delta=ps.delta,
                                                deadline=deadline)]
            else:
                # enqueue ALL trees before waiting on any: one window
                handles = [self.batcher.enqueue_tree(ps.plane, *item,
                                                     delta=ps.delta,
                                                     deadline=deadline)
                           for ps, item in resolved]
                out = [self.batcher.wait(h) for h in handles]
            self._mark("read")  # the coalesced window, launch and read
            return out
        # no batcher: one family call per (plane, overlay) pair
        groups: dict[tuple, list[int]] = {}
        for i, (ps, _item) in enumerate(resolved):
            groups.setdefault((id(ps.plane), id(ps.delta)), []).append(i)
        out = [0] * len(resolved)
        for idxs in groups.values():
            ps = resolved[idxs[0]][0]
            slots, progs, extras = assemble_items(
                [resolved[i][1] for i in idxs])
            vals = self.fused.run_tree_counts(ps.plane, slots, progs, extras,
                                              delta=ps.delta)
            self._mark("dispatch")
            for j, v in zip(idxs, vals.cpu().numpy().tolist()):
                out[j] = int(v)
        self._mark("read")
        return out

    def _tree_item(self, ctx: _Ctx, spec):
        """One spec's runtime form ``(PlaneSet, (slots, prog, extras))``:
        PUSH args rewritten against the LIVE slot map (a row with no bits
        anywhere becomes a zero push), extras materialized.  None = not
        served by the tree path now (shard count past the int32 device
        reduce, plane over budget, a small slice of a wide plane that
        is not resident, or a plane building in the background)."""
        field = ctx.index.field(spec.field)
        if field is None or field.options.type not in ROW_TYPES:
            return None
        if len(ctx.shards) > self._REDUCE_SHARD_MAX:
            return None
        if not self._plane_admitted(ctx, field, max(1, len(spec.rows))):
            return None
        ps = self.planes.field_plane_nowait(ctx.index.name, field,
                                            VIEW_STANDARD, ctx.shards)
        if ps is None:
            return None  # building in the background
        slots: list[int] = []
        slot_arg: list[int | None] = []
        for r in spec.rows:
            s = ps.slot_of.get(int(r))
            slot_arg.append(None if s is None else len(slots))
            if s is not None:
                slots.append(s)
        extras = []
        for espec in spec.extras:
            arr = self._tree_extra(ctx, espec)
            if arr is None:
                return None
            extras.append(arr)
        prog = []
        for op, arg in spec.prog:
            if op == kernels.TREE_PUSH:
                if slot_arg[arg] is None:  # no bits anywhere: empty
                    prog.append((kernels.TREE_ZERO, 0))
                    continue
                arg = slot_arg[arg]
            prog.append((op, arg))
        return ps, (tuple(slots), tuple(prog), tuple(extras))

    def _tree_extra(self, ctx: _Ctx, espec) -> torch.Tensor | None:
        """One extra operand int32[S, W]: the existence row, another set
        field's row, a BSI comparison (masks re-derived from the spec's
        offset and the field's current depth), a time range (off the time
        plane, or the union of its cover views) or a ``ConstRow``,
        through the plane cache."""
        if espec[0] == "exists":
            return self._exists(ctx)
        if espec[0] == "trange":
            _, fname, rid, frm, to = espec
            field = ctx.index.field(fname)
            if field is None or not field.options.time_quantum:
                return None
            return self._time_row(ctx, field, rid, frm, to)
        if espec[0] == "constrow":
            return self._const_row_cols(ctx, espec[1])
        if espec[0] in ("bsi", "bsi-exists"):
            field = ctx.index.field(espec[1])
            if field is None or field.options.type not in BSI_TYPES:
                return None
            ps = self.planes.bsi_plane(ctx.index.name, field, ctx.shards)
            if espec[0] == "bsi-exists":
                return ps.plane[:, bsik.EXISTS_ROW, :]
            return self._bsi_words(ps.plane, field, espec[2], espec[3])
        _, fname, vname, rid = espec
        field = ctx.index.field(fname)
        if field is None or field.options.type not in ROW_TYPES:
            return None
        return self.planes.row_words(ctx.index.name, field, vname, rid,
                                     ctx.shards)

    def _count_batch_plane(self, ctx: _Ctx, calls: list[Call]) \
            -> list[int] | None:
        """Same-field plain-row Count batches run over the resident
        whole-field plane, or in pages when the plane is past the budget
        or the tenant's quota.  None when the batch doesn't match, when a
        plane that is not resident yet is over budget (with paging off) or
        would be scanned for a small slice of its rows, or while it builds
        in the background (the generic path answers).  A resident plane
        behind the fragments absorbs the write gap into its overlay."""
        hit = self._plain_row_parse(ctx, calls)
        if hit is None:
            return None
        field, values = hit
        if not self.planes.has_plane(ctx.index.name, field, VIEW_STANDARD,
                                     ctx.shards):
            est = self.planes.plane_bytes(field, VIEW_STANDARD, ctx.shards)
            if self._paging_engaged(est):
                return self._paged_count(ctx, field, values)
            if not self._plane_admitted(ctx, field, len(calls), est):
                return None
        row_ids = [self._row_id(field, v, create=False)
                   for v in values]
        ps = self.planes.field_plane_nowait(ctx.index.name, field,
                                            VIEW_STANDARD, ctx.shards)
        if ps is None:
            return None
        return self._plane_count_rows(ps, row_ids)

    def _plane_admitted(self, ctx: _Ctx, field: Field, n_rows: int,
                        est: int | None = None) -> bool:
        """A request reading ``n_rows`` rows may use the whole-field
        plane: it is resident, or building it stays within the budget and
        does not scan the plane for a small slice of its rows."""
        if est is None:
            if self.planes.has_plane(ctx.index.name, field, VIEW_STANDARD,
                                     ctx.shards):
                return True
            est = self.planes.plane_bytes(field, VIEW_STANDARD, ctx.shards)
        if est > self.planes.budget:
            return False
        r_est = max(1, est // (len(ctx.shards) * WORDS_PER_SHARD * 4))
        return n_rows * 4 >= r_est

    # -- paged residency ----------------------------------------------------

    def _paging_engaged(self, est: int) -> bool:
        """Whether a plane of ``est`` bytes is served in pages: paging is
        on and the plane exceeds the budget or the tenant's byte quota."""
        if self.pager is None:
            return False
        limit = self.planes.budget
        if self.governor.byte_quota > 0:
            limit = min(limit, self.governor.byte_quota)
        return est > limit

    def _count_batch_paged(self, ctx: _Ctx,
                           calls: list[Call]) -> list[int] | None:
        """A single Count's entry to paging: plain-row Counts over a plane
        past the limit and not resident; None otherwise."""
        if self.pager is None or not ctx.shards:
            return None
        hit = self._plain_row_parse(ctx, calls)
        if hit is None:
            return None
        field, values = hit
        if self.planes.has_plane(ctx.index.name, field, VIEW_STANDARD,
                                 ctx.shards):
            return None
        est = self.planes.plane_bytes(field, VIEW_STANDARD, ctx.shards)
        if not self._paging_engaged(est):
            return None
        return self._paged_count(ctx, field, values)

    def _paged_count(self, ctx: _Ctx, field: Field,
                     values: list) -> list[int] | None:
        """Per-call totals over a plane past the limit, page by page: a
        resident page answers on the card (its overlay included), an
        absent one is paged in (within the tenant's byte quota) or, when
        the quota denies it, answered from the host's row cardinalities.
        Exact whatever the mix.  None when the shards make one page."""
        pages = self.pager.partition(field, VIEW_STANDARD, ctx.shards)
        if pages is None:
            return None
        self._note_path("paged")
        row_ids = [self._row_id(field, v, create=False) for v in values]
        totals = [0] * len(row_ids)
        for page_shards in pages:
            ps = self.pager.resident_page(ctx.index.name, field,
                                          VIEW_STANDARD, page_shards)
            if ps is None:
                ps = self.pager.page_in(ctx.index.name, field,
                                        VIEW_STANDARD, page_shards)
            if ps is not None:
                part = self._plane_count_rows(ps, row_ids)
            else:
                self._note_path("row-directory oracle")
                part = self.pager.oracle_counts(field, VIEW_STANDARD,
                                                page_shards, row_ids)
            for i, v in enumerate(part):
                totals[i] += int(v)
        self._mark("read")
        return totals

    def _plain_row_parse(self, ctx: _Ctx, calls: list[Call]):
        """``(field, values)`` when every call is ``Count(Row(f=v))`` over
        ONE set field with plain scalar rows; None otherwise."""
        fname = None
        values = []
        for call in calls:
            child = call.children[0]
            if child.name != "Row" or child.children:
                return None
            hit = _field_arg(child)
            if hit is None:
                return None
            f, v = hit
            if isinstance(v, (Condition, Call)):
                return None
            if _has_time_args(child):
                return None
            if fname is None:
                fname = f
            elif f != fname:
                return None
            values.append(v)
        if fname is None:
            return None
        field = self._field(ctx, fname)
        if field.options.type not in ROW_TYPES or not ctx.shards:
            return None
        return field, values

    def _plane_count_rows(self, ps, row_ids) -> list[int]:
        """Per-call totals for ``row_ids`` over a resident plane: the
        selected-row gather when the request touches a small fraction of
        the rows, the whole-plane row counts otherwise; base+delta when
        the plane carries an overlay.  A None row (an unknown key) counts
        0."""
        slots = [None if r is None else ps.slot_of.get(int(r))
                 for r in row_ids]
        live = list(dict.fromkeys(s for s in slots if s is not None))
        if not live:  # unknown keys and rows with no bits: nothing to read
            return [0] * len(slots)
        r_pad = ps.plane.shape[-2]
        if (len(ps.shards) <= self._REDUCE_SHARD_MAX
                and len(live) * self._SELECTED_ROWS_FRACTION <= r_pad):
            by_slot = self._plane_selected_totals(ps, tuple(live))
            return [int(by_slot[s]) if s is not None else 0 for s in slots]
        totals = self._plane_totals(ps)
        return [int(totals[s]) if s is not None else 0 for s in slots]

    def _plane_selected_totals(self, ps, slots: tuple) -> dict:
        """slot -> int64 total of the selected plane rows: one gather and
        popcount, the shard axis reduced on the device (callers gate on
        ``_REDUCE_SHARD_MAX``), coalesced across concurrent requests by
        the batcher."""
        if self.batcher is not None:
            vals = self.batcher.submit_selected(
                ps.plane, slots, ps.delta, deadline=self._query_deadline())
            self._mark("read")  # the coalesced window, launch and read
        else:
            vals = self.fused.run_selected_counts(ps.plane, slots, ps.delta)
            self._mark("dispatch")
            vals = vals.cpu().numpy().astype(np.int64)[:len(slots)]
            self._mark("read")
        return dict(zip(slots, vals.tolist()))

    def _plane_totals(self, ps) -> np.ndarray:
        """Whole-plane per-row totals int64[R_pad]: reduced over shards
        on the device while int32 stays exact (through the batcher, where
        identical concurrent requests dedupe to one scan), else per shard
        and finished in int64 on the host."""
        small = len(ps.shards) <= self._REDUCE_SHARD_MAX
        if self.batcher is not None and small:
            totals = self.batcher.submit_rowcounts(
                ps.plane, delta=ps.delta, deadline=self._query_deadline())
            self._mark("read")  # the coalesced window, launch and read
            return totals
        if ps.delta is not None:
            out = self.fused.run_rowcounts_delta(ps.plane, ps.delta,
                                                 reduce=small)
        elif small:
            out = self.fused.run_rowcounts_batch((False,), (ps.plane,))[0]
        else:
            out = kernels.row_counts(ps.plane)
        self._mark("dispatch")
        totals = (out.cpu().numpy().astype(np.int64) if small
                  else kernels.shard_totals(out))
        self._mark("read")
        return totals

    # ----------------------------------------------------------- plan cache

    def forget_index(self, index: str, path: str,
                     field: str | None = None) -> None:
        """Drop what this executor holds of a deleted index, or of one
        deleted field: every cached plane of the index (the reference's
        ``invalidate(index)``, even for a field) once the builds reading
        under ``path`` are done, its plans and key stores (a field's key
        files removed too), and, for a whole index, the tenant's paging
        and QoS state."""
        self.planes.invalidate(index)
        self.planes.wait_idle(index, path)
        self.invalidate_plans(index)
        if field is None:
            self.translate.drop(index)
            if self.pager is not None:
                self.pager.forget(index)
            self.qos.forget(index)
        else:
            self.translate.drop(index, field, remove_files=True)

    def invalidate_plans(self, index: str | None = None) -> None:
        """Drop cached plans (all, or one index's)."""
        with self._plans_lock:
            if index is None:
                self._plans.clear()
                return
            for key in [k for k in self._plans if k[0] == index]:
                del self._plans[key]

    def _execute_planned(self, index: Index, index_name: str, query: str,
                         shards, tracer=None) -> list | None:
        """Plan-cache path for all-Count queries: a repeated query string
        skips parse and plan.  None = take the parse path (not plannable,
        no longer valid, or its plane is not resident: admission stays on
        the parse path)."""
        # strip() only: whitespace inside the query may be inside a key;
        # raw mode takes integer ids on keyed fields, so it plans apart
        skey = (index_name, query.strip(),
                tuple(shards) if shards is not None else None, self._raw())
        with self._plans_lock:
            entry = self._plans.get(skey)
            if entry is not None:
                self._plans.move_to_end(skey)
                if entry is not _UNPLANNABLE:
                    self.plan_hits += 1
            else:
                self.plan_misses += 1
        if entry is None:
            self.stats.count("plan_cache_misses", 1)
        elif entry is not _UNPLANNABLE:
            self.stats.count("plan_cache_hits", 1)
        if entry is _UNPLANNABLE:
            return None
        if entry is None:
            # build TWICE and keep the plan only when both walks saw the
            # same generations: generations only grow, so equal snapshots
            # bracket the second walk and a write racing the build cannot
            # leave a plan that was planned against older state
            first = self._build_plan(index, query, shards)
            if first is not None:
                entry = self._build_plan(index, query, shards)
                if entry is None or entry.gens != first.gens:
                    return None  # racing writes: plan on a later request
            with self._plans_lock:
                self._plans[skey] = (entry if entry is not None
                                     else _UNPLANNABLE)
                while len(self._plans) > self.MAX_PLANS:
                    self._plans.popitem(last=False)
            if entry is None:
                return None
        if (self._shards_for(index, shards) != entry.shards
                or (entry.checked
                    and self._dep_gens(index, entry.deps, entry.shards)
                    != entry.gens)
                or any((f := index.field(name)) is None
                       or f.options.type not in ROW_TYPES
                       or f.options.keys != (name in entry.keyed_fields)
                       for name in entry.set_fields)
                or any((f := index.field(name)) is None
                       or bsi_signature(f.options) != sig
                       for name, sig in entry.bsi_sigs)):
            self.stats.count("plan_cache_invalidations", 1)
            with self._plans_lock:
                if self._plans.get(skey) is entry:
                    del self._plans[skey]
            return None
        return self._run_plan(index, entry, tracer)

    def _build_plan(self, index: Index, query: str,
                    shards) -> _PlanEntry | None:
        try:
            calls = parse_cached(query).calls
        except Exception:  # noqa: BLE001 — errors surface on the parse path
            return None
        if not calls or any(c.name != "Count" or len(c.children) != 1
                            for c in calls):
            return None
        ctx = _Ctx(index, self._shards_for(index, shards))
        try:
            entry = (self._plan_plane_entry(ctx, calls)
                     or self._plan_bsirange_entry(ctx, calls)
                     or self._plan_tree_entry(ctx, calls)
                     or self._plan_generic_entry(ctx, calls))
        except (Unfusable, ExecutionError):
            # the parse path raises the same errors
            return None
        if entry is not None:
            entry.n_calls = len(calls)
        return entry

    def _plan_plane_entry(self, ctx: _Ctx, calls) -> _PlanEntry | None:
        """The same-field plain-row batch :meth:`_count_batch_plane`
        serves over the resident plane.  Keyed rows resolve once, so the
        entry is generation-checked: the write that creates a missing key
        writes its bits, and the next hit plans again."""
        hit = self._plain_row_parse(ctx, calls)
        if hit is None:
            return None
        field, values = hit
        keyed = bool(field.options.keys)
        deps = ((field.name, VIEW_STANDARD),)
        return _PlanEntry("plane", ctx.shards, deps,
                          self._dep_gens(ctx.index, deps, ctx.shards),
                          field_name=field.name,
                          row_ids=tuple(self._row_id(field, v, create=False)
                                        for v in values),
                          set_fields=(field.name,),
                          keyed_fields=(field.name,) if keyed else (),
                          checked=keyed)

    def _plan_bsirange_entry(self, ctx: _Ctx, calls) -> _PlanEntry | None:
        """Every Count child a simple BSI range Count: the entry keeps the
        fields, op keys, offsets and host operands; the plane comes
        delta-aware on every hit."""
        if self.batcher is None or not ctx.shards:
            return None
        if len(ctx.shards) > self._REDUCE_SHARD_MAX:
            return None
        items = []
        sigs: dict = {}
        deps: dict = {}
        for call in calls:
            it = self._bsirange_item(ctx, call.children[0])
            if it is None:
                return None
            field, op_keys, offsets = it
            items.append((field.name, op_keys, offsets,
                          self._bsirange_operands(field, offsets)))
            sigs[field.name] = bsi_signature(field.options)
            deps[(field.name, field.bsi_view_name)] = None
        deps = tuple(deps)
        return _PlanEntry("bsirange", ctx.shards, deps,
                          self._dep_gens(ctx.index, deps, ctx.shards),
                          range_items=tuple(items),
                          bsi_sigs=tuple(sigs.items()))

    def _plan_tree_entry(self, ctx: _Ctx, calls) -> _PlanEntry | None:
        """Every Count child lowered to a TreeSpec."""
        if not self.tree_fusion or not ctx.shards:
            return None
        if not any(c.children[0].name in TREE_CALLS for c in calls):
            return None
        try:
            specs = tuple(lower_count_tree(self, ctx, c.children[0])
                          for c in calls)
        except Unfusable:
            return None  # the generic entry may take it
        deps: dict[tuple, None] = {}
        set_fields: dict[str, None] = {}
        sigs: dict = {}
        checked = False
        for spec in specs:
            set_fields[spec.field] = None
            deps[(spec.field, VIEW_STANDARD)] = None
            checked |= spec.volatile
            for fname in spec.keyed:
                # a key read as missing resolved to an empty push: a write
                # that creates it bumps this field's generations
                deps[(fname, VIEW_STANDARD)] = None
                checked = True
            for fname in spec.bsi_fields:
                f = ctx.index.field(fname)
                sigs[fname] = bsi_signature(f.options)
                deps[(fname, f.bsi_view_name)] = None
            for espec in spec.extras:
                if espec[0] == "exists":
                    deps[(_EXISTS_DEP, VIEW_STANDARD)] = None
                elif espec[0] == "row":
                    set_fields[espec[1]] = None
                    deps[(espec[1], espec[2])] = None
                elif espec[0] == "trange":
                    # every timestamped write lands in the standard view
                    # too, so its generations stand for the bucket views';
                    # a new view (a first write in a fresh period) bumps
                    # them without showing in a cached cover
                    deps[(espec[1], VIEW_STANDARD)] = None
                    checked = True
        deps = tuple(deps)
        return _PlanEntry("tree", ctx.shards, deps,
                          self._dep_gens(ctx.index, deps, ctx.shards),
                          tree_specs=specs,
                          set_fields=tuple(set_fields),
                          keyed_fields=self._keyed(ctx, set_fields),
                          bsi_sigs=tuple(sigs.items()), checked=checked)

    def _plan_generic_entry(self, ctx: _Ctx,
                            calls) -> _PlanEntry | None:
        """Every Count child walked into leaf specs (:meth:`_plan`): the
        shapes the plane, bsirange and tree entries decline, which is
        every compound Count without the tree compiler.  None when a leaf
        is volatile.  The entry is generation-checked: a write to any
        dependency drops it."""
        walk = _Walk()
        nodes = tuple(self._plan(ctx, c.children[0], walk) for c in calls)
        if not walk.cacheable:
            return None
        deps = tuple(walk.deps)
        set_fields = tuple(dict.fromkeys(sp[1] for sp in walk.specs
                                         if sp[0] == "row"))
        return _PlanEntry("generic", ctx.shards, deps,
                          self._dep_gens(ctx.index, deps, ctx.shards),
                          nodes=nodes, leaf_specs=tuple(walk.specs),
                          set_fields=set_fields,
                          keyed_fields=self._keyed(ctx, set_fields),
                          bsi_sigs=tuple(walk.sigs.items()), checked=True)

    @staticmethod
    def _keyed(ctx: _Ctx, names) -> tuple:
        """The keyed fields among ``names``."""
        return tuple(n for n in names
                     if (f := ctx.index.field(n)) is not None
                     and f.options.keys)

    def _leaves_from_specs(self, ctx: _Ctx, specs) -> list | None:
        """Leaf tensors of walked specs, each through the plane cache
        (which revalidates its own generations).  None = a spec no longer
        resolves (its field is gone or changed type)."""
        out: list = []
        for spec in specs:
            kind = spec[0]
            if kind == "zeros":
                out.append(self._zeros(ctx))
            elif kind == "exists":
                out.append(self._exists(ctx))
            elif kind == "union":
                out.append(self._union_rows(ctx, spec[1]))
            elif kind == "const":
                out.append(self._const_row_cols(ctx, spec[1]))
            elif kind == "limit":
                out.append(self._limit_bitmap(ctx, spec[1]))
            elif kind == "bsi":
                field = ctx.index.field(spec[1])
                if field is None or field.options.type not in BSI_TYPES:
                    return None
                out.append(self._bsi_condition(ctx, field, spec[2]))
            else:  # "row", "trange"
                field = ctx.index.field(spec[1])
                if field is None or field.options.type not in ROW_TYPES:
                    return None
                out.append(
                    self.planes.row_words(ctx.index.name, field, spec[2],
                                          spec[3], ctx.shards)
                    if kind == "row"
                    else self._time_row(ctx, field, *spec[2:]))
        return out

    def _leaves(self, ctx: _Ctx, walk: _Walk) -> tuple:
        """A walk's leaf tensors, for the request that walked it."""
        leaves = self._leaves_from_specs(ctx, walk.specs)
        if leaves is None:
            raise ExecutionError("a field was deleted or changed type while "
                                 "the query ran")
        return tuple(leaves)

    @staticmethod
    def _dep_gens(index: Index, deps: tuple, shards: tuple) -> tuple:
        out = []
        for fname, vname in deps:
            f = (index.existence_field if fname == _EXISTS_DEP
                 else index.field(fname))
            view = f.view(vname) if f is not None else None
            out.append(view.generations(shards) if view is not None
                       else None)
        return tuple(out)

    def _run_plan(self, index: Index, entry: _PlanEntry,
                  tracer=None) -> list | None:
        """Run a valid plan; None = its plane is not resident (the parse
        path decides admission)."""
        ctx = _Ctx(index, entry.shards, self._query_deadline())
        ctx.check_deadline()
        tracer = tracer or self.tracer
        with tracer.span("executor.PlanCached", index=index.name,
                         calls=entry.n_calls, shards=len(ctx.shards)):
            t0 = time.perf_counter()
            out = self._with_oom_retry(
                lambda: self._run_plan_inner(ctx, entry))
            if out is not None:
                self.stats.timing("query_seconds", time.perf_counter() - t0,
                                  call="CountBatch")
        return out

    def _run_plan_inner(self, ctx: _Ctx, entry: _PlanEntry) -> list | None:
        index = ctx.index
        if entry.kind == "tree":
            if not self.tree_fusion:
                return None
            out = self._run_tree_specs(ctx, list(entry.tree_specs))
            if out is not None:
                self._mark("assemble")
            return out
        if entry.kind == "bsirange":
            if self.batcher is None:
                return None
            out = self._run_bsirange_items(ctx, [
                (index.field(fname), op_keys, offsets, operands)
                for fname, op_keys, offsets, operands in entry.range_items])
            self._mark("assemble")
            return out
        if entry.kind == "generic":
            leaves = self._leaves_from_specs(ctx, entry.leaf_specs)
            if leaves is None:
                return None
            self._mark("plan")
            out = self._dispatch_count_run(entry.nodes, tuple(leaves))
            self._mark("assemble")
            return out
        field = index.field(entry.field_name)
        if field is None or not self.planes.has_plane(
                index.name, field, VIEW_STANDARD, ctx.shards):
            return None
        ps = self.planes.field_plane_nowait(index.name, field, VIEW_STANDARD,
                                            ctx.shards)
        if ps is None:
            return None
        self._mark("plan")
        out = self._plane_count_rows(ps, entry.row_ids)
        self._mark("assemble")
        return out

    def _shards_for(self, index: Index, shards,
                    call: Call | None = None) -> tuple[int, ...]:
        """The shards a call runs over: ``Options(shards=)``, else the
        request's ``shards``, else every shard the index holds; padded to
        the placement's width with ``PAD_SHARD`` under one."""
        opts = (call.args.get("shards")
                if call is not None and call.name == "Options" else None)
        if opts is not None:
            out = tuple(int(s) for s in opts)
        elif shards is not None:
            out = tuple(shards)
        else:
            avail = index.available_shards()
            out = tuple(avail) if avail else (0,)
        return self._padded(out)

    def _padded(self, shards: tuple[int, ...]) -> tuple[int, ...]:
        if self.placement is None:
            return shards
        return self.placement.pad_shards(shards)

    # ------------------------------------------------------------- dispatch

    def _call(self, ctx: _Ctx, call: Call):
        if call.name == "Options":
            return self._execute_options(ctx, call)
        if call.name in _BITMAP_CALLS:
            result = self._to_row_result(ctx, self._fused_bitmap(ctx, call))
            if call.name == "Row":
                self._attach_row_attrs(ctx, call, result)
            if call.name == "All":
                # All(limit=, offset=) pages the column list
                offset = int(call.args.get("offset", 0))
                limit = call.args.get("limit")
                if offset or limit is not None:
                    end = None if limit is None else offset + int(limit)
                    result.columns = result.columns[offset:end]
                    if result.keys is not None:
                        result.keys = result.keys[offset:end]
            return result
        handler = {"Count": self._execute_count, "TopN": self._execute_topn,
                   "Sum": self._execute_sum, "Min": self._execute_min,
                   "Max": self._execute_max,
                   "Percentile": self._execute_percentile,
                   "Distinct": self._execute_distinct,
                   "Rows": self._execute_rows,
                   "GroupBy": self._execute_groupby,
                   "Extract": self._execute_extract,
                   "IncludesColumn": self._execute_includescolumn,
                   "Set": self._execute_set,
                   "Clear": self._execute_clear,
                   "ClearRow": self._execute_clearrow,
                   "Store": self._execute_store,
                   "SetRowAttrs": self._execute_setrowattrs,
                   "SetColumnAttrs": self._execute_setcolumnattrs,
                   }.get(call.name)
        if handler is None:
            raise ExecutionError(
                f"call {call.name!r} is not supported by this port")
        return handler(ctx, call)

    def _attach_row_attrs(self, ctx: _Ctx, call: Call,
                          result: RowResult) -> None:
        """A plain ``Row(field=row)`` result carries the row's attributes
        unless ``excludeRowAttrs=true``; a read never creates a store."""
        if call.args.get("excludeRowAttrs"):
            return
        hit = _field_arg(call)
        if hit is None:
            return
        fname, value = hit
        if isinstance(value, (Condition, Call)):
            return
        field = ctx.index.field(str(fname))
        if field is None or field.options.type in BSI_TYPES:
            return
        if not field.has_row_attrs:
            return
        row_id = self._row_id(field, value, create=False)
        if row_id is None:
            return
        attrs = field.row_attrs.attrs(int(row_id))
        if attrs:
            result.row_attrs = {str(k): v for k, v in attrs.items()}

    def _fused_bitmap(self, ctx: _Ctx, call: Call, want: str = "words"):
        """A bitmap call's words int32[S, W] (``want="count"``: per-shard
        counts int32[S]): compound calls through the tree compiler (one
        fold over rows of the resident plane), else the planned leaves."""
        if (self.tree_fusion and ctx.shards
                and call.name in TREE_CALLS):
            try:
                hit = self._tree_item(ctx, lower_count_tree(self, ctx, call))
            except Unfusable:
                hit = None
            if hit is not None:
                ps, (slots, prog, extras) = hit
                words = self.fused.run_tree_words(ps.plane, slots, prog,
                                                  extras, delta=ps.delta)
                return kernels.count(words) if want == "count" else words
        walk = _Walk()
        node = self._plan(ctx, call, walk)
        return self.fused.run(node, self._leaves(ctx, walk), want)

    def _plan(self, ctx: _Ctx, call: Call, walk: _Walk):
        """Walk a bitmap call: validate it, record its leaves as specs in
        ``walk`` (``("row", field, view, row)``, ``("exists",)``,
        ``("zeros",)``, ``("bsi", field, Condition)`` and the volatile
        ``("trange", field, row, from, to)``, ``("union", call)``,
        ``("const", columns)``, ``("limit", call)``) and return the
        hashable node tree over them."""
        if call.name in ("Row", "Range"):
            bsi = self._bsi_leaf(ctx, call)
            if bsi is not None:
                field, cond = bsi
                if isinstance(cond.value, Call):
                    raise ExecutionError(
                        "BSI condition values must be literals")
                walk.sigs[field.name] = bsi_signature(field.options)
                return walk.leaf(("bsi", field.name, cond),
                                 (field.name, field.bsi_view_name))
            field, row_id = self._row_leaf(ctx, call)
            if row_id is None:  # an unknown key: empty until a write
                return walk.leaf(("zeros",), (field.name, VIEW_STANDARD))
            rng = self._time_args(field, call)
            if rng is not None:
                return walk.volatile(("trange", field.name, row_id) + rng)
            return walk.leaf(("row", field.name, VIEW_STANDARD, row_id),
                             (field.name, VIEW_STANDARD))
        if call.name == "All":
            self._existence_field(ctx)
            return walk.leaf(("exists",), (_EXISTS_DEP, VIEW_STANDARD))
        if call.name == "Shift":
            if len(call.children) != 1:
                raise ExecutionError("Shift: exactly one child required")
            n = self._shift_n(call)
            return ("shift", self._plan(ctx, call.children[0], walk), n)
        if call.name == "UnionRows":
            return walk.volatile(("union", call))
        if call.name == "ConstRow":
            return walk.volatile(("const", self._const_row_arg(call)))
        if call.name == "Limit":
            # ordered by global column rank: the child's words, ranked
            self._limit_args(call)
            return walk.volatile(("limit", call))

        def exists_leaf() -> int:
            self._existence_field(ctx)
            return walk.leaf(("exists",), (_EXISTS_DEP, VIEW_STANDARD))[1]

        out = fold_bool_call(
            call,
            recurse=lambda c: self._plan(ctx, c, walk),
            zeros=lambda: walk.leaf(("zeros",)),
            exists=exists_leaf,
            combine=lambda op, kids: (op, tuple(k() for k in kids)),
            complement=lambda exists, child:
                (lambda ch: ("not", ch, exists()))(child()))
        if is_not_bool(out):
            raise ExecutionError(
                f"bitmap call {call.name!r} is not supported by this port")
        return out

    def _bsi_leaf(self, ctx: _Ctx, call: Call):
        """``(field, Condition)`` of a ``Row``/``Range`` on a BSI field
        (``Row(amount=5)`` is ``amount == 5``); None for a set-field
        row."""
        hit = _field_arg(call)
        if hit is None:
            raise ExecutionError(f"{call.name}: missing field argument")
        fname, value = hit
        field = self._field(ctx, fname)
        if not isinstance(value, Condition) \
                and field.options.type not in BSI_TYPES:
            return None
        if field.options.type not in BSI_TYPES:
            raise ExecutionError(
                f"field {field.name!r}: condition on non-BSI field")
        return field, (value if isinstance(value, Condition)
                       else Condition("==", value))

    def _bsi_condition(self, ctx: _Ctx, field: Field,
                       cond: Condition) -> torch.Tensor:
        """One BSI condition's columns int32[S, W] over the clean plane."""
        if isinstance(cond.value, Call):
            raise ExecutionError("BSI condition values must be literals")
        ps = self.planes.bsi_plane(ctx.index.name, field, ctx.shards)
        words = None
        for op_key, v in bsi_cmp_pairs(cond):
            cmp = self._bsi_cmp(field, ps, op_key, v)
            words = cmp if words is None else kernels.intersect(words, cmp)
        return words

    def _bsi_cmp(self, field: Field, ps, op_key: str,
                 value) -> torch.Tensor:
        """One signed comparison, saturated past the bit depth (every
        non-null column, or none, with no kernel)."""
        offset, verdict = bsi_offset(field, op_key, value)
        if verdict is None:
            return self._bsi_words(ps.plane, field, op_key, offset)
        exists = ps.plane[:, bsik.EXISTS_ROW, :]
        return exists.contiguous() if verdict else torch.zeros_like(exists)

    @staticmethod
    def _bsi_words(plane: torch.Tensor, field: Field, op_key: str,
                   offset: int) -> torch.Tensor:
        """The columns of ``plane`` whose value compares ``op_key``
        against an in-depth stored ``offset``."""
        masks = bsik.predicate_masks(abs(offset), field.options.bit_depth)
        return bsik.range_cmp(plane, masks, offset < 0,
                              keys=(op_key,))[op_key]

    def _row_leaf(self, ctx: _Ctx, call: Call) -> tuple[Field, int | None]:
        """``(field, row id)`` of a ``Row`` on a row field (the eager
        planner and the tree compiler refuse the same leaves alike); the
        id is None for an unknown key, which is an empty row whatever the
        time arguments say.  Time arguments are :meth:`_time_args`' to
        read."""
        hit = _field_arg(call)
        if hit is None:
            raise ExecutionError(f"{call.name}: missing field argument")
        fname, value = hit
        field = self._field(ctx, fname)
        if isinstance(value, Condition) or field.options.type not in ROW_TYPES:
            raise ExecutionError(
                f"Row on {field.options.type!r} field {fname!r} is not "
                "supported by this port")
        return field, self._row_id(field, value, create=False)

    # -- time ranges --------------------------------------------------------

    @staticmethod
    def _time_args(field: Field, call: Call):
        """``(from, to)`` timestamp strings of a time-range ``Row`` /
        ``Range`` (the legacy positional form puts them in ``_timestamp``
        / ``_timestamp2``; either may be None), or None for a plain row.
        Raises for a field without a time quantum or a bad timestamp."""
        if not _has_time_args(call):
            return None
        if not field.options.time_quantum:
            raise ExecutionError(f"field {field.name!r} is not a time field")
        frm = call.args.get("from", call.args.get("_timestamp"))
        to = call.args.get("to", call.args.get("_timestamp2"))
        out = tuple(None if t is None else str(t) for t in (frm, to))
        for t in out:
            if t is not None:
                _parse_time(t)
        return out

    def _time_row(self, ctx: _Ctx, field: Field, row_id: int, frm,
                  to) -> torch.Tensor:
        """The columns of ``row_id`` seen in ``[from, to)``: off the time
        plane, else the union of the cover views' rows."""
        start = _parse_time(frm) if frm is not None else None
        end = _parse_time(to) if to is not None else None
        words = self._time_range_words(ctx, field, row_id, start, end)
        if words is not None:
            return words
        return self._time_row_span(ctx, field, row_id, start, end)

    def _time_range_words(self, ctx: _Ctx, field: Field, row_id: int,
                          start, end) -> torch.Tensor | None:
        """One OR over the contiguous bucket lanes of ``row_id`` in the
        field's time plane, equal bit for bit to the union of the minimal
        cover (the finest views carry every bit).  None = not served by
        the plane: the shard axis past the int32 bound, or no plane
        within the budget."""
        if len(ctx.shards) > self._REDUCE_SHARD_MAX:
            return None
        tps = self.planes.time_plane_nowait(ctx.index.name, field,
                                            ctx.shards)
        if tps is None:
            return None
        with self._served_lock:
            self.time_ranges_plane += 1
        idx = tps.slot_of.get(int(row_id))
        b0, b1 = tps.bucket_range(start, end)
        if idx is None or b1 <= b0:
            return self._zeros(ctx)
        self.stats.observe("time_range_cover_size", float(b1 - b0))
        return self.fused.run_time_range(tps.plane, idx * tps.n_buckets + b0,
                                         b1 - b0, delta=tps.delta)

    def _time_row_span(self, ctx: _Ctx, field: Field, row_id: int, start,
                       end) -> torch.Tensor:
        """The union of ``row_id``'s row in each view of the minimal cover
        of ``[start, end)``, clamped to the span the field's views cover
        (an omitted bound would otherwise walk the calendar unit by unit):
        the path for a time plane over the budget, and the oracle the
        plane is held to."""
        with self._served_lock:
            self.time_ranges_span += 1
        acc = self._zeros(ctx)
        for vname in self._time_cover_views(field, start, end):
            acc = kernels.union(acc, self.planes.row_words(
                ctx.index.name, field, vname, row_id, ctx.shards))
        return acc

    @staticmethod
    def _time_cover_views(field: Field, start, end) -> list[str]:
        """The existing views minimally covering ``[start, end)``
        (datetimes or None), clamped to the span the views cover."""
        q = field.options.time_quantum
        if not q:
            raise ExecutionError(f"field {field.name!r} is not a time field")
        prefix = VIEW_STANDARD + "_"
        spans = []
        for vname in list(field.views):
            if vname.startswith(prefix):
                try:
                    spans.append(view_span(vname[len(prefix):]))
                except ValueError:
                    continue
        if not spans:
            return []
        vmin = min(s for s, _ in spans)
        vmax = max(e for _, e in spans)
        start = vmin if start is None else max(start, vmin)
        end = vmax if end is None else min(end, vmax)
        return [v for v in views_by_time_range(VIEW_STANDARD, start, end, q)
                if field.view(v) is not None]

    # -- Shift, Limit, ConstRow, UnionRows ----------------------------------

    @staticmethod
    def _shift_n(call: Call) -> int:
        try:
            n = int(call.args.get("n", 1))
        except (TypeError, ValueError):
            raise ExecutionError(f"Shift: bad n {call.args.get('n')!r}")
        if not 0 <= n < SHARD_WIDTH:
            raise ExecutionError(f"Shift: n must be in [0, 2^20), got {n}")
        return n

    @staticmethod
    def _limit_args(call: Call) -> tuple[int, int | None]:
        """``Limit(x, limit=, offset=)``'s ``(offset, limit)``."""
        if len(call.children) != 1:
            raise ExecutionError("Limit: exactly one bitmap child required")
        offset = int(call.args.get("offset", 0))
        limit = call.args.get("limit")
        if offset < 0 or (limit is not None and int(limit) < 0):
            raise ExecutionError("Limit: limit/offset must be >= 0")
        return offset, None if limit is None else int(limit)

    def _limit_bitmap(self, ctx: _Ctx, call: Call) -> torch.Tensor:
        """The child's bits ranked ``[offset, offset + limit)`` in global
        column order (``engine.kernels.rank_limit``, over a placement's
        blocks too, and over any number of shards: its bases are int64)."""
        offset, limit = self._limit_args(call)
        words = self._fused_bitmap(ctx, call.children[0])
        return kernels.rank_limit(words, offset,
                                  -1 if limit is None else limit)

    @staticmethod
    def _const_row_arg(call: Call) -> list:
        cols = call.args.get("columns")
        if cols is None:
            raise ExecutionError("ConstRow: missing columns argument")
        return list(cols)

    def _const_row_cols(self, ctx: _Ctx, cols) -> torch.Tensor:
        """A literal bitmap of ``cols``; an unknown key, and a column whose
        shard is outside the queried shards, drop."""
        host = np.zeros((len(ctx.shards), WORDS_PER_SHARD), np.uint32)
        shard_slot = {s: si for si, s in enumerate(ctx.shards)}
        for c in cols:
            cid = self._col_id(ctx, c, create=False)
            if cid is None:
                continue
            si = shard_slot.get(cid // SHARD_WIDTH)
            if si is None:
                continue
            off = cid % SHARD_WIDTH
            host[si, off >> 5] |= np.uint32(1) << np.uint32(off & 31)
        if self.placement is not None:
            return self.placement.place(host)
        return torch.from_numpy(host.view(np.int32)).to(self.device)

    def _union_rows_sel(self, ctx: _Ctx, call: Call) -> list:
        """``UnionRows(Rows(f), ...)``'s ``[(field, row ids), ...]``."""
        bad = [c.name for c in call.children if c.name != "Rows"]
        if bad:
            raise ExecutionError(
                f"UnionRows: children must be Rows calls, got {bad}")
        if not call.children:
            raise ExecutionError("UnionRows: Rows children required")
        out = []
        for rc in call.children:
            fname = rc.args.get("_field") or rc.args.get("field")
            field = self._field(ctx, str(fname))
            out.append((field, self._rows_of(ctx, field, rc)))
        return out

    def _union_rows(self, ctx: _Ctx, call: Call) -> torch.Tensor:
        """The OR of every selected row, over a rows plane of just those
        rows per field."""
        acc = self._zeros(ctx)
        for field, rows in self._union_rows_sel(ctx, call):
            if len(rows) == 0:
                continue
            ps = self.planes.rows_plane(ctx.index.name, field, VIEW_STANDARD,
                                        rows, ctx.shards)
            mask = np.zeros(ps.plane.shape[-2], dtype=bool)
            mask[:len(rows)] = True
            acc = kernels.union(acc, kernels.union_rows(ps.plane, mask))
        return acc

    # -- helpers ------------------------------------------------------------

    def _field(self, ctx: _Ctx, name: str) -> Field:
        field = ctx.index.field(name)
        if field is None:
            raise ExecutionError(
                f"field {name!r} not found in index {ctx.index.name!r}")
        return field

    def _raw(self) -> bool:
        """Raw mode on this thread's query (``translate_output=False``)."""
        return getattr(self._tls, "raw", False)

    def _keyed_out(self, keyed: bool) -> bool:
        """Whether a keyed field's or index's output is translated: not
        in raw mode."""
        return keyed and not self._raw()

    def _row_id(self, field: Field, value, create: bool) -> int | None:
        """A row value's id: a bool is 0 or 1, a string is a key of a keyed
        field (None when unknown and not ``create``), an integer is an id
        of an unkeyed field, or of any field in raw mode."""
        if isinstance(value, bool):
            return int(value)
        if isinstance(value, str):
            if not field.options.keys:
                raise ExecutionError(
                    f"field {field.name!r}: string row on unkeyed field")
            log = self.translate.rows(field.index_name, field.name)
            return log.translate([value], create=create)[0]
        if self._keyed_out(field.options.keys):
            raise ExecutionError(
                f"field {field.name!r}: integer row on keyed field")
        return int(value)

    def _col_id(self, ctx: _Ctx, value, create: bool) -> int | None:
        """A column value's id: a key of a keyed index (None when unknown
        and not ``create``), or an id of an unkeyed one."""
        if isinstance(value, str):
            if not ctx.index.keys:
                raise ExecutionError(
                    f"index {ctx.index.name!r}: string column on unkeyed "
                    "index")
            log = self.translate.columns(ctx.index.name)
            return log.translate([value], create=create)[0]
        if self._keyed_out(ctx.index.keys):
            raise ExecutionError(
                f"index {ctx.index.name!r}: integer column on keyed index")
        return int(value)

    def _existence_field(self, ctx: _Ctx) -> Field:
        ef = ctx.index.existence_field
        if ef is None:
            raise ExecutionError(
                f"index {ctx.index.name!r} does not track existence "
                "(required for Not/All)")
        return ef

    def _exists(self, ctx: _Ctx) -> torch.Tensor:
        return self.planes.row_words(ctx.index.name,
                                     self._existence_field(ctx),
                                     VIEW_STANDARD, 0, ctx.shards)

    def _zeros(self, ctx: _Ctx) -> torch.Tensor:
        return self.planes.zeros(len(ctx.shards))

    def _to_row_result(self, ctx: _Ctx, words: torch.Tensor) -> RowResult:
        host = whole(words).cpu().numpy().view(np.uint32)
        parts = []
        for si, s in enumerate(ctx.shards):
            offs = unpack_columns(host[si])
            if len(offs):
                parts.append(offs + np.uint64(s * SHARD_WIDTH))
        columns = (np.concatenate(parts) if parts
                   else np.empty(0, np.uint64))
        if self._keyed_out(ctx.index.keys):
            # strict: a column with no key raises, as in the reference
            log = self.translate.columns(ctx.index.name)
            return RowResult(keys=log.keys_of(columns))
        return RowResult(columns)

    def _filter_words(self, ctx: _Ctx, call: Call) -> torch.Tensor | None:
        """Optional bitmap-call filter child (TopN)."""
        flt = call.args.get("filter")
        if flt is None and call.children:
            flt = call.children[0]
        if flt is None:
            return None
        if not isinstance(flt, Call):
            raise ExecutionError("filter must be a bitmap call")
        return self._fused_bitmap(ctx, flt)

    # -- calls --------------------------------------------------------------

    def _execute_count(self, ctx: _Ctx, call: Call) -> int:
        if len(call.children) != 1:
            raise ExecutionError("Count: exactly one child required")
        paged = self._count_batch_paged(ctx, [call])
        if paged is not None:
            return paged[0]
        fast = self._count_batch_bsi(ctx, [call])
        if fast is not None:
            return fast[0]
        fused_tree = self._count_batch_tree(ctx, [call])
        if fused_tree is not None:
            return fused_tree[0]
        if self.batcher is not None:
            # one batcher item: concurrent Counts share a launch and a read
            walk = _Walk()
            node = self._plan(ctx, call.children[0], walk)
            return self.batcher.submit(node, self._leaves(ctx, walk),
                                       deadline=self._query_deadline())
        per_shard = self._fused_bitmap(ctx, call.children[0], want="count")
        return int(kernels.shard_totals(per_shard))

    def _execute_topn(self, ctx: _Ctx, call: Call):
        fname = call.args.get("_field") or call.args.get("field")
        if fname is None:
            raise ExecutionError("TopN: missing field argument")
        field = self._field(ctx, str(fname))
        n = call.args.get("n")
        filter_words = self._filter_words(ctx, call)
        # tanimoto= keeps the rows whose coefficient against the filter
        # row, 100 |row & src| / (|src| + |row| - |row & src|), reaches the
        # threshold; _rowCounts=1 answers each row's filtered and full
        # counts and |src| instead of the pairs
        tanimoto = call.args.get("tanimoto")
        want_partial = bool(call.args.get("_rowCounts"))
        if tanimoto is not None:
            tanimoto = float(tanimoto)
            if not 0 < tanimoto <= 100:
                raise ExecutionError("TopN: tanimoto must be in (0, 100]")
        need_row_counts = want_partial or tanimoto is not None
        if need_row_counts and filter_words is None:
            raise ExecutionError(
                "TopN: tanimoto requires a filter row (source bitmap)")
        src_count = 0
        if need_row_counts:
            src_count = int(kernels.shard_totals(kernels.count(filter_words)))
        empty = ({"pairs": [], "srcCount": src_count} if want_partial
                 else PairsResult([]))
        # the representation: 1. the resident dense plane (one within the
        # budget builds now, or in the background past SYNC_BUILD_MAX);
        # 2. unfiltered, the host's row cardinalities; 3. past the budget,
        # the sparse residency when it fits; 4. row blocks streamed
        row_totals = None
        ps = None
        tried = False
        if self.planes.has_entry(ctx.index.name, field, VIEW_STANDARD,
                                 ctx.shards):
            ps = self.planes.field_plane_nowait(ctx.index.name, field,
                                                VIEW_STANDARD, ctx.shards)
            tried = True
        if ps is None:
            est = self.planes.plane_bytes(field, VIEW_STANDARD, ctx.shards)
            if est <= self.planes.budget and not tried:
                ps = self.planes.field_plane_nowait(
                    ctx.index.name, field, VIEW_STANDARD, ctx.shards)
        if ps is not None:
            self._note_topn("dense")
            if ps.n_rows == 0:
                return empty
            totals, row_totals = self._topn_dense(ctx, ps, filter_words,
                                                  need_row_counts)
            all_rows = ps.row_ids
        elif filter_words is None:
            self._note_topn("host")
            all_rows, totals = self._host_row_cards(ctx, field)
            if len(all_rows) == 0:
                return PairsResult([])
        elif (est > self.planes.budget  # not while the dense plane builds
              and self.planes.sparse_bytes(field, VIEW_STANDARD, ctx.shards)
              <= self.planes.budget):
            self._note_topn("sparse")
            ss = self.planes.sparse_plane(ctx.index.name, field,
                                          VIEW_STANDARD, ctx.shards)
            if ss.n_rows == 0:
                return empty
            if (n is not None and tanimoto is None and not want_partial
                    and call.args.get("ids") is None
                    and call.args.get("attrName") is None):
                # plain TopN(n, filter): the top k on the card, k pairs read
                k = min(int(n), ss.n_rows)
                k_pad = min(ss.n_rows_pad, 1 << max(0, (k - 1).bit_length()))
                vals, slots = self._sparse_counts(filter_words, ss, k_pad)
                vals = vals.cpu().numpy()[:k]
                slots = slots.cpu().numpy()[:k]
                live = vals > 0
                row_ids, vals = ss.row_ids[slots[live]], vals[live]
                if self._keyed_out(field.options.keys):
                    log = self.translate.rows(ctx.index.name, field.name)
                    return PairsResult(
                        [Pair(key=k_, count=int(c)) for k_, c in
                         zip(log.keys_of(row_ids, strict=False), vals)])
                return PairsResult([Pair(id=int(r), count=int(c))
                                    for r, c in zip(row_ids, vals)])
            counts = self._sparse_counts(filter_words, ss)
            totals = counts.cpu().numpy().astype(np.int64)[:ss.n_rows]
            all_rows = ss.row_ids
            if need_row_counts:
                row_totals = ss.row_cards  # host truth, no second pass
        else:
            self._note_topn("streamed")
            all_rows, totals, row_totals = self._topn_streamed(
                ctx, field, filter_words, need_row_counts, est)
            if not len(all_rows):
                return empty
        ids_arg = call.args.get("ids")
        attr_name = call.args.get("attrName")
        if attr_name is not None:
            # only the rows whose attribute matches
            ids_arg = list(ids_arg or []) + field.row_attrs.find_ids(
                str(attr_name), call.args.get("attrValue"))
            if not ids_arg:
                return PairsResult([])
        if ids_arg is not None:
            wanted = {int(r) for r in ids_arg}
            keep = np.array([int(r) in wanted for r in all_rows])
            totals = np.where(keep, totals, 0)
        if want_partial:
            live = row_totals > 0
            return {"pairs": [
                {"id": int(r), "count": int(c), "rowCount": int(rc)}
                for r, c, rc in zip(all_rows[live], totals[live],
                                    row_totals[live])],
                "srcCount": src_count}
        if tanimoto is not None:
            union = src_count + row_totals - totals
            keep = (totals > 0) & (100.0 * totals >= tanimoto * union)
            totals = np.where(keep, totals, 0)
        # host ordering: count descending, ties in row-id order
        k = len(all_rows) if n is None else min(int(n), len(all_rows))
        slots = np.argsort(-totals, kind="stable")[:k]
        vals = totals[slots]
        live = vals > 0
        row_ids, vals = all_rows[slots[live]], vals[live]
        if self._keyed_out(field.options.keys):
            log = self.translate.rows(ctx.index.name, field.name)
            return PairsResult([Pair(key=log.key_of(int(r)), count=int(c))
                                for r, c in zip(row_ids, vals)])
        return PairsResult([Pair(id=int(r), count=int(c))
                            for r, c in zip(row_ids, vals)])

    @staticmethod
    def _sparse_counts(filter_words, ss, k: int | None = None):
        """Every row's count over the sparse residency ``ss``, or with
        ``k`` the top k: per block beside per-block CSR arrays, else over
        the flat arrays, whose filter is then whole on the first device (a
        2-D placement keeps the flat form, as the reference does)."""
        meshed = isinstance(ss.word_idx, PerBlock)
        if not meshed:
            filter_words = whole(filter_words)
        args = (filter_words, ss.word_idx, ss.mask, ss.row_ptr)
        if k is None:
            return (sparsek.sparse_row_counts_meshed if meshed
                    else sparsek.sparse_row_counts)(*args)
        return (sparsek.topn_sparse_meshed if meshed
                else sparsek.topn_sparse)(*args, k)

    def _note_topn(self, path: str) -> None:
        with self._served_lock:
            self.topn_served[path] += 1

    def _topn_dense(self, ctx: _Ctx, ps, filter_words, need_row_counts):
        """Per-row totals int64[R] over a resident plane (base+delta when it
        carries an overlay) and, for tanimoto, each row's full count."""
        n_rows = ps.n_rows
        row_totals = None
        if self.batcher is not None and \
                len(ctx.shards) <= self._REDUCE_SHARD_MAX:
            # concurrent TopNs over one plane and filter share one scan;
            # tanimoto enqueues both reads before waiting on either
            deadline = self._query_deadline()
            if need_row_counts:
                h1 = self.batcher.enqueue_rowcounts(
                    ps.plane, filter_words, delta=ps.delta, deadline=deadline)
                h2 = self.batcher.enqueue_rowcounts(
                    ps.plane, delta=ps.delta, deadline=deadline)
                totals = self.batcher.wait(h1)[:n_rows]
                row_totals = self.batcher.wait(h2)[:n_rows]
            else:
                totals = self.batcher.submit_rowcounts(
                    ps.plane, filter_words, delta=ps.delta,
                    deadline=deadline)[:n_rows]
        elif ps.delta is not None:
            # per-shard base+delta counts, finished on the host
            totals = kernels.shard_totals(self.fused.run_rowcounts_delta(
                ps.plane, ps.delta, filter_words, reduce=False))[:n_rows]
            if need_row_counts:
                row_totals = kernels.shard_totals(
                    self.fused.run_rowcounts_delta(
                        ps.plane, ps.delta, reduce=False))[:n_rows]
        elif len(ctx.shards) <= self._REDUCE_SHARD_MAX:
            # shard axis reduced on the device, one int32[R_pad] read
            flags = (filter_words is not None,)
            leaves = (ps.plane,) + ((filter_words,) if flags[0] else ())
            if need_row_counts:
                flags, leaves = flags + (False,), leaves + (ps.plane,)
            out = self.fused.run_rowcounts_batch(flags, leaves)
            out = out.cpu().numpy().astype(np.int64)[:, :n_rows]
            totals = out[0]
            if need_row_counts:
                row_totals = out[1]
        else:
            totals = kernels.shard_totals(
                kernels.row_counts(ps.plane, filter_words))[:n_rows]
            if need_row_counts:
                row_totals = kernels.shard_totals(
                    kernels.row_counts(ps.plane))[:n_rows]
        return totals, row_totals

    def _topn_streamed(self, ctx: _Ctx, field: Field, filter_words,
                       need_row_counts: bool, est: int):
        """``(row_ids, totals, row_totals)`` with the view's rows streamed
        through the card in zero-padded blocks, one ``row_counts`` pass
        per block (two for tanimoto).  The reference's block is
        ``max(64, budget / (4 * S * W * 4))`` rows; here it is also at most
        the view's rows padded to a power of two (``est``'s row axis), so
        a narrow field is one block the size of its plane rather than a
        64-row one.  The answer does not depend on the block."""
        lane = len(ctx.shards) * WORDS_PER_SHARD * 4
        block = max(64, int(self.planes.budget // (lane * 4)))
        block = min(block, max(1, est // lane))
        parts_rows, parts_totals, parts_row_totals = [], [], []
        for chunk_rows, chunk_plane in self.planes.iter_row_blocks(
                field, VIEW_STANDARD, ctx.shards, block):
            ctx.check_deadline()  # streaming can run for seconds
            n = len(chunk_rows)
            parts_totals.append(kernels.shard_totals(
                kernels.row_counts(chunk_plane, filter_words))[:n])
            if need_row_counts:
                parts_row_totals.append(kernels.shard_totals(
                    kernels.row_counts(chunk_plane))[:n])
            parts_rows.append(chunk_rows)
            del chunk_plane
        if not parts_rows:
            return np.empty(0, np.uint64), np.empty(0, np.int64), None
        return (np.concatenate(parts_rows), np.concatenate(parts_totals),
                np.concatenate(parts_row_totals) if need_row_counts
                else None)

    def _host_row_cards(self, ctx: _Ctx, field: Field):
        """Exact per-row cardinalities merged across shards from the
        fragments' host metadata: the unfiltered TopN, with no device
        work."""
        view = field.view(VIEW_STANDARD)
        frags = []
        if view is not None:
            for s in ctx.shards:
                frag = view.fragment(s)
                if frag is not None:
                    frags.append(frag)
        return merge_row_cards(frags)

    # -- Rows ---------------------------------------------------------------

    def _execute_rows(self, ctx: _Ctx, call: Call) -> RowIdsResult:
        fname = call.args.get("_field") or call.args.get("field")
        if fname is None:
            raise ExecutionError("Rows: missing field argument")
        field = self._field(ctx, str(fname))
        rows = self._rows_of(ctx, field, call)
        if self._keyed_out(field.options.keys):
            log = self.translate.rows(ctx.index.name, field.name)
            return RowIdsResult(keys=log.keys_of(rows, strict=False))
        return RowIdsResult(rows=rows)

    def _rows_of(self, ctx: _Ctx, field: Field, call: Call) -> np.ndarray:
        """Sorted row ids with a bit in the standard view, or with
        ``from=`` / ``to=`` in a view of the range's minimal cover,
        honoring ``column=``, ``like=`` (a pattern over a keyed field's
        row keys), ``previous=`` and ``limit=``."""
        frm, to = call.args.get("from"), call.args.get("to")
        if frm is not None or to is not None:
            views = [field.view(v) for v in self._time_cover_views(
                field, None if frm is None else _parse_time(str(frm)),
                None if to is None else _parse_time(str(to)))]
        else:
            views = [field.standard_view()]
        views = [v for v in views if v is not None]
        column = call.args.get("column")
        if column is not None:
            # one column lies in one shard: one probe of its rows there
            col_id = self._col_id(ctx, column, create=False)
            parts = []
            if col_id is not None:
                shard, off = col_id // SHARD_WIDTH, col_id % SHARD_WIDTH
                for v in views:
                    frag = v.fragment(shard) if shard in ctx.shards else None
                    if frag is not None:
                        ids = np.asarray(frag.row_ids(), np.uint64)
                        parts.append(
                            ids[frag.rows_contain(ids, [off])[:, 0]])
        else:
            parts = [frag.row_ids_array() for v in views for s in ctx.shards
                     if (frag := v.fragment(s)) is not None]
        rows = (np.unique(np.concatenate(parts)) if parts
                else np.empty(0, np.uint64))
        like = call.args.get("like")
        if like is not None:
            # SQL LIKE over the row keys: % any run, _ one character
            if not field.options.keys:
                raise ExecutionError("Rows: like= requires a keyed field")
            pattern = (str(like).replace("*", "[*]").replace("?", "[?]")
                       .replace("%", "*").replace("_", "?"))
            rx = re.compile(fnmatch.translate(pattern))
            keys = self.translate.rows(ctx.index.name,
                                       field.name).keys_of(rows,
                                                           strict=False)
            keep = [k is not None and rx.match(k) is not None for k in keys]
            rows = rows[np.array(keep, dtype=bool)] if len(rows) else rows
        prev = call.args.get("previous")
        if prev is not None:
            # an unknown key pages from the start
            prev_id = self._row_id(field, prev, create=False)
            if prev_id is not None:
                rows = rows[rows > prev_id]
        limit = call.args.get("limit")
        if limit is not None:
            rows = rows[:int(limit)]
        return rows

    # -- GroupBy ------------------------------------------------------------

    _GROUPBY_AGGS = {"Sum": "sum", "Count": None, "Min": "minmax",
                     "Max": "minmax"}

    @staticmethod
    def parse_having(having, agg_name: str | None):
        """``having=Condition(count > 10)`` / ``Condition(sum < 0)``:
        (metric, Condition)."""
        if not isinstance(having, Call) or having.name != "Condition":
            raise ExecutionError("GroupBy: having= must be Condition(...)")
        conds = [(k, v) for k, v in having.args.items()
                 if isinstance(v, Condition)]
        if len(conds) != 1 or conds[0][0] not in ("count", "sum"):
            raise ExecutionError("GroupBy: having supports exactly one "
                                 "condition on count or sum")
        metric, cond = conds[0]
        if metric == "sum" and agg_name != "Sum":
            raise ExecutionError(
                "GroupBy: having on sum requires aggregate=Sum(...)")
        return metric, cond

    def _groupby_agg(self, ctx: _Ctx, agg):
        """``(name, field)`` of ``aggregate=``: (None, None) without one;
        the field is None for Count."""
        if not isinstance(agg, Call):
            return None, None
        if agg.name not in self._GROUPBY_AGGS:
            raise ExecutionError(
                "GroupBy: aggregate must be Sum/Count/Min/Max")
        if agg.name == "Count":
            return agg.name, None
        aname = agg.args.get("field") or agg.args.get("_field")
        field = self._field(ctx, str(aname))
        if field.options.type not in BSI_TYPES:
            raise ExecutionError(
                f"GroupBy: aggregate field {aname!r} is not BSI")
        return agg.name, field

    def _groupby_run(self):
        """The block dispatcher of :func:`exec.groupby.iter_blocks`: each
        block through the batcher's ``groupby`` kind (identical concurrent
        blocks dedupe by the digest of their combination slots), or one
        direct call without a batcher."""
        if self.batcher is None:
            return None
        deadline = self._query_deadline()

        def run(pl, ci, lp, fw, ap, agg, ad):
            meta = (int(ci.shape[0]) if pl else 1, int(lp.shape[1]),
                    int(ap.shape[1]) - 2 if ap is not None else 0)
            digest = hashlib.blake2b(ci.tobytes(), digest_size=8).digest()
            return self.batcher.submit_groupby(pl, ci, lp, fw, ap, agg, meta,
                                               digest, delta=ad,
                                               deadline=deadline)
        return run

    @staticmethod
    def _group_sums(out: dict, slots: np.ndarray, base: int) -> np.ndarray:
        """Exact group Sums [C, L] of one block: an int64 product while the
        bound proves it exact, else Python ints."""
        pos = out["pos"][:, slots].astype(np.int64)
        neg = out["neg"][:, slots].astype(np.int64)
        acnt = out["cnt"][:, slots].astype(np.int64)
        depth = pos.shape[-1]
        max_count = int(max(np.abs(pos).max(initial=0),
                            np.abs(neg).max(initial=0)))
        bound = (max_count << (depth + 1)) + \
            abs(int(base)) * int(np.abs(acnt).max(initial=0))
        if depth <= 62 and bound < (1 << 62):
            weights = np.int64(1) << np.arange(depth, dtype=np.int64)
            return (pos - neg) @ weights + base * acnt
        aggs = np.empty(pos.shape[:2], dtype=object)
        for c in range(pos.shape[0]):
            for li in range(pos.shape[1]):
                aggs[c, li] = sum(
                    (int(pos[c, li, b]) - int(neg[c, li, b])) << b
                    for b in range(depth)) + base * int(acnt[c, li])
        return aggs

    def _execute_groupby(self, ctx: _Ctx, call: Call) -> GroupCountsResult:
        """Every combination of the ``Rows()`` levels' rows, counted over
        rows planes of the selected rows (:mod:`exec.groupby`), with an
        optional aggregate per group; groups come in lexicographic row-id
        order."""
        rows_calls = [c for c in call.children if c.name == "Rows"]
        if not rows_calls:
            raise ExecutionError("GroupBy: at least one Rows child required")
        filter_words = None
        flt = call.args.get("filter")
        if isinstance(flt, Call):
            filter_words = self._fused_bitmap(ctx, flt)
        agg_name, agg_field = self._groupby_agg(ctx,
                                                call.args.get("aggregate"))
        # Min/Max reconstruct int32 values up to MINMAX_MAX_DEPTH bits;
        # deeper fields finish each surviving group on the exact host path
        minmax_host = (agg_name in ("Min", "Max")
                       and agg_field.options.bit_depth > gb.MINMAX_MAX_DEPTH)
        if len(ctx.shards) > gb.MAX_SHARDS:
            raise ExecutionError(
                f"GroupBy: more than {gb.MAX_SHARDS} shards per node "
                "unsupported")
        specs = []  # (field, row ids, PlaneSet)
        for rc in rows_calls:
            f = self._field(ctx, str(rc.args.get("_field")
                                     or rc.args.get("field")))
            rows = self._rows_of(ctx, f, rc)
            if len(rows) == 0:
                return GroupCountsResult([])  # no combination possible
            specs.append((f, rows, self.planes.rows_plane(
                ctx.index.name, f, VIEW_STANDARD, rows, ctx.shards)))
        # the aggregates read base+delta; the host Min/Max path reads the
        # plane directly, so it folds first
        agg_plane = None
        if agg_field is not None:
            fetch = (self.planes.bsi_plane if minmax_host
                     else self.planes.bsi_plane_delta)
            agg_plane = fetch(ctx.index.name, agg_field, ctx.shards)
        having = call.args.get("having")
        having_metric = having_cond = None
        if having is not None:
            having_metric, having_cond = self.parse_having(having, agg_name)
        limit = call.args.get("limit")
        # previous=[rowID, ...] pages past one combination: groups come in
        # lexicographic row-id order, so skip while combo <= previous
        prev = call.args.get("previous")
        prev_tuple = (tuple(int(r) for r in prev)
                      if isinstance(prev, list) else None)
        if prev_tuple is not None and len(prev_tuple) != len(specs):
            raise ExecutionError(
                "GroupBy: previous= must list one row per Rows call")

        _, last_rows, last_ps = specs[-1]
        slots = np.asarray([last_ps.slot_of[int(r)] for r in last_rows],
                           np.int64)
        last_rows_arr = np.asarray(last_rows, np.uint64)
        base = agg_field.options.base if agg_field is not None else 0
        agg_kind = None if minmax_host else self._GROUPBY_AGGS.get(agg_name)
        acc_rows, acc_counts, acc_aggs, acc_mask = [], [], [], []
        n_levels = len(specs)
        total = 0
        for combo_rows, out in gb.iter_blocks(
                specs, filter_words, None if minmax_host else agg_plane,
                agg_kind, limited=limit is not None, run=self._groupby_run(),
                agg_delta=(None if minmax_host or agg_plane is None
                           else agg_plane.delta)):
            ctx.check_deadline()  # many combination blocks stream
            sub = out["counts"][:, slots].astype(np.int64)  # [C, L]
            aggs = agg_ok = None
            if agg_name == "Count":
                aggs = sub
            elif agg_name == "Sum":
                aggs = self._group_sums(out, slots, base)
            elif agg_name in ("Min", "Max") and not minmax_host:
                key = "min" if agg_name == "Min" else "max"
                aggs = out[key][:, slots].astype(np.int64) + base
                agg_ok = out[key + "_cnt"][:, slots] > 0
            keep = sub > 0
            if having_cond is not None:
                # a sum condition comes with aggregate=Sum (parse_having)
                keep = keep & having_cond.matches_array(
                    sub if having_metric == "count" else aggs)
            c_idx, l_idx = np.nonzero(keep)
            if c_idx.size == 0:
                continue
            rows_mat = np.empty((c_idx.size, n_levels), np.uint64)
            if n_levels > 1:
                rows_mat[:, :-1] = combo_rows[c_idx]
            rows_mat[:, -1] = last_rows_arr[l_idx]
            if prev_tuple is not None:
                after = _lex_gt(rows_mat, prev_tuple)
                if not after.all():
                    rows_mat = rows_mat[after]
                    c_idx, l_idx = c_idx[after], l_idx[after]
                    if c_idx.size == 0:
                        continue
            acc_rows.append(rows_mat)
            acc_counts.append(sub[c_idx, l_idx])
            if minmax_host:
                vals, ok = self._host_group_minmax(
                    specs, filter_words, agg_plane, rows_mat,
                    want_min=agg_name == "Min")
                acc_aggs.append(vals + base)
                acc_mask.append(ok)
            elif aggs is not None:
                acc_aggs.append(aggs[c_idx, l_idx])
                acc_mask.append(agg_ok[c_idx, l_idx] if agg_ok is not None
                                else np.ones(c_idx.size, bool))
            total += c_idx.size
            if limit is not None and total >= int(limit):
                break
        if not acc_rows:
            return GroupCountsResult([])
        n = None if limit is None else int(limit)
        row_ids = np.concatenate(acc_rows)[:n]
        # a keyed level translates once, over its unique row ids
        row_keys: list = [None] * n_levels
        for lvl, (f, _, _) in enumerate(specs):
            if self._keyed_out(f.options.keys):
                uniq, inv = np.unique(row_ids[:, lvl], return_inverse=True)
                keys = self.translate.rows(ctx.index.name,
                                           f.name).keys_of(uniq,
                                                           strict=False)
                row_keys[lvl] = [keys[i] for i in inv]
        return GroupCountsResult(
            fields=[f.name for f, _, _ in specs],
            row_ids=row_ids,
            row_keys=(row_keys if any(k is not None for k in row_keys)
                      else None),
            counts=np.concatenate(acc_counts)[:n],
            aggs=np.concatenate(acc_aggs)[:n] if acc_aggs else None,
            agg_mask=np.concatenate(acc_mask)[:n] if acc_mask else None)

    @staticmethod
    def _host_group_minmax(specs, filter_words, agg_plane,
                           rows_mat: np.ndarray, want_min: bool):
        """Exact Min/Max per surviving group for BSI depths past
        ``groupby.MINMAX_MAX_DEPTH``: the group's columns intersected on
        the device, then the whole-depth descent of ``bsi.min_max`` with
        Python-int reconstruction, one pass per group.  The correctness
        path for such depths, not the serving path."""
        vals: list = []
        oks = np.zeros(len(rows_mat), bool)
        for g in range(len(rows_mat)):
            words = filter_words
            for lvl, (_f, _rows, ps) in enumerate(specs):
                row = ps.plane[:, ps.slot_of[int(rows_mat[g, lvl])], :]
                words = row if words is None else kernels.intersect(words,
                                                                    row)
            live = [t for t in bsik.min_max(agg_plane.plane, words)
                    if (t[1] if want_min else t[3]) > 0]
            if not live:
                vals.append(0)
                continue
            vals.append(min(t[0] for t in live) if want_min
                        else max(t[2] for t in live))
            oks[g] = True
        return np.array(vals), oks

    # -- BSI aggregates -----------------------------------------------------

    def _agg_args(self, ctx: _Ctx, call: Call):
        fname = call.args.get("field") or call.args.get("_field")
        if fname is None:
            raise ExecutionError(f"{call.name}: missing field argument")
        field = self._field(ctx, str(fname))
        if field.options.type not in BSI_TYPES:
            raise ExecutionError(f"{call.name}: field {fname!r} is not BSI")
        return field, self._filter_words(ctx, call)

    @staticmethod
    def _agg_filters(filter_words) -> tuple:
        """The one-item family arguments (flags, filters)."""
        if filter_words is None:
            return (False,), ()
        return (True,), (filter_words,)

    def _execute_sum(self, ctx: _Ctx, call: Call) -> ValCount:
        field, filter_words = self._agg_args(ctx, call)
        ps = self.planes.bsi_plane_delta(ctx.index.name, field, ctx.shards)
        if self.batcher is not None:
            total, cnt = self.batcher.submit_sum(
                ps.plane, filter_words, delta=ps.delta,
                deadline=self._query_deadline())
        else:
            out = self.fused.run_sum_plane_batch(
                ps.plane, *self._agg_filters(filter_words), delta=ps.delta)
            total, cnt = bsik.decode_sum_packed(out.cpu().numpy()[0])
        value = total + field.options.base * cnt
        return ValCount(value=field.from_stored(value) if cnt else 0,
                        count=cnt)

    def _execute_min(self, ctx: _Ctx, call: Call) -> ValCount:
        return self._min_max(ctx, call, want_min=True)

    def _execute_max(self, ctx: _Ctx, call: Call) -> ValCount:
        return self._min_max(ctx, call, want_min=False)

    def _min_max(self, ctx: _Ctx, call: Call, want_min: bool) -> ValCount:
        field, filter_words = self._agg_args(ctx, call)
        ps = self.planes.bsi_plane_delta(ctx.index.name, field, ctx.shards)
        if self.batcher is not None:
            per_shard = self.batcher.submit_minmax(
                ps.plane, filter_words, delta=ps.delta,
                deadline=self._query_deadline())
        else:
            out = self.fused.run_minmax_plane_batch(
                ps.plane, *self._agg_filters(filter_words), delta=ps.delta)
            per_shard = bsik.decode_minmax_packed(out.cpu().numpy()[0])
        # one tuple per shard, plus one per overlay column
        live = [t for t in per_shard if (t[1] if want_min else t[3]) > 0]
        if not live:
            return ValCount(0, 0)
        if want_min:
            best = min(t[0] for t in live)
            total = sum(t[1] for t in live if t[0] == best)
        else:
            best = max(t[2] for t in live)
            total = sum(t[3] for t in live if t[2] == best)
        return ValCount(value=field.from_stored(best + field.options.base),
                        count=total)

    def _execute_percentile(self, ctx: _Ctx, call: Call) -> ValCount:
        """``Percentile(field=f, nth=99.9[, filter])``: the smallest stored
        value v with count(values <= v) >= nth% of the non-null columns,
        searched on the device (two reads in all)."""
        field, filter_words = self._agg_args(ctx, call)
        nth = call.args.get("nth")
        if nth is None:
            raise ExecutionError("Percentile: missing nth argument")
        nth = float(nth)
        if not 0 <= nth <= 100:
            raise ExecutionError("Percentile: nth must be in [0, 100]")
        ps = self.planes.bsi_plane(ctx.index.name, field, ctx.shards)
        out, total = self.fused.run_percentile(ps.plane, filter_words, nth)
        if total == 0:
            return ValCount(0, 0)
        offset, count = out.cpu().tolist()
        return ValCount(value=field.from_stored(offset + field.options.base),
                        count=count)

    def _execute_distinct(self, ctx: _Ctx, call: Call) -> DistinctResult:
        """``Distinct([filter,] field=f)``: the sorted distinct values
        among the (filtered) columns, from device presence bitmaps."""
        field, filter_words = self._agg_args(ctx, call)
        if field.options.bit_depth > 24:
            raise ExecutionError(
                "Distinct: bit depth > 24 not supported (presence array "
                "would exceed 16M entries)")
        ps = self.planes.bsi_plane(ctx.index.name, field, ctx.shards)
        if self.batcher is not None:
            # identical concurrent Distincts share one presence scan
            pos, neg = self.batcher.submit_distinct(
                ps.plane, filter_words, deadline=self._query_deadline())
        else:
            pos, neg = bsik.distinct_presence(ps.plane, filter_words)
            pos, neg = pos.cpu().numpy(), neg.cpu().numpy()
        # offsets below the base descending, then above it ascending: the
        # sorted union with no sort (the two meet only at the base itself)
        nz_pos, nz_neg = np.flatnonzero(pos), np.flatnonzero(neg)
        if len(nz_pos) and len(nz_neg) and nz_pos[0] == 0 == nz_neg[0]:
            nz_neg = nz_neg[1:]
        base = np.int64(field.options.base)
        values = np.concatenate([base - nz_neg[::-1].astype(np.int64),
                                 base + nz_pos.astype(np.int64)]).tolist()
        if field.options.type == TYPE_DECIMAL:
            values = [field.from_stored(v) for v in values]
        return DistinctResult(values)

    # -- Options, IncludesColumn --------------------------------------------

    def _execute_options(self, ctx: _Ctx, call: Call):
        """``Options(call, shards=, columnAttrs=, excludeColumns=)``: the
        child over the shards ``_execute_calls`` chose
        (:meth:`_shards_for`).  ``columnAttrs=true`` attaches the
        attributes of a row result's ``columns`` (none on a keyed index,
        whose result holds keys), and ``excludeColumns=true`` empties
        them; an unkeyed bitmap child without ``columnAttrs`` then runs
        but its columns are never read to the host."""
        if len(call.children) != 1:
            raise ExecutionError("Options: exactly one child required")
        child = call.children[0]
        col_attrs = call.args.get("columnAttrs")
        exclude = call.args.get("excludeColumns")
        if (exclude and not col_attrs and not ctx.index.keys
                and child.name in _BITMAP_CALLS):
            self._fused_bitmap(ctx, child)
            result = RowResult()
            if child.name == "Row":
                self._attach_row_attrs(ctx, child, result)
            return result
        result = self._call(ctx, child)
        if not isinstance(result, RowResult):
            return result
        if col_attrs:
            store = ctx.index.column_attrs
            result.attrs = {int(c): a for c, a in
                            zip(result.columns,
                                store.attrs_many(result.columns)) if a}
        if exclude:
            result.columns = np.empty(0, np.uint64)
            if result.keys is not None:
                result.keys = []
        return result

    def _execute_includescolumn(self, ctx: _Ctx, call: Call) -> bool:
        """``IncludesColumn(bitmap, column=c)``: the child evaluated over
        the shard that owns ``c`` alone, one word read; False for a
        column outside the queried shards."""
        if len(call.children) != 1:
            raise ExecutionError(
                "IncludesColumn: exactly one bitmap child required")
        column = call.args.get("column")
        if column is None:
            raise ExecutionError("IncludesColumn: missing column argument")
        col_id = self._col_id(ctx, column, create=False)
        if col_id is None:
            return False
        shard, off = divmod(col_id, SHARD_WIDTH)
        if shard not in ctx.shards:
            return False
        words = whole(self._fused_bitmap(
            _Ctx(ctx.index, self._padded((shard,))), call.children[0]))
        return bool((int(words[0, off >> 5]) >> (off & 31)) & 1)

    # -- Extract ------------------------------------------------------------

    # Extract materializes a value per selected column and field: a wide
    # selection is narrowed with Limit(...)
    MAX_EXTRACT_COLUMNS = 100_000

    def _execute_extract(self, ctx: _Ctx, call: Call) -> ExtractResult:
        """``Extract(bitmap, Rows(f), ...)``: per selected column, each
        field's value.  The per-shard counts come first (one read of an
        int32 per shard) so the cap holds before anything is
        materialized, then only the non-empty shard rows are read (under a
        placement each block reads its own).  A keyed index answers column
        keys, a keyed field row keys."""
        if not call.children:
            raise ExecutionError("Extract: bitmap filter child required")
        flt, *field_calls = call.children
        bad = [c.name for c in field_calls if c.name != "Rows"]
        if bad:
            raise ExecutionError(
                f"Extract: field children must be Rows calls, got {bad}")
        fields = []
        for fc in field_calls:
            fname = fc.args.get("_field") or fc.args.get("field")
            if fname is None:
                raise ExecutionError("Extract: Rows child missing field")
            fields.append(self._field(ctx, str(fname)))
        words = self._fused_bitmap(ctx, flt)
        counts = gathered(kernels.count(words)).cpu().numpy()
        total = int(counts.sum(dtype=np.int64))
        if total > self.MAX_EXTRACT_COLUMNS:
            raise ExecutionError(
                f"Extract: {total} columns selected; cap is "
                f"{self.MAX_EXTRACT_COLUMNS} — narrow the filter or wrap "
                "it in Limit(...)")
        nz = np.flatnonzero(counts)
        col_parts = [(si, ctx.shards[si], unpack_columns(row))
                     for si, row in zip(nz.tolist(),
                                        self._shard_rows(words, nz))]
        columns = [int(s) * SHARD_WIDTH + int(o)
                   for _, s, offs in col_parts for o in offs.tolist()]
        per_field = [self._extract_field(ctx, f, col_parts) for f in fields]
        if self._keyed_out(ctx.index.keys):
            columns = self.translate.columns(ctx.index.name).keys_of(
                columns, strict=False)
        return ExtractResult(
            field_specs=[(f.name, f.options.type) for f in fields],
            columns=[(c, [vals[i] for vals in per_field])
                     for i, c in enumerate(columns)])

    @staticmethod
    def _shard_rows(words: torch.Tensor, slots: np.ndarray) -> np.ndarray:
        """The words of shard slots ``slots`` (ascending) of ``words`` as
        uint32[len(slots), W]: one gather and one read, however many
        shards ``words`` spans; a blocked bitmap's blocks each read their
        own slots' words."""
        out = np.zeros((len(slots), words.shape[-1]), np.uint32)
        for (s0, s1, w0, w1), blk in blocks_of(words):
            sel = (slots >= s0) & (slots < s1)
            if sel.any():
                local = torch.from_numpy(slots[sel] - s0).to(blk.device)
                out[sel, w0:w1] = blk.index_select(0, local).cpu().numpy() \
                    .view(np.uint32)
        return out

    def _extract_field(self, ctx: _Ctx, field: Field, col_parts) -> list:
        """One field's cell for each selected column: BSI values off the
        bit plane, set-like rows off the field's clean plane, or, when
        that plane exceeds the budget, by one probe of the selected
        columns in every row of each shard's fragment."""
        if not col_parts:
            return []
        if field.options.type in BSI_TYPES:
            return self._extract_bsi(ctx, field, col_parts)
        opts = field.options
        key_log = (self.translate.rows(ctx.index.name, field.name)
                   if self._keyed_out(opts.keys) else None)
        if self.planes.plane_bytes(field, VIEW_STANDARD,
                                   ctx.shards) > self.planes.budget:
            view = field.standard_view()
            out: list = []
            for _, s, offs in col_parts:
                frag = view.fragment(s) if view is not None else None
                ids = np.asarray(frag.row_ids() if frag is not None else (),
                                 np.uint64)
                held = (frag.rows_contain(ids, offs) if frag is not None
                        else np.zeros((0, len(offs)), bool))
                out.extend(self._extract_cell(opts, key_log, ids[held[:, j]])
                           for j in range(len(offs)))
            return out
        ps = self.planes.field_plane(ctx.index.name, field, VIEW_STANDARD,
                                     ctx.shards)
        if ps.n_rows == 0:
            return [self._extract_cell(opts, key_log, ps.row_ids)
                    for _, _, offs in col_parts for _ in range(len(offs))]
        bits = self._column_probe(ps.plane, col_parts)[:, :ps.n_rows]
        return [self._extract_cell(opts, key_log,
                                   ps.row_ids[np.flatnonzero(b)])
                for b in bits]

    def _extract_bsi(self, ctx: _Ctx, field: Field, col_parts) -> list:
        """BSI values of the selected columns off the clean bit plane,
        decoded on the host."""
        opts = field.options
        depth = opts.bit_depth
        ps = self.planes.bsi_plane(ctx.index.name, field, ctx.shards)
        bits = self._column_probe(ps.plane, col_parts).astype(np.int64)
        weights = np.int64(1) << np.arange(depth, dtype=np.int64)
        mags = bits[:, bsik.OFFSET_ROW:bsik.OFFSET_ROW + depth] @ weights
        np.negative(mags, out=mags, where=bits[:, bsik.SIGN_ROW] != 0)
        return [field.from_stored(int(m) + opts.base) if e else None
                for m, e in zip(mags.tolist(),
                                bits[:, bsik.EXISTS_ROW].tolist())]

    @staticmethod
    def _column_probe(plane: torch.Tensor, col_parts) -> np.ndarray:
        """Every selected column's bit in every row of ``plane``
        int32[S, R, W] as int32[n_cols, R], in ``col_parts`` order: one
        :func:`kernels.column_bits_grouped` over just the shards that
        hold selected columns (one column per group, so nothing is
        padded) and one read; over a placement one per block holding
        selected columns (on a 2-D one the word block of each)."""
        offs = np.concatenate([o for _, _, o in col_parts]).astype(np.int64)
        slots = np.repeat([si for si, _, _ in col_parts],
                          [len(o) for _, _, o in col_parts])
        words = offs >> 5
        out = np.zeros((len(offs), plane.shape[1]), np.int32)
        for (s0, s1, w0, w1), blk in blocks_of(plane):
            sel = (slots >= s0) & (slots < s1) & (words >= w0) & (words < w1)
            if not sel.any():
                continue
            dev = blk.device
            out[sel] = kernels.column_bits_grouped(
                blk, torch.from_numpy(words[sel, None] - w0).to(dev),
                torch.from_numpy(offs[sel, None] & 31).to(dev),
                torch.from_numpy(slots[sel] - s0).to(dev))[:, :, 0] \
                .cpu().numpy()
        return out

    @staticmethod
    def _extract_cell(opts, key_log, rows):
        """One (column, field) cell from the column's sorted row ids, as
        keys through ``key_log`` on a keyed field."""
        if opts.type == TYPE_BOOL:
            return bool(rows[-1]) if len(rows) else None
        if opts.type == TYPE_MUTEX:
            if not len(rows):
                return None
            r = int(rows[0])
            return key_log.key_of(r) if key_log else r
        if key_log is not None:
            return key_log.keys_of(rows, strict=False)
        return [int(r) for r in rows]

    # -- writes -------------------------------------------------------------

    def _execute_set(self, ctx: _Ctx, call: Call) -> bool:
        col = call.args.get("_col")
        if col is None:
            raise ExecutionError("Set: missing column argument")
        col_id = self._col_id(ctx, col, create=True)
        hit = _field_arg(call)
        if hit is None:
            raise ExecutionError("Set: missing field=value argument")
        fname, value = hit
        field = self._field(ctx, fname)
        if field.options.type in BSI_TYPES:
            try:
                changed = field.set_value(col_id, value)
            except ValueError as e:
                raise ExecutionError(str(e))
            ctx.index.note_columns(np.array([col_id], np.uint64))
            return changed
        if field.options.type not in ROW_TYPES:
            raise ExecutionError(f"Set on {field.options.type!r} field "
                                 f"{fname!r} is not supported by this port")
        ts = call.args.get("_timestamp")
        # the store writes the quantum views of a time field only, as in
        # the reference
        changed = field.set_bit(self._row_id(field, value, create=True),
                                col_id, _parse_time(ts) if ts is not None
                                else None)
        ctx.index.note_columns(np.array([col_id], np.uint64))
        return changed

    def _execute_clear(self, ctx: _Ctx, call: Call) -> bool:
        col = call.args.get("_col")
        if col is None:
            raise ExecutionError("Clear: missing column argument")
        col_id = self._col_id(ctx, col, create=False)
        if col_id is None:
            return False
        hit = _field_arg(call)
        if hit is None:
            raise ExecutionError("Clear: missing field argument")
        fname, value = hit
        field = self._field(ctx, fname)
        if field.options.type in BSI_TYPES:
            return field.clear_value(col_id)
        if field.options.type not in ROW_TYPES:
            raise ExecutionError(f"Clear on {field.options.type!r} field "
                                 f"{fname!r} is not supported by this port")
        row_id = self._row_id(field, value, create=False)
        if row_id is None:
            return False
        return field.clear_bit(row_id, col_id)

    def _execute_clearrow(self, ctx: _Ctx, call: Call) -> bool:
        """``ClearRow(f=row)``: one whole-row clear per fragment of the
        standard view, shard by shard (time views keep their copy, as in
        the reference)."""
        hit = _field_arg(call)
        if hit is None:
            raise ExecutionError("ClearRow: missing field=row argument")
        fname, value = hit
        field = self._field(ctx, fname)
        row_id = self._row_id(field, value, create=False)
        if row_id is None:
            return False
        view = field.standard_view()
        changed = 0
        if view is not None:
            for s in ctx.shards:
                frag = view.fragment(s)
                if frag is not None:
                    changed += frag.clear_row(row_id)
        return changed > 0

    def _execute_store(self, ctx: _Ctx, call: Call) -> bool:
        """``Store(bitmap, f=row)``: the row replaced wholesale by the
        child's columns in every queried shard, one ``set_row`` each (no
        mutex clears on a mutex field, as in the reference).  Only the
        non-empty shard rows are read to the host; the others empty the
        row."""
        if len(call.children) != 1:
            raise ExecutionError("Store: exactly one bitmap child required")
        hit = _field_arg(call)
        if hit is None:
            raise ExecutionError("Store: missing field=row argument")
        fname, value = hit
        field = self._field(ctx, fname)
        row_id = self._row_id(field, value, create=True)
        words = whole(self._fused_bitmap(ctx, call.children[0]))
        nz = np.flatnonzero(kernels.count(words).cpu().numpy())
        host = dict(zip(nz.tolist(), self._shard_rows(words, nz)))
        view = field.standard_view(create=True)
        changed = False
        for si, s in enumerate(ctx.shards):
            if s == PAD_SHARD:
                continue
            cols = (unpack_columns(host[si]).astype(np.uint32) if si in host
                    else np.empty(0, np.uint32))
            changed |= view.fragment(s, create=True).set_row(row_id, cols)
        return changed

    # -- attributes ---------------------------------------------------------

    def _execute_setrowattrs(self, ctx: _Ctx, call: Call):
        """``SetRowAttrs(f, row, k=v, ...)``: merged into the field's row
        attributes (a null value deletes a key); a new key is created."""
        fname = call.args.get("_field")
        if fname is None:
            raise ExecutionError("SetRowAttrs: missing field")
        field = self._field(ctx, str(fname))
        row = call.args.get("_row")
        if row is None:
            raise ExecutionError("SetRowAttrs: missing row")
        row_id = self._row_id(field, row, create=True)
        field.row_attrs.set_attrs(int(row_id), {
            k: v for k, v in call.args.items() if not k.startswith("_")})
        return None

    def _execute_setcolumnattrs(self, ctx: _Ctx, call: Call):
        """``SetColumnAttrs(col, k=v, ...)``: merged into the index's
        column attributes; a new key is created."""
        col = call.args.get("_col")
        if col is None:
            raise ExecutionError("SetColumnAttrs: missing column")
        col_id = self._col_id(ctx, col, create=True)
        ctx.index.column_attrs.set_attrs(int(col_id), {
            k: v for k, v in call.args.items() if not k.startswith("_")})
        return None
