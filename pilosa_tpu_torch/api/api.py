"""Programmatic API: index and field creation and deletion, schema,
queries, imports, CSV export and node info.

The counterpart of ``pilosa_tpu.api.api.API`` for the calls this port
serves; ``query`` answers the same ``{"results": [...]}`` JSON (and the
same 504, 500 and 503 bodies, and the storage layer's 503 / 507), the
imports the same changed-bit counts and ``export_csv`` the same bytes.

Every query has a trace id: :meth:`API.last_trace_id` on the thread
that ran it, ``X-Pilosa-Trace-Id`` over REST (the reference returns it in
the answer dict, which the port keeps ``{"results": ...}``).  The
retention decision is made before any span exists: a sampled
(``trace_sample_rate``), profiled or slow-hunted query
(``slow_query_threshold`` at or under :data:`API.SLOW_TRACE_FLOOR`) runs
under its own :class:`~pilosa_tpu_torch.obs.Tracer` and is kept in the
process ring; any other runs under a
:class:`~pilosa_tpu_torch.obs.LiteTracer` (an id and stage marks), and
one that still comes in over the threshold lands in the slow log with its
root and ``stage.*`` breakdown.  A profiled query's root carries the cost
ledger's ``deviceSeconds`` for its trace.

With a :class:`~pilosa_tpu_torch.cluster.Cluster` attached (``cluster``)
the API is a cluster node's, as in the reference: schema changes and
deletes broadcast to every peer, queries fan out through
:class:`~pilosa_tpu_torch.cluster.DistributedExecutor`, imports route to
every replica owner of their shards through the
:class:`~pilosa_tpu_torch.ingest.BulkImporter` (hinted handoff and op-id
dedup included), and a batch marked ``direct`` (a peer already routed it)
applies locally, once per op id.
"""

from __future__ import annotations

import io
import logging
import os
import random
import shutil
import tarfile
import tempfile
import threading
import time
from datetime import datetime, timezone

import numpy as np
import torch

from pilosa_tpu_torch import __version__
from pilosa_tpu_torch.engine.words import SHARD_WIDTH
from pilosa_tpu_torch.exec import ExecutionError, Executor, result_to_json
from pilosa_tpu_torch.exec.errors import (PipelineStalledError,
                                          QueryTimeoutError,
                                          WriteUnavailableError)
from pilosa_tpu_torch.exec.executor import ExecutorSaturatedError
from pilosa_tpu_torch.obs import (GLOBAL_TRACER, LiteTracer, SlowQueryLog,
                                  Tracer)
from pilosa_tpu_torch.obs.tracing import set_current_trace_id
from pilosa_tpu_torch.pql.parser import ParseError
from pilosa_tpu_torch.api import proto
from pilosa_tpu_torch.store import FieldOptions, Holder, roaring
from pilosa_tpu_torch.engine.bsi import EXISTS_ROW, OFFSET_ROW, SIGN_ROW
from pilosa_tpu_torch.store.field import (BSI_TYPES, TYPE_DECIMAL, TYPE_SET,
                                          TYPE_TIME, BoolRowError)
from pilosa_tpu_torch.store.health import StorageFaultError
from pilosa_tpu_torch.store.oplog import SyncBatch
from pilosa_tpu_torch.store.timeq import parse_pql_time
from pilosa_tpu_torch.store.view import VIEW_STANDARD
from pilosa_tpu_torch.tenancy import TenantThrottledError


class ApiError(Exception):
    """An HTTP error: its status, a ``Retry-After`` in seconds for a shed
    request, and structured fields answered beside ``"error"``."""

    def __init__(self, msg: str, status: int = 400,
                 retry_after: float | None = None,
                 extra: dict | None = None):
        super().__init__(msg)
        self.status = status
        self.retry_after = retry_after
        self.extra = extra or {}

    @classmethod
    def timeout(cls, exc: QueryTimeoutError, elapsed: float,
                deadline: float | None) -> "ApiError":
        """The deadline passed: 504 with a ``timeout`` block (how long the
        query ran, its budget, the shards that never answered, and the
        batcher stage it waited in, None at a call boundary)."""
        return cls(str(exc), 504, extra={"timeout": {
            "elapsedSeconds": round(elapsed, 6),
            "deadlineSeconds": deadline or None,
            "shardsOutstanding": getattr(exc, "shards_outstanding", None),
            "stage": getattr(exc, "stage", None)}})

    @classmethod
    def pipeline_stall(cls, exc: PipelineStalledError) -> "ApiError":
        """A quarantined batcher window: 500 with a ``pipelineStall``
        block naming the stalled stage and how long it aged."""
        return cls(str(exc), 500, extra={"pipelineStall": {
            "stage": getattr(exc, "stage", None),
            "elapsedSeconds": round(getattr(exc, "elapsed", 0.0), 3)}})

    @classmethod
    def write_unavailable(cls, exc: WriteUnavailableError) -> "ApiError":
        """A cluster write that could not replicate: 503 with
        ``Retry-After`` and a ``writeUnavailable{op, replica, reason}``
        block naming the down replica and why handoff could not cover
        it."""
        return cls(str(exc), 503,
                   retry_after=getattr(exc, "retry_after", 1.0),
                   extra={"writeUnavailable": {
                       "op": exc.op, "replica": exc.replica,
                       "reason": exc.reason}})

    @classmethod
    def tenant_throttled(cls, exc: TenantThrottledError) -> "ApiError":
        """A tenant's own quota shed it: 503 with ``Retry-After`` and a
        ``tenantThrottled{tenant, quota, kind}`` body, told apart from an
        overloaded executor."""
        return cls(str(exc), 503, retry_after=exc.retry_after,
                   extra={"tenantThrottled": {
                       "tenant": exc.tenant, "quota": exc.quota,
                       "kind": exc.kind}})

    @classmethod
    def storage_fault(cls, exc: StorageFaultError) -> "ApiError":
        """The storage layer refused a write: a full disk answers 507
        with ``writeUnavailable{reason: "disk_full"}`` (the node is
        read-only, reads keep serving), a quarantined fragment 503 with
        ``storageFault{path, kind}``; both with ``Retry-After``."""
        kind = getattr(exc, "kind", "unknown")
        retry = getattr(exc, "retry_after", 1.0)
        if kind == "disk_full":
            return cls(str(exc), 507, retry_after=retry,
                       extra={"writeUnavailable": {
                           "op": None, "replica": None,
                           "reason": "disk_full"}})
        return cls(str(exc), 503, retry_after=retry,
                   extra={"storageFault": {
                       "path": getattr(exc, "path", None), "kind": kind}})


def field_options_from_json(o: dict) -> FieldOptions:
    """REST field-options body -> FieldOptions."""
    return FieldOptions(
        type=o.get("type", "set"), keys=o.get("keys", False),
        cache_type=o.get("cacheType", "ranked"),
        cache_size=o.get("cacheSize", 50000),
        time_quantum=o.get("timeQuantum", ""),
        min=o.get("min"), max=o.get("max"), base=o.get("base", 0),
        bit_depth=o.get("bitDepth", 0), scale=o.get("scale", 0),
        epoch=o.get("epoch", ""), time_unit=o.get("timeUnit", "s"),
    )


class API:
    # span trees are built only for queries that may be kept: sampled,
    # profiled, or slow-hunted (a slow threshold at or under this floor
    # asks for full trees on nearly every query); above it a slow
    # capture carries the root and its stage breakdown
    SLOW_TRACE_FLOOR = 0.05

    def __init__(self, holder: Holder, executor: Executor,
                 query_timeout: float = 0.0,
                 trace_sample_rate: float = 0.01,
                 slow_query_threshold: float = 1.0, cluster=None):
        self.holder = holder
        self.executor = executor
        self.cluster = cluster  # set by the cluster layer on a node
        self._bulk_importer = None
        # seconds; a cap on every request's timeout (0: no cap)
        self.query_timeout = query_timeout
        # this fraction of ordinary queries is kept in the trace ring
        self.trace_sample_rate = min(max(float(trace_sample_rate), 0.0),
                                     1.0)
        # queries slower than this (seconds) land in GET /debug/slow;
        # 0 disables
        self.slow_query_threshold = float(slow_query_threshold)
        self.slow_log = SlowQueryLog()
        self.scrubber = None  # set by the server when it runs one
        self._trace_tls = threading.local()
        self._imported_bits = 0
        self._import_fsyncs = 0
        self.last_import_fsyncs = 0  # fsyncs of the last import's flush
        self._stats_lock = threading.Lock()

    def last_trace_id(self) -> str | None:
        """The trace id of the last query this thread ran."""
        return getattr(self._trace_tls, "trace_id", None)

    def create_index(self, name: str, options: dict | None = None):
        options = options or {}
        try:
            idx = self.holder.create_index(
                name, keys=options.get("keys", False),
                track_existence=options.get("trackExistence", True))
        except ValueError as e:
            raise ApiError(str(e), 409 if "exists" in str(e) else 400)
        if self.cluster is not None:
            self.cluster.broadcast_schema()
        return idx

    def create_field(self, index: str, name: str,
                     options: dict | None = None):
        idx = self._index(index)
        try:
            f = idx.create_field(name, field_options_from_json(options or {}))
        except ValueError as e:
            raise ApiError(str(e), 409 if "exists" in str(e) else 400)
        if self.cluster is not None:
            self.cluster.broadcast_schema()
        return f

    def delete_index(self, name: str, direct: bool = False) -> None:
        """Delete an index, its directory, its key stores and everything
        the executor holds of it (404 when absent); in a cluster, on
        every node (``direct``: a peer's broadcast, applied here only)."""
        try:
            self.holder.delete_index(
                name, release=lambda path: self.executor.forget_index(
                    name, path))
        except KeyError:
            raise ApiError(f"index {name!r} not found", 404)
        if self.cluster is not None and not direct:
            self.cluster.broadcast_delete(name, None)

    def delete_field(self, index: str, name: str,
                     direct: bool = False) -> None:
        """Delete a field, its directory and its key files; every cached
        plane of the index drops, as in the reference (404 when absent);
        in a cluster, on every node."""
        idx = self._index(index)

        def release(path: str) -> None:
            self.holder.forget_path(path)
            self.executor.forget_index(index, path, field=name)

        try:
            idx.delete_field(name, release=release)
        except KeyError:
            raise ApiError(f"field {name!r} not found", 404)
        if self.cluster is not None and not direct:
            self.cluster.broadcast_delete(index, name)

    def schema(self) -> list[dict]:
        return self.holder.schema()

    def apply_schema(self, schema: list[dict]) -> None:
        self.holder.apply_schema(schema)

    def query(self, index: str, pql: str,
              shards: list[int] | None = None,
              profile: bool = False,
              timeout: float | None = None) -> dict:
        """``timeout`` (seconds) bounds the query: past it the answer is
        a 504 with a ``timeout`` block.  ``query_timeout`` caps it (a
        request cannot lift the operator's bound), and None or 0 means
        the cap.  ``profile`` adds the query's span tree (``profile``),
        its root tagged with the cost ledger's ``deviceSeconds`` and
        ``deviceShare``.  The trace id: :meth:`last_trace_id`."""
        self._index(index)
        cap = self.query_timeout
        if timeout is None or timeout == 0:
            timeout = cap
        elif cap:
            timeout = min(timeout, cap)
        deadline = (time.monotonic() + timeout) if timeout else None
        sampled = (self.trace_sample_rate > 0
                   and random.random() < self.trace_sample_rate)
        trace = (profile or sampled
                 or 0 < self.slow_query_threshold <= self.SLOW_TRACE_FLOOR)
        stats = self.executor.stats
        if not trace:
            tracer = LiteTracer()
            self._trace_tls.trace_id = tracer.trace_id
            # the thread's active trace id: log lines join the query
            set_current_trace_id(tracer.trace_id)
            t0 = time.perf_counter()
            try:
                out, err = self._run_query(index, pql, shards, tracer,
                                           deadline, timeout, t0)
            finally:
                set_current_trace_id(None)
            duration = time.perf_counter() - t0
            if (self.slow_query_threshold > 0
                    and duration >= self.slow_query_threshold):
                root = tracer.slow_root("query", duration, index=index,
                                        node=self._node(), liteTrace=True)
                if err is not None:
                    root.tags["error"] = str(err)
                stats.count("slow_query_total", 1)
                self.slow_log.record(self._slow_entry(
                    index, pql, shards, duration, root, err))
                GLOBAL_TRACER.record(root)
                self._log_slow(index, pql, duration, tracer.trace_id)
            if err is not None:
                raise err
            return out
        tracer = Tracer()
        tracer.sampled = sampled or profile
        t0 = time.perf_counter()
        with tracer.span("query", index=index, node=self._node()) as root:
            self._trace_tls.trace_id = root.trace_id
            set_current_trace_id(root.trace_id)
            try:
                out, err = self._run_query(index, pql, shards, tracer,
                                           deadline, timeout, t0)
            finally:
                set_current_trace_id(None)
            if err is not None:
                root.tags["error"] = str(err)
        duration = time.perf_counter() - t0
        dev_s = self.executor.ledger.trace_seconds(root.trace_id)
        if dev_s is not None and dev_s > 0:
            root.tags["deviceSeconds"] = round(dev_s, 6)
            if duration > 0:
                root.tags["deviceShare"] = round(min(1.0, dev_s / duration),
                                                 4)
        slow = (self.slow_query_threshold > 0
                and duration >= self.slow_query_threshold)
        if sampled:
            stats.count("trace_sampled_total", 1)
        if slow:
            stats.count("slow_query_total", 1)
            self.slow_log.record(self._slow_entry(
                index, pql, shards, duration, root, err))
            self._log_slow(index, pql, duration, root.trace_id)
        if sampled or slow or profile:
            # resolvable at /internal/traces?trace_id= afterwards
            GLOBAL_TRACER.record(root)
        if err is not None:
            raise err
        if profile:
            out["profile"] = [sp.to_json() for sp in tracer.finished()]
        return out

    def _node(self) -> str:
        """This node's id in spans: the cluster's, else ``local``."""
        return self.cluster.node_id if self.cluster is not None else "local"

    def _run_query(self, index: str, pql: str, shards, tracer, deadline,
                   timeout, t0) -> tuple[dict, ApiError | None]:
        """Execute and classify the error: (answer, ApiError or None);
        the caller orders the raise and the slow capture."""
        try:
            if self.cluster is not None:
                return {"results": self.cluster.dist.execute_json(
                    index, pql, shards=shards, tracer=tracer,
                    deadline=deadline)}, None
            results = self.executor.execute(index, pql, shards=shards,
                                            deadline=deadline, tracer=tracer)
            return {"results": [result_to_json(r) for r in results]}, None
        except QueryTimeoutError as e:
            return {}, ApiError.timeout(e, time.perf_counter() - t0, timeout)
        except PipelineStalledError as e:
            return {}, ApiError.pipeline_stall(e)
        except TenantThrottledError as e:
            return {}, ApiError.tenant_throttled(e)
        except ExecutorSaturatedError as e:
            return {}, ApiError(str(e), 503, retry_after=e.retry_after)
        except WriteUnavailableError as e:
            return {}, ApiError.write_unavailable(e)
        except StorageFaultError as e:
            return {}, ApiError.storage_fault(e)
        except (ParseError, ExecutionError) as e:
            return {}, ApiError(str(e), 400)

    def _slow_entry(self, index: str, pql: str, shards, duration: float,
                    root, err) -> dict:
        return {
            "ts": time.time(), "index": index,
            "pql": pql if len(pql) <= 4096 else pql[:4096] + "…",
            "shards": list(shards) if shards is not None else None,
            "durationMs": round(duration * 1e3, 3),
            "traceId": root.trace_id,
            # which path answered: batched, one request at a time, paged,
            # the row-directory oracle, or the degraded governor
            "path": self.executor.serving_path(),
            "error": str(err) if err is not None else None,
            "profile": root.to_json()}

    @staticmethod
    def _log_slow(index: str, pql: str, duration: float,
                  trace_id: str) -> None:
        """One WARNING per slow capture, carrying the query's trace id
        (the JSON formatter's ``traceId``)."""
        logging.getLogger("pilosa_tpu_torch.api").warning(
            "slow query %.3fs index=%s pql=%s",
            duration, index, pql if len(pql) <= 200 else pql[:200] + "…",
            extra={"traceId": trace_id})

    # -- imports ------------------------------------------------------------

    def close(self) -> None:
        """Close the executor's key stores (they reopen on next use)."""
        self.executor.translate.close()

    def import_bits(self, index: str, field: str, *, row_ids=None,
                    col_ids=None, row_keys=None, col_keys=None,
                    timestamps=None, clear: bool = False,
                    op_id: str | None = None, direct: bool = False) -> int:
        """Bulk (row, column) import, set or ``clear``: ids, or keys of a
        keyed field (``row_keys``) and index (``col_keys``), created as
        they arrive, rows first; ``timestamps`` (one per pair: an ISO
        string, epoch seconds, or None / 0 / "" for none) also write a
        time field's quantum views.  Returns the bits changed.  The next
        Count or TopN over a resident plane absorbs the batch into its
        delta overlay.  ``op_id`` (``X-Pilosa-Op-Id``) names the batch for
        a cluster's duplicate-delivery check (a delivery whose id the node
        applied is a no-op); a single node has no cluster, so, as in the
        reference, every delivery applies.  In a cluster the batch goes
        to every replica owner of each shard it touches, unless
        ``direct`` (a peer routed it: ids only, applied here).  On a
        holder with ``fsync`` on the batch is durable when this returns,
        with one fsync per op-log it touched (a :class:`SyncBatch`).
        Timed on ``import_batch_seconds``."""
        t0 = time.perf_counter()
        changed = self._import_bits(index, field, row_ids=row_ids,
                                    col_ids=col_ids, row_keys=row_keys,
                                    col_keys=col_keys,
                                    timestamps=timestamps, clear=clear,
                                    op_id=op_id, direct=direct)
        self.executor.stats.observe("import_batch_seconds",
                                    time.perf_counter() - t0)
        return changed

    def _import_bits(self, index: str, field: str, *, row_ids, col_ids,
                     row_keys, col_keys, timestamps, clear: bool,
                     op_id: str | None, direct: bool) -> int:
        idx = self._index(index)
        f = self._field(idx, field)
        rows = self._translate_rows(idx, f, row_ids, row_keys, direct)
        cols = self._translate_cols(idx, col_ids, col_keys, direct)
        if rows.ndim != 1 or cols.ndim != 1 or len(rows) != len(cols):
            raise ApiError("rows and columns length mismatch")
        if self.cluster is not None and not direct:
            return self._bulk().import_bits(index, field, rows, cols,
                                            timestamps, clear)
        if self._applied(op_id):
            return 0  # a duplicate delivery (a retry, a replayed hint)
        ts = self._parse_timestamps(timestamps)
        sb = SyncBatch()
        try:
            if clear:
                changed = f.clear_import(rows, cols, sync_batch=sb)
            else:
                changed = f.import_bits(rows, cols, ts, sync_batch=sb)
                idx.note_columns(cols, sync_batch=sb)
        except BoolRowError:
            raise  # the reference's 500
        except ValueError as e:
            raise ApiError(str(e))
        finally:
            self._flush(sb)
        self._note_applied(op_id)
        self._count_imported(changed)
        return changed

    def _applied(self, op_id: str | None) -> bool:
        """Whether this cluster node already applied the batch ``op_id``."""
        return (op_id is not None and self.cluster is not None
                and op_id in self.cluster.applied_ops)

    def _note_applied(self, op_id: str | None) -> None:
        if op_id is not None and self.cluster is not None:
            self.cluster.applied_ops.add(op_id)

    def _bulk(self):
        """The cluster's bulk-import coordinator (made at first use: the
        cluster is attached after construction)."""
        bulk = self._bulk_importer
        if bulk is None or bulk.cluster is not self.cluster:
            from pilosa_tpu_torch.ingest import BulkImporter
            bulk = self._bulk_importer = BulkImporter(self, self.cluster)
        return bulk

    def _flush(self, sb: SyncBatch) -> None:
        """Flush an import's fsyncs and tally them for ``/status``."""
        n = sb.flush()
        with self._stats_lock:
            self._import_fsyncs += n
            self.last_import_fsyncs = n

    @staticmethod
    def _parse_timestamps(timestamps) -> list | None:
        """Import timestamps as naive UTC datetimes (None for none)."""
        if timestamps is None:
            return None
        if not isinstance(timestamps, (list, tuple)):
            raise ApiError("import: timestamps must be a list")
        out = []
        try:
            for t in timestamps:
                if t in (None, 0, ""):
                    out.append(None)
                elif isinstance(t, str):
                    out.append(parse_pql_time(t))
                else:
                    out.append(datetime.fromtimestamp(
                        int(t), timezone.utc).replace(tzinfo=None))
        except (TypeError, ValueError, OverflowError, OSError) as e:
            raise ApiError(f"import: bad timestamp: {e}")
        return out

    def import_values(self, index: str, field: str, *, col_ids=None,
                      col_keys=None, values=None,
                      direct: bool = False) -> int:
        """Bulk (column, value) import into a BSI field: column ids, or
        keys of a keyed index (``col_keys``, created as they arrive);
        returns the bits changed.  The next Sum/Min/Max/range Count over
        a resident bit plane absorbs the batch into its BSI overlay.  In
        a cluster each shard's values go to its replica owners (the
        primary's count answers), unless ``direct``."""
        idx = self._index(index)
        f = self._field(idx, field)
        if f.options.type not in BSI_TYPES:
            raise ApiError(f"field {field!r} is not an int field")
        cols = self._translate_cols(idx, col_ids, col_keys, direct)
        if (not isinstance(values, (list, tuple)) or cols.ndim != 1
                or len(values) != len(cols)):
            raise ApiError("columns and values length mismatch")
        if self.cluster is not None and not direct:
            return self._route_import_values(index, field, cols, values)
        try:
            changed = f.import_values(cols, values)
        except (TypeError, ValueError, OverflowError) as e:
            raise ApiError(str(e))
        idx.note_columns(cols)
        self._count_imported(changed, ingest=False)
        return changed

    def _route_to_owners(self, index: str, shard: int, local_fn,
                         remote_fn) -> int:
        """Apply a write on every replica owner of a shard: ``local_fn()``
        here, ``remote_fn(client)`` on a peer; returns the primary's
        changed count."""
        primary_changed = None
        for owner in self.cluster.shard_owners(index, shard):
            if owner == self.cluster.node_id:
                got = local_fn()
            else:
                got = remote_fn(self.cluster._client(owner))
            if primary_changed is None:
                primary_changed = got
        return primary_changed or 0

    @staticmethod
    def _proto_or_json_forward(path: str, encode, json_body):
        """A forwarded batch's sender: the protobuf wire, encoded at the
        first remote owner, or JSON for what the codec refuses."""
        cache: list = []

        def remote(client):
            if not cache:
                try:
                    cache.append((encode(), True))
                except ValueError:
                    cache.append((None, False))
            body, is_proto = cache[0]
            if is_proto:
                return client._do(
                    "POST", path, body, content_type=proto.CONTENT_TYPE,
                    headers={"X-Pilosa-Direct": "1"})["changed"]
            return client._json("POST", path, json_body(),
                                headers={"X-Pilosa-Direct": "1"})["changed"]
        return remote

    def _route_import_values(self, index: str, field: str, cols,
                             values) -> int:
        shards = cols // np.uint64(SHARD_WIDTH)
        changed = 0
        for shard in np.unique(shards):
            m = shards == shard
            sub_cols = [int(c) for c in cols[m]]
            sub_vals = [values[i] for i in np.nonzero(m)[0]]
            remote = self._proto_or_json_forward(
                f"/index/{index}/field/{field}/importValue",
                lambda: proto.encode_import_value_request(
                    col_ids=sub_cols, values=sub_vals),
                lambda: {"columnIDs": sub_cols, "values": sub_vals})
            changed += self._route_to_owners(
                index, int(shard),
                lambda: self.import_values(
                    index, field, col_ids=sub_cols, values=sub_vals,
                    direct=True),
                remote)
        return changed

    def import_roaring(self, index: str, field: str, shard: int,
                       blob: bytes, view: str = VIEW_STANDARD,
                       clear: bool = False,
                       op_id: str | None = None,
                       direct: bool = False) -> int:
        """Import a roaring-encoded bit set (positions ``row *
        SHARD_WIDTH + column offset``) into one shard of any view of a set
        or time field, created on first use; returns the bits changed.  A mutex or bool field
        takes pair imports only.  The positions are ids on a keyed field
        or index too, as in the reference.  ``op_id`` and ``direct`` as
        for :meth:`import_bits`."""
        t0 = time.perf_counter()
        idx = self._index(index)
        f = self._field(idx, field)
        if f.options.type not in (TYPE_SET, TYPE_TIME):
            # a raw union would skip a mutex's clears and a bool's row
            # check
            raise ApiError("import-roaring supports set/time fields, not "
                           f"{f.options.type!r}; use the pair import")
        if view in ("", ".", "..") or "/" in view or "\0" in view:
            # a view is one directory under the field
            raise ApiError(f"import-roaring: invalid view name {view!r}")
        if self.cluster is not None and not direct:
            changed = self._bulk().import_roaring(index, field, shard, blob,
                                                  view, clear)
            self.executor.stats.observe("import_batch_seconds",
                                        time.perf_counter() - t0)
            return changed
        if self._applied(op_id):
            return 0
        frag = f.view(view, create=True).fragment(shard, create=True)
        sb = SyncBatch()
        try:
            try:
                changed = frag.import_roaring(blob, clear=clear,
                                              sync_batch=sb)
            except ValueError as e:
                raise ApiError(f"bad roaring payload: {e}")
            if changed and idx.track_existence and not clear:
                positions = roaring.deserialize(blob)
                idx.note_columns(
                    np.unique(positions % np.uint64(SHARD_WIDTH))
                    + np.uint64(shard * SHARD_WIDTH), sync_batch=sb)
        finally:
            self._flush(sb)
        self._note_applied(op_id)
        self._count_imported(changed)
        self.executor.stats.observe("import_batch_seconds",
                                    time.perf_counter() - t0)
        return changed

    def _count_imported(self, changed: int, ingest: bool = True) -> None:
        """Tally the bits an import changed; bit imports also count on
        ``ingest_bits_total`` (as in the reference, value imports do
        not)."""
        if changed and ingest:
            self.executor.stats.count("ingest_bits_total", changed)
        with self._stats_lock:
            self._imported_bits += changed

    def status(self) -> dict:
        dev = self.executor.device
        name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                else "cpu")
        with self._stats_lock:
            imported = self._imported_bits
        cluster = {}
        if self.cluster is not None:
            # per-peer liveness and breakers, and the hint backlog
            cluster = {"nodes": self.cluster.nodes_status(),
                       "clusterHealth": self.cluster.health_payload(),
                       "writeHealth": self.cluster.write_health_payload()}
        return {"state": (self.cluster.state if self.cluster is not None
                          else "NORMAL"),
                **cluster,
                "version": __version__,
                "device": str(dev), "deviceName": name,
                "planes": self.executor.planes.stats(),
                "batcher": self.executor.serving_stats(),
                "ingest": {**self.executor.planes.delta_stats(),
                           "importedBits": imported},
                "timeViews": self.executor.time_status(),
                "tenancy": self.executor.tenancy_status(),
                "deviceHealth": self.executor.device_health(),
                "storage": self.storage_status(),
                "storageHealth": self.storage_health(),
                "costs": self.executor.cost_status(),
                "slowQueries": {**self.slow_log.summary(),
                                "thresholdSeconds":
                                    self.slow_query_threshold},
                "queryStages": self.executor.stats.histogram_summary(
                    "query_stage_seconds")}

    # -- the legacy single-node tar --------------------------------------

    def backup_tar(self) -> bytes:
        """A consistent tar of the data directory (the reference's): every
        fragment with op-log records compacts first, so the snapshots
        hold every write, then snapshots, metadata and key stores are
        tarred under ``data/`` without the op-logs."""
        for idx in list(self.holder.indexes.values()):
            for f in list(idx.fields.values()):
                for v in list(f.views.values()):
                    for frag in list(v.fragments.values()):
                        if frag.op_n > 0:
                            frag.snapshot()
        buf = io.BytesIO()
        with tarfile.open(fileobj=buf, mode="w") as tar:
            tar.add(self.holder.path, arcname="data",
                    filter=lambda ti: None if ti.name.endswith(".oplog")
                    else ti)
        return buf.getvalue()

    def restore_tar(self, blob: bytes) -> None:
        """Unpack a :meth:`backup_tar` (of either package) into the data
        directory and open what it holds.  Refused (409) unless the
        holder is empty, as upstream restore is.  The resident planes,
        the plans and the key stores are dropped afterwards, so their
        device memory is freed and nothing cached answers for the
        restored indexes."""
        if self.holder.indexes:
            raise ApiError("restore requires an empty holder", 409)
        with tarfile.open(fileobj=io.BytesIO(blob)) as tar:
            for member in tar.getmembers():
                name = member.name
                if not name.startswith("data/") and name != "data":
                    raise ApiError(f"unexpected tar entry {name!r}")
            # unpacked beside the tree (a dot entry the holder skips), so
            # each move is a rename
            with tempfile.TemporaryDirectory(
                    dir=self.holder.path, prefix=".restore-") as tmp:
                tar.extractall(tmp, filter="data")
                src = os.path.join(tmp, "data")
                for entry in sorted(os.listdir(src)):
                    shutil.move(os.path.join(src, entry),
                                os.path.join(self.holder.path, entry))
        # an empty holder has nothing to close: its compaction queue and
        # disk governor keep running over the indexes it now opens
        self.holder.open()
        self.executor.planes.invalidate()
        self.executor.invalidate_plans()
        self.executor.translate.close()

    def storage_health(self) -> dict:
        """The ``/status`` storageHealth block: the disk governor's state,
        the quarantine registry and, with a scrubber, its progress."""
        out = self.holder.storage_health.payload()
        if self.scrubber is not None:
            out["scrub"] = self.scrubber.payload()
        return out

    def storage_stats(self) -> dict:
        """Fragments, op-log bytes (write-ahead growth not yet compacted)
        and snapshot bytes on disk, from stat calls alone."""
        frags = oplog = snap = 0
        for idx in list(self.holder.indexes.values()):
            for f in list(idx.fields.values()):
                for v in list(f.views.values()):
                    for frag in list(v.fragments.values()):
                        frags += 1
                        oplog += frag._oplog.size()
                        try:
                            snap += os.path.getsize(frag.path)
                        except OSError:
                            pass
        return {"fragmentCount": frags, "oplogBytes": oplog,
                "snapshotBytes": snap}

    def storage_status(self) -> dict:
        """The ``/status`` storage block: the footprint, the plane builds
        (with the sidecars' warm hits and misses), the background
        compactions and the import fsyncs."""
        pc = self.executor.planes.stats()
        q = self.holder.snapshot_queue
        with self._stats_lock:
            fsyncs = self._import_fsyncs
        return {**self.storage_stats(),
                "planeBuild": {k: pc[k] for k in (
                    "builds", "buildSeconds", "buildBytes", "buildFailures",
                    "warmHits", "warmMisses", "meshed")},
                "snapshotQueue": None if q is None else {
                    "pending": q.pending(), "compactions": q.compactions,
                    "lastCompactionSeconds": q.last_compaction_seconds},
                "fsync": self.holder.fsync, "importFsyncs": fsyncs}

    def export_csv(self, index: str, field: str) -> str:
        """The field as CSV: ``row,column`` lines of the standard view
        (set, time, mutex and bool fields), ``column,value`` of a BSI
        field, shard by shard, rows and columns ascending; keys where the
        index or field is keyed and its store holds any (an id without a
        key prints ``None``), as the reference writes them."""
        idx = self._index(index)
        f = self._field(idx, field)
        col_log = (self.executor.translate.columns(index)
                   if idx.keys else None)
        col_keys = col_log is not None and len(col_log) > 0
        lines: list[str] = []
        if f.options.type in BSI_TYPES:
            view = f.bsi_view()
            for shard in sorted(view.fragments) if view is not None else ():
                cols, vals = _bsi_values(view.fragment(shard),
                                         f.options.bit_depth)
                if not len(cols):
                    continue
                vals += f.options.base
                cols = cols + np.uint64(shard * SHARD_WIDTH)
                cells = (col_log.keys_of(cols.tolist(), strict=False)
                         if col_keys else cols.tolist())
                if f.options.type == TYPE_DECIMAL:
                    out = [f.from_stored(v) for v in vals.tolist()]
                else:
                    out = vals.tolist()
                lines += [f"{c},{v}\n" for c, v in zip(cells, out)]
            return "".join(lines)
        row_log = (self.executor.translate.rows(index, field)
                   if f.options.keys else None)
        row_keys = row_log is not None and len(row_log) > 0
        view = f.standard_view()
        for shard in sorted(view.fragments) if view is not None else ():
            pos = view.fragment(shard).positions()
            if not len(pos):
                continue
            rows = pos // np.uint64(SHARD_WIDTH)
            cols = (pos % np.uint64(SHARD_WIDTH)
                    + np.uint64(shard * SHARD_WIDTH))
            if row_keys:
                ids, inv = np.unique(rows, return_inverse=True)
                names = row_log.keys_of(ids.tolist(), strict=False)
                rcell = [names[i] for i in inv.tolist()]
            else:
                rcell = rows.tolist()
            ccell = (col_log.keys_of(cols.tolist(), strict=False)
                     if col_keys else cols.tolist())
            lines += [f"{r},{c}\n" for r, c in zip(rcell, ccell)]
        return "".join(lines)

    def info(self) -> dict:
        return {"shardWidth": SHARD_WIDTH,
                "cpuPhysicalCores": os.cpu_count(),
                "memory": _total_memory_bytes()}

    def _index(self, name: str):
        idx = self.holder.index(name)
        if idx is None:
            raise ApiError(f"index {name!r} not found", 404)
        return idx

    @staticmethod
    def _field(idx, name: str):
        f = idx.field(name)
        if f is None:
            raise ApiError(f"field {name!r} not found", 404)
        return f

    @staticmethod
    def _ids(ids) -> np.ndarray:
        try:
            return np.asarray(ids, dtype=np.uint64)
        except (TypeError, ValueError, OverflowError) as e:
            raise ApiError(f"import: bad IDs: {e}")

    def _translate_rows(self, idx, f, row_ids, row_keys,
                        direct: bool = False) -> np.ndarray:
        """An import's row ids: ``row_keys`` of a keyed field translated
        (created as they arrive; in a cluster by the coordinator), else
        ``row_ids`` of an unkeyed one, or of any in a routed batch."""
        if row_keys is not None:
            if not f.options.keys:
                raise ApiError(f"field {f.name!r} is not keyed")
            if self.cluster is not None:
                return np.array(self.cluster.translate_keys(
                    idx.name, f.name, list(row_keys), create=True),
                    dtype=np.uint64)
            log = self.executor.translate.rows(idx.name, f.name)
            return np.array(log.translate(list(row_keys), create=True),
                            dtype=np.uint64)
        if row_ids is None:
            raise ApiError("missing rowIDs/rowKeys")
        if f.options.keys and not direct:
            raise ApiError(f"field {f.name!r} is keyed; use rowKeys")
        return self._ids(row_ids)

    def _translate_cols(self, idx, col_ids, col_keys,
                        direct: bool = False) -> np.ndarray:
        """An import's column ids: ``col_keys`` of a keyed index
        translated (created as they arrive; in a cluster by the
        coordinator), else ``col_ids`` of an unkeyed one, or of any in a
        routed batch."""
        if col_keys is not None:
            if not idx.keys:
                raise ApiError(f"index {idx.name!r} is not keyed")
            if self.cluster is not None:
                return np.array(self.cluster.translate_keys(
                    idx.name, None, list(col_keys), create=True),
                    dtype=np.uint64)
            log = self.executor.translate.columns(idx.name)
            return np.array(log.translate(list(col_keys), create=True),
                            dtype=np.uint64)
        if col_ids is None:
            raise ApiError("missing columnIDs/columnKeys")
        if idx.keys and not direct:
            raise ApiError(f"index {idx.name!r} is keyed; use columnKeys")
        return self._ids(col_ids)


def _bsi_values(frag, depth: int) -> tuple[np.ndarray, np.ndarray]:
    """A BSI fragment's (columns with a value, stored - base values):
    the exists row's columns ascending, each value read from the offset
    and sign rows."""
    def bits(row: int, at: np.ndarray) -> np.ndarray:
        words = frag.row_words(row)
        return (words[at >> 5] >> (at & 31).astype(np.uint32)) & 1

    words = frag.row_words(EXISTS_ROW)
    cols = np.flatnonzero(np.unpackbits(
        words.view(np.uint8), bitorder="little")).astype(np.uint64)
    vals = np.zeros(len(cols), np.int64)
    if not len(cols):
        return cols, vals
    at = cols.astype(np.int64)
    for b in range(depth):
        vals += bits(OFFSET_ROW + b, at).astype(np.int64) << b
    neg = bits(SIGN_ROW, at).astype(bool)
    vals[neg] = -vals[neg]
    return cols, vals


def _total_memory_bytes() -> int:
    """The host's memory (``MemTotal`` of ``/proc/meminfo``), 0 where it
    cannot be read."""
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemTotal:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return 0
