"""Threaded REST server over the API.

Routes (the single-node surface of ``pilosa_tpu.api.server``; the query
and import endpoints negotiate JSON or ``application/x-protobuf``)::

    POST   /index/{i}/query[?timeout=s][&shards=a,b][&profile=true]
                                 PQL body (or a protobuf QueryRequest)
                                 -> {"results": [...]} (a protobuf
                                 QueryResponse when Accept asks for one),
                                 the trace id in X-Pilosa-Trace-Id;
                                 ``profile`` adds the span tree (JSON
                                 only: with a protobuf answer it is a
                                 400)
    POST   /index/{i}/field/{f}/import
                                 JSON {"rowIDs" | "rowKeys",
                                 "columnIDs" | "columnKeys",
                                 "timestamps", "clear"} or a protobuf
                                 ImportRequest -> {"changed": n}
    POST   /index/{i}/field/{f}/importValue
                                 JSON {"columnIDs" | "columnKeys",
                                 "values"} or a protobuf
                                 ImportValueRequest into a BSI field
                                 -> {"changed": n}
    POST   /index/{i}/field/{f}/import-roaring/{shard}[?view=v][&clear]
                                 roaring body -> {"changed": n}
    POST   /index/{i}            create index
    DELETE /index/{i}            delete index
    POST   /index/{i}/field/{f}  create field
    DELETE /index/{i}/field/{f}  delete field
    GET    /index/{i}            the index's schema entry
    GET    /index/{i}/field/{f}  the field's schema entry
    GET    /export?index=i&field=f
                                 text/csv (``API.export_csv``)
    GET    /schema               {"indexes": [...]}
    GET    /info                 shard width, host cores and memory
    GET    /version              {"version": "..."}
    GET    /status               state, the torch device serving, the
                                 ``batcher`` block (windows, items,
                                 fast-lane hits, current window, plan
                                 cache hits and misses) and the
                                 ``ingest`` block (overlay fill,
                                 absorbs, compactions, imported bits),
                                 ``timeViews`` and the ``tenancy``
                                 block (paging, evictions, QoS sheds,
                                 per-tenant residency),
                                 ``deviceHealth`` (the governor's state,
                                 the watchdog bound, quarantines),
                                 ``storage``, ``storageHealth`` (disk
                                 state, quarantined fragments, scrub
                                 progress), ``costs`` (the device-cost
                                 ledger), ``slowQueries``, ``queryStages``
    GET    /metrics              Prometheus text (OpenMetrics, with trace
                                 exemplars, when Accept asks for it)
    GET    /internal/traces[?trace_id=]
                                 retained traces (sampled, slow, profiled)
    GET    /debug/slow           the slow-query ring
    GET    /debug/flight[?limit=n]
                                 the flight recorder's ring
    GET    /debug/threads        every thread's stack
    POST   /debug/profile[?seconds=s][&dir=d]
                                 a torch.profiler capture (CPU and CUDA)
                                 written as a Chrome trace under ``dir``

``?timeout=`` bounds a query (the API's ``query_timeout`` caps it; 0 means
the cap): past it the answer is 504 with a ``timeout{elapsedSeconds,
deadlineSeconds, shardsOutstanding, stage}`` body.  A query whose batcher
window was quarantined answers 500 with ``pipelineStall{stage,
elapsedSeconds}``.  A query shed by its tenant's quota answers 503 with
``Retry-After`` and a ``tenantThrottled{tenant, quota, kind}`` body; a
saturated executor answers 503 with ``Retry-After``.  A write the
storage layer refuses answers 503 ``storageFault{path, kind}`` (a
quarantined fragment) or 507 ``writeUnavailable{reason: "disk_full"}``.
A protobuf query's errors answer in protobuf with the same status.
Imports accept an ``X-Pilosa-Op-Id`` header (in a cluster, a delivery
whose id the node already applied is a no-op; a single node applies
every delivery) and ``X-Pilosa-Direct: 1``, the mark of a batch a
cluster peer already routed.  A write a cluster cannot replicate
answers 503 with ``Retry-After`` and ``writeUnavailable{op, replica,
reason}``.  Every request counts on ``http_requests_total{method,
status}`` and ``http_request_seconds{method}``; the ``server.response``
failpoint's ``drop_response`` runs the handler and drops its answer.

The cluster's routes: ``GET /metrics/cluster`` (every node's registry in
one Prometheus document, ``cluster_metrics_node_up 0`` for a node that
did not answer), ``GET /status/cluster`` (every node's ``/status``),
``GET /debug/flight?cluster=1`` (every node's flight ring), ``GET
/internal/metrics/snapshot`` and the node-to-node ``/internal/*`` of
:mod:`pilosa_tpu_torch.cluster.internal`, which answer 503 on a node
that is not clustered.  With an ``ssl_context`` the server speaks HTTPS
only.
"""

from __future__ import annotations

import json
import logging
import math
import os
import re
import socket
import sys
import threading
import time
import traceback
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from pilosa_tpu_torch import __version__, fault
from pilosa_tpu_torch.api import proto
from pilosa_tpu_torch.api.api import API, ApiError
from pilosa_tpu_torch.obs import GLOBAL_TRACER
from pilosa_tpu_torch.store.health import StorageFaultError

_log = logging.getLogger("pilosa_tpu_torch.api")


def parse_timeout_param(raw: str) -> float:
    """A ``?timeout=`` value in seconds: NaN (every deadline comparison
    False: silently unlimited) and negatives are a 400; 0 means the
    API's cap."""
    try:
        timeout = float(raw)
    except ValueError:
        timeout = None
    if timeout is None or not math.isfinite(timeout) or timeout < 0:
        raise ApiError(f"bad timeout param {raw!r}")
    return timeout


# /debug/profile capture bounds: shorter is noise, longer holds the
# profiler and the handler thread hostage
PROFILE_SECONDS_MIN = 0.1
PROFILE_SECONDS_MAX = 60.0


def clamp_profile_seconds(seconds: float) -> float:
    """Clamp a ``?seconds=`` capture window to [PROFILE_SECONDS_MIN,
    PROFILE_SECONDS_MAX]."""
    return min(max(seconds, PROFILE_SECONDS_MIN), PROFILE_SECONDS_MAX)


def _route(method: str, pattern: str, name: str):
    """A route: ``{name}`` segments match one path segment each."""
    regex = re.sub(r"\{(\w+)\}", r"(?P<\1>[^/]+)", pattern)
    return method, re.compile("^" + regex + "$"), name


class Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server_version = "pilosa-tpu-torch"
    # a connection idle this long (or stalled in a TLS handshake) is
    # dropped, reclaiming its thread
    timeout = 120
    # keep-alive replies must not wait out Nagle and the peer's delayed
    # ACK
    disable_nagle_algorithm = True

    ROUTES = [
        _route("POST", "/index/{index}/query", "h_query"),
        _route("POST", "/index/{index}/field/{field}/import", "h_import"),
        _route("POST", "/index/{index}/field/{field}/importValue",
               "h_import_value"),
        ("POST", re.compile(r"^/index/(?P<index>[^/]+)/field/"
                            r"(?P<field>[^/]+)/import-roaring/"
                            r"(?P<shard>[0-9]+)$"), "h_import_roaring"),
        _route("POST", "/index/{index}/field/{field}", "h_create_field"),
        _route("POST", "/index/{index}", "h_create_index"),
        _route("DELETE", "/index/{index}/field/{field}", "h_delete_field"),
        _route("DELETE", "/index/{index}", "h_delete_index"),
        _route("GET", "/index/{index}/field/{field}", "h_get_field"),
        _route("GET", "/index/{index}", "h_get_index"),
        _route("GET", "/export", "h_export"),
        _route("GET", "/schema", "h_schema"),
        _route("GET", "/status", "h_status"),
        _route("GET", "/info", "h_info"),
        _route("GET", "/version", "h_version"),
        _route("GET", "/metrics", "h_metrics"),
        _route("GET", "/metrics/cluster", "h_metrics_cluster"),
        _route("GET", "/status/cluster", "h_status_cluster"),
        _route("GET", "/internal/metrics/snapshot", "h_metrics_snapshot"),
        _route("GET", "/internal/traces", "h_traces"),
        _route("GET", "/debug/slow", "h_debug_slow"),
        _route("GET", "/debug/flight", "h_debug_flight"),
        _route("GET", "/debug/threads", "h_debug_threads"),
        _route("POST", "/debug/profile", "h_debug_profile"),
    ]

    # ROUTES and the cluster's /internal/* routes, built at first use
    # (the cluster's handlers import this module)
    _all_routes: list | None = None

    @classmethod
    def routes(cls) -> list:
        if cls._all_routes is None:
            from pilosa_tpu_torch.cluster.internal import \
                register_internal_routes
            routes = list(cls.ROUTES)
            register_internal_routes(routes)
            cls._all_routes = routes
        return cls._all_routes

    def log_message(self, fmt, *args):
        _log.debug("http: " + fmt, *args)

    def _body(self) -> bytes:
        # read once: every request's body is drained before its handler
        # runs, so bytes left unread cannot prefix the next request on a
        # kept-alive connection
        if not hasattr(self, "_body_cache"):
            n = int(self.headers.get("Content-Length") or 0)
            self._body_cache = self.rfile.read(n) if n else b""
        return self._body_cache

    def _json_body(self) -> dict:
        raw = self._body()
        if not raw:
            return {}
        try:
            return json.loads(raw)
        except json.JSONDecodeError as e:
            raise ApiError(f"invalid JSON body: {e}")

    def _reply(self, obj, status: int = 200, headers=None,
               content_type: str = "application/json") -> None:
        if getattr(self, "_fault_drop_response", False):
            # drop_response: the handler ran, the caller never hears
            # back (it sees a reset, and its retry is a duplicate)
            self.close_connection = True
            return
        data = obj if isinstance(obj, bytes) else json.dumps(obj).encode()
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(data)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(data)

    @property
    def query(self) -> dict:
        return urllib.parse.parse_qs(urllib.parse.urlparse(self.path).query,
                                     keep_blank_values=True)

    def _dispatch(self, method: str) -> None:
        path = urllib.parse.urlparse(self.path).path
        # one handler serves every request of a kept-alive connection
        self.__dict__.pop("_body_cache", None)
        if "chunked" in (self.headers.get("Transfer-Encoding") or "").lower():
            # only a Content-Length body can be drained
            self.close_connection = True
            self._reply({"error": "chunked transfer encoding not "
                                  "supported; send Content-Length"}, 411)
            return
        self._body()
        for m, rx, name in self.routes():
            hit = rx.match(path)
            if m == method and hit:
                break
        else:
            name = None
        self._fault_drop_response = False
        if fault.ACTIVE and name is not None:
            spec = fault.fire("server.response", method=method, path=path)
            if spec is not None and spec["action"] == "drop_response":
                self._fault_drop_response = True
        t0 = time.perf_counter()
        code = 200
        try:
            if name is None:
                code = 404
                self._reply({"error": f"no route {method} {path}"}, 404)
                return
            if callable(name):  # a cluster handler: a function of self
                name(self, **hit.groupdict())
            else:
                getattr(self, name)(**hit.groupdict())
        except (ApiError, StorageFaultError) as e:
            if isinstance(e, StorageFaultError):
                # a storage refusal from any handler: the structured
                # 503 / 507, never a generic 500
                e = ApiError.storage_fault(e)
            code = e.status
            # a shed (503) tells the client when to come back
            hdrs = (None if e.retry_after is None
                    else {"Retry-After": str(max(1, int(e.retry_after)))})
            self._reply({"error": str(e), **e.extra}, e.status, hdrs)
        except BrokenPipeError:
            code = 499  # the client left
        except Exception as e:  # noqa: BLE001 — the server must not die
            code = 500
            _log.exception("http 500: %s %s", method, path)
            try:
                self._reply({"error": f"internal error: {e}"}, 500)
            except BrokenPipeError:
                pass
        finally:
            stats = self.server.stats
            stats.count("http_requests_total", 1, method=method,
                        status=str(code))
            stats.observe("http_request_seconds", time.perf_counter() - t0,
                          method=method)

    def do_GET(self):
        self._dispatch("GET")

    def do_POST(self):
        self._dispatch("POST")

    def do_DELETE(self):
        self._dispatch("DELETE")

    @property
    def api(self) -> API:
        return self.server.api

    def _is_proto(self, header: str) -> bool:
        return proto.CONTENT_TYPE in (self.headers.get(header) or "")

    def h_query(self, index: str) -> None:
        # Content-Type picks the request's decoding, Accept the answer's
        body = self._body()
        want_proto = self._is_proto("Accept")
        if self._is_proto("Content-Type"):
            try:
                pql, shards = proto.decode_query_request(body)
            except ValueError as e:
                raise ApiError(f"bad protobuf request: {e}")
        else:
            pql, shards = body.decode(), None
        q = self.query
        if "shards" in q:
            try:
                shards = [int(s) for s in q["shards"][0].split(",") if s]
            except ValueError:
                raise ApiError(f"bad shards param {q['shards'][0]!r}")
        # as the reference parses it: a blank ``?profile`` asks nothing
        profile = any(q.get("profile", ()))
        timeout = None
        if "timeout" in q:
            timeout = parse_timeout_param(q["timeout"][0])
        if not want_proto:
            out = self.api.query(index, pql, shards=shards, profile=profile,
                                 timeout=timeout)
            # the trace id rides a header, not the body
            self._reply(out, headers={
                "X-Pilosa-Trace-Id": self.api.last_trace_id()})
            return
        if profile:
            # a QueryResponse has no profile field: refuse rather than
            # drop the span tree the caller asked for
            raise ApiError("?profile is not supported with "
                           "application/x-protobuf responses")
        # errors answer in protobuf, with the status the JSON surface
        # would give
        status = 200
        trace_id = None
        try:
            res = self.api.query(index, pql, shards=shards, timeout=timeout)
        except ApiError as e:
            raw = proto.encode_query_response(err=str(e))
            status = e.status
        else:
            trace_id = self.api.last_trace_id()
            try:
                raw = proto.encode_query_response(res["results"])
            except ValueError as e:  # a result with no protobuf encoding
                raw = proto.encode_query_response(err=str(e))
                status = 400
        self._reply(raw, status=status, content_type=proto.CONTENT_TYPE,
                    headers={"X-Pilosa-Trace-Id": trace_id}
                    if trace_id else None)

    @property
    def _op_id(self) -> str | None:
        return self.headers.get("X-Pilosa-Op-Id") or None

    @property
    def _direct(self) -> bool:
        """A batch a cluster peer already routed: apply it here."""
        return self.headers.get("X-Pilosa-Direct") == "1"

    def h_import(self, index: str, field: str) -> None:
        if self._is_proto("Content-Type"):
            try:
                b = proto.decode_import_request(self._body())
            except ValueError as e:
                raise ApiError(f"bad protobuf import: {e}")
            kw = dict(row_ids=b["row_ids"], col_ids=b["col_ids"],
                      row_keys=b["row_keys"], col_keys=b["col_keys"],
                      timestamps=b["timestamps"],
                      clear=b["clear"] or "clear" in self.query)
        else:
            b = self._json_body()
            kw = dict(row_ids=b.get("rowIDs"), col_ids=b.get("columnIDs"),
                      row_keys=b.get("rowKeys"),
                      col_keys=b.get("columnKeys"),
                      timestamps=b.get("timestamps"),
                      clear=(bool(b.get("clear", False))
                             or "clear" in self.query))
        self._reply_import(self.api.import_bits(index, field,
                                                op_id=self._op_id,
                                                direct=self._direct, **kw))

    def h_import_value(self, index: str, field: str) -> None:
        if self._is_proto("Content-Type"):
            try:
                b = proto.decode_import_value_request(self._body())
            except ValueError as e:
                raise ApiError(f"bad protobuf import: {e}")
            kw = dict(col_ids=b["col_ids"], col_keys=b["col_keys"],
                      values=b["values"])
        else:
            b = self._json_body()
            kw = dict(col_ids=b.get("columnIDs"),
                      col_keys=b.get("columnKeys"), values=b.get("values"))
        self._reply_import(self.api.import_values(index, field,
                                                  direct=self._direct, **kw))

    def _reply_import(self, changed: int) -> None:
        if self._is_proto("Accept"):
            self._reply(proto.encode_import_response(changed),
                        content_type=proto.CONTENT_TYPE)
        else:
            self._reply({"changed": changed})

    def h_import_roaring(self, index: str, field: str, shard: str) -> None:
        view = self.query.get("view", ["standard"])[0]
        changed = self.api.import_roaring(index, field, int(shard),
                                          self._body(), view=view,
                                          clear="clear" in self.query,
                                          op_id=self._op_id,
                                          direct=self._direct)
        self._reply({"changed": changed})

    def h_create_index(self, index: str) -> None:
        self.api.create_index(index, self._json_body().get("options"))
        self._reply({"success": True})

    def h_create_field(self, index: str, field: str) -> None:
        self.api.create_field(index, field,
                              self._json_body().get("options"))
        self._reply({"success": True})

    def h_delete_index(self, index: str) -> None:
        self.api.delete_index(index)
        self._reply({"success": True})

    def h_delete_field(self, index: str, field: str) -> None:
        self.api.delete_field(index, field)
        self._reply({"success": True})

    def h_get_index(self, index: str) -> None:
        for spec in self.api.schema():
            if spec["name"] == index:
                self._reply(spec)
                return
        raise ApiError(f"index {index!r} not found", 404)

    def h_get_field(self, index: str, field: str) -> None:
        for spec in self.api.schema():
            if spec["name"] == index:
                for f in spec["fields"]:
                    if f["name"] == field:
                        self._reply(f)
                        return
                raise ApiError(f"field {field!r} not found", 404)
        raise ApiError(f"index {index!r} not found", 404)

    def h_export(self) -> None:
        q = self.query
        index = q.get("index", [None])[0]
        field = q.get("field", [None])[0]
        if not index or not field:
            raise ApiError("export requires ?index= and ?field=")
        self._reply(self.api.export_csv(index, field).encode(),
                    content_type="text/csv")

    def h_schema(self) -> None:
        self._reply({"indexes": self.api.schema()})

    def h_status(self) -> None:
        self._reply(self.api.status())

    def h_info(self) -> None:
        self._reply(self.api.info())

    def h_version(self) -> None:
        self._reply({"version": __version__})

    def _refresh_scrape_gauges(self) -> None:
        """Point-in-time gauges, refreshed at each scrape: the plane
        cache's residency, the overlays, the plan cache, the batcher's
        window, the governor, the admission slots, the storage footprint
        and the disk governor."""
        stats = self.server.stats
        ex = self.api.executor
        pc = ex.planes.stats()
        stats.gauge("plane_cache_bytes", pc["bytes"])
        stats.gauge("plane_cache_budget_bytes", pc["budgetBytes"])
        stats.gauge("plane_cache_entries", pc["entries"])
        stats.gauge("plane_cache_incremental_refreshes",
                    pc["incrementalRefreshes"])
        stats.gauge("plane_cache_pinned_entries", pc["pinnedEntries"])
        stats.gauge("plane_lease_count", pc["leases"])
        stats.gauge("plane_cache_hit_ratio", pc["hitRatio"])
        stats.gauge("delta_overlay_bits",
                    ex.planes.delta_stats()["deltaOverlayBits"])
        stats.gauge("plan_cache_entries", ex.serving_stats()["plans"])
        if ex.batcher is not None:
            stats.gauge("count_batcher_window_seconds", ex.batcher._win)
        stats.gauge("device_health_state", ex.device_health()["stateCode"])
        stats.gauge("query_slots_in_use", ex.slots_in_use)
        stats.gauge("query_slots_max", ex.max_concurrent)
        st = self.api.storage_stats()
        stats.gauge("oplog_bytes", st["oplogBytes"])
        stats.gauge("fragment_count", st["fragmentCount"])
        stats.gauge("snapshot_bytes", st["snapshotBytes"])
        pay = self.api.holder.storage_health.payload()
        stats.gauge("disk_health_state", pay["stateCode"])
        stats.gauge("storage_fragment_quarantined", len(pay["quarantined"]))

    # the only exposition format in which exemplars are legal
    OPENMETRICS_TYPE = "application/openmetrics-text"

    def h_metrics(self) -> None:
        self._refresh_scrape_gauges()
        om = self.OPENMETRICS_TYPE in (self.headers.get("Accept") or "")
        text = self.server.stats.prometheus_text(openmetrics=om)
        self._reply(text.encode(),
                    content_type=(self.OPENMETRICS_TYPE
                                  + "; version=1.0.0; charset=utf-8"
                                  if om else "text/plain; version=0.0.4"))

    def _full_snapshot(self) -> dict:
        """This node's registry for the cluster fan-in, its scrape-time
        gauges refreshed first."""
        self._refresh_scrape_gauges()
        return self.server.stats.full_snapshot()

    def h_metrics_snapshot(self) -> None:
        """The node-to-node leg of ``/metrics/cluster``: the whole registry
        as JSON (histograms with raw bucket counts)."""
        cluster = self.api.cluster
        self._reply({
            "node": cluster.node_id if cluster is not None else "local",
            "snapshot": self._full_snapshot()})

    def h_metrics_cluster(self) -> None:
        """One Prometheus document for the fleet: live peers' registries
        (breaker-aware) merged with this node's; a node that did not
        answer is a ``cluster_metrics_node_up 0`` row and named in
        ``X-Pilosa-Stale-Nodes``, never an error."""
        from pilosa_tpu_torch.obs.metrics import render_cluster_metrics
        local = self._full_snapshot()
        cluster = self.api.cluster
        if cluster is None:
            snaps, stale = {"local": local}, []
        else:
            snaps, stale = cluster.metrics_snapshots()
            snaps[cluster.node_id] = local
        self._reply(render_cluster_metrics(snaps, stale).encode(),
                    content_type="text/plain; version=0.0.4",
                    headers=({"X-Pilosa-Stale-Nodes": ",".join(stale)}
                             if stale else None))

    def h_status_cluster(self) -> None:
        """Every node's ``/status`` keyed by node id, with the nodes that
        did not answer in ``staleNodes``."""
        local = self.api.status()
        cluster = self.api.cluster
        if cluster is None:
            self._reply({"nodes": {"local": local}, "staleNodes": []})
            return
        snaps, stale = cluster.status_snapshots()
        snaps[cluster.node_id] = local
        self._reply({"nodes": snaps, "staleNodes": stale,
                     "coordinator": cluster.coordinator_id()})

    def h_traces(self) -> None:
        """Retained traces (sampled, slow, profiled); ``?trace_id=``
        narrows to one."""
        spans = GLOBAL_TRACER.finished()
        want = self.query.get("trace_id", [None])[0]
        if want:
            spans = [sp for sp in spans if sp.trace_id == want]
        self._reply({"traces": [sp.to_json() for sp in spans]})

    def h_debug_slow(self) -> None:
        api = self.api
        self._reply({"thresholdSeconds": api.slow_query_threshold,
                     **api.slow_log.summary(),
                     "slow": api.slow_log.entries()})

    def h_debug_flight(self) -> None:
        """The flight recorder's ring, oldest first; ``?limit=`` keeps
        the newest N events; ``?cluster=1`` answers every node's ring
        (``/status/cluster``'s contract)."""
        raw = self.query.get("limit", ["0"])[0]
        try:
            limit = int(raw)
        except ValueError:
            raise ApiError(f"bad limit param {raw!r}")
        local = self.api.executor.flight.snapshot(limit=limit or None)
        if self.query.get("cluster", ["0"])[0] not in ("1", "true"):
            self._reply(local)
            return
        cluster = self.api.cluster
        if cluster is None:
            self._reply({"nodes": {"local": local}, "staleNodes": []})
            return
        snaps, stale = cluster.flight_snapshots(limit=limit)
        snaps[cluster.node_id] = local
        self._reply({"nodes": snaps, "staleNodes": stale})

    def h_debug_threads(self) -> None:
        """Every thread's Python stack."""
        names = {t.ident: t.name for t in threading.enumerate()}
        out = []
        for ident, frame in sys._current_frames().items():
            out.append(f"Thread {names.get(ident, '?')} ({ident}):")
            out.extend(line.rstrip()
                       for line in traceback.format_stack(frame))
            out.append("")
        self._reply("\n".join(out).encode(), content_type="text/plain")

    def h_debug_profile(self) -> None:
        """A ``torch.profiler`` capture (CPU, and CUDA on a card) of
        ``?seconds=`` (default 3, clamped) written as a Chrome trace into
        ``?dir=`` (default ``<data dir>/_profiles``).  A capture slows
        what runs under it and the burst after it."""
        import torch
        from torch.profiler import ProfilerActivity, profile
        raw = self.query.get("seconds", ["3"])[0]
        try:
            seconds = float(raw)
        except ValueError:
            raise ApiError(f"bad seconds param {raw!r}")
        if not math.isfinite(seconds):
            raise ApiError(f"bad seconds param {raw!r}")
        seconds = clamp_profile_seconds(seconds)
        out_dir = (self.query.get("dir", [None])[0]
                   or os.path.join(self.api.holder.path, "_profiles"))
        acts = [ProfilerActivity.CPU]
        if self.api.executor.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            time.sleep(seconds)
            if self.api.executor.device.type == "cuda":
                torch.cuda.synchronize(self.api.executor.device)
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, f"trace-{int(time.time() * 1e3)}.json")
        prof.export_chrome_trace(path)
        self._reply({"traceDir": out_dir, "seconds": seconds,
                     "traceFile": path})


class _HTTPServer(ThreadingHTTPServer):
    """Tracks its connections so ``close`` can sever them: with HTTP/1.1
    keep-alive, ``shutdown()`` only stops the accept loop, and handler
    threads parked on persistent connections would keep answering."""

    daemon_threads = True
    request_queue_size = 64

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self._conns: set = set()
        self._conns_lock = threading.Lock()

    def process_request(self, request, client_address):
        with self._conns_lock:
            self._conns.add(request)
        super().process_request(request, client_address)

    def shutdown_request(self, request):
        with self._conns_lock:
            self._conns.discard(request)
        super().shutdown_request(request)

    def close_all_connections(self) -> None:
        with self._conns_lock:
            conns = list(self._conns)
        for s in conns:
            try:
                s.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                s.close()
            except OSError:
                pass

    def handle_error(self, request, client_address):
        # failed TLS handshakes (plaintext probes) and client disconnects
        # are one connection's noise, not server errors
        import sys
        exc = sys.exc_info()[1]
        if isinstance(exc, OSError):  # ssl.SSLError and resets included
            _log.debug("http connection error from %s: %r",
                       client_address, exc)
            return
        super().handle_error(request, client_address)


class Server:
    """HTTP server with ``serve_forever`` on a background thread; HTTPS
    with an ``ssl_context`` (:func:`pilosa_tpu_torch.api.tls.
    server_context`)."""

    def __init__(self, api: API, host: str = "127.0.0.1", port: int = 10101,
                 ssl_context=None, stats=None):
        self.httpd = _HTTPServer((host, port), Handler)
        # the registry /metrics renders and the http_* families count
        # on: the executor's unless another is given
        self.httpd.stats = stats if stats is not None else api.executor.stats
        if ssl_context is not None:
            # the handshake runs on the connection's own thread at its
            # first read, not in the accept loop: a client that connects
            # and never sends a ClientHello cannot wedge accept()
            self.httpd.socket = ssl_context.wrap_socket(
                self.httpd.socket, server_side=True,
                do_handshake_on_connect=False)
        self.httpd.api = api
        self._thread: threading.Thread | None = None

    @property
    def address(self) -> tuple[str, int]:
        return self.httpd.server_address[:2]

    def start(self) -> "Server":
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        name="pilosa-torch-http",
                                        daemon=True)
        self._thread.start()
        return self

    def serve_forever(self) -> None:
        self.httpd.serve_forever()

    def close(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        self.httpd.close_all_connections()
        if self._thread is not None:
            self._thread.join(timeout=5)
