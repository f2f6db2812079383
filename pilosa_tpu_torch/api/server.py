"""Threaded REST server over the API.

Routes (the single-node surface of ``pilosa_tpu.api.server``; the query
and import endpoints negotiate JSON or ``application/x-protobuf``)::

    POST   /index/{i}/query[?timeout=s][&shards=a,b]
                                 PQL body (or a protobuf QueryRequest)
                                 -> {"results": [...]} (a protobuf
                                 QueryResponse when Accept asks for one)
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
                                 the watchdog bound, quarantines) and
                                 ``storage``

``?timeout=`` bounds a query (the API's ``query_timeout`` caps it; 0 means
the cap): past it the answer is 504 with a ``timeout{elapsedSeconds,
deadlineSeconds, shardsOutstanding, stage}`` body.  A query whose batcher
window was quarantined answers 500 with ``pipelineStall{stage,
elapsedSeconds}``.  A query shed by its tenant's quota answers 503 with
``Retry-After`` and a ``tenantThrottled{tenant, quota, kind}`` body; a
saturated executor answers 503 with ``Retry-After``.  A protobuf query's
errors answer in protobuf with the same status.  Imports accept an
``X-Pilosa-Op-Id`` header and, on a single node, apply every delivery.

The reference's ``/metrics``, ``/debug/*``, ``/internal/*`` and
``?profile`` are not served yet: they answer 404, and ``?profile`` the
"not supported by this port" 400.  With an ``ssl_context`` the server
speaks HTTPS only.
"""

from __future__ import annotations

import json
import logging
import math
import re
import socket
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from pilosa_tpu_torch import __version__
from pilosa_tpu_torch.api import proto
from pilosa_tpu_torch.api.api import API, ApiError

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
    ]

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
        for m, rx, name in self.ROUTES:
            hit = rx.match(path)
            if m == method and hit:
                break
        else:
            self._reply({"error": f"no route {method} {path}"}, 404)
            return
        try:
            getattr(self, name)(**hit.groupdict())
        except ApiError as e:
            # a shed (503) tells the client when to come back
            hdrs = (None if e.retry_after is None
                    else {"Retry-After": str(max(1, int(e.retry_after)))})
            self._reply({"error": str(e), **e.extra}, e.status, hdrs)
        except BrokenPipeError:
            pass  # the client left
        except Exception as e:  # noqa: BLE001 — the server must not die
            _log.exception("http 500: %s %s", method, path)
            try:
                self._reply({"error": f"internal error: {e}"}, 500)
            except BrokenPipeError:
                pass

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
        if "profile" in q:
            raise ApiError("?profile is not supported by this port (it has "
                           "no tracer yet)")
        timeout = None
        if "timeout" in q:
            timeout = parse_timeout_param(q["timeout"][0])
        if not want_proto:
            self._reply(self.api.query(index, pql, shards=shards,
                                       timeout=timeout))
            return
        # errors answer in protobuf, with the status the JSON surface
        # would give
        status = 200
        try:
            res = self.api.query(index, pql, shards=shards, timeout=timeout)
        except ApiError as e:
            raw = proto.encode_query_response(err=str(e))
            status = e.status
        else:
            try:
                raw = proto.encode_query_response(res["results"])
            except ValueError as e:  # a result with no protobuf encoding
                raw = proto.encode_query_response(err=str(e))
                status = 400
        self._reply(raw, status=status, content_type=proto.CONTENT_TYPE)

    @property
    def _op_id(self) -> str | None:
        return self.headers.get("X-Pilosa-Op-Id") or None

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
                                                op_id=self._op_id, **kw))

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
        self._reply_import(self.api.import_values(index, field, **kw))

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
                                          op_id=self._op_id)
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
                 ssl_context=None):
        self.httpd = _HTTPServer((host, port), Handler)
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
