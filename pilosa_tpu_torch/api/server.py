"""Threaded REST server over the API.

Routes (the surface of ``pilosa_tpu.api.server`` for this port's calls;
the query and import endpoints negotiate JSON or
``application/x-protobuf``)::

    POST /index/{i}/query[?timeout=s][&shards=a,b]
                                 PQL body (or a protobuf QueryRequest)
                                 -> {"results": [...]} (a protobuf
                                 QueryResponse when Accept asks for one)
    POST /index/{i}/field/{f}/import
                                 JSON {"rowIDs" | "rowKeys",
                                 "columnIDs" | "columnKeys",
                                 "timestamps", "clear"} or a protobuf
                                 ImportRequest -> {"changed": n}
    POST /index/{i}/field/{f}/importValue
                                 JSON {"columnIDs" | "columnKeys",
                                 "values"} or a protobuf
                                 ImportValueRequest into a BSI field
                                 -> {"changed": n}
    POST /index/{i}/field/{f}/import-roaring/{shard}[?clear]
                                 roaring body -> {"changed": n}
    POST /index/{i}              create index
    POST /index/{i}/field/{f}    create field
    GET  /schema                 {"indexes": [...]}
    GET  /status                 state, the torch device serving, the
                                 ``batcher`` block (windows, items,
                                 fast-lane hits, current window, plan
                                 cache hits and misses) and the
                                 ``ingest`` block (overlay fill,
                                 absorbs, compactions, imported bits),
                                 ``timeViews`` and the ``tenancy``
                                 block (paging, evictions, QoS sheds,
                                 per-tenant residency) and
                                 ``deviceHealth`` (the governor's state,
                                 the watchdog bound, quarantines)

``?timeout=`` bounds a query (the API's ``query_timeout`` caps it; 0 means
the cap): past it the answer is 504 with a ``timeout{elapsedSeconds,
deadlineSeconds, shardsOutstanding, stage}`` body.  A query whose batcher
window was quarantined answers 500 with ``pipelineStall{stage,
elapsedSeconds}``.  A query shed by its tenant's quota answers 503 with
``Retry-After`` and a ``tenantThrottled{tenant, quota, kind}`` body; a
saturated executor answers 503 with ``Retry-After``.  A protobuf query's
errors answer in protobuf with the same status.  Imports accept an
``X-Pilosa-Op-Id`` header and, on a single node, apply every delivery.
"""

from __future__ import annotations

import json
import math
import re
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from pilosa_tpu_torch.api import proto
from pilosa_tpu_torch.api.api import API, ApiError


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


class Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server_version = "pilosa-tpu-torch"
    timeout = 120

    ROUTES = [
        ("POST", re.compile(r"^/index/(?P<index>[^/]+)/query$"), "h_query"),
        ("POST", re.compile(r"^/index/(?P<index>[^/]+)/field/"
                            r"(?P<field>[^/]+)/import$"), "h_import"),
        ("POST", re.compile(r"^/index/(?P<index>[^/]+)/field/"
                            r"(?P<field>[^/]+)/importValue$"),
         "h_import_value"),
        ("POST", re.compile(r"^/index/(?P<index>[^/]+)/field/"
                            r"(?P<field>[^/]+)/import-roaring/"
                            r"(?P<shard>[0-9]+)$"), "h_import_roaring"),
        ("POST", re.compile(r"^/index/(?P<index>[^/]+)/field/"
                            r"(?P<field>[^/]+)$"), "h_create_field"),
        ("POST", re.compile(r"^/index/(?P<index>[^/]+)$"), "h_create_index"),
        ("GET", re.compile(r"^/schema$"), "h_schema"),
        ("GET", re.compile(r"^/status$"), "h_status"),
    ]

    def log_message(self, fmt, *args):
        pass  # requests are not logged

    def _body(self) -> bytes:
        n = int(self.headers.get("Content-Length") or 0)
        return self.rfile.read(n) if n else b""

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
        for m, rx, name in self.ROUTES:
            hit = rx.match(path)
            if m == method and hit:
                break
        else:
            self._body()
            self._reply({"error": f"no route {method} {path}"}, 404)
            return
        try:
            getattr(self, name)(**hit.groupdict())
        except ApiError as e:
            # a shed (503) tells the client when to come back
            hdrs = (None if e.retry_after is None
                    else {"Retry-After": str(max(1, int(e.retry_after)))})
            self._reply({"error": str(e), **e.extra}, e.status, hdrs)
        except Exception as e:  # noqa: BLE001 — the server must not die
            self._reply({"error": f"internal error: {e}"}, 500)

    def do_GET(self):
        self._dispatch("GET")

    def do_POST(self):
        self._dispatch("POST")

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

    def h_schema(self) -> None:
        self._reply({"indexes": self.api.schema()})

    def h_status(self) -> None:
        self._reply(self.api.status())


class Server:
    """HTTP server with ``serve_forever`` on a background thread."""

    def __init__(self, api: API, host: str = "127.0.0.1", port: int = 10101):
        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.httpd.daemon_threads = True
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
        if self._thread is not None:
            self._thread.join(timeout=5)
