"""Threaded REST server over the API.

Routes (the JSON surface of ``pilosa_tpu.api.server`` for this port's
calls)::

    POST /index/{i}/query        PQL body -> {"results": [...]}
    POST /index/{i}/field/{f}/import
                                 JSON {"rowIDs" | "rowKeys",
                                 "columnIDs" | "columnKeys",
                                 "timestamps", "clear"} -> {"changed": n}
    POST /index/{i}/field/{f}/importValue
                                 JSON {"columnIDs" | "columnKeys",
                                 "values"} into a BSI field
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
                                 per-tenant residency)

A query shed by its tenant's quota answers 503 with ``Retry-After`` and a
``tenantThrottled{tenant, quota, kind}`` body; a saturated executor
answers 503 with ``Retry-After``.
"""

from __future__ import annotations

import json
import re
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from pilosa_tpu_torch.api.api import API, ApiError


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

    def _reply(self, obj, status: int = 200, headers=None) -> None:
        data = json.dumps(obj).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
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

    def h_query(self, index: str) -> None:
        self._reply(self.api.query(index, self._body().decode()))

    def _refuse_protobuf(self) -> None:
        if "protobuf" in (self.headers.get("Content-Type") or ""):
            self._body()
            raise ApiError("protobuf import bodies are not supported by "
                           "this port", 415)

    def h_import(self, index: str, field: str) -> None:
        self._refuse_protobuf()
        b = self._json_body()
        changed = self.api.import_bits(
            index, field, row_ids=b.get("rowIDs"),
            col_ids=b.get("columnIDs"), row_keys=b.get("rowKeys"),
            col_keys=b.get("columnKeys"), timestamps=b.get("timestamps"),
            clear=bool(b.get("clear", False)) or "clear" in self.query,
            op_id=self.headers.get("X-Pilosa-Op-Id") or None)
        self._reply({"changed": changed})

    def h_import_value(self, index: str, field: str) -> None:
        self._refuse_protobuf()
        b = self._json_body()
        changed = self.api.import_values(
            index, field, col_ids=b.get("columnIDs"),
            col_keys=b.get("columnKeys"), values=b.get("values"))
        self._reply({"changed": changed})

    def h_import_roaring(self, index: str, field: str, shard: str) -> None:
        view = self.query.get("view", ["standard"])[0]
        changed = self.api.import_roaring(index, field, int(shard),
                                          self._body(), view=view,
                                          clear="clear" in self.query)
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
