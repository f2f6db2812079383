"""HTTP client for the REST surface (``pilosa_tpu.api.client``'s): the
CLI's import, export and introspection commands, and any external caller.
stdlib ``http.client``; no external dependency.

Retry policy: a failure in the SEND phase (``CannotSendRequest``: the
request never left this process) always retries once on a fresh
connection.  A failure AFTER the request was sent (``BadStatusLine``, a
reset, a broken pipe: the response was lost, but the server may already
have applied the request) retries only an idempotent request: a safe
method (GET/HEAD/PUT/DELETE), or a POST on a client made with
``idempotent_posts=True``.  A default client never retries a
possibly-delivered POST: ``query`` can carry writes (``Set(...)``) and
imports are not exactly-once.

Fault sites (:mod:`pilosa_tpu_torch.fault`): ``client.send`` before the
request leaves (``partition``: the server is unreachable) and
``client.recv`` after it was sent (``drop``: the response is lost).
"""

from __future__ import annotations

import http.client
import json
import ssl
import threading
import urllib.parse

from pilosa_tpu_torch import fault


class ClientError(Exception):
    """Transport or HTTP failure.

    ``kind`` distinguishes failure classes that a caller handles
    differently:

    - ``"http"``       — the peer answered with an error status
    - ``"unreachable"`` — connection refused/reset/DNS: the peer never
      saw the request, so a write definitely did NOT apply
    - ``"timeout"``    — the socket timed out AFTER the request was
      sent: the peer may still apply it → replica state is UNKNOWN,
      which is NOT the same as "down"
    - ``"transport"``  — other transport faults (TLS alerts, …)
    """

    def __init__(self, msg: str, status: int = 0, kind: str = "transport"):
        super().__init__(msg)
        self.status = status
        self.kind = kind if status == 0 else "http"


class Client:
    """Persistent-connection HTTP client.  Each request checks a
    keep-alive connection out of a small idle pool (concurrent callers
    each get their own; at most ``MAX_IDLE`` are kept), so a request
    pays no TCP (or TLS) handshake of its own."""

    MAX_IDLE = 8

    # methods whose retry after a lost response cannot double-apply
    IDEMPOTENT_METHODS = frozenset({"GET", "HEAD", "PUT", "DELETE"})

    def __init__(self, host: str = "127.0.0.1", port: int = 10101,
                 timeout: float = 60.0, ssl_context=None,
                 idempotent_posts: bool = False):
        scheme = "https" if ssl_context is not None else "http"
        self.base = f"{scheme}://{host}:{port}"
        self.host, self.port = host, port
        self.timeout = timeout
        # True ONLY when every POST this client sends is idempotent:
        # enables the stale-socket retry for POSTs whose response was
        # lost after the server may have applied them (module docstring)
        self.idempotent_posts = idempotent_posts
        self._ssl = ssl_context
        self._idle: list[http.client.HTTPConnection] = []
        self._plock = threading.Lock()
        # per-thread flag: did the LAST completed request on this
        # thread go through a retry?
        self._tls = threading.local()

    # -- transport ----------------------------------------------------------

    def _checkout(self, timeout: float, fresh: bool = False):
        """An idle keep-alive connection, or a freshly-connected one.
        A pooled socket may be stale (server restarted / idle-closed),
        so ``_do`` retries stale errors once with ``fresh=True``, which
        bypasses and drains the pool — every idle socket predates the
        failure and is equally suspect."""
        if fresh:
            self.close()
        else:
            with self._plock:
                if self._idle:
                    conn = self._idle.pop()
                    if conn.sock is not None:
                        conn.sock.settimeout(timeout)
                    return conn
        cls = http.client.HTTPConnection
        kw = {}
        if self._ssl is not None:
            cls, kw = http.client.HTTPSConnection, {"context": self._ssl}
        conn = cls(self.host, self.port, timeout=timeout, **kw)
        try:
            conn.connect()
        except TimeoutError as e:
            # CONNECT timeout: not one byte of the request was sent, so
            # this is "unreachable" (a write definitely did not apply),
            # NOT the state-unknown "timeout" class — that kind is
            # reserved for sockets that time out AFTER the request left
            # (the peer may still be processing it)
            raise ClientError(f"cannot reach {self.base}: connect timed "
                              f"out: {e}", kind="unreachable") from e
        except OSError as e:
            # refused / DNS / TLS-handshake rejection: the request was
            # never delivered — a write definitely did not apply
            raise ClientError(f"cannot reach {self.base}: {e}",
                              kind="unreachable") from e
        # no Nagle: request writes on a kept-alive socket must not wait
        # out the server's delayed ACK (mirror of the server setting)
        import socket
        conn.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return conn

    def _checkin(self, conn) -> None:
        with self._plock:
            if len(self._idle) < self.MAX_IDLE:
                self._idle.append(conn)
                return
        conn.close()

    def close(self) -> None:
        """Drop idle pooled connections (new requests reconnect)."""
        with self._plock:
            idle, self._idle = self._idle, []
        for conn in idle:
            conn.close()

    def _do(self, method: str, path: str, body: bytes | None = None,
            content_type: str = "application/json",
            headers: dict | None = None, _retried: bool = False,
            timeout: float | None = None):
        hdrs = dict(headers or {})
        if body:
            hdrs["Content-Type"] = content_type
        if not _retried:
            self._tls.retried = False
        if fault.ACTIVE:
            # failpoint BEFORE the socket: a partitioned peer is
            # indistinguishable from connection-refused (the request
            # was never delivered — kind="unreachable", exactly the
            # class write replication may safely skip best-effort)
            spec = fault.fire("client.send",
                              peer=f"{self.host}:{self.port}",
                              method=method, path=path)
            if spec is not None and spec["action"] == "partition":
                raise ClientError(
                    f"cannot reach {self.base}: injected partition",
                    kind="unreachable")
        t = self.timeout if timeout is None else timeout
        conn = self._checkout(t, fresh=_retried)
        try:
            conn.request(method, path, body=body, headers=hdrs)
            if fault.ACTIVE:
                # failpoint AFTER the request left: losing the response
                # here exercises the at-least-once retry contract — the
                # peer HAS processed the request (raised inside the try
                # so the reset takes the real lost-response path below)
                spec = fault.fire("client.recv",
                                  peer=f"{self.host}:{self.port}",
                                  method=method, path=path)
                if spec is not None and spec["action"] == "drop":
                    raise ConnectionResetError(
                        "injected response drop (request was sent)")
            resp = conn.getresponse()
            data = resp.read()
        except http.client.CannotSendRequest as e:
            # SEND-phase failure: the request never left this process —
            # always safe to retry once on a fresh connection
            conn.close()
            if not _retried:
                if hasattr(body, "seek"):
                    body.seek(0)  # streamed (file-object) bodies rewind
                self._tls.retried = True
                return self._do(method, path, body, content_type, headers,
                                _retried=True, timeout=timeout)
            raise ClientError(f"connection reset by {self.base}",
                              kind="unreachable") from e
        except (http.client.BadStatusLine, http.client.IncompleteRead,
                ConnectionResetError, BrokenPipeError) as e:
            # the response was lost AFTER the request was sent (a peer
            # dying mid-response-write surfaces as IncompleteRead, not
            # a reset): the peer may already have processed it, so an
            # automatic retry is at-least-once.  Retry only idempotent
            # requests (safe methods, or POSTs of an idempotent_posts
            # client); a default client surfaces the error and lets the
            # caller decide (module docstring)
            conn.close()
            idempotent = (method in self.IDEMPOTENT_METHODS
                          or self.idempotent_posts)
            if idempotent and not _retried:
                if hasattr(body, "seek"):
                    body.seek(0)  # streamed (file-object) bodies rewind
                self._tls.retried = True
                return self._do(method, path, body, content_type, headers,
                                _retried=True, timeout=timeout)
            raise ClientError(f"connection reset by {self.base}",
                              kind="unreachable") from e
        except TimeoutError as e:
            # read timeout after the request was sent (socket.timeout is
            # TimeoutError since 3.10): the peer may still apply a write
            conn.close()
            raise ClientError(
                f"request to {self.base} timed out", kind="timeout") from e
        except ssl.SSLError as e:
            # TLS alerts (e.g. mTLS 'certificate required') surfacing
            # mid-request, after the handshake
            conn.close()
            raise ClientError(f"transport error from {self.base}: {e}") \
                from e
        except OSError as e:
            conn.close()
            raise ClientError(f"cannot reach {self.base}: {e}",
                              kind="unreachable") from e
        status = resp.status
        ctype = resp.headers.get("Content-Type", "")
        if resp.will_close:
            conn.close()
        else:
            self._checkin(conn)
        if status >= 400:
            detail = data.decode(errors="replace")
            try:
                detail = json.loads(detail).get("error", detail)
            except json.JSONDecodeError:
                pass
            raise ClientError(detail, status)
        if ctype.startswith("application/json"):
            return json.loads(data)
        return data

    def last_retried(self) -> bool:
        """Whether the most recent ``_do`` on THIS thread retried (lost
        response redelivered / stale socket resent)."""
        return getattr(self._tls, "retried", False)

    # streamed-download read size: bounds peak memory per transfer (a
    # multi-GB fragment image never materializes as one bytes object)
    DOWNLOAD_CHUNK = 1 << 20

    def download(self, path: str, sink, chunk_size: int | None = None,
                 timeout: float | None = None,
                 _retried: bool = False) -> dict:
        """Stream a GET response body into ``sink`` (anything with
        ``write(bytes)``) in bounded chunks; returns the response
        headers as a plain dict (``Content-Length``,
        ``X-Content-SHA256``, …) so callers can verify digests they
        computed while writing.

        Retry contract: GET is idempotent, so a stale pooled socket
        retries once — but only while ZERO body bytes have reached the
        sink (a mid-body retry would duplicate the prefix; callers
        that want mid-body recovery restart the whole transfer, e.g.
        against another replica)."""
        chunk_size = chunk_size or self.DOWNLOAD_CHUNK
        t = self.timeout if timeout is None else timeout
        conn = self._checkout(t, fresh=_retried)
        wrote = 0
        try:
            conn.request("GET", path)
            resp = conn.getresponse()
            if resp.status >= 400:
                data = resp.read()
                if resp.will_close:
                    conn.close()
                else:
                    self._checkin(conn)
                detail = data.decode(errors="replace")
                try:
                    detail = json.loads(detail).get("error", detail)
                except json.JSONDecodeError:
                    pass
                raise ClientError(detail, resp.status)
            while True:
                chunk = resp.read(chunk_size)
                if not chunk:
                    break
                sink.write(chunk)
                wrote += len(chunk)
        except (http.client.CannotSendRequest, http.client.BadStatusLine,
                http.client.IncompleteRead, ConnectionResetError,
                BrokenPipeError) as e:
            conn.close()
            if not _retried and wrote == 0:
                return self.download(path, sink, chunk_size,
                                     timeout=timeout, _retried=True)
            raise ClientError(f"connection reset by {self.base}",
                              kind="unreachable") from e
        except TimeoutError as e:
            conn.close()
            raise ClientError(f"request to {self.base} timed out",
                              kind="timeout") from e
        except OSError as e:
            conn.close()
            raise ClientError(f"cannot reach {self.base}: {e}",
                              kind="unreachable") from e
        headers = dict(resp.headers.items())
        if resp.will_close:
            conn.close()
        else:
            self._checkin(conn)
        clen = headers.get("Content-Length")
        if clen is not None and int(clen) != wrote:
            raise ClientError(
                f"short read from {self.base}{path}: got {wrote} of "
                f"{clen} bytes", kind="transport")
        return headers

    def _json(self, method: str, path: str, obj=None,
              headers: dict | None = None):
        body = json.dumps(obj).encode() if obj is not None else None
        return self._do(method, path, body, headers=headers)

    # -- api ----------------------------------------------------------------

    def query(self, index: str, pql: str, shards: list[int] | None = None):
        path = f"/index/{index}/query"
        if shards:
            path += "?shards=" + ",".join(str(s) for s in shards)
        return self._do("POST", path, pql.encode())["results"]

    def create_index(self, name: str, options: dict | None = None):
        return self._json("POST", f"/index/{name}",
                          {"options": options or {}})

    def delete_index(self, name: str):
        return self._json("DELETE", f"/index/{name}")

    def create_field(self, index: str, name: str,
                     options: dict | None = None):
        getattr(self, "_field_type_cache", {}).pop((index, name), None)
        return self._json("POST", f"/index/{index}/field/{name}",
                          {"options": options or {}})

    def delete_field(self, index: str, name: str):
        getattr(self, "_field_type_cache", {}).pop((index, name), None)
        return self._json("DELETE", f"/index/{index}/field/{name}")

    # auto-roaring import: ID-form batches whose pairs concentrate per
    # shard serialize client-side and ride the import-roaring path;
    # scattered batches keep the pair wire, where per-shard HTTP round
    # trips would dominate
    ROARING_MIN_PER_SHARD = 4096

    def import_bits(self, index: str, field: str, **body):
        """Bulk bit import; dense ID-form batches ride the roaring
        bulk path (see ROARING_MIN_PER_SHARD), other batches the
        protobuf wire when the codec accepts them (smaller and cheaper
        to encode than JSON), falling back to JSON otherwise (heterogeneous timestamp lists, out-of-range
        ints)."""
        from pilosa_tpu_torch.api import proto

        if (body.get("rowIDs") is not None
                and body.get("columnIDs") is not None
                and not body.get("rowKeys")
                and not body.get("columnKeys")
                and body.get("timestamps") is None
                and not body.get("clear", False)):
            out = self._try_import_roaring(index, field, body["rowIDs"],
                                           body["columnIDs"])
            if out is not None:
                return out
        try:
            raw = proto.encode_import_request(
                row_ids=body.get("rowIDs"), col_ids=body.get("columnIDs"),
                row_keys=body.get("rowKeys"),
                col_keys=body.get("columnKeys"),
                timestamps=body.get("timestamps"),
                clear=bool(body.get("clear", False)))
        except ValueError:
            return self._json(
                "POST", f"/index/{index}/field/{field}/import",
                body)["changed"]
        return self._do("POST", f"/index/{index}/field/{field}/import",
                        raw, content_type=proto.CONTENT_TYPE)["changed"]

    def import_values(self, index: str, field: str, **body):
        from pilosa_tpu_torch.api import proto
        try:
            raw = proto.encode_import_value_request(
                col_ids=body.get("columnIDs"),
                col_keys=body.get("columnKeys"),
                values=body.get("values"))
        except ValueError:
            return self._json(
                "POST", f"/index/{index}/field/{field}/importValue",
                body)["changed"]
        return self._do("POST",
                        f"/index/{index}/field/{field}/importValue",
                        raw, content_type=proto.CONTENT_TYPE)["changed"]

    def _try_import_roaring(self, index: str, field: str, row_ids,
                            col_ids) -> int | None:
        """Serialize an ID-form batch into per-shard roaring blobs and
        import each — or return None to fall through to the pair wire:
        when the batch is too scattered (per-shard HTTP round trips
        would cost more than the wire saves), when ids don't fit
        uint64, or when the target is not a set/time field (raw
        fragment unions skip mutex/bool/BSI semantics — the server
        rejects those too).

        Unlike the single-request pair/proto wire, this path commits
        one request PER SHARD: a failure partway leaves earlier shards
        applied.  The raised ClientError carries the bits already
        committed as ``partial_changed`` — set-bit imports are
        idempotent, so retrying the whole batch is always safe."""
        import numpy as np

        from pilosa_tpu_torch.engine.words import SHARD_WIDTH
        from pilosa_tpu_torch.store import roaring

        if self._field_type(index, field) not in ("set", "time"):
            return None
        try:
            rows = np.asarray(row_ids, dtype=np.uint64)
            cols = np.asarray(col_ids, dtype=np.uint64)
        except (OverflowError, ValueError, TypeError):
            return None  # out-of-range ids: the JSON fallback's case
        if len(rows) != len(cols) or len(rows) == 0:
            return None
        shard_of = cols // np.uint64(SHARD_WIDTH)
        shards = np.unique(shard_of)
        if len(rows) < self.ROARING_MIN_PER_SHARD * len(shards):
            return None
        positions = rows * np.uint64(SHARD_WIDTH) \
            + (cols % np.uint64(SHARD_WIDTH))
        # one sort, then boundary slices — a per-shard boolean mask
        # would rescan the whole batch n_shards times
        order = np.argsort(shard_of, kind="stable")
        positions = positions[order]
        bounds = np.searchsorted(shard_of[order], shards)
        bounds = np.append(bounds, len(positions))
        changed = 0
        for i, s in enumerate(shards):
            blob = roaring.serialize(positions[bounds[i]:bounds[i + 1]])
            try:
                changed += self.import_roaring(index, field, int(s), blob)
            except ClientError as e:
                if e.status == 400 and i == 0:
                    # stale cached field type (field recreated with a
                    # different type): the server's type check fires
                    # before anything imports — refresh and fall back
                    self._field_type_cache.pop((index, field), None)
                    return None
                e.partial_changed = changed  # earlier shards committed
                raise
        return changed

    def _field_type(self, index: str, field: str) -> str | None:
        """Field type from the server schema, cached per (index,
        field).  Transient transport failures are NOT cached (a single
        connection blip must not pin this client to the slow pair wire
        for its lifetime); create/delete_field invalidate."""
        cache = getattr(self, "_field_type_cache", None)
        if cache is None:
            cache = self._field_type_cache = {}
        key = (index, field)
        if key not in cache:
            try:
                info = self._json("GET", f"/index/{index}/field/{field}")
                cache[key] = info.get("options", {}).get("type")
            except ClientError as e:
                if not 400 <= e.status < 500:
                    return None  # transport/5xx: don't cache
                cache[key] = None
        return cache[key]

    def import_roaring(self, index: str, field: str, shard: int, blob: bytes,
                       view: str = "standard"):
        path = (f"/index/{index}/field/{field}/import-roaring/{shard}"
                f"?view={urllib.parse.quote(view)}")
        return self._do("POST", path, blob,
                        content_type="application/octet-stream")["changed"]

    def export_csv(self, index: str, field: str) -> str:
        return self._do(
            "GET", f"/export?index={index}&field={field}").decode()

    def schema(self) -> list[dict]:
        return self._json("GET", "/schema")["indexes"]

    def status(self) -> dict:
        return self._json("GET", "/status")

    def write_health(self) -> dict:
        """The ``writeHealth`` block of ``/status``: the hinted-handoff
        backlog, its age and the per-peer drains (empty on a single
        node)."""
        return self._json("GET", "/status").get("writeHealth", {})

    def info(self) -> dict:
        return self._json("GET", "/info")

    def version(self) -> str:
        return self._json("GET", "/version")["version"]

    def metrics_text(self, openmetrics: bool = False) -> str:
        """``/metrics`` exposition text; ``openmetrics`` negotiates the
        OpenMetrics format (the only one that carries exemplars)."""
        headers = ({"Accept": "application/openmetrics-text"}
                   if openmetrics else None)
        return self._do("GET", "/metrics", headers=headers).decode()
