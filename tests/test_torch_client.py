"""The port's HTTP client against both packages' servers on the CPU.

The same calls through ``pilosa_tpu_torch.api.client.Client`` reach a
``pilosa_tpu`` server and a port server over copies of one empty data
directory, and every answer is equal:

- index and field creation and deletion, the three import wires (dense
  id batches serialized to roaring per shard, the protobuf pair wire,
  the JSON fallback for timestamps the codec refuses) and the value
  wire, queries, ``export_csv`` and ``download``, ``schema``, ``info``
  and ``version``;
- the retry policy through the port's fault sites: ``client.send``
  ``partition`` is unreachable before any socket; ``client.recv``
  ``drop`` retries a GET and an ``idempotent_posts`` client's POST once
  (``last_retried``), and surfaces on a default client's POST, whose
  write the server applied;
- the send-phase and lost-response classes on a fake connection, and the
  reference-only calls refused.
"""

import http.client
import io
import time

import numpy as np
import pytest

from pilosa_tpu.api import API as JAPI
from pilosa_tpu.api import Server as JServer
from pilosa_tpu.exec import Executor as JExecutor
from pilosa_tpu.store import Holder as JHolder
from pilosa_tpu_torch import fault as tfault
from pilosa_tpu_torch.api import API as TAPI
from pilosa_tpu_torch.api import Server as TServer
from pilosa_tpu_torch.api.client import Client, ClientError
from pilosa_tpu_torch.exec import Executor as TExecutor
from pilosa_tpu_torch.store import Holder as THolder

SW = 1 << 20


@pytest.fixture(autouse=True)
def _clean_faults():
    tfault.clear()
    yield
    tfault.clear()


@pytest.fixture
def servers(tmp_path):
    """A JAX server and a port server, each over an empty directory."""
    jh = JHolder(str(tmp_path / "j")).open()
    th = THolder(str(tmp_path / "t")).open()
    japi = JAPI(jh, JExecutor(jh, plane_paging=False))
    tapi = TAPI(th, TExecutor(th, device="cpu"))
    js = JServer(japi, "127.0.0.1", 0).start()
    ts = TServer(tapi, "127.0.0.1", 0).start()
    yield {"reference": js, "port": ts}
    js.close()
    ts.close()
    japi.executor.translate.close()
    tapi.executor.close()
    jh.close()
    th.close()


def _clients(servers, **kw):
    return {name: Client("127.0.0.1", s.address[1], **kw)
            for name, s in servers.items()}


def _script(c: Client) -> list:
    """Every call of the client, its answers in order."""
    rng = np.random.default_rng(3)
    out = [c.create_index("i"), c.create_field("i", "f"),
           c.create_field("i", "t", {"type": "time", "timeQuantum": "YMD"}),
           c.create_field("i", "amount",
                          {"type": "int", "min": -100, "max": 100})]
    # dense: 2 shards x 5000 pairs rides import-roaring per shard
    cols = np.concatenate([rng.integers(0, 60000, 5000),
                           SW + rng.integers(0, 60000, 5000)])
    rows = rng.integers(0, 4, len(cols))
    out.append(c.import_bits("i", "f", rowIDs=rows.tolist(),
                             columnIDs=cols.tolist()))
    # scattered: the protobuf pair wire
    out.append(c.import_bits("i", "f", rowIDs=[5, 5, 6],
                             columnIDs=[1, 2 * SW + 3, 3 * SW]))
    # a clear: the protobuf pair wire with the clear flag
    out.append(c.import_bits("i", "f", rowIDs=[5], columnIDs=[1],
                             clear=True))
    # timestamps mixing None and strings: the codec refuses, JSON carries
    out.append(c.import_bits("i", "t", rowIDs=[1, 1, 2],
                             columnIDs=[4, 5, 6],
                             timestamps=["2021-02-03T00:00", None,
                                         "2021-02-04T10:00"]))
    out.append(c.import_values("i", "amount", columnIDs=[4, 5, SW + 9],
                               values=[-3, 77, 100]))
    # keyed index and field
    out += [c.create_index("k", {"keys": True}),
            c.create_field("k", "f", {"keys": True})]
    out.append(c.import_bits("k", "f", rowKeys=["a", "b", "a"],
                             columnKeys=["x", "y", "z"]))
    for q in ("Count(Row(f=1))", "TopN(f, n=3)", "Row(f=6)",
              "Sum(field=amount)",
              "Row(t=1, from=2021-02-01T00:00, to=2021-02-05T00:00)"):
        out.append(c.query("i", q))
    out.append(c.query("i", "Count(Row(f=1))", shards=[1]))
    out.append(c.query("k", 'Row(f="a")'))
    out += [c.export_csv("i", "f"), c.export_csv("i", "amount"),
            c.export_csv("k", "f"), _strip(c.schema()), c.info(),
            c.version()]
    sink = io.BytesIO()
    headers = c.download("/export?index=i&field=t", sink)
    out += [sink.getvalue(), headers["Content-Type"]]
    out += [c.delete_field("i", "t"), c.delete_index("k"),
            _strip(c.schema())]
    for call in (lambda: c.query("k", "Count(Row(f=1))"),
                 lambda: c.delete_index("k"),
                 lambda: c.export_csv("i", "nope"),
                 lambda: c.download("/export?index=i&field=nope",
                                    io.BytesIO()),
                 lambda: c.create_index("i")):
        with pytest.raises(ClientError) as ei:
            call()
        out.append((ei.value.status, ei.value.kind, str(ei.value)))
    return out


def _strip(schema: list) -> list:
    """A schema without its creation times."""
    for s in schema:
        s.pop("createdAt")
        for f in s["fields"]:
            f.pop("createdAt")
    return schema


def test_script_equal_across_servers(servers):
    cs = _clients(servers)
    got = {name: _script(c) for name, c in cs.items()}
    assert got["port"] == got["reference"]
    # the dense batch took the roaring wire on both: one request per shard
    assert cs["port"]._field_type_cache[("i", "f")] == "set"


def test_send_partition_is_unreachable_before_any_socket():
    tfault.set_fault("client.send", "partition",
                     match={"peer": "127.0.0.1:1"})
    c = Client("127.0.0.1", 1)
    with pytest.raises(ClientError) as ei:
        c._do("GET", "/status")
    assert ei.value.kind == "unreachable"
    assert "injected partition" in str(ei.value)


@pytest.mark.parametrize("name", ["reference", "port"])
def test_recv_drop_retries_idempotent_requests(servers, name):
    port = servers[name].address[1]
    c = Client("127.0.0.1", port)
    tfault.set_fault("client.recv", "drop", nth=1)
    assert c.version() == "0.1.0"
    assert c.last_retried()
    assert c.version() == "0.1.0" and not c.last_retried()
    c.create_index("i")
    c.create_field("i", "f")
    idem = Client("127.0.0.1", port, idempotent_posts=True)
    tfault.set_fault("client.recv", "drop", nth=1,
                     match={"path": "/query"})
    assert idem.query("i", "Set(7, f=2)") in ([True], [False])
    assert idem.last_retried()
    assert c.query("i", "Count(Row(f=2))") == [1]


@pytest.mark.parametrize("name", ["reference", "port"])
def test_recv_drop_surfaces_on_default_posts(servers, name):
    c = Client("127.0.0.1", servers[name].address[1])
    c.create_index("i")
    c.create_field("i", "f")
    tfault.set_fault("client.recv", "drop", match={"path": "/query"})
    with pytest.raises(ClientError) as ei:
        c.query("i", "Set(1, f=1)")
    assert ei.value.kind == "unreachable"
    tfault.clear()
    # the request was delivered: the write applied
    end = time.monotonic() + 5
    while c.query("i", "Count(Row(f=1))") != [1]:
        assert time.monotonic() < end
        time.sleep(0.01)


class _FakeResp:
    status = 200
    headers = {"Content-Type": "application/json"}
    will_close = False

    def read(self, *a):
        return b'{"ok": true}'


def _fake_client(fail_exc, **kw):
    """A client whose first connection fails with ``fail_exc`` and whose
    fresh (retry) connection answers."""
    c = Client("127.0.0.1", 1, **kw)

    class FakeConn:
        def __init__(self, fail):
            self.fail = fail
            self.sock = None

        def request(self, *a, **k):
            if self.fail:
                raise fail_exc

        def getresponse(self):
            return _FakeResp()

        def close(self):
            pass

    c._checkout = lambda timeout, fresh=False: FakeConn(not fresh)
    return c


@pytest.mark.parametrize("exc, method, kw, retried", [
    (ConnectionResetError("reset"), "POST", {}, False),
    (ConnectionResetError("reset"), "GET", {}, True),
    (ConnectionResetError("reset"), "DELETE", {}, True),
    (ConnectionResetError("reset"), "POST", {"idempotent_posts": True},
     True),
    (http.client.CannotSendRequest(), "POST", {}, True),
    (http.client.IncompleteRead(b"", 29), "POST", {}, False),
    (http.client.IncompleteRead(b"", 29), "POST",
     {"idempotent_posts": True}, True),
])
def test_retry_policy(exc, method, kw, retried):
    c = _fake_client(exc, **kw)
    if retried:
        assert c._do(method, "/index/i/query", b"x") == {"ok": True}
        assert c.last_retried()
    else:
        with pytest.raises(ClientError) as ei:
            c._do(method, "/index/i/query", b"Set(1, f=1)")
        assert ei.value.kind == "unreachable"


def test_client_error_kinds():
    assert ClientError("x", 404).kind == "http"
    assert ClientError("x").kind == "transport"
    assert ClientError("x", kind="timeout").kind == "timeout"


def test_reference_only_calls_refused():
    c = Client("127.0.0.1", 1)
    # write_health and /metrics are served: each call goes to the wire
    # (nothing listens)
    with pytest.raises(ClientError):
        c.write_health()
    with pytest.raises(ClientError):
        c.metrics_text()
