"""The port's gRPC surface against ``pilosa_tpu``'s, byte for byte: the
same raw requests (Query, Import, ImportValue, and the requests that
answer an error body: a bad message, a missing index or field, a parse
error, an unknown index, a value out of range) go to a JAX
``GrpcServer`` and a port ``GrpcServer`` over copies of one empty data
directory, and the response bytes are equal.  A port server with the
``[tls]`` block's credentials serves a TLS channel.  Skipped without
grpcio."""

import pytest

pytest.importorskip("grpc")

from pilosa_tpu.api import API as JAPI  # noqa: E402
from pilosa_tpu.api.grpc import GrpcServer as JGrpc  # noqa: E402
from pilosa_tpu.exec import Executor as JExecutor  # noqa: E402
from pilosa_tpu.store import Holder as JHolder  # noqa: E402
from pilosa_tpu_torch.api import API as TAPI  # noqa: E402
from pilosa_tpu_torch.api import proto  # noqa: E402
from pilosa_tpu_torch.api.grpc import SERVICE  # noqa: E402
from pilosa_tpu_torch.api.grpc import GrpcServer as TGrpc  # noqa: E402
from pilosa_tpu_torch.exec import Executor as TExecutor  # noqa: E402
from pilosa_tpu_torch.store import Holder as THolder  # noqa: E402

SW = 1 << 20


@pytest.fixture
def servers(tmp_path):
    jh = JHolder(str(tmp_path / "j")).open()
    th = THolder(str(tmp_path / "t")).open()
    apis = {"reference": JAPI(jh, JExecutor(jh, plane_paging=False)),
            "port": TAPI(th, TExecutor(th, device="cpu"))}
    for api in apis.values():
        api.create_index("i")
        api.create_field("i", "f")
        api.create_field("i", "v", {"type": "int", "min": -50, "max": 50})
        api.create_index("k", {"keys": True})
        api.create_field("k", "f", {"keys": True})
    srvs = {"reference": JGrpc(apis["reference"], port=0).start(),
            "port": TGrpc(apis["port"], port=0).start()}
    yield srvs
    for s in srvs.values():
        s.close()
    apis["reference"].executor.translate.close()
    apis["port"].executor.close()
    jh.close()
    th.close()


def _stubs(port: int, creds=None):
    import grpc
    chan = (grpc.secure_channel(f"127.0.0.1:{port}", creds) if creds
            else grpc.insecure_channel(f"127.0.0.1:{port}"))

    def ident(b):
        return b  # raw bytes both ways: the codec does the work

    return chan, {m: chan.unary_unary(f"/{SERVICE}/{m}",
                                      request_serializer=ident,
                                      response_deserializer=ident)
                  for m in ("Query", "Import", "ImportValue")}


REQUESTS = [
    ("Import", proto.encode_import_request(
        index="i", field="f", row_ids=[1, 1, 2, 3],
        col_ids=[5, 9, 5, 2 * SW + 1])),
    ("Import", proto.encode_import_request(
        index="i", field="f", row_ids=[1], col_ids=[9], clear=True)),
    ("Import", proto.encode_import_request(
        index="k", field="f", row_keys=["a", "b"], col_keys=["x", "y"])),
    ("ImportValue", proto.encode_import_value_request(
        index="i", field="v", col_ids=[5, 9, SW], values=[-7, 40, 50])),
    ("Query", proto.encode_query_request(
        "Count(Row(f=1)) Row(f=1) Sum(field=v) TopN(f) Min(field=v)",
        index="i")),
    ("Query", proto.encode_query_request("Count(Row(f=1))", shards=[2],
                                         index="i")),
    ("Query", proto.encode_query_request('Row(f="a")', index="k")),
    # error bodies
    ("Query", proto.encode_query_request("Count(Row(f=1))", index="nope")),
    ("Query", proto.encode_query_request("Count(Row(f=1))")),
    ("Query", proto.encode_query_request("Count(Row(f=1)", index="i")),
    ("Query", b"\xff\xff\xff"),
    ("Import", proto.encode_import_request(index="i", row_ids=[1],
                                           col_ids=[1])),
    ("Import", proto.encode_import_request(index="i", field="nope",
                                           row_ids=[1], col_ids=[1])),
    ("Import", b"\xff\xff"),
    ("ImportValue", proto.encode_import_value_request(
        index="i", field="v", col_ids=[1], values=[99])),
    ("ImportValue", proto.encode_import_value_request(
        index="i", field="f", col_ids=[1], values=[1])),
    ("ImportValue", proto.encode_import_value_request(
        field="v", col_ids=[1], values=[1])),
]


def test_requests_answer_the_same_bytes(servers):
    got = {}
    for name, srv in servers.items():
        chan, stubs = _stubs(srv.port)
        got[name] = [stubs[m](req, timeout=60) for m, req in REQUESTS]
        chan.close()
    for i, (m, _) in enumerate(REQUESTS):
        assert got["port"][i] == got["reference"][i], (i, m)
    results = proto.decode_query_response(got["port"][4])["results"]
    assert results[0] == 1 and results[2] == {"value": 83, "count": 3}
    assert "nope" in proto.decode_query_response(got["port"][7])["error"]


def test_tls_channel(tmp_path):
    pytest.importorskip("cryptography")
    import grpc

    from pilosa_tpu_torch.api import tls
    from test_torch_tls import _cert, _write
    ca_cert, ca_key = _cert("grpc-ca", None, None, is_ca=True)
    node_cert, node_key = _cert("grpc-node", ca_cert, ca_key)
    ca = _write(tmp_path, "ca", ca_cert, ca_key)
    cert, key = _write(tmp_path, "node", node_cert, node_key)
    th = THolder(str(tmp_path / "t")).open()
    api = TAPI(th, TExecutor(th, device="cpu"))
    api.create_index("i")
    creds = tls.grpc_server_credentials(tls.TLSConfig(
        certificate=cert, key=key, ca_certificate=ca[0]))
    srv = TGrpc(api, port=0, credentials=creds).start()
    try:
        with open(ca[0], "rb") as f:
            ccreds = grpc.ssl_channel_credentials(root_certificates=f.read())
        chan, stubs = _stubs(srv.port, ccreds)
        resp = proto.decode_query_response(stubs["Query"](
            proto.encode_query_request("Count(All())", index="i"),
            timeout=60))
        chan.close()
        assert resp["results"] == [0]
    finally:
        srv.close()
        api.executor.close()
        th.close()
