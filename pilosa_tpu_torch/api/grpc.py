"""gRPC query and ingest surface (``pilosa_tpu.api.grpc``'s).

Service ``pilosa_tpu.Pilosa`` with unary rpcs:

    Query(QueryRequest) -> QueryResponse
    Import(ImportRequest) -> ImportResponse
    ImportValue(ImportValueRequest) -> ImportResponse

The messages are the reference's ``api/internal.proto`` ones
(``QueryRequest.index`` names the index: there is no URL path), encoded
by the port's codec (:mod:`pilosa_tpu_torch.api.proto`).  The server
registers grpcio's generic method handlers over raw bytes, so no
generated code exists; a client generated from internal.proto
interoperates, and Python callers use ``channel.unary_unary`` with the
same codec.

Application errors answer in ``QueryResponse.err`` / ``ImportResponse.err``
with gRPC status OK, as the reference's do.  ``grpc`` is imported when a
server is made, so the module imports without grpcio.
"""

from __future__ import annotations

from pilosa_tpu_torch.api import proto
from pilosa_tpu_torch.api.api import API, ApiError

SERVICE = "pilosa_tpu.Pilosa"


class GrpcServer:
    def __init__(self, api: API, host: str = "127.0.0.1", port: int = 0,
                 max_workers: int = 8, credentials=None):
        from concurrent import futures

        import grpc

        self.api = api
        self._server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=max_workers))
        rpcs = {
            "Query": grpc.unary_unary_rpc_method_handler(self._query),
            "Import": grpc.unary_unary_rpc_method_handler(self._import),
            "ImportValue": grpc.unary_unary_rpc_method_handler(
                self._import_value),
        }
        self._server.add_generic_rpc_handlers(
            (grpc.method_handlers_generic_handler(SERVICE, rpcs),))
        if credentials is not None:
            # the REST surface's tls block (api.tls.grpc_server_credentials)
            self.port = self._server.add_secure_port(
                f"{host}:{port}", credentials)
        else:
            self.port = self._server.add_insecure_port(f"{host}:{port}")

    def start(self) -> "GrpcServer":
        self._server.start()
        return self

    def close(self, grace: float = 0.5) -> None:
        self._server.stop(grace).wait()

    # -- rpcs (raw request bytes -> raw response bytes) ----------------------

    def _query(self, request: bytes, context) -> bytes:
        try:
            pql, shards, index = proto.decode_query_request_indexed(request)
        except ValueError as e:
            return proto.encode_query_response(err=f"bad request: {e}")
        if not index:
            return proto.encode_query_response(err="missing index")
        try:
            res = self.api.query(index, pql, shards=shards)
            return proto.encode_query_response(res["results"])
        except (ApiError, ValueError) as e:
            return proto.encode_query_response(err=str(e))

    def _import(self, request: bytes, context) -> bytes:
        try:
            b = proto.decode_import_request(request)
        except ValueError as e:
            return proto.encode_import_response(err=f"bad request: {e}")
        if not b["index"] or not b["field"]:
            return proto.encode_import_response(err="missing index/field")
        try:
            changed = self.api.import_bits(
                b["index"], b["field"], row_ids=b["row_ids"],
                col_ids=b["col_ids"], row_keys=b["row_keys"],
                col_keys=b["col_keys"], timestamps=b["timestamps"],
                clear=b["clear"])
            return proto.encode_import_response(changed)
        except ApiError as e:
            return proto.encode_import_response(err=str(e))

    def _import_value(self, request: bytes, context) -> bytes:
        try:
            b = proto.decode_import_value_request(request)
        except ValueError as e:
            return proto.encode_import_response(err=f"bad request: {e}")
        if not b["index"] or not b["field"]:
            return proto.encode_import_response(err="missing index/field")
        try:
            changed = self.api.import_values(
                b["index"], b["field"], col_ids=b["col_ids"],
                col_keys=b["col_keys"], values=b["values"])
            return proto.encode_import_response(changed)
        except ApiError as e:
            return proto.encode_import_response(err=str(e))
