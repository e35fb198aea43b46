"""ABCI over gRPC (reference: abci/client/grpc_client.go +
abci/server/grpc_server.go).

The reference exposes one unary RPC per ABCI method on a
protoc-generated `tendermint.abci.ABCI` service. The server here hosts
BOTH encodings on one port, keyed by service name:

  /tendermint.abci.ABCI/<CamelMethod>   — raw proto request/response
      bodies (abci/proto_codec.py), wire-compatible with the reference's
      generated stubs: any existing gRPC ABCI client connects unmodified.
  /cometbft_tpu.abci.ABCI/<method>      — the framework-native JSON
      frames (legacy transport, kept for in-framework callers).

Server: serve_grpc(app, addr) -> started grpc.Server (thread-pool; the
Application interface is synchronous).
Client: GRPCClient over grpc.aio — one in-flight request per method call,
matching the Client contract used by the proxy connections; wire="proto"
(default) speaks the tendermint.abci.ABCI service.

The port's copy of cometbft_tpu/abci/grpc.py. The service keeps the
reference's name, so either package's client reaches either package's
server.
"""

from __future__ import annotations

import json
import struct
import threading
from concurrent import futures

import grpc
import grpc.aio

from cometbft_tpu_torch.abci import codec
from cometbft_tpu_torch.abci import proto_codec
from cometbft_tpu_torch.abci import types as abci
from cometbft_tpu_torch.abci.client import Client, ClientError

SERVICE = "cometbft_tpu.abci.ABCI"
PROTO_SERVICE = "tendermint.abci.ABCI"

_METHODS = sorted(codec._REQUEST_TYPES)
_CAMEL = {m: "".join(p.capitalize() for p in m.split("_")) for m in _METHODS}
_BY_CAMEL = {v: k for k, v in _CAMEL.items()}


def _ident(b: bytes) -> bytes:
    return b


def _strip_frame(data: bytes) -> dict:
    if len(data) < 4:
        raise ValueError("short ABCI frame")
    (n,) = struct.unpack(">I", data[:4])
    if n != len(data) - 4:
        raise ValueError("ABCI frame length mismatch")
    return json.loads(data[4:])


class _AppHandler(grpc.GenericRpcHandler):
    """grpc_server.go: every ABCI verb is a unary RPC onto the app."""

    def __init__(self, app: abci.Application):
        self.app = app
        self._lock = threading.Lock()  # app calls are serialized, like local

    def service(self, handler_call_details):
        path = handler_call_details.method  # "/<service>/<Method>"
        try:
            service, method = path.lstrip("/").split("/", 1)
        except ValueError:
            return None
        if service == PROTO_SERVICE and method in _BY_CAMEL:
            m = _BY_CAMEL[method]

            def proto_handler(request_bytes: bytes, context) -> bytes:
                req = proto_codec._REQ_DECODERS[m](request_bytes)
                resp = self._run(m, req)
                return proto_codec._RESP_ENCODERS[m](resp)

            return grpc.unary_unary_rpc_method_handler(
                proto_handler, request_deserializer=_ident,
                response_serializer=_ident)
        if service != SERVICE or method not in codec._REQUEST_TYPES:
            return None

        def handler(request_bytes: bytes, context) -> bytes:
            m, req = codec._decode_request_body(_strip_frame(request_bytes))
            resp = self._run(m, req)
            return codec.encode_response(m, resp)

        return grpc.unary_unary_rpc_method_handler(
            handler, request_deserializer=_ident, response_serializer=_ident)

    def _run(self, m: str, req):
        with self._lock:
            if m == "echo":
                return abci.ResponseEcho(message=req.message)
            if m == "flush":
                return abci.ResponseFlush()
            return getattr(self.app, m)(req)


def serve_grpc(app: abci.Application, addr: str) -> tuple[grpc.Server, str]:
    """-> (started server, bound 'host:port'). addr may use port 0."""
    server = grpc.server(futures.ThreadPoolExecutor(max_workers=4))
    server.add_generic_rpc_handlers((_AppHandler(app),))
    host = addr.removeprefix("grpc://").removeprefix("tcp://")
    port = server.add_insecure_port(host)
    server.start()
    bound = f"{host.rsplit(':', 1)[0]}:{port}"
    return server, bound


class GRPCClient(Client):
    """grpc_client.go over grpc.aio — satisfies the proxy Client contract.
    wire="proto" (default) calls the reference-compatible
    tendermint.abci.ABCI service; wire="json" the legacy framework one."""

    def __init__(self, addr: str, wire: str = "proto"):
        self.addr = addr.removeprefix("grpc://").removeprefix("tcp://")
        if wire not in ("proto", "json"):
            raise ValueError(f"unknown ABCI wire format {wire!r}")
        self.wire = wire
        self._channel: grpc.aio.Channel | None = None
        self._stubs: dict[str, object] = {}

    async def _ensure(self) -> None:
        if self._channel is None:
            self._channel = grpc.aio.insecure_channel(self.addr)
            for m in _METHODS:
                path = (f"/{PROTO_SERVICE}/{_CAMEL[m]}" if self.wire == "proto"
                        else f"/{SERVICE}/{m}")
                self._stubs[m] = self._channel.unary_unary(
                    path,
                    request_serializer=_ident,
                    response_deserializer=_ident,
                )

    async def _call(self, name: str, req) -> object:
        await self._ensure()
        if self.wire == "proto":
            try:
                raw = await self._stubs[name](
                    proto_codec._REQ_ENCODERS[name](req))
            except grpc.aio.AioRpcError as e:
                raise ClientError(
                    f"grpc abci call {name} failed: {e.details()}") from e
            return proto_codec._RESP_DECODERS[name](raw)
        try:
            raw = await self._stubs[name](codec.encode_request(name, req))
        except grpc.aio.AioRpcError as e:
            raise ClientError(f"grpc abci call {name} failed: {e.details()}") from e
        m, resp = codec._decode_response_body(_strip_frame(raw))
        if m == "exception":
            raise ClientError(f"abci app exception in {name}: {resp}")
        return resp

    async def echo(self, msg: str) -> abci.ResponseEcho:
        return await self._call("echo", abci.RequestEcho(message=msg))

    async def flush(self) -> None:
        await self._call("flush", abci.RequestFlush())

    async def close(self) -> None:
        if self._channel is not None:
            await self._channel.close()
            self._channel = None


# the proxy-facing per-method coroutines (same generation as client.py)
def _make_method(name: str):
    async def call(self, req):
        return await self._call(name, req)

    return call


for _m in _METHODS:
    if _m not in ("echo", "flush"):
        setattr(GRPCClient, _m, _make_method(_m))
