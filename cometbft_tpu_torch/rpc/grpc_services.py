"""gRPC RPC services: version / block / block-results / pruning.

Reference: rpc/grpc/server/services/{versionservice,blockservice,
blockresultservice,pruningservice} — a gRPC surface beside the JSON-RPC
server, with the pruning (data-companion) service on a separate
PRIVILEGED listener (config.go:520-543 GRPCConfig/GRPCPrivilegedConfig).

Transport follows abci/grpc.py: unary methods on grpc's generic-handler
API. Every service is served TWICE on the same listener — on the
reference's proto paths (tendermint.services.{version,block,block_results,
pruning}.v1.*, raw protobuf bodies per the .proto shapes, so the
data-companion ecosystem's generated stubs connect unmodified) and on the
framework-native JSON paths below. GetLatestHeight is a server stream, as
in the reference (blockservice/service.go:98): it yields a height whenever
the store head advances.

Framework-native service names (JSON bodies):
  cometbft_tpu.rpc.VersionService / GetVersion
  cometbft_tpu.rpc.BlockService   / GetByHeight, GetLatest,
                                    GetLatestHeight (stream)
  cometbft_tpu.rpc.BlockResultsService / GetBlockResults
  cometbft_tpu.rpc.PruningService (privileged) /
      SetBlockRetainHeight, GetBlockRetainHeight,
      SetBlockResultsRetainHeight, GetBlockResultsRetainHeight,
      SetTxIndexerRetainHeight, GetTxIndexerRetainHeight,
      SetBlockIndexerRetainHeight, GetBlockIndexerRetainHeight

The port's copy of cometbft_tpu/rpc/grpc_services.py. The services keep
the reference's names, so either package's client reaches either
package's server.
"""

from __future__ import annotations

import asyncio
import json
import time
from concurrent import futures

import grpc

from cometbft_tpu_torch import version as ver
from cometbft_tpu_torch.state import pruner as pruner_mod


def _ident(b: bytes) -> bytes:
    return b


# long-lived streams each hold one thread-pool worker; bound them so idle
# subscribers can never starve the unary RPCs sharing the executor
import threading

_MAX_STREAMS = 4
_stream_slots = threading.BoundedSemaphore(_MAX_STREAMS)


class _JsonServicer:
    """Maps /<service>/<Method> onto self.<snake_case Method>(dict)->dict.
    Only methods listed in rpc_methods / stream_methods are reachable —
    never arbitrary attributes (untrusted input picks the method name).

    When proto_service_name is set, the same methods are ALSO served on the
    reference's service path (tendermint.services.*.v1.*) with raw protobuf
    request/response bodies via proto_codecs — the data-companion ecosystem
    connects with its generated stubs, no configuration."""

    service_name = ""
    proto_service_name = ""
    rpc_methods: frozenset[str] = frozenset()
    stream_methods: frozenset[str] = frozenset()
    # Method -> (decode_request(bytes) -> dict,
    #            encode_response(self, dict) -> bytes)
    proto_codecs: dict = {}
    # Method -> alternate handler attr for the proto path (when the JSON
    # handler's dict would be built only to be thrown away)
    proto_method_overrides: dict = {}

    def service(self, handler_call_details):
        path = handler_call_details.method
        service, _, method = path.lstrip("/").partition("/")
        if service == self.proto_service_name and method in self.proto_codecs:
            return self._proto_handler(method)
        if service != self.service_name:
            return None
        snake = "".join(
            ("_" + c.lower()) if c.isupper() else c for c in method
        ).lstrip("_")
        if method in self.rpc_methods:
            fn = getattr(self, snake)

            def unary(request: bytes, context) -> bytes:
                try:
                    out = fn(json.loads(request or b"{}"))
                except KeyError as e:
                    context.abort(grpc.StatusCode.NOT_FOUND, str(e))
                except ValueError as e:
                    context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(e))
                return json.dumps(out).encode()

            return grpc.unary_unary_rpc_method_handler(
                unary, request_deserializer=_ident,
                response_serializer=_ident)
        if method in self.stream_methods:
            sfn = getattr(self, "stream_" + snake)

            def streaming(request: bytes, context):
                if not _stream_slots.acquire(blocking=False):
                    context.abort(
                        grpc.StatusCode.RESOURCE_EXHAUSTED,
                        f"too many concurrent streams (max {_MAX_STREAMS})")
                try:
                    for out in sfn(json.loads(request or b"{}"), context):
                        yield json.dumps(out).encode()
                finally:
                    _stream_slots.release()

            return grpc.unary_stream_rpc_method_handler(
                streaming, request_deserializer=_ident,
                response_serializer=_ident)
        return None

    def _proto_handler(self, method: str):
        dec, enc = self.proto_codecs[method]
        snake = "".join(
            ("_" + c.lower()) if c.isupper() else c for c in method
        ).lstrip("_")
        if method in self.stream_methods:
            sfn = getattr(self, "stream_" + snake)

            def p_streaming(request: bytes, context):
                if not _stream_slots.acquire(blocking=False):
                    context.abort(
                        grpc.StatusCode.RESOURCE_EXHAUSTED,
                        f"too many concurrent streams (max {_MAX_STREAMS})")
                try:
                    for out in sfn(dec(request), context):
                        yield enc(self, out)
                finally:
                    _stream_slots.release()

            return grpc.unary_stream_rpc_method_handler(
                p_streaming, request_deserializer=_ident,
                response_serializer=_ident)
        fn = getattr(self, self.proto_method_overrides.get(method, snake))

        def p_unary(request: bytes, context) -> bytes:
            try:
                # enc may re-read stores (a concurrent pruner can delete
                # between loads) — its KeyError must map to NOT_FOUND too
                return enc(self, fn(dec(request)))
            except KeyError as e:
                context.abort(grpc.StatusCode.NOT_FOUND, str(e))
            except ValueError as e:
                context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(e))

        return grpc.unary_unary_rpc_method_handler(
            p_unary, request_deserializer=_ident, response_serializer=_ident)


# --- proto codec helpers (tendermint/services/*/v1/*.proto shapes) ---------

from cometbft_tpu_torch.utils import protobuf as pb  # noqa: E402


def _dec_empty(_data: bytes) -> dict:
    return {}


def _dec_height_i64(data: bytes) -> dict:
    r = pb.Reader(data)
    h = 0
    while not r.at_end():
        f, w = r.read_tag()
        if f == 1:
            h = r.read_varint_i64()
        else:
            r.skip(w)
    return {"height": str(h)}


def _dec_height_u64(data: bytes) -> dict:
    r = pb.Reader(data)
    h = 0
    while not r.at_end():
        f, w = r.read_tag()
        if f == 1:
            h = r.read_uvarint()
        else:
            r.skip(w)
    return {"height": str(h)}


def _enc_empty(_self, _out: dict) -> bytes:
    return b""


def _enc_height_i64(_self, out: dict) -> bytes:
    return pb.Writer().varint_i64(1, int(out["height"])).output()


def _enc_version(_self, out: dict) -> bytes:
    w = pb.Writer()
    w.string(1, str(out["node"]))
    w.string(2, str(out["abci"]))
    w.uvarint(3, int(out["p2p"]))
    w.uvarint(4, int(out["block"]))
    return w.output()


class VersionService(_JsonServicer):
    service_name = "cometbft_tpu.rpc.VersionService"
    proto_service_name = "tendermint.services.version.v1.VersionService"
    rpc_methods = frozenset({"GetVersion"})
    proto_codecs = {"GetVersion": (_dec_empty, _enc_version)}

    def get_version(self, _req: dict) -> dict:
        return {
            "node": ver.CMTSemVer,
            "abci": ver.ABCIVersion,
            "p2p": ver.P2PProtocol,
            "block": ver.BlockProtocol,
        }


def _enc_block_resp(_self, out: dict) -> bytes:
    """tendermint.services.block.v1 GetByHeightResponse/GetLatestResponse:
    block_id=1 (tendermint.types.BlockID), block=2 (tendermint.types.Block
    — the framework's Block.to_proto is that wire layout)."""
    bid = pb.Writer()
    bid.bytes(1, bytes.fromhex(out["block_id"]["hash"]))
    psh = pb.Writer()
    psh.uvarint(1, out["block_id"]["part_set_header"]["total"])
    psh.bytes(2, bytes.fromhex(out["block_id"]["part_set_header"]["hash"]))
    bid.message(2, psh.output(), always=True)
    w = pb.Writer()
    w.message(1, bid.output(), always=True)
    w.message(2, bytes.fromhex(out["block_proto"]), always=True)
    return w.output()


class BlockService(_JsonServicer):
    service_name = "cometbft_tpu.rpc.BlockService"
    proto_service_name = "tendermint.services.block.v1.BlockService"
    rpc_methods = frozenset({"GetByHeight", "GetLatest"})
    stream_methods = frozenset({"GetLatestHeight"})
    proto_codecs = {
        "GetByHeight": (_dec_height_i64, _enc_block_resp),
        "GetLatest": (_dec_empty, _enc_block_resp),
        "GetLatestHeight": (_dec_empty, _enc_height_i64),
    }

    def __init__(self, block_store):
        self.block_store = block_store

    def _block_payload(self, height: int) -> dict:
        meta = self.block_store.load_block_meta(height)
        block = self.block_store.load_block(height)
        if meta is None or block is None:
            raise KeyError(f"block at height {height} not found")
        return {
            "block_id": {
                "hash": meta.block_id.hash.hex(),
                "part_set_header": {
                    "total": meta.block_id.part_set_header.total,
                    "hash": meta.block_id.part_set_header.hash.hex(),
                },
            },
            "height": str(height),
            "block_proto": block.to_proto().hex(),
        }

    def get_by_height(self, req: dict) -> dict:
        if "height" not in req:
            raise ValueError("missing height")  # INVALID_ARGUMENT, not 404
        h = int(req["height"])
        # block.proto: "If set to 0, the latest height will be returned"
        return self._block_payload(h if h else self.block_store.height())

    def get_latest(self, _req: dict) -> dict:
        return self._block_payload(self.block_store.height())

    def stream_get_latest_height(self, _req: dict, context):
        """blockservice/service.go:98 GetLatestHeight: push the head
        height whenever it advances, until the client goes away."""
        last = 0
        # polling (0.2 s) keeps this free of event-bus plumbing into the
        # sync worker thread; 5 store reads/s per subscriber, stream count
        # capped by _MAX_STREAMS
        while context.is_active():
            h = self.block_store.height()
            if h > last:
                last = h
                yield {"height": str(h)}
            time.sleep(0.2)


def _enc_block_results(self_, out: dict) -> bytes:
    """tendermint.services.block_results.v1 GetBlockResultsResponse —
    encoded from the RAW stored FinalizeBlock response via the ABCI proto
    codec (the JSON dict form base64s its bytes)."""
    from cometbft_tpu_torch.abci import proto_codec as apc

    height = int(out["height"])
    resp = self_.state_store.load_finalize_block_response(height)
    if resp is None:  # pruned between handler and encoder -> NOT_FOUND
        raise KeyError(f"block results at height {height} not found")
    w = pb.Writer()
    w.varint_i64(1, height)
    for t in resp.tx_results:
        tw = pb.Writer()
        apc._enc_tx_result_fields(tw, t)
        w.message(2, tw.output(), always=True)
    for e in resp.events:
        w.message(3, apc._enc_event(e), always=True)
    for u in resp.validator_updates:
        w.message(4, apc._enc_validator_update(u), always=True)
    w.message(5, apc._enc_consensus_params(resp.consensus_param_updates))
    w.bytes(6, resp.app_hash)
    return w.output()


class BlockResultsService(_JsonServicer):
    service_name = "cometbft_tpu.rpc.BlockResultsService"
    proto_service_name = (
        "tendermint.services.block_results.v1.BlockResultsService")
    rpc_methods = frozenset({"GetBlockResults"})
    proto_codecs = {"GetBlockResults": (_dec_height_i64, _enc_block_results)}
    # the proto encoder reads the raw stored object itself; skip the JSON
    # handler's base64 conversion work on this path
    proto_method_overrides = {"GetBlockResults": "resolve_results_height"}

    def __init__(self, state_store, block_store):
        self.state_store = state_store
        self.block_store = block_store

    def resolve_results_height(self, req: dict) -> dict:
        height = int(req.get("height") or 0) or self.block_store.height()
        if self.state_store.load_finalize_block_response(height) is None:
            raise KeyError(f"block results at height {height} not found")
        return {"height": str(height)}

    def get_block_results(self, req: dict) -> dict:
        from cometbft_tpu_torch.abci import codec as abci_codec

        height = int(req.get("height") or 0) or self.block_store.height()
        resp = self.state_store.load_finalize_block_response(height)
        if resp is None:
            raise KeyError(f"block results at height {height} not found")
        return {
            "height": str(height),
            "txs_results": [abci_codec._to_jsonable(r) for r in resp.tx_results],
            "finalize_block_events": [
                abci_codec._to_jsonable(e) for e in resp.events],
            "app_hash": resp.app_hash.hex(),
        }


def _enc_block_retain(_self, out: dict) -> bytes:
    w = pb.Writer()
    w.uvarint(1, int(out["app_retain_height"]))
    w.uvarint(2, int(out["pruning_service_retain_height"]))
    return w.output()


def _enc_service_retain(_self, out: dict) -> bytes:
    return pb.Writer().uvarint(
        1, int(out["pruning_service_retain_height"])).output()


def _enc_height_u64(_self, out: dict) -> bytes:
    return pb.Writer().uvarint(1, int(out["height"])).output()


class PruningService(_JsonServicer):
    """The data-companion control plane (pruningservice/service.go):
    retain heights set here gate what the background pruner may delete."""

    service_name = "cometbft_tpu.rpc.PruningService"
    proto_service_name = "tendermint.services.pruning.v1.PruningService"
    rpc_methods = frozenset({
        "SetBlockRetainHeight", "GetBlockRetainHeight",
        "SetBlockResultsRetainHeight", "GetBlockResultsRetainHeight",
        "SetTxIndexerRetainHeight", "GetTxIndexerRetainHeight",
        "SetBlockIndexerRetainHeight", "GetBlockIndexerRetainHeight",
    })
    proto_codecs = {
        "SetBlockRetainHeight": (_dec_height_u64, _enc_empty),
        "GetBlockRetainHeight": (_dec_empty, _enc_block_retain),
        "SetBlockResultsRetainHeight": (_dec_height_u64, _enc_empty),
        "GetBlockResultsRetainHeight": (_dec_empty, _enc_service_retain),
        "SetTxIndexerRetainHeight": (_dec_height_u64, _enc_empty),
        "GetTxIndexerRetainHeight": (_dec_empty, _enc_height_u64),
        "SetBlockIndexerRetainHeight": (_dec_height_u64, _enc_empty),
        "GetBlockIndexerRetainHeight": (_dec_empty, _enc_height_u64),
    }

    def __init__(self, pruner):
        self.pruner = pruner

    def set_block_retain_height(self, req: dict) -> dict:
        self.pruner.set_companion_block_retain_height(int(req["height"]))
        return {}

    def get_block_retain_height(self, _req: dict) -> dict:
        return {
            "app_retain_height": str(
                self.pruner.state_store.load_retain_height(
                    pruner_mod.APP_RETAIN)),
            "pruning_service_retain_height": str(
                self.pruner.state_store.load_retain_height(
                    pruner_mod.COMPANION_RETAIN)),
        }

    def set_block_results_retain_height(self, req: dict) -> dict:
        self.pruner.set_abci_res_retain_height(int(req["height"]))
        return {}

    def get_block_results_retain_height(self, _req: dict) -> dict:
        return {"pruning_service_retain_height": str(
            self.pruner.get_abci_res_retain_height())}

    def set_tx_indexer_retain_height(self, req: dict) -> dict:
        self.pruner.set_tx_indexer_retain_height(int(req["height"]))
        return {}

    def get_tx_indexer_retain_height(self, _req: dict) -> dict:
        return {"height": str(self.pruner.get_tx_indexer_retain_height())}

    def set_block_indexer_retain_height(self, req: dict) -> dict:
        self.pruner.set_block_indexer_retain_height(int(req["height"]))
        return {}

    def get_block_indexer_retain_height(self, _req: dict) -> dict:
        return {"height": str(self.pruner.get_block_indexer_retain_height())}


class _MultiHandler(grpc.GenericRpcHandler):
    def __init__(self, servicers):
        self.servicers = servicers

    def service(self, handler_call_details):
        for s in self.servicers:
            h = s.service(handler_call_details)
            if h is not None:
                return h
        return None


def serve(servicers, addr: str) -> tuple[grpc.Server, str]:
    """Start a gRPC server hosting the servicers; returns (server,
    'host:bound_port')."""
    server = grpc.server(futures.ThreadPoolExecutor(max_workers=8))
    server.add_generic_rpc_handlers((_MultiHandler(servicers),))
    host = addr.removeprefix("tcp://")
    port = server.add_insecure_port(host)
    if port == 0:
        raise RuntimeError(f"gRPC bind failed on {addr!r}")
    server.start()
    bound = f"{host.rsplit(':', 1)[0]}:{port}"
    return server, bound


# ----------------------------------------------------------------- client


class GRPCServicesClient:
    """Minimal client for the JSON-framed services (tests, operator
    tooling, the data companion)."""

    def __init__(self, addr: str):
        self.channel = grpc.aio.insecure_channel(addr.removeprefix("tcp://"))

    async def call(self, service: str, method: str, req: dict | None = None) -> dict:
        rpc = self.channel.unary_unary(
            f"/cometbft_tpu.rpc.{service}/{method}",
            request_serializer=_ident, response_deserializer=_ident)
        out = await rpc(json.dumps(req or {}).encode())
        return json.loads(out)

    async def stream(self, service: str, method: str, req: dict | None = None):
        rpc = self.channel.unary_stream(
            f"/cometbft_tpu.rpc.{service}/{method}",
            request_serializer=_ident, response_deserializer=_ident)
        async for out in rpc(json.dumps(req or {}).encode()):
            yield json.loads(out)

    async def close(self) -> None:
        await self.channel.close()


async def wait_closed(server: grpc.Server, grace: float = 1.0) -> None:
    """Stop the server and wait for the drain, so a restart can rebind."""
    await asyncio.to_thread(server.stop(grace=grace).wait)
