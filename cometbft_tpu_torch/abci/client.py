"""ABCI clients: in-process (local) and unix/tcp socket transports — async.

Reference: abci/client/local_client.go (mutex-serialized in-proc calls),
abci/client/socket_client.go (request/response over a stream). The engine is
asyncio-based; app calls are awaitable. Local calls run on a worker thread
under one app-wide lock (the app is a non-reentrant state machine and must
not block the event loop); socket calls await stream I/O. The wire codec is
the framework-native length-prefixed encoding (codec.py) or the reference's
protobuf (proto_codec.py).

The port's copy of cometbft_tpu/abci/client.py.
"""

from __future__ import annotations

import asyncio
import threading

from cometbft_tpu_torch.abci import codec
from cometbft_tpu_torch.abci import types as abci


class ClientError(Exception):
    pass


_METHODS = [
    "info", "query", "check_tx", "init_chain", "prepare_proposal",
    "process_proposal", "finalize_block", "extend_vote",
    "verify_vote_extension", "commit", "list_snapshots", "offer_snapshot",
    "load_snapshot_chunk", "apply_snapshot_chunk",
]


class Client:
    """Async call surface used by proxy.AppConns — one coroutine per ABCI
    method, generated onto the class below."""

    async def echo(self, msg: str) -> abci.ResponseEcho: ...

    async def flush(self) -> None: ...

    async def close(self) -> None: ...


def _make_method(name: str):
    async def call(self, req):
        return await self._call(name, req)

    call.__name__ = name
    return call


for _m in _METHODS:
    setattr(Client, _m, _make_method(_m))


class LocalClient(Client):
    """In-proc client (reference: abci/client/local_client.go): direct app
    calls on a worker thread, serialized by one shared threading.Lock across
    all 4 logical connections (proxy/client.go NewLocalClientCreator)."""

    def __init__(self, app: abci.Application, lock: threading.Lock | None = None):
        self.app = app
        self.lock = lock or threading.Lock()

    async def _call(self, name: str, req):
        def run():
            with self.lock:
                return getattr(self.app, name)(req)

        return await asyncio.to_thread(run)

    async def echo(self, msg: str) -> abci.ResponseEcho:
        return abci.ResponseEcho(message=msg)

    async def flush(self) -> None:
        return None

    async def close(self) -> None:
        return None


class SocketClient(Client):
    """Request/response over a unix or TCP socket. One in-flight call per
    connection (asyncio.Lock); the engine's 4 logical connections provide
    cross-subsystem concurrency, as in the reference.

    wire="proto" speaks the reference's varint-delimited
    tendermint.abci.Request/Response protobuf (abci/proto_codec.py), so this
    client drives any existing ABCI app, including the reference's own
    kvstore; wire="json" is the framework-native frame."""

    def __init__(self, addr: str, wire: str = "proto"):
        from cometbft_tpu_torch.abci import proto_codec

        self.addr = addr
        if wire not in ("proto", "json"):
            raise ValueError(f"unknown ABCI wire format {wire!r}")
        self._codec = proto_codec if wire == "proto" else codec
        self.wire = wire
        self._lock = asyncio.Lock()
        self._reader: asyncio.StreamReader | None = None
        self._writer: asyncio.StreamWriter | None = None

    async def connect(self, timeout: float = 10.0) -> None:
        if self.addr.startswith("unix://"):
            self._reader, self._writer = await asyncio.wait_for(
                asyncio.open_unix_connection(self.addr[len("unix://"):]), timeout
            )
        else:
            host, _, port = self.addr.removeprefix("tcp://").rpartition(":")
            self._reader, self._writer = await asyncio.wait_for(
                asyncio.open_connection(host, int(port)), timeout
            )
        if self.wire == "json":
            # the server's wire autodetector keys on the connection's FIRST
            # byte (0x00 = JSON 4-byte length header). A first frame >= 16 MB
            # would start nonzero and be misread as proto, so lock the mode
            # in with a tiny echo before any real (possibly huge) request.
            self._writer.write(self._codec.encode_request(
                "echo", abci.RequestEcho(message="")))
            await self._writer.drain()
            await asyncio.wait_for(
                self._codec.decode_response_async(self._reader), timeout)

    async def _call(self, name: str, req):
        async with self._lock:
            # the first calls may come at once (the RPC's concurrent
            # check_txs on the mempool connection): connect under the lock,
            # or each would dial and the later dial would drop the
            # connection the earlier call is reading
            if self._writer is None:
                await self.connect()
            self._writer.write(self._codec.encode_request(name, req))
            await self._writer.drain()
            resp_name, resp = await self._codec.decode_response_async(self._reader)
        if resp_name == "exception":
            raise ClientError(resp)
        if resp_name != name:
            raise ClientError(f"out-of-order response: want {name}, got {resp_name}")
        return resp

    async def echo(self, msg: str) -> abci.ResponseEcho:
        return await self._call("echo", abci.RequestEcho(message=msg))

    async def flush(self) -> None:
        await self._call("flush", abci.RequestFlush())

    async def close(self) -> None:
        if self._writer is not None:
            self._writer.close()
            try:
                await self._writer.wait_closed()
            except Exception:  # noqa: BLE001
                pass
            self._writer = None
