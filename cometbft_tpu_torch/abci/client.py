"""ABCI clients, async: the in-process (local) transport.

Reference: abci/client/local_client.go (mutex-serialized in-proc calls). The
engine is asyncio-based; app calls are awaitable. Local calls run on a
worker thread under one app-wide lock (the app is a non-reentrant state
machine and must not block the event loop).

The port's copy of cometbft_tpu/abci/client.py's Client and LocalClient;
the socket client (and with it the wire codecs' stream framing) comes with
the node.
"""

from __future__ import annotations

import asyncio
import threading

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

