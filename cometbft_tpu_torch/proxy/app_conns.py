"""AppConns: the engine's view of its application (async).

reference: proxy/multi_app_conn.go (4 named connections), proxy/app_conn.go
(per-connection facades). Each logical connection is its own Client so a
slow FinalizeBlock cannot block CheckTx — the isolation the reference gets
from 4 sockets.

The port's copy of cometbft_tpu/proxy/app_conns.py.
"""

from __future__ import annotations

import threading
from typing import Callable

from cometbft_tpu_torch.abci import types as abci
from cometbft_tpu_torch.abci.client import Client, LocalClient, SocketClient
from cometbft_tpu_torch.libs.service import BaseService

ClientCreator = Callable[[], Client]


def local_client_creator(app: abci.Application) -> ClientCreator:
    """All 4 connections share one lock + app instance
    (reference: proxy/client.go NewLocalClientCreator)."""
    lock = threading.Lock()
    return lambda: LocalClient(app, lock=lock)


def socket_client_creator(addr: str) -> ClientCreator:
    return lambda: SocketClient(addr)


def grpc_client_creator(addr: str) -> ClientCreator:
    """proxy/client.go NewRemoteClientCreator with transport=grpc."""
    def make():
        from cometbft_tpu_torch.abci.grpc import GRPCClient

        return GRPCClient(addr)

    return make


class AppConns(BaseService):
    """Owns the 4 logical connections (consensus/mempool/query/snapshot)."""

    def __init__(self, creator: ClientCreator):
        super().__init__("AppConns")
        self._creator = creator
        self.consensus: Client | None = None
        self.mempool: Client | None = None
        self.query: Client | None = None
        self.snapshot: Client | None = None

    async def on_start(self) -> None:
        self.query = self._creator()
        self.snapshot = self._creator()
        self.mempool = self._creator()
        self.consensus = self._creator()
        # liveness probe, as the reference pings with Echo on connect
        await self.query.echo("hello")

    async def on_stop(self) -> None:
        for c in (self.consensus, self.mempool, self.query, self.snapshot):
            if c is not None:
                await c.close()
