"""Peer: one remote node = one MConnection + its handshake identity.

Reference: p2p/peer.go:23 — wraps the multiplexed connection, carries the
NodeInfo learned in the handshake, a per-peer key/value store reactors hang
their PeerState on (peer.Set/Get, peer.go:356-366), and send helpers that
route by channel id. The port's copy of cometbft_tpu/p2p/peer.py.
"""

from __future__ import annotations

import asyncio
from typing import Optional

from cometbft_tpu_torch.libs import log as cmtlog
from cometbft_tpu_torch.libs.service import BaseService
from cometbft_tpu_torch.p2p.conn.connection import ChannelDescriptor, MConnConfig, MConnection
from cometbft_tpu_torch.p2p.conn.secret_connection import SecretConnection
from cometbft_tpu_torch.p2p.node_info import NodeInfo


class Peer(BaseService):
    def __init__(
        self,
        conn: SecretConnection,
        node_info: NodeInfo,
        channels: list[ChannelDescriptor],
        on_receive,  # async (chan_id, peer, msg_bytes)
        on_error,  # async (peer, err)
        outbound: bool,
        persistent: bool = False,
        mconn_config: MConnConfig | None = None,
        logger: cmtlog.Logger | None = None,
        metrics=None,  # libs.metrics.P2PMetrics | None
        peer_label: str = "",  # pre-capped metrics label (Switch assigns)
    ):
        super().__init__(f"peer-{node_info.node_id[:10]}", logger)
        self.node_info = node_info
        self.outbound = outbound
        self.persistent = persistent
        self._data: dict[str, object] = {}
        self._conn = conn

        async def _mconn_receive(chan_id: int, msg: bytes) -> None:
            await on_receive(chan_id, self, msg)

        async def _mconn_error(err: Exception) -> None:
            await on_error(self, err)

        self.mconn = MConnection(
            conn, channels, _mconn_receive, _mconn_error,
            config=mconn_config, logger=self.logger,
            metrics=metrics, peer_label=peer_label,
            peer_id=node_info.node_id,
        )

    # ------------------------------------------------------------- identity

    @property
    def id(self) -> str:
        return self.node_info.node_id

    @property
    def remote_host(self) -> str:
        """The remote socket host (through the netchaos wrapper's
        attribute forwarding) — the PEX book's source-group key."""
        return getattr(self._conn, "remote_host", "") or ""

    def is_persistent(self) -> bool:
        return self.persistent

    # ------------------------------------------------------------ lifecycle

    async def on_start(self) -> None:
        self.mconn.start()

    async def on_stop(self) -> None:
        await self.mconn.stop()

    # ----------------------------------------------------------------- send

    async def send(self, chan_id: int, msg: bytes) -> bool:
        """Blocking send (peer.go:261)."""
        if not self.is_running:
            return False
        return await self.mconn.send(chan_id, msg)

    def try_send(self, chan_id: int, msg: bytes) -> bool:
        """Non-blocking send; drops when the channel queue is full
        (peer.go:273)."""
        if not self.is_running:
            return False
        return self.mconn.try_send(chan_id, msg)

    # -------------------------------------------------------- per-peer data

    def set(self, key: str, value: object) -> None:
        self._data[key] = value

    def get(self, key: str) -> Optional[object]:
        return self._data.get(key)

    def status(self) -> dict:
        return self.mconn.status()

    def __repr__(self) -> str:
        arrow = "out" if self.outbound else "in"
        return f"Peer{{{self.id[:10]} {arrow}}}"
