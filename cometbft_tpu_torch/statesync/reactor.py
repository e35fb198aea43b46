"""Statesync reactor (reference: statesync/reactor.go).

Serves local snapshots to catching-up peers (ListSnapshots /
LoadSnapshotChunk via the app's snapshot connection) and feeds incoming
offers/chunks into the Syncer. Sync() drives the whole bootstrap and hands
(state, commit) to the node, which persists them and switches to blocksync
(node.go fast-sync handoff).

The port's copy of cometbft_tpu/statesync/reactor.py.
"""

from __future__ import annotations

import asyncio
from typing import Optional

from cometbft_tpu_torch.abci import types as abci
from cometbft_tpu_torch.libs import log as cmtlog
from cometbft_tpu_torch.p2p.base_reactor import Envelope, Reactor
from cometbft_tpu_torch.p2p.conn.connection import ChannelDescriptor
from cometbft_tpu_torch.statesync import messages as sm
from cometbft_tpu_torch.statesync.snapshots import Snapshot
from cometbft_tpu_torch.statesync.syncer import Syncer

RECENT_SNAPSHOTS = 10  # reactor.go:30


class StatesyncReactor(Reactor):
    """reactor.go:38-280."""

    def __init__(self, snapshot_conn, state_provider=None,
                 logger: cmtlog.Logger | None = None,
                 chunk_timeout: float = 15.0):
        super().__init__("StatesyncReactor", logger)
        self.conn = snapshot_conn
        self.syncer: Optional[Syncer] = None
        if state_provider is not None:
            self.syncer = Syncer(
                state_provider, snapshot_conn, self._request_chunk,
                logger=self.logger, chunk_timeout=chunk_timeout,
            )

    def get_channels(self) -> list[ChannelDescriptor]:
        return [
            ChannelDescriptor(id=sm.SNAPSHOT_CHANNEL, priority=5,
                              send_queue_capacity=10),
            ChannelDescriptor(id=sm.CHUNK_CHANNEL, priority=3,
                              send_queue_capacity=16),
        ]

    # ---------------------------------------------------------- lifecycle

    async def add_peer(self, peer) -> None:
        """reactor.go:103-110: ask every new peer for its snapshots while
        we are syncing."""
        if self.syncer is not None:
            await peer.send(sm.SNAPSHOT_CHANNEL, sm.encode(sm.SnapshotsRequest()))

    async def remove_peer(self, peer, reason) -> None:
        if self.syncer is not None:
            self.syncer.remove_peer(peer.id)

    # ------------------------------------------------------------ receive

    async def receive(self, e: Envelope) -> None:
        try:
            msg = sm.decode(e.message)
        except Exception as err:  # noqa: BLE001
            self.logger.error("bad statesync message", err=str(err))
            return
        if isinstance(msg, sm.SnapshotsRequest):
            await self._serve_snapshots(e.src)
        elif isinstance(msg, sm.SnapshotsResponse):
            if self.syncer is not None:
                self.syncer.add_snapshot(
                    e.src.id,
                    Snapshot(height=msg.height, format=msg.format,
                             chunks=msg.chunks, hash_=msg.hash_,
                             metadata=msg.metadata),
                )
        elif isinstance(msg, sm.ChunkRequest):
            await self._serve_chunk(e.src, msg)
        elif isinstance(msg, sm.ChunkResponse):
            if self.syncer is not None and not msg.missing:
                await self.syncer.add_chunk(msg.index, msg.chunk, e.src.id)

    async def _serve_snapshots(self, peer) -> None:
        """reactor.go:121-146: up to the 10 newest local snapshots."""
        resp = await self.conn.list_snapshots(abci.RequestListSnapshots())
        snaps = sorted(resp.snapshots, key=lambda s: (s.height, s.format_),
                       reverse=True)[:RECENT_SNAPSHOTS]
        for s in snaps:
            await peer.send(sm.SNAPSHOT_CHANNEL, sm.encode(sm.SnapshotsResponse(
                height=s.height, format=s.format_, chunks=s.chunks,
                hash_=s.hash, metadata=s.metadata)))

    async def _serve_chunk(self, peer, msg: sm.ChunkRequest) -> None:
        """reactor.go:148-175."""
        resp = await self.conn.load_snapshot_chunk(abci.RequestLoadSnapshotChunk(
            height=msg.height, format_=msg.format, chunk=msg.index))
        await peer.send(sm.CHUNK_CHANNEL, sm.encode(sm.ChunkResponse(
            height=msg.height, format=msg.format, index=msg.index,
            chunk=resp.chunk, missing=not resp.chunk)))

    # ------------------------------------------------------------- egress

    def _request_chunk(self, peer_id: str, snapshot, index: int) -> None:
        """Syncer callback: fire a chunk request at a specific peer."""
        if self.switch is None:
            return
        peer = self.switch.peers.get(peer_id)
        if peer is None:
            return
        asyncio.get_running_loop().create_task(
            peer.send(sm.CHUNK_CHANNEL, sm.encode(sm.ChunkRequest(
                height=snapshot.height, format=snapshot.format, index=index))))

    # --------------------------------------------------------------- sync

    async def sync(self, discovery_time: float = 3.0):
        """Drive a full state sync; returns (state, commit) for the node
        to bootstrap from (node.go stateSync handoff)."""
        if self.syncer is None:
            raise RuntimeError("statesync reactor has no state provider")
        return await self.syncer.sync_any(discovery_time)
