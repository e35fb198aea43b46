"""The state-sync engine (reference: statesync/syncer.go).

SyncAny loop: pick the best offered snapshot, anchor its app hash in
light-client-verified headers, OfferSnapshot to the app, fetch chunks in
parallel, apply them in order, then verify the restored app (Info) against
the trusted app hash. Error taxonomy mirrors the reference:

  ErrAbort          — app said abort: give up state sync entirely
  ErrRetrySnapshot  — refetch every chunk of the same snapshot
  ErrRejectSnapshot — discard this snapshot, try the next
  ErrRejectFormat   — discard every snapshot of this format
  ErrRejectSender   — ban this snapshot's senders
  ErrNoSnapshots    — nothing (left) to try

The port's copy of cometbft_tpu/statesync/syncer.py.
"""

from __future__ import annotations

import asyncio
from typing import Callable, Optional

from cometbft_tpu_torch.abci import types as abci
from cometbft_tpu_torch.libs import log as cmtlog
from cometbft_tpu_torch.statesync.chunks import ChunkQueue, ErrQueueClosed
from cometbft_tpu_torch.statesync.provider import StateProvider
from cometbft_tpu_torch.statesync.snapshots import Snapshot, SnapshotPool

CHUNK_FETCHERS = 4  # config statesync.chunk_fetchers
CHUNK_TIMEOUT = 15.0


class ErrAbort(Exception):
    pass


class ErrRetrySnapshot(Exception):
    pass


class ErrRejectSnapshot(Exception):
    pass


class ErrRejectFormat(Exception):
    pass


class ErrRejectSender(Exception):
    pass


class ErrNoSnapshots(Exception):
    pass


class Syncer:
    """syncer.go:40-520."""

    def __init__(
        self,
        state_provider: StateProvider,
        snapshot_conn,  # abci client (proxy snapshot connection)
        request_chunk: Callable[[str, Snapshot, int], "asyncio.Future | None"],
        logger: cmtlog.Logger | None = None,
        chunk_fetchers: int = CHUNK_FETCHERS,
        chunk_timeout: float = CHUNK_TIMEOUT,
    ):
        self.state_provider = state_provider
        self.conn = snapshot_conn
        self.request_chunk = request_chunk  # (peer_id, snapshot, index) -> None
        self.logger = logger or cmtlog.nop()
        self.pool = SnapshotPool()
        self.chunk_fetchers = chunk_fetchers
        self.chunk_timeout = chunk_timeout
        self._chunks: Optional[ChunkQueue] = None
        self._snapshot: Optional[Snapshot] = None

    # ------------------------------------------------------------- intake

    def add_snapshot(self, peer_id: str, snapshot: Snapshot) -> bool:
        return self.pool.add(peer_id, snapshot)

    async def add_chunk(self, index: int, chunk: bytes, sender: str) -> bool:
        if self._chunks is None:
            return False
        return await self._chunks.add(index, chunk, sender)

    def remove_peer(self, peer_id: str) -> None:
        self.pool.remove_peer(peer_id)

    # --------------------------------------------------------------- sync

    async def sync_any(self, discovery_time: float = 0.0,
                       retry_hook: Callable[[], None] | None = None):
        """syncer.go:145-238: -> (state, commit)."""
        if discovery_time:
            await asyncio.sleep(discovery_time)
        snapshot: Optional[Snapshot] = None
        chunks: Optional[ChunkQueue] = None
        while True:
            if snapshot is None:
                snapshot = self.pool.best()
                chunks = None
            if snapshot is None:
                if not discovery_time:
                    raise ErrNoSnapshots
                if retry_hook is not None:
                    retry_hook()
                await asyncio.sleep(discovery_time)
                continue
            if chunks is None:
                chunks = ChunkQueue(snapshot.chunks)
            try:
                return await self.sync(snapshot, chunks)
            except ErrAbort:
                raise
            except ErrRetrySnapshot:
                await chunks.retry_all()
                self.logger.info("retrying snapshot", height=snapshot.height)
                continue
            except TimeoutError:
                self.pool.reject(snapshot)
                self.logger.error("timed out waiting for chunks; snapshot rejected",
                                  height=snapshot.height)
            except ErrRejectSnapshot:
                self.pool.reject(snapshot)
                self.logger.info("snapshot rejected", height=snapshot.height)
            except ErrRejectFormat:
                self.pool.reject_format(snapshot.format)
                self.logger.info("snapshot format rejected", format=snapshot.format)
            except ErrRejectSender:
                self.logger.info("snapshot senders rejected", height=snapshot.height)
                for pid in self.pool.peers_of(snapshot):
                    self.pool.reject_peer(pid)
            await chunks.close()
            snapshot = None
            chunks = None

    async def sync(self, snapshot: Snapshot, chunks: ChunkQueue):
        """syncer.go:241-320."""
        if self._chunks is not None:
            raise RuntimeError("a state sync is already in progress")
        self._chunks = chunks
        self._snapshot = snapshot
        fetchers: list[asyncio.Task] = []
        try:
            # anchor the app hash in light-client-verified headers BEFORE
            # offering anything to the app
            try:
                trusted_app_hash = await self.state_provider.app_hash(snapshot.height)
            except Exception as e:  # noqa: BLE001 - unverifiable: reject
                self.logger.info("failed to fetch and verify app hash", err=str(e))
                raise ErrRejectSnapshot from e

            await self._offer_snapshot(snapshot, trusted_app_hash)

            for _ in range(self.chunk_fetchers):
                fetchers.append(asyncio.create_task(
                    self._fetch_chunks(snapshot, chunks)))

            state = await self.state_provider.state(snapshot.height)
            commit = await self.state_provider.commit(snapshot.height)

            await self._apply_chunks(chunks)
            await self._verify_app(snapshot, trusted_app_hash, state.app_version)
            self.logger.info("snapshot restored", height=snapshot.height)
            return state, commit
        finally:
            for t in fetchers:
                t.cancel()
            self._chunks = None
            self._snapshot = None

    async def _offer_snapshot(self, snapshot: Snapshot, app_hash: bytes) -> None:
        """syncer.go:322-355."""
        resp = await self.conn.offer_snapshot(abci.RequestOfferSnapshot(
            snapshot=abci.Snapshot(
                height=snapshot.height, format_=snapshot.format,
                chunks=snapshot.chunks, hash=snapshot.hash_,
                metadata=snapshot.metadata,
            ),
            app_hash=app_hash,
        ))
        r = resp.result
        if r == abci.OfferSnapshotResult.ACCEPT:
            return
        if r == abci.OfferSnapshotResult.ABORT:
            raise ErrAbort("app aborted state sync")
        if r == abci.OfferSnapshotResult.REJECT:
            raise ErrRejectSnapshot
        if r == abci.OfferSnapshotResult.REJECT_FORMAT:
            raise ErrRejectFormat
        if r == abci.OfferSnapshotResult.REJECT_SENDER:
            raise ErrRejectSender
        raise ErrRejectSnapshot(f"unknown OfferSnapshot result {r}")

    async def _fetch_chunks(self, snapshot: Snapshot, chunks: ChunkQueue) -> None:
        """syncer.go:415-463: one fetcher loop."""
        rr = 0
        while True:
            try:
                index = await chunks.allocate()
            except ErrQueueClosed:
                return
            if index is None:
                if chunks.done():
                    return
                await asyncio.sleep(0.1)
                continue
            peers = self.pool.peers_of(snapshot)
            if peers:
                peer = peers[rr % len(peers)]
                rr += 1
                try:
                    self.request_chunk(peer, snapshot, index)
                except Exception as e:  # noqa: BLE001
                    self.logger.error("chunk request failed", index=index, err=str(e))
            await asyncio.sleep(0)

    async def _apply_chunks(self, chunks: ChunkQueue) -> None:
        """syncer.go:358-413."""
        while not chunks.done():
            index, chunk = await chunks.next_chunk(timeout=self.chunk_timeout)
            resp = await self.conn.apply_snapshot_chunk(
                abci.RequestApplySnapshotChunk(
                    index=index, chunk=chunk, sender=chunks.sender_of(index)))
            for i in resp.refetch_chunks:
                await chunks.retry(i)
            for pid in resp.reject_senders:
                self.pool.reject_peer(pid)
            r = resp.result
            if r == abci.ApplySnapshotChunkResult.ACCEPT:
                continue
            if r == abci.ApplySnapshotChunkResult.ABORT:
                raise ErrAbort("app aborted during chunk apply")
            if r == abci.ApplySnapshotChunkResult.RETRY:
                await chunks.retry(index)
            elif r == abci.ApplySnapshotChunkResult.RETRY_SNAPSHOT:
                raise ErrRetrySnapshot
            elif r == abci.ApplySnapshotChunkResult.REJECT_SNAPSHOT:
                raise ErrRejectSnapshot
            else:
                raise ErrRejectSnapshot(f"unknown ApplySnapshotChunk result {r}")

    async def _verify_app(self, snapshot: Snapshot, trusted_app_hash: bytes,
                          app_version: int) -> None:
        """syncer.go:485-520: the restored app must report the trusted hash
        at the snapshot height."""
        resp = await self.conn.info(abci.RequestInfo())
        if resp.last_block_app_hash != trusted_app_hash:
            raise ErrRejectSnapshot(
                f"app hash mismatch after restore: got "
                f"{resp.last_block_app_hash.hex()}, want {trusted_app_hash.hex()}"
            )
        if resp.last_block_height != snapshot.height:
            raise ErrRejectSnapshot(
                f"app height mismatch after restore: got {resp.last_block_height}, "
                f"want {snapshot.height}"
            )
