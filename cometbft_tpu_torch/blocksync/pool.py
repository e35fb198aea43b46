"""BlockPool: parallel height requesters for catch-up sync.

Reference: blocksync/pool.go — up to 600 in-flight height requesters
(pool.go:22-26), <=20 pending per peer, each requester owning one height:
pick a peer, send the request, wait for the block (retry elsewhere on
timeout/redo). The pool exposes peek_two_blocks/pop_request/redo_request
to the reactor's apply loop.

asyncio redesign: one task per requester (goroutine analog); peer pick
waits on a condition instead of the reference's retry ticker.

The port's copy of cometbft_tpu/blocksync/pool.py.
"""

from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

from cometbft_tpu_torch.libs import log as cmtlog
from cometbft_tpu_torch.libs.service import BaseService, TaskRunner
from cometbft_tpu_torch.types.block import Block
from cometbft_tpu_torch.types.commit import ExtendedCommit

MAX_TOTAL_REQUESTERS = 600  # pool.go:36-42
MAX_PENDING_REQUESTS_PER_PEER = 20
REQUEST_TIMEOUT = 15.0
POOL_SPAWN_INTERVAL = 0.01

# a peer that hasn't sent us anything for this long while owing blocks is
# considered stalled (pool.go minRecvRate analog, simplified to a deadline)


@dataclass
class _BPPeer:
    peer_id: str
    base: int
    height: int
    num_pending: int = 0


@dataclass
class _BPRequester:
    height: int
    peer_id: str = ""
    block: Optional[Block] = None
    ext_commit: Optional[ExtendedCommit] = None
    banned: set = field(default_factory=set)  # peers tried and failed
    got_block: asyncio.Event = field(default_factory=asyncio.Event)
    task: Optional[asyncio.Task] = None


class BlockPool(BaseService):
    """pool.go:63 BlockPool."""

    def __init__(
        self,
        start_height: int,
        send_request: Callable[[int, str], "asyncio.Future | object"],
        on_peer_error: Callable[[str, str], None],
        logger: cmtlog.Logger | None = None,
    ):
        super().__init__("BlockPool", logger)
        self.height = start_height  # next height to process
        self.start_height = start_height
        self._send_request = send_request  # async fn(height, peer_id) -> bool
        self._on_peer_error = on_peer_error  # fn(reason, peer_id)
        self.peers: dict[str, _BPPeer] = {}
        self.requesters: dict[int, _BPRequester] = {}
        self.max_peer_height = 0
        self._tasks = TaskRunner("blockpool")
        self._peer_cond: asyncio.Event = asyncio.Event()
        self._started_at = 0.0
        self.blocks_synced = 0

    # ----------------------------------------------------------- lifecycle

    async def on_start(self) -> None:
        self._started_at = time.monotonic()
        self._tasks.spawn(self._make_requesters_routine(), name="bp-spawner")

    async def on_stop(self) -> None:
        for r in self.requesters.values():
            if r.task is not None:
                r.task.cancel()
        await self._tasks.cancel_all()

    # --------------------------------------------------------------- peers

    def set_peer_range(self, peer_id: str, base: int, height: int) -> None:
        """pool.go SetPeerRange: called on StatusResponse."""
        p = self.peers.get(peer_id)
        if p is not None:
            p.base, p.height = base, height
        else:
            self.peers[peer_id] = _BPPeer(peer_id, base, height)
        if height > self.max_peer_height:
            self.max_peer_height = height
        self._peer_cond.set()

    def remove_peer(self, peer_id: str) -> None:
        """pool.go RemovePeer: redo every requester of the peer elsewhere,
        the ones holding a block it delivered included (pool.go
        removePeer -> requester.redo). The reference keeps those blocks, so
        a peer stopped for a bad block still has its other blocks applied
        or failed one window at a time."""
        self.peers.pop(peer_id, None)
        for r in self.requesters.values():
            if r.peer_id == peer_id:
                r.banned.add(peer_id)
                r.block = None
                r.ext_commit = None
                r.got_block.set()  # wake the task; it will retry
        self.max_peer_height = max((p.height for p in self.peers.values()), default=0)

    # -------------------------------------------------------------- blocks

    def add_block(self, peer_id: str, block: Block, ext_commit: ExtendedCommit | None,
                  _size: int) -> None:
        """pool.go AddBlock: only the assigned requester may deliver."""
        r = self.requesters.get(block.header.height)
        if r is None:
            # late/unsolicited block: height already processed or never asked
            if block.header.height > self.height:
                self._on_peer_error("unsolicited block", peer_id)
            return
        if r.peer_id != peer_id or r.block is not None:
            self._on_peer_error("block from wrong peer or duplicate", peer_id)
            return
        r.block = block
        r.ext_commit = ext_commit
        p = self.peers.get(peer_id)
        if p is not None:
            p.num_pending = max(0, p.num_pending - 1)
        r.got_block.set()

    def peek_two_blocks(self):
        """pool.go PeekTwoBlocks: (first, first_ext, second) or Nones."""
        r1 = self.requesters.get(self.height)
        r2 = self.requesters.get(self.height + 1)
        first = r1.block if r1 is not None else None
        first_ext = r1.ext_commit if r1 is not None else None
        second = r2.block if r2 is not None else None
        return first, first_ext, second

    def block_at(self, height: int):
        r = self.requesters.get(height)
        return (r.block, r.ext_commit) if r is not None else (None, None)

    def peer_of(self, height: int) -> str:
        r = self.requesters.get(height)
        return r.peer_id if r is not None else ""

    def pop_request(self) -> None:
        """pool.go PopRequest: height verified + applied."""
        r = self.requesters.pop(self.height, None)
        if r is not None and r.task is not None:
            r.task.cancel()
        self.height += 1
        self.blocks_synced += 1

    def redo_request(self, height: int) -> str:
        """pool.go RedoRequest: bad block — drop it and retry elsewhere.
        Returns the peer that served it (for punishment)."""
        r = self.requesters.get(height)
        if r is None:
            return ""
        bad_peer = r.peer_id
        r.banned.add(bad_peer)
        r.block = None
        r.ext_commit = None
        r.got_block.set()  # wake task to re-request
        return bad_peer

    # -------------------------------------------------------------- status

    def is_caught_up(self) -> bool:
        """pool.go IsCaughtUp: never claims caught-up with zero peers —
        a node that is behind must keep waiting for its peers to appear
        rather than limp into consensus."""
        if not self.peers:
            return False
        return self.height >= self.max_peer_height

    def sync_rate(self) -> float:
        dt = time.monotonic() - self._started_at
        return self.blocks_synced / dt if dt > 0 else 0.0

    # ----------------------------------------------------------- requesters

    async def _make_requesters_routine(self) -> None:
        """pool.go:108 makeRequestersRoutine."""
        while True:
            next_h = self.height + len(self.requesters)
            if (
                len(self.requesters) < MAX_TOTAL_REQUESTERS
                and next_h <= self.max_peer_height
            ):
                r = _BPRequester(height=next_h)
                self.requesters[next_h] = r
                r.task = self._tasks.spawn(
                    self._requester_routine(r), name=f"bp-req-{next_h}"
                )
            else:
                await asyncio.sleep(POOL_SPAWN_INTERVAL)

    def _pick_peer(self, r: _BPRequester) -> Optional[_BPPeer]:
        best = None
        for p in self.peers.values():
            if p.peer_id in r.banned or p.num_pending >= MAX_PENDING_REQUESTS_PER_PEER:
                continue
            if not (p.base <= r.height <= p.height):
                continue
            if best is None or p.num_pending < best.num_pending:
                best = p
        return best

    async def _requester_routine(self, r: _BPRequester) -> None:
        """pool.go:394 requestRoutine: acquire a block, hold it until the
        pool pops the height (task cancelled) or redoes it (loop back)."""
        while True:
            while r.block is None:
                peer = self._pick_peer(r)
                if peer is None:
                    if r.banned and self.peers and len(r.banned) >= len(self.peers):
                        r.banned.clear()  # every peer failed once: forgive, retry
                    self._peer_cond.clear()
                    try:
                        await asyncio.wait_for(self._peer_cond.wait(), 0.25)
                    except asyncio.TimeoutError:
                        pass
                    continue
                r.peer_id = peer.peer_id
                peer.num_pending += 1
                r.got_block.clear()
                try:
                    await self._send_request(r.height, peer.peer_id)
                    await asyncio.wait_for(r.got_block.wait(), REQUEST_TIMEOUT)
                except asyncio.TimeoutError:
                    peer.num_pending = max(0, peer.num_pending - 1)
                    r.banned.add(peer.peer_id)
                    self._on_peer_error("block request timed out", peer.peer_id)
                except Exception as e:  # noqa: BLE001 - send failure: try another peer
                    peer.num_pending = max(0, peer.num_pending - 1)
                    r.banned.add(peer.peer_id)
                    self.logger.debug("request send failed", height=r.height, err=str(e))
                # got_block fired (block / redo / remove) or timed out: re-check
            while r.block is not None:
                r.got_block.clear()
                await r.got_block.wait()
            # redo_request dropped the block: acquire again
