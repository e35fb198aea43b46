"""Blocksync reactor: catch up by downloading blocks from peers.

Reference: blocksync/reactor.go — channel 0x40, pool-driven parallel
requesters, VerifyCommitLight per height (reactor.go:463), ValidateBlock,
SaveBlock, ApplyBlock, then SwitchToConsensus (reactor.go:286-330).

The batched redesign of the verify loop (BASELINE config 3):
instead of one synchronous commit verification at a time, a WINDOW of
consecutive ready heights is staged through verify_batch_async — host
staging of commit N+1 overlaps device compute of commit N, and the whole
window's masks come back in one device fetch (resolve_batches). Each commit
is verified ONCE on device with full verify_commit semantics (covering both
the reference's VerifyCommitLight pre-check and validateBlock's re-check,
which ApplyBlock then skips via last_commit_verified).

The port's copy of cometbft_tpu/blocksync/reactor.py. The
commit-certificate exchange waits for cert/plane.py: `cert_plane=` takes
None only and the 0x25 channel is not offered.
"""

from __future__ import annotations

import asyncio
import time

from cometbft_tpu_torch.blocksync import messages as bm
from cometbft_tpu_torch.blocksync.pool import BlockPool
from cometbft_tpu_torch.libs import log as cmtlog
from cometbft_tpu_torch.libs import trace
from cometbft_tpu_torch.libs.service import TaskRunner
from cometbft_tpu_torch.p2p.base_reactor import Envelope, Reactor
from cometbft_tpu_torch.p2p.conn.connection import ChannelDescriptor
from cometbft_tpu_torch.types import validation
from cometbft_tpu_torch.types.basic import BlockID

BLOCKSYNC_CHANNEL = 0x40
BLOCK_PART_SIZE = 65536
STATUS_UPDATE_INTERVAL = 10.0
VERIFY_WINDOW = 8  # heights staged on device concurrently
TRY_SYNC_INTERVAL = 0.01


class BlocksyncReactor(Reactor):
    def __init__(
        self,
        block_exec,
        block_store,
        active: bool,
        consensus_reactor=None,
        window: int = VERIFY_WINDOW,
        cert_plane=None,
        logger: cmtlog.Logger | None = None,
    ):
        if cert_plane is not None:
            raise NotImplementedError("BlocksyncReactor(cert_plane=) waits for cert/plane.py")
        super().__init__("Blocksync", logger)
        self.block_exec = block_exec
        self.block_store = block_store
        self.active = active  # syncing (vs serving only)
        self.consensus_reactor = consensus_reactor
        self.window = window
        self.state = None  # set via set_state before start
        self.pool: BlockPool | None = None
        self._tasks = TaskRunner("blocksync")
        self._verified_commits: set[bytes] = set()
        self._status_task = None
        self.synced_at: float = 0.0
        self.device_busy_s: float = 0.0  # time spent waiting on device masks
        # the window's other parts: staging (host rows, dispatch) and the
        # finish/validate/apply loop, and the windows prefetched
        self.stage_s: float = 0.0
        self.apply_s: float = 0.0
        self.windows = 0

    def set_state(self, state) -> None:
        self.state = state

    # ------------------------------------------------------------- channels

    def get_channels(self) -> list[ChannelDescriptor]:
        """The block channel only: without a cert plane the 0x25
        certificate channel is not offered, so no peer sends on it."""
        return [
            ChannelDescriptor(
                id=BLOCKSYNC_CHANNEL, priority=5, send_queue_capacity=1000,
                recv_message_capacity=1 << 22,
            )
        ]

    # ------------------------------------------------------------ lifecycle

    async def on_start(self) -> None:
        if self.active:
            await self._start_sync()

    async def _start_sync(self) -> None:
        if self.state is None:
            raise RuntimeError("BlocksyncReactor.set_state before start")
        self.pool = BlockPool(
            self.state.last_block_height + 1 if self.state.last_block_height
            else self.state.initial_height,
            self._send_block_request,
            self._on_pool_peer_error,
            logger=self.logger,
        )
        await self.pool.start()
        self._tasks.spawn(self._pool_routine(), name="bcs-pool")
        self._status_task = self._tasks.spawn(
            self._status_broadcast_routine(), name="bcs-status")

    async def activate(self, state) -> None:
        """Start syncing AFTER boot — the statesync handoff (node.go
        stateSync -> blockSync switch): the pool begins at the restored
        state's height + 1."""
        if self.active:
            return
        self.active = True
        self.state = state
        await self._start_sync()
        # peers that connected while we were state-syncing: ask for their
        # ranges right away (the broadcast routine also fires immediately,
        # this is belt-and-braces for a changed interval)
        if self.switch is not None:
            self.switch.broadcast(BLOCKSYNC_CHANNEL, bm.encode(bm.StatusRequest()))

    async def on_stop(self) -> None:
        await self._tasks.cancel_all()
        if self.pool is not None and self.pool.is_running:
            await self.pool.stop()

    # ----------------------------------------------------------------- p2p

    async def add_peer(self, peer) -> None:
        """reactor.go AddPeer: advertise our range."""
        await peer.send(BLOCKSYNC_CHANNEL, bm.encode(
            bm.StatusResponse(self.block_store.height(), self.block_store.base())))

    async def remove_peer(self, peer, reason) -> None:
        if self.pool is not None:
            self.pool.remove_peer(peer.id)

    async def receive(self, e: Envelope) -> None:
        try:
            msg = bm.decode(e.message)
        except Exception as err:  # noqa: BLE001
            self.logger.error("bad blocksync message", err=str(err), peer=e.src.id)
            await self._punish(e.src.id, f"undecodable message: {err}")
            return
        if isinstance(msg, (bm.CertRequest, bm.CertResponse, bm.NoCertResponse)):
            return  # certificate frames belong to the 0x25 channel, not offered
        if isinstance(msg, bm.StatusRequest):
            await e.src.send(BLOCKSYNC_CHANNEL, bm.encode(
                bm.StatusResponse(self.block_store.height(), self.block_store.base())))
        elif isinstance(msg, bm.StatusResponse):
            if self.active and self.pool is not None:
                self.pool.set_peer_range(e.src.id, msg.base, msg.height)
        elif isinstance(msg, bm.BlockRequest):
            await self._respond_to_block_request(msg, e.src)
        elif isinstance(msg, bm.NoBlockResponse):
            self.logger.debug("peer has no block", height=msg.height, peer=e.src.id)
        elif isinstance(msg, bm.BlockResponse):
            if self.active and self.pool is not None:
                self.pool.add_block(e.src.id, msg.block, msg.ext_commit, len(e.message))

    async def _respond_to_block_request(self, msg: bm.BlockRequest, peer) -> None:
        """reactor.go respondToPeer."""
        block = self.block_store.load_block(msg.height)
        if block is None:
            await peer.send(BLOCKSYNC_CHANNEL, bm.encode(bm.NoBlockResponse(msg.height)))
            return
        ext = self.block_store.load_block_extended_commit(msg.height)
        await peer.send(BLOCKSYNC_CHANNEL, bm.encode(bm.BlockResponse(block, ext)))

    # ------------------------------------------------------------ pool glue

    async def _send_block_request(self, height: int, peer_id: str) -> None:
        peer = self.switch.get_peer(peer_id) if self.switch else None
        if peer is None:
            raise ConnectionError(f"peer {peer_id} gone")
        ok = await peer.send(BLOCKSYNC_CHANNEL, bm.encode(bm.BlockRequest(height)))
        if not ok:
            raise ConnectionError(f"send to {peer_id} failed")

    def _on_pool_peer_error(self, reason: str, peer_id: str) -> None:
        task = self._punish(peer_id, reason)
        self._tasks.spawn(task, name="bcs-punish")

    async def _punish(self, peer_id: str, reason: str) -> None:
        if self.switch is None:
            return
        peer = self.switch.get_peer(peer_id)
        if peer is not None:
            await self.switch.stop_peer_for_error(peer, reason)

    # --------------------------------------------------------- status bcast

    async def _status_broadcast_routine(self) -> None:
        while True:
            if self.switch is not None:
                self.switch.broadcast(BLOCKSYNC_CHANNEL, bm.encode(bm.StatusRequest()))
            await asyncio.sleep(STATUS_UPDATE_INTERVAL)

    # ------------------------------------------------- the TPU apply loop

    async def _pool_routine(self) -> None:
        """reactor.go:286 poolRoutine, windowed AND pipelined: while window
        N's masks are in flight on the device, window N+1 is staged (the
        host-heavy part: sign-bytes + SHA-512 challenges + dispatch), so
        the device never idles between windows. The staged-ahead window is
        used only if the pool height after applying window N lands exactly
        on its first height; any redo/invalid-block path discards it (the
        staging is speculative work, never speculative state)."""
        chain_id = self.state.chain_id
        staged_ahead: list | None = None
        while True:
            if self.pool.is_caught_up():
                await self._switch_to_consensus()
                return
            if staged_ahead and staged_ahead[0][0] == self.pool.height:
                entries = staged_ahead
            else:
                t0 = time.monotonic()
                entries = self._stage_window(chain_id, self.pool.height)
                self.stage_s += time.monotonic() - t0
            staged_ahead = None
            if not entries:
                await asyncio.sleep(TRY_SYNC_INTERVAL)
                continue
            # device->host mask fetch must not stall the p2p event loop;
            # timing runs INSIDE the worker so device_busy_s measures the
            # fetch alone, not the overlapped staging below
            # sync-class: the window yields the device to consensus-
            # critical flushes in the global verify scheduler, and queued
            # mempool-admission rows ride the window batch as filler
            def _timed_prefetch(batch=[e[-1] for e in entries], h0=entries[0][0]):
                t0 = time.monotonic()
                # root span per verify window (fresh context on the
                # executor thread): a slow window keeps its full tree —
                # header fetch, payload pulls, host re-checks — in the
                # slow-batch capture ring
                with trace.span("sync.window", cat="sync", height=h0,
                                heights=len(batch)):
                    validation.prefetch_staged(batch, klass="sync")
                return time.monotonic() - t0

            fetch = asyncio.get_running_loop().run_in_executor(
                None, _timed_prefetch)
            # overlap: stage the next window while the fetch is in flight
            # (same valset assumption — _stage_window stops at a change)
            t0 = time.monotonic()
            staged_ahead = self._stage_window(chain_id, entries[-1][0] + 1)
            self.stage_s += time.monotonic() - t0
            self.device_busy_s += await fetch
            self.windows += 1
            t0 = time.monotonic()
            for h, first, first_ext, second, parts, first_id, staged in entries:
                if h != self.pool.height:
                    break  # an earlier redo shifted the window
                try:
                    staged.finish()
                    self._check_extensions(first, first_ext)
                    lc_ok = (
                        first.last_commit is not None
                        and first.last_commit.hash() in self._verified_commits
                    )
                    self.block_exec.validate_block(
                        self.state, first, last_commit_verified=lc_ok)
                except Exception as err:  # noqa: BLE001 - bad block: redo + punish
                    self.logger.error("invalid block in sync", height=h, err=str(err))
                    p1 = self.pool.redo_request(h)
                    p2 = self.pool.redo_request(h + 1)
                    for pid in {p1, p2} - {""}:
                        await self._punish(pid, f"sent invalid block {h}: {err}")
                    break
                # commit for height h (second.last_commit) is device-verified
                self._remember_verified(second.last_commit.hash())
                self.pool.pop_request()
                if self.state.consensus_params.abci.vote_extensions_enabled(h):
                    self.block_store.save_block_with_extended_commit(
                        first, parts, first_ext)
                else:
                    self.block_store.save_block(first, parts, second.last_commit)
                self.state = await self.block_exec.apply_block(
                    self.state, first_id, first, validated=True)
                if self.pool.blocks_synced % 100 == 0:
                    self.logger.info(
                        "block sync rate", height=self.pool.height,
                        max_peer=self.pool.max_peer_height,
                        bps=round(self.pool.sync_rate(), 1))
            self.apply_s += time.monotonic() - t0

    def _stage_window(self, chain_id: str, start_height: int):
        """Stage up to `window` consecutive verifications from
        start_height. Stops at a valset change boundary (staged batches
        assume the current valset)."""
        entries = []
        h = start_height
        vals = self.state.validators
        vals_hash = vals.hash()
        with trace.span("sync.stage_window", cat="sync",
                        height=start_height) as stage_sp:
            try:
                self._stage_window_inner(chain_id, vals, vals_hash, h,
                                         entries)
            finally:
                stage_sp.set(heights=len(entries))
        return entries

    def _stage_window_inner(self, chain_id: str, vals, vals_hash,
                            h: int, entries: list) -> None:
        while len(entries) < self.window:
            first, first_ext = self.pool.block_at(h)
            second, _ = self.pool.block_at(h + 1)
            if first is None or second is None:
                break
            if first.header.validators_hash != vals_hash:
                # valset changes at h: process what we have; the rest after
                # state catches up (next loop uses the updated valset)
                break
            parts = first.make_part_set(BLOCK_PART_SIZE)
            first_id = BlockID(hash=first.hash(), part_set_header=parts.header())
            try:
                staged = validation.stage_verify_commit(
                    chain_id, vals, first_id, h, second.last_commit)
            except Exception as err:  # noqa: BLE001 - structurally bad: redo now
                self.logger.error("commit rejected in staging", height=h, err=str(err))
                p1 = self.pool.redo_request(h)
                p2 = self.pool.redo_request(h + 1)
                for pid in {p1, p2} - {""}:
                    self._on_pool_peer_error(f"bad commit for {h}: {err}", pid)
                break
            entries.append((h, first, first_ext, second, parts, first_id, staged))
            h += 1

    def _check_extensions(self, first, first_ext) -> None:
        """reactor.go:471-480."""
        if self.state.consensus_params.abci.vote_extensions_enabled(first.header.height):
            if first_ext is None:
                raise ValueError(
                    f"no extended commit for height {first.header.height} "
                    "(extensions enabled)")
            first_ext.ensure_extensions(True)
        elif first_ext is not None:
            raise ValueError(
                f"non-nil extended commit for height {first.header.height} "
                "(extensions disabled)")

    def _remember_verified(self, commit_hash: bytes) -> None:
        if len(self._verified_commits) > 4096:
            self._verified_commits.clear()
        self._verified_commits.add(commit_hash)

    # ----------------------------------------------------------- handoff

    async def _switch_to_consensus(self) -> None:
        """reactor.go:286-330 SwitchToConsensus."""
        self.synced_at = time.monotonic()
        if self._status_task is not None:
            self._status_task.cancel()
            self._status_task = None
        self.logger.info(
            "caught up; switching to consensus",
            height=self.pool.height, synced=self.pool.blocks_synced,
            device_busy_s=round(self.device_busy_s, 3))
        await self.pool.stop()
        self.active = False
        if self.consensus_reactor is not None:
            await self.consensus_reactor.switch_to_consensus(self.state)
