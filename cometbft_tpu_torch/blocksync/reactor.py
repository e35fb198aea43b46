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

The port's copy of cometbft_tpu/blocksync/reactor.py, with the
commit-certificate exchange on channel 0x25 while a cert plane is given:
a height whose certificate proves its commit is verified by one BLS
pairing-product check on the card (B1-B5) instead of its per-vote batch.
A failed card (ops/dispatch.DEVICE_FAULTS) judges no block and punishes no
peer: the sync stops, with the error in the log and in `device_fault`.
"""

from __future__ import annotations

import asyncio
import time

from cometbft_tpu_torch.blocksync import messages as bm
from cometbft_tpu_torch.blocksync.pool import BlockPool
from cometbft_tpu_torch.libs import log as cmtlog
from cometbft_tpu_torch.libs import trace
from cometbft_tpu_torch.libs.service import TaskRunner
from cometbft_tpu_torch.ops import dispatch
from cometbft_tpu_torch.p2p.base_reactor import Envelope, Reactor
from cometbft_tpu_torch.p2p.conn.connection import ChannelDescriptor
from cometbft_tpu_torch.types import validation
from cometbft_tpu_torch.types.basic import BlockID

BLOCKSYNC_CHANNEL = 0x40
# commit-certificate exchange (framework extension, no reference analog):
# cert frames ride their OWN channel so support is negotiated in the p2p
# handshake's channel list, exactly like the consensus VoteSummary channel
# (0x24) — a peer that never advertises 0x25 never sees a cert frame and
# syncs through the classic per-vote window path
CERT_CHANNEL = 0x25
BLOCK_PART_SIZE = 65536
STATUS_UPDATE_INTERVAL = 10.0
VERIFY_WINDOW = 8  # heights staged on device concurrently
TRY_SYNC_INTERVAL = 0.01
MAX_HELD_CERTS = 1024  # peer-served certs awaiting their window


class _CertStaged:
    """Stand-in for a StagedCommitVerification when a commit certificate
    already proved the height: nothing to prefetch, finish() is a no-op.
    The pool routine treats it like any staged entry."""

    def finish(self) -> None:
        return None


class BlocksyncReactor(Reactor):
    def __init__(
        self,
        block_exec,
        block_store,
        active: bool,
        consensus_reactor=None,
        window: int = VERIFY_WINDOW,
        cert_plane=None,
        cert_serve: bool = True,
        logger: cmtlog.Logger | None = None,
    ):
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
        # "<exception type>: <text>" once a failed card stopped the sync
        self.device_fault: str | None = None
        # commit-certificate plane (None = cert exchange off; the 0x25
        # channel is then never advertised and peers treat us as classic)
        self.cert_plane = cert_plane
        self.cert_serve = cert_serve and cert_plane is not None
        self._held_certs: dict = {}  # height -> CommitCertificate
        self.certs_requested = 0  # CertRequests sent to 0x25-capable peers
        self.certs_received = 0   # well-formed certs accepted into holding
        self.certs_served = 0     # CertResponses answered with a cert
        self.cert_heights = 0     # window heights proved by a certificate
        self.certs_rejected = 0   # corrupt/mismatched/failed certs (no ban)

    def set_state(self, state) -> None:
        self.state = state

    # ------------------------------------------------------------- channels

    def get_channels(self) -> list[ChannelDescriptor]:
        chans = [
            ChannelDescriptor(
                id=BLOCKSYNC_CHANNEL, priority=5, send_queue_capacity=1000,
                recv_message_capacity=1 << 22,
            )
        ]
        if self.cert_plane is not None:
            # advertising the channel IS the capability announcement
            # (the VoteSummary 0x24 idiom)
            chans.append(ChannelDescriptor(
                id=CERT_CHANNEL, priority=2, send_queue_capacity=64))
        return chans

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
            if e.channel_id == CERT_CHANNEL:
                # certificates are an accept-only optimization: a garbled
                # frame costs the peer nothing but the shortcut (never a
                # ban — contrast the block channel below, where garbage
                # stalls the sync itself)
                self.certs_rejected += 1
                self.logger.debug("bad cert frame", err=str(err), peer=e.src.id)
                return
            self.logger.error("bad blocksync message", err=str(err), peer=e.src.id)
            await self._punish(e.src.id, f"undecodable message: {err}")
            return
        if isinstance(msg, (bm.CertRequest, bm.CertResponse, bm.NoCertResponse)):
            await self._receive_cert_message(msg, e.src)
            return
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

    async def _receive_cert_message(self, msg, peer) -> None:
        """Commit-certificate exchange on 0x25. Serving reads straight off
        the cert plane; received certs are parked until their height's
        window stages (where they substitute ONE pairing for the per-vote
        batch). Every failure path here degrades to classic verification —
        a certificate can only ever remove work, never add risk."""
        from cometbft_tpu_torch.cert import CommitCertificate

        if isinstance(msg, bm.CertRequest):
            raw = self.cert_plane.serve(msg.height) if self.cert_serve else None
            if raw is None:
                await peer.send(CERT_CHANNEL, bm.encode(bm.NoCertResponse(msg.height)))
            else:
                self.certs_served += 1
                await peer.send(CERT_CHANNEL, bm.encode(bm.CertResponse(msg.height, raw)))
        elif isinstance(msg, bm.CertResponse):
            try:
                cert = CommitCertificate.decode(msg.cert)
                if cert.height != msg.height:
                    raise ValueError(
                        f"cert height {cert.height} != response height {msg.height}")
            except Exception as err:  # noqa: BLE001 - corrupt cert: count, no ban
                self.certs_rejected += 1
                self.logger.debug("undecodable cert", height=msg.height,
                                  err=str(err), peer=peer.id)
                return
            if len(self._held_certs) < MAX_HELD_CERTS:
                self._held_certs[cert.height] = cert
                self.certs_received += 1
        # NoCertResponse: peer simply has no cert — classic path runs

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
        # opportunistically ask a 0x25-capable peer for the height's commit
        # certificate alongside the block: if it lands before the window
        # stages, the height verifies with one pairing instead of a
        # per-vote batch; if not, nothing changes
        if (self.cert_plane is not None
                and height not in self._held_certs
                and CERT_CHANNEL in (peer.node_info.channels or b"")):
            self.certs_requested += 1
            await peer.send(CERT_CHANNEL, bm.encode(bm.CertRequest(height)))

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
        try:
            await self._pool_loop()
        except dispatch.DEVICE_FAULTS as exc:
            self.device_fault = f"{type(exc).__name__}: {exc}"
            self.logger.error("block sync halted: the card failed", err=self.device_fault)

    async def _pool_loop(self) -> None:
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
            def _timed_prefetch(batch=[e[-1] for e in entries
                                       if not isinstance(e[-1], _CertStaged)],
                                h0=entries[0][0]):
                if not batch:  # whole window proved by certificates
                    return 0.0
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
                except dispatch.DEVICE_FAULTS:
                    raise  # the card failed, not the block or its peer
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
        # certs that arrived after their height was already applied
        # would otherwise pin holding slots forever
        for k in [k for k in self._held_certs if k < start_height]:
            del self._held_certs[k]
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
            if self._cert_proves(chain_id, vals, h, first_id, second.last_commit):
                entries.append((h, first, first_ext, second, parts, first_id,
                                _CertStaged()))
                h += 1
                continue
            try:
                staged = validation.stage_verify_commit(
                    chain_id, vals, first_id, h, second.last_commit)
            except dispatch.DEVICE_FAULTS:
                raise  # the card failed, not the commit or its peer
            except Exception as err:  # noqa: BLE001 - structurally bad: redo now
                self.logger.error("commit rejected in staging", height=h, err=str(err))
                p1 = self.pool.redo_request(h)
                p2 = self.pool.redo_request(h + 1)
                for pid in {p1, p2} - {""}:
                    self._on_pool_peer_error(f"bad commit for {h}: {err}", pid)
                break
            entries.append((h, first, first_ext, second, parts, first_id, staged))
            h += 1

    def _cert_proves(self, chain_id: str, vals, h: int, first_id,
                     commit) -> bool:
        """True iff a held certificate fully proves height h's commit:
        it names this exact block, attests THIS commit's signature set
        (matching bitmap/timestamps AND an aggregate-sum equal to the
        cert's — so a mauled commit can't hide behind an honest cert),
        and its one pairing-product check passes against the current
        valset. Any failure is counted and falls through to the classic
        per-vote staging — bit-identical verdicts, never a peer ban."""
        cert = self._held_certs.pop(h, None)
        if cert is None or self.cert_plane is None:
            return False
        from cometbft_tpu_torch import cert as certmod

        try:
            if cert.block_id != first_id or not certmod.attests_commit(cert, commit):
                raise certmod.ErrCertInvalid("certificate does not attest synced commit")
            certmod.verify_certificate(cert, chain_id, vals)
        except certmod.ErrCertInvalid as err:
            self.certs_rejected += 1
            self.cert_plane.count_verify_failure()
            self.logger.debug("cert rejected; classic verification",
                              height=h, err=str(err))
            return False
        self.cert_heights += 1
        self.cert_plane.count_verified()
        return True

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
