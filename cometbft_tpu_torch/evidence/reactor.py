"""Evidence reactor: gossips byzantine-behavior proofs.

Reference: evidence/reactor.go:32 — one channel (0x38), a per-peer
broadcast routine walking the pool's pending list, and Receive that adds
(and thereby verifies) evidence from peers. Invalid evidence from a peer
is a protocol violation — the switch bans the sender (reactor.go:99).

Wire: EvidenceList {1: repeated Evidence envelope} via
types.evidence_list_to_proto.

The port's copy of cometbft_tpu/evidence/reactor.py.
"""

from __future__ import annotations

import asyncio

from cometbft_tpu_torch.evidence.pool import EvidencePool
from cometbft_tpu_torch.libs import log as cmtlog
from cometbft_tpu_torch.p2p.base_reactor import Envelope, Reactor
from cometbft_tpu_torch.p2p.conn.connection import ChannelDescriptor
from cometbft_tpu_torch.types.evidence import (
    evidence_list_from_proto,
    evidence_list_to_proto,
)

EVIDENCE_CHANNEL = 0x38
_BROADCAST_BATCH_BYTES = 1 << 20


class EvidenceReactor(Reactor):
    def __init__(self, pool: EvidencePool, logger: cmtlog.Logger | None = None):
        super().__init__("Evidence", logger)
        self.pool = pool
        self._peer_tasks: dict[object, asyncio.Task] = {}

    def get_channels(self) -> list[ChannelDescriptor]:
        return [ChannelDescriptor(id=EVIDENCE_CHANNEL, priority=6,
                                  recv_message_capacity=1 << 22)]

    async def add_peer(self, peer) -> None:
        self._peer_tasks[peer] = asyncio.get_running_loop().create_task(
            self._broadcast_routine(peer)
        )

    async def remove_peer(self, peer, reason) -> None:
        t = self._peer_tasks.pop(peer, None)
        if t is not None:
            t.cancel()

    async def receive(self, e: Envelope) -> None:
        """reactor.go:84-120: add (verifies); raising here lets the switch
        stop the peer for invalid evidence."""
        for ev in evidence_list_from_proto(e.message):
            self.pool.add_evidence(ev)

    async def _broadcast_routine(self, peer) -> None:
        """reactor.go:67 broadcastEvidenceRoutine: resend the pending list
        until it drains; new evidence is picked up on the next lap."""
        sent: set[bytes] = set()
        try:
            while peer.is_running:
                evs, _ = self.pool.pending_evidence(_BROADCAST_BATCH_BYTES)
                fresh = [ev for ev in evs if ev.hash() not in sent]
                if fresh and await peer.send(
                    EVIDENCE_CHANNEL, evidence_list_to_proto(fresh)
                ):
                    # only delivered evidence is marked; failed sends retry
                    sent.update(ev.hash() for ev in fresh)
                await asyncio.sleep(0.1)
        except asyncio.CancelledError:
            raise
        except Exception as err:  # noqa: BLE001
            self.logger.error("evidence broadcast routine failed",
                              peer=peer.id[:10], err=str(err))
