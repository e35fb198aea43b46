"""Mempool reactor: gossips valid transactions to peers.

Reference: mempool/reactor.go — one channel (0x30), one per-peer
broadcast routine (reactor.go:210 broadcastTxRoutine) walking the tx list
in arrival order and suppressing echo back to the tx's original sender.
Received txs go through CheckTx with the peer recorded as sender.

Wire: Txs message {1: repeated tx bytes} (proto/tendermint/mempool/types.proto).

The port's copy of cometbft_tpu/mempool/reactor.py. Under the node's
overload registry (libs/overload) gossip shrinks its batches and slows
down at the elevated and saturated watermarks.
"""

from __future__ import annotations

import asyncio

from cometbft_tpu_torch.libs import log as cmtlog
from cometbft_tpu_torch.mempool.mempool import CListMempool, ErrMempoolIsFull, ErrTxInCache
from cometbft_tpu_torch.p2p.base_reactor import Envelope, Reactor
from cometbft_tpu_torch.p2p.conn.connection import ChannelDescriptor
from cometbft_tpu_torch.utils.protobuf import Reader, Writer

MEMPOOL_CHANNEL = 0x30


def encode_txs(txs: list[bytes]) -> bytes:
    w = Writer()
    for tx in txs:
        w.bytes(1, tx, always=True)
    return w.output()


def decode_txs(data: bytes) -> list[bytes]:
    r = Reader(data)
    txs = []
    while not r.at_end():
        f, w = r.read_tag()
        if f == 1:
            txs.append(r.read_bytes())
        else:
            r.skip(w)
    return txs


class MempoolReactor(Reactor):
    def __init__(
        self,
        mempool: CListMempool,
        broadcast: bool = True,
        logger: cmtlog.Logger | None = None,
    ):
        super().__init__("Mempool", logger)
        self.mempool = mempool
        self.broadcast = broadcast
        self._peer_tasks: dict[object, asyncio.Task] = {}

    def get_channels(self) -> list[ChannelDescriptor]:
        return [ChannelDescriptor(id=MEMPOOL_CHANNEL, priority=5,
                                  recv_message_capacity=1 << 22)]

    async def add_peer(self, peer) -> None:
        if self.broadcast:
            self._peer_tasks[peer] = asyncio.get_running_loop().create_task(
                self._broadcast_tx_routine(peer)
            )

    async def remove_peer(self, peer, reason) -> None:
        t = self._peer_tasks.pop(peer, None)
        if t is not None:
            t.cancel()

    async def receive(self, e: Envelope) -> None:
        """reactor.go:93-130 Receive: CheckTx each, recording the sender."""
        for tx in decode_txs(e.message):
            try:
                await self.mempool.check_tx(tx, sender=e.src.id)
            except (ErrTxInCache, ErrMempoolIsFull):
                pass  # expected duplicates/backpressure, not peer misbehavior
            except Exception as err:  # noqa: BLE001
                self.logger.info("checktx from peer failed", err=str(err))

    def _gossip_budget(self) -> tuple[int, float]:
        """(batch cap, idle sleep) under the overload policy: at the
        elevated/saturated watermarks gossip is the first optional work
        to shrink — smaller batches, longer pauses — so admission and
        consensus keep their share of the loop."""
        reg = getattr(self.mempool, "overload", None)
        if reg is None:
            return 64, 0.05
        from cometbft_tpu_torch.libs import overload as _ovl

        lvl = reg.level("mempool")
        if lvl >= _ovl.SATURATED:
            return 8, 0.25
        if lvl >= _ovl.ELEVATED:
            return 16, 0.1
        return 64, 0.05

    async def _broadcast_tx_routine(self, peer) -> None:
        """reactor.go:210: walk txs in seq order; echo suppression by
        sender; batch a few per message. last_seq only advances once the
        batch is actually delivered (the reference blocks in Send until
        success) so a full/slow channel never drops txs for this peer.
        A peer whose channel refuses the batch is signaling ITS
        saturation — the retry backoff doubles per consecutive refusal
        (capped) instead of hammering a drowning peer at a fixed 50 ms."""
        last_seq = 0
        peer_backoff = 0.05
        try:
            while peer.is_running:
                batch = []
                batch_last_seq = last_seq
                batch_cap, idle = self._gossip_budget()
                for mtx in self.mempool.iter_txs():
                    if mtx.seq <= last_seq:
                        continue
                    batch_last_seq = mtx.seq
                    if mtx.sender == peer.id:
                        continue  # don't echo a tx to where it came from
                    batch.append(mtx.tx)
                    if len(batch) >= batch_cap:
                        break
                if batch:
                    if await peer.send(MEMPOOL_CHANNEL, encode_txs(batch)):
                        last_seq = batch_last_seq
                        peer_backoff = 0.05
                    else:
                        # retry the same batch, backing off toward a
                        # saturated peer
                        await asyncio.sleep(peer_backoff)
                        peer_backoff = min(peer_backoff * 2, 0.8)
                else:
                    last_seq = batch_last_seq  # only sender-suppressed txs
                    await asyncio.sleep(idle)
        except asyncio.CancelledError:
            raise
        except Exception as e:  # noqa: BLE001
            self.logger.error("mempool broadcast routine failed",
                              peer=peer.id[:10], err=str(e))
