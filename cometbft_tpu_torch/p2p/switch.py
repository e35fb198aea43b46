"""Switch: owns peers and reactors, routes messages between them.

Reference: p2p/switch.go:72 — reactors register channel descriptors; the
switch accepts/dials connections, wraps them in Peers, and dispatches every
received message to the reactor owning that channel. Persistent peers are
redialed with exponential backoff (switch.go:398 reconnectToPeer);
StopPeerForError tears a peer down and triggers the redial.

Misbehavior scoring (framework extension; the reference only disconnects):
every stop-for-error and every reactor-reported offense (invalid vote
signatures, pex floods, bad evidence) adds to a per-peer score with
exponential time decay. Crossing the threshold bans the peer for a window
that doubles on repeat offenses — while banned, inbound conns are refused
and the persistent-peer redial loop waits instead of redialing a byzantine
peer forever.

The port's copy of cometbft_tpu/p2p/switch.py. The node sets `metrics`
(libs/metrics.P2PMetrics); its MConnections report to it.
"""

from __future__ import annotations

import asyncio
import random
import time
from typing import Optional

from cometbft_tpu_torch.libs import log as cmtlog
from cometbft_tpu_torch.libs.service import BaseService, TaskRunner
from cometbft_tpu_torch.p2p import netchaos
from cometbft_tpu_torch.p2p.base_reactor import Envelope, Reactor
from cometbft_tpu_torch.p2p.conn.connection import ChannelDescriptor, MConnConfig
from cometbft_tpu_torch.p2p.peer import Peer
from cometbft_tpu_torch.p2p.transport import Transport, UpgradedConn, parse_addr

RECONNECT_ATTEMPTS = 20
RECONNECT_BASE_DELAY = 0.5
RECONNECT_MAX_DELAY = 30.0


class ErrDuplicatePeer(Exception):
    pass


class ErrBannedPeer(Exception):
    pass


class _PeerRecord:
    __slots__ = ("score", "updated", "banned_until", "ban_count", "last_ban")

    def __init__(self):
        self.score = 0.0
        self.updated = None  # None until the first report (0.0 is a valid time)
        self.banned_until = 0.0
        self.ban_count = 0
        self.last_ban = 0.0


class PeerScorer:
    """Misbehavior score + ban ledger, one record per node id.

    Scores decay exponentially (half_life), so a peer must misbehave
    FASTER than the decay to get banned — a one-off glitch ages out. Ban
    windows double per repeat offense up to ban_max, and the repeat
    counter itself resets after a clean stretch (10x the base window), so
    a long-reformed peer earns back the short first-offense window."""

    def __init__(self, ban_threshold: float = 3.0, ban_base: float = 60.0,
                 ban_max: float = 3600.0, half_life: float = 120.0):
        self.ban_threshold = ban_threshold
        self.ban_base = ban_base
        self.ban_max = ban_max
        self.half_life = half_life
        self._records: dict[str, _PeerRecord] = {}

    def record(self, node_id: str, weight: float = 1.0,
               now: float | None = None) -> bool:
        """Score a misbehavior; returns True when this report trips a ban."""
        now = time.monotonic() if now is None else now
        rec = self._records.setdefault(node_id, _PeerRecord())
        if rec.updated is not None and self.half_life > 0:
            rec.score *= 0.5 ** ((now - rec.updated) / self.half_life)
        rec.updated = now
        rec.score += weight
        if rec.score < self.ban_threshold or now < rec.banned_until:
            return False
        if rec.banned_until and now - rec.banned_until > 10 * self.ban_base:
            # clean stretch measured from ban END, not start: a banned
            # peer can't offend while refused, so measuring from the start
            # would forgive any ban longer than the stretch itself
            rec.ban_count = 0
        window = min(self.ban_base * (2 ** rec.ban_count), self.ban_max)
        rec.banned_until = now + window
        rec.ban_count += 1
        rec.last_ban = now
        rec.score = 0.0
        return True

    def is_banned(self, node_id: str, now: float | None = None) -> bool:
        rec = self._records.get(node_id)
        if rec is None:
            return False
        return (time.monotonic() if now is None else now) < rec.banned_until

    def ban_remaining(self, node_id: str, now: float | None = None) -> float:
        rec = self._records.get(node_id)
        if rec is None:
            return 0.0
        return max(0.0, rec.banned_until - (time.monotonic() if now is None else now))

    def snapshot(self) -> dict:
        now = time.monotonic()
        return {
            nid: {"score": round(rec.score, 3),
                  "banned_for": max(0.0, rec.banned_until - now),
                  "bans": rec.ban_count}
            for nid, rec in self._records.items()
        }


class Switch(BaseService):
    def __init__(
        self,
        transport: Transport,
        mconn_config: MConnConfig | None = None,
        logger: cmtlog.Logger | None = None,
        scorer: PeerScorer | None = None,
    ):
        super().__init__("P2P Switch", logger)
        self.transport = transport
        self.mconn_config = mconn_config or MConnConfig()
        self.reactors: dict[str, Reactor] = {}
        self._chan_to_reactor: dict[int, Reactor] = {}
        self._channels: list[ChannelDescriptor] = []
        self.peers: dict[str, Peer] = {}
        self.metrics = None  # libs.metrics.P2PMetrics | None (node wires it)
        self.persistent_addrs: dict[str, str] = {}  # node_id -> addr
        self._reconnecting: set[str] = set()
        self._tasks = TaskRunner("switch")
        self.scorer = scorer or PeerScorer()
        self.transport.is_banned = self.scorer.is_banned
        self._closing = False
        # ban observer (the node points this at addr_book.mark_bad so PEX
        # stops offering/dialing a banned peer too): (node_id, seconds)
        self.on_ban: Optional[callable] = None

    # ------------------------------------------------------------ reactors

    def add_reactor(self, name: str, reactor: Reactor) -> None:
        """switch.go:206 AddReactor: channel ids must be globally unique."""
        for d in reactor.get_channels():
            if d.id in self._chan_to_reactor:
                raise ValueError(f"channel {d.id:#x} already registered")
            self._chan_to_reactor[d.id] = reactor
            self._channels.append(d)
        self.reactors[name] = reactor
        reactor.set_switch(self)
        # advertise channels in the handshake
        self.transport.node_info.channels = bytes(
            sorted(d.id for d in self._channels)
        )

    # ------------------------------------------------------------ lifecycle

    async def on_start(self) -> None:
        self._closing = False
        for reactor in self.reactors.values():
            await reactor.on_start()
        self._tasks.spawn(self._accept_routine(), name="switch-accept")

    async def on_stop(self) -> None:
        # peer-error callbacks racing the teardown must not spawn fresh
        # reconnect tasks after cancel_all has already run
        self._closing = True
        await self._tasks.cancel_all()
        for peer in list(self.peers.values()):
            await self._stop_peer(peer, "switch stopping")
        for reactor in self.reactors.values():
            await reactor.on_stop()
        self.transport.close()

    # -------------------------------------------------------------- accept

    async def _accept_routine(self) -> None:
        """switch.go:633 acceptRoutine."""
        while True:
            try:
                up = await self.transport.accept()
            except asyncio.CancelledError:
                raise
            except Exception as e:  # noqa: BLE001
                self.logger.error("accept error", err=str(e))
                await asyncio.sleep(0.1)
                continue
            try:
                await self._add_peer(up)
            except Exception as e:  # noqa: BLE001 - bad peer must not kill accepts
                self.logger.info("failed to add inbound peer", err=str(e))
                up.conn.close()

    # ---------------------------------------------------------------- dial

    async def dial_peers_async(self, addrs: list[str], persistent: bool = False) -> None:
        """switch.go:573 DialPeersAsync: fire-and-forget dial attempts."""
        for addr in addrs:
            node_id, _, _ = parse_addr(addr)
            if persistent and node_id:
                self.persistent_addrs[node_id] = addr
            self._tasks.spawn(self._dial_with_retries(addr, persistent),
                              name=f"dial-{addr}")

    async def dial_peer(self, addr: str) -> bool:
        """One AWAITED dial attempt with the outcome returned to the
        caller — the PEX ensure-peers seam: failures must land back on
        the address book's attempt/backoff bookkeeping instead of being
        dropped by a fire-and-forget task (dial_peers_async stays the
        fire-and-forget path for operator/topology dials)."""
        node_id, _, _ = parse_addr(addr)
        if node_id and (node_id in self.peers
                        or self.scorer.is_banned(node_id)):
            return False
        try:
            up = await self.transport.dial(addr)
            await self._add_peer(up)
            return True
        except asyncio.CancelledError:
            raise
        except ErrDuplicatePeer:
            # lost a simultaneous-dial tie-break: the peer IS connected
            return True
        except Exception as e:  # noqa: BLE001
            self.logger.info("dial failed", addr=addr, err=str(e))
            return False

    async def _dial_with_retries(self, addr: str, persistent: bool) -> None:
        node_id, _, _ = parse_addr(addr)
        attempts = RECONNECT_ATTEMPTS if persistent else 1
        delay = RECONNECT_BASE_DELAY
        i = 0
        while i < attempts:
            if node_id and node_id in self.peers:
                return
            if node_id and self.scorer.is_banned(node_id):
                # a banned peer is not redialed — wait out the (finite)
                # ban window WITHOUT consuming dial attempts, or a long
                # ban would permanently abandon a persistent peer
                if not persistent:
                    return
                await asyncio.sleep(
                    min(self.scorer.ban_remaining(node_id), RECONNECT_MAX_DELAY)
                    + RECONNECT_BASE_DELAY)
                continue
            try:
                up = await self.transport.dial(addr)
                await self._add_peer(up, persistent=persistent)
                return
            except asyncio.CancelledError:
                raise
            except Exception as e:  # noqa: BLE001
                self.logger.info("dial failed", addr=addr, attempt=i, err=str(e))
                i += 1
                # exponential backoff + jitter (switch.go:398)
                await asyncio.sleep(delay * (0.5 + random.random()))
                delay = min(delay * 2, RECONNECT_MAX_DELAY)

    # ---------------------------------------------------------------- peers

    async def _add_peer(self, up: UpgradedConn, persistent: bool = False) -> Peer:
        node_id = up.node_info.node_id
        if self.scorer.is_banned(node_id):
            up.conn.close()
            raise ErrBannedPeer(
                f"peer {node_id[:10]} is banned for another "
                f"{self.scorer.ban_remaining(node_id):.1f}s")
        existing = self.peers.get(node_id)
        if existing is not None:
            # Simultaneous-dial tie-break: both sides keep ONLY the
            # connection dialed by the lower node id, so they agree on
            # which TCP conn survives and the mutual-close livelock of
            # naive dedup cannot happen (switch.go addPeer dedup, with a
            # deterministic winner instead of first-wins).
            my_id = self.transport.node_key.id()
            new_is_canonical = (my_id < node_id) == up.outbound
            if not new_is_canonical:
                up.conn.close()
                raise ErrDuplicatePeer(node_id)
            await self._stop_peer(existing, "replaced by canonical duplicate conn")
        persistent = persistent or node_id in self.persistent_addrs
        peer = Peer(
            # every peer conn rides through the net-chaos seam; a clean
            # wire is one flag test per write (p2p/netchaos.py)
            conn=netchaos.wrap(up.conn, self.transport.node_key.id(), node_id),
            node_info=up.node_info,
            channels=self._channels,
            on_receive=self._on_peer_receive,
            on_error=self._on_peer_error,
            outbound=up.outbound,
            persistent=persistent,
            mconn_config=self.mconn_config,
            logger=self.logger.with_fields(peer=node_id[:10]),
            metrics=self.metrics,
            peer_label=(self.metrics.peer_label(node_id)
                        if self.metrics is not None else ""),
        )
        for reactor in self.reactors.values():
            reactor.init_peer(peer)
        await peer.start()
        self.peers[node_id] = peer
        if self.metrics is not None:
            self.metrics.peers.set(len(self.peers))
        for reactor in self.reactors.values():
            await reactor.add_peer(peer)
        self.logger.info("added peer", peer=node_id[:10],
                         outbound=up.outbound, n_peers=len(self.peers))
        return peer

    async def _on_peer_receive(self, chan_id: int, peer: Peer, msg: bytes) -> None:
        reactor = self._chan_to_reactor.get(chan_id)
        if reactor is None:
            await self.stop_peer_for_error(peer, f"unknown channel {chan_id:#x}")
            return
        try:
            await reactor.receive(Envelope(channel_id=chan_id, message=msg, src=peer))
        except Exception as e:  # noqa: BLE001 - a bad message bans the peer
            self.logger.error("reactor receive failed", chan=f"{chan_id:#x}", err=str(e))
            await self.stop_peer_for_error(peer, e)

    async def _on_peer_error(self, peer: Peer, err: Exception) -> None:
        await self.stop_peer_for_error(peer, err)

    def report_misbehavior(self, peer_id: str, reason: str,
                           weight: float = 1.0) -> bool:
        """Score a peer offense (invalid vote signature, bad evidence, pex
        flood, ...). Sync so reactors/consensus can call it inline; a ban
        tears the live conn down on a spawned task. Returns True when this
        report newly banned the peer."""
        if not peer_id:
            return False
        if self.metrics is not None:
            self.metrics.peer_misbehavior.labels(reason).inc()
        banned = self.scorer.record(peer_id, weight)
        if not banned:
            return False
        remaining = self.scorer.ban_remaining(peer_id)
        self.logger.info("banning misbehaving peer", peer=peer_id[:10],
                         reason=reason, seconds=round(remaining, 1))
        if self.metrics is not None:
            self.metrics.peer_bans.inc()
        if self.on_ban is not None:
            try:
                self.on_ban(peer_id, remaining)
            except Exception as e:  # noqa: BLE001 - observer must not break bans
                self.logger.error("on_ban hook failed", err=str(e))
        peer = self.peers.get(peer_id)
        if peer is not None:
            self._tasks.spawn(self.stop_peer_for_error(peer, f"banned: {reason}",
                                                       score=0.0),
                              name=f"ban-{peer_id[:10]}")
        return True

    async def stop_peer_for_error(self, peer: Peer, reason: object,
                                  score: float = 0.4) -> None:
        """switch.go:335: drop the peer; redial if persistent (and not
        banned). `score` feeds the misbehavior ledger — the 0.4 default
        means ~8 conn errors inside one decay half-life before a ban (a
        crashing neighbor is not an attacker); pass 0 for stops that are
        our own doing (seed-mode hangups, operator disconnects, ban
        enforcement) and 1.0 for protocol offenses."""
        if self.peers.get(peer.id) is not peer:
            # a late error from an already-replaced conn (duplicate
            # tie-break) must not tear down the canonical replacement
            return
        self.logger.info("stopping peer for error", peer=peer.id[:10], err=str(reason))
        if score > 0:
            self.report_misbehavior(peer.id, "conn-error", weight=score)
        await self._stop_peer(peer, reason)
        if peer.is_persistent() and not self._closing:
            # banned persistent peers still get a reconnect task — the
            # dial loop waits out the (decaying) ban window instead of
            # hammering dials at a peer we just banned
            addr = self.persistent_addrs.get(peer.id)
            if addr and peer.id not in self._reconnecting:
                self._reconnecting.add(peer.id)
                self._tasks.spawn(self._reconnect(peer.id, addr),
                                  name=f"reconnect-{peer.id[:10]}")

    async def _reconnect(self, node_id: str, addr: str) -> None:
        try:
            await asyncio.sleep(RECONNECT_BASE_DELAY)
            await self._dial_with_retries(addr, persistent=True)
        finally:
            self._reconnecting.discard(node_id)

    async def _stop_peer(self, peer: Peer, reason: object) -> None:
        if self.peers.get(peer.id) is peer:
            self.peers.pop(peer.id, None)
            if self.metrics is not None:
                self.metrics.peers.set(len(self.peers))
                # free the metrics label slot: under a churn storm the
                # label ledger must turn over instead of pinning dead
                # peers' slots forever (a returning peer re-claims its
                # old label — same series, no new cardinality)
                self.metrics.release_peer(peer.id)
        try:
            await peer.stop()
        except Exception:  # noqa: BLE001
            pass
        for reactor in self.reactors.values():
            try:
                await reactor.remove_peer(peer, reason)
            except Exception as e:  # noqa: BLE001
                self.logger.error("remove_peer failed", reactor=reactor.name, err=str(e))

    # ------------------------------------------------------------ broadcast

    def broadcast(self, chan_id: int, msg: bytes) -> None:
        """switch.go:274 Broadcast: try_send to every peer (drops on full
        queues — gossip routines provide reliability). Sync so event-switch
        callbacks can call it inline."""
        for peer in list(self.peers.values()):
            peer.try_send(chan_id, msg)

    def n_peers(self) -> int:
        return len(self.peers)

    def get_peer(self, node_id: str) -> Optional[Peer]:
        return self.peers.get(node_id)

    # ------------------------------------------------------------ telemetry

    def net_telemetry(self) -> dict:
        """The wire-plane accounting rollup the net_telemetry RPC route
        serves: every peer's full MConnection status (per-channel
        bytes/msgs/packets both ways, queue depth + high-water, stall
        split, ping RTT) plus cross-peer totals per channel and for the
        whole switch — 'where do my wire bytes go'."""
        peers = []
        totals = {"send_bytes": 0, "recv_bytes": 0,
                  "send_msgs": 0, "recv_msgs": 0,
                  "send_stall_seconds": 0.0}
        by_channel: dict[str, dict] = {}
        for p in list(self.peers.values()):
            st = p.status()
            peers.append({
                "id": p.id,
                "moniker": p.node_info.moniker,
                "is_outbound": p.outbound,
                "persistent": p.is_persistent(),
                "connection_status": st,
            })
            totals["send_bytes"] += st["send"]["bytes_total"]
            totals["recv_bytes"] += st["recv"]["bytes_total"]
            totals["send_stall_seconds"] += st["send_stall_seconds"]
            for ch_id, ch in st["channels"].items():
                agg = by_channel.setdefault(ch_id, {
                    "send_bytes": 0, "recv_bytes": 0,
                    "send_msgs": 0, "recv_msgs": 0,
                    "send_packets": 0, "recv_packets": 0,
                    "queue_hwm": 0})
                for k in ("send_bytes", "recv_bytes", "send_msgs",
                          "recv_msgs", "send_packets", "recv_packets"):
                    agg[k] += ch[k]
                agg["queue_hwm"] = max(agg["queue_hwm"], ch["queue_hwm"])
                totals["send_msgs"] += ch["send_msgs"]
                totals["recv_msgs"] += ch["recv_msgs"]
        totals["send_stall_seconds"] = round(totals["send_stall_seconds"], 6)
        return {
            "n_peers": len(peers),
            "peers": peers,
            "channels": by_channel,
            "totals": totals,
            "peer_scores": self.scorer.snapshot(),
        }
