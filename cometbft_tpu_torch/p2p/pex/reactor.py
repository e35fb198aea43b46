"""PEX reactor (reference: p2p/pex/pex_reactor.go).

Channel 0x00: PexRequest / PexAddrs. Outbound peers get asked for
addresses on connect; inbound requests are rate-limited per peer and
answered with a random book selection. An ensure-peers routine dials from
the address book (biased toward NEW addresses while the node is young)
until max_outbound is reached. Seed mode answers requests and disconnects
(crawler behavior) — pex_reactor.go:54-70.

Discovery-plane hardening (the eclipse defenses the book's hashed-bucket
geometry anchors):

- Gossip intake stamps every learned address with the gossip source's
  SOCKET host (unforgeable) so the book's per-source-group bucket caps
  bind to real network position, not to free-to-mint identities.
- Dial outcomes are AWAITED (Switch.dial_peer), not dropped: a failed
  dial lands on mark_attempt, which feeds bias-aware eviction and the
  per-address failure backoff — a dead address is not re-picked every
  ensure interval, and a flood of unroutable sybil claims burns itself
  out of the book.
- ensure_peers enforces a per-/16-group OUTBOUND cap so one netblock
  cannot own the whole outbound slot budget; persistent peers are
  exempt (operator intent outranks the heuristic).
- The thin-book peer pick rides an injectable RNG so tests are
  deterministic.

The port's copy of cometbft_tpu/p2p/pex/reactor.py.
"""

from __future__ import annotations

import asyncio
import random
import time

from cometbft_tpu_torch.libs import log as cmtlog
from cometbft_tpu_torch.p2p.base_reactor import Envelope, Reactor
from cometbft_tpu_torch.p2p.conn.connection import ChannelDescriptor
from cometbft_tpu_torch.p2p.pex.addrbook import AddrBook, NetAddress, group16
from cometbft_tpu_torch.utils import protobuf as pb

PEX_CHANNEL = 0x00
ENSURE_PEERS_INTERVAL = 30.0  # pex_reactor.go:33
MIN_REQUEST_INTERVAL = 10.0   # per-peer request rate limit
NEED_ADDRESS_THRESHOLD = 1000  # addrbook.go needAddressThreshold


def encode_request() -> bytes:
    w = pb.Writer()
    w.message(1, b"", always=True)
    return w.output()


def encode_addrs(addrs: list[NetAddress]) -> bytes:
    inner = pb.Writer()
    for a in addrs:
        aw = pb.Writer()
        aw.string(1, a.node_id)
        aw.string(2, a.host)
        aw.uvarint(3, a.port)
        inner.message(1, aw.output(), always=True)
    w = pb.Writer()
    w.message(2, inner.output(), always=True)
    return w.output()


def decode(data: bytes):
    """-> ('request', None) | ('addrs', [NetAddress])."""
    r = pb.Reader(data)
    f, wt = r.read_tag()
    if f == 1:
        return "request", None
    if f == 2:
        out: list[NetAddress] = []
        ir = pb.Reader(r.read_bytes())
        while not ir.at_end():
            jf, jw = ir.read_tag()
            if jf != 1:
                ir.skip(jw)
                continue
            ar = pb.Reader(ir.read_bytes())
            node_id, host, port = "", "", 0
            while not ar.at_end():
                kf, kw = ar.read_tag()
                if kf == 1:
                    node_id = ar.read_string()
                elif kf == 2:
                    host = ar.read_string()
                elif kf == 3:
                    port = ar.read_uvarint()
                else:
                    ar.skip(kw)
            if node_id:
                out.append(NetAddress(node_id=node_id, host=host, port=port))
        return "addrs", out
    raise ValueError(f"unknown pex message field {f}")


class PEXReactor(Reactor):
    """pex_reactor.go:75-520."""

    def __init__(self, book: AddrBook, max_outbound: int = 10,
                 seed_mode: bool = False,
                 ensure_interval: float = ENSURE_PEERS_INTERVAL,
                 max_group_outbound: int = 0,
                 rng: random.Random | None = None,
                 logger: cmtlog.Logger | None = None):
        super().__init__("PEXReactor", logger)
        self.book = book
        self.max_outbound = max_outbound
        self.seed_mode = seed_mode
        self.ensure_interval = ensure_interval
        # per-/16-group outbound cap; 0 = auto (half the outbound budget,
        # never below 2 so a two-group world still fills)
        self.max_group_outbound = (max_group_outbound
                                   or max(2, max_outbound // 2))
        self._rng = rng or random.Random()
        self._last_request: dict[str, float] = {}
        self._requested: set[str] = set()
        # outbound throttle: we must respect the SAME per-peer rate limit
        # we enforce inbound, or a thin address book makes ensure-peers
        # spam requests that the peer rightfully scores as a pex flood
        self._last_sent: dict[str, float] = {}
        # peer id -> /16 group of the host we actually dialed/see; feeds
        # the outbound diversity cap
        self._peer_groups: dict[str, str] = {}
        self._task: asyncio.Task | None = None

    def get_channels(self) -> list[ChannelDescriptor]:
        return [ChannelDescriptor(id=PEX_CHANNEL, priority=1,
                                  send_queue_capacity=10)]

    async def on_start(self) -> None:
        self._task = asyncio.create_task(self._ensure_peers_routine())

    async def on_stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None
        self.book.save()

    # ------------------------------------------------------------ lifecycle

    async def add_peer(self, peer) -> None:
        """pex_reactor.go:145-165: learn the peer's self-address; ask
        outbound peers for more."""
        addr = self._peer_net_address(peer)
        if addr is not None:
            self.book.add_address(addr)
            if peer.outbound:
                # only addresses WE dialed successfully graduate to OLD —
                # an inbound connect proves nothing about the claimed
                # listen address (a sybil would mint OLD entries for free)
                self.book.mark_good(peer.id)
        self._peer_groups[peer.id] = group16(
            getattr(peer, "remote_host", "") or
            (addr.host if addr is not None else ""))
        if peer.outbound and not self.seed_mode:
            await self._request_addrs(peer)

    async def remove_peer(self, peer, reason) -> None:
        self._last_request.pop(peer.id, None)
        self._last_sent.pop(peer.id, None)
        self._requested.discard(peer.id)
        self._peer_groups.pop(peer.id, None)

    def _peer_net_address(self, peer) -> NetAddress | None:
        listen = getattr(peer.node_info, "listen_addr", "")
        if not listen:
            return None
        try:
            na = NetAddress.parse(f"{peer.id}@{listen.removeprefix('tcp://')}")
            # the source of a self-reported address is the peer itself;
            # the socket host is the unforgeable group key
            na.src_id = peer.id
            na.src_host = getattr(peer, "remote_host", "") or na.host
            return na
        except (ValueError, TypeError):
            return None

    # -------------------------------------------------------------- wire

    async def _request_addrs(self, peer) -> None:
        now = time.time()
        if now - self._last_sent.get(peer.id, 0.0) < MIN_REQUEST_INTERVAL:
            return
        self._last_sent[peer.id] = now
        self._requested.add(peer.id)
        await peer.send(PEX_CHANNEL, encode_request())

    async def receive(self, e: Envelope) -> None:
        try:
            kind, payload = decode(e.message)
        except Exception as err:  # noqa: BLE001
            self.logger.error("bad pex message", err=str(err))
            return
        peer = e.src
        if kind == "request":
            # rate limit (pex_reactor.go:230 receiveRequest)
            now = time.time()
            last = self._last_request.get(peer.id, 0.0)
            if now - last < MIN_REQUEST_INTERVAL:
                self.logger.info("pex request too soon; disconnecting",
                                 peer=peer.id)
                if self.switch is not None:
                    await self.switch.stop_peer_for_error(peer, "pex flood",
                                                          score=1.0)
                return
            self._last_request[peer.id] = now
            await peer.send(PEX_CHANNEL, encode_addrs(self.book.selection()))
            if self.seed_mode and self.switch is not None:
                # seed: serve and hang up (pex_reactor.go:205) — our own
                # doing, so it must not score against the client
                await self.switch.stop_peer_for_error(peer, "seed served",
                                                      score=0.0)
        else:  # addrs
            if peer.id not in self._requested:
                # unsolicited PexAddrs is protocol abuse (pex_reactor.go:260)
                if self.switch is not None:
                    await self.switch.stop_peer_for_error(
                        peer, "unsolicited pex addrs", score=1.0)
                return
            self._requested.discard(peer.id)
            src_host = getattr(peer, "remote_host", "")
            for a in payload or []:
                a.src_id = peer.id
                # bucket attribution binds to the sender's SOCKET host: a
                # sybil swarm behind one /16 shares one source group no
                # matter how many identities it mints
                a.src_host = src_host
                self.book.add_address(a)

    # ------------------------------------------------------------- dialing

    async def _ensure_peers_routine(self) -> None:
        """pex_reactor.go:300 ensurePeersRoutine."""
        while True:
            try:
                await self._ensure_peers()
            except asyncio.CancelledError:
                raise
            except Exception as e:  # noqa: BLE001
                self.logger.error("ensure peers failed", err=str(e))
            await asyncio.sleep(self.ensure_interval)

    def _outbound_group_counts(self) -> dict[str, int]:
        counts: dict[str, int] = {}
        for p in self.switch.peers.values():
            if not p.outbound:
                continue
            g = self._peer_groups.get(
                p.id, group16(getattr(p, "remote_host", "")))
            counts[g] = counts.get(g, 0) + 1
        return counts

    async def _ensure_peers(self) -> None:
        if self.switch is None:
            return
        out_count = sum(1 for p in self.switch.peers.values() if p.outbound)
        needed = self.max_outbound - out_count
        if needed <= 0:
            return
        # young nodes bias toward NEW addresses (pex_reactor.go:330)
        bias = max(30, 100 - 10 * len(self.switch.peers))
        groups = self._outbound_group_counts()
        picks: list[NetAddress] = []
        tried: set[str] = set()
        while len(picks) < needed:
            addr = self.book.pick_address(new_bias_pct=bias)
            if addr is None or addr.node_id in tried:
                break
            tried.add(addr.node_id)
            if (addr.node_id in self.switch.peers
                    or addr.node_id == self.book.our_id):
                continue
            # outbound diversity: one /16 group may not own more than
            # max_group_outbound slots — persistent/protected peers are
            # operator intent and bypass the heuristic
            g = addr.group
            if (groups.get(g, 0) >= self.max_group_outbound
                    and not self.book.is_protected(addr.node_id)):
                continue
            groups[g] = groups.get(g, 0) + 1
            self.book.mark_attempt(addr.node_id)
            picks.append(addr)
        if picks:
            # dial concurrently, AWAITING outcomes: a failure has already
            # been counted by mark_attempt (backoff + eviction bias);
            # a success resets it via add_peer -> mark_good
            results = await asyncio.gather(
                *(self.switch.dial_peer(a.addr) for a in picks),
                return_exceptions=True)
            for a, ok in zip(picks, results):
                if ok is not True:
                    self.logger.info("pex dial failed", addr=a.addr,
                                     attempts=a.attempts)
        # book still wants addresses (addrbook.go needAddressThreshold):
        # ask a RANDOM existing peer — inbound included, which is exactly
        # the surface a sybil swarm floods; the per-peer rate limit and
        # the book's hashed-bucket geometry are the defense, not silence
        if self.book.size() < NEED_ADDRESS_THRESHOLD and self.switch.peers:
            peer = self._rng.choice(list(self.switch.peers.values()))
            await self._request_addrs(peer)
