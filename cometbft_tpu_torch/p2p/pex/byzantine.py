"""Byzantine PEX harness: drive the REAL discovery stack adversarially.

The discovery-plane sibling of consensus/byzantine.py — one adversary,
many identities, one netblock, attacking a victim's address book over the
same encrypted wire honest PEX uses. Behaviors:

  sybil-flood    the eclipse precursor: the adversary mints N node
                 identities (NodeKeys are free), parks them all behind
                 ONE /16 (in-process that is loopback — exactly the
                 shape of a single hosting-provider swarm), connects
                 each to the victim, and answers every PexAddrs request
                 with bursts of FORGED addresses claiming another /16 it
                 controls. Success for the defense means the book's
                 hashed-bucket geometry confines every claim to the
                 source group's NEW_BUCKETS_PER_GROUP buckets, the
                 victim keeps >= 1 honest outbound peer (protected
                 persistent entries are never evicted), and consensus
                 keeps committing.

Each sybil identity is a full production endpoint (NodeKey, Transport,
Switch, encrypted mconn) whose ONLY reactor is the flood responder — the
victim cannot tell it from an honest peer until it answers a request.
`flood_book` is the socket-free variant of the same intake path for
geometry tests and bench --discovery, where booting 32 transports would
cost seconds for no extra coverage.

The port's copy of cometbft_tpu/p2p/pex/byzantine.py.
"""

from __future__ import annotations

import hashlib

from cometbft_tpu_torch.libs import log as cmtlog
from cometbft_tpu_torch.p2p.base_reactor import Envelope, Reactor
from cometbft_tpu_torch.p2p.conn.connection import ChannelDescriptor
from cometbft_tpu_torch.p2p.key import NodeKey
from cometbft_tpu_torch.p2p.node_info import NodeInfo
from cometbft_tpu_torch.p2p.pex import reactor as pexmod
from cometbft_tpu_torch.p2p.pex.addrbook import AddrBook, NetAddress
from cometbft_tpu_torch.p2p.switch import Switch
from cometbft_tpu_torch.p2p.transport import Transport

PEX_BEHAVIORS = ("sybil-flood",)


def forged_claims(n: int, group: str = "10.66",
                  tag: str = "sybil") -> list[NetAddress]:
    """n deterministic forged addresses, all inside one claimed /16:
    node ids are hashes (indistinguishable from real ids), hosts walk
    the group's address space."""
    out = []
    for k in range(n):
        node_id = hashlib.sha256(f"{tag}:{k}".encode()).hexdigest()[:40]
        out.append(NetAddress(node_id=node_id,
                              host=f"{group}.{k // 200}.{k % 200 + 1}",
                              port=26656))
    return out


class _SybilPexReactor(Reactor):
    """The flood responder: answers every PexRequest with the next burst
    of forged claims (plus the swarm's own real listen addresses, so the
    victim keeps discovering more sybils — the swarm advertises itself).

    `mimic_channels` is the camouflage: a sybil that advertises ONLY the
    PEX channel dies the instant the victim's consensus reactor sends it
    a round-step message (unknown channel = wire error). A real attacker
    advertises whatever the victim speaks and silently drops it — so the
    harness registers the victim's channels as black holes."""

    def __init__(self, harness: "ByzantinePexHarness",
                 mimic_channels: bytes = b"",
                 logger: cmtlog.Logger | None = None):
        super().__init__("SybilPEX", logger)
        self.harness = harness
        self.mimic_channels = mimic_channels

    def get_channels(self) -> list[ChannelDescriptor]:
        chans = [ChannelDescriptor(id=pexmod.PEX_CHANNEL, priority=1,
                                   send_queue_capacity=10)]
        chans += [ChannelDescriptor(id=c, priority=1, send_queue_capacity=10)
                  for c in self.mimic_channels if c != pexmod.PEX_CHANNEL]
        return chans

    async def receive(self, e: Envelope) -> None:
        if e.channel_id != pexmod.PEX_CHANNEL:
            return  # camouflage traffic: swallowed, never answered
        try:
            kind, _ = pexmod.decode(e.message)
        except Exception:  # noqa: BLE001 - an adversary ignores bad input
            return
        if kind != "request":
            return  # the adversary has no use for the victim's addrs
        burst = self.harness.next_burst()
        self.harness.floods_sent += 1
        self.harness.addrs_claimed += len(burst)
        await e.src.send(pexmod.PEX_CHANNEL, pexmod.encode_addrs(burst))


class ByzantinePexHarness:
    """One adversary, `n_identities` NodeKeys, one /16 (the shared source
    host every sybil connects from), flooding forged PexAddrs at a
    victim. start() boots the swarm's endpoints, dial_victim() connects
    every identity (the victim's book learns each sybil's REAL listen
    address from the inbound self-report — that is the hook that later
    makes the victim dial into the swarm and ask it for addresses)."""

    def __init__(self, network: str, n_identities: int = 32,
                 claim_group: str = "10.66", claims_per_reply: int = 100,
                 total_claims: int = 4096, mimic_channels: bytes = b"",
                 logger: cmtlog.Logger | None = None):
        if n_identities < 1:
            raise ValueError("a sybil swarm needs at least one identity")
        self.network = network
        self.n_identities = n_identities
        self.claim_group = claim_group
        self.claims_per_reply = claims_per_reply
        self.mimic_channels = mimic_channels
        self.logger = logger or cmtlog.nop()
        self._claims = forged_claims(total_claims, group=claim_group)
        self._next = 0
        # the swarm: (node_key, transport, switch), one per identity
        self.identities: list[tuple[NodeKey, Transport, Switch]] = []
        self.listen_addrs: list[str] = []
        # counters (harness idiom: every adversarial act is counted)
        self.connects = 0
        self.floods_sent = 0
        self.addrs_claimed = 0

    # ------------------------------------------------------------- swarm

    async def start(self) -> None:
        from cometbft_tpu_torch.crypto import ed25519

        for i in range(self.n_identities):
            nk = NodeKey(ed25519.gen_priv_key())
            info = NodeInfo(node_id=nk.id(), network=self.network,
                            version="dev", moniker=f"sybil-{i}",
                            channels=bytes([pexmod.PEX_CHANNEL]))
            transport = Transport(nk, info, logger=cmtlog.nop())
            switch = Switch(transport, logger=cmtlog.nop())
            switch.add_reactor(
                "PEX", _SybilPexReactor(self, self.mimic_channels))
            addr = await transport.listen("127.0.0.1:0")
            info.listen_addr = addr
            await switch.start()
            self.identities.append((nk, transport, switch))
            self.listen_addrs.append(f"{nk.id()}@{addr}")

    async def dial_victim(self, victim_addr: str) -> int:
        """Connect every identity to the victim (inbound there); returns
        how many connects succeeded."""
        ok = 0
        for _, _, switch in self.identities:
            if await switch.dial_peer(victim_addr):
                ok += 1
        self.connects += ok
        return ok

    async def stop(self) -> None:
        for _, _, switch in self.identities:
            try:
                await switch.stop()
            except Exception:  # noqa: BLE001
                pass
        self.identities.clear()

    def next_burst(self) -> list[NetAddress]:
        """The next claims_per_reply forged claims (wrapping), salted
        with the swarm's own real listen addresses."""
        burst = []
        for _ in range(self.claims_per_reply):
            burst.append(self._claims[self._next % len(self._claims)])
            self._next += 1
        for s in self.listen_addrs[:10]:
            burst.append(NetAddress.parse(s))
        return burst

    def snapshot(self) -> dict:
        return {"identities": self.n_identities,
                "connects": self.connects,
                "floods_sent": self.floods_sent,
                "addrs_claimed": self.addrs_claimed}

    # -------------------------------------------------- socket-free path

    @staticmethod
    def flood_book(book: AddrBook, n_identities: int = 32,
                   claims_per_identity: int = 128,
                   src_group: str = "203.0",
                   claim_groups: int = 64) -> dict:
        """Drive the SAME book-intake path without sockets: n sybil
        identities, all sourced from one /16, each pushing a slab of
        forged claims — the geometry-bound measurement bench --discovery
        and the bucket-invariant tests ride. Claims are spread across
        `claim_groups` forged /16s: claims sharing (claimed group, source
        group) collapse into ONE bucket, so a single-/16 flood would only
        show 64 slots — diverse claims probe the flood's FULL allowance
        (NEW_BUCKETS_PER_GROUP buckets per source group). Returns the
        flood ledger."""
        total = n_identities * claims_per_identity
        per_group = max(1, total // max(1, claim_groups))
        claims: list[NetAddress] = []
        for j in range(max(1, claim_groups)):
            claims.extend(forged_claims(per_group, group=f"10.{j}",
                                        tag=f"sybil:{j}"))
        accepted = 0
        for i in range(n_identities):
            src_id = hashlib.sha256(f"src:{i}".encode()).hexdigest()[:40]
            src_host = f"{src_group}.{i // 200}.{i % 200 + 1}"
            for a in claims[i * claims_per_identity:
                            (i + 1) * claims_per_identity]:
                rec = NetAddress(node_id=a.node_id, host=a.host,
                                 port=a.port, src_id=src_id,
                                 src_host=src_host)
                if book.add_address(rec):
                    accepted += 1
        return {"identities": n_identities,
                "claimed": total,
                "accepted": accepted,
                "src_group": src_group}


def make_pex_byzantine(behavior: str, network: str,
                       **kwargs) -> ByzantinePexHarness:
    """Factory mirroring consensus.byzantine.make_byzantine: behavior
    name -> armed harness."""
    if behavior not in PEX_BEHAVIORS:
        raise ValueError(f"unknown pex behavior {behavior!r} "
                         f"(behaviors: {PEX_BEHAVIORS})")
    return ByzantinePexHarness(network, **kwargs)
