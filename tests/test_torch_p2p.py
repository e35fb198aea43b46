"""The port's wire (libs/flowrate, libs/linkmodel, crypto/fallback and
_libcrypto's AEAD and X25519, p2p/) against the JAX package's:

- the AEAD and X25519 on every rung the port has (`cryptography`, libcrypto
  through ctypes, numpy/Python), against `cryptography` and the JAX
  package's fallback, on seeded keys, nonces and messages;
- the secret connection's HKDF keys and Merlin challenge, MConnection's
  packets, NodeInfo, and the consensus, blocksync, mempool and evidence
  messages: the same bytes, both ways;
- the link model, the skew estimator, the peer scorer and the net-chaos
  spec parser on the same inputs;
- a port Transport and a JAX Transport complete the secret handshake over
  loopback TCP both ways, on each of the port's rungs, and exchange
  channel messages through their Switches.
"""

from __future__ import annotations

import asyncio

import numpy as np
import pytest

from cometbft_tpu.blocksync import messages as jbm
from cometbft_tpu.consensus import messages as jM
from cometbft_tpu.consensus import reactor_codec as jcodec
from cometbft_tpu.crypto import ed25519 as jed
from cometbft_tpu.crypto import fallback as jfb
from cometbft_tpu.libs import linkmodel as jlink
from cometbft_tpu.libs.bits import BitArray as JBits
from cometbft_tpu.mempool import reactor as jmr
from cometbft_tpu.p2p import base_reactor as jbr
from cometbft_tpu.p2p import netchaos as jchaos
from cometbft_tpu.p2p import switch as jswitch
from cometbft_tpu.p2p.conn import connection as jconn
from cometbft_tpu.p2p.conn import secret_connection as jsc
from cometbft_tpu.p2p.key import NodeKey as JNodeKey
from cometbft_tpu.p2p.node_info import NodeInfo as JNodeInfo
from cometbft_tpu.p2p.transport import Transport as JTransport
from cometbft_tpu.types.basic import BlockID as JBlockID
from cometbft_tpu.types.basic import PartSetHeader as JPSH
from cometbft_tpu.types.basic import SignedMsgType as JT
from cometbft_tpu.types.part_set import PartSet as JPartSet
from cometbft_tpu.types.proposal import Proposal as JProposal
from cometbft_tpu.types.vote import Vote as JVote
from cometbft_tpu.utils.cmttime import Timestamp as JTs
from cometbft_tpu_torch.blocksync import messages as tbm
from cometbft_tpu_torch.consensus import reactor_codec as tcodec
from cometbft_tpu_torch.crypto import _libcrypto as tlib
from cometbft_tpu_torch.crypto import ed25519 as ted
from cometbft_tpu_torch.crypto import fallback as tfb
from cometbft_tpu_torch.libs import flowrate as tflow
from cometbft_tpu_torch.libs import linkmodel as tlink
from cometbft_tpu_torch.mempool import reactor as tmr
from cometbft_tpu_torch.p2p import base_reactor as tbr
from cometbft_tpu_torch.p2p import netchaos as tchaos
from cometbft_tpu_torch.p2p import switch as tswitch
from cometbft_tpu_torch.p2p.conn import connection as tconn
from cometbft_tpu_torch.p2p.conn import secret_connection as tsc
from cometbft_tpu_torch.p2p.key import NodeKey as TNodeKey
from cometbft_tpu_torch.p2p.node_info import NodeInfo as TNodeInfo
from cometbft_tpu_torch.p2p.transport import Transport as TTransport

RUNGS = tsc.available_rungs()
RNG_SEED = 17


def _rng(tag: int = 0):
    return np.random.default_rng(RNG_SEED + tag)


# --------------------------------------------------------------- the cipher


def test_the_port_has_every_rung_here():
    assert RUNGS == ["cryptography", "libcrypto", "python"]
    assert tsc.AEAD_RUNG == "cryptography"
    assert tlib.available()


@pytest.mark.parametrize("rung", RUNGS)
@pytest.mark.parametrize("size", [0, 1, 63, 1028, 4100])
def test_aead_rung_is_cryptography_s_and_the_reference_s(rung, size):
    from cryptography.hazmat.primitives.ciphers.aead import ChaCha20Poly1305

    rng = _rng(size)
    key, nonce, msg, aad = (rng.bytes(32), rng.bytes(12), rng.bytes(size),
                            rng.bytes(size % 7))
    want = ChaCha20Poly1305(key).encrypt(nonce, msg, aad)
    port = tsc.make_aead(key, rung)
    assert port.encrypt(nonce, msg, aad) == want
    assert jfb.ChaCha20Poly1305(key).encrypt(nonce, msg, aad) == want
    assert port.decrypt(nonce, want, aad) == msg
    bad = bytearray(want)
    bad[-1] ^= 1
    with pytest.raises(tsc._invalid_tags()):
        port.decrypt(nonce, bytes(bad), aad)


@pytest.mark.parametrize("rung", RUNGS)
def test_x25519_rung_is_cryptography_s_and_the_reference_s(rung):
    from cryptography.hazmat.primitives.asymmetric.x25519 import X25519PrivateKey

    rng = _rng(1)
    for _ in range(3):
        a, b = rng.bytes(32), rng.bytes(32)
        pub_b = X25519PrivateKey.from_private_bytes(b).public_key().public_bytes_raw()
        pub_a = tsc.x25519(a, tfb.X25519_BASEPOINT, rung)
        assert pub_a == X25519PrivateKey.from_private_bytes(a).public_key().public_bytes_raw()
        shared = tsc.x25519(a, pub_b, rung)
        assert shared == jfb.x25519(a, pub_b) == tsc.x25519(b, pub_a, "cryptography")


def test_python_rung_matches_the_reference_s_python_copy():
    """The numpy keystream, Poly1305 and the Montgomery ladder are the
    reference's, with libcrypto off on both sides."""
    rng = _rng(2)
    key, nonce = rng.bytes(32), rng.bytes(12)
    data = rng.bytes(2000)
    assert tfb.chacha20_xor(key, nonce, data) == jfb.chacha20_xor(key, nonce, data)
    assert tfb.poly1305_mac(key, data) == jfb.poly1305_mac(key, data)
    assert tfb._chacha20_block(key, 5, nonce) == jfb._chacha20_block(key, 5, nonce)
    k, u = rng.bytes(32), rng.bytes(32)
    assert tfb._x25519_ladder(int.from_bytes(k, "little"), int.from_bytes(u, "little")) == \
        jfb._x25519_ladder(int.from_bytes(k, "little"), int.from_bytes(u, "little"))
    with pytest.raises(ValueError):
        tfb.x25519(k, bytes(32), native=False)


def test_rung_can_be_chosen_and_restored():
    prev = tsc.set_aead_rung("python")
    try:
        assert tsc.AEAD_RUNG == "python"
        assert isinstance(tsc.make_aead(bytes(32)), tfb.ChaCha20Poly1305)
        with pytest.raises(ValueError):
            tsc.set_aead_rung("openssl")
    finally:
        tsc.set_aead_rung(prev)


@pytest.mark.parametrize("loc_is_least", [True, False])
def test_handshake_secrets_are_the_reference_s(loc_is_least):
    rng = _rng(3)
    dh, lo, hi = rng.bytes(32), rng.bytes(32), rng.bytes(32)
    assert tsc.derive_secrets(dh, loc_is_least) == jsc.derive_secrets(dh, loc_is_least)
    assert tsc.handshake_challenge(lo, hi, dh) == jsc.handshake_challenge(lo, hi, dh)


# ----------------------------------------------------------- MConnection


@pytest.mark.parametrize("chan,eof,size", [(0x20, True, 0), (0x21, False, 1024),
                                           (0x40, True, 77)])
def test_mconnection_packets_are_the_reference_s(chan, eof, size):
    data = _rng(size).bytes(size)
    assert tconn._encode_packet_msg(chan, eof, data) == jconn._encode_packet_msg(chan, eof, data)
    assert tconn._encode_packet_ping() == jconn._encode_packet_ping()
    for wall in (0, 1_700_000_000_123_456_789):
        assert tconn._encode_packet_pong(wall) == jconn._encode_packet_pong(wall)
    for pkt in (jconn._encode_packet_msg(chan, eof, data), jconn._encode_packet_ping(),
                jconn._encode_packet_pong(123_456)):
        _, pos = jconn.decode_uvarint(pkt)
        assert tconn._decode_packet(pkt[pos:]) == jconn._decode_packet(pkt[pos:])


def test_node_info_is_the_reference_s():
    kw = dict(node_id="ab" * 20, listen_addr="127.0.0.1:26656", network="wire-chain",
              version="dev", channels=bytes([0x20, 0x21, 0x22, 0x23, 0x30, 0x38, 0x40]),
              moniker="val0")
    j, t = JNodeInfo(**kw), TNodeInfo(**kw)
    assert t.encode() == j.encode()
    back = TNodeInfo.decode(j.encode())
    assert back.encode() == j.encode()
    back.validate()
    other = TNodeInfo(**{**kw, "network": "other-chain"})
    with pytest.raises(Exception):
        t.compatible_with(other)
    with pytest.raises(Exception):
        JNodeInfo(**{**kw, "network": "other-chain"}).compatible_with(j)


# --------------------------------------------------------- reactor messages


def _jax_messages() -> dict:
    """One of every consensus reactor message, built with the JAX
    package's types from a seed."""
    rng = _rng(4)
    bid = JBlockID(rng.bytes(32), JPSH(3, rng.bytes(32)))
    bits = JBits(13)
    for i in (0, 4, 12):
        bits.set_index(i, True)
    vote = JVote(type_=JT.PREVOTE, height=7, round_=1, block_id=bid,
                 timestamp=JTs(1_700_000_007, 123_000_000),
                 validator_address=rng.bytes(20), validator_index=4, signature=rng.bytes(64))
    prop = JProposal(height=7, round_=1, pol_round=0, block_id=bid,
                     timestamp=JTs(1_700_000_007, 5), signature=rng.bytes(64))
    part = JPartSet.from_data(rng.bytes(3000), 1024).get_part(1)
    return {
        "new_round_step": jM.NewRoundStepMessage(7, 1, 3, 12, 0),
        "new_valid_block": jM.NewValidBlockMessage(7, 1, bid.part_set_header, bits, True),
        "proposal": jM.ProposalMessage(proposal=prop),
        "proposal_pol": jM.ProposalPOLMessage(7, 0, bits),
        "block_part": jM.BlockPartMessage(7, 1, part),
        "vote": jM.VoteMessage(vote=vote),
        "has_vote": jM.HasVoteMessage(7, 1, JT.PRECOMMIT, 9),
        "vote_set_maj23": jM.VoteSetMaj23Message(7, 1, JT.PREVOTE, bid),
        "vote_set_bits": jM.VoteSetBitsMessage(7, 1, JT.PRECOMMIT, bid, bits),
        "vote_summary": jM.VoteSummaryMessage(
            height=7, round_=1, prevotes=bits, precommits=None,
            checksum=jcodec.vote_summary_checksum(7, 1, bits, None)),
    }


@pytest.mark.parametrize("kind", sorted(_jax_messages()))
def test_consensus_message_is_the_reference_s(kind):
    raw = jcodec.encode(_jax_messages()[kind])
    msg, want = tcodec.decode(raw), jcodec.decode(raw)
    assert type(msg).__name__ == type(want).__name__
    assert repr(msg) == repr(want)
    assert tcodec.encode(msg) == jcodec.encode(want)


def test_vote_summary_checksum_is_the_reference_s():
    from cometbft_tpu_torch.libs.bits import BitArray as TBits

    jb, tb = JBits(150), TBits(150)
    for i in range(0, 150, 7):
        jb.set_index(i, True)
        tb.set_index(i, True)
    assert tcodec.vote_summary_checksum(9, 2, tb, None) == \
        jcodec.vote_summary_checksum(9, 2, jb, None)


def _jax_block():
    from cometbft_tpu.types.block import Block, Data, EvidenceData, Header
    from cometbft_tpu.types.commit import Commit, CommitSig

    rng = _rng(5)
    bid = JBlockID(rng.bytes(32), JPSH(1, rng.bytes(32)))
    sigs = [CommitSig(2, rng.bytes(20), JTs(1_700_000_001, i), rng.bytes(64)) for i in range(3)]
    return Block(header=Header(chain_id="wire-chain", height=2, time=JTs(1_700_000_002, 0),
                               last_block_id=bid, proposer_address=rng.bytes(20)),
                 data=Data(txs=[b"a=1", b"b=2"]), evidence=EvidenceData([]),
                 last_commit=Commit(1, 0, bid, sigs))


BLOCKSYNC_KINDS = ["block_request", "no_block_response", "status_request", "status_response",
                   "block_response", "cert_request", "cert_response", "no_cert_response"]


def _jax_blocksync(kind: str):
    return {
        "block_request": lambda: jbm.BlockRequest(41),
        "no_block_response": lambda: jbm.NoBlockResponse(42),
        "status_request": lambda: jbm.StatusRequest(),
        "status_response": lambda: jbm.StatusResponse(height=1000, base=1),
        "block_response": lambda: jbm.BlockResponse(_jax_block(), None),
        "cert_request": lambda: jbm.CertRequest(43),
        "cert_response": lambda: jbm.CertResponse(44, b"\x01\x02cert"),
        "no_cert_response": lambda: jbm.NoCertResponse(45),
    }[kind]()


@pytest.mark.parametrize("kind", BLOCKSYNC_KINDS)
def test_blocksync_message_is_the_reference_s(kind):
    raw = jbm.encode(_jax_blocksync(kind))
    msg = tbm.decode(raw)
    assert tbm.encode(msg) == jbm.encode(jbm.decode(raw)) == raw
    if kind == "block_response":
        assert msg.block.hash() == jbm.decode(raw).block.hash()


def test_mempool_txs_are_the_reference_s():
    txs = [b"", b"k=v", _rng(6).bytes(300)]
    assert tmr.encode_txs(txs) == jmr.encode_txs(txs)
    assert tmr.decode_txs(jmr.encode_txs(txs)) == txs


# ------------------------------------------ link model, scorer, chaos spec


def test_link_model_and_skew_are_the_reference_s():
    rng = _rng(7)
    obs = [(int(n), float(s)) for n, s in zip(rng.integers(0, 200_000, 60),
                                              rng.uniform(1e-4, 0.2, 60))]
    jm, tm = jlink.LinkModel(alpha=0.2), tlink.LinkModel(alpha=0.2)
    js, ts = jlink.SkewEstimator(), tlink.SkewEstimator()
    for i, (n, s) in enumerate(obs):
        for m, sk in ((jm, js), (tm, ts)):
            m.observe_transfer(n, s)
            m.observe_rtt(s / 3)
            sk.observe_ping("p", 10**9 * i + n, 10**9 * i, s)
            sk.observe_vote("p", 10**9 * i + 2 * n, 10**9 * i, s)
    assert tm.snapshot() == jm.snapshot()
    assert tm.transfer_seconds(100_000) == jm.transfer_seconds(100_000)
    assert ts.snapshot() == js.snapshot()
    assert ts.error_bound_ms("p") == js.error_bound_ms("p")


def test_flow_monitor_counts_what_it_is_given():
    m = tflow.Monitor(rate_limit=0)
    assert m.update(1000) == 0.0 and m.update(24) == 0.0
    st = m.stats()
    assert st["bytes_total"] == 1024 and st["updates_total"] == 2
    assert tflow.Monitor(rate_limit=100).update(1000) > 0


def test_peer_scorer_bans_as_the_reference_does():
    seq = [("a", 1.0, 0.0), ("a", 1.0, 10.0), ("b", 0.4, 11.0), ("a", 1.5, 12.0),
           ("a", 3.0, 80.0), ("a", 3.0, 2000.0), ("b", 5.0, 3000.0)]
    got = []
    for mod in (jswitch, tswitch):
        sc = mod.PeerScorer(ban_threshold=3.0, ban_base=60.0, half_life=120.0)
        got.append([(sc.record(n, w, now=t), sc.is_banned(n, now=t + 1),
                     round(sc.ban_remaining(n, now=t + 1), 6)) for n, w, t in seq])
    assert got[0] == got[1]


@pytest.mark.parametrize("spec", [
    "latency=0.05,drop=0.01,dup=0.02,reorder=0.05,bandwidth=65536,seed=3",
    "partition=aa.bb|cc.dd",
    "profile.wan=latency:0.04;jitter:0.02;drop:0.005,region=aa:r0,region=bb:r1,link.r0-r1=wan",
])
def test_net_chaos_spec_is_the_reference_s(spec):
    j, t = jchaos.parse_spec(spec), tchaos.parse_spec(spec)

    def plain(obj):
        if hasattr(obj, "__slots__"):
            return {k: plain(getattr(obj, k)) for k in type(obj).__slots__}
        if isinstance(obj, dict):
            return {k: plain(v) for k, v in obj.items()}
        return obj

    assert plain(t) == plain(j)
    assert not tchaos.dial_blocked("aa", "bb")


# ----------------------------------------------- handshake over real sockets


def _echo(base, conn):
    """A reactor on channel 0x60 that records what it receives, in the
    package of `base` (p2p/base_reactor) and `conn` (p2p/conn/connection)."""

    class Echo(base.Reactor):
        def __init__(self):
            super().__init__("echo")
            self.got = []

        def get_channels(self):
            return [conn.ChannelDescriptor(id=0x60)]

        async def receive(self, e):
            self.got.append(e.message)

    return Echo()


def _port_side(seed: int):
    key = TNodeKey(ted.gen_priv_key_from_secret(b"wire-port-%d" % seed))
    tr = TTransport(key, TNodeInfo(node_id=key.id(), network="wire-chain", version="dev",
                                   moniker="port"))
    sw = tswitch.Switch(tr)
    echo = _echo(tbr, tconn)
    sw.add_reactor("ECHO", echo)
    return key, tr, sw, echo


def _jax_side(seed: int):
    key = JNodeKey(jed.gen_priv_key_from_secret(b"wire-jax-%d" % seed))
    tr = JTransport(key, JNodeInfo(node_id=key.id(), network="wire-chain", version="dev",
                                   moniker="jax"))
    sw = jswitch.Switch(tr)
    echo = _echo(jbr, jconn)
    sw.add_reactor("ECHO", echo)
    return key, tr, sw, echo


@pytest.mark.parametrize("port_dials", [True, False], ids=["port_dials", "jax_dials"])
@pytest.mark.parametrize("rung", RUNGS)
def test_port_and_jax_transports_handshake_and_exchange(rung, port_dials):
    async def run():
        prev = tsc.set_aead_rung(rung)
        p, j = _port_side(1), _jax_side(1)
        try:
            p_addr = await p[1].listen("127.0.0.1:0")
            j_addr = await j[1].listen("127.0.0.1:0")
            await p[2].start()
            await j[2].start()
            if port_dials:
                await p[2].dial_peers_async([f"{j[0].id()}@{j_addr}"])
            else:
                await j[2].dial_peers_async([f"{p[0].id()}@{p_addr}"])

            async def connected():
                while p[2].n_peers() < 1 or j[2].n_peers() < 1:
                    await asyncio.sleep(0.01)

            await asyncio.wait_for(connected(), 10.0)
            big = _rng(8).bytes(5000)  # several MConnection packets and frames
            assert await p[2].get_peer(j[0].id()).send(0x60, b"from-port")
            assert await p[2].get_peer(j[0].id()).send(0x60, big)
            assert await j[2].get_peer(p[0].id()).send(0x60, b"from-jax")

            async def delivered():
                while len(j[3].got) < 2 or len(p[3].got) < 1:
                    await asyncio.sleep(0.01)

            await asyncio.wait_for(delivered(), 10.0)
            assert j[3].got == [b"from-port", big]
            assert p[3].got == [b"from-jax"]
            st = p[2].get_peer(j[0].id()).status()
            assert st["channels"]["0x60"]["send_msgs"] == 2
            assert st["send"]["bytes_total"] >= len(big)
        finally:
            tsc.set_aead_rung(prev)
            await p[2].stop()
            await j[2].stop()

    asyncio.run(asyncio.wait_for(run(), 30.0))


def test_port_switch_rejects_the_wrong_node_id():
    async def run():
        p, j = _port_side(2), _jax_side(2)
        try:
            j_addr = await j[1].listen("127.0.0.1:0")
            await j[2].start()
            with pytest.raises(Exception, match="authenticated as"):
                await p[1].dial(f"{'00' * 20}@{j_addr}")
        finally:
            await j[2].stop()

    asyncio.run(asyncio.wait_for(run(), 30.0))


def test_port_takes_no_metrics_or_fuzzing_yet():
    """The fuzzing transport, since the slice of p2p/fuzz.py: a Transport
    takes a FuzzConnConfig and keeps it for its upgrades, as the
    reference's does. The metrics, filled by the node's slice: a port
    switch and a JAX switch, each with its P2PMetrics, exchange the same
    messages both ways and count the same bytes and messages a channel and
    a peer."""
    from cometbft_tpu.libs import metrics as jm
    from cometbft_tpu_torch.libs import metrics as tm
    from cometbft_tpu_torch.p2p.fuzz import FuzzConnConfig

    key = TNodeKey(ted.gen_priv_key_from_secret(b"wire-none"))
    info = TNodeInfo(node_id=key.id(), network="wire-chain")
    fuzz = FuzzConnConfig(mode="delay")
    assert TTransport(key, info, fuzz_config=fuzz).fuzz_config is fuzz
    assert TTransport(key, info).fuzz_config is None

    async def run():
        p, j = _port_side(3), _jax_side(3)
        p[2].metrics = tm.P2PMetrics(tm.Registry())
        j[2].metrics = jm.P2PMetrics(jm.Registry())
        try:
            j_addr = await j[1].listen("127.0.0.1:0")
            await p[1].listen("127.0.0.1:0")
            await p[2].start()
            await j[2].start()
            await p[2].dial_peers_async([f"{j[0].id()}@{j_addr}"])

            async def connected():
                while p[2].n_peers() < 1 or j[2].n_peers() < 1:
                    await asyncio.sleep(0.01)

            await asyncio.wait_for(connected(), 10.0)
            big = _rng(9).bytes(3000)
            for side, other in ((p, j), (j, p)):
                for msg in (b"m-one", big, b"m-three"):
                    assert await side[2].get_peer(other[0].id()).send(0x60, msg)

            async def delivered():
                while len(j[3].got) < 3 or len(p[3].got) < 3:
                    await asyncio.sleep(0.01)

            await asyncio.wait_for(delivered(), 10.0)
            await asyncio.sleep(0.3)  # the send routine's last flush of counters
            out = {}
            for name, side, other in (("port", p, j), ("jax", j, p)):
                m = side[2].metrics
                label = m.peer_label(other[0].id())
                out[name] = [
                    (m.peer_send_bytes.value(label, "0x60"), m.peer_receive_bytes.value(label, "0x60"),
                     m.peer_send_msgs.value(label, "0x60"), m.peer_receive_msgs.value(label, "0x60"),
                     m.message_send_bytes.value("0x60"), m.message_receive_bytes.value("0x60"),
                     m.peers.value())]
            return out
        finally:
            await p[2].stop()
            await j[2].stop()

    out = asyncio.run(asyncio.wait_for(run(), 30.0))
    assert out["port"][0][2] == 3 and out["port"][0][0] > 3000
    assert out["port"] == out["jax"]
