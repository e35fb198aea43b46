"""The port's consensus engine (consensus/: HeightVoteSet, RoundState, the
messages, the ticker and ConsensusState) against the JAX package's:

- HeightVoteSet on the same vote sequences: serial and staged votes, the
  2/3 majority, pending_sets, the catch-up round quota, set_peer_maj23 and
  pol_info;
- a single-validator chain in each package with both packages' clocks
  patched to the same stepping clock: the same block hashes for 3 heights,
  bit for bit (the whole single-node path);
- a 4-validator port net with batch_vote_verification on the CPU (the
  kernels' plain versions through the port's scheduler) commits 2 heights;
  its blocks agree across its nodes and replay through the JAX package's
  BlockExecutor to the same app hashes and State;
- a batched flush with one tampered peer vote reports FLUSH_INVALID for
  the same vote in both packages, and one equivocation becomes the same
  evidence;
- on the default "gpu" backend with no card the port's flush raises: a
  consensus flush never runs on the CPU;
- with a WAL and consensus metrics, the single-validator chain writes the
  reference's WAL bytes and metrics exposition.
"""

from __future__ import annotations

import asyncio
import contextlib

import pytest
import torch

from cometbft_tpu.abci.kvstore import KVStoreApplication as JKV
from cometbft_tpu.consensus import ConsensusState as JCS
from cometbft_tpu.consensus import height_vote_set as jhvs
from cometbft_tpu.consensus import messages as jmsg
from cometbft_tpu.consensus import round_state as jrs
from cometbft_tpu.consensus import ticker as jticker
from cometbft_tpu.consensus import wal as jwal
from cometbft_tpu.consensus.config import ConsensusConfig as JConfig
from cometbft_tpu.crypto import ed25519 as jed
from cometbft_tpu.evidence import EvidencePool as JPool
from cometbft_tpu.libs import metrics as jmetrics
from cometbft_tpu.mempool.mempool import CListMempool as JMempool
from cometbft_tpu.mempool.mempool import MempoolConfig as JMempoolConfig
from cometbft_tpu.privval.file_pv import FilePV as JFilePV
from cometbft_tpu.proxy import AppConns as JAppConns
from cometbft_tpu.proxy import local_client_creator as jlocal
from cometbft_tpu.state import BlockExecutor as JExec
from cometbft_tpu.state import State as JState
from cometbft_tpu.state import StateStore as JStateStore
from cometbft_tpu.store import BlockStore as JBlockStore
from cometbft_tpu.store import MemDB as JMemDB
from cometbft_tpu.types import vote_set as jvs
from cometbft_tpu.types.basic import SignedMsgType as JT
from cometbft_tpu.types.block import Block as JBlock
from cometbft_tpu.types.genesis import GenesisDoc as JGenesis
from cometbft_tpu.types.vote import Vote as JVote
from cometbft_tpu.utils import cmttime as jtime
from cometbft_tpu_torch.consensus import height_vote_set as thvs
from cometbft_tpu_torch.consensus import messages as tmsg
from cometbft_tpu_torch.consensus import round_state as trs
from cometbft_tpu_torch.consensus import ticker as tticker
from cometbft_tpu_torch.consensus import wal as twal
from cometbft_tpu_torch.consensus.config import ConsensusConfig as TConfig
from cometbft_tpu_torch.crypto import batch as tbatch
from cometbft_tpu_torch.libs import metrics as tmetrics
from cometbft_tpu_torch.types import vote as tvote
from cometbft_tpu_torch.types import vote_set as tvs
from cometbft_tpu_torch.utils import cmttime as ttime
from tests import torch_net_harness as H
from tests.torch_consumers import block_id, first_line, fresh_backends, port_vals, priv, \
    valset, vote

CHAIN = "consumers-chain"


@pytest.fixture(autouse=True)
def _fresh():
    yield from fresh_backends()


def _config(cls, **kw):
    """Timeouts of seconds: a plain batch costs ~1 s on the CPU."""
    base = dict(timeout_propose=8.0, timeout_propose_delta=1.0, timeout_prevote=4.0,
                timeout_prevote_delta=1.0, timeout_precommit=4.0, timeout_precommit_delta=1.0,
                timeout_commit=0.05, skip_timeout_commit=True, batch_vote_verification=True)
    base.update(kw)
    return cls(**base)


# -------------------------------------------------------- HeightVoteSet


def _hvs_run(hvs_mod, vs_mod, vals, conv, bconv, votes_by_step):
    h = hvs_mod.HeightVoteSet(CHAIN, 9, vals, batch_flush_size=3)
    out = []
    for kind, v, peer in votes_by_step:
        try:
            if kind == "add":
                out.append(("add", h.add_vote(conv(v), peer)))
            elif kind == "stage":
                out.append(("stage", h.add_pending(conv(v), peer)))
            elif kind == "flush":
                for vs in h.pending_sets():
                    try:
                        res = vs.flush_pending()
                    except vs_mod.ErrVoteConflictingVotes as e:
                        res = e.results
                    out.append(("flush", vs.round_, int(vs.signed_msg_type),
                                [(x.validator_index, s) for x, s in res]))
            elif kind == "round":
                h.set_round(v)
                out.append(("round", h.round_))
            elif kind == "maj23":
                h.prevotes(v).set_peer_maj23(peer, bconv(block_id(b"blk")))
                out.append(("maj23", sorted(h.prevotes(v).peer_maj23s)))
        except Exception as e:  # noqa: BLE001 - the outcome is what is compared
            out.append(first_line(e))
    for r in sorted(h._sets):
        for vs in (h.prevotes(r), h.precommits(r)):
            bid, ok = vs.two_thirds_majority()
            out.append((r, int(vs.signed_msg_type), ok, bid.to_proto() if bid else None,
                        vs.has_two_thirds_any(), vs.has_one_third_any(), vs.sum,
                        str(vs.bit_array()), len(vs._pending)))
    r, bid = h.pol_info()
    out.append((r, bid.to_proto() if bid else None))
    return out


def test_height_vote_set_is_the_reference_s():
    jvals, privs = valset([priv("ed25519", b"hvs", i) for i in range(4)])
    tvals = port_vals(jvals)
    blk = block_id(b"blk")
    pv = lambda i, r, b=blk: vote(privs, i, 9, r, b, JT.PREVOTE)  # noqa: E731
    pc = lambda i, r, b=blk: vote(privs, i, 9, r, b, JT.PRECOMMIT)  # noqa: E731
    bad = pv(3, 0)
    bad.signature = bad.signature[:40] + bytes([bad.signature[40] ^ 1]) + bad.signature[41:]
    steps = [
        ("add", pv(0, 0), ""), ("stage", pv(1, 0), "p1"), ("stage", pv(2, 0), "p2"),
        ("stage", pv(1, 0), "p1"),  # the same staged vote: not staged again
        ("stage", bad, "p3"), ("flush", None, ""),
        ("stage", pv(2, 1, block_id(b"other")), "p2"),  # next round: wanted
        ("stage", pv(0, 5), "p9"), ("stage", pv(1, 6), "p9"),  # catch-up quota of 2
        ("stage", pv(2, 7), "p9"),  # over the quota
        ("round", 2, ""), ("maj23", 0, "p4"), ("maj23", 0, "p4"),
        ("stage", pc(0, 0), "p0"), ("stage", pc(1, 0), "p1"), ("stage", pc(2, 0), "p2"),
        ("flush", None, ""), ("add", pc(3, 0, block_id(b"x")), "p3"),
        ("stage", pv(2, 0, block_id(b"other")), "p2"), ("flush", None, ""),
    ]
    from cometbft_tpu_torch.types.basic import BlockID as TBlockID

    got = [_hvs_run(jhvs, jvs, jvals, lambda v: v, lambda b: b, steps),
           _hvs_run(thvs, tvs, tvals, lambda v: tvote.Vote.from_proto(v.to_proto()),
                    lambda b: TBlockID.from_proto(b.to_proto()), steps)]
    assert got[0] == got[1]
    flushes = [o for o in got[1] if o[0] == "flush"]
    assert (3, tvs.FLUSH_INVALID) in flushes[0][3]


def test_round_state_messages_and_ticker_are_the_reference_s():
    got = []
    for rs, msg, tk in ((jrs, jmsg, jticker), (trs, tmsg, tticker)):
        state = rs.RoundState(height=4, round_=2, step=rs.RoundStepType.PRECOMMIT_WAIT)
        steps = [(s.name, int(s)) for s in rs.RoundStepType]
        msgs = [repr(msg.NewRoundStepMessage(height=4, round_=2, step=3)),
                repr(msg.HasVoteMessage(height=4, round_=2, type_=1, index=7)),
                [f.name for f in msg.VoteSummaryMessage.__dataclass_fields__.values()]]

        async def tick():
            q = asyncio.Queue()
            t = tk.TimeoutTicker(q)
            t.schedule_timeout(tk.TimeoutInfo(5.0, 1, 0, rs.RoundStepType.PROPOSE))
            t.schedule_timeout(tk.TimeoutInfo(0.01, 1, 0, rs.RoundStepType.PREVOTE_WAIT))
            first = await asyncio.wait_for(q.get(), 2.0)
            t.schedule_timeout(tk.TimeoutInfo(5.0, 2, 0, rs.RoundStepType.NEW_HEIGHT))
            t.stop()
            await asyncio.sleep(0.02)
            return str(first), q.qsize()

        got.append((state.height_round_step(), steps, msgs, asyncio.run(tick())))
    assert got[0] == got[1]


# ------------------------------------------------ single-validator chain


@contextlib.contextmanager
def stepping_clocks(start_s: int = 1_700_000_100):
    """Both packages' cmttime.now and canonical_now_ms on one clock each,
    stepping 1 ms a reading from the same start."""
    saved = [(m, m.now, m.canonical_now_ms) for m in (jtime, ttime)]

    def install(m):
        n = [0]

        def now():
            n[0] += 1
            ns = start_s * 10**9 + n[0] * 10**6
            return m.Timestamp(ns // 10**9, ns % 10**9)

        m.now = now
        m.canonical_now_ms = now

    for m in (jtime, ttime):
        install(m)
    try:
        yield
    finally:
        for m, now, ms in saved:
            m.now, m.canonical_now_ms = now, ms


async def _jax_node(gdoc, jpriv, config):
    """The JAX package's node stack, as tests/net_harness.make_net builds
    one, from a given genesis and key."""
    state = JState.from_genesis(gdoc)
    app = JKV()
    conns = JAppConns(jlocal(app))
    await conns.start()
    state_store = JStateStore(JMemDB())
    state_store.bootstrap(state)
    block_store = JBlockStore(JMemDB())
    mempool = JMempool(JMempoolConfig(), conns.mempool)
    pool = JPool(JMemDB(), state_store, block_store=block_store)
    exec_ = JExec(state_store, conns.consensus, mempool, evidence_pool=pool)
    cs = JCS(config=config, state=state, block_exec=exec_, block_store=block_store,
             wal=None, priv_validator=JFilePV(jpriv))
    return cs, conns, mempool, block_store


def _jax_priv(i: int, seed: int = 0):
    return jed.gen_priv_key_from_secret(b"torch-net-%d-%d" % (seed, i))


async def _run_single(side: str, heights: int):
    tpriv = H.gen_priv("ed25519", 0, seed=3)
    gdoc = H.genesis([tpriv], "single-chain")
    if side == "port":
        node = await H.make_node("solo", gdoc, tpriv, _config(TConfig))
        cs, conns, mempool, bs = node.cs, node.conns, node.mempool, node.block_store
    else:
        cs, conns, mempool, bs = await _jax_node(JGenesis.from_json(gdoc.to_json()),
                                                 _jax_priv(0, seed=3), _config(JConfig))
    for i in range(3):
        await mempool.check_tx(b"solo%d=%d" % (i, i))
    # The State is taken as update_to_state receives the one of height
    # `heights`: the block store saves a height before apply_block's awaits
    # end, so a poll of bs.height() alone can stop the node in between, and
    # a poll of cs.state can let it move on to the next height.
    at_height: list[bytes] = []
    update_to_state = cs.update_to_state

    def capture(state):
        if state.last_block_height == heights and not at_height:
            at_height.append(state.to_bytes())
        update_to_state(state)

    cs.update_to_state = capture
    await cs.start()
    try:
        async def poll():
            while not at_height or bs.height() < heights:
                assert not cs.failed
                await asyncio.sleep(0.01)

        await asyncio.wait_for(poll(), 90.0)
    finally:
        await cs.stop()
        await conns.stop()
    return ([bs.load_block(h).hash() for h in range(1, heights + 1)],
            [bs.load_seen_commit(h).to_proto() for h in range(1, heights + 1)],
            at_height[0])


def test_single_validator_chain_is_bit_equal_to_the_reference_s():
    assert H.gen_priv("ed25519", 0, 3).pub_key().bytes_() == _jax_priv(0, 3).pub_key().bytes_()
    with stepping_clocks():
        jax = asyncio.run(_run_single("jax", 3))
    with stepping_clocks():
        port = asyncio.run(_run_single("port", 3))
    assert len(port[0]) == 3
    assert jax == port


# ------------------------------------------------- a 4-validator port net


def test_port_net_commits_on_the_cpu_and_replays_through_the_jax_executor():
    heights = 2

    async def run():
        net = await H.make_net(4, config=_config(TConfig), chain_id="torch-net", device="cpu")
        await net.start()
        try:
            for i in range(4):
                await net.nodes[i].mempool.check_tx(b"net%d=%d" % (i, i))
            await net.wait_for_height(heights, timeout=120.0)
        finally:
            await net.stop()
        return net

    net = asyncio.run(run())
    blocks = [[n.block_store.load_block(h) for n in net.nodes] for h in range(1, heights + 1)]
    for per_node in blocks:
        assert len({b.hash() for b in per_node}) == 1
    node = net.nodes[0]
    port_state = node.state_store.load()
    top = port_state.last_block_height
    assert top >= heights

    async def replay():
        from cometbft_tpu.types.basic import BlockID

        state = JState.from_genesis(JGenesis.from_json(net.gdoc.to_json()))
        app = JKV()
        conns = JAppConns(jlocal(app))
        await conns.start()
        store = JStateStore(JMemDB())
        store.bootstrap(state)
        exec_ = JExec(store, conns.consensus, JMempool(JMempoolConfig(), conns.mempool))
        app_hashes = []
        try:
            for h in range(1, top + 1):
                blk = JBlock.from_proto(node.block_store.load_block(h).to_proto())
                bid = BlockID.from_proto(node.block_store.load_block_meta(h).block_id.to_proto())
                state = await exec_.apply_block(state, bid, blk)
                app_hashes.append(state.app_hash)
        finally:
            await conns.stop()
        return app_hashes, state.to_bytes()

    from cometbft_tpu.crypto import batch as jbatch

    jbatch.set_backend("cpu")
    app_hashes, jax_state = asyncio.run(replay())
    assert jax_state == port_state.to_bytes()
    for h, app_hash in enumerate(app_hashes, start=1):
        nxt = node.block_store.load_block(h + 1)
        assert nxt is None or nxt.header.app_hash == app_hash
    assert sum(len(node.block_store.load_block(h).data.txs) for h in range(1, top + 1)) >= 1


# ------------------------------------------------ flushes: statuses, evidence


async def _cs_pair(tkeys):
    """Each package's ConsensusState for validator 0 of a 4-validator set
    (the same keys), at height 1, not started."""
    tgdoc = H.genesis(tkeys, "flush-chain")
    tnode = await H.make_node("val0", tgdoc, tkeys[0], _config(TConfig))
    jcs, jconns, _, _ = await _jax_node(JGenesis.from_json(tgdoc.to_json()), _jax_priv(0, 5),
                                        _config(JConfig))
    return (jcs, jconns), (tnode.cs, tnode.conns)


def _flush_votes(cs, equivocate: bool):
    """Three peer prevotes at height 1 signed by the JAX keys (peer 2's
    tampered), plus, with `equivocate`, peer 1's second vote for nil."""
    vals = cs.state.validators
    out = []
    for i in (1, 2, 3):
        p = _jax_priv(i, 5)
        idx, _ = vals.get_by_address(p.pub_key().address())
        bid = block_id(b"proposal")
        for b in ([bid] + ([block_id(b"second")] if equivocate and i == 1 else [])):
            v = JVote(type_=JT.PREVOTE, height=1, round_=0, block_id=b,
                      timestamp=jtime.Timestamp(1_700_000_001, i),
                      validator_address=p.pub_key().address(), validator_index=idx)
            v.signature = p.sign(v.sign_bytes("flush-chain"))
            if i == 2:
                v.signature = v.signature[:40] + bytes([v.signature[40] ^ 1]) + v.signature[41:]
            out.append((v, f"peer{i}"))
    return out


@pytest.mark.parametrize("equivocate", [False, True], ids=["tampered", "equivocation"])
def test_flush_statuses_and_evidence_are_the_reference_s(equivocate):
    tkeys = [H.gen_priv("ed25519", i, seed=5) for i in range(4)]

    async def run():
        (jcs, jconns), (tcs, tconns) = await _cs_pair(tkeys)
        out = []
        try:
            for cs, conv in ((jcs, lambda v: v),
                             (tcs, lambda v: tvote.Vote.from_proto(v.to_proto()))):
                seen = []
                cs.misbehavior_hook = lambda peer, reason: seen.append((peer, reason))
                flushed = []
                orig = cs._flush_vote_set

                async def spy(vs, _orig=orig, _flushed=flushed):
                    _flushed.append(len(vs._pending))
                    await _orig(vs)

                cs._flush_vote_set = spy
                for v, peer in _flush_votes(cs, equivocate):
                    await cs._try_add_vote(conv(v), peer)
                await cs._flush_all_pending_votes()
                pre = cs.rs.votes.prevotes(0)
                buf = cs.block_exec.evidence_pool._consensus_buffer
                out.append((seen, flushed, pre.sum, str(pre.bit_array()),
                            [(a.to_proto(), b.to_proto()) for a, b in buf]))
        finally:
            await jconns.stop()
            await tconns.stop()
        return out

    jax, port = asyncio.run(run())
    assert jax == port
    assert ("peer2", "invalid-vote-signature") in port[0]
    assert len(port[4]) == (1 if equivocate else 0)


def test_port_flush_raises_without_a_card_on_the_default_backend():
    """The default "gpu" backend and no card: the flush raises (no CPU run),
    and the running receive routine stops as a consensus failure."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the flush would run on it")
    tkeys = [H.gen_priv("ed25519", i, seed=5) for i in range(4)]

    async def run():
        node = await H.make_node("val0", H.genesis(tkeys, "flush-chain"), tkeys[0],
                                 _config(TConfig))
        cs = node.cs
        votes = [tvote.Vote.from_proto(v.to_proto()) for v, _ in _flush_votes(cs, False)]
        try:
            tbatch.set_backend("gpu")
            for v in votes[:2]:
                cs.rs.votes.add_pending(v, "peer")
            with pytest.raises(RuntimeError):
                await cs._flush_vote_set(cs.rs.votes.prevotes(0))
            await cs.start()
            for v in votes[2:]:
                await cs.add_vote_from_peer(v, "peer3")
            await cs.add_vote_from_peer(votes[0], "peer1")

            async def died():
                while not cs.failed:
                    await asyncio.sleep(0.01)

            await asyncio.wait_for(died(), 10.0)
            return cs.failed
        finally:
            if cs.is_running:
                await cs.stop()
            await node.conns.stop()
            tbatch.set_backend("cpu")

    assert asyncio.run(run()) is True


async def run_chain_with_wal(side: str, heights: int, wal_path: str):
    """A single-validator chain of `heights` blocks with 3 txs, its
    ConsensusState given a WAL at `wal_path` and a ConsensusMetrics
    registry. Returns the block hashes and the registry's exposition."""
    tpriv = H.gen_priv("ed25519", 0, seed=3)
    gdoc = H.genesis([tpriv], "wal-chain")
    if side == "port":
        node = await H.make_node("solo", gdoc, tpriv, _config(TConfig))
        base, conns, mempool, bs = node.cs, node.conns, node.mempool, node.block_store
        m, CS, W = tmetrics, type(node.cs), twal.WAL
    else:
        base, conns, mempool, bs = await _jax_node(JGenesis.from_json(gdoc.to_json()),
                                                   _jax_priv(0, seed=3), _config(JConfig))
        m, CS, W = jmetrics, JCS, jwal.WAL
    reg = m.Registry()
    cs = CS(config=base.config, state=base.state, block_exec=base.block_exec,
            block_store=base.block_store, wal=W(wal_path), priv_validator=base.priv_validator,
            metrics=m.ConsensusMetrics(reg))
    for i in range(3):
        await mempool.check_tx(b"wal%d=%d" % (i, i))
    await cs.start()
    try:
        async def poll():
            while bs.height() < heights or cs.rs.height <= heights:
                assert not cs.failed
                await asyncio.sleep(0.01)

        await asyncio.wait_for(poll(), 90.0)
    finally:
        await cs.stop()
        await conns.stop()
    return [bs.load_block(h).hash() for h in range(1, heights + 1)], reg.render()



def test_port_consensus_state_takes_no_wal_or_metrics_yet(tmp_path):
    """ConsensusState(wal=, metrics=), filled by the node's slice: a
    single-validator chain with a WAL and consensus metrics writes the
    reference's WAL bytes, blocks and exposition, both packages' clocks on
    one stepping clock."""
    out = {}
    for side in ("jax", "port"):
        with stepping_clocks():
            out[side] = asyncio.run(run_chain_with_wal(side, 2, str(tmp_path / side / "wal")))
    assert out["port"] == out["jax"]
    for side in ("jax", "port"):
        assert (open(tmp_path / side / "wal", "rb").read()
                == open(tmp_path / "jax" / "wal", "rb").read())


def test_a_block_part_that_does_not_fit_is_logged_not_a_consensus_failure():
    """A part whose proof does not fit the proposal's part set (a part of
    another round's proposal, or a bad peer's): the port logs it as
    CometBFT's handleMsg does and keeps its receive routine; the reference
    raises it out of _handle_msg, which its routine turns into a consensus
    failure."""
    from cometbft_tpu.types.part_set import ErrPartSetInvalidProof as JErr
    from cometbft_tpu.types.part_set import PartSet as JPartSet
    from cometbft_tpu_torch.types.part_set import PartSet as TPartSet

    async def run():
        tkeys = [H.gen_priv("ed25519", i, 5) for i in range(4)]
        (jcs, jconns), (tcs, tconns) = await _cs_pair(tkeys)
        try:
            out = {}
            for side, cs, PartSet, mod in (("jax", jcs, JPartSet, jmsg),
                                           ("port", tcs, TPartSet, tmsg)):
                ours = PartSet.from_data(b"the proposal's block" * 40, 64)
                theirs = PartSet.from_data(b"another round's block" * 40, 64)
                cs.rs.proposal_block_parts = PartSet.from_header(ours.header())
                for rnd in (cs.rs.round_ + 1, cs.rs.round_):
                    msg = mod.BlockPartMessage(height=cs.rs.height, round_=rnd,
                                               part=theirs.get_part(0), peer_id="peer1")
                    try:
                        await cs._handle_msg(msg)
                        out.setdefault(side, []).append("logged")
                    except JErr:
                        out.setdefault(side, []).append("raised")
                out[side].append(cs.rs.proposal_block_parts.count)
            return out
        finally:
            await jconns.stop()
            await tconns.stop()

    out = asyncio.run(run())
    assert out["port"] == ["logged", "logged", 0]
    assert out["jax"] == ["raised", "raised", 0]
