"""The port's block execution and stores against the JAX package's, over a
chain that the JAX package's 4-validator net commits on the CPU
(tests/net_harness.make_net, kv txs in the mempools): the genesis document
(its JSON read by the other package, the same hash), then block by block
through each package's own executor (state/execution.py BlockExecutor:
validate_block with the LastCommit through verify_commit, the port's on the
kernels' plain versions, and apply_block) over its own kvstore, state store
and block store. Exact: the same State bytes at every height (app hash,
results hash, validator hashes, last block ID), the same state-store and
block-store entries, the same refusal of a LastCommit with one tampered
signature, and the same DuplicateVoteEvidence from the evidence pools.
"""

from __future__ import annotations

import asyncio
import hashlib

import pytest

from cometbft_tpu.abci.kvstore import KVStoreApplication as JKV
from cometbft_tpu.consensus.state import BLOCK_PART_SIZE
from cometbft_tpu.evidence import EvidencePool as JPool
from cometbft_tpu.mempool.mempool import CListMempool as JMempool
from cometbft_tpu.mempool.mempool import MempoolConfig as JMempoolConfig
from cometbft_tpu.proxy import AppConns as JAppConns
from cometbft_tpu.proxy import local_client_creator as jlocal
from cometbft_tpu.state import BlockExecutor as JExec
from cometbft_tpu.state import State as JState
from cometbft_tpu.state import StateStore as JStateStore
from cometbft_tpu.store import BlockStore as JBlockStore
from cometbft_tpu.store import MemDB as JMemDB
from cometbft_tpu.types.basic import BlockID as JBlockID
from cometbft_tpu.types.basic import SignedMsgType as JT
from cometbft_tpu.types.genesis import GenesisDoc as JGenesis
from cometbft_tpu.types.vote import Vote as JVote
from cometbft_tpu.utils import cmttime as jtime
from cometbft_tpu_torch.abci.kvstore import KVStoreApplication as TKV
from cometbft_tpu_torch.evidence import EvidencePool as TPool
from cometbft_tpu_torch.mempool.mempool import CListMempool as TMempool
from cometbft_tpu_torch.mempool.mempool import MempoolConfig as TMempoolConfig
from cometbft_tpu_torch.proxy import AppConns as TAppConns
from cometbft_tpu_torch.proxy import local_client_creator as tlocal
from cometbft_tpu_torch.state import BlockExecutor as TExec
from cometbft_tpu_torch.state import State as TState
from cometbft_tpu_torch.state import StateStore as TStateStore
from cometbft_tpu_torch.store import BlockStore as TBlockStore
from cometbft_tpu_torch.store import MemDB as TMemDB
from cometbft_tpu_torch.types import evidence as tevidence
from cometbft_tpu_torch.types.basic import BlockID as TBlockID
from cometbft_tpu_torch.types.block import Block as TBlock
from cometbft_tpu_torch.types.commit import Commit as TCommit
from cometbft_tpu_torch.types.genesis import GenesisDoc as TGenesis
from cometbft_tpu_torch.types.vote import Vote as TVote
from tests.torch_consumers import first_line, fresh_backends

CHAIN = "exec-chain"
HEIGHTS = 4

J = dict(KV=JKV, Pool=JPool, Mempool=JMempool, MempoolConfig=JMempoolConfig,
         AppConns=JAppConns, local=jlocal, Exec=JExec, State=JState,
         StateStore=JStateStore, BlockStore=JBlockStore, MemDB=JMemDB)
P = dict(KV=TKV, Pool=TPool, Mempool=TMempool, MempoolConfig=TMempoolConfig,
         AppConns=TAppConns, local=tlocal, Exec=TExec, State=TState,
         StateStore=TStateStore, BlockStore=TBlockStore, MemDB=TMemDB)


@pytest.fixture(autouse=True)
def _fresh():
    yield from fresh_backends()


@pytest.fixture(scope="module")
def jax_chain():
    """A chain of >= HEIGHTS blocks with kv txs, committed by the JAX
    package's 4-validator net on the CPU: (its genesis JSON, node 0, the
    validators' keys)."""
    import net_harness

    from cometbft_tpu.crypto import batch as jbatch

    jbatch.set_backend("cpu")
    docs = []

    class Captured(JGenesis):
        def validate_and_complete(self) -> None:
            super().validate_and_complete()
            docs.append(self)

    async def run():
        net = await net_harness.make_net(4, chain_id=CHAIN)
        await net.start()
        try:
            for i in range(12):
                await net.nodes[i % 4].mempool.check_tx(b"key%d=value%d" % (i, i))
            await net.wait_for_height(HEIGHTS + 1, timeout=60.0)

            async def txs_committed():
                while any(n.mempool.size() for n in net.nodes):
                    await asyncio.sleep(0.02)

            await asyncio.wait_for(txs_committed(), 60.0)
            await net.wait_for_height(net.max_height() + 1, timeout=60.0)
        finally:
            await net.stop()
        return net

    net_harness.GenesisDoc = Captured
    try:
        net = asyncio.run(run())
    finally:
        net_harness.GenesisDoc = JGenesis
    return docs[0].to_json(), net.nodes[0], net.privs


class Stack:
    """One package's executor over a fresh kvstore, mempool, evidence pool,
    state store and block store, started from a genesis document."""

    def __init__(self, m: dict, gdoc):
        self.m = m
        self.gdoc = gdoc

    async def __aenter__(self):
        m = self.m
        self.state = m["State"].from_genesis(self.gdoc)
        self.app = m["KV"]()
        self.conns = m["AppConns"](m["local"](self.app))
        await self.conns.start()
        self.state_db, self.block_db = m["MemDB"](), m["MemDB"]()
        self.state_store = m["StateStore"](self.state_db)
        self.state_store.bootstrap(self.state)
        self.block_store = m["BlockStore"](self.block_db)
        self.pool = m["Pool"](m["MemDB"](), self.state_store, block_store=self.block_store)
        mempool = m["Mempool"](m["MempoolConfig"](), self.conns.mempool)
        self.exec = m["Exec"](self.state_store, self.conns.consensus, mempool,
                              evidence_pool=self.pool)
        return self

    async def __aexit__(self, *exc):
        await self.conns.stop()

    async def apply(self, block, block_id, seen_commit) -> None:
        self.exec.validate_block(self.state, block)
        self.state = await self.exec.apply_block(self.state, block_id, block, validated=True)
        self.block_store.save_block(block, block.make_part_set(BLOCK_PART_SIZE), seen_commit)


def _chain(jnode, upto: int):
    """(JAX block, its BlockID, its seen commit) for heights 1..upto."""
    bs = jnode.block_store
    return [(bs.load_block(h), bs.load_block_meta(h).block_id, bs.load_seen_commit(h))
            for h in range(1, upto + 1)]


def _port(block, block_id, commit):
    return (TBlock.from_proto(block.to_proto()), TBlockID.from_proto(block_id.to_proto()),
            TCommit.from_proto(commit.to_proto()))


def _db(db) -> dict:
    return dict(db.iterate())


def test_genesis_json_crosses_with_the_same_hash(jax_chain):
    raw, jnode, privs = jax_chain
    jg = JGenesis.from_json(raw)
    tg = TGenesis.from_json(raw)
    assert tg.hash() == jg.hash() and tg.to_json() == jg.to_json() == raw
    back = JGenesis.from_json(tg.to_json())
    assert back.hash() == jg.hash()
    assert TState.from_genesis(tg).to_bytes() == JState.from_genesis(jg).to_bytes()
    assert jnode.block_store.load_block(1).header.chain_id == tg.chain_id == CHAIN


def test_jax_chain_replays_through_the_port_executor_to_the_same_state(jax_chain):
    raw, jnode, privs = jax_chain
    gj, gt = JGenesis.from_json(raw), TGenesis.from_json(raw)
    height = jnode.block_store.height()
    chain = _chain(jnode, height)

    async def run():
        async with Stack(J, gj) as js, Stack(P, gt) as ts:
            per_height = []
            for blk, bid, seen in chain:
                await js.apply(blk, bid, seen)
                await ts.apply(*_port(blk, bid, seen))
                per_height.append((js.state.to_bytes(), ts.state.to_bytes(),
                                   js.app.app_hash, ts.app.app_hash))
            return (per_height, _db(js.state_db), _db(ts.state_db), _db(js.block_db),
                    _db(ts.block_db), ts.state)

    per_height, jsdb, tsdb, jbdb, tbdb, tstate = asyncio.run(run())
    for jb, tb, ja, ta in per_height:
        assert jb == tb and ja == ta
    assert jsdb == tsdb and jbdb == tbdb
    # the port's state at the node's applied height is the JAX net node's
    # own (the net stops between saving a block and applying it at times),
    # and its block store holds the bytes the node's does
    node_state = jnode.cs.block_exec.state_store.load()
    assert per_height[node_state.last_block_height - 1][1] == node_state.to_bytes()
    assert tbdb == _db(jnode.block_store.db)
    assert sum(len(b.data.txs) for b, _, _ in chain) == 12
    assert tstate.last_block_id.hash == chain[-1][0].hash()


def test_tampered_last_commit_is_refused_by_both_with_the_same_error(jax_chain):
    raw, jnode, privs = jax_chain
    gj, gt = JGenesis.from_json(raw), TGenesis.from_json(raw)
    chain = _chain(jnode, 3)

    async def run():
        async with Stack(J, gj) as js, Stack(P, gt) as ts:
            for blk, bid, seen in chain[:2]:
                await js.apply(blk, bid, seen)
                await ts.apply(*_port(blk, bid, seen))
            blk = chain[2][0]
            sigs = blk.last_commit.signatures
            i = next(k for k, s in enumerate(sigs) if s.signature)
            bad = bytearray(sigs[i].signature)
            bad[40] ^= 1
            tblk = TBlock.from_proto(blk.to_proto())
            tblk.last_commit.signatures[i].signature = bytes(bad)
            tblk.header.last_commit_hash = tblk.last_commit.hash()
            jblk = type(blk).from_proto(tblk.to_proto())
            out = []
            for stack, b in ((js, jblk), (ts, tblk)):
                try:
                    stack.exec.validate_block(stack.state, b)
                    out.append("ok")
                except Exception as e:  # noqa: BLE001 - the outcome is compared
                    out.append(first_line(e))
            return out, i

    (jout, tout), i = asyncio.run(run())
    assert jout == tout and jout[0] == "ErrInvalidCommitSignature"
    assert f"#{i}" in jout[1]


def test_equivocation_becomes_the_same_evidence_in_both_pools(jax_chain):
    raw, jnode, privs = jax_chain
    gj, gt = JGenesis.from_json(raw), TGenesis.from_json(raw)
    chain = _chain(jnode, 3)
    vals = jnode.cs.block_exec.state_store.load_validators(2)
    priv = privs[1]
    idx, _ = vals.get_by_address(priv.pub_key().address())

    def signed(tag: bytes):
        bid = JBlockID(hashlib.sha256(tag).digest(), chain[1][1].part_set_header)
        v = JVote(type_=JT.PREVOTE, height=2, round_=0, block_id=bid,
                  timestamp=jtime.Timestamp(1_700_000_002, 5),
                  validator_address=priv.pub_key().address(), validator_index=idx)
        v.signature = priv.sign(v.sign_bytes(CHAIN))
        return v

    va, vb = signed(b"a"), signed(b"b")

    async def run():
        out = []
        async with Stack(J, gj) as js, Stack(P, gt) as ts:
            for stack, conv in ((js, lambda v: v), (ts, lambda v: TVote.from_proto(v.to_proto()))):
                for blk, bid, seen in chain[:2]:
                    if stack is ts:
                        blk, bid, seen = _port(blk, bid, seen)
                    await stack.apply(blk, bid, seen)
                stack.pool.report_conflicting_votes(conv(va), conv(vb))
                before = stack.pool.pending_evidence(-1)[0]
                blk, bid, seen = chain[2] if stack is js else _port(*chain[2])
                await stack.apply(blk, bid, seen)  # update() materialises it
                evs, size = stack.pool.pending_evidence(-1)
                stack.pool.check_evidence(evs)
                again = stack.pool.add_evidence(evs[0])
                stack.pool.update(stack.state, evs)
                out.append((len(before), [e.bytes_() for e in evs], size, again,
                            len(stack.pool.pending_evidence(-1)[0]), _db(stack.pool.db)))
        return out

    jout, tout = asyncio.run(run())
    assert jout == tout
    assert jout[0] == 0 and len(jout[1]) == 1 and jout[4] == 0 and jout[3] is False
    ev = tevidence.DuplicateVoteEvidence.from_proto(tout[1][0])
    assert ev.height() == 2 and ev.vote_a.validator_index == idx
