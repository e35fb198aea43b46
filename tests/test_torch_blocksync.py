"""The port's block sync (blocksync/messages, pool and reactor) on the
CPU, through stage_verify_commit and prefetch_staged(klass="sync") with the
kernels' plain versions:

- the pool spreads requests over its peers and a redo hands a height to
  another peer (tests/test_blocksync.py's pool cases, on the port);
- a fresh port node syncs 40 blocks from a JAX package node over real TCP
  in windows of 8, then switches to consensus; its block hashes, State
  bytes and app hash equal what the JAX chain recorded at that height;
- a lying peer serves every block with one tampered LastCommit signature:
  the sync pinpoints the signature, stops the liar, redoes the heights
  from the honest peer and ends on the honest chain's State.

Each sync runs under its own time limit (asyncio.wait_for).
"""

from __future__ import annotations

import asyncio
import re

import pytest

from cometbft_tpu.abci.kvstore import KVStoreApplication as JKV
from cometbft_tpu.blocksync import BlocksyncReactor as JBlocksync
from cometbft_tpu.consensus.replay import Handshaker as JHandshaker
from cometbft_tpu.mempool.mempool import CListMempool as JMempool
from cometbft_tpu.mempool.mempool import MempoolConfig as JMempoolConfig
from cometbft_tpu.proxy import AppConns as JAppConns
from cometbft_tpu.proxy import local_client_creator as jlocal
from cometbft_tpu.state import BlockExecutor as JExec
from cometbft_tpu.state import StateStore as JStateStore
from cometbft_tpu.store import BlockStore as JBlockStore
from cometbft_tpu.store import MemDB as JMemDB
from cometbft_tpu.types.basic import BlockID as JBlockID
from cometbft_tpu.types.commit import Commit as JCommit
from cometbft_tpu.types.genesis import GenesisDoc as JGenesis
from cometbft_tpu_torch.blocksync import BlockPool
from cometbft_tpu_torch.types.genesis import GenesisDoc as TGenesis
from tests import torch_net_harness as H
from tests import torch_tcp_harness as T
from tests.test_blocksync import _make_p2p as jax_p2p
from tests.test_state_execution import make_genesis, sign_commit_for
from tests.torch_consumers import fresh_backends


@pytest.fixture(autouse=True)
def _fresh():
    yield from fresh_backends()


async def _wait(pred, timeout: float) -> None:
    async def poll():
        while not pred():
            await asyncio.sleep(0.02)

    await asyncio.wait_for(poll(), timeout)


# -------------------------------------------------------------------- pool


def _port_chain(n_blocks: int, n_vals: int = 4, seed: int = 0):
    privs = [H.gen_priv("ed25519", i, seed) for i in range(n_vals)]
    by_addr = {p.pub_key().address(): p for p in privs}
    gdoc = H.genesis(privs, "torch-sync-chain")
    return asyncio.run(T.build_chain(gdoc, n_blocks, lambda a, m: by_addr[a].sign(m)))


@pytest.fixture(scope="module")
def chain12():
    return _port_chain(12)


def test_pool_spreads_requests_and_serves_blocks(chain12):
    async def run():
        sent, errors = [], []

        async def serve(height, peer_id):
            await asyncio.sleep(0.02)  # latency: the requesters overlap
            pool.add_block(peer_id, chain12.block_store.load_block(height), None, 1)

        async def send_request(height, peer_id):
            sent.append((height, peer_id))
            asyncio.get_running_loop().create_task(serve(height, peer_id))

        pool = BlockPool(1, send_request, lambda r, p: errors.append((r, p)))
        await pool.start()
        pool.set_peer_range("p1", 1, 12)
        pool.set_peer_range("p2", 1, 12)
        while pool.height <= 12:
            first, _, second = pool.peek_two_blocks()
            if first is not None and (second is not None or pool.height == 12):
                pool.pop_request()
            else:
                await asyncio.sleep(0.005)
        await pool.stop()
        return pool, sent, errors

    pool, sent, errors = asyncio.run(asyncio.wait_for(run(), 30.0))
    assert pool.is_caught_up() and pool.blocks_synced == 12 and not errors
    assert {p for _, p in sent} == {"p1", "p2"}


def test_pool_redo_hands_the_height_to_another_peer(chain12):
    async def run():
        async def send_request(height, peer_id):
            pool.add_block(peer_id, chain12.block_store.load_block(height), None, 1)

        pool = BlockPool(1, send_request, lambda r, p: None)
        await pool.start()
        pool.set_peer_range("bad", 1, 12)
        await _wait(lambda: pool.block_at(1)[0] is not None, 5.0)
        assert pool.peer_of(1) == "bad"
        assert pool.redo_request(1) == "bad"
        pool.set_peer_range("good", 1, 12)
        await _wait(lambda: pool.block_at(1)[0] is not None, 5.0)
        peer = pool.peer_of(1)
        await pool.stop()
        return peer

    assert asyncio.run(asyncio.wait_for(run(), 30.0)) == "good"


def test_pool_remove_peer_redoes_the_blocks_it_delivered(chain12):
    """pool.go removePeer redoes every requester of the peer, those holding
    its blocks too (the JAX package's pool keeps them: the port is right
    here, the reference is not)."""
    async def run():
        async def send_request(height, peer_id):
            pool.add_block(peer_id, chain12.block_store.load_block(height), None, 1)

        pool = BlockPool(1, send_request, lambda r, p: None)
        await pool.start()
        pool.set_peer_range("gone", 1, 12)
        await _wait(lambda: all(pool.block_at(h)[0] is not None for h in range(1, 13)), 5.0)
        pool.remove_peer("gone")
        dropped = all(pool.block_at(h)[0] is None for h in range(1, 13))
        pool.set_peer_range("good", 1, 12)
        await _wait(lambda: all(pool.block_at(h)[0] is not None for h in range(1, 13)), 5.0)
        peers = {pool.peer_of(h) for h in range(1, 13)}
        await pool.stop()
        return dropped, peers

    dropped, peers = asyncio.run(asyncio.wait_for(run(), 30.0))
    assert dropped and peers == {"good"}


# ------------------------------------------------- sync from a JAX node


async def _jax_chain(n_blocks: int):
    """tests/test_blocksync.build_chain from the handshake's InitChain, with
    each height's State bytes."""
    gdoc, _state, privs = make_genesis(n=4)
    conns = JAppConns(jlocal(JKV()))
    await conns.start()
    # the chain starts from the handshake's InitChain, as a node's does
    store = JStateStore(JMemDB())
    state = await JHandshaker(store, JBlockStore(JMemDB()), gdoc).handshake(conns)
    bstore = JBlockStore(JMemDB())
    execu = JExec(store, conns.consensus, JMempool(JMempoolConfig(), conns.mempool))
    last = JCommit(height=0, round_=0, block_id=JBlockID(), signatures=[])
    states = {}
    for h in range(1, n_blocks + 1):
        block = state.make_block(h, [b"h%d=v" % h], last, [],
                                 state.validators.get_proposer().address)
        bid, commit, ps = sign_commit_for(block, state, privs)
        state = await execu.apply_block(state, bid, block)
        bstore.save_block(block, ps, commit)
        states[h] = state.to_bytes()
        last = commit
    await conns.stop()
    return gdoc, bstore, states


def test_port_node_blocksyncs_from_a_jax_node_to_the_same_state():
    n_blocks = 41

    async def run():
        jgdoc, jbstore, states = await _jax_chain(n_blocks)
        src = JBlocksync(JExec(JStateStore(JMemDB()), None, None), jbstore, active=False)
        src_key, src_tr, src_sw = jax_p2p("src", jgdoc.chain_id, {"BLOCKSYNC": src})
        node = await T.sync_node(TGenesis.from_json(jgdoc.to_json()), window=8)
        addr = await src_tr.listen("127.0.0.1:0")
        await node.transport.listen("127.0.0.1:0")
        await src_sw.start()
        await node.switch.start()
        try:
            await node.switch.dial_peers_async([f"{src_key.id()}@{addr}"], persistent=True)
            await _wait(lambda: node.block_store.height() >= n_blocks - 1
                        and not node.reactor.active, 150.0)
        finally:
            await node.switch.stop()
            await src_sw.stop()
            await node.conns.stop()
        return node, jbstore, states

    node, jbstore, states = asyncio.run(asyncio.wait_for(run(), 200.0))
    top = n_blocks - 1  # the tip waits for its successor's commit
    assert node.block_store.height() == top
    for h in range(1, top + 1):
        assert node.block_store.load_block(h).hash() == jbstore.load_block(h).hash()
    state = node.state_store.load()
    assert state.to_bytes() == states[top]
    assert state.app_hash == jbstore.load_block(n_blocks).header.app_hash
    assert node.app.height == top
    assert node.reactor.windows >= top // 8
    assert not node.cons_reactor.wait_sync and node.cs.rs.height == n_blocks
    assert node.cs.rs.last_commit is not None


# ------------------------------------------------------------- a lying peer


def test_lying_peer_is_pinpointed_punished_and_redone(chain12):
    n_blocks, bad_index = 12, 1

    async def run():
        gdoc = chain12.gdoc
        hkey, htr, hsw = T.serve_node("honest", gdoc, chain12.block_store)
        liar_store = T.LyingStore(chain12.block_store, bad_index)
        lkey, ltr, lsw = T.serve_node("liar", gdoc, liar_store)
        node = await T.sync_node(gdoc, window=4)
        haddr, laddr = await htr.listen("127.0.0.1:0"), await ltr.listen("127.0.0.1:0")
        await node.transport.listen("127.0.0.1:0")
        for sw in (hsw, lsw, node.switch):
            await sw.start()
        try:
            # the liar first, so that it is asked for blocks before the
            # honest peer is there to take them
            await node.switch.dial_peers_async([f"{lkey.id()}@{laddr}"])
            await _wait(lambda: liar_store.served > 0, 30.0)
            await node.switch.dial_peers_async([f"{hkey.id()}@{haddr}"], persistent=True)
            await _wait(lambda: node.block_store.height() >= n_blocks - 1
                        and not node.reactor.active, 150.0)
        finally:
            for sw in (node.switch, hsw, lsw):
                await sw.stop()
            await node.conns.stop()
        return node, liar_store, lkey.id()

    node, liar, liar_id = asyncio.run(asyncio.wait_for(run(), 200.0))
    log = node.log.getvalue()
    assert re.search(r"invalid block in sync .*#%d\b" % bad_index, log), log[-2000:]
    assert liar.served >= 1
    assert liar_id not in node.switch.peers  # stopped for its blocks
    assert liar_id in node.switch.scorer.snapshot()
    top = n_blocks - 1
    for h in range(1, top + 1):
        mine, honest = node.block_store.load_block(h), chain12.block_store.load_block(h)
        assert mine.hash() == honest.hash()
        assert mine.last_commit.hash() == honest.last_commit.hash()  # no tampered commit kept
    assert node.state_store.load().to_bytes() == chain12.states[top]
    assert node.cs.rs.height == n_blocks
