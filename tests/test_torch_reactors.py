"""The port's consensus, mempool and evidence reactors over real TCP
(tests/torch_tcp_harness.py), on the CPU (the kernels' plain versions):

- a 4-validator port net over SecretConnection/MConnection commits heights
  with a signed tx gossiped by the mempool reactor and a forged one kept
  out; a killed validator's switch comes back and catches up through the
  reactor's catch-up gossip (tests/test_reactor_net.py's two cases);
- a mixed net of 2 JAX package nodes (tests/tcp_net_harness.py) and 2 port
  nodes on one genesis commits 2 heights with the same block hashes on all
  four: the wire, the gossip and the consensus agree across packages.

Each net runs under its own time limit (asyncio.wait_for).
"""

from __future__ import annotations

import asyncio

import pytest

from cometbft_tpu.consensus.config import ConsensusConfig as JConfig
from cometbft_tpu.crypto import ed25519 as jed
from cometbft_tpu.types.genesis import GenesisDoc as JGenesis
from cometbft_tpu_torch.consensus.config import ConsensusConfig as TConfig
from cometbft_tpu_torch.mempool.mempool import MempoolConfig
from tests import tcp_net_harness as JH
from tests import torch_net_harness as H
from tests import torch_tcp_harness as T
from tests.torch_consumers import fresh_backends


@pytest.fixture(autouse=True)
def _fresh():
    yield from fresh_backends()


def _config(cls, **kw):
    """Timeouts of seconds: a plain batch costs ~1 s on the CPU."""
    base = dict(timeout_propose=10.0, timeout_propose_delta=1.0, timeout_prevote=5.0,
                timeout_prevote_delta=1.0, timeout_precommit=5.0, timeout_precommit_delta=1.0,
                timeout_commit=0.05, skip_timeout_commit=True, batch_vote_verification=True)
    base.update(kw)
    return cls(**base)


def _same_chain(nodes, top: int) -> None:
    for h in range(1, top + 1):
        hashes = {n.block_store.load_block(h).hash() for n in nodes}
        assert len(hashes) == 1, f"fork at height {h}"


def test_port_tcp_net_commits_gossips_txs_and_a_killed_peer_catches_up():
    async def run():
        net = await T.make_tcp_net(4, config=_config(TConfig), device="cpu",
                                   app_factory=H.SignedKVStoreApplication,
                                   mempool_config=MempoolConfig(tx_verify="ed25519"), seed=1)
        priv = net.privs[0]
        good, forged = H.signed_tx(priv, b"wire=1"), H.signed_tx(priv, b"forged=1", forge=True)
        await net.start()
        try:
            await net.nodes[0].mempool.check_tx(good)
            with pytest.raises(Exception):
                await net.nodes[0].mempool.check_tx(forged)
            await net.wait_for_height(2, 120.0)
            victim, others = net.nodes[3], net.nodes[:3]
            await victim.switch.stop()
            h_kill = max(n.block_store.height() for n in net.nodes)
            await net.wait_for_height(h_kill + 1, 90.0, nodes=others)
            victim.switch.reset()
            victim.cs.reset()
            victim.transport._accept_queue = asyncio.Queue(64)
            victim.addr = await victim.transport.listen("127.0.0.1:0")
            await victim.switch.start()
            await victim.switch.dial_peers_async([n.p2p_addr for n in others], persistent=True)
            target = max(n.block_store.height() for n in others) + 1
            await net.wait_for_height(target, 120.0)
        finally:
            await net.stop()
        return net, good, forged

    net, good, forged = asyncio.run(asyncio.wait_for(run(), 300.0))
    top = min(n.block_store.height() for n in net.nodes)
    _same_chain(net.nodes, top)
    txs = [tx for h in range(1, top + 1) for tx in net.nodes[3].block_store.load_block(h).data.txs]
    assert good in txs and forged not in txs
    # every node holds the signed tx it only heard of through gossip
    assert all(n.node.app.height >= 1 for n in net.nodes)


def test_mixed_jax_and_port_tcp_net_commits_the_same_blocks():
    heights, seed = 2, 2

    async def run():
        privs = [H.gen_priv("ed25519", i, seed) for i in range(4)]
        gdoc = H.genesis(privs, "torch-tcp-chain")
        jgdoc = JGenesis.from_json(gdoc.to_json())
        pnodes = [await T.make_tcp_node(f"val{i}", gdoc, privs[i], _config(TConfig), seed=seed)
                  for i in (0, 1)]
        jnodes = [await JH.make_tcp_node(
            f"jax{i}", jed.gen_priv_key_from_secret(b"torch-net-%d-%d" % (seed, i)), jgdoc,
            _config(JConfig)) for i in (2, 3)]
        net = T.TcpNet(nodes=pnodes + jnodes, privs=privs, gdoc=gdoc)
        await net.start()
        try:
            await net.nodes[0].mempool.check_tx(b"mixed=1")
            await net.wait_for_height(heights, 150.0)
        finally:
            await net.stop()
        return net

    net = asyncio.run(asyncio.wait_for(run(), 240.0))
    _same_chain(net.nodes, heights)
    port_top = net.nodes[0].block_store.load_block(heights)
    jax_top = net.nodes[2].block_store.load_block(heights)
    assert port_top.hash() == jax_top.hash()
    assert port_top.to_proto() == jax_top.to_proto()
