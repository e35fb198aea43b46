"""Consensus nets and block sync of the port over real TCP: the JAX-free
counterpart of tests/tcp_net_harness.py and of tests/test_blocksync.py's
chain builder (torch, numpy and cometbft_tpu_torch only), which
chip_smoke.py imports for its wire phase.

make_tcp_net builds N validators, each the full stack of
torch_net_harness.make_node with a ConsensusReactor, a MempoolReactor and an
EvidenceReactor on a Switch, talking SecretConnection/MConnection over
loopback TCP, every node dialling every other persistently. Node keys come
from the seed, as the validators' keys do.

build_chain makes an n-block chain with full stores through the port's
BlockExecutor and State.make_block, every validator signing every commit
through `sign(address, sign_bytes)`; serve_node (with a certificate plane,
also serving commit certificates) and sync_node put a serving and a
syncing BlocksyncReactor behind a Switch. LyingStore serves a chain's
blocks with one tampered signature in every LastCommit.
"""

from __future__ import annotations

import asyncio
import io
from dataclasses import dataclass, field

from cometbft_tpu_torch.abci.kvstore import KVStoreApplication
from cometbft_tpu_torch.blocksync import BlocksyncReactor
from cometbft_tpu_torch.consensus import ConsensusState
from cometbft_tpu_torch.consensus.config import ConsensusConfig
from cometbft_tpu_torch.consensus.config import test_consensus_config as make_test_config
from cometbft_tpu_torch.consensus.reactor import ConsensusReactor
from cometbft_tpu_torch.consensus.replay import Handshaker
from cometbft_tpu_torch.consensus.state import BLOCK_PART_SIZE
from cometbft_tpu_torch.crypto import ed25519
from cometbft_tpu_torch.evidence.reactor import EvidenceReactor
from cometbft_tpu_torch.libs import log as cmtlog
from cometbft_tpu_torch.libs.events import EventSwitch
from cometbft_tpu_torch.mempool.mempool import CListMempool, MempoolConfig
from cometbft_tpu_torch.mempool.reactor import MempoolReactor
from cometbft_tpu_torch.p2p.conn.connection import MConnConfig
from cometbft_tpu_torch.p2p.key import NodeKey
from cometbft_tpu_torch.p2p.node_info import NodeInfo
from cometbft_tpu_torch.p2p.switch import Switch
from cometbft_tpu_torch.p2p.transport import Transport
from cometbft_tpu_torch.proxy import AppConns, local_client_creator
from cometbft_tpu_torch.state import BlockExecutor, State, StateStore
from cometbft_tpu_torch.store import BlockStore, MemDB
from cometbft_tpu_torch.types.basic import BlockID, BlockIDFlag
from cometbft_tpu_torch.types.block import Block
from cometbft_tpu_torch.types.commit import Commit, CommitSig
from cometbft_tpu_torch.types.genesis import GenesisDoc
from cometbft_tpu_torch.utils import cmttime

import torch_net_harness as H

# a fast ping and a generous rate for loopback nets, as the reference's tests
MCONN = dict(send_rate=50_000_000, recv_rate=50_000_000, ping_interval=5.0, pong_timeout=10.0)


def node_key(name: str, seed: int = 0) -> NodeKey:
    return NodeKey(ed25519.gen_priv_key_from_secret(b"torch-tcp-%d-%s" % (seed, name.encode())))


def make_switch(name: str, chain_id: str, reactors: dict, seed: int = 0,
                logger: cmtlog.Logger | None = None) -> tuple[NodeKey, Transport, Switch]:
    key = node_key(name, seed)
    info = NodeInfo(node_id=key.id(), network=chain_id, version="dev", moniker=name)
    transport = Transport(key, info)
    switch = Switch(transport, mconn_config=MConnConfig(**MCONN), logger=logger)
    for rname, r in reactors.items():
        switch.add_reactor(rname, r)
    return key, transport, switch


@dataclass
class TcpNode:
    name: str
    node: H.NetNode
    switch: Switch
    transport: Transport
    node_key: NodeKey
    cons_reactor: ConsensusReactor
    mem_reactor: MempoolReactor
    addr: str = ""

    @property
    def p2p_addr(self) -> str:
        return f"{self.node_key.id()}@{self.addr}"

    @property
    def cs(self) -> ConsensusState:
        return self.node.cs

    @property
    def block_store(self) -> BlockStore:
        return self.node.block_store

    @property
    def mempool(self) -> CListMempool:
        return self.node.mempool

    @property
    def conns(self) -> AppConns:
        return self.node.conns


async def make_tcp_node(name: str, gdoc: GenesisDoc, priv, config: ConsensusConfig,
                        app_factory=None, mempool_config: MempoolConfig | None = None,
                        seed: int = 0) -> TcpNode:
    node = await H.make_node(name, gdoc, priv, config, app_factory, mempool_config,
                             event_switch=EventSwitch())
    cons = ConsensusReactor(node.cs)
    mem = MempoolReactor(node.mempool)
    key, transport, switch = make_switch(
        name, gdoc.chain_id,
        {"CONSENSUS": cons, "MEMPOOL": mem, "EVIDENCE": EvidenceReactor(node.evidence_pool)},
        seed)
    node.cs.misbehavior_hook = switch.report_misbehavior
    return TcpNode(name=name, node=node, switch=switch, transport=transport, node_key=key,
                   cons_reactor=cons, mem_reactor=mem)


@dataclass
class TcpNet:
    nodes: list = field(default_factory=list)
    privs: list = field(default_factory=list)
    gdoc: GenesisDoc | None = None

    async def start(self) -> None:
        """Listen everywhere first, then start the switches and dial a full
        mesh, persistently. A node of another package (the JAX harness's
        TcpNode) takes part as long as it has transport, switch and
        p2p_addr."""
        for n in self.nodes:
            n.addr = await n.transport.listen("127.0.0.1:0")
        for n in self.nodes:
            if isinstance(n, TcpNode):
                n.node.running = True
            await n.switch.start()
        for n in self.nodes:
            await n.switch.dial_peers_async([m.p2p_addr for m in self.nodes if m is not n],
                                            persistent=True)

    async def stop(self) -> None:
        for n in self.nodes:
            if isinstance(n, TcpNode):
                n.node.running = False
            try:
                await n.switch.stop()
            except Exception:  # noqa: BLE001 - teardown of a half-started node
                pass
            await n.conns.stop()

    def failed(self) -> list[str]:
        return [n.name for n in self.nodes if n.cs.failed]

    async def wait_for_height(self, h: int, timeout: float, nodes: list | None = None) -> None:
        """Every node of `nodes` (all by default) at height >= h within
        `timeout` s; raises at once if a node's consensus routine died."""
        targets = self.nodes if nodes is None else nodes

        async def poll():
            while any(n.block_store.height() < h for n in targets):
                if self.failed():
                    raise RuntimeError(f"consensus failure on {self.failed()}")
                await asyncio.sleep(0.01)

        await asyncio.wait_for(poll(), timeout)


async def make_tcp_net(n_vals: int = 4, config: ConsensusConfig | None = None,
                       chain_id: str = "torch-tcp-chain", device=None, app_factory=None,
                       mempool_config: MempoolConfig | None = None, seed: int = 0) -> TcpNet:
    """n_vals ed25519 validators of power 10 (keys from `seed`); `device`
    points crypto.batch at the CPU or the card."""
    H.use_device(device)
    privs = [H.gen_priv("ed25519", i, seed) for i in range(n_vals)]
    gdoc = H.genesis(privs, chain_id)
    net = TcpNet(privs=privs, gdoc=gdoc)
    for i in range(n_vals):
        net.nodes.append(await make_tcp_node(f"val{i}", gdoc, privs[i],
                                             config or make_test_config(), app_factory,
                                             mempool_config, seed))
    return net


# ------------------------------------------------------------------ block sync


def block_time(height: int) -> cmttime.Timestamp:
    return cmttime.Timestamp(H.GENESIS_TIME.seconds + height, 0)


def sign_commit(state: State, block: Block, sign,
                shared_time: bool = False) -> tuple[BlockID, Commit, object]:
    """Every validator of `state` precommits `block` in round 0: sign(address,
    sign_bytes) -> signature. Each vote carries its own timestamp, or with
    `shared_time` one for all, so that every validator signs the same bytes.
    Returns (block id, commit, part set)."""
    parts = block.make_part_set(BLOCK_PART_SIZE)
    bid = BlockID(hash=block.hash(), part_set_header=parts.header())
    h = block.header.height
    sigs = [CommitSig(BlockIDFlag.COMMIT, v.address,
                      cmttime.Timestamp(block_time(h).seconds, 0 if shared_time else i))
            for i, v in enumerate(state.validators.validators)]
    commit = Commit(h, 0, bid, sigs)
    rows = commit.vote_sign_bytes_all(state.chain_id)
    for i, cs in enumerate(sigs):
        cs.signature = sign(cs.validator_address, rows[i])
    return bid, commit, parts


@dataclass
class Chain:
    gdoc: GenesisDoc
    state: State  # after the last block
    block_store: BlockStore
    states: dict  # height -> State.to_bytes() after that block, for the heights kept
    sign_s: float = 0.0
    state_store: StateStore | None = None  # the validator sets and results by height


async def _exec_stack(gdoc: GenesisDoc):
    """A kvstore app and the State a node starts from: its Handshaker's
    InitChain, whose app hash the chain's first block carries."""
    app = KVStoreApplication()
    conns = AppConns(local_client_creator(app))
    await conns.start()
    store = StateStore(MemDB())
    state = await Handshaker(store, BlockStore(MemDB()), gdoc).handshake(conns)
    mempool = CListMempool(MempoolConfig(), conns.mempool)
    return app, conns, state, store, mempool, BlockExecutor(store, conns.consensus, mempool)


def block_txs(height: int, n: int | None, value_bytes: int = 1) -> list[bytes]:
    """A block's kvstore txs: one, `h<height>=v`, or with `n` that many
    keys of `value_bytes`-byte values."""
    if n is None:
        return [b"h%d=v" % height]
    return [b"h%d-%d=%s" % (height, i, b"v" * value_bytes) for i in range(n)]


async def build_chain(gdoc: GenesisDoc, n_blocks: int, sign, keep: tuple = (),
                      txs_per_block: int | None = None, value_bytes: int = 1,
                      shared_time: bool = False) -> Chain:
    """An n_blocks chain with full stores (a serving node's data): one tx a
    block (or `txs_per_block` txs of `value_bytes`-byte values: block_txs),
    block times from the genesis time, commits from `sign` (one timestamp a
    commit with `shared_time`: sign_commit). The State bytes are kept after
    the heights of `keep` and after n_blocks - 1, where a sync stops."""
    import time

    _app, conns, state, store, _mempool, executor = await _exec_stack(gdoc)
    block_store = BlockStore(MemDB())
    last_commit = Commit(height=0, round_=0, block_id=BlockID(), signatures=[])
    states, sign_s = {}, 0.0
    try:
        for height in range(1, n_blocks + 1):
            block = state.make_block(height, block_txs(height, txs_per_block, value_bytes),
                                     last_commit, [], state.validators.get_proposer().address,
                                     block_time=block_time(height))
            t0 = time.perf_counter()
            bid, commit, parts = sign_commit(state, block, sign, shared_time)
            sign_s += time.perf_counter() - t0
            state = await executor.apply_block(state, bid, block, validated=True)
            block_store.save_block(block, parts, commit)
            if height in keep or height == n_blocks - 1:
                states[height] = state.to_bytes()
            last_commit = commit
    finally:
        await conns.stop()
    return Chain(gdoc=gdoc, state=state, block_store=block_store, states=states, sign_s=sign_s,
                 state_store=store)


def stepped_bls_signer(secrets: dict):
    """sign(address, msg) for BLS validators whose secrets step by one
    ({address: secret}, sk_i = sk_0 + i) and who all sign one message a
    commit (build_chain's shared_time): the first call for a message
    computes every validator's signature, sig_i = sig_(i-1) + H(msg), one
    point addition each."""
    from cometbft_tpu_torch.crypto import bls12381
    from cometbft_tpu_torch.crypto import bls12381_math as O

    order = sorted(secrets.items(), key=lambda kv: kv[1])
    if any(sk != order[0][1] + i for i, (_, sk) in enumerate(order)):
        raise ValueError("the secrets must step by one")
    cache: dict = {}

    def sign(address: bytes, msg: bytes) -> bytes:
        if msg not in cache:
            h = O._ec_from_affine(O.bls_hash_to_g2(msg, bls12381.DST))
            acc = O._ec_mul(O._Fp2Ops, order[0][1], h)
            sigs = {}
            for k, (addr, _) in enumerate(order):
                if k:
                    acc = O._ec_add(O._Fp2Ops, acc, h)
                sigs[addr] = O.bls_g2_compress(O._ec_affine(O._Fp2Ops, acc))
            cache.clear()
            cache[msg] = sigs
        return cache[msg][address]

    return sign


class LyingStore:
    """A block store that serves `inner`'s blocks with signature `index` of
    every LastCommit flipped: the block hash stands, the commit fails."""

    def __init__(self, inner: BlockStore, index: int = 0):
        self.inner = inner
        self.index = index
        self.served = 0

    def height(self) -> int:
        return self.inner.height()

    def base(self) -> int:
        return self.inner.base()

    def load_block_extended_commit(self, height: int):
        return self.inner.load_block_extended_commit(height)

    def load_block(self, height: int):
        block = self.inner.load_block(height)
        if block is None or not block.last_commit.signatures:
            return block
        block = Block.from_proto(block.to_proto())
        cs = block.last_commit.signatures[self.index]
        sig = bytearray(cs.signature)
        sig[40] ^= 1
        cs.signature = bytes(sig)
        self.served += 1
        return block


@dataclass
class SyncNode:
    """A fresh node with the full execution stack, its consensus waiting
    for block sync to hand over."""
    app: KVStoreApplication
    conns: AppConns
    state_store: StateStore
    block_store: BlockStore
    cs: ConsensusState
    cons_reactor: ConsensusReactor
    reactor: BlocksyncReactor
    switch: Switch
    transport: Transport
    log: io.StringIO


async def sync_node(gdoc: GenesisDoc, window: int, config: ConsensusConfig | None = None,
                    seed: int = 0, cert: bool = False) -> SyncNode:
    """A fresh node syncing at `window`; with `cert` its BlocksyncReactor
    holds a certificate plane over its own stores (not started: it asks
    peers for certificates and counts them)."""
    app, conns, state, store, mempool, execu = await _exec_stack(gdoc)
    bstore = BlockStore(MemDB())
    plane = None
    if cert:
        from cometbft_tpu_torch.cert import CertPlane, CertStore

        plane = CertPlane(CertStore(MemDB()), bstore, store, gdoc.chain_id)
    cs = ConsensusState(config=config or make_test_config(), state=state, block_exec=execu,
                        block_store=bstore, event_switch=EventSwitch())
    cons = ConsensusReactor(cs, wait_sync=True)
    log = io.StringIO()
    bcr = BlocksyncReactor(execu, bstore, active=True, consensus_reactor=cons, window=window,
                           logger=cmtlog.Logger(log, level=cmtlog.INFO), cert_plane=plane)
    bcr.set_state(state)
    _, transport, switch = make_switch("sync", gdoc.chain_id,
                                       {"CONSENSUS": cons, "BLOCKSYNC": bcr}, seed)
    return SyncNode(app=app, conns=conns, state_store=store, block_store=bstore, cs=cs,
                    cons_reactor=cons, reactor=bcr, switch=switch, transport=transport, log=log)


def serve_node(name: str, gdoc: GenesisDoc, block_store, seed: int = 0, cert_plane=None):
    """(node key, transport, switch) of a node that serves `block_store`,
    and with a `cert_plane` its commit certificates on channel 0x25."""
    bcr = BlocksyncReactor(BlockExecutor(StateStore(MemDB()), None, None), block_store,
                           active=False, cert_plane=cert_plane)
    return make_switch(name, gdoc.chain_id, {"BLOCKSYNC": bcr}, seed)
