"""In-process consensus nets of the port: the JAX-free counterpart of
tests/net_harness.py (torch, numpy and cometbft_tpu_torch only), which
chip_smoke.py imports for its consensus phase.

make_net builds N real validators, each a full vertical stack (kvstore app
over AppConns(local_client_creator), StateStore and BlockStore on MemDB,
CListMempool, EvidencePool, BlockExecutor, ConsensusState with a FilePV).
The "network" is each state machine's outbound_hook fanning its proposals,
parts and votes into every other node's peer queue. Keys come from a seed.

make_hub builds ONE real node among n validators; the others are stub
validators in the manner of CometBFT's consensus/common_test.go
(validatorStub, decideProposal): they sign prevotes and precommits for what
the real node votes for, and when a stub is the proposer the hub builds the
block through the real node's BlockExecutor.create_proposal_block, signs
the Proposal with the stub's key and delivers the proposal and its parts.
One stub may sign one tampered prevote, and one may equivocate once.
"""

from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass, field

import torch

from cometbft_tpu_torch.abci.kvstore import KVStoreApplication
from cometbft_tpu_torch.consensus import ConsensusState
from cometbft_tpu_torch.consensus import messages as M
from cometbft_tpu_torch.consensus.config import ConsensusConfig
from cometbft_tpu_torch.consensus.config import test_consensus_config as make_test_config
from cometbft_tpu_torch.consensus.round_state import RoundStepType
from cometbft_tpu_torch.consensus.state import BLOCK_PART_SIZE
from cometbft_tpu_torch.crypto import batch as crypto_batch
from cometbft_tpu_torch.crypto import bls12381, ed25519, ed25519_math, sr25519
from cometbft_tpu_torch.evidence import EvidencePool
from cometbft_tpu_torch.libs.events import EventSwitch
from cometbft_tpu_torch.mempool.mempool import TX_SIG_OVERHEAD, CListMempool, MempoolConfig
from cometbft_tpu_torch.privval.file_pv import FilePV
from cometbft_tpu_torch.proxy import AppConns, local_client_creator
from cometbft_tpu_torch.state import BlockExecutor, State, StateStore
from cometbft_tpu_torch.store import BlockStore, MemDB
from cometbft_tpu_torch.types.basic import BlockID, BlockIDFlag, SignedMsgType
from cometbft_tpu_torch.types.commit import CommitSig, ExtendedCommit, ExtendedCommitSig
from cometbft_tpu_torch.types.genesis import GenesisDoc, GenesisValidator
from cometbft_tpu_torch.types.proposal import Proposal
from cometbft_tpu_torch.types.vote import Vote
from cometbft_tpu_torch.utils import cmttime

GENESIS_TIME = cmttime.Timestamp(1_700_000_000, 0)


class SignedKVStoreApplication(KVStoreApplication):
    """The kvstore over signed txs (mempool tx_verify="ed25519": pub(32) ||
    sig(64) || payload): the app reads the payload as its key=value tx."""

    def _parse_kv(self, tx: bytes):
        return super()._parse_kv(tx[TX_SIG_OVERHEAD:])


def signed_tx(priv, payload: bytes, forge: bool = False) -> bytes:
    """pub || sig || payload; `forge` signs other bytes."""
    sig = priv.sign(payload + b"!" if forge else payload)
    return priv.pub_key().bytes_() + sig + payload


def gen_priv(scheme: str, i: int, seed: int = 0):
    """Validator i's key of `scheme`, from the seed."""
    secret = b"torch-net-%d-%d" % (seed, i)
    mod = {"ed25519": ed25519, "sr25519": sr25519, "bls12381": bls12381}.get(scheme)
    if mod is None:
        raise ValueError(f"unknown key scheme {scheme!r}")
    return mod.gen_priv_key_from_secret(secret)


def use_device(device) -> None:
    """Point crypto.batch at `device`: the "cpu" backend for the CPU, the
    card ("gpu") otherwise. Process-global, as the backend is."""
    if device is not None:
        crypto_batch.set_backend("cpu" if torch.device(device).type == "cpu" else "gpu")


def genesis(privs: list, chain_id: str, ext_enable_height: int = 0,
            power: int = 10) -> GenesisDoc:
    gdoc = GenesisDoc(
        genesis_time=GENESIS_TIME,
        chain_id=chain_id,
        validators=[GenesisValidator(address=p.pub_key().address(), pub_key=p.pub_key(),
                                     power=power) for p in privs],
    )
    gdoc.consensus_params.abci.vote_extensions_enable_height = ext_enable_height
    gdoc.validate_and_complete()
    return gdoc


@dataclass
class NetNode:
    name: str
    cs: ConsensusState
    conns: AppConns
    mempool: CListMempool
    block_store: BlockStore
    state_store: StateStore
    evidence_pool: EvidencePool
    block_exec: BlockExecutor
    app: KVStoreApplication
    running: bool = False


async def make_node(name: str, gdoc: GenesisDoc, priv, config: ConsensusConfig,
                    app_factory=None, mempool_config: MempoolConfig | None = None,
                    event_switch=None) -> NetNode:
    state = State.from_genesis(gdoc)
    app = (app_factory or KVStoreApplication)()
    conns = AppConns(local_client_creator(app))
    await conns.start()
    state_store = StateStore(MemDB())
    state_store.bootstrap(state)
    block_store = BlockStore(MemDB())
    mempool = CListMempool(mempool_config or MempoolConfig(), conns.mempool)
    ev_pool = EvidencePool(MemDB(), state_store, block_store=block_store)
    block_exec = BlockExecutor(state_store, conns.consensus, mempool, evidence_pool=ev_pool)
    cs = ConsensusState(config=config, state=state, block_exec=block_exec,
                        block_store=block_store, wal=None,
                        priv_validator=FilePV(priv), event_switch=event_switch)
    return NetNode(name=name, cs=cs, conns=conns, mempool=mempool, block_store=block_store,
                   state_store=state_store, evidence_pool=ev_pool, block_exec=block_exec,
                   app=app)


@dataclass
class InProcNet:
    nodes: list[NetNode] = field(default_factory=list)
    privs: list = field(default_factory=list)
    gdoc: GenesisDoc | None = None
    _tasks: set = field(default_factory=set)

    def wire(self, node: NetNode) -> None:
        sender = node.name

        def hook(msg) -> None:
            for other in self.nodes:
                if other.name == sender or not other.running:
                    continue
                if isinstance(msg, M.VoteMessage):
                    coro = other.cs.add_vote_from_peer(msg.vote, sender)
                elif isinstance(msg, M.ProposalMessage):
                    coro = other.cs.add_proposal_from_peer(msg.proposal, sender)
                elif isinstance(msg, M.BlockPartMessage):
                    coro = other.cs.add_block_part_from_peer(
                        msg.height, msg.round_, msg.part, sender)
                else:
                    continue
                task = asyncio.get_running_loop().create_task(coro)
                self._tasks.add(task)
                task.add_done_callback(self._tasks.discard)

        node.cs.outbound_hook = hook

    async def start(self) -> None:
        for n in self.nodes:
            n.running = True
            await n.cs.start()

    async def stop(self) -> None:
        for n in self.nodes:
            if n.running:
                n.running = False
                await n.cs.stop()
            await n.conns.stop()
        for t in list(self._tasks):
            t.cancel()
        if self._tasks:
            await asyncio.gather(*self._tasks, return_exceptions=True)

    def min_height(self) -> int:
        return min(n.block_store.height() for n in self.nodes)

    def failed(self) -> list[str]:
        return [n.name for n in self.nodes if n.cs.failed]

    async def wait_for_height(self, h: int, timeout: float) -> None:
        """Every node at height >= h within `timeout` s, its block stored
        and applied (a block is saved before apply_block's awaits); raises
        at once if a node's consensus routine died."""
        async def poll():
            while self.min_height() < h or any(
                    n.cs.state.last_block_height < h for n in self.nodes):
                if self.failed():
                    raise RuntimeError(f"consensus failure on {self.failed()}")
                await asyncio.sleep(0.01)

        await asyncio.wait_for(poll(), timeout)


async def make_net(n_vals: int = 4, config: ConsensusConfig | None = None,
                   chain_id: str = "torch-net-chain", key_schemes: list[str] | None = None,
                   ext_enable_height: int = 0, device=None, app_factory=None,
                   mempool_config: MempoolConfig | None = None, seed: int = 0) -> InProcNet:
    """n_vals real validators of power 10 (keys of `key_schemes`, ed25519 by
    default, from `seed`); `device` points crypto.batch at the CPU or the
    card (None leaves the backend as it is)."""
    use_device(device)
    schemes = key_schemes or ["ed25519"] * n_vals
    if len(schemes) != n_vals:
        raise ValueError(f"{len(schemes)} key schemes for {n_vals} validators")
    privs = [gen_priv(s, i, seed) for i, s in enumerate(schemes)]
    gdoc = genesis(privs, chain_id, ext_enable_height)
    net = InProcNet(privs=privs, gdoc=gdoc)
    for i in range(n_vals):
        node = await make_node(f"val{i}", gdoc, privs[i], config or make_test_config(),
                               app_factory, mempool_config)
        net.nodes.append(node)
        net.wire(node)
    return net


# ------------------------------------------------------------ stub validators


def _unsigned_vote(priv, type_: SignedMsgType, height: int, round_: int, block_id: BlockID,
                   index: int) -> Vote:
    return Vote(type_=type_, height=height, round_=round_, block_id=block_id,
                timestamp=cmttime.canonical_now_ms(),
                validator_address=priv.pub_key().address(), validator_index=index)


@dataclass
class HubNet:
    """One real node (`node`) among the validators of `privs`; the others are
    stubs, named by their validator index in the genesis set."""
    node: NetNode
    privs: list
    gdoc: GenesisDoc
    real: int
    tamper: tuple[int, int] | None = None  # (height, stub index): one bad prevote
    equivocate: tuple[int, int] | None = None  # (height, stub index): nil + block prevotes
    # an executor (a process pool) that signs the stubs' votes off the event
    # loop through ed25519_math.sign(seed, msg); None signs inline
    sign_pool: object = None
    sign_s: float = 0.0  # wall time of the stubs' signing
    # what the stubs did: (height, stub) of the tampered vote, of the
    # equivocation, and the heights each stub proposed
    tampered: list = field(default_factory=list)
    equivocated: list = field(default_factory=list)
    proposed: dict = field(default_factory=dict)
    misbehavior: list = field(default_factory=list)
    # precommits for the block the real node committed at each height:
    # height -> (round, block_id, {index: Vote})
    precommits: dict = field(default_factory=dict)
    _tasks: set = field(default_factory=set)

    def __post_init__(self):
        self._index = {}  # validator index -> stub priv, in the node's set order
        vals = self.node.cs.state.validators
        for i, p in enumerate(self.privs):
            if i != self.real:
                idx, _ = vals.get_by_address(p.pub_key().address())
                self._index[idx] = p
        self.real_index, _ = vals.get_by_address(self.privs[self.real].pub_key().address())
        cs = self.node.cs
        cs.outbound_hook = self._on_outbound
        cs.misbehavior_hook = lambda peer, reason: self.misbehavior.append((peer, reason))
        cs.event_switch.add_listener("hub", "NewRoundStep", self._on_step)

    def stub_name(self, index: int) -> str:
        return f"stub{index}"

    def _spawn(self, coro) -> None:
        task = asyncio.get_running_loop().create_task(coro)
        self._tasks.add(task)
        task.add_done_callback(self._tasks.discard)

    # the real node's votes: the stubs vote the same way
    def _on_outbound(self, msg) -> None:
        if isinstance(msg, M.VoteMessage):
            self._spawn(self._stub_votes(msg.vote))

    async def _sign(self, votes: list[tuple[int, Vote]]) -> None:
        chain = self.gdoc.chain_id
        seeds = [self._index[idx].bytes_()[:32] for idx, _ in votes]
        msgs = [v.sign_bytes(chain) for _, v in votes]
        t0 = time.perf_counter()
        if self.sign_pool is None:
            sigs = [ed25519_math.sign(s, m) for s, m in zip(seeds, msgs)]
        else:
            sigs = await asyncio.get_running_loop().run_in_executor(
                None, lambda: list(self.sign_pool.map(ed25519_math.sign, seeds, msgs,
                                                      chunksize=8)))
        self.sign_s += time.perf_counter() - t0
        for (_, v), sig in zip(votes, sigs):
            v.signature = sig

    async def _stub_votes(self, real: Vote) -> None:
        cs = self.node.cs
        h, r = real.height, real.round_
        if real.type_ == SignedMsgType.PRECOMMIT and not real.block_id.is_nil():
            self.precommits[h] = (r, real.block_id, {self.real_index: real})
        votes: list[tuple[int, Vote]] = []
        bad = None
        for idx, priv in self._index.items():
            if (real.type_ == SignedMsgType.PREVOTE and self.equivocate == (h, idx)
                    and not self.equivocated and not real.block_id.is_nil()):
                # the equivocation goes first, so that the quorum flush holds it
                self.equivocated.append((h, idx))
                votes.insert(0, (idx, _unsigned_vote(priv, real.type_, h, r, BlockID(), idx)))
            vote = _unsigned_vote(priv, real.type_, h, r, real.block_id, idx)
            if (real.type_ == SignedMsgType.PREVOTE and self.tamper == (h, idx)
                    and not self.tampered):
                self.tampered.append((h, idx))
                bad = vote
                votes.insert(0, (idx, vote))
            else:
                votes.append((idx, vote))
            if real.type_ == SignedMsgType.PRECOMMIT and h in self.precommits:
                self.precommits[h][2][idx] = vote
        await self._sign(votes)
        if bad is not None:
            sig = bytearray(bad.signature)
            sig[40] ^= 1
            bad.signature = bytes(sig)
        for idx, vote in votes:
            await cs.add_vote_from_peer(vote, self.stub_name(idx))

    # a stub's turn to propose
    def _on_step(self, rs) -> None:
        if rs.step != RoundStepType.PROPOSE:
            return
        idx, _ = rs.validators.get_by_address(rs.validators.get_proposer().address)
        if idx in self._index:
            self._spawn(self._stub_propose(rs.height, rs.round_, idx))

    def full_last_commit(self, height: int) -> ExtendedCommit | None:
        """Every validator's precommit for the block committed at `height`,
        as the stubs and the real node signed them."""
        got = self.precommits.get(height)
        if got is None:
            return None
        round_, block_id, by_index = got
        n = len(self.node.cs.state.last_validators)
        sigs = []
        for i in range(n):
            v = by_index.get(i)
            cs = (CommitSig(block_id_flag=BlockIDFlag.COMMIT, validator_address=v.validator_address,
                            timestamp=v.timestamp, signature=v.signature)
                  if v is not None else CommitSig.absent())
            sigs.append(ExtendedCommitSig(commit_sig=cs))
        return ExtendedCommit(height=height, round_=round_, block_id=block_id,
                              extended_signatures=sigs)

    async def _stub_propose(self, height: int, round_: int, idx: int) -> None:
        cs, chain = self.node.cs, self.gdoc.chain_id
        priv = self._index[idx]
        state = cs.state
        if height == state.initial_height:
            last = ExtendedCommit(height=0, round_=0, block_id=BlockID(), extended_signatures=[])
        else:
            last = self.full_last_commit(height - 1)
            if last is None or last.block_id != state.last_block_id:
                last = cs.rs.last_commit.make_extended_commit()
        block = await self.node.block_exec.create_proposal_block(
            height, state, last, priv.pub_key().address())
        parts = block.make_part_set(BLOCK_PART_SIZE)
        proposal = Proposal(height=height, round_=round_, pol_round=-1,
                            block_id=BlockID(hash=block.hash(), part_set_header=parts.header()),
                            timestamp=cmttime.now())
        proposal.signature = priv.sign(proposal.sign_bytes(chain))
        self.proposed.setdefault(idx, []).append(height)
        name = self.stub_name(idx)
        await cs.add_proposal_from_peer(proposal, name)
        for i in range(parts.total):
            await cs.add_block_part_from_peer(height, round_, parts.get_part(i), name)

    async def start(self) -> None:
        self.node.running = True
        await self.node.cs.start()

    async def stop(self) -> None:
        if self.node.running:
            self.node.running = False
            await self.node.cs.stop()
        await self.node.conns.stop()
        for t in list(self._tasks):
            t.cancel()
        if self._tasks:
            await asyncio.gather(*self._tasks, return_exceptions=True)

    async def wait_for_height(self, h: int, timeout: float) -> None:
        async def poll():
            while self.node.block_store.height() < h:
                if self.node.cs.failed:
                    raise RuntimeError("consensus failure on the real node")
                await asyncio.sleep(0.005)

        await asyncio.wait_for(poll(), timeout)


async def make_hub(n_vals: int = 150, real: int = 0, config: ConsensusConfig | None = None,
                   chain_id: str = "cosmoshub-4", device=None, seed: int = 0,
                   tamper: tuple[int, int] | None = None,
                   equivocate: tuple[int, int] | None = None, sign_pool=None) -> HubNet:
    """One real ed25519 validator (genesis index `real`) among n_vals of power
    10; `tamper` and `equivocate` name (height, stub's validator index)."""
    use_device(device)
    privs = [gen_priv("ed25519", i, seed) for i in range(n_vals)]
    gdoc = genesis(privs, chain_id)
    node = await make_node("real", gdoc, privs[real], config or make_test_config(),
                           event_switch=EventSwitch())
    return HubNet(node=node, privs=privs, gdoc=gdoc, real=real, tamper=tamper,
                  equivocate=equivocate, sign_pool=sign_pool)
