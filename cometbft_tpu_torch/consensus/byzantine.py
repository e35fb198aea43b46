"""Byzantine validator harness: drive the REAL reactor stack adversarially.

Reference: consensus/byzantine_test.go — the byzantine node keeps its whole
production stack (reactors, switch, encrypted mconns) and only its decision
seams are replaced, so the honest majority is attacked over the same wire
it uses for everything else. Behaviors:

  equivocation   double-sign: every non-nil vote is shadowed by a second,
                 validly-signed vote for a fabricated block, gossiped to
                 peers (never enqueued locally — the liar believes its own
                 first story). Honest nodes must detect the conflict,
                 report it to the evidence pool, and commit
                 DuplicateVoteEvidence into a block.
  amnesia        vote, then forget: locks are wiped right after each
                 precommit, so later rounds can prevote a different block
                 (arXiv:2010.07031's amnesia attack shape).
  silence        a crashed-but-connected validator: gossip keeps flowing,
                 votes never come. Costs one validator of liveness margin,
                 never safety.
  flood          invalid-signature flooding: bursts of votes carrying the
                 byzantine validator's real address but forged signatures.
                 The batch verifier must reject every lane and the peer
                 scorer must ban the sender (p2p/switch.py).

The double-sign is only possible because the harness signs with the raw
key via UnsafeSigner — FilePV's HRS guard exists precisely to refuse this,
which is why the reference's byzantine tests also swap the signer.

The port's copy of cometbft_tpu/consensus/byzantine.py, over the port's
seams ConsensusState._sign_add_vote and _gossip. An unknown behaviour
raises ValueError at make_byzantine, so a Node with one fails at
construction, as the reference's does.
"""

from __future__ import annotations

import asyncio
import os

from cometbft_tpu_torch import crypto
from cometbft_tpu_torch.consensus import messages as M
from cometbft_tpu_torch.consensus.state import ConsensusState
from cometbft_tpu_torch.crypto import tmhash
from cometbft_tpu_torch.privval.file_pv import PrivValidator
from cometbft_tpu_torch.types.basic import BlockID, PartSetHeader, SignedMsgType
from cometbft_tpu_torch.types.proposal import Proposal
from cometbft_tpu_torch.types.vote import Vote

BEHAVIORS = ("equivocation", "amnesia", "silence", "flood")

FLOOD_INTERVAL = 0.05   # seconds between bursts
FLOOD_BURST = 4         # forged votes per burst


class UnsafeSigner(PrivValidator):
    """A privval with NO double-sign protection — the byzantine analog of
    handing an attacker the raw key. Never use outside tests/harnesses."""

    def __init__(self, priv_key: crypto.PrivKey):
        self.priv_key = priv_key

    def get_pub_key(self) -> crypto.PubKey:
        return self.priv_key.pub_key()

    def sign_vote(self, chain_id: str, vote: Vote, sign_extension: bool = False) -> None:
        vote.signature = self.priv_key.sign(vote.sign_bytes(chain_id))
        if sign_extension and vote.type_ == SignedMsgType.PRECOMMIT and not vote.block_id.is_nil():
            vote.extension_signature = self.priv_key.sign(
                vote.extension_sign_bytes(chain_id))

    def sign_proposal(self, chain_id: str, proposal: Proposal) -> None:
        proposal.signature = self.priv_key.sign(proposal.sign_bytes(chain_id))


class ByzantineHarness:
    """Installed over a live ConsensusState by make_byzantine()."""

    def __init__(self, cs: ConsensusState, behavior: str, send=None):
        if behavior not in BEHAVIORS:
            raise ValueError(
                f"unknown byzantine behavior {behavior!r} (behaviors: {BEHAVIORS})")
        self.cs = cs
        self.behavior = behavior
        # outbound channel for adversarial messages; defaults to the state
        # machine's gossip tap (in-proc nets). Reactor stacks pass
        # switch_vote_sender(switch) so evil votes ride the real wire.
        self._send = send if send is not None else cs._gossip
        self._priv = cs.priv_validator.priv_key
        self._orig_sign_add_vote = cs._sign_add_vote
        self._flood_task: asyncio.Task | None = None
        self.equivocations = 0
        self.floods = 0
        self._install()

    # ------------------------------------------------------------ behaviors

    def _install(self) -> None:
        cs = self.cs
        if self.behavior == "equivocation":
            cs._sign_add_vote = self._equivocating_sign_add_vote
        elif self.behavior == "amnesia":
            cs._sign_add_vote = self._amnesiac_sign_add_vote
        elif self.behavior == "silence":
            cs._sign_add_vote = self._silent_sign_add_vote

    async def start(self) -> None:
        if self.behavior == "flood" and self._flood_task is None:
            self._flood_task = asyncio.get_running_loop().create_task(
                self._flood_routine())

    async def stop(self) -> None:
        if self._flood_task is not None:
            self._flood_task.cancel()
            try:
                await self._flood_task
            except (asyncio.CancelledError, Exception):  # noqa: BLE001
                pass
            self._flood_task = None
        self.cs._sign_add_vote = self._orig_sign_add_vote

    # ---------------------------------------------------------- equivocation

    def _conflicting_vote(self, vote: Vote, chain_id: str) -> Vote:
        """A validly-signed vote at the same H/R/type for a fabricated
        block — exactly the pair DuplicateVoteEvidence punishes."""
        fake = tmhash.sum_(b"byzantine-fork|" + vote.block_id.hash)
        evil = Vote(
            type_=vote.type_,
            height=vote.height,
            round_=vote.round_,
            block_id=BlockID(hash=fake,
                             part_set_header=PartSetHeader(total=1, hash=fake)),
            timestamp=vote.timestamp,
            validator_address=vote.validator_address,
            validator_index=vote.validator_index,
        )
        evil.signature = self._priv.sign(evil.sign_bytes(chain_id))
        return evil

    async def _equivocating_sign_add_vote(self, type_, hash_, psh):
        vote = await self._orig_sign_add_vote(type_, hash_, psh)
        if vote is None or not hash_:
            return vote
        if self.cs.state.consensus_params.abci.vote_extensions_enabled(vote.height) \
                and type_ == SignedMsgType.PRECOMMIT:
            # an extension-carrying double-sign needs a second extension
            # round-trip; equivocating on prevotes already yields evidence
            return vote
        evil = self._conflicting_vote(vote, self.cs.state.chain_id)
        self.equivocations += 1
        # gossip only — enqueueing it locally would trip our own
        # "conflicting vote from ourselves" containment
        self._send(M.VoteMessage(vote=evil))
        return vote

    # --------------------------------------------------------------- amnesia

    async def _amnesiac_sign_add_vote(self, type_, hash_, psh):
        vote = await self._orig_sign_add_vote(type_, hash_, psh)
        if vote is not None and type_ == SignedMsgType.PRECOMMIT and hash_:
            rs = self.cs.rs
            rs.locked_round = -1
            rs.locked_block = None
            rs.locked_block_parts = None
        return vote

    # --------------------------------------------------------------- silence

    async def _silent_sign_add_vote(self, type_, hash_, psh):
        return None

    # ----------------------------------------------------------------- flood

    def _forged_vote(self, rs) -> Vote:
        fake = os.urandom(32)
        return Vote(
            type_=SignedMsgType.PREVOTE,
            height=rs.height,
            round_=rs.round_,
            block_id=BlockID(hash=fake,
                             part_set_header=PartSetHeader(total=1, hash=fake)),
            timestamp=self.cs.rs.start_time,
            validator_address=self._priv.pub_key().address(),
            validator_index=self._own_index(rs),
            signature=os.urandom(64),
        )

    def _own_index(self, rs) -> int:
        if rs.validators is None:
            return 0
        idx, _ = rs.validators.get_by_address(self._priv.pub_key().address())
        return max(idx, 0)

    async def _flood_routine(self) -> None:
        while True:
            await asyncio.sleep(FLOOD_INTERVAL)
            rs = self.cs.rs
            if rs.validators is None or rs.height == 0:
                continue
            for _ in range(FLOOD_BURST):
                self.floods += 1
                self._send(M.VoteMessage(vote=self._forged_vote(rs)))


def switch_vote_sender(switch):
    """Adapter: broadcast adversarial VoteMessages over the real p2p switch
    (the consensus reactor's vote channel)."""
    from cometbft_tpu_torch.consensus import reactor_codec as codec
    from cometbft_tpu_torch.consensus.reactor import VOTE_CHANNEL

    def send(msg) -> None:
        switch.broadcast(VOTE_CHANNEL, codec.encode(msg))

    return send


def make_byzantine(cs: ConsensusState, behavior: str, send=None) -> ByzantineHarness:
    """Turn a live ConsensusState adversarial. Swaps the privval for an
    UnsafeSigner (double-signing requires bypassing FilePV's HRS guard)
    and installs the behavior's decision seams. Returns the harness;
    call start()/stop() around the node's lifetime for flood mode."""
    cs.priv_validator = UnsafeSigner(cs.priv_validator.priv_key)
    return ByzantineHarness(cs, behavior, send=send)
