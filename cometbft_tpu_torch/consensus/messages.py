"""Consensus message types flowing through the state-machine queue.

Reference: consensus/reactor.go:1576-1592 message taxonomy; the subset the
state machine consumes (Proposal/BlockPart/Vote) plus the gossip-control
messages the reactor exchanges (NewRoundStep, HasVote, VoteSetMaj23, ...).

The port's copy of cometbft_tpu/consensus/messages.py.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from cometbft_tpu_torch.libs.bits import BitArray
from cometbft_tpu_torch.types.basic import BlockID, SignedMsgType
from cometbft_tpu_torch.types.part_set import Part
from cometbft_tpu_torch.types.proposal import Proposal
from cometbft_tpu_torch.types.vote import Vote


@dataclass
class ProposalMessage:
    proposal: Proposal
    peer_id: str = ""


@dataclass
class BlockPartMessage:
    height: int
    round_: int
    part: Part
    peer_id: str = ""


@dataclass
class VoteMessage:
    vote: Vote
    peer_id: str = ""


# ---- reactor-level gossip control messages (consensus/reactor.go) ----


@dataclass
class NewRoundStepMessage:
    height: int
    round_: int
    step: int
    seconds_since_start_time: int = 0
    last_commit_round: int = -1


@dataclass
class NewValidBlockMessage:
    height: int
    round_: int
    block_part_set_header: object = None
    block_parts: BitArray | None = None
    is_commit: bool = False


@dataclass
class ProposalPOLMessage:
    height: int
    proposal_pol_round: int
    proposal_pol: BitArray | None = None


@dataclass
class HasVoteMessage:
    height: int
    round_: int
    type_: SignedMsgType = SignedMsgType.UNKNOWN
    index: int = -1


@dataclass
class VoteSetMaj23Message:
    height: int
    round_: int
    type_: SignedMsgType
    block_id: BlockID = field(default_factory=BlockID)


@dataclass
class VoteSetBitsMessage:
    height: int
    round_: int
    type_: SignedMsgType
    block_id: BlockID = field(default_factory=BlockID)
    votes: BitArray | None = None


@dataclass
class VoteSummaryMessage:
    """Compact vote-set reconciliation (no reference analog): one frame
    carrying BOTH vote-presence bitmaps for (height, round) — the batch
    form of per-vote HasVote announcements, so a peer whose HasVotes were
    lost (drops, full queues, churn) re-learns our whole vote view in one
    message and stops re-sending votes we already have. Rides its own
    channel (reactor.RECON_CHANNEL) so nodes that never negotiated it
    simply never see it, and carries an end-to-end checksum so a
    corrupted summary degrades to plain full gossip instead of poisoning
    the peer's bookkeeping."""

    height: int
    round_: int
    prevotes: BitArray | None = None
    precommits: BitArray | None = None
    checksum: int = 0
