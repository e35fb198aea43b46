"""Per-peer consensus state tracking.

Reference: consensus/reactor.go:1069 PeerState +
consensus/types/peer_round_state.go. The gossip routines consult this to
decide what the peer still needs (parts, votes, proposal); Receive handlers
update it from the peer's own announcements. Single event loop — no locks
(the reference needs a mutex because goroutines race; reactor.go:1075).

The port's copy of cometbft_tpu/consensus/peer_state.py.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from cometbft_tpu_torch.consensus import messages as M
from cometbft_tpu_torch.consensus.round_state import RoundStepType
from cometbft_tpu_torch.libs.bits import BitArray
from cometbft_tpu_torch.types.basic import PartSetHeader, SignedMsgType
from cometbft_tpu_torch.types.proposal import Proposal
from cometbft_tpu_torch.types.vote import Vote
from cometbft_tpu_torch.utils import cmttime


@dataclass
class PeerRoundState:
    """consensus/types/peer_round_state.go:9-42."""

    height: int = 0
    round_: int = -1
    step: RoundStepType = RoundStepType.NEW_HEIGHT
    start_time: cmttime.Timestamp = field(default_factory=cmttime.Timestamp.zero)
    proposal: bool = False
    proposal_block_part_set_header: PartSetHeader = field(default_factory=PartSetHeader)
    proposal_block_parts: BitArray | None = None
    proposal_pol_round: int = -1
    proposal_pol: BitArray | None = None
    prevotes: BitArray | None = None
    precommits: BitArray | None = None
    last_commit_round: int = -1
    last_commit: BitArray | None = None
    catchup_commit_round: int = -1
    catchup_commit: BitArray | None = None


class PeerState:
    def __init__(self, peer_id: str):
        self.peer_id = peer_id
        self.prs = PeerRoundState()
        # gossip accounting (fleet dimension): what this peer link cost.
        # votes_sent = votes our gossip routines pushed at the peer;
        # votes_recv_* = receiver-side classification of the peer's sends
        # (needed / already_had / stale); summaries_* = the reconciliation
        # plane. Rolled up by ConsensusReactor.gossip_accounting() into
        # net_telemetry — bounded by live peers, no metric labels.
        self.gossip: dict[str, int] = {
            "votes_sent": 0,
            "votes_recv": 0, "votes_recv_needed": 0,
            "votes_recv_already_had": 0, "votes_recv_stale": 0,
            "summaries_sent": 0, "summaries_applied": 0,
            "summaries_degraded": 0,
        }
        # set once when the peer turns out not to speak the RECON channel
        self.summary_unsupported = False
        # last summary signature sent, so an unchanged vote view is not
        # re-sent every interval: (height, round, prevote bytes, precommit
        # bytes)
        self.last_summary_sent: tuple | None = None

    # -------------------------------------------------------------- queries

    def get_height(self) -> int:
        return self.prs.height

    def get_vote_bit_array(
        self, height: int, round_: int, type_: SignedMsgType
    ) -> Optional[BitArray]:
        """reactor.go:1220 getVoteBitArray."""
        prs = self.prs
        if height == prs.height:
            if round_ == prs.round_:
                return prs.prevotes if type_ == SignedMsgType.PREVOTE else prs.precommits
            if round_ == prs.catchup_commit_round and type_ == SignedMsgType.PRECOMMIT:
                return prs.catchup_commit
            if round_ == prs.proposal_pol_round and type_ == SignedMsgType.PREVOTE:
                return prs.proposal_pol
            return None
        if height == prs.height - 1:
            if round_ == prs.last_commit_round and type_ == SignedMsgType.PRECOMMIT:
                return prs.last_commit
            return None
        return None

    # -------------------------------------------------------------- updates

    def set_has_proposal(self, proposal: Proposal) -> None:
        """reactor.go:1127."""
        prs = self.prs
        if prs.height != proposal.height or prs.round_ != proposal.round_:
            return
        if prs.proposal:
            return
        prs.proposal = True
        if prs.proposal_block_parts is not None:
            return  # NewValidBlock already set it
        prs.proposal_block_part_set_header = proposal.block_id.part_set_header
        prs.proposal_block_parts = BitArray(proposal.block_id.part_set_header.total)
        prs.proposal_pol_round = proposal.pol_round
        prs.proposal_pol = None  # until ProposalPOLMessage arrives

    def init_proposal_block_parts(self, header: PartSetHeader) -> None:
        """reactor.go:1147."""
        if self.prs.proposal_block_parts is not None:
            return
        self.prs.proposal_block_part_set_header = header
        self.prs.proposal_block_parts = BitArray(header.total)

    def set_has_proposal_block_part(self, height: int, round_: int, index: int) -> None:
        """reactor.go:1159."""
        prs = self.prs
        if prs.height != height or prs.round_ != round_:
            return
        if prs.proposal_block_parts is None:
            prs.proposal_block_parts = BitArray(index + 1)
        if index < prs.proposal_block_parts.size():
            prs.proposal_block_parts.set_index(index, True)

    def set_has_vote(self, height: int, round_: int, type_: SignedMsgType, index: int) -> None:
        """reactor.go:1288 setHasVote."""
        ba = self.get_vote_bit_array(height, round_, type_)
        if ba is not None and 0 <= index < ba.size():
            ba.set_index(index, True)

    def ensure_vote_bit_arrays(self, height: int, num_validators: int) -> None:
        """reactor.go:1249 EnsureVoteBitArrays."""
        prs = self.prs
        if prs.height == height:
            if prs.prevotes is None:
                prs.prevotes = BitArray(num_validators)
            if prs.precommits is None:
                prs.precommits = BitArray(num_validators)
            if prs.catchup_commit is None:
                prs.catchup_commit = BitArray(num_validators)
            if prs.proposal_pol is None:
                prs.proposal_pol = BitArray(num_validators)
        elif prs.height == height + 1:
            if prs.last_commit is None:
                prs.last_commit = BitArray(num_validators)

    def ensure_catchup_commit_round(self, height: int, round_: int, num_validators: int) -> None:
        """reactor.go:1233."""
        prs = self.prs
        if prs.height != height:
            return
        if prs.catchup_commit_round == round_:
            return
        prs.catchup_commit_round = round_
        if round_ == prs.round_:
            prs.catchup_commit = prs.precommits
        else:
            prs.catchup_commit = BitArray(num_validators)

    # ------------------------------------------------------- vote picking

    def pick_vote_to_send(self, votes) -> Optional[Vote]:
        """reactor.go:1185 PickVoteToSend: a random verified vote the peer
        does not have. `votes` is any vote-set reader: size() +
        bit_array() + get_by_index() + .height/.round_/.signed_msg_type."""
        prs = self.prs
        if votes.size() == 0:
            return None
        height, round_, type_ = votes.height, votes.round_, votes.signed_msg_type
        # lazily init the peer's bit arrays from the vote set's shape
        # (reactor.go:1185-1204: ensureCatchupCommitRound + ensureVoteBitArrays)
        if type_ == SignedMsgType.PRECOMMIT and height == prs.height and round_ != prs.round_:
            self.ensure_catchup_commit_round(height, round_, votes.size())
        self.ensure_vote_bit_arrays(height, votes.size())
        ps_votes = self.get_vote_bit_array(height, round_, type_)
        if ps_votes is None:
            return None
        gap = votes.bit_array().sub(ps_votes)
        idx, ok = gap.pick_random()
        if not ok:
            return None
        return votes.get_by_index(idx)

    # ------------------------------------------------- message application

    def apply_new_round_step(self, msg: M.NewRoundStepMessage) -> None:
        """reactor.go:1313 ApplyNewRoundStepMessage."""
        prs = self.prs
        # ignore stale announcements
        if (
            msg.height < prs.height
            or (msg.height == prs.height and msg.round_ < prs.round_)
            or (
                msg.height == prs.height
                and msg.round_ == prs.round_
                and msg.step < int(prs.step)
            )
        ):
            return
        psh_round = prs.round_
        ps_catchup_round = prs.catchup_commit_round
        ps_precommits = prs.precommits
        start_height, start_round = prs.height, prs.round_

        prs.height = msg.height
        prs.round_ = msg.round_
        prs.step = RoundStepType(msg.step)
        prs.start_time = cmttime.now().add_seconds(-msg.seconds_since_start_time)

        if start_height != msg.height or start_round != msg.round_:
            # RE-ARM the vote-summary send (PR 12 residual): the
            # send-first routine suppresses resends while OUR view is
            # unchanged, but a summary sent while this peer was on an
            # earlier round was dropped as "stale" on its side — when
            # the peer arrives at a new (height, round) the next summary
            # tick must send again so a multi-round height repairs the
            # peer's vote view for the CURRENT round, not just the round
            # it happened to be on at connect time.
            self.last_summary_sent = None
            prs.proposal = False
            prs.proposal_block_part_set_header = PartSetHeader()
            prs.proposal_block_parts = None
            prs.proposal_pol_round = -1
            prs.proposal_pol = None
            prs.prevotes = None
            prs.precommits = None
        if start_height == msg.height and start_round != msg.round_ and msg.round_ == ps_catchup_round:
            # peer caught up to the round we tracked as its catchup commit
            prs.precommits = prs.catchup_commit
        if start_height != msg.height:
            # shift precommits to last_commit
            if start_height == msg.height - 1 and psh_round == msg.last_commit_round:
                prs.last_commit_round = msg.last_commit_round
                prs.last_commit = ps_precommits
            else:
                prs.last_commit_round = msg.last_commit_round
                prs.last_commit = None
            prs.catchup_commit_round = -1
            prs.catchup_commit = None

    def apply_new_valid_block(self, msg: M.NewValidBlockMessage) -> None:
        """reactor.go:1370."""
        prs = self.prs
        if prs.height != msg.height:
            return
        if prs.round_ != msg.round_ and not msg.is_commit:
            return
        prs.proposal_block_part_set_header = msg.block_part_set_header
        prs.proposal_block_parts = msg.block_parts

    def apply_proposal_pol(self, msg: M.ProposalPOLMessage) -> None:
        """reactor.go:1389."""
        prs = self.prs
        if prs.height != msg.height:
            return
        if prs.proposal_pol_round != msg.proposal_pol_round:
            return
        prs.proposal_pol = msg.proposal_pol

    def apply_has_vote(self, msg: M.HasVoteMessage) -> None:
        """reactor.go:1402."""
        if self.prs.height != msg.height:
            return
        self.set_has_vote(msg.height, msg.round_, msg.type_, msg.index)

    def apply_vote_summary(self, msg: M.VoteSummaryMessage,
                           expected_size: int | None = None) -> str:
        """Compact vote-set reconciliation: merge the peer's whole vote
        view for (height, round) into its bit arrays in ONE step — the
        batch form of apply_has_vote. Returns "applied", "stale" (the
        summary is for a height/round we no longer track for this peer —
        ignored, not an error), or "shape" (bit sizes disagree with the
        arrays we track or with `expected_size`, the caller's validator
        count — degraded, ignored). Merging is a monotonic in-place OR:
        a reordered older summary can never erase has-vote knowledge,
        and aliases (catchup_commit may be the same object as
        precommits) stay consistent.

        `expected_size` guards the None-array window right after a round
        change: without it a peer could install an arbitrary-size bitmap
        (the crc32 is integrity, not authentication) that poisons this
        peer's bookkeeping for the whole height — later correct-size
        summaries would read as shape mismatches and set_has_vote would
        silently drop out-of-range indices."""
        prs = self.prs
        if prs.height != msg.height or prs.round_ != msg.round_:
            return "stale"
        pairs = [(bits, attr) for bits, attr in
                 ((msg.prevotes, "prevotes"), (msg.precommits, "precommits"))
                 if bits is not None]
        # validate every shape BEFORE mutating anything: a half-applied
        # summary would be a new corruption mode of its own
        for bits, attr in pairs:
            if expected_size is not None and bits.size() != expected_size:
                return "shape"
            cur = getattr(prs, attr)
            if cur is not None and cur.size() != bits.size():
                return "shape"
        for bits, attr in pairs:
            cur = getattr(prs, attr)
            if cur is None:
                setattr(prs, attr, bits.copy())
            else:
                cur.or_update(bits)
        self.gossip["summaries_applied"] += 1
        return "applied"

    def apply_vote_set_bits(self, msg: M.VoteSetBitsMessage, our_votes: BitArray | None) -> None:
        """reactor.go:1412: if we know our votes for that block id, the
        peer's claimed bits are OR'd restricted to what it can prove;
        otherwise taken as-is."""
        ba = self.get_vote_bit_array(msg.height, msg.round_, msg.type_)
        if ba is None or msg.votes is None:
            return
        if our_votes is not None:
            other_votes = ba.sub(our_votes)
            has_votes = other_votes.or_(msg.votes)
            ba.update(has_votes)
        else:
            ba.update(msg.votes)
