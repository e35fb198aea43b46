"""HeightVoteSet — prevote/precommit VoteSets for every round of one height.

Reference: consensus/types/height_vote_set.go. Tracks which peers claim
catch-up rounds (peer_catchup_rounds, max 2 per peer) so Byzantine peers
can't force unbounded round allocations.

The port's copy of cometbft_tpu/consensus/height_vote_set.py.
"""

from __future__ import annotations

from cometbft_tpu_torch.types.basic import SignedMsgType
from cometbft_tpu_torch.types.validator import ValidatorSet
from cometbft_tpu_torch.types.vote import Vote
from cometbft_tpu_torch.types.vote_set import VoteSet


class ErrGotVoteFromUnwantedRound(Exception):
    pass


class HeightVoteSet:
    def __init__(self, chain_id: str, height: int, val_set: ValidatorSet,
                 extensions_enabled: bool = False, batch_flush_size: int = 128):
        self.chain_id = chain_id
        self.height = height
        self.val_set = val_set
        self.extensions_enabled = extensions_enabled
        self.batch_flush_size = batch_flush_size
        self.round_ = 0
        self._sets: dict[int, dict[str, VoteSet]] = {}
        self._peer_catchup_rounds: dict[str, list[int]] = {}
        self._add_round(0)

    def _add_round(self, round_: int) -> None:
        if round_ in self._sets:
            return
        # auto_flush off: ConsensusState drives flushes so it can observe
        # the per-vote results (events, threshold hooks, evidence)
        self._sets[round_] = {
            "prevote": VoteSet(self.chain_id, self.height, round_,
                               SignedMsgType.PREVOTE, self.val_set,
                               batch_flush_size=self.batch_flush_size,
                               auto_flush=False),
            "precommit": VoteSet(self.chain_id, self.height, round_,
                                 SignedMsgType.PRECOMMIT, self.val_set,
                                 extensions_enabled=self.extensions_enabled,
                                 batch_flush_size=self.batch_flush_size,
                                 auto_flush=False),
        }

    def set_round(self, round_: int) -> None:
        """Create vote sets up to round_+1 (catchup; height_vote_set.go:104)."""
        new_round = self.round_
        for r in range(self.round_, round_ + 2):
            self._add_round(r)
        self.round_ = round_

    def add_vote(self, vote: Vote, peer_id: str = "") -> bool:
        """height_vote_set.go:126-160: non-current rounds only allowed from
        peers with catchup quota."""
        if not self._is_wanted(vote.round_, peer_id):
            raise ErrGotVoteFromUnwantedRound(
                f"peer {peer_id} has sent a vote for round {vote.round_} != current {self.round_}"
            )
        self._add_round(vote.round_)
        vs = self._get(vote.round_, vote.type_)
        return vs.add_vote(vote)

    def add_pending(self, vote: Vote, peer_id: str = "") -> bool:
        """Batch-path analog of add_vote: same round gating, then stage the
        vote in the round's VoteSet for deferred device verification (the
        SURVEY §3.3 hot path)."""
        if not self._is_wanted(vote.round_, peer_id):
            raise ErrGotVoteFromUnwantedRound(
                f"peer {peer_id} has sent a vote for round {vote.round_} != current {self.round_}"
            )
        self._add_round(vote.round_)
        vs = self._get(vote.round_, vote.type_)
        return vs.add_pending(vote)

    def pending_sets(self) -> list[VoteSet]:
        """All VoteSets with staged (unflushed) votes, every round/type."""
        out = []
        for sets in self._sets.values():
            for vs in sets.values():
                if vs._pending:
                    out.append(vs)
        return out

    def _is_wanted(self, round_: int, peer_id: str) -> bool:
        if self.round_ <= round_ <= self.round_ + 1:
            return True
        if round_ in self._sets:
            return True
        rounds = self._peer_catchup_rounds.setdefault(peer_id, [])
        if round_ in rounds:
            return True
        if len(rounds) < 2:
            rounds.append(round_)
            return True
        return False

    def _get(self, round_: int, type_: SignedMsgType) -> VoteSet | None:
        sets = self._sets.get(round_)
        if sets is None:
            return None
        return sets["prevote" if type_ == SignedMsgType.PREVOTE else "precommit"]

    def prevotes(self, round_: int) -> VoteSet | None:
        return self._get(round_, SignedMsgType.PREVOTE)

    def precommits(self, round_: int) -> VoteSet | None:
        return self._get(round_, SignedMsgType.PRECOMMIT)

    def pol_info(self) -> tuple[int, object]:
        """Highest round with a prevote +2/3 majority (POLRound, POLBlockID)."""
        for r in sorted(self._sets.keys(), reverse=True):
            vs = self.prevotes(r)
            if vs is not None:
                bid, ok = vs.two_thirds_majority()
                if ok:
                    return r, bid
        return -1, None
