"""VoteSet — vote accumulation with batch-first verification.

Reference: types/vote_set.go. The reference verifies every incoming vote
serially on the consensus goroutine (vote_set.go:218-231: 10k serial
verifies per step at the largest validator set). This VoteSet keeps those
semantics for add_vote() but adds the batched path:

  add_pending(vote)  — cheap structural checks + staging + SPECULATIVE tally;
                       no consensus-visible state changes.
  flush_pending()    — one batch of all staged votes through crypto.batch
                       (with the scheduler on, an inline drain on the card:
                       K5, K1/K2, K6), then a second batch for the extension
                       signatures; only then are votes added to the real
                       tally.

The "never count an unverified vote" invariant holds: two_thirds_majority(),
get_vote(), make_commit() etc. read only verified state. The speculative
tally is used solely to decide when flushing is worthwhile (quorum boundary),
mirroring the deferred-flush design in SURVEY.md §7 step 2. Conflicting-vote
(equivocation) evidence semantics are preserved for both paths.

The port's copy of cometbft_tpu/types/vote_set.py. The batch verifier is
chosen by the proposer's key type; with the scheduler enabled (the default)
it is a ScheduledBatchVerifier, which takes rows of every scheme, so a mixed
ed25519 + sr25519 set flushes as one drain (one batch a scheme). What
differs: the flush stages its sign bytes factored (vote.sign_rows: the
same bytes, one shared prefix a block ID), so it takes the device-challenge
path (K5); the extension rows stay plain bytes. add_pending takes a
signature of its validator's key type's length (96 bytes for BLS12-381, 64
for the others), where the reference stages 64-byte signatures only.
"""

from __future__ import annotations

from dataclasses import dataclass

from cometbft_tpu_torch.crypto import batch as crypto_batch
from cometbft_tpu_torch.libs.bits import BitArray
from cometbft_tpu_torch.types.basic import MAX_VOTES_COUNT, BlockID, BlockIDFlag, SignedMsgType
from cometbft_tpu_torch.types.commit import Commit, CommitSig, ExtendedCommit, ExtendedCommitSig
from cometbft_tpu_torch.types.validator import ValidatorSet
from cometbft_tpu_torch.types.vote import Vote, sign_rows


# flush_pending per-vote statuses
FLUSH_ADDED = "added"        # signature verified, vote tallied
FLUSH_INVALID = "invalid"    # bad signature or extension signature
FLUSH_CONFLICT = "conflict"  # valid signature, rejected as equivocation


class ErrVoteConflictingVotes(Exception):
    """Equivocation detected — carries both votes (evidence material)."""

    def __init__(self, vote_a: Vote, vote_b: Vote):
        super().__init__(f"conflicting votes from validator {vote_b.validator_address.hex()}")
        self.vote_a = vote_a
        self.vote_b = vote_b


class ErrVoteInvalidSignature(Exception):
    pass


@dataclass
class _BlockVotes:
    """Votes for one particular block (vote_set.go:471-500)."""

    peer_maj23: bool
    bit_array: BitArray
    votes: list[Vote | None]
    sum: int

    @classmethod
    def new(cls, peer_maj23: bool, num_validators: int) -> "_BlockVotes":
        return cls(
            peer_maj23=peer_maj23,
            bit_array=BitArray(num_validators),
            votes=[None] * num_validators,
            sum=0,
        )

    def add_verified_vote(self, vote: Vote, voting_power: int) -> None:
        idx = vote.validator_index
        if self.votes[idx] is None:
            self.bit_array.set_index(idx, True)
            self.votes[idx] = vote
            self.sum += voting_power

    def get_by_index(self, idx: int) -> Vote | None:
        return self.votes[idx]


class VoteSet:
    """vote_set.go:55-100."""

    def __init__(
        self,
        chain_id: str,
        height: int,
        round_: int,
        signed_msg_type: SignedMsgType,
        val_set: ValidatorSet,
        extensions_enabled: bool = False,
        batch_flush_size: int = 128,
        auto_flush: bool = True,
    ):
        if height == 0:
            raise ValueError("cannot make VoteSet for height == 0, doesn't make sense")
        if len(val_set) > MAX_VOTES_COUNT:
            raise ValueError(f"validator set exceeds MaxVotesCount {MAX_VOTES_COUNT}")
        self.chain_id = chain_id
        self.height = height
        self.round_ = round_
        self.signed_msg_type = signed_msg_type
        self.extensions_enabled = extensions_enabled
        self.val_set = val_set
        self.votes_bit_array = BitArray(len(val_set))
        self.votes: list[Vote | None] = [None] * len(val_set)
        self.sum = 0
        self.maj23: BlockID | None = None
        self.votes_by_block: dict[bytes, _BlockVotes] = {}
        self.peer_maj23s: dict[str, BlockID] = {}
        # --- batch path state ---
        self.batch_flush_size = batch_flush_size
        # auto_flush=False hands flush control to the caller (consensus
        # needs the flush results to fire events / run threshold hooks)
        self.auto_flush = auto_flush
        self._pending: list[tuple[Vote, int]] = []  # (vote, voting_power)
        self._pending_by_key: dict[tuple[int, bytes], Vote] = {}
        self._speculative_sum = 0

    def size(self) -> int:
        return len(self.val_set)

    # ------------------------------------------------------ serial add path

    def add_vote(self, vote: Vote) -> bool:
        """Reference addVote (vote_set.go:157-231): full structural checks +
        serial signature verification + verified-tally update. Returns True
        if added; False for exact duplicates; raises on anything bad."""
        val, _ = self._check_structure(vote)
        existing = self._get_vote(vote.validator_index, vote.block_id.key())
        if existing is not None:
            if existing.signature == vote.signature:
                return False
            raise ValueError(
                f"non-deterministic signature: existing {existing}; new {vote}"
            )
        if self.extensions_enabled:
            if not vote.verify_vote_and_extension(self.chain_id, val.pub_key):
                raise ErrVoteInvalidSignature(f"failed to verify extended vote {vote}")
        else:
            if not vote.verify(self.chain_id, val.pub_key):
                raise ErrVoteInvalidSignature(f"failed to verify vote {vote}")
            if vote.extension or vote.extension_signature:
                raise ValueError("unexpected vote extension data present in vote")
        return self._add_verified_vote(vote, val.voting_power)

    # ------------------------------------------------------- batch add path

    def add_pending(self, vote: Vote) -> bool:
        """Stage a vote for batched verification. Cheap host-side checks
        only; consensus-visible state untouched. Returns True if staged
        (auto-flushes at quorum boundaries / batch size; see flush_pending)."""
        val, _ = self._check_structure(vote)
        want = crypto_batch.ScheduledBatchVerifier.SIGNATURE_SIZES.get(val.pub_key.type_(), 64)
        if len(vote.signature) != want:
            raise ErrVoteInvalidSignature(f"bad signature length {len(vote.signature)}")
        key = (vote.validator_index, vote.block_id.key())
        staged = self._pending_by_key.get(key)
        if staged is not None:
            if staged.signature == vote.signature:
                return False
            raise ValueError(
                f"non-deterministic signature: staged {staged}; new {vote}"
            )
        existing = self._get_vote(vote.validator_index, vote.block_id.key())
        if existing is not None:
            if existing.signature == vote.signature:
                return False
            raise ValueError(
                f"non-deterministic signature: existing {existing}; new {vote}"
            )
        if not self.extensions_enabled and (vote.extension or vote.extension_signature):
            raise ValueError("unexpected vote extension data present in vote")
        self._pending.append((vote, val.voting_power))
        self._pending_by_key[key] = vote
        if self.votes[vote.validator_index] is None:
            self._speculative_sum += val.voting_power
        if self.auto_flush and self.should_flush():
            self.flush_pending()
        return True

    def should_flush(self) -> bool:
        """True when flushing now is worthwhile: the staged batch is full,
        or the speculative (unverified) tally would cross the 2/3 quorum —
        the deferred-flush boundary that keeps 'never count an unverified
        vote' compatible with batching (SURVEY.md §7 step 2)."""
        if len(self._pending) >= self.batch_flush_size:
            return True
        # quorum boundary: the speculative (unverified) tally would cross
        # 2/3 — verifying now lets consensus observe the majority.
        quorum = self.val_set.total_voting_power() * 2 // 3 + 1
        return self.sum < quorum <= self.sum + self._speculative_sum

    def flush_pending(self) -> list[tuple[Vote, str]]:
        """Verify all staged votes in ONE device batch; fold the valid ones
        into the verified tally. Returns [(vote, status)] with status one
        of FLUSH_ADDED (verified + tallied), FLUSH_INVALID (bad
        signature/extension), FLUSH_CONFLICT (signature valid but rejected
        as an equivocation — distinct so callers can turn it into
        DuplicateVoteEvidence). Conflicting votes ALSO surface as
        ErrVoteConflictingVotes AFTER the tally is updated with everything
        non-conflicting (matching serial-path ordering)."""
        if not self._pending:
            return []
        pending, self._pending = self._pending, []
        self._pending_by_key.clear()
        self._speculative_sum = 0

        proposer = self.val_set.get_proposer()
        results: list[tuple[Vote, str]] = []
        batchable = len(pending) >= 2 and crypto_batch.supports_batch_verifier(
            proposer.pub_key if proposer else None
        )
        if batchable:
            bv = crypto_batch.create_batch_verifier(proposer.pub_key)
            rows = sign_rows(self.chain_id, [vote for vote, _ in pending])
            for (vote, _power), row in zip(pending, rows):
                _, val = self.val_set.get_by_index(vote.validator_index)
                bv.add(val.pub_key, row, vote.signature)
            _, mask = bv.verify()
        else:
            mask = []
            for vote, _power in pending:
                _, val = self.val_set.get_by_index(vote.validator_index)
                mask.append(vote.verify(self.chain_id, val.pub_key))

        ext_bad: set[int] = set()
        if self.extensions_enabled:
            # Extension signatures ride a second batch over the same keys.
            ext_rows = []
            for i, (vote, _) in enumerate(pending):
                if not mask[i] or vote.block_id.is_nil():
                    continue
                if len(vote.extension_signature) != 64:
                    ext_bad.add(i)  # structurally invalid: fails without device trip
                    continue
                ext_rows.append((i, vote))
            if ext_rows:
                bv2 = crypto_batch.create_batch_verifier(proposer.pub_key)
                for _, vote in ext_rows:
                    _, val = self.val_set.get_by_index(vote.validator_index)
                    bv2.add(val.pub_key, vote.extension_sign_bytes(self.chain_id), vote.extension_signature)
                _, ext_mask = bv2.verify()
                for (i, _), ok in zip(ext_rows, ext_mask):
                    if not ok:
                        ext_bad.add(i)

        conflict: ErrVoteConflictingVotes | None = None
        conflicts: list[ErrVoteConflictingVotes] = []
        for i, (vote, power) in enumerate(pending):
            if not (bool(mask[i]) and i not in ext_bad):
                results.append((vote, FLUSH_INVALID))
                continue
            existing = self._get_vote(vote.validator_index, vote.block_id.key())
            if existing is not None and existing.signature == vote.signature:
                # landed via the serial path while staged: already tallied
                results.append((vote, FLUSH_ADDED))
                continue
            try:
                self._add_verified_vote(vote, power)
                results.append((vote, FLUSH_ADDED))
            except ErrVoteConflictingVotes as e:
                conflict = conflict or e
                conflicts.append(e)
                results.append((vote, FLUSH_CONFLICT))
        if conflict is not None:
            # The raise preserves serial-path parity; the full per-vote
            # outcome survives on the exception so callers can build
            # DuplicateVoteEvidence for EVERY equivocation in the flush,
            # not just the first pair.
            conflict.results = results
            conflict.conflicts = conflicts
            raise conflict
        return results

    # -------------------------------------------------------------- internals

    def _check_structure(self, vote: Vote):
        if vote is None:
            raise ValueError("nil vote")
        if vote.validator_index < 0:
            raise ValueError("index < 0: invalid validator index")
        if not vote.validator_address:
            raise ValueError("empty address: invalid validator address")
        if (
            vote.height != self.height
            or vote.round_ != self.round_
            or vote.type_ != self.signed_msg_type
        ):
            raise ValueError(
                f"expected {self.height}/{self.round_}/{self.signed_msg_type}, got "
                f"{vote.height}/{vote.round_}/{vote.type_}: unexpected step"
            )
        lookup_addr, val = self.val_set.get_by_index(vote.validator_index)
        if val is None:
            raise ValueError(
                f"cannot find validator {vote.validator_index} in valSet of size {self.size()}"
            )
        if vote.validator_address != lookup_addr:
            raise ValueError(
                f"vote.ValidatorAddress ({vote.validator_address.hex()}) does not match "
                f"address ({lookup_addr.hex()}) for vote.ValidatorIndex ({vote.validator_index})"
            )
        return val, lookup_addr

    def _get_vote(self, val_index: int, block_key: bytes) -> Vote | None:
        existing = self.votes[val_index]
        if existing is not None and existing.block_id.key() == block_key:
            return existing
        bv = self.votes_by_block.get(block_key)
        if bv is not None:
            return bv.get_by_index(val_index)
        return None

    def _add_verified_vote(self, vote: Vote, voting_power: int) -> bool:
        """vote_set.go:257-330 addVerifiedVote."""
        val_index = vote.validator_index
        block_key = vote.block_id.key()
        conflicting: Vote | None = None

        existing = self.votes[val_index]
        if existing is None:
            self.votes[val_index] = vote
            self.votes_bit_array.set_index(val_index, True)
            self.sum += voting_power
        else:
            if existing.block_id == vote.block_id:
                raise RuntimeError("_add_verified_vote does not expect duplicate votes")
            conflicting = existing
            # Replace vote if the maj23 block's vote (vote_set.go:284-291)
            if self.maj23 is not None and self.maj23.key() == block_key:
                self.votes[val_index] = vote
                self.votes_bit_array.set_index(val_index, True)

        votes_by_block = self.votes_by_block.get(block_key)
        if votes_by_block is not None:
            if conflicting is not None and not votes_by_block.peer_maj23:
                # ignore conflicting vote without peer maj23 (vote_set.go:297-301)
                raise ErrVoteConflictingVotes(conflicting, vote)
        else:
            if conflicting is not None:
                # peer claimed no maj23 for this block: ignore (vote_set.go:305-312)
                raise ErrVoteConflictingVotes(conflicting, vote)
            votes_by_block = _BlockVotes.new(False, self.size())
            self.votes_by_block[block_key] = votes_by_block

        old_sum = votes_by_block.sum
        quorum = self.val_set.total_voting_power() * 2 // 3 + 1
        votes_by_block.add_verified_vote(vote, voting_power)
        if old_sum < quorum <= votes_by_block.sum and self.maj23 is None:
            self.maj23 = vote.block_id
            # promote this block's votes to the main tracking (vote_set.go:326-330)
            for i, v in enumerate(votes_by_block.votes):
                if v is not None:
                    self.votes[i] = v
        if conflicting is not None:
            raise ErrVoteConflictingVotes(conflicting, vote)
        return True

    # ---------------------------------------------------------- peer maj23

    def set_peer_maj23(self, peer_id: str, block_id: BlockID) -> None:
        """vote_set.go:339-368: peer claims a +2/3 majority for block_id."""
        existing = self.peer_maj23s.get(peer_id)
        if existing is not None:
            if existing == block_id:
                return
            raise ValueError(
                f"setPeerMaj23: Received conflicting blockID from peer {peer_id}: "
                f"{existing} vs {block_id}"
            )
        self.peer_maj23s[peer_id] = block_id
        block_key = block_id.key()
        votes_by_block = self.votes_by_block.get(block_key)
        if votes_by_block is not None:
            votes_by_block.peer_maj23 = True
        else:
            self.votes_by_block[block_key] = _BlockVotes.new(True, self.size())

    # ------------------------------------------------------------- queries

    def bit_array(self) -> BitArray:
        return self.votes_bit_array.copy()

    def bit_array_by_block_id(self, block_id: BlockID) -> BitArray | None:
        bv = self.votes_by_block.get(block_id.key())
        return bv.bit_array.copy() if bv is not None else None

    def get_by_index(self, idx: int) -> Vote | None:
        return self.votes[idx]

    def get_by_address(self, address: bytes) -> Vote | None:
        idx, val = self.val_set.get_by_address(address)
        return self.votes[idx] if val is not None else None

    def has_two_thirds_majority(self) -> bool:
        return self.maj23 is not None

    def two_thirds_majority(self) -> tuple[BlockID | None, bool]:
        if self.maj23 is not None:
            return self.maj23, True
        return None, False

    def has_two_thirds_any(self) -> bool:
        return self.sum > self.val_set.total_voting_power() * 2 // 3

    def has_one_third_any(self) -> bool:
        return self.sum > self.val_set.total_voting_power() // 3

    def has_all(self) -> bool:
        return self.sum == self.val_set.total_voting_power()

    def is_commit(self) -> bool:
        return self.signed_msg_type == SignedMsgType.PRECOMMIT and self.maj23 is not None

    # -------------------------------------------------------------- commit

    def make_commit(self) -> Commit:
        """vote_set.go MakeCommit (plain, pre-extension)."""
        if self.signed_msg_type != SignedMsgType.PRECOMMIT:
            raise ValueError("cannot MakeCommit() unless VoteSet.Type is PRECOMMIT")
        if self.maj23 is None:
            raise ValueError("cannot MakeCommit() unless a blockhash has +2/3")
        sigs = []
        for i, v in enumerate(self.votes):
            sigs.append(self._commit_sig_for(v, i))
        return Commit(
            height=self.height, round_=self.round_, block_id=self.maj23, signatures=sigs
        )

    def make_extended_commit(self) -> ExtendedCommit:
        if self.signed_msg_type != SignedMsgType.PRECOMMIT:
            raise ValueError("cannot MakeExtendedCommit() unless VoteSet.Type is PRECOMMIT")
        if self.maj23 is None:
            raise ValueError("cannot MakeExtendedCommit() unless a blockhash has +2/3")
        esigs = []
        for i, v in enumerate(self.votes):
            cs = self._commit_sig_for(v, i)
            esigs.append(
                ExtendedCommitSig(
                    commit_sig=cs,
                    extension=v.extension if v is not None and cs.for_block() else b"",
                    extension_signature=(
                        v.extension_signature if v is not None and cs.for_block() else b""
                    ),
                )
            )
        return ExtendedCommit(
            height=self.height,
            round_=self.round_,
            block_id=self.maj23,
            extended_signatures=esigs,
        )

    def _commit_sig_for(self, v: Vote | None, idx: int) -> CommitSig:
        if v is None:
            return CommitSig.absent()
        if v.block_id == self.maj23:
            flag = BlockIDFlag.COMMIT
        elif v.block_id.is_nil():
            flag = BlockIDFlag.NIL
        else:
            # Vote for a different block: excluded as ABSENT — its signature
            # is over that other BlockID and would fail reconstruction
            # (reference: vote_set.go MakeExtendedCommit:652-655).
            return CommitSig.absent()
        return CommitSig(
            block_id_flag=flag,
            validator_address=v.validator_address,
            timestamp=v.timestamp,
            signature=v.signature,
        )


def commit_to_vote_set(chain_id: str, commit: Commit, val_set: ValidatorSet) -> VoteSet:
    """Rebuild the precommit VoteSet a Commit was distilled from, verifying
    every signature (types/vote_set.go CommitToVoteSet). Used on restart to
    reconstruct LastCommit from the block store's seen commit."""
    vote_set = VoteSet(
        chain_id, commit.height, commit.round_, SignedMsgType.PRECOMMIT, val_set
    )
    for idx, cs in enumerate(commit.signatures):
        if not cs.for_block() and not cs.signature:
            continue  # OK, absent — no vote to reconstruct
        added = vote_set.add_vote(commit.get_vote(idx))
        if not added:
            raise RuntimeError(f"failed to reconstruct vote {idx} from commit")
    return vote_set


def extended_commit_to_vote_set(
    chain_id: str, ext_commit: ExtendedCommit, val_set: ValidatorSet
) -> VoteSet:
    """types/vote_set.go ExtendedCommit.ToExtendedVoteSet: like
    commit_to_vote_set but carrying (and verifying) vote extensions."""
    vote_set = VoteSet(
        chain_id,
        ext_commit.height,
        ext_commit.round_,
        SignedMsgType.PRECOMMIT,
        val_set,
        extensions_enabled=True,
    )
    commit = ext_commit.to_commit()  # hoisted: get_extended_vote rebuilds it per call
    for idx, ecs in enumerate(ext_commit.extended_signatures):
        if not ecs.commit_sig.for_block() and not ecs.commit_sig.signature:
            continue
        vote = commit.get_vote(idx)
        vote.extension = ecs.extension
        vote.extension_signature = ecs.extension_signature
        added = vote_set.add_vote(vote)
        if not added:
            raise RuntimeError(f"failed to reconstruct extended vote {idx}")
    return vote_set
