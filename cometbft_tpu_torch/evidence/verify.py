"""Evidence verification (reference: evidence/verify.go).

verify_evidence: age/expiry checks against consensus params + dispatch by
type (verify.go:19-108). verify_duplicate_vote: the equivocation proof
check (verify.go:166-232) — both votes must be valid signatures from the
same validator over the same height/round/type but different block IDs.
Signature checks ride the batch verifier (two sigs per evidence coalesce
with anything else in flight on the device).

The port's copy of cometbft_tpu/evidence/verify.py. What differs: a
RuntimeError (no card on the "gpu" backend, a kernel or staging failure)
propagates as itself instead of being wrapped in ErrInvalidEvidence.
"""

from __future__ import annotations

from cometbft_tpu_torch.crypto import batch as crypto_batch
from cometbft_tpu_torch.state.state import State
from cometbft_tpu_torch.types.evidence import DuplicateVoteEvidence, Evidence, LightClientAttackEvidence
from cometbft_tpu_torch.types.validator import ValidatorSet


class ErrInvalidEvidence(Exception):
    pass


def verify_evidence(ev: Evidence, state: State, get_validators,
                    block_store=None, from_consensus: bool = False) -> None:
    """verify.go:19-108:
    - structural validity (validate_basic)
    - the recorded time must equal the block time at the evidence height
      (verify.go:28-35; an attacker-chosen time would defeat time-based
      expiry) — skipped for evidence our own consensus produced
      (from_consensus, ref AddEvidenceFromConsensus), whose height has no
      committed header yet
    - the evidence must not be expired (height AND time window)
    - the evidence height's validator set must contain the culprit(s)
    get_validators(height) -> ValidatorSet | None (historical lookup);
    block_store supplies historical headers (None -> LC evidence rejected
    for lack of a header source; time check skipped)."""
    # structural validity is the pool's intake contract (add/check call
    # validate_basic before hashing); only the semantic checks live here
    ev_time = ev.time()
    if not from_consensus and block_store is not None:
        meta = block_store.load_block_meta(ev.height())
        if meta is None:
            raise ErrInvalidEvidence(f"no header at evidence height {ev.height()}")
        if ev_time.unix_ns() != meta.header.time.unix_ns():
            raise ErrInvalidEvidence(
                f"evidence time ({ev_time}) differs from the block time at its "
                f"height ({meta.header.time})"
            )
        ev_time = meta.header.time
    ev_params = state.consensus_params.evidence
    height = state.last_block_height
    age_num_blocks = height - ev.height()
    age_ns = state.last_block_time.unix_ns() - ev_time.unix_ns()
    if (
        age_num_blocks > ev_params.max_age_num_blocks
        and age_ns > ev_params.max_age_duration_ns
    ):
        raise ErrInvalidEvidence(
            f"evidence from height {ev.height()} is too old; "
            f"min height is {height - ev_params.max_age_num_blocks}"
        )
    val_set = get_validators(ev.height())
    if val_set is None:
        raise ErrInvalidEvidence(f"no validator set at evidence height {ev.height()}")

    # sync class: evidence intake must not preempt consensus-critical
    # flushes in the global verify scheduler; its tiny batches (2 sigs
    # for an equivocation) coalesce with whatever else is in flight
    from cometbft_tpu_torch import sched

    with sched.work_class(sched.SYNC):
        if isinstance(ev, DuplicateVoteEvidence):
            verify_duplicate_vote(ev, state.chain_id, val_set)
        elif isinstance(ev, LightClientAttackEvidence):
            verify_light_client_attack(ev, state, val_set, block_store)
        else:
            raise ErrInvalidEvidence(f"unknown evidence type {type(ev).__name__}")


def verify_duplicate_vote(
    ev: DuplicateVoteEvidence, chain_id: str, val_set: ValidatorSet
) -> None:
    """verify.go:166-232."""
    a, b = ev.vote_a, ev.vote_b
    if a.height != b.height or a.round_ != b.round_ or a.type_ != b.type_:
        raise ErrInvalidEvidence(
            f"h/r/s mismatch: {a.height}/{a.round_}/{a.type_} vs {b.height}/{b.round_}/{b.type_}"
        )
    if a.block_id.key() == b.block_id.key():
        raise ErrInvalidEvidence("block IDs are the same; not an equivocation")
    if a.validator_address != b.validator_address:
        raise ErrInvalidEvidence(
            f"validator addresses differ: {a.validator_address.hex()} vs {b.validator_address.hex()}"
        )
    if a.validator_index != b.validator_index:
        raise ErrInvalidEvidence("validator indices differ")
    _, val = val_set.get_by_address(a.validator_address)
    if val is None:
        raise ErrInvalidEvidence(
            f"address {a.validator_address.hex()} was not a validator at height {a.height}"
        )
    # powers recorded in the evidence must match the historical set
    if ev.validator_power != val.voting_power:
        raise ErrInvalidEvidence(
            f"validator power mismatch: evidence {ev.validator_power}, valset {val.voting_power}"
        )
    if ev.total_voting_power != val_set.total_voting_power():
        raise ErrInvalidEvidence(
            f"total voting power mismatch: evidence {ev.total_voting_power}, "
            f"valset {val_set.total_voting_power()}"
        )
    # both signatures must verify under the culprit's key (batched: 2 sigs)
    bv = crypto_batch.create_batch_verifier(val.pub_key)
    bv.add(val.pub_key, a.sign_bytes(chain_id), a.signature)
    bv.add(val.pub_key, b.sign_bytes(chain_id), b.signature)
    ok, mask = bv.verify()
    if not ok:
        which = "A" if not mask[0] else "B"
        raise ErrInvalidEvidence(f"invalid signature on vote {which}")


def _signed_header_at(block_store, height: int):
    """verify.go:266-279 getSignedHeader."""
    from cometbft_tpu_torch.types.light import SignedHeader

    meta = block_store.load_block_meta(height)
    if meta is None:
        return None
    commit = block_store.load_block_commit(height)
    if commit is None:
        return None
    return SignedHeader(header=meta.header, commit=commit)


def verify_light_client_attack(
    ev: LightClientAttackEvidence, state: State, common_vals: ValidatorSet,
    block_store,
) -> None:
    """verify.go:101-164 VerifyLightClientAttack against full-node state:
    - lunatic (common height != conflicting height): 1/3+ of the common
      valset must have signed the conflicting commit (one skipping jump);
      equivocation/amnesia: the conflicting header must be correctly derived
    - +2/3 of the conflicting valset signed the conflicting block (device-
      batched: the whole commit is one batch through verify_commit_light)
    - the node's own header at that height must differ from the conflict
    - recorded total voting power and byzantine validators must match."""
    from cometbft_tpu_torch.light.verifier import DEFAULT_TRUST_LEVEL
    from cometbft_tpu_torch.types.validation import (
        verify_commit_light,
        verify_commit_light_trusting,
    )

    if block_store is None:
        raise ErrInvalidEvidence(
            "light-client attack evidence requires a block store for header lookups"
        )
    # the conflicting block must be internally consistent: its valset hashes
    # to ITS header's validators_hash and its commit signs ITS header
    # (types/evidence.go ValidateBasic -> ConflictingBlock.ValidateBasic);
    # without this a forged valset could satisfy every later check
    try:
        ev.conflicting_block.validate_basic(state.chain_id)
    except ValueError as e:
        raise ErrInvalidEvidence(f"invalid conflicting light block: {e}") from e
    common_header = _signed_header_at(block_store, ev.height())
    if common_header is None:
        raise ErrInvalidEvidence(f"no header at evidence height {ev.height()}")
    trusted_header = common_header
    conflicting = ev.conflicting_block
    if ev.height() != conflicting.height:
        trusted_header = _signed_header_at(block_store, conflicting.height)
        if trusted_header is None:
            # forward lunatic: conflicting height above our head — compare
            # against the latest header we do have (verify.go:70-85)
            latest = block_store.height()
            trusted_header = _signed_header_at(block_store, latest)
            if trusted_header is None:
                raise ErrInvalidEvidence(f"no header at latest height {latest}")
            if trusted_header.time.unix_ns() < conflicting.time.unix_ns():
                raise ErrInvalidEvidence(
                    "latest block time is before conflicting block time"
                )

    if common_header.height != conflicting.height:
        # lunatic: one skipping verification from the common ancestor
        try:
            verify_commit_light_trusting(
                state.chain_id, common_vals, conflicting.commit, DEFAULT_TRUST_LEVEL
            )
        except RuntimeError:  # the card or a kernel failed: not a verdict
            raise
        except Exception as e:  # noqa: BLE001
            raise ErrInvalidEvidence(
                f"skipping verification of conflicting block failed: {e}"
            ) from e
    elif ev.conflicting_header_is_invalid(trusted_header.header):
        raise ErrInvalidEvidence(
            "common height equals conflicting height, so the conflicting "
            "block must be correctly derived, yet it wasn't"
        )

    try:
        verify_commit_light(
            state.chain_id,
            conflicting.validator_set,
            conflicting.commit.block_id,
            conflicting.height,
            conflicting.commit,
        )
    except RuntimeError:  # the card or a kernel failed: not a verdict
        raise
    except Exception as e:  # noqa: BLE001
        raise ErrInvalidEvidence(f"invalid commit from conflicting block: {e}") from e

    if ev.total_voting_power != common_vals.total_voting_power():
        raise ErrInvalidEvidence(
            f"total voting power mismatch: evidence {ev.total_voting_power}, "
            f"common valset {common_vals.total_voting_power()}"
        )

    if conflicting.height > trusted_header.height:
        # forward lunatic must violate monotonic time to be an infraction
        if conflicting.time.unix_ns() > trusted_header.time.unix_ns():
            raise ErrInvalidEvidence(
                "conflicting block doesn't violate monotonically increasing time"
            )
    elif trusted_header.hash() == conflicting.hash():
        raise ErrInvalidEvidence(
            "trusted header hash matches the evidence's conflicting header hash"
        )

    # ABCI component: byzantine validators recorded = derived (verify.go:220-262)
    expected = ev.get_byzantine_validators(common_vals, trusted_header)
    got = ev.byzantine_validators
    if len(expected) != len(got):
        raise ErrInvalidEvidence(
            f"byzantine validator count mismatch: evidence {len(got)}, derived {len(expected)}"
        )
    for e_val, g_val in zip(expected, got):
        if e_val.address != g_val.address or e_val.voting_power != g_val.voting_power:
            raise ErrInvalidEvidence("byzantine validator mismatch")
