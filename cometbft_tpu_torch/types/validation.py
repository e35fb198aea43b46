"""Commit verification over the batch verifier. The port's copy of
cometbft_tpu/types/validation.py (CometBFT types/validation.go).

Every entry point turns a commit into signature rows (_commit_rows: the
shared-prefix sign bytes of Commit.vote_sign_bytes_all, factored) and
verifies them as one batch through crypto.batch: with the scheduler
enabled, an inline drain of the node-wide VerifyScheduler on the card. On
failure the batch's per-lane mask names the first bad signature.

Semantics as in the reference:
  verify_commit                 counts COMMIT flags, verifies every
                                non-absent signature, validator by index.
  verify_commit_light           counts every COMMIT signature, stops at
                                +2/3, by index.
  verify_commit_light_trusting  trust-fraction threshold, validators by
                                address (the set may differ from the
                                commit's), double votes rejected.

stage_verify_commit* do the structural checks and the voting-power tally
at once and defer the signatures: prefetch_staged verifies a window of
staged commits as one batch (one scheduler group a commit, under SYNC),
resolve_staged then raises at the first bad commit in window order.

A commit whose signers are all bls12381 keys is first decided by one
aggregate pairing-product check (_bls_aggregate_ok: ops/bls_kernel.
aggregate_verify); an accepted aggregate returns, a failed one re-runs the
rows per lane through the batch path to name the first bad signature. Such
a set with the scheme switched off (crypto/bls12381.set_enabled) raises
ErrInvalidKey. Staged all-BLS commits are aggregate-checked at finish(),
outside the window's batch.

What differs from the reference: nothing falls back off the card. Only
ErrInvalidKey and ErrInvalidSignature from BatchVerifier.add() (a key type
with no batch verifier, a signature of the wrong length) send a commit to
the serial path, as the reference intends; a CUDA or staging error
propagates.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Callable

from cometbft_tpu_torch import crypto
from cometbft_tpu_torch.crypto import batch as crypto_batch
from cometbft_tpu_torch.ops import ed25519_kernel
from cometbft_tpu_torch.ops import residency
from cometbft_tpu_torch.types.basic import BlockID, BlockIDFlag
from cometbft_tpu_torch.types.commit import Commit, CommitSig
from cometbft_tpu_torch.types.validator import ValidatorSet

BATCH_VERIFY_THRESHOLD = 2  # types/validation.go:13

# what BatchVerifier.add() raises for a row the batch cannot take: the
# commit is then verified serially, as in the reference
_ADD_ERRORS = (crypto.ErrInvalidKey, crypto.ErrInvalidSignature)


@dataclass(frozen=True)
class Fraction:
    """libs/math Fraction: the light client's trust level."""

    numerator: int
    denominator: int


class ErrNotEnoughVotingPowerSigned(Exception):
    def __init__(self, got: int, needed: int):
        super().__init__(f"invalid commit -- insufficient voting power: got {got}, "
                         f"needed more than {needed}")
        self.got = got
        self.needed = needed


class ErrInvalidCommitSignature(Exception):
    pass


def _verify_basic(vals: ValidatorSet, commit: Commit, height: int, block_id: BlockID) -> None:
    """types/validation.go verifyBasicValsAndCommit."""
    if vals is None or vals.is_nil_or_empty():
        raise ValueError("nil or empty validator set")
    if commit is None:
        raise ValueError("nil commit")
    if len(vals) != len(commit.signatures):
        raise ValueError(
            f"invalid commit -- wrong set size: {len(vals)} vs {len(commit.signatures)}")
    if height != commit.height:
        raise ValueError(f"invalid commit -- wrong height: {height} vs {commit.height}")
    if block_id != commit.block_id:
        raise ValueError(
            f"invalid commit -- wrong block ID: want {block_id}, got {commit.block_id}")


def _should_batch_verify(vals: ValidatorSet, commit: Commit) -> bool:
    return len(commit.signatures) >= BATCH_VERIFY_THRESHOLD and \
        crypto_batch.supports_batch_verifier(vals.get_proposer().pub_key
                                             if vals.get_proposer() else None)


def _commit_rows(chain_id: str, vals: ValidatorSet, commit: Commit, voting_power_needed: int,
                 ignore_sig: Callable[[CommitSig], bool], count_sig: Callable[[CommitSig], bool],
                 count_all_signatures: bool, lookup_by_index: bool
                 ) -> tuple[list, list, list[bytes], list[int]]:
    """The row builder behind every batched commit verification
    (types/validation.go:153-257's loop body): select the signatures, tally
    the power, enforce the threshold. Returns (pub keys, sign bytes, sigs,
    commit indices), the sign bytes factored (PrefixedMsg) where they share
    the commit's prefix; raises ErrNotEnoughVotingPowerSigned below the
    threshold. Announces the validator set to the key tables' epoch pins.
    Host time: part "rows" of ed25519_kernel.timed_parts."""
    with ed25519_kernel.host_part("rows"):
        seen_vals: dict[int, int] = {}
        pubs: list = []
        sigs: list[bytes] = []
        idxs: list[int] = []
        tallied = 0
        sign_rows = commit.vote_sign_bytes_all(chain_id)
        residency.announce_validator_set(vals)
        for idx, cs in enumerate(commit.signatures):
            if ignore_sig(cs):
                continue
            if lookup_by_index:
                val = vals.validators[idx]
            else:
                val_idx, val = vals.get_by_address(cs.validator_address)
                if val is None:
                    continue
                if val_idx in seen_vals:
                    raise ValueError(f"double vote from {val.address.hex()} "
                                     f"({seen_vals[val_idx]} and {idx})")
                seen_vals[val_idx] = idx
            pubs.append(val.pub_key)
            sigs.append(cs.signature)
            idxs.append(idx)
            if count_sig(cs):
                tallied += val.voting_power
            if not count_all_signatures and tallied > voting_power_needed:
                break
        if tallied <= voting_power_needed:
            raise ErrNotEnoughVotingPowerSigned(got=tallied, needed=voting_power_needed)
        return pubs, sign_rows.rows_for(idxs), sigs, idxs


def _bls_set(pubs) -> bool:
    """Are the rows' keys all bls12381 (the aggregate path's shape)? Raises
    ErrInvalidKey when they are and the scheme is switched off."""
    from cometbft_tpu_torch.crypto import bls12381

    if not pubs or any(p.type_() != bls12381.KEY_TYPE for p in pubs):
        return False
    crypto_batch.check_bls_enabled(bls12381.KEY_TYPE)
    return True


def _bls_aggregate_ok(pubs, msgs, sigs) -> bool | None:
    """The aggregate commit check (ops/bls_kernel.aggregate_verify) when every
    signer is a bls12381 key: None when the rows are not all BLS (the caller
    batches them per lane), True on an accepted aggregate, False when it
    fails (the caller then re-runs the rows per lane to name the offending
    signature: the aggregate is a verdict on the commit, not a mask)."""
    if not _bls_set(pubs):
        return None
    from cometbft_tpu_torch.ops import bls_kernel

    with ed25519_kernel.host_part("aggregate"):
        return bls_kernel.aggregate_verify([p.bytes_() for p in pubs], msgs,
                                           [bytes(s) for s in sigs])


def _bls_aggregate_agg_ok(pubs, msgs, agg_sig: bytes) -> bool | None:
    """The certificate sibling of _bls_aggregate_ok: the signature arrives
    already aggregated (ops/bls_kernel.aggregate_verify_agg). The same
    contract: None when the rows are not all BLS, else the verdict."""
    if not _bls_set(pubs):
        return None
    from cometbft_tpu_torch.ops import bls_kernel

    return bls_kernel.aggregate_verify_agg([p.bytes_() for p in pubs], msgs, bytes(agg_sig))


def _raise_first_bad(commit: Commit, idxs: list[int], mask) -> None:
    for i, sig_ok in enumerate(mask):
        if not sig_ok:
            idx = idxs[i]
            raise ErrInvalidCommitSignature(
                f"wrong signature (#{idx}): {commit.signatures[idx].signature.hex()}")


def _verify_commit_batch(chain_id: str, vals: ValidatorSet, commit: Commit,
                         voting_power_needed: int, ignore_sig: Callable[[CommitSig], bool],
                         count_sig: Callable[[CommitSig], bool], count_all_signatures: bool,
                         lookup_by_index: bool) -> None:
    """types/validation.go:153-257."""
    pubs, msgs, sigs, idxs = _commit_rows(chain_id, vals, commit, voting_power_needed,
                                          ignore_sig, count_sig, count_all_signatures,
                                          lookup_by_index)
    # all-BLS signers: one pairing-product check; a failed aggregate falls
    # through to the per-lane path to name the bad signature
    if _bls_aggregate_ok(pubs, msgs, sigs):
        return
    # every key type becomes one device batch of the same flush (a mixed
    # ed25519 + sr25519 + bls12381 commit: three batches, one fetch)
    bv = crypto_batch.create_mixed_batch_verifier()
    try:
        for pub, msg, sig in zip(pubs, msgs, sigs):
            bv.add(pub, msg, sig)
    except _ADD_ERRORS as e:
        logging.getLogger(__name__).info("commit verification falling back to serial: %s", e)
        return _verify_commit_single(chain_id, vals, commit, voting_power_needed, ignore_sig,
                                     count_sig, count_all_signatures, lookup_by_index)
    ok, valid_sigs = bv.verify()
    if ok:
        return
    _raise_first_bad(commit, idxs, valid_sigs)
    raise RuntimeError("BUG: batch verification failed with no invalid signatures")


def _verify_commit_single(chain_id: str, vals: ValidatorSet, commit: Commit,
                          voting_power_needed: int, ignore_sig: Callable[[CommitSig], bool],
                          count_sig: Callable[[CommitSig], bool], count_all_signatures: bool,
                          lookup_by_index: bool) -> None:
    """types/validation.go:266-330: one signature at a time on the host
    oracle (a commit of one signature, or keys with no batch verifier)."""
    seen_vals: dict[int, int] = {}
    tallied = 0
    for idx, cs in enumerate(commit.signatures):
        if ignore_sig(cs):
            continue
        if lookup_by_index:
            val = vals.validators[idx]
        else:
            val_idx, val = vals.get_by_address(cs.validator_address)
            if val is None:
                continue
            if val_idx in seen_vals:
                raise ValueError(
                    f"double vote from {val.address.hex()} ({seen_vals[val_idx]} and {idx})")
            seen_vals[val_idx] = idx
        sign_bytes = commit.vote_sign_bytes(chain_id, idx)
        if not val.pub_key.verify_signature(sign_bytes, cs.signature):
            raise ErrInvalidCommitSignature(f"wrong signature (#{idx}): {cs.signature.hex()}")
        if count_sig(cs):
            tallied += val.voting_power
        if not count_all_signatures and tallied > voting_power_needed:
            return
    if tallied <= voting_power_needed:
        raise ErrNotEnoughVotingPowerSigned(got=tallied, needed=voting_power_needed)


def _ignore_absent(c: CommitSig) -> bool:
    return c.block_id_flag == BlockIDFlag.ABSENT


def _ignore_not_commit(c: CommitSig) -> bool:
    return c.block_id_flag != BlockIDFlag.COMMIT


def _count_commit(c: CommitSig) -> bool:
    return c.block_id_flag == BlockIDFlag.COMMIT


def _count_all(c: CommitSig) -> bool:
    return True


def _verify(chain_id, vals, commit, needed, ignore, count, count_all, by_index) -> None:
    if _should_batch_verify(vals, commit):
        _verify_commit_batch(chain_id, vals, commit, needed, ignore, count, count_all, by_index)
    else:
        _verify_commit_single(chain_id, vals, commit, needed, ignore, count, count_all, by_index)


def _trusting_needed(vals: ValidatorSet, commit: Commit, trust_level: Fraction) -> int:
    if vals is None:
        raise ValueError("nil validator set")
    if trust_level.denominator == 0:
        raise ValueError("trustLevel has zero Denominator")
    if commit is None:
        raise ValueError("nil commit")
    return vals.total_voting_power() * trust_level.numerator // trust_level.denominator


def verify_commit(chain_id: str, vals: ValidatorSet, block_id: BlockID, height: int,
                  commit: Commit) -> None:
    """+2/3 signed; checks ALL signatures (types/validation.go:26-57)."""
    _verify_basic(vals, commit, height, block_id)
    _verify(chain_id, vals, commit, vals.total_voting_power() * 2 // 3, _ignore_absent,
            _count_commit, True, True)


def verify_commit_light(chain_id: str, vals: ValidatorSet, block_id: BlockID, height: int,
                        commit: Commit) -> None:
    """+2/3 signed; stops early (types/validation.go:60-92)."""
    _verify_basic(vals, commit, height, block_id)
    _verify(chain_id, vals, commit, vals.total_voting_power() * 2 // 3, _ignore_not_commit,
            _count_all, False, True)


def verify_commit_light_trusting(chain_id: str, vals: ValidatorSet, commit: Commit,
                                 trust_level: Fraction) -> None:
    """trust_level of the (possibly different) set signed
    (types/validation.go:95-131)."""
    needed = _trusting_needed(vals, commit, trust_level)
    _verify(chain_id, vals, commit, needed, _ignore_not_commit, _count_all, False, False)


# ---------------------------------------------------------------------------
# Staged commit verification: the blocksync and light-client windows. A
# window's commits are staged (structural checks and tally at once), then
# verified as one batch (prefetch_staged), then finished in window order.
# ---------------------------------------------------------------------------


class StagedCommitVerification:
    """A staged, unverified verify_commit*: finish() raises exactly what the
    synchronous call would. The rows are not dispatched at staging:
    prefetch_staged verifies every staged commit of a window in one batch.
    An all-ed25519 commit keeps its rows as key bytes (ed_rows), any other
    as keys (rows). An all-BLS commit (bls=True) is not part of the window's
    batch: finish() decides it with one aggregate check, and only a failed
    aggregate verifies its rows per lane."""

    def __init__(self, commit: Commit, sig_idxs: list[int], rows=None, ed_rows=None,
                 bls: bool = False):
        self.commit = commit
        self.sig_idxs = sig_idxs
        self._rows = rows  # (pub keys, msgs, sigs)
        self._ed_rows = ed_rows  # (pub key bytes, msgs, sigs), all ed25519
        self._bls = bls
        self._mask = None
        self._passed = False

    def finish(self, mask=None) -> None:
        """Take the window's mask (or verify this commit alone) and raise at
        the first invalid signature. Idempotent once passed."""
        if self._passed:
            return
        if mask is None:
            mask = self._mask
        if mask is None and self._bls:
            if _bls_aggregate_ok(*self._rows):
                self._passed = True
                return
        if mask is None:
            if self._ed_rows is not None:
                mask = ed25519_kernel.verify_batch_async(
                    ed25519_kernel.ED25519, *self._ed_rows,
                    device=crypto_batch.backend_device())()
            else:
                pubs, msgs, sigs = self._rows
                bv = crypto_batch.create_mixed_batch_verifier()
                try:
                    for p, m, s in zip(pubs, msgs, sigs):
                        bv.add(p, m, s)
                except _ADD_ERRORS:
                    from cometbft_tpu_torch.libs.prefixrows import as_bytes

                    mask = [p.verify_signature(as_bytes(m), s) for p, m, s in zip(pubs, msgs, sigs)]
                else:
                    _, mask = bv.verify()
        _raise_first_bad(self.commit, self.sig_idxs, mask)
        self._passed = True


def _stage_rows(commit: Commit, rows) -> StagedCommitVerification:
    pubs, msgs, sigs, idxs = rows
    if _bls_set(pubs):
        return StagedCommitVerification(commit, idxs, rows=(pubs, msgs, sigs), bls=True)
    if all(p.type_() == "ed25519" for p in pubs):
        return StagedCommitVerification(commit, idxs,
                                        ed_rows=([p.bytes_() for p in pubs], msgs, sigs))
    return StagedCommitVerification(commit, idxs, rows=(pubs, msgs, sigs))


def stage_verify_commit(chain_id: str, vals: ValidatorSet, block_id: BlockID, height: int,
                        commit: Commit) -> StagedCommitVerification:
    """verify_commit (every non-absent signature checked, COMMIT flags
    tallied) staged: structural checks and the threshold now, the
    signatures at finish()."""
    _verify_basic(vals, commit, height, block_id)
    rows = _commit_rows(chain_id, vals, commit, vals.total_voting_power() * 2 // 3,
                        _ignore_absent, _count_commit, True, True)
    return _stage_rows(commit, rows)


def stage_verify_commit_light(chain_id: str, vals: ValidatorSet, block_id: BlockID,
                              height: int, commit: Commit) -> StagedCommitVerification:
    """verify_commit_light staged."""
    _verify_basic(vals, commit, height, block_id)
    rows = _commit_rows(chain_id, vals, commit, vals.total_voting_power() * 2 // 3,
                        _ignore_not_commit, _count_all, False, True)
    return _stage_rows(commit, rows)


def stage_verify_commit_light_trusting(chain_id: str, vals: ValidatorSet, commit: Commit,
                                       trust_level: Fraction) -> StagedCommitVerification:
    """verify_commit_light_trusting staged: the threshold now, the
    signatures at finish()."""
    needed = _trusting_needed(vals, commit, trust_level)
    rows = _commit_rows(chain_id, vals, commit, needed, _ignore_not_commit, _count_all,
                        False, False)
    return _stage_rows(commit, rows)


def prefetch_staged(staged: list[StagedCommitVerification], klass: str | None = None) -> None:
    """Verify every unresolved staged commit of a window in one batch and
    keep each commit's slice of the mask; finish() is then host work only.
    With the scheduler enabled (the default) the window is one verify_many
    drain, one group a commit (each its own recheck budget), under `klass`
    (default SYNC), with queued riders. Without it the all-ed25519 commits
    form one batch (chunked below the largest bucket, commit bounds as
    recheck groups), resolved with one fetch; other commits verify at
    finish()."""
    from cometbft_tpu_torch import sched

    if sched.enabled():
        _prefetch_via_scheduler(staged, klass or sched.SYNC)
        return
    EK = ed25519_kernel
    rows = [s for s in staged if s._ed_rows is not None and s._mask is None and not s._passed]
    chunk_cap = 1 << (EK.MAX_BUCKET_LOG2 - 1)
    chunks: list[list[StagedCommitVerification]] = []
    cur: list[StagedCommitVerification] = []
    cur_n = 0
    for s in rows:
        n = len(s._ed_rows[2])
        if cur and cur_n + n > chunk_cap:
            chunks.append(cur)
            cur, cur_n = [], 0
        cur.append(s)
        cur_n += n
    if cur:
        chunks.append(cur)
    device = crypto_batch.backend_device()
    thunks = []
    for chunk in chunks:
        pubs: list[bytes] = []
        msgs: list = []
        sigs: list[bytes] = []
        groups: list[tuple[int, int]] = []
        for s in chunk:
            p, m, g = s._ed_rows
            groups.append((len(sigs), len(sigs) + len(g)))
            pubs.extend(p)
            msgs.extend(m)
            sigs.extend(g)
        thunks.append(EK.verify_batch_async(EK.ED25519, pubs, msgs, sigs, device=device,
                                            recheck_groups=groups))
    if not thunks:
        return
    resolved = EK.resolve_batches(thunks)
    for chunk, combined in zip(chunks, resolved):
        off = 0
        for s in chunk:
            n = len(s._ed_rows[2])
            s._mask = combined[off:off + n]
            off += n


def _prefetch_via_scheduler(staged: list[StagedCommitVerification], klass: str) -> None:
    """The scheduler's window: every unresolved staged commit one group of
    one verify_many drain (an all-ed25519 commit's key bytes go in as they
    are)."""
    from cometbft_tpu_torch import sched
    from cometbft_tpu_torch.crypto import ed25519

    todo: list[StagedCommitVerification] = []
    rowlists: list = []
    for s in staged:
        if s._passed or s._mask is not None or s._bls:
            continue
        if s._ed_rows is not None:
            rows = sched.RowColumns.single(ed25519.KEY_TYPE, *s._ed_rows)
        else:
            rows = list(zip(*s._rows))
        todo.append(s)
        rowlists.append(rows)
    if rowlists:
        for s, mask in zip(todo, sched.get().verify_many(rowlists, klass)):
            s._mask = mask


def resolve_staged(staged: list[StagedCommitVerification]) -> None:
    """Finish a window of staged verifications with one batch. Raises at
    the first bad commit, in window order."""
    prefetch_staged(staged)
    for s in staged:
        s.finish()
