"""CommitCertificate: a succinct, durable finality artifact.

For an all-BLS validator set a committed height is fully decided by
~200 bytes: one aggregated G2 signature over the signers' canonical
precommit sign-bytes, a bitmap naming WHICH validators signed, and the
(chain_id, height, round, block_id, valset_hash) tuple pinning what
they signed about. Verification is a >2/3-voting-power tally over the
bitmap plus ONE pairing-product check — the same check
`_bls_aggregate_ok` runs per commit, minus the per-vote signature sum
(the certificate carries the sum pre-computed).

Sign-bytes subtlety: CometBFT precommits embed each validator's own
timestamp, so the messages under the aggregate differ per signer. The
certificate therefore carries a base timestamp plus one uvarint
nanosecond delta per set bit (index order); reconstruction reuses
Commit.vote_sign_bytes_all so the rows are byte-identical to what the
per-vote path verifies.

The fallback invariant every consumer relies on: a certificate can
only ever ACCEPT. Absent, mismatched, corrupt, or failing certificates
all fall through to the unchanged per-vote path, so verdicts (and
raised errors) are bit-identical with or without the plane — a forged
certificate can never cause acceptance, only a counted fallback.

The port's copy of cometbft_tpu/cert/certificate.py.
"""

from __future__ import annotations

from dataclasses import dataclass

from cometbft_tpu_torch.libs.bits import BitArray
from cometbft_tpu_torch.types.basic import BlockID, BlockIDFlag
from cometbft_tpu_torch.types.commit import Commit, CommitSig
from cometbft_tpu_torch.utils import cmttime
from cometbft_tpu_torch.utils import protobuf as pb

# compressed G2 point
AGG_SIG_SIZE = 96

# decode() guards: a certificate names one committee, not a DoS vector
MAX_CHAIN_ID_LEN = 64
MAX_VALIDATORS = 1 << 20


class ErrCertInvalid(Exception):
    """The certificate failed verification against a validator set.

    Consumers treat this exactly like a missing certificate: count it
    and run the classic per-vote path. Never a ban, never a verdict."""


@dataclass
class CommitCertificate:
    chain_id: str
    height: int
    round_: int
    block_id: BlockID
    valset_hash: bytes
    n_vals: int
    signers: BitArray
    ts_base: cmttime.Timestamp
    ts_deltas: list[int]  # ns offsets from ts_base, one per set bit, index order
    agg_sig: bytes

    def signer_indices(self) -> list[int]:
        return self.signers.get_true_indices()

    def signer_timestamps(self) -> list[cmttime.Timestamp]:
        """Per-signer timestamps (same order as signer_indices)."""
        base_ns = self.ts_base.unix_ns()
        out = []
        for d in self.ts_deltas:
            ns = base_ns + d
            out.append(cmttime.Timestamp(ns // 1_000_000_000, ns % 1_000_000_000))
        return out

    def to_commit(self) -> Commit:
        """A synthetic Commit carrying exactly the certified votes:
        COMMIT rows (with reconstructed timestamps) for set bits, ABSENT
        elsewhere. Canonical vote sign-bytes do not include the
        validator address, so none is needed — vote_sign_bytes_all on
        this commit yields rows byte-identical to the original."""
        sigs = [CommitSig.absent() for _ in range(self.n_vals)]
        for i, ts in zip(self.signer_indices(), self.signer_timestamps()):
            sigs[i] = CommitSig(block_id_flag=BlockIDFlag.COMMIT, timestamp=ts)
        return Commit(height=self.height, round_=self.round_,
                      block_id=self.block_id, signatures=sigs)

    def encode(self) -> bytes:
        w = pb.Writer()
        w.string(1, self.chain_id)
        w.varint_i64(2, self.height)
        w.varint_i64(3, self.round_)
        w.message(4, self.block_id.to_proto(), always=True)
        w.bytes(5, self.valset_hash)
        w.uvarint(6, self.n_vals)
        w.bytes(7, self.signers.to_bytes())
        w.message(8, pb.timestamp_bytes(self.ts_base.seconds, self.ts_base.nanos),
                  always=True)
        w.bytes(9, b"".join(pb.encode_uvarint(d) for d in self.ts_deltas))
        w.bytes(10, self.agg_sig)
        return w.output()

    @classmethod
    def decode(cls, data: bytes) -> "CommitCertificate":
        """Raises ValueError on any malformed input (store quarantine
        and wire handlers catch it)."""
        r = pb.Reader(data)
        chain_id = ""
        height = 0
        round_ = 0
        block_id = BlockID()
        valset_hash = b""
        n_vals = 0
        bitmap_raw = b""
        ts_base = cmttime.Timestamp.zero()
        deltas_raw = b""
        agg_sig = b""
        while not r.at_end():
            f, w = r.read_tag()
            if f == 1:
                chain_id = r.read_bytes().decode("utf-8")
            elif f == 2:
                height = r.read_varint_i64()
            elif f == 3:
                round_ = r.read_varint_i64()
            elif f == 4:
                block_id = BlockID.from_proto(r.read_bytes())
            elif f == 5:
                valset_hash = r.read_bytes()
            elif f == 6:
                n_vals = r.read_uvarint()
            elif f == 7:
                bitmap_raw = r.read_bytes()
            elif f == 8:
                secs, nanos = r.read_timestamp()
                ts_base = cmttime.Timestamp(secs, nanos)
            elif f == 9:
                deltas_raw = r.read_bytes()
            elif f == 10:
                agg_sig = r.read_bytes()
            else:
                r.skip(w)
        if len(chain_id) > MAX_CHAIN_ID_LEN:
            raise ValueError("certificate chain_id too long")
        if not (0 < n_vals <= MAX_VALIDATORS):
            raise ValueError(f"certificate n_vals out of range: {n_vals}")
        if len(bitmap_raw) != (n_vals + 7) // 8:
            raise ValueError("certificate bitmap length mismatch")
        if height <= 0:
            raise ValueError(f"certificate height out of range: {height}")
        if round_ < 0:
            raise ValueError(f"negative certificate round: {round_}")
        if len(agg_sig) != AGG_SIG_SIZE:
            raise ValueError("certificate aggregate signature must be "
                             f"{AGG_SIG_SIZE} bytes, got {len(agg_sig)}")
        signers = BitArray.from_bytes(n_vals, bitmap_raw)
        deltas: list[int] = []
        pos = 0
        while pos < len(deltas_raw):
            d, pos = pb.decode_uvarint(deltas_raw, pos)
            deltas.append(d)
        if len(deltas) != signers.num_true():
            raise ValueError("certificate timestamp deltas do not match "
                             "signer count")
        return cls(chain_id=chain_id, height=height, round_=round_,
                   block_id=block_id, valset_hash=valset_hash, n_vals=n_vals,
                   signers=signers, ts_base=ts_base, ts_deltas=deltas,
                   agg_sig=agg_sig)

    def summary(self) -> dict:
        """JSON-safe view for RPC / debugging (no signature material)."""
        return {
            "chain_id": self.chain_id,
            "height": self.height,
            "round": self.round_,
            "block_hash": self.block_id.hash.hex(),
            "valset_hash": self.valset_hash.hex(),
            "n_vals": self.n_vals,
            "n_signers": self.signers.num_true(),
            "size_bytes": len(self.encode()),
        }


def build_certificate(chain_id: str, vals, commit: Commit):
    """Condense a verified commit into a certificate, or return None
    when this (set, commit) pair is not certifiable: mixed/ed25519
    validator sets, empty or sub-threshold commits, or undecodable
    signature points. None is the ONLY negative outcome — production is
    best-effort and consumers always have the per-vote path.

    Raises ErrInvalidKey when the set is all-BLS but the BLS backend is
    disabled: that is a misconfiguration, and the loud-failure rule from
    the verify path (`_bls_aggregate_ok`) applies to production too.
    """
    if commit is None or vals is None:
        return None
    n = len(vals.validators)
    if n == 0 or len(commit.signatures) != n:
        return None
    if any(v.pub_key.type_() != "bls12381" for v in vals.validators):
        return None
    from cometbft_tpu_torch.crypto import batch as crypto_batch
    from cometbft_tpu_torch.crypto import bls12381
    if not bls12381.enabled():
        raise crypto_batch.crypto.ErrInvalidKey(
            "bls12381 validator set but crypto.bls_enabled is off")
    idxs = [i for i, cs in enumerate(commit.signatures)
            if cs.block_id_flag == BlockIDFlag.COMMIT]
    if not idxs:
        return None
    tallied = sum(vals.validators[i].voting_power for i in idxs)
    if tallied <= vals.total_voting_power() * 2 // 3:
        return None
    from cometbft_tpu_torch.ops import bls_kernel
    try:
        agg = bls_kernel.aggregate_signatures(
            [bytes(commit.signatures[i].signature) for i in idxs])
    except ValueError:
        return None
    ts_ns = [commit.signatures[i].timestamp.unix_ns() for i in idxs]
    base_ns = min(ts_ns)
    signers = BitArray(n)
    for i in idxs:
        signers.set_index(i, True)
    return CommitCertificate(
        chain_id=chain_id,
        height=commit.height,
        round_=commit.round_,
        block_id=commit.block_id,
        valset_hash=vals.hash(),
        n_vals=n,
        signers=signers,
        ts_base=cmttime.Timestamp(base_ns // 1_000_000_000,
                                  base_ns % 1_000_000_000),
        ts_deltas=[t - base_ns for t in ts_ns],
        agg_sig=agg,
    )


def verify_certificate(cert: CommitCertificate, chain_id: str, vals) -> None:
    """Full certificate verification against a validator set: structural
    checks, >2/3 voting-power tally over the bitmap, and ONE
    pairing-product check through the scheduler/mesh path. Raises
    ErrCertInvalid on any failure; returns None on success.

    Raises ErrInvalidKey (not ErrCertInvalid) when the set is all-BLS
    but the backend is disabled — misconfiguration must stay loud, the
    same rule the per-vote aggregate path enforces.
    """
    if cert.chain_id != chain_id:
        raise ErrCertInvalid(
            f"certificate chain {cert.chain_id!r} != {chain_id!r}")
    if vals is None or not vals.validators:
        raise ErrCertInvalid("empty validator set")
    if cert.n_vals != len(vals.validators):
        raise ErrCertInvalid(
            f"certificate covers {cert.n_vals} validators, set has "
            f"{len(vals.validators)}")
    if cert.valset_hash != vals.hash():
        raise ErrCertInvalid("certificate valset_hash does not match set")
    if cert.block_id.is_nil():
        raise ErrCertInvalid("certificate for nil block")
    if len(cert.agg_sig) != AGG_SIG_SIZE:
        raise ErrCertInvalid("bad aggregate signature size")
    idxs = cert.signer_indices()
    if not idxs or len(cert.ts_deltas) != len(idxs):
        raise ErrCertInvalid("certificate signer bitmap/timestamps malformed")
    tallied = sum(vals.validators[i].voting_power for i in idxs)
    needed = vals.total_voting_power() * 2 // 3
    if tallied <= needed:
        raise ErrCertInvalid(
            f"insufficient certified voting power: {tallied} <= needed "
            f"{needed}")
    pubs = [vals.validators[i].pub_key for i in idxs]
    rows = cert.to_commit().vote_sign_bytes_all(chain_id)
    msgs = rows.rows_for(idxs)
    from cometbft_tpu_torch.types import validation
    ok = validation._bls_aggregate_agg_ok(pubs, msgs, cert.agg_sig)
    if ok is None:
        # mixed/non-BLS sets never get a certificate; one claiming to
        # cover such a set is forged or misdirected
        raise ErrCertInvalid("validator set is not all-BLS")
    if not ok:
        raise ErrCertInvalid("aggregate pairing check failed")


def matches_commit(cert: CommitCertificate, commit: Commit) -> bool:
    """Does this certificate attest EXACTLY the given commit? Same
    height/round/block_id, bitmap == the commit's COMMIT-flag signer
    set, and identical per-signer timestamps. Consumers that hold both
    artifacts (light clients verifying a header whose hash covers the
    commit) require a match before letting the certificate stand in for
    per-vote verification — that is what keeps verdicts bit-identical."""
    if commit is None:
        return False
    if (cert.height != commit.height or cert.round_ != commit.round_
            or cert.block_id != commit.block_id
            or cert.n_vals != len(commit.signatures)):
        return False
    commit_idxs = [i for i, cs in enumerate(commit.signatures)
                   if cs.block_id_flag == BlockIDFlag.COMMIT]
    if commit_idxs != cert.signer_indices():
        return False
    cert_ts = cert.signer_timestamps()
    for i, ts in zip(commit_idxs, cert_ts):
        if commit.signatures[i].timestamp.unix_ns() != ts.unix_ns():
            return False
    return True


def attests_commit(cert: CommitCertificate, commit: Commit) -> bool:
    """matches_commit PLUS signature-sum equality: the commit's own
    signature bytes must aggregate to cert.agg_sig. A consumer holding
    BOTH artifacts needs this before the certificate may stand in for
    per-vote verification — without it, a commit carrying a mauled
    signature next to an honestly-aggregated certificate would verify
    via the certificate while the per-vote path rejects it. With the
    sum pinned, cert-accept is equivalent to today's aggregate-first
    BLS path (`_bls_aggregate_ok`) on this exact commit: same sum, same
    messages, same one-pairing verdict. Point adds only — the pairing
    stays in verify_certificate."""
    if not matches_commit(cert, commit):
        return False
    from cometbft_tpu_torch.ops import bls_kernel
    try:
        agg = bls_kernel.aggregate_signatures(
            [bytes(commit.signatures[i].signature)
             for i in cert.signer_indices()])
    except ValueError:
        return False
    return agg == cert.agg_sig
