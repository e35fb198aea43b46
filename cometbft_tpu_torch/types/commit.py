"""Commit and CommitSig (reference: types/block.go:574-900).

A Commit is the +2/3 precommit aggregate persisted in every block's
LastCommit; each CommitSig records one validator's precommit (or absence).
Commit.vote_sign_bytes reconstructs the exact canonical bytes each validator
signed — the input rows of the device verification batch.

The port's copy of cometbft_tpu/types/commit.py. ExtendedCommit and
ExtendedCommitSig (vote extensions) are not ported yet: nothing in the port
builds or stores them before the node wiring.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from cometbft_tpu_torch import crypto
from cometbft_tpu_torch.crypto import merkle
from cometbft_tpu_torch.types.basic import BlockID, BlockIDFlag, SignedMsgType
from cometbft_tpu_torch.types.vote import Vote
from cometbft_tpu_torch.utils import cmttime
from cometbft_tpu_torch.utils import protobuf as pb

MAX_COMMIT_OVERHEAD_BYTES = 94
MAX_COMMIT_SIG_BYTES = 109


@dataclass
class CommitSig:
    """types/block.go:586-600."""

    block_id_flag: BlockIDFlag
    validator_address: bytes = b""
    timestamp: cmttime.Timestamp = field(default_factory=cmttime.Timestamp.zero)
    signature: bytes = b""

    @classmethod
    def absent(cls) -> "CommitSig":
        return cls(block_id_flag=BlockIDFlag.ABSENT)

    def for_block(self) -> bool:
        return self.block_id_flag == BlockIDFlag.COMMIT

    def block_id(self, commit_block_id: BlockID) -> BlockID:
        """types/block.go:632-645."""
        if self.block_id_flag == BlockIDFlag.COMMIT:
            return commit_block_id
        return BlockID()

    def validate_basic(self) -> None:
        if self.block_id_flag not in (BlockIDFlag.ABSENT, BlockIDFlag.COMMIT, BlockIDFlag.NIL):
            raise ValueError(f"unknown BlockIDFlag: {self.block_id_flag}")
        if self.block_id_flag == BlockIDFlag.ABSENT:
            if self.validator_address:
                raise ValueError("validator address is present for absent CommitSig")
            if not self.timestamp.is_zero():
                raise ValueError("time is present for absent CommitSig")
            if self.signature:
                raise ValueError("signature is present for absent CommitSig")
        else:
            if len(self.validator_address) != crypto.ADDRESS_SIZE:
                raise ValueError("expected ValidatorAddress size to be 20 bytes")
            if not self.signature:
                raise ValueError("signature is missing")
            if len(self.signature) > crypto.MAX_SIGNATURE_SIZE:
                raise ValueError("signature is too big")

    def to_proto(self) -> bytes:
        w = pb.Writer()
        w.uvarint(1, int(self.block_id_flag))
        w.bytes(2, self.validator_address)
        w.message(3, pb.timestamp_bytes(self.timestamp.seconds, self.timestamp.nanos), always=True)
        w.bytes(4, self.signature)
        return w.output()

    @classmethod
    def from_proto(cls, data: bytes) -> "CommitSig":
        r = pb.Reader(data)
        cs = cls(block_id_flag=BlockIDFlag.ABSENT)
        while not r.at_end():
            f, w = r.read_tag()
            if f == 1:
                cs.block_id_flag = BlockIDFlag(r.read_uvarint())
            elif f == 2:
                cs.validator_address = r.read_bytes()
            elif f == 3:
                secs, nanos = r.read_timestamp()
                cs.timestamp = cmttime.Timestamp(secs, nanos)
            elif f == 4:
                cs.signature = r.read_bytes()
            else:
                r.skip(w)
        return cs


@dataclass
class Commit:
    """types/block.go:700-760."""

    height: int
    round_: int
    block_id: BlockID
    signatures: list[CommitSig]
    _hash: bytes | None = field(default=None, repr=False, compare=False)
    # chain_id -> rows; a dict (not a single-slot tuple) so alternating-
    # chain callers (light-client cross-chain paths, tests) don't silently
    # degrade to zero cache hits (ADVICE round-5). Bounded: a Commit is
    # only ever verified against a handful of chain ids.
    _sign_rows: dict | None = field(default=None, repr=False, compare=False)

    _MAX_SIGN_ROW_CHAINS = 4

    def size(self) -> int:
        return len(self.signatures)

    def get_vote(self, val_idx: int) -> Vote:
        """Reconstruct the precommit Vote for signature val_idx
        (types/block.go:857-869)."""
        cs = self.signatures[val_idx]
        return Vote(
            type_=SignedMsgType.PRECOMMIT,
            height=self.height,
            round_=self.round_,
            block_id=cs.block_id(self.block_id),
            timestamp=cs.timestamp,
            validator_address=cs.validator_address,
            validator_index=val_idx,
            signature=cs.signature,
        )

    def vote_sign_bytes(self, chain_id: str, val_idx: int) -> bytes:
        """types/block.go:880-883 — the batch-verification row builder."""
        return self.get_vote(val_idx).sign_bytes(chain_id)

    def vote_sign_bytes_all(self, chain_id: str):
        """All signatures' canonical sign-bytes in one pass, as a
        SharedPrefixRows container (libs/prefixrows.py) — indexing is
        byte-identical to vote_sign_bytes(chain_id, i) per index
        (asserted by tests). The CanonicalVote rows of one commit differ
        only in the timestamp field and the NIL-vote block_id omission,
        so the length varint + type/height/round/block_id head is built
        ONCE and kept FACTORED: COMMIT rows whose timestamp encodes to
        the commit's modal length store only their ~17-byte suffix
        (timestamp + chain tail); NIL votes and odd-length timestamps
        materialize as exception rows. The factored form flows through
        validation into kernel staging, where the whole run reassembles
        on the batch axis with one prefix broadcast instead of N row
        copies (the reduced-send protocol's host half) — per-row Writer
        construction was the dominant host cost of blocksync staging,
        and the prefix copies were most of what remained."""
        from collections import Counter

        from cometbft_tpu_torch.libs.prefixrows import SharedPrefixRows
        from cometbft_tpu_torch.types import canonical
        from cometbft_tpu_torch.utils.protobuf import encode_uvarint

        if self._sign_rows is None:
            self._sign_rows = {}
        cached = self._sign_rows.get(chain_id)
        if cached is not None:
            return cached
        w = pb.Writer()
        w.uvarint(1, int(SignedMsgType.PRECOMMIT))
        w.sfixed64(2, self.height)
        w.sfixed64(3, self.round_)
        head_nil = w.output()  # NIL votes: block_id field omitted
        w.message(4, canonical.canonical_block_id_bytes(self.block_id))
        head_commit = w.output()
        tail = pb.Writer().string(6, chain_id).output()
        ts_tag = bytes([5 << 3 | 2])  # field 5, wire 2 (timestamp message)
        ts_all = [pb.timestamp_bytes(cs.timestamp.seconds,
                                     cs.timestamp.nanos)
                  for cs in self.signatures]
        # the shared prefix covers COMMIT rows at the commit's modal
        # timestamp-encoding length (the length varint in front of the
        # body pins the total row length, so an off-length timestamp
        # cannot share it)
        commit_lens = Counter(
            len(ts) for ts, cs in zip(ts_all, self.signatures)
            if cs.block_id_flag == BlockIDFlag.COMMIT)
        modal_ts_len = commit_lens.most_common(1)[0][0] if commit_lens else 0
        modal_body = (len(head_commit) + len(ts_tag)
                      + len(encode_uvarint(modal_ts_len)) + modal_ts_len
                      + len(tail))
        prefix = encode_uvarint(modal_body) + head_commit
        suffixes: list = []
        exceptions: dict[int, bytes] = {}
        for i, (ts, cs) in enumerate(zip(ts_all, self.signatures)):
            if (cs.block_id_flag == BlockIDFlag.COMMIT
                    and len(ts) == modal_ts_len):
                suffixes.append(ts_tag + encode_uvarint(len(ts)) + ts + tail)
                continue
            head = (head_commit if cs.block_id_flag == BlockIDFlag.COMMIT
                    else head_nil)
            body = head + ts_tag + encode_uvarint(len(ts)) + ts + tail
            suffixes.append(None)
            exceptions[i] = encode_uvarint(len(body)) + body
        rows = SharedPrefixRows(prefix, suffixes, exceptions)
        if len(self._sign_rows) >= self._MAX_SIGN_ROW_CHAINS:
            self._sign_rows.pop(next(iter(self._sign_rows)))
        self._sign_rows[chain_id] = rows
        return rows

    def hash(self) -> bytes:
        """Merkle root over CommitSig protos (types/block.go Commit.Hash)."""
        if self._hash is None:
            self._hash = merkle.hash_from_byte_slices(
                [cs.to_proto() for cs in self.signatures]
            )
        return self._hash

    def validate_basic(self) -> None:
        if self.height < 0:
            raise ValueError("negative Height")
        if self.round_ < 0:
            raise ValueError("negative Round")
        if self.height >= 1:
            if self.block_id.is_nil():
                raise ValueError("commit cannot be for nil block")
            if not self.signatures:
                raise ValueError("no signatures in commit")
            for cs in self.signatures:
                cs.validate_basic()

    def to_proto(self) -> bytes:
        w = pb.Writer()
        w.varint_i64(1, self.height)
        w.varint_i64(2, self.round_)
        w.message(3, self.block_id.to_proto(), always=True)
        for cs in self.signatures:
            w.message(4, cs.to_proto(), always=True)
        return w.output()

    @classmethod
    def from_proto(cls, data: bytes) -> "Commit":
        r = pb.Reader(data)
        c = cls(height=0, round_=0, block_id=BlockID(), signatures=[])
        while not r.at_end():
            f, w = r.read_tag()
            if f == 1:
                c.height = r.read_varint_i64()
            elif f == 2:
                c.round_ = r.read_varint_i64()
            elif f == 3:
                c.block_id = BlockID.from_proto(r.read_bytes())
            elif f == 4:
                c.signatures.append(CommitSig.from_proto(r.read_bytes()))
            else:
                r.skip(w)
        return c
