"""Vote — the unit of consensus signaling (reference: types/vote.go).

Sign-bytes are the canonical encoding (canonical.py); wire encoding is the
tendermint.types.Vote proto (types.proto:83-103) used by the WAL, p2p
envelopes, and the privval protocol.

The port's copy of cometbft_tpu/types/vote.py.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from cometbft_tpu_torch import crypto
from cometbft_tpu_torch.types import canonical
from cometbft_tpu_torch.types.basic import BlockID, SignedMsgType
from cometbft_tpu_torch.utils import cmttime
from cometbft_tpu_torch.utils import protobuf as pb

MAX_VOTE_BYTES = 223  # types/vote.go MaxVoteBytes (without extensions)


@dataclass
class Vote:
    type_: SignedMsgType
    height: int
    round_: int
    block_id: BlockID
    timestamp: cmttime.Timestamp
    validator_address: bytes
    validator_index: int
    signature: bytes = b""
    extension: bytes = b""
    extension_signature: bytes = b""

    def is_nil(self) -> bool:
        """A vote for 'nil' — explicitly against the proposal."""
        return self.block_id.is_nil()

    def sign_bytes(self, chain_id: str) -> bytes:
        return canonical.vote_sign_bytes(
            chain_id, self.type_, self.height, self.round_, self.block_id, self.timestamp
        )

    def extension_sign_bytes(self, chain_id: str) -> bytes:
        return canonical.vote_extension_sign_bytes(
            chain_id, self.height, self.round_, self.extension
        )

    def verify(self, chain_id: str, pub_key: crypto.PubKey) -> bool:
        """Serial-path verification (reference types/vote.go:224). The batch
        path goes through VoteSet/validation instead."""
        if pub_key.address() != self.validator_address:
            return False
        return pub_key.verify_signature(self.sign_bytes(chain_id), self.signature)

    def verify_extension(self, chain_id: str, pub_key: crypto.PubKey) -> bool:
        """Only the extension signature (types/vote.go:247 VerifyExtension)
        — the gate before the app sees the payload; the vote's own
        signature verifies separately (serial add or device-batch flush)."""
        if self.type_ != SignedMsgType.PRECOMMIT or self.block_id.is_nil():
            return True
        if not self.extension_signature:
            return False
        return pub_key.verify_signature(
            self.extension_sign_bytes(chain_id), self.extension_signature
        )

    def verify_vote_and_extension(self, chain_id: str, pub_key: crypto.PubKey) -> bool:
        if not self.verify(chain_id, pub_key):
            return False
        if self.type_ == SignedMsgType.PRECOMMIT and not self.block_id.is_nil():
            if not self.extension_signature:
                return False
            return pub_key.verify_signature(
                self.extension_sign_bytes(chain_id), self.extension_signature
            )
        return True

    def validate_basic(self) -> None:
        """types/vote.go ValidateBasic."""
        if self.type_ not in (SignedMsgType.PREVOTE, SignedMsgType.PRECOMMIT):
            raise ValueError("invalid Type")
        if self.height <= 0:
            raise ValueError("non-positive Height")
        if self.round_ < 0:
            raise ValueError("negative Round")
        self.block_id.validate_basic()
        if not self.block_id.is_nil() and not self.block_id.is_complete():
            raise ValueError(f"blockID must be either empty or complete, got: {self.block_id}")
        if len(self.validator_address) != crypto.ADDRESS_SIZE:
            raise ValueError("expected ValidatorAddress size to be 20 bytes")
        if self.validator_index < 0:
            raise ValueError("negative ValidatorIndex")
        if not self.signature:
            raise ValueError("signature is missing")
        if self.type_ != SignedMsgType.PRECOMMIT or self.is_nil():
            if self.extension:
                raise ValueError("unexpected vote extension")
            if self.extension_signature:
                raise ValueError("unexpected extension signature")

    # ------------------------------------------------------------- proto

    def to_proto(self) -> bytes:
        w = pb.Writer()
        w.uvarint(1, int(self.type_))
        w.varint_i64(2, self.height)
        w.varint_i64(3, self.round_)
        w.message(4, self.block_id.to_proto(), always=True)
        w.message(5, pb.timestamp_bytes(self.timestamp.seconds, self.timestamp.nanos), always=True)
        w.bytes(6, self.validator_address)
        w.varint_i64(7, self.validator_index)
        w.bytes(8, self.signature)
        w.bytes(9, self.extension)
        w.bytes(10, self.extension_signature)
        return w.output()

    @classmethod
    def from_proto(cls, data: bytes) -> "Vote":
        r = pb.Reader(data)
        v = cls(
            type_=SignedMsgType.UNKNOWN,
            height=0,
            round_=0,
            block_id=BlockID(),
            timestamp=cmttime.Timestamp.zero(),
            validator_address=b"",
            validator_index=0,
        )
        while not r.at_end():
            f, w = r.read_tag()
            if f == 1:
                v.type_ = SignedMsgType(r.read_uvarint())
            elif f == 2:
                v.height = r.read_varint_i64()
            elif f == 3:
                v.round_ = r.read_varint_i64()
            elif f == 4:
                v.block_id = BlockID.from_proto(r.read_bytes())
            elif f == 5:
                secs, nanos = r.read_timestamp()
                v.timestamp = cmttime.Timestamp(secs, nanos)
            elif f == 6:
                v.validator_address = r.read_bytes()
            elif f == 7:
                v.validator_index = r.read_varint_i64()
            elif f == 8:
                v.signature = r.read_bytes()
            elif f == 9:
                v.extension = r.read_bytes()
            elif f == 10:
                v.extension_signature = r.read_bytes()
            else:
                r.skip(w)
        return v

    def __str__(self) -> str:
        kind = {SignedMsgType.PREVOTE: "Prevote", SignedMsgType.PRECOMMIT: "Precommit"}.get(
            self.type_, "?"
        )
        return (
            f"Vote{{{self.validator_index}:{self.validator_address.hex()[:12]} "
            f"{self.height}/{self.round_} {kind} {self.block_id}}}"
        )


def sign_rows(chain_id: str, votes: list[Vote]) -> list:
    """The votes' sign bytes in factored form (libs/prefixrows.PrefixedMsg),
    row by row byte-identical to vote.sign_bytes(chain_id): a canonical
    vote row splits before its timestamp field, and the votes that share
    the head (length, type, height, round, block ID) share one prefix
    object. A VoteSet flush so takes the device-challenge path (K5) as a
    commit's rows do (Commit.vote_sign_bytes_all); the reference stages
    the plain rows."""
    from cometbft_tpu_torch.libs.prefixrows import PrefixedMsg

    tail = len(pb.Writer().string(6, chain_id).output())
    heads: dict[bytes, bytes] = {}
    out = []
    for v in votes:
        row = v.sign_bytes(chain_id)
        ts = len(pb.timestamp_bytes(v.timestamp.seconds, v.timestamp.nanos))
        cut = len(row) - tail - ts - len(pb.encode_uvarint(ts)) - 1  # 1: the field's tag
        head = heads.setdefault(row[:cut], row[:cut])
        out.append(PrefixedMsg(head, row[cut:]))
    return out
