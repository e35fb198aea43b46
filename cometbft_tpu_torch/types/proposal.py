"""Proposal (reference: types/proposal.go).

The port's copy of cometbft_tpu/types/proposal.py.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from cometbft_tpu_torch import crypto
from cometbft_tpu_torch.types import canonical
from cometbft_tpu_torch.types.basic import BlockID, SignedMsgType
from cometbft_tpu_torch.utils import cmttime
from cometbft_tpu_torch.utils import protobuf as pb


@dataclass
class Proposal:
    height: int
    round_: int
    pol_round: int  # -1 when no proof-of-lock
    block_id: BlockID
    timestamp: cmttime.Timestamp
    signature: bytes = b""

    def sign_bytes(self, chain_id: str) -> bytes:
        return canonical.proposal_sign_bytes(
            chain_id, self.height, self.round_, self.pol_round, self.block_id, self.timestamp
        )

    def verify(self, chain_id: str, pub_key: crypto.PubKey) -> bool:
        return pub_key.verify_signature(self.sign_bytes(chain_id), self.signature)

    def validate_basic(self) -> None:
        """proposal.go ValidateBasic."""
        if self.height <= 0:
            raise ValueError("non-positive Height")
        if self.round_ < 0:
            raise ValueError("negative Round")
        if self.pol_round < -1 or self.pol_round >= self.round_:
            raise ValueError("POLRound must be -1 or in [0, round)")
        self.block_id.validate_basic()
        if not self.block_id.is_complete():
            raise ValueError(f"expected a complete, non-empty BlockID, got: {self.block_id}")
        if not self.signature:
            raise ValueError("signature is missing")
        if len(self.signature) > crypto.MAX_SIGNATURE_SIZE:
            raise ValueError("signature is too big")

    def to_proto(self) -> bytes:
        w = pb.Writer()
        w.uvarint(1, int(SignedMsgType.PROPOSAL))
        w.varint_i64(2, self.height)
        w.varint_i64(3, self.round_)
        w.varint_i64(4, self.pol_round & ((1 << 64) - 1) if self.pol_round < 0 else self.pol_round)
        w.message(5, self.block_id.to_proto(), always=True)
        w.message(6, pb.timestamp_bytes(self.timestamp.seconds, self.timestamp.nanos), always=True)
        w.bytes(7, self.signature)
        return w.output()

    @classmethod
    def from_proto(cls, data: bytes) -> "Proposal":
        r = pb.Reader(data)
        p = cls(
            height=0,
            round_=0,
            pol_round=0,
            block_id=BlockID(),
            timestamp=cmttime.Timestamp.zero(),
        )
        while not r.at_end():
            f, w = r.read_tag()
            if f == 2:
                p.height = r.read_varint_i64()
            elif f == 3:
                p.round_ = r.read_varint_i64()
            elif f == 4:
                p.pol_round = r.read_varint_i64()
            elif f == 5:
                p.block_id = BlockID.from_proto(r.read_bytes())
            elif f == 6:
                secs, nanos = r.read_timestamp()
                p.timestamp = cmttime.Timestamp(secs, nanos)
            elif f == 7:
                p.signature = r.read_bytes()
            else:
                r.skip(w)
        return p
