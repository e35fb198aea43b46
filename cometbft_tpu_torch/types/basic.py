"""Primitive domain types shared across the types layer.

Reference seams: SignedMsgType (proto/tendermint/types/types.proto),
BlockIDFlag (types/block.go:574-583), BlockID/PartSetHeader
(types/block.go, proto layout types.proto:27-42), size limits
(types/vote_set.go:17).

The port's copy of cometbft_tpu/types/basic.py.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field

from cometbft_tpu_torch.crypto import tmhash
from cometbft_tpu_torch.utils import protobuf as pb

# reference: types/vote_set.go:17 — hard cap on votes per set.
MAX_VOTES_COUNT = 10000


class SignedMsgType(enum.IntEnum):
    """proto/tendermint/types/types.proto SignedMsgType."""

    UNKNOWN = 0
    PREVOTE = 1
    PRECOMMIT = 2
    PROPOSAL = 32


class BlockIDFlag(enum.IntEnum):
    """types/block.go:578-583."""

    ABSENT = 1
    COMMIT = 2
    NIL = 3


@dataclass(frozen=True)
class PartSetHeader:
    total: int = 0
    hash: bytes = b""

    def is_zero(self) -> bool:
        return self.total == 0 and len(self.hash) == 0

    def validate_basic(self) -> None:
        if self.total < 0:
            raise ValueError("negative Total")
        if self.hash and len(self.hash) != tmhash.SIZE:
            raise ValueError(f"wrong PartSetHeader hash size {len(self.hash)}")

    def to_proto(self) -> bytes:
        return pb.Writer().uvarint(1, self.total).bytes(2, self.hash).output()

    @classmethod
    def from_proto(cls, data: bytes) -> "PartSetHeader":
        r = pb.Reader(data)
        total, h = 0, b""
        while not r.at_end():
            f, w = r.read_tag()
            if f == 1:
                total = r.read_uvarint()
            elif f == 2:
                h = r.read_bytes()
            else:
                r.skip(w)
        return cls(total=total, hash=h)


@dataclass(frozen=True)
class BlockID:
    hash: bytes = b""
    part_set_header: PartSetHeader = field(default_factory=PartSetHeader)

    def is_nil(self) -> bool:
        """reference: types/block.go BlockID.IsNil — zero value = 'nil vote'."""
        return len(self.hash) == 0 and self.part_set_header.is_zero()

    def is_complete(self) -> bool:
        return (
            len(self.hash) == tmhash.SIZE
            and self.part_set_header.total > 0
            and len(self.part_set_header.hash) == tmhash.SIZE
        )

    def validate_basic(self) -> None:
        if self.hash and len(self.hash) != tmhash.SIZE:
            raise ValueError(f"wrong BlockID hash size {len(self.hash)}")
        self.part_set_header.validate_basic()

    def key(self) -> bytes:
        """Map key: hash || psh proto (reference: types/block.go BlockID.Key)."""
        return self.hash + self.part_set_header.to_proto()

    def to_proto(self) -> bytes:
        """types.proto BlockID: hash=1 bytes, part_set_header=2 non-nullable."""
        w = pb.Writer()
        w.bytes(1, self.hash)
        w.message(2, self.part_set_header.to_proto(), always=True)
        return w.output()

    @classmethod
    def from_proto(cls, data: bytes) -> "BlockID":
        r = pb.Reader(data)
        h, psh = b"", PartSetHeader()
        while not r.at_end():
            f, w = r.read_tag()
            if f == 1:
                h = r.read_bytes()
            elif f == 2:
                psh = PartSetHeader.from_proto(r.read_bytes())
            else:
                r.skip(w)
        return cls(hash=h, part_set_header=psh)

    def __str__(self) -> str:
        return f"{self.hash.hex()[:12]}:{self.part_set_header.total}"
