"""SignedHeader and LightBlock — the light-client domain types.

Reference: types/light.go (LightBlock, SignedHeader). A SignedHeader is a
header plus the commit that signed it; a LightBlock adds the validator set
whose hash the header carries. validate_basic mirrors types/light.go:13-60
and types/block.go SignedHeader.ValidateBasic.

The port's copy of cometbft_tpu/types/light.py.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from cometbft_tpu_torch.types.block import Header
from cometbft_tpu_torch.types.commit import Commit
from cometbft_tpu_torch.types.validator import ValidatorSet
from cometbft_tpu_torch.utils import protobuf as pb


@dataclass
class SignedHeader:
    """types/block.go SignedHeader: header + the commit over it."""

    header: Header
    commit: Commit

    @property
    def height(self) -> int:
        return self.header.height

    @property
    def time(self):
        return self.header.time

    @property
    def chain_id(self) -> str:
        return self.header.chain_id

    def hash(self) -> bytes | None:
        return self.header.hash()

    def validate_basic(self, chain_id: str) -> None:
        """types/block.go SignedHeader.ValidateBasic: header and commit are
        self-consistent and commit actually points at this header."""
        if self.header is None:
            raise ValueError("missing header")
        if self.commit is None:
            raise ValueError("missing commit")
        self.header.validate_basic()
        self.commit.validate_basic()
        if self.header.chain_id != chain_id:
            raise ValueError(
                f"header belongs to another chain {self.header.chain_id!r}, not {chain_id!r}"
            )
        if self.commit.height != self.header.height:
            raise ValueError(
                f"header and commit height mismatch: {self.header.height} vs {self.commit.height}"
            )
        if self.commit.block_id.hash != self.header.hash():
            raise ValueError("commit signs a different header")

    def to_proto(self) -> bytes:
        w = pb.Writer()
        w.message(1, self.header.to_proto(), always=True)
        w.message(2, self.commit.to_proto(), always=True)
        return w.output()

    @classmethod
    def from_proto(cls, data: bytes) -> "SignedHeader":
        r = pb.Reader(data)
        header, commit = None, None
        while not r.at_end():
            f, w = r.read_tag()
            if f == 1:
                header = Header.from_proto(r.read_bytes())
            elif f == 2:
                commit = Commit.from_proto(r.read_bytes())
            else:
                r.skip(w)
        if header is None or commit is None:
            raise ValueError("incomplete SignedHeader proto")
        return cls(header=header, commit=commit)


@dataclass
class LightBlock:
    """types/light.go:100-150: SignedHeader + the validator set for that
    height. The light client's unit of transfer and trust."""

    signed_header: SignedHeader
    validator_set: ValidatorSet

    @property
    def height(self) -> int:
        return self.signed_header.height

    @property
    def time(self):
        return self.signed_header.time

    def hash(self) -> bytes | None:
        return self.signed_header.hash()

    @property
    def header(self) -> Header:
        return self.signed_header.header

    @property
    def commit(self) -> Commit:
        return self.signed_header.commit

    def validate_basic(self, chain_id: str) -> None:
        """types/light.go:30-60: inner checks plus the valset-hash link."""
        if self.signed_header is None:
            raise ValueError("missing signed header")
        if self.validator_set is None or self.validator_set.is_nil_or_empty():
            raise ValueError("missing validator set")
        self.signed_header.validate_basic(chain_id)
        self.validator_set.validate_basic()
        if self.signed_header.header.validators_hash != self.validator_set.hash():
            raise ValueError(
                "light block's validator set hash does not match its header's"
            )

    def to_proto(self) -> bytes:
        w = pb.Writer()
        w.message(1, self.signed_header.to_proto(), always=True)
        w.message(2, self.validator_set.to_proto(), always=True)
        return w.output()

    @classmethod
    def from_proto(cls, data: bytes) -> "LightBlock":
        r = pb.Reader(data)
        sh: Optional[SignedHeader] = None
        vs: Optional[ValidatorSet] = None
        while not r.at_end():
            f, w = r.read_tag()
            if f == 1:
                sh = SignedHeader.from_proto(r.read_bytes())
            elif f == 2:
                vs = ValidatorSet.from_proto(r.read_bytes())
            else:
                r.skip(w)
        if sh is None or vs is None:
            raise ValueError("incomplete LightBlock proto")
        return cls(signed_header=sh, validator_set=vs)
