"""PartSet — block serialization into gossip-sized merkle-proven parts.

Reference: types/part_set.go. Blocks travel the consensus Data channel as
64 kB parts (BlockPartSizeBytes, types/params.go) with per-part merkle
proofs against the PartSetHeader root that the proposal commits to.

The port's copy of cometbft_tpu/types/part_set.py.
"""

from __future__ import annotations

from dataclasses import dataclass

from cometbft_tpu_torch.crypto import merkle
from cometbft_tpu_torch.libs.bits import BitArray
from cometbft_tpu_torch.types.basic import PartSetHeader
from cometbft_tpu_torch.utils import protobuf as pb

BLOCK_PART_SIZE_BYTES = 65536  # types/params.go BlockPartSizeBytes


class ErrPartSetUnexpectedIndex(Exception):
    pass


class ErrPartSetInvalidProof(Exception):
    pass


@dataclass
class Part:
    index: int
    bytes_: bytes
    proof: merkle.Proof

    def validate_basic(self) -> None:
        if self.index < 0:
            raise ValueError("negative Index")
        if len(self.bytes_) > BLOCK_PART_SIZE_BYTES:
            raise ValueError(f"part bytes exceed maximum {BLOCK_PART_SIZE_BYTES}")
        if self.proof.index != self.index or len(self.proof.leaf_hash) != 32:
            raise ValueError("wrong proof")

    def to_proto(self) -> bytes:
        proof_w = pb.Writer()
        proof_w.varint_i64(1, self.proof.total)
        proof_w.varint_i64(2, self.proof.index)
        proof_w.bytes(3, self.proof.leaf_hash)
        for aunt in self.proof.aunts:
            proof_w.bytes(4, aunt, always=True)
        w = pb.Writer()
        w.uvarint(1, self.index)
        w.bytes(2, self.bytes_)
        w.message(3, proof_w.output(), always=True)
        return w.output()

    @classmethod
    def from_proto(cls, data: bytes) -> "Part":
        r = pb.Reader(data)
        index = 0
        body = b""
        proof = merkle.Proof(total=0, index=0, leaf_hash=b"")
        while not r.at_end():
            f, w = r.read_tag()
            if f == 1:
                index = r.read_uvarint()
            elif f == 2:
                body = r.read_bytes()
            elif f == 3:
                pr = r.read_message()
                total = pidx = 0
                leaf = b""
                aunts: list[bytes] = []
                while not pr.at_end():
                    pf, pw = pr.read_tag()
                    if pf == 1:
                        total = pr.read_varint_i64()
                    elif pf == 2:
                        pidx = pr.read_varint_i64()
                    elif pf == 3:
                        leaf = pr.read_bytes()
                    elif pf == 4:
                        aunts.append(pr.read_bytes())
                    else:
                        pr.skip(pw)
                proof = merkle.Proof(total=total, index=pidx, leaf_hash=leaf, aunts=aunts)
            else:
                r.skip(w)
        return cls(index=index, bytes_=body, proof=proof)


class PartSet:
    """types/part_set.go:129-292. Either built complete from data (proposer
    side) or assembled part-by-part with proof verification (receiver)."""

    def __init__(self, total: int, header_hash: bytes):
        self.total = total
        self.hash = header_hash
        self.parts: list[Part | None] = [None] * total
        self.parts_bit_array = BitArray(total)
        self.count = 0
        self.byte_size = 0

    @classmethod
    def from_data(cls, data: bytes, part_size: int = BLOCK_PART_SIZE_BYTES) -> "PartSet":
        """Split + build merkle proofs (part_set.go NewPartSetFromData)."""
        chunks = [data[i : i + part_size] for i in range(0, len(data), part_size)] or [b""]
        root, proofs = merkle.proofs_from_byte_slices(chunks)
        ps = cls(total=len(chunks), header_hash=root)
        for i, chunk in enumerate(chunks):
            part = Part(index=i, bytes_=chunk, proof=proofs[i])
            ps.parts[i] = part
            ps.parts_bit_array.set_index(i, True)
            ps.count += 1
            ps.byte_size += len(chunk)
        return ps

    @classmethod
    def from_header(cls, header: PartSetHeader) -> "PartSet":
        return cls(total=header.total, header_hash=header.hash)

    def header(self) -> PartSetHeader:
        return PartSetHeader(total=self.total, hash=self.hash)

    def has_header(self, header: PartSetHeader) -> bool:
        return self.header() == header

    def add_part(self, part: Part) -> bool:
        """part_set.go AddPart: False for duplicates; raises on bad
        index/proof."""
        if part.index >= self.total:
            raise ErrPartSetUnexpectedIndex(f"index {part.index} >= total {self.total}")
        if self.parts[part.index] is not None:
            return False
        if part.proof.total != self.total:
            raise ErrPartSetInvalidProof("proof total mismatch")
        if not part.proof.verify(self.hash, part.bytes_):
            raise ErrPartSetInvalidProof(f"invalid proof for part {part.index}")
        self.parts[part.index] = part
        self.parts_bit_array.set_index(part.index, True)
        self.count += 1
        self.byte_size += len(part.bytes_)
        return True

    def get_part(self, index: int) -> Part | None:
        return self.parts[index]

    def is_complete(self) -> bool:
        return self.count == self.total

    def get_reader(self) -> bytes:
        """Reassembled payload (only when complete)."""
        if not self.is_complete():
            raise ValueError("cannot read incomplete PartSet")
        return b"".join(p.bytes_ for p in self.parts)  # type: ignore[union-attr]

    def bit_array(self) -> BitArray:
        return self.parts_bit_array.copy()
