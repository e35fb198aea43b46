"""Block, Header, Data — and their consensus-critical hashes.

Reference: types/block.go. Header.hash() is the merkle root over the 14
field encodings (block.go:439-474) using gogoproto wrapper encodings
(types/encoding_helper.go cdcEncode); Data.hash() is the tx merkle root;
Block.hash() == Header.hash().

The port's copy of cometbft_tpu/types/block.py.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field

from cometbft_tpu_torch.crypto import merkle, tmhash
from cometbft_tpu_torch.types.basic import BlockID
from cometbft_tpu_torch.types.commit import Commit
from cometbft_tpu_torch.utils import cmttime
from cometbft_tpu_torch.utils import protobuf as pb

# Block protocol version (reference: version/version.go BlockProtocol = 11)
BLOCK_PROTOCOL = 11
MAX_HEADER_BYTES = 626


def cdc_encode_string(s: str) -> bytes:
    """gogotypes.StringValue marshal (encoding_helper.go:14-22);
    empty -> nil leaf."""
    if not s:
        return b""
    return pb.Writer().string(1, s).output()


def cdc_encode_int64(v: int) -> bytes:
    if not v:
        return b""
    return pb.Writer().varint_i64(1, v).output()


def cdc_encode_bytes(v: bytes) -> bytes:
    if not v:
        return b""
    return pb.Writer().bytes(1, v).output()


@dataclass
class Consensus:
    """version.Consensus proto (proto/tendermint/version/types.proto:19-24)."""

    block: int = BLOCK_PROTOCOL
    app: int = 0

    def to_proto(self) -> bytes:
        return pb.Writer().uvarint(1, self.block).uvarint(2, self.app).output()

    @classmethod
    def from_proto(cls, data: bytes) -> "Consensus":
        r = pb.Reader(data)
        c = cls(block=0, app=0)
        while not r.at_end():
            f, w = r.read_tag()
            if f == 1:
                c.block = r.read_uvarint()
            elif f == 2:
                c.app = r.read_uvarint()
            else:
                r.skip(w)
        return c


@dataclass
class Header:
    """types/block.go:337-360."""

    version: Consensus = field(default_factory=Consensus)
    chain_id: str = ""
    height: int = 0
    time: cmttime.Timestamp = field(default_factory=cmttime.Timestamp.zero)
    last_block_id: BlockID = field(default_factory=BlockID)
    last_commit_hash: bytes = b""
    data_hash: bytes = b""
    validators_hash: bytes = b""
    next_validators_hash: bytes = b""
    consensus_hash: bytes = b""
    app_hash: bytes = b""
    last_results_hash: bytes = b""
    evidence_hash: bytes = b""
    proposer_address: bytes = b""

    def hash(self) -> bytes | None:
        """block.go:439-474. None when the header is incomplete (pre-populate)."""
        if not self.validators_hash:
            return None
        return merkle.hash_from_byte_slices(
            [
                self.version.to_proto(),
                cdc_encode_string(self.chain_id),
                cdc_encode_int64(self.height),
                pb.timestamp_bytes(self.time.seconds, self.time.nanos),
                self.last_block_id.to_proto(),
                cdc_encode_bytes(self.last_commit_hash),
                cdc_encode_bytes(self.data_hash),
                cdc_encode_bytes(self.validators_hash),
                cdc_encode_bytes(self.next_validators_hash),
                cdc_encode_bytes(self.consensus_hash),
                cdc_encode_bytes(self.app_hash),
                cdc_encode_bytes(self.last_results_hash),
                cdc_encode_bytes(self.evidence_hash),
                cdc_encode_bytes(self.proposer_address),
            ]
        )

    def validate_basic(self) -> None:
        """block.go Header.ValidateBasic."""
        if len(self.chain_id) > 50:
            raise ValueError("chainID is too long")
        if self.height < 0:
            raise ValueError("negative Header.Height")
        if self.height == 0:
            raise ValueError("zero Header.Height")
        self.last_block_id.validate_basic()
        for name, h in (
            ("LastCommitHash", self.last_commit_hash),
            ("DataHash", self.data_hash),
            ("EvidenceHash", self.evidence_hash),
            ("ValidatorsHash", self.validators_hash),
            ("NextValidatorsHash", self.next_validators_hash),
            ("ConsensusHash", self.consensus_hash),
            ("LastResultsHash", self.last_results_hash),
        ):
            if h and len(h) != tmhash.SIZE:
                raise ValueError(f"wrong {name} size {len(h)}")
        if len(self.proposer_address) != 20:
            raise ValueError("invalid ProposerAddress length")

    def to_proto(self) -> bytes:
        w = pb.Writer()
        w.message(1, self.version.to_proto(), always=True)
        w.string(2, self.chain_id)
        w.varint_i64(3, self.height)
        w.message(4, pb.timestamp_bytes(self.time.seconds, self.time.nanos), always=True)
        w.message(5, self.last_block_id.to_proto(), always=True)
        w.bytes(6, self.last_commit_hash)
        w.bytes(7, self.data_hash)
        w.bytes(8, self.validators_hash)
        w.bytes(9, self.next_validators_hash)
        w.bytes(10, self.consensus_hash)
        w.bytes(11, self.app_hash)
        w.bytes(12, self.last_results_hash)
        w.bytes(13, self.evidence_hash)
        w.bytes(14, self.proposer_address)
        return w.output()

    @classmethod
    def from_proto(cls, data: bytes) -> "Header":
        r = pb.Reader(data)
        h = cls()
        while not r.at_end():
            f, w = r.read_tag()
            if f == 1:
                h.version = Consensus.from_proto(r.read_bytes())
            elif f == 2:
                h.chain_id = r.read_string()
            elif f == 3:
                h.height = r.read_varint_i64()
            elif f == 4:
                secs, nanos = r.read_timestamp()
                h.time = cmttime.Timestamp(secs, nanos)
            elif f == 5:
                h.last_block_id = BlockID.from_proto(r.read_bytes())
            elif f == 6:
                h.last_commit_hash = r.read_bytes()
            elif f == 7:
                h.data_hash = r.read_bytes()
            elif f == 8:
                h.validators_hash = r.read_bytes()
            elif f == 9:
                h.next_validators_hash = r.read_bytes()
            elif f == 10:
                h.consensus_hash = r.read_bytes()
            elif f == 11:
                h.app_hash = r.read_bytes()
            elif f == 12:
                h.last_results_hash = r.read_bytes()
            elif f == 13:
                h.evidence_hash = r.read_bytes()
            elif f == 14:
                h.proposer_address = r.read_bytes()
            else:
                r.skip(w)
        return h


def tx_hash(tx: bytes) -> bytes:
    """types/tx.go Tx.Hash — SHA-256 of the raw tx bytes."""
    return hashlib.sha256(tx).digest()


@dataclass
class Data:
    """Block transactions (types/block.go Data)."""

    txs: list[bytes] = field(default_factory=list)
    _hash: bytes | None = field(default=None, repr=False, compare=False)

    def hash(self) -> bytes:
        """Merkle root over raw txs (types/tx.go Txs.Hash — leaves are the
        raw transactions, NOT their hashes)."""
        if self._hash is None:
            self._hash = merkle.hash_from_byte_slices(list(self.txs))
        return self._hash


@dataclass
class EvidenceData:
    """types/evidence.go EvidenceData — list of committed evidence."""

    evidence: list = field(default_factory=list)
    _hash: bytes | None = field(default=None, repr=False, compare=False)

    def hash(self) -> bytes:
        if self._hash is None:
            self._hash = merkle.hash_from_byte_slices(
                [ev.bytes_() for ev in self.evidence]
            )
        return self._hash


@dataclass
class Block:
    """types/block.go:27-45."""

    header: Header
    data: Data
    evidence: EvidenceData
    last_commit: Commit | None

    def hash(self) -> bytes | None:
        self.fill_header()
        return self.header.hash()

    def fill_header(self) -> None:
        """block.go fillHeader: populate derived hashes if unset."""
        if not self.header.last_commit_hash and self.last_commit is not None:
            self.header.last_commit_hash = self.last_commit.hash()
        if not self.header.data_hash:
            self.header.data_hash = self.data.hash()
        if not self.header.evidence_hash:
            self.header.evidence_hash = self.evidence.hash()

    def validate_basic(self) -> None:
        """block.go ValidateBasic. LastCommit is required unconditionally —
        first-height blocks carry an EMPTY (zero-signature) commit, never a
        nil one (the reference likewise rejects nil at any height, and a
        height-1 special case would also be wrong for chains whose
        initial_height > 1)."""
        self.header.validate_basic()
        if self.last_commit is None:
            raise ValueError("nil LastCommit")
        self.last_commit.validate_basic()
        if self.header.last_commit_hash != self.last_commit.hash():
            raise ValueError("wrong LastCommitHash")
        if self.header.data_hash != self.data.hash():
            raise ValueError("wrong DataHash")
        if self.header.evidence_hash != self.evidence.hash():
            raise ValueError("wrong EvidenceHash")

    def make_part_set(self, part_size: int):
        from cometbft_tpu_torch.types.part_set import PartSet

        return PartSet.from_data(self.to_proto(), part_size)

    def to_proto(self) -> bytes:
        from cometbft_tpu_torch.types.evidence import evidence_list_to_proto

        w = pb.Writer()
        w.message(1, self.header.to_proto(), always=True)
        data_w = pb.Writer()
        for tx in self.data.txs:
            data_w.bytes(1, tx, always=True)
        w.message(2, data_w.output(), always=True)
        w.message(3, evidence_list_to_proto(self.evidence.evidence), always=True)
        if self.last_commit is not None:
            w.message(4, self.last_commit.to_proto())
        return w.output()

    @classmethod
    def from_proto(cls, data: bytes) -> "Block":
        from cometbft_tpu_torch.types.evidence import evidence_list_from_proto

        r = pb.Reader(data)
        header = Header()
        txs: list[bytes] = []
        evidence: list = []
        last_commit = None
        while not r.at_end():
            f, w = r.read_tag()
            if f == 1:
                header = Header.from_proto(r.read_bytes())
            elif f == 2:
                dr = r.read_message()
                while not dr.at_end():
                    df, dw = dr.read_tag()
                    if df == 1:
                        txs.append(dr.read_bytes())
                    else:
                        dr.skip(dw)
            elif f == 3:
                evidence = evidence_list_from_proto(r.read_bytes())
            elif f == 4:
                last_commit = Commit.from_proto(r.read_bytes())
            else:
                r.skip(w)
        return cls(
            header=header,
            data=Data(txs=txs),
            evidence=EvidenceData(evidence=evidence),
            last_commit=last_commit,
        )
