"""Canonical sign-bytes — byte-exact with the reference's gogoproto output.

The CanonicalVote/CanonicalProposal/CanonicalVoteExtension encodings
(reference: types/canonical.go, proto/tendermint/types/canonical.proto,
generated marshal canonical.pb.go:590-640) are THE interop surface: every
signature in the system is over these bytes, varint-length-delimited
(libs/protoio/writer.go:93). Field rules confirmed against the generated
marshaller:
  - type:    varint, omitted when 0
  - height:  sfixed64, omitted when 0
  - round:   sfixed64, omitted when 0   (int64 of the int32 round)
  - block_id: nullable message — omitted when the BlockID is nil/zero
  - timestamp: ALWAYS emitted (gogoproto non-nullable stdtime)
  - chain_id: omitted when empty

The port's copy of cometbft_tpu/types/canonical.py's vote and vote-extension
sign bytes (proposals come with the node).
"""

from __future__ import annotations

from cometbft_tpu_torch.types.basic import BlockID, SignedMsgType
from cometbft_tpu_torch.utils import cmttime
from cometbft_tpu_torch.utils import protobuf as pb


def canonical_block_id_bytes(block_id: BlockID) -> bytes | None:
    """CanonicalBlockID: hash=1, part_set_header=2 non-nullable.
    Returns None for nil block IDs (field omitted, types/canonical.go:18-34)."""
    if block_id.is_nil():
        return None
    w = pb.Writer()
    w.bytes(1, block_id.hash)
    w.message(2, block_id.part_set_header.to_proto(), always=True)
    return w.output()


def _timestamp(ts: cmttime.Timestamp) -> bytes:
    return pb.timestamp_bytes(ts.seconds, ts.nanos)


def vote_sign_bytes(
    chain_id: str,
    msg_type: SignedMsgType,
    height: int,
    round_: int,
    block_id: BlockID,
    timestamp: cmttime.Timestamp,
) -> bytes:
    """CanonicalVote, length-delimited (types/vote.go:139, canonical.proto:30-37)."""
    w = pb.Writer()
    w.uvarint(1, int(msg_type))
    w.sfixed64(2, height)
    w.sfixed64(3, round_)
    w.message(4, canonical_block_id_bytes(block_id))
    w.message(5, _timestamp(timestamp), always=True)
    w.string(6, chain_id)
    return pb.marshal_delimited(w.output())


def vote_extension_sign_bytes(
    chain_id: str, height: int, round_: int, extension: bytes
) -> bytes:
    """CanonicalVoteExtension (types/vote.go VoteExtensionSignBytes,
    canonical.proto:41-46)."""
    w = pb.Writer()
    w.bytes(1, extension)
    w.sfixed64(2, height)
    w.sfixed64(3, round_)
    w.string(4, chain_id)
    return pb.marshal_delimited(w.output())
