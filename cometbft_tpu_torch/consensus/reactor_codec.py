"""Wire codec for consensus reactor messages.

Reference: proto/tendermint/consensus/types.proto + consensus/reactor.go
message taxonomy (reactor.go:1576-1592). Each channel carries a Message
envelope with a oneof keyed by field number:

  1 NewRoundStep  2 NewValidBlock  3 Proposal  4 ProposalPOL  5 BlockPart
  6 Vote          7 HasVote        8 VoteSetMaj23  9 VoteSetBits
  10 VoteSummary (framework extension: compact vote-set reconciliation,
     only ever sent on the negotiated RECON channel)

BitArrays ride as {1: bits varint, 2: packed little-endian bytes}.

The port's copy of cometbft_tpu/consensus/reactor_codec.py.
"""

from __future__ import annotations

import zlib

from cometbft_tpu_torch.consensus import messages as M
from cometbft_tpu_torch.libs.bits import BitArray
from cometbft_tpu_torch.types.basic import BlockID, PartSetHeader, SignedMsgType
from cometbft_tpu_torch.types.part_set import Part
from cometbft_tpu_torch.types.proposal import Proposal
from cometbft_tpu_torch.types.vote import Vote
from cometbft_tpu_torch.utils.protobuf import Reader, Writer


def _bits_bytes(ba: BitArray | None) -> bytes | None:
    if ba is None:
        return None
    return Writer().varint_i64(1, ba.size()).bytes(2, ba.to_bytes()).output()


def _read_bits(r: Reader) -> BitArray:
    br = r.read_message()
    bits, data = 0, b""
    while not br.at_end():
        f, w = br.read_tag()
        if f == 1:
            bits = br.read_varint_i64()
        elif f == 2:
            data = br.read_bytes()
        else:
            br.skip(w)
    return BitArray.from_bytes(bits, data)


def vote_summary_checksum(height: int, round_: int,
                          prevotes: BitArray | None,
                          precommits: BitArray | None) -> int:
    """End-to-end integrity word for a VoteSummaryMessage: crc32 over the
    canonical payload. Transport framing already checks lengths; this
    catches a summary whose BITS were corrupted in flight or by a buggy
    peer — an invalid summary must degrade to full gossip, never update
    the peer's vote bookkeeping."""
    pv = prevotes.to_bytes() if prevotes is not None else b""
    pc = precommits.to_bytes() if precommits is not None else b""
    body = b"%d|%d|%d|%d|" % (
        height, round_,
        prevotes.size() if prevotes is not None else -1,
        precommits.size() if precommits is not None else -1) + pv + b"|" + pc
    return zlib.crc32(body) & 0xFFFFFFFF


def encode(msg) -> bytes:
    w = Writer()
    if isinstance(msg, M.NewRoundStepMessage):
        inner = (
            Writer()
            .varint_i64(1, msg.height)
            .varint_i64(2, msg.round_)
            .uvarint(3, msg.step)
            .varint_i64(4, msg.seconds_since_start_time)
            .varint_i64(5, msg.last_commit_round)
            .output()
        )
        w.message(1, inner, always=True)
    elif isinstance(msg, M.NewValidBlockMessage):
        inner = Writer().varint_i64(1, msg.height).varint_i64(2, msg.round_)
        psh = msg.block_part_set_header
        inner.message(3, psh.to_proto() if psh else None)
        inner.message(4, _bits_bytes(msg.block_parts))
        inner.bool(5, msg.is_commit)
        w.message(2, inner.output(), always=True)
    elif isinstance(msg, M.ProposalMessage):
        w.message(3, Writer().message(1, msg.proposal.to_proto(), always=True).output(), always=True)
    elif isinstance(msg, M.ProposalPOLMessage):
        inner = (
            Writer()
            .varint_i64(1, msg.height)
            .varint_i64(2, msg.proposal_pol_round)
            .message(3, _bits_bytes(msg.proposal_pol))
            .output()
        )
        w.message(4, inner, always=True)
    elif isinstance(msg, M.BlockPartMessage):
        inner = (
            Writer()
            .varint_i64(1, msg.height)
            .varint_i64(2, msg.round_)
            .message(3, msg.part.to_proto(), always=True)
            .output()
        )
        w.message(5, inner, always=True)
    elif isinstance(msg, M.VoteMessage):
        w.message(6, Writer().message(1, msg.vote.to_proto(), always=True).output(), always=True)
    elif isinstance(msg, M.HasVoteMessage):
        inner = (
            Writer()
            .varint_i64(1, msg.height)
            .varint_i64(2, msg.round_)
            .uvarint(3, int(msg.type_))
            .varint_i64(4, msg.index)
            .output()
        )
        w.message(7, inner, always=True)
    elif isinstance(msg, M.VoteSetMaj23Message):
        inner = (
            Writer()
            .varint_i64(1, msg.height)
            .varint_i64(2, msg.round_)
            .uvarint(3, int(msg.type_))
            .message(4, msg.block_id.to_proto(), always=True)
            .output()
        )
        w.message(8, inner, always=True)
    elif isinstance(msg, M.VoteSetBitsMessage):
        inner = (
            Writer()
            .varint_i64(1, msg.height)
            .varint_i64(2, msg.round_)
            .uvarint(3, int(msg.type_))
            .message(4, msg.block_id.to_proto(), always=True)
            .message(5, _bits_bytes(msg.votes))
            .output()
        )
        w.message(9, inner, always=True)
    elif isinstance(msg, M.VoteSummaryMessage):
        inner = (
            Writer()
            .varint_i64(1, msg.height)
            .varint_i64(2, msg.round_)
            .message(3, _bits_bytes(msg.prevotes))
            .message(4, _bits_bytes(msg.precommits))
            .uvarint(5, msg.checksum)
            .output()
        )
        w.message(10, inner, always=True)
    else:
        raise TypeError(f"cannot encode consensus message {type(msg)}")
    return w.output()


def decode(data: bytes):
    r = Reader(data)
    f, w = r.read_tag()
    if f == 1:
        mr = r.read_message()
        msg = M.NewRoundStepMessage(height=0, round_=0, step=0)
        while not mr.at_end():
            mf, mw = mr.read_tag()
            if mf == 1:
                msg.height = mr.read_varint_i64()
            elif mf == 2:
                msg.round_ = mr.read_varint_i64()
            elif mf == 3:
                msg.step = mr.read_uvarint()
            elif mf == 4:
                msg.seconds_since_start_time = mr.read_varint_i64()
            elif mf == 5:
                msg.last_commit_round = mr.read_varint_i64()
            else:
                mr.skip(mw)
        return msg
    if f == 2:
        mr = r.read_message()
        msg = M.NewValidBlockMessage(height=0, round_=0)
        while not mr.at_end():
            mf, mw = mr.read_tag()
            if mf == 1:
                msg.height = mr.read_varint_i64()
            elif mf == 2:
                msg.round_ = mr.read_varint_i64()
            elif mf == 3:
                msg.block_part_set_header = PartSetHeader.from_proto(mr.read_bytes())
            elif mf == 4:
                msg.block_parts = _read_bits(mr)
            elif mf == 5:
                msg.is_commit = mr.read_uvarint() != 0
            else:
                mr.skip(mw)
        return msg
    if f == 3:
        mr = r.read_message()
        proposal = None
        while not mr.at_end():
            mf, mw = mr.read_tag()
            if mf == 1:
                proposal = Proposal.from_proto(mr.read_bytes())
            else:
                mr.skip(mw)
        return M.ProposalMessage(proposal=proposal)
    if f == 4:
        mr = r.read_message()
        msg = M.ProposalPOLMessage(height=0, proposal_pol_round=0)
        while not mr.at_end():
            mf, mw = mr.read_tag()
            if mf == 1:
                msg.height = mr.read_varint_i64()
            elif mf == 2:
                msg.proposal_pol_round = mr.read_varint_i64()
            elif mf == 3:
                msg.proposal_pol = _read_bits(mr)
            else:
                mr.skip(mw)
        return msg
    if f == 5:
        mr = r.read_message()
        height = round_ = 0
        part = None
        while not mr.at_end():
            mf, mw = mr.read_tag()
            if mf == 1:
                height = mr.read_varint_i64()
            elif mf == 2:
                round_ = mr.read_varint_i64()
            elif mf == 3:
                part = Part.from_proto(mr.read_bytes())
            else:
                mr.skip(mw)
        return M.BlockPartMessage(height=height, round_=round_, part=part)
    if f == 6:
        mr = r.read_message()
        vote = None
        while not mr.at_end():
            mf, mw = mr.read_tag()
            if mf == 1:
                vote = Vote.from_proto(mr.read_bytes())
            else:
                mr.skip(mw)
        return M.VoteMessage(vote=vote)
    if f == 7:
        mr = r.read_message()
        msg = M.HasVoteMessage(height=0, round_=0)
        while not mr.at_end():
            mf, mw = mr.read_tag()
            if mf == 1:
                msg.height = mr.read_varint_i64()
            elif mf == 2:
                msg.round_ = mr.read_varint_i64()
            elif mf == 3:
                msg.type_ = SignedMsgType(mr.read_uvarint())
            elif mf == 4:
                msg.index = mr.read_varint_i64()
            else:
                mr.skip(mw)
        return msg
    if f == 8:
        mr = r.read_message()
        msg = M.VoteSetMaj23Message(height=0, round_=0, type_=SignedMsgType.UNKNOWN)
        while not mr.at_end():
            mf, mw = mr.read_tag()
            if mf == 1:
                msg.height = mr.read_varint_i64()
            elif mf == 2:
                msg.round_ = mr.read_varint_i64()
            elif mf == 3:
                msg.type_ = SignedMsgType(mr.read_uvarint())
            elif mf == 4:
                msg.block_id = BlockID.from_proto(mr.read_bytes())
            else:
                mr.skip(mw)
        return msg
    if f == 9:
        mr = r.read_message()
        msg = M.VoteSetBitsMessage(height=0, round_=0, type_=SignedMsgType.UNKNOWN)
        while not mr.at_end():
            mf, mw = mr.read_tag()
            if mf == 1:
                msg.height = mr.read_varint_i64()
            elif mf == 2:
                msg.round_ = mr.read_varint_i64()
            elif mf == 3:
                msg.type_ = SignedMsgType(mr.read_uvarint())
            elif mf == 4:
                msg.block_id = BlockID.from_proto(mr.read_bytes())
            elif mf == 5:
                msg.votes = _read_bits(mr)
            else:
                mr.skip(mw)
        return msg
    if f == 10:
        mr = r.read_message()
        msg = M.VoteSummaryMessage(height=0, round_=0)
        while not mr.at_end():
            mf, mw = mr.read_tag()
            if mf == 1:
                msg.height = mr.read_varint_i64()
            elif mf == 2:
                msg.round_ = mr.read_varint_i64()
            elif mf == 3:
                msg.prevotes = _read_bits(mr)
            elif mf == 4:
                msg.precommits = _read_bits(mr)
            elif mf == 5:
                msg.checksum = mr.read_uvarint()
            else:
                mr.skip(mw)
        return msg
    raise ValueError(f"unknown consensus message field {f}")
