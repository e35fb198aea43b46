"""Blocksync wire messages + codec.

Reference: proto/tendermint/blocksync/types.proto and blocksync/msgs.go.
One Message envelope, oneof by field number:

  1 BlockRequest{1:height}
  2 NoBlockResponse{1:height}
  3 BlockResponse{1:block, 2:ext_commit}
  4 StatusRequest{}
  5 StatusResponse{1:height, 2:base}

Framework extension (no reference analog) — commit-certificate exchange,
negotiated via its own channel (0x25, reactor.py CERT_CHANNEL) exactly
like the consensus VoteSummary idiom, so non-supporting peers never see
these frames:

  6 CertRequest{1:height}
  7 CertResponse{1:height, 2:cert}   (cert = encoded CommitCertificate)
  8 NoCertResponse{1:height}

The port's copy of cometbft_tpu/blocksync/messages.py.
"""

from __future__ import annotations

from dataclasses import dataclass

from cometbft_tpu_torch.types.block import Block
from cometbft_tpu_torch.types.commit import ExtendedCommit
from cometbft_tpu_torch.utils.protobuf import Reader, Writer


@dataclass
class BlockRequest:
    height: int


@dataclass
class NoBlockResponse:
    height: int


@dataclass
class BlockResponse:
    block: Block
    ext_commit: ExtendedCommit | None = None


@dataclass
class StatusRequest:
    pass


@dataclass
class CertRequest:
    height: int


@dataclass
class CertResponse:
    height: int
    cert: bytes  # encoded CommitCertificate (opaque at this layer)


@dataclass
class NoCertResponse:
    height: int


@dataclass
class StatusResponse:
    height: int
    base: int


def encode(msg) -> bytes:
    w = Writer()
    if isinstance(msg, BlockRequest):
        w.message(1, Writer().varint_i64(1, msg.height).output(), always=True)
    elif isinstance(msg, NoBlockResponse):
        w.message(2, Writer().varint_i64(1, msg.height).output(), always=True)
    elif isinstance(msg, BlockResponse):
        inner = Writer().message(1, msg.block.to_proto(), always=True)
        if msg.ext_commit is not None:
            from cometbft_tpu_torch.store.blockstore import _extended_to_proto

            inner.message(2, _extended_to_proto(msg.ext_commit))
        w.message(3, inner.output(), always=True)
    elif isinstance(msg, StatusRequest):
        w.message(4, b"", always=True)
    elif isinstance(msg, StatusResponse):
        w.message(
            5,
            Writer().varint_i64(1, msg.height).varint_i64(2, msg.base).output(),
            always=True,
        )
    elif isinstance(msg, CertRequest):
        w.message(6, Writer().varint_i64(1, msg.height).output(), always=True)
    elif isinstance(msg, CertResponse):
        inner = Writer().varint_i64(1, msg.height).bytes(2, msg.cert)
        w.message(7, inner.output(), always=True)
    elif isinstance(msg, NoCertResponse):
        w.message(8, Writer().varint_i64(1, msg.height).output(), always=True)
    else:
        raise TypeError(f"cannot encode blocksync message {type(msg)}")
    return w.output()


def decode(data: bytes):
    r = Reader(data)
    f, _w = r.read_tag()
    body = r.read_bytes()
    br = Reader(body)
    if f == 1 or f == 2:
        height = 0
        while not br.at_end():
            g, w2 = br.read_tag()
            if g == 1:
                height = br.read_varint_i64()
            else:
                br.skip(w2)
        return BlockRequest(height) if f == 1 else NoBlockResponse(height)
    if f == 3:
        block, ec = None, None
        while not br.at_end():
            g, w2 = br.read_tag()
            if g == 1:
                block = Block.from_proto(br.read_bytes())
            elif g == 2:
                from cometbft_tpu_torch.store.blockstore import _extended_from_proto

                ec = _extended_from_proto(br.read_bytes())
            else:
                br.skip(w2)
        if block is None:
            raise ValueError("BlockResponse without block")
        return BlockResponse(block, ec)
    if f == 4:
        return StatusRequest()
    if f == 5:
        height, base = 0, 0
        while not br.at_end():
            g, w2 = br.read_tag()
            if g == 1:
                height = br.read_varint_i64()
            elif g == 2:
                base = br.read_varint_i64()
            else:
                br.skip(w2)
        return StatusResponse(height, base)
    if f == 6 or f == 8:
        height = 0
        while not br.at_end():
            g, w2 = br.read_tag()
            if g == 1:
                height = br.read_varint_i64()
            else:
                br.skip(w2)
        return CertRequest(height) if f == 6 else NoCertResponse(height)
    if f == 7:
        height, cert = 0, b""
        while not br.at_end():
            g, w2 = br.read_tag()
            if g == 1:
                height = br.read_varint_i64()
            elif g == 2:
                cert = br.read_bytes()
            else:
                br.skip(w2)
        return CertResponse(height, cert)
    raise ValueError(f"unknown blocksync message field {f}")
