"""Statesync wire messages (reference: statesync/messages.go,
proto/tendermint/statesync). Channels: snapshot metadata on 0x60, chunk
payloads on 0x61 (reactor.go:33-35).

The port's copy of cometbft_tpu/statesync/messages.py.
"""

from __future__ import annotations

from dataclasses import dataclass

from cometbft_tpu_torch.utils import protobuf as pb

SNAPSHOT_CHANNEL = 0x60
CHUNK_CHANNEL = 0x61


@dataclass
class SnapshotsRequest:
    pass


@dataclass
class SnapshotsResponse:
    height: int = 0
    format: int = 0
    chunks: int = 0
    hash_: bytes = b""
    metadata: bytes = b""


@dataclass
class ChunkRequest:
    height: int = 0
    format: int = 0
    index: int = 0


@dataclass
class ChunkResponse:
    height: int = 0
    format: int = 0
    index: int = 0
    chunk: bytes = b""
    missing: bool = False


_TYPES = {
    1: SnapshotsRequest,
    2: SnapshotsResponse,
    3: ChunkRequest,
    4: ChunkResponse,
}
_TAGS = {v: k for k, v in _TYPES.items()}


def encode(msg) -> bytes:
    """oneof Message wrapper."""
    inner = pb.Writer()
    if isinstance(msg, SnapshotsRequest):
        pass
    elif isinstance(msg, SnapshotsResponse):
        inner.uvarint(1, msg.height)
        inner.uvarint(2, msg.format)
        inner.uvarint(3, msg.chunks)
        inner.bytes(4, msg.hash_)
        inner.bytes(5, msg.metadata)
    elif isinstance(msg, ChunkRequest):
        inner.uvarint(1, msg.height)
        inner.uvarint(2, msg.format)
        inner.uvarint(3, msg.index)
    elif isinstance(msg, ChunkResponse):
        inner.uvarint(1, msg.height)
        inner.uvarint(2, msg.format)
        inner.uvarint(3, msg.index)
        inner.bytes(4, msg.chunk)
        if msg.missing:
            inner.uvarint(5, 1)
    else:
        raise ValueError(f"unknown statesync message {type(msg)}")
    w = pb.Writer()
    w.message(_TAGS[type(msg)], inner.output(), always=True)
    return w.output()


def decode(data: bytes):
    r = pb.Reader(data)
    while not r.at_end():
        f, wt = r.read_tag()
        cls = _TYPES.get(f)
        if cls is None:
            r.skip(wt)
            continue
        ir = pb.Reader(r.read_bytes())
        msg = cls()
        while not ir.at_end():
            jf, jw = ir.read_tag()
            if isinstance(msg, SnapshotsResponse):
                if jf == 1:
                    msg.height = ir.read_uvarint()
                elif jf == 2:
                    msg.format = ir.read_uvarint()
                elif jf == 3:
                    msg.chunks = ir.read_uvarint()
                elif jf == 4:
                    msg.hash_ = ir.read_bytes()
                elif jf == 5:
                    msg.metadata = ir.read_bytes()
                else:
                    ir.skip(jw)
            elif isinstance(msg, ChunkRequest):
                if jf == 1:
                    msg.height = ir.read_uvarint()
                elif jf == 2:
                    msg.format = ir.read_uvarint()
                elif jf == 3:
                    msg.index = ir.read_uvarint()
                else:
                    ir.skip(jw)
            elif isinstance(msg, ChunkResponse):
                if jf == 1:
                    msg.height = ir.read_uvarint()
                elif jf == 2:
                    msg.format = ir.read_uvarint()
                elif jf == 3:
                    msg.index = ir.read_uvarint()
                elif jf == 4:
                    msg.chunk = ir.read_bytes()
                elif jf == 5:
                    msg.missing = bool(ir.read_uvarint())
                else:
                    ir.skip(jw)
            else:
                ir.skip(jw)
        return msg
    raise ValueError("empty statesync message")
