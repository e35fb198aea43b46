"""Minimal protobuf wire-format codec.

The framework's canonical sign-bytes (CanonicalVote / CanonicalProposal /
CanonicalVoteExtension) must be byte-exact with the reference's gogoproto
output (reference: types/canonical.go, proto/tendermint/types/canonical.proto,
libs/protoio/writer.go:93 MarshalDelimited). Rather than depending on
generated bindings, this module hand-rolls the handful of wire rules gogoproto
uses, in ascending-field order, with proto3 omit-if-zero semantics and
gogoproto's always-emit semantics for non-nullable embedded messages.

Wire types: 0=varint, 1=fixed64, 2=length-delimited, 5=fixed32.

The port's copy of the parts of cometbft_tpu/utils/protobuf.py that the
types' sign bytes and protos use.
"""

from __future__ import annotations

import struct

_U64_MASK = (1 << 64) - 1


def encode_uvarint(v: int) -> bytes:
    """Unsigned LEB128 varint."""
    if v < 0:
        raise ValueError("uvarint of negative value")
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def encode_varint_i64(v: int) -> bytes:
    """Protobuf int64/int32 varint: negative values as 64-bit two's complement."""
    return encode_uvarint(v & _U64_MASK)


def decode_uvarint(data: bytes, pos: int = 0) -> tuple[int, int]:
    """Return (value, new_pos). Raises ValueError on truncation/overlong."""
    result = 0
    shift = 0
    while True:
        if pos >= len(data):
            raise ValueError("truncated varint")
        b = data[pos]
        pos += 1
        if shift == 63 and b > 1:
            # 10th byte may only carry the final bit (Go binary.Uvarint
            # overflow rule) — reject values >= 2^64
            raise ValueError("varint overflows uint64")
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 63:
            raise ValueError("varint too long")


def decode_varint_i64(data: bytes, pos: int = 0) -> tuple[int, int]:
    v, pos = decode_uvarint(data, pos)
    if v >= 1 << 63:
        v -= 1 << 64
    return v, pos


class Writer:
    """Appends protobuf fields in the order methods are called.

    Callers are responsible for ascending field order (matching gogoproto's
    MarshalToSizedBuffer output, e.g. canonical.pb.go CanonicalVote)."""

    __slots__ = ("buf",)

    def __init__(self) -> None:
        self.buf = bytearray()

    def _tag(self, field: int, wire: int) -> None:
        self.buf += encode_uvarint(field << 3 | wire)

    # -- scalar fields (proto3: omitted when zero unless always=True) --

    def uvarint(self, field: int, v: int, always: bool = False) -> "Writer":
        if v or always:
            self._tag(field, 0)
            self.buf += encode_uvarint(v)
        return self

    def varint_i64(self, field: int, v: int, always: bool = False) -> "Writer":
        if v or always:
            self._tag(field, 0)
            self.buf += encode_varint_i64(v)
        return self

    def sfixed64(self, field: int, v: int, always: bool = False) -> "Writer":
        """Little-endian two's-complement 8 bytes (canonical height/round)."""
        if v or always:
            self._tag(field, 1)
            self.buf += struct.pack("<q", v)
        return self

    # -- length-delimited fields --

    def bytes(self, field: int, v: bytes, always: bool = False) -> "Writer":
        if v or always:
            self._tag(field, 2)
            self.buf += encode_uvarint(len(v))
            self.buf += v
        return self

    def string(self, field: int, v: str, always: bool = False) -> "Writer":
        return self.bytes(field, v.encode("utf-8"), always)

    def message(self, field: int, body: "bytes | Writer | None",
                always: bool = False) -> "Writer":
        """Embedded message. None → omitted (nullable); empty body with
        always=True → tag + zero length (gogoproto non-nullable)."""
        if body is None:
            if always:
                raise ValueError("always-emit message field got None")
            return self
        if isinstance(body, Writer):
            body = bytes(body.buf)
        if body or always:
            self.bytes(field, body, always=True)
        return self

    def output(self) -> bytes:
        return bytes(self.buf)


def marshal_delimited(body: bytes) -> bytes:
    """Varint length-prefix, matching libs/protoio MarshalDelimited
    (reference: libs/protoio/writer.go:93) used for all sign-bytes."""
    return encode_uvarint(len(body)) + body


class Reader:
    """Field-at-a-time protobuf reader (the types' from_proto)."""

    __slots__ = ("data", "pos", "end")

    def __init__(self, data: bytes, pos: int = 0, end: int | None = None):
        self.data = data
        self.pos = pos
        self.end = len(data) if end is None else end

    def at_end(self) -> bool:
        return self.pos >= self.end

    def read_tag(self) -> tuple[int, int]:
        v, self.pos = decode_uvarint(self.data, self.pos)
        return v >> 3, v & 7

    def read_uvarint(self) -> int:
        v, self.pos = decode_uvarint(self.data, self.pos)
        return v

    def read_varint_i64(self) -> int:
        v, self.pos = decode_varint_i64(self.data, self.pos)
        return v

    def read_bytes(self) -> bytes:
        n = self.read_uvarint()
        if self.pos + n > self.end:
            raise ValueError("truncated bytes field")
        v = self.data[self.pos:self.pos + n]
        self.pos += n
        return bytes(v)

    def read_string(self) -> str:
        return self.read_bytes().decode("utf-8")

    def read_message(self) -> "Reader":
        body = self.read_bytes()
        return Reader(body)

    def read_timestamp(self) -> tuple[int, int]:
        """Parse an embedded google.protobuf.Timestamp field value that was
        written by timestamp_bytes(): returns (seconds, nanos)."""
        tr = self.read_message()
        seconds = nanos = 0
        while not tr.at_end():
            f, w = tr.read_tag()
            if f == 1:
                seconds = tr.read_varint_i64()
            elif f == 2:
                nanos = tr.read_varint_i64()
            else:
                tr.skip(w)
        return seconds, nanos

    def skip(self, wire: int) -> None:
        if wire == 0:
            self.read_uvarint()
        elif wire == 1:
            self.pos += 8
        elif wire == 2:
            self.read_bytes()
        elif wire == 5:
            self.pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")


def timestamp_bytes(seconds: int, nanos: int) -> bytes:
    """google.protobuf.Timestamp encoding (gogoproto StdTimeMarshal):
    field 1 seconds int64 varint, field 2 nanos int32 varint, both
    omitted when zero."""
    w = Writer()
    w.varint_i64(1, seconds)
    w.varint_i64(2, nanos)
    return w.output()
