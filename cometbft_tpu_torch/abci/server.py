"""Socket ABCI server: host an Application out-of-process (asyncio).

Reference: abci/server/socket_server.go. Each connection is served by its
own task; app calls are executed on worker threads under one app-wide lock
(the app is a single non-reentrant state machine).

Wire format is detected per connection from the first byte: the reference's
varint-delimited proto Request stream starts with a nonzero length prefix,
while the framework-native JSON frame starts with a 4-byte big-endian
length whose first byte is zero for any sane frame (<16 MB). A reference
node or abci-cli therefore connects with no configuration. A first byte of
0x00 alone is ambiguous (it is also the varint length of an empty proto
frame), so the detector peeks the next 4 bytes: JSON carries 3 more length
bytes then '{'.

The port's copy of cometbft_tpu/abci/server.py.
"""

from __future__ import annotations

import asyncio
import os
import threading

from cometbft_tpu_torch.abci import codec
from cometbft_tpu_torch.abci import proto_codec
from cometbft_tpu_torch.abci import types as abci
from cometbft_tpu_torch.libs.service import BaseService, TaskRunner


class _PrefixedReader:
    """StreamReader facade replaying bytes the wire autodetector peeked
    past a 0x00 first byte before handing the stream to the proto reader."""

    def __init__(self, reader: asyncio.StreamReader, buf: bytes):
        self._reader = reader
        self._buf = buf

    async def readexactly(self, n: int) -> bytes:
        out = b""
        if self._buf:
            out, self._buf = self._buf[:n], self._buf[n:]
        if len(out) < n:
            out += await self._reader.readexactly(n - len(out))
        return out


class ABCIServer(BaseService):
    def __init__(self, app: abci.Application, addr: str):
        super().__init__("ABCIServer")
        self.app = app
        self.addr = addr
        self.app_lock = threading.Lock()
        self._server: asyncio.AbstractServer | None = None
        self._tasks = TaskRunner("abci-server")
        self._conns: set[asyncio.StreamWriter] = set()

    async def on_start(self) -> None:
        if self.addr.startswith("unix://"):
            path = self.addr[len("unix://"):]
            if os.path.exists(path):
                os.unlink(path)
            self._server = await asyncio.start_unix_server(self._serve, path)
        else:
            host, _, port = self.addr.removeprefix("tcp://").rpartition(":")
            self._server = await asyncio.start_server(
                self._serve, host or "127.0.0.1", int(port)
            )

    def bound_addr(self) -> str:
        """Actual address after bind (useful with tcp port 0)."""
        import socket as socketlib

        assert self._server is not None
        sock = self._server.sockets[0]
        if sock.family == getattr(socketlib, "AF_UNIX", None):
            return self.addr
        host, port = sock.getsockname()[:2]
        return f"tcp://{host}:{port}"

    async def _serve(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter) -> None:
        self._conns.add(writer)
        try:
            try:
                first = await reader.readexactly(1)
                if first == b"\x00":
                    # Ambiguous first byte: a JSON frame's 4-byte BE length
                    # starts 0x00 for bodies < 2^24, but 0x00 is also the
                    # varint length of an empty proto frame. JSON carries 3
                    # more length bytes then '{' — peek them to decide.
                    peek = await reader.readexactly(4)
                    if peek[3:4] == b"{":
                        wire = codec
                        read_req = self._json_reader(reader, first + peek)
                    else:
                        wire = proto_codec
                        read_req = self._proto_reader(
                            _PrefixedReader(reader, peek), first)
                else:
                    wire = proto_codec
                    read_req = self._proto_reader(reader, first)
            except (asyncio.IncompleteReadError, ConnectionError):
                return
            while self.is_running:
                try:
                    method, req = await read_req()
                except (EOFError, asyncio.IncompleteReadError, ConnectionError):
                    return
                if method == "echo":
                    writer.write(wire.encode_response("echo", abci.ResponseEcho(message=req.message)))
                elif method == "flush":
                    writer.write(wire.encode_response("flush", abci.ResponseFlush()))
                else:
                    try:
                        resp = await self._dispatch(method, req)
                        writer.write(wire.encode_response(method, resp))
                    except Exception as e:  # noqa: BLE001 - report to client
                        writer.write(wire.encode_exception(f"{type(e).__name__}: {e}"))
                await writer.drain()
        finally:
            self._conns.discard(writer)
            writer.close()

    @staticmethod
    def _json_reader(reader, consumed: bytes):
        """consumed: the 5 autodetection bytes (4-byte BE length + the
        leading '{' of the body)."""
        state = {"consumed": consumed}

        async def read():
            if state["consumed"] is not None:
                import json as _json
                import struct as _struct

                buf = state["consumed"]
                state["consumed"] = None
                (n,) = _struct.unpack(">I", buf[:4])
                raw = buf[4:] + await reader.readexactly(n - 1)
                return codec._decode_request_body(_json.loads(raw))
            return await codec.decode_request_async(reader)

        return read

    @staticmethod
    def _proto_reader(reader, first: bytes):
        """first: the single already-consumed varint byte (0x00 here means
        an empty proto frame — the autodetector's peeked bytes ride a
        _PrefixedReader so the next frame is not lost)."""
        state = {"first": first}

        async def read():
            while True:
                pre, state["first"] = state["first"] or b"", None
                data = await proto_codec.read_delimited_async(
                    reader, first_byte=pre)
                if data:
                    return proto_codec.decode_request_bytes(data)
                # zero-length frame (an empty Request): nothing to serve,
                # keep the stream aligned and read the next frame

        return read

    async def _dispatch(self, method: str, req):
        def run():
            with self.app_lock:
                return getattr(self.app, method)(req)

        return await asyncio.to_thread(run)

    async def on_stop(self) -> None:
        if self._server is not None:
            self._server.close()
            # Python 3.12 wait_closed() also waits for per-connection
            # handlers; close live client connections so an app-side stop
            # never hangs on an idle client
            for w in list(self._conns):
                w.close()
            await self._server.wait_closed()
        await self._tasks.cancel_all()
