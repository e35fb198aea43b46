"""A small asyncio client of the node's RPC (rpc/server.py of either
package): URI GET, JSON-RPC POST and websocket subscriptions. JAX-free:
chip_smoke.py imports it (it puts tests/ on sys.path) as the tests do.

    env = await get(addr, "/block?height=3")          # the JSON-RPC envelope
    env = await post(addr, "tx_search", {"query": "tx.height = 3"})
    ws = await WS.connect(addr)
    await ws.send({"jsonrpc": "2.0", "id": 1, "method": "subscribe",
                   "params": {"query": "tm.event = 'NewBlock'"}})
    ack = await ws.recv()

`addr` is host:port, as RPCServer.bound_addr gives it.
"""

from __future__ import annotations

import asyncio
import base64
import json
import os


async def _request(addr: str, head: bytes, body: bytes = b"") -> tuple[int, bytes]:
    host, port = addr.removeprefix("tcp://").rsplit(":", 1)
    reader, writer = await asyncio.open_connection(host, int(port))
    try:
        writer.write(head + body)
        await writer.drain()
        raw = await reader.read()
    finally:
        writer.close()
    status, _, payload = raw.partition(b"\r\n\r\n")
    return int(status.split(b" ", 2)[1]), payload


async def get_raw(addr: str, path: str) -> tuple[int, bytes]:
    """GET `path`: the status code and the body's bytes."""
    return await _request(addr, b"GET " + path.encode()
                          + b" HTTP/1.1\r\nHost: x\r\nConnection: close\r\n\r\n")


async def get(addr: str, path: str) -> dict:
    """URI GET (`/route?k=v`): the JSON-RPC envelope."""
    _, payload = await get_raw(addr, path)
    return json.loads(payload)


async def post(addr: str, method: str, params: dict | None = None, rid=1) -> dict:
    """A JSON-RPC 2.0 call in a POST body: the envelope."""
    body = json.dumps({"jsonrpc": "2.0", "id": rid, "method": method,
                       "params": params or {}}).encode()
    _, payload = await _request(addr, b"POST / HTTP/1.1\r\nHost: x\r\nConnection: close\r\n"
                                + b"Content-Type: application/json\r\nContent-Length: "
                                + str(len(body)).encode() + b"\r\n\r\n", body)
    return json.loads(payload)


def b64(tx: bytes) -> str:
    return base64.b64encode(tx).decode()


class WS:
    """A websocket client of /websocket (RFC 6455 text frames, masked)."""

    def __init__(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        self.reader, self.writer = reader, writer

    @classmethod
    async def connect(cls, addr: str) -> "WS":
        host, port = addr.removeprefix("tcp://").rsplit(":", 1)
        reader, writer = await asyncio.open_connection(host, int(port))
        key = base64.b64encode(os.urandom(16)).decode()
        writer.write((f"GET /websocket HTTP/1.1\r\nHost: {addr}\r\nUpgrade: websocket\r\n"
                      f"Connection: Upgrade\r\nSec-WebSocket-Key: {key}\r\n"
                      "Sec-WebSocket-Version: 13\r\n\r\n").encode())
        await writer.drain()
        status = await reader.readline()
        if b" 101 " not in status:
            raise ConnectionError(f"websocket upgrade refused: {status!r}")
        while (await reader.readline()) not in (b"\r\n", b""):
            pass
        return cls(reader, writer)

    async def send(self, obj: dict) -> None:
        payload = json.dumps(obj).encode()
        mask = os.urandom(4)
        masked = bytes(b ^ mask[i % 4] for i, b in enumerate(payload))
        n = len(payload)
        if n < 126:
            head = bytes([0x81, 0x80 | n])
        elif n < 1 << 16:
            head = bytes([0x81, 0x80 | 126]) + n.to_bytes(2, "big")
        else:
            head = bytes([0x81, 0x80 | 127]) + n.to_bytes(8, "big")
        self.writer.write(head + mask + masked)
        await self.writer.drain()

    async def recv(self) -> dict:
        """The next text frame's JSON (control frames are skipped)."""
        while True:
            h = await self.reader.readexactly(2)
            n = h[1] & 0x7F
            if n == 126:
                n = int.from_bytes(await self.reader.readexactly(2), "big")
            elif n == 127:
                n = int.from_bytes(await self.reader.readexactly(8), "big")
            payload = await self.reader.readexactly(n)
            if h[0] & 0x0F == 0x1:
                return json.loads(payload)
            if h[0] & 0x0F == 0x8:
                raise ConnectionError("websocket closed by the server")

    async def subscribe(self, query: str, rid=1) -> dict:
        await self.send({"jsonrpc": "2.0", "id": rid, "method": "subscribe",
                         "params": {"query": query}})
        return await self.recv()

    async def close(self) -> None:
        self.writer.close()
        try:
            await self.writer.wait_closed()
        except (ConnectionError, OSError):
            pass
