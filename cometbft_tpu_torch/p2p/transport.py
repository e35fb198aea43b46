"""TCP transport: listen/dial + connection upgrade.

Reference: p2p/transport.go — the MultiplexTransport accepts/dials raw TCP,
then "upgrades": SecretConnection handshake (authenticates the remote
ed25519 key), NodeInfo exchange, and compatibility/identity checks. The
upgraded bundle goes to the Switch to become a Peer.

The port's copy of cometbft_tpu/p2p/transport.py. `fuzz_config=` (a
p2p/fuzz.FuzzConnConfig) wraps every raw connection in the fault injector
before the secret-connection upgrade, as the reference does.
"""

from __future__ import annotations

import asyncio
from dataclasses import dataclass

from cometbft_tpu_torch.libs import chaos
from cometbft_tpu_torch.libs import log as cmtlog
from cometbft_tpu_torch.p2p import netchaos
from cometbft_tpu_torch.p2p.conn.secret_connection import SecretConnection
from cometbft_tpu_torch.p2p.key import NodeKey, node_id_from_pubkey
from cometbft_tpu_torch.p2p.node_info import NodeInfo

HANDSHAKE_TIMEOUT = 10.0


class ErrRejected(Exception):
    """Connection rejected during upgrade (transport.go ErrRejected)."""


@dataclass
class UpgradedConn:
    conn: SecretConnection
    node_info: NodeInfo
    outbound: bool


def parse_addr(addr: str) -> tuple[str, str, int]:
    """'id@host:port' -> (id, host, port); id may be empty."""
    node_id = ""
    if "@" in addr:
        node_id, addr = addr.split("@", 1)
    host, _, port = addr.rpartition(":")
    return node_id, host or "127.0.0.1", int(port)


class Transport:
    def __init__(
        self,
        node_key: NodeKey,
        node_info: NodeInfo,
        logger: cmtlog.Logger | None = None,
        fuzz_config=None,
    ):
        self.node_key = node_key
        self.node_info = node_info
        self.logger = logger or cmtlog.nop()
        # p2p.FuzzConnConfig | None: wrap every raw conn in the fault
        # injector before upgrade (transport.go:221-223 TestFuzz)
        self.fuzz_config = fuzz_config
        # optional (node_id) -> bool ban probe, wired by the Switch: a
        # banned peer is refused at the handshake, so its dialer sees a
        # clean dial failure instead of an add-then-drop conn churn
        self.is_banned = None
        self._server: asyncio.Server | None = None
        self._accept_queue: asyncio.Queue[UpgradedConn] = asyncio.Queue(64)
        # in-flight inbound upgrades: server.close() only stops LISTENING;
        # handlers mid-handshake must be cancelled at close or they leak
        self._inbound_tasks: set[asyncio.Task] = set()

    # ------------------------------------------------------------- listen

    async def listen(self, laddr: str) -> str:
        """Start the TCP listener; returns the bound 'host:port'."""
        _, host, port = parse_addr(laddr)
        self._server = await asyncio.start_server(self._handle_inbound, host, port)
        sock = self._server.sockets[0]
        bound = sock.getsockname()
        addr = f"{bound[0]}:{bound[1]}"
        self.node_info.listen_addr = addr
        self.logger.info("p2p listening", addr=addr)
        return addr

    async def _handle_inbound(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        task = asyncio.current_task()
        if task is not None:
            self._inbound_tasks.add(task)
            task.add_done_callback(self._inbound_tasks.discard)
        try:
            chaos.fire("net.accept")
            up = await asyncio.wait_for(
                self._upgrade(reader, writer, outbound=False, expect_id=""),
                HANDSHAKE_TIMEOUT,
            )
        except asyncio.CancelledError:  # transport closing
            writer.close()
            raise
        except Exception as e:  # noqa: BLE001 - a bad dialer must not kill the listener
            self.logger.info("inbound upgrade failed", err=str(e))
            writer.close()
            return
        try:
            await self._accept_queue.put(up)
        except asyncio.CancelledError:  # cancelled while the queue was full
            up.conn.close()
            raise

    async def accept(self) -> UpgradedConn:
        """Next fully-upgraded inbound connection (transport.go Accept).
        Upgrade failures are logged in _handle_inbound, never surfaced here."""
        return await self._accept_queue.get()

    # --------------------------------------------------------------- dial

    async def dial(self, addr: str) -> UpgradedConn:
        """Dial 'id@host:port' and upgrade (transport.go Dial)."""
        expect_id, host, port = parse_addr(addr)
        chaos.fire("net.dial")
        if expect_id and netchaos.dial_blocked(self.node_key.id(), expect_id):
            raise ErrRejected(f"partitioned from {expect_id[:10]} (net chaos)")
        reader, writer = await asyncio.open_connection(host, port)
        try:
            return await asyncio.wait_for(
                self._upgrade(reader, writer, outbound=True, expect_id=expect_id),
                HANDSHAKE_TIMEOUT,
            )
        except Exception:
            writer.close()
            raise

    # ------------------------------------------------------------ upgrade

    async def _upgrade(
        self,
        reader: asyncio.StreamReader,
        writer: asyncio.StreamWriter,
        outbound: bool,
        expect_id: str,
    ) -> UpgradedConn:
        if self.fuzz_config is not None:
            from cometbft_tpu_torch.p2p.fuzz import fuzz_streams

            reader, writer = fuzz_streams(reader, writer, self.fuzz_config)
        chaos.fire("net.handshake")
        sconn = await SecretConnection.make(reader, writer, self.node_key.priv_key)
        authed_id = node_id_from_pubkey(sconn.remote_pubkey)
        if netchaos.dial_blocked(self.node_key.id(), authed_id):
            raise ErrRejected(
                f"partitioned from {authed_id[:10]} (net chaos)")
        if self.is_banned is not None and self.is_banned(authed_id):
            raise ErrRejected(f"peer {authed_id[:10]} is banned")
        if expect_id and authed_id != expect_id:
            raise ErrRejected(
                f"dialed {expect_id[:10]} but authenticated as {authed_id[:10]}"
            )
        # NodeInfo exchange over the encrypted channel (transport.go:455)
        await sconn.write_msg(self.node_info.encode())
        their_info = NodeInfo.decode(await sconn.read_msg(max_size=10240))
        their_info.validate()
        if their_info.node_id != authed_id:
            raise ErrRejected("node info id does not match authenticated key")
        if their_info.node_id == self.node_info.node_id:
            raise ErrRejected("self connection")
        self.node_info.compatible_with(their_info)
        return UpgradedConn(conn=sconn, node_info=their_info, outbound=outbound)

    def close(self) -> None:
        if self._server is not None:
            self._server.close()
        for t in list(self._inbound_tasks):
            t.cancel()
        # upgraded conns parked in the accept queue would otherwise leak
        # their sockets once nothing will ever accept() them
        while True:
            try:
                self._accept_queue.get_nowait().conn.close()
            except asyncio.QueueEmpty:
                break
