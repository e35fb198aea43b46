"""Multiplexed message connection.

Reference: p2p/conn/connection.go:81-157 — N logical channels (byte IDs
with priorities and bounded send queues) multiplexed onto one encrypted
stream. A send task drains channel queues packet-by-packet, picking the
channel with the lowest sent-bytes/priority ratio (connection.go:693-719
sendPacketMsg "least ratio" scheduling); a recv task reassembles PacketMsg
chunks per channel and hands complete messages to the owning reactor.
Ping/pong keepalive (connection.go:429-520) and token-bucket rate limiting
via libs/flowrate (connection.go:44-45).

Wire: varint-length-delimited protobuf Packet envelopes
(proto/tendermint/p2p/conn.proto shape): oneof ping=1 / pong=2 /
msg=3{channel_id=1, eof=2, data=3}.

Wire-plane accounting (framework extension): every connection keeps
per-channel byte/message/packet counters for both directions, send-queue
depth high-water marks, send-routine stall time (rate-limit sleeps +
blocked socket writes), and a ping-RTT EWMA — surfaced via status(), the
net_telemetry RPC route, and (through the owning Switch's P2PMetrics)
bounded-cardinality Prometheus series. The flowrate monitors are ALWAYS
updated, throttling or not: rate_limit=0 keeps them non-throttling, so
accounting never depends on rate limiting being enabled.

The port's copy of cometbft_tpu/p2p/conn/connection.py.
"""

from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass
from typing import Awaitable, Callable, Optional

from cometbft_tpu_torch.libs import linkmodel
from cometbft_tpu_torch.libs import log as cmtlog
from cometbft_tpu_torch.libs.flowrate import Monitor
from cometbft_tpu_torch.libs.service import TaskRunner
from cometbft_tpu_torch.utils.protobuf import Reader, Writer, decode_uvarint, encode_uvarint


@dataclass
class MConnConfig:
    send_rate: int = 5_120_000  # bytes/sec (config.go DefaultP2PConfig)
    recv_rate: int = 5_120_000
    max_packet_msg_payload_size: int = 1024
    flush_throttle: float = 0.1  # connection.go:39 (100ms)
    ping_interval: float = 30.0
    pong_timeout: float = 45.0
    send_timeout: float = 10.0  # connection.go defaultSendTimeout


@dataclass
class ChannelDescriptor:
    id: int
    priority: int = 1
    send_queue_capacity: int = 64
    recv_message_capacity: int = 1 << 22  # 4 MB


class _Channel:
    def __init__(self, desc: ChannelDescriptor, max_payload: int):
        self.desc = desc
        self.max_payload = max_payload
        self.send_queue: asyncio.Queue[bytes] = asyncio.Queue(desc.send_queue_capacity)
        self.sending: bytes = b""  # partially-sent message
        self.sent_pos = 0
        self.recently_sent = 0  # decayed sent-bytes counter for scheduling
        self.recving = bytearray()
        # wire accounting (monotonic counters; bytes are WIRE bytes — the
        # encoded packet envelope, so per-channel sums match the flowrate
        # monitor totals and the actual conn-seam traffic)
        self.send_bytes = 0
        self.send_msgs = 0
        self.send_packets = 0
        self.recv_bytes = 0
        self.recv_msgs = 0
        self.recv_packets = 0
        self.queue_hwm = 0  # send-queue depth high-water mark

    def note_queued(self) -> None:
        depth = self.send_queue.qsize()
        if depth > self.queue_hwm:
            self.queue_hwm = depth

    def has_data(self) -> bool:
        return bool(self.sending) or not self.send_queue.empty()

    def next_packet(self) -> tuple[bytes, bool]:
        """Pop the next <=max_payload chunk + eof flag."""
        if not self.sending:
            self.sending = self.send_queue.get_nowait()
            self.sent_pos = 0
        chunk = self.sending[self.sent_pos : self.sent_pos + self.max_payload]
        self.sent_pos += len(chunk)
        eof = self.sent_pos >= len(self.sending)
        if eof:
            self.sending = b""
            self.sent_pos = 0
            self.send_msgs += 1
        self.send_packets += 1
        self.recently_sent += len(chunk)
        return chunk, eof


class MConnection:
    """One per peer. on_receive(chan_id, msg_bytes) is awaited on the recv
    task; keep it fast (reactors should queue internally)."""

    def __init__(
        self,
        conn,  # SecretConnection (or any object with write/read_msg-like API)
        channels: list[ChannelDescriptor],
        on_receive: Callable[[int, bytes], Awaitable[None]],
        on_error: Callable[[Exception], Awaitable[None]],
        config: MConnConfig | None = None,
        logger: cmtlog.Logger | None = None,
        metrics=None,  # libs.metrics.P2PMetrics | None
        peer_label: str = "",  # pre-capped metrics label for this peer
        peer_id: str = "",  # node id, keys the clock-skew table
    ):
        self.config = config or MConnConfig()
        self._conn = conn
        self._channels = {
            d.id: _Channel(d, self.config.max_packet_msg_payload_size) for d in channels
        }
        self._on_receive = on_receive
        self._on_error = on_error
        self.logger = logger or cmtlog.nop()
        self._send_wake = asyncio.Event()
        self._pong_pending = False
        self._pong_received = asyncio.Event()
        self._send_monitor = Monitor(self.config.send_rate)
        self._recv_monitor = Monitor(self.config.recv_rate)
        self._tasks = TaskRunner("mconn")
        self._stopped = False  # no new sends / no more error callbacks
        self._torn_down = False  # tasks cancelled + socket closed
        self.metrics = metrics
        self.peer_label = peer_label
        # send-routine stall accounting: seconds the routine spent NOT
        # idle-parked — asleep on the rate limiter or blocked in a socket
        # write (TCP backpressure); the "is the wire the bottleneck"
        # number for this peer
        self._stall_rate_limit_s = 0.0
        self._stall_write_s = 0.0
        # ping RTT EWMA (alpha 0.2) + last sample; feeds the process-wide
        # p2p link model for net_telemetry
        self._ping_rtt_s = 0.0
        self._ping_rtt_last_s = 0.0
        self._ping_samples = 0
        # clock-skew sampling: the last pong's remote wall stamp, consumed
        # by the ping routine against its own wall t0 + rtt/2
        self.peer_id = peer_id
        self._last_pong_wall_ns = 0

    # ----------------------------------------------------------- lifecycle

    def start(self) -> None:
        self._tasks.spawn(self._send_routine(), name="mconn-send")
        self._tasks.spawn(self._recv_routine(), name="mconn-recv")
        self._tasks.spawn(self._ping_routine(), name="mconn-ping")

    async def stop(self) -> None:
        """Idempotent teardown. _error() marks the conn stopped but must NOT
        skip this cleanup: the owning Peer always calls stop() afterwards to
        cancel tasks and close the socket."""
        self._stopped = True
        if self._torn_down:
            return
        self._torn_down = True
        await self._tasks.cancel_all()
        self._conn.close()

    # ---------------------------------------------------------------- send

    async def send(self, chan_id: int, msg: bytes) -> bool:
        """Queue msg on the channel; blocks when the queue is full, but only
        up to send_timeout (connection.go:287 Send + defaultSendTimeout) so a
        caller never hangs on a dead peer's full queue."""
        ch = self._channels.get(chan_id)
        if ch is None or self._stopped:
            return False
        try:
            await asyncio.wait_for(ch.send_queue.put(msg), self.config.send_timeout)
        except asyncio.TimeoutError:
            return False
        ch.note_queued()
        self._send_wake.set()
        return True

    def try_send(self, chan_id: int, msg: bytes) -> bool:
        """Non-blocking send; False when the queue is full
        (connection.go:311 TrySend)."""
        ch = self._channels.get(chan_id)
        if ch is None or self._stopped:
            return False
        try:
            ch.send_queue.put_nowait(msg)
        except asyncio.QueueFull:
            return False
        ch.note_queued()
        self._send_wake.set()
        return True

    def _pick_channel(self) -> Optional[_Channel]:
        """Least recently_sent/priority ratio among channels with data
        (connection.go:693-719)."""
        best, best_ratio = None, None
        for ch in self._channels.values():
            if not ch.has_data():
                continue
            ratio = ch.recently_sent / max(ch.desc.priority, 1)
            if best_ratio is None or ratio < best_ratio:
                best, best_ratio = ch, ratio
        return best

    async def _send_routine(self) -> None:
        try:
            while True:
                ch = self._pick_channel()
                if ch is None and not self._pong_pending:
                    # idle: park on the wake event (no polling; try_send /
                    # send / ping-receipt set it)
                    self._send_wake.clear()
                    if self._pick_channel() is None and not self._pong_pending:
                        await self._send_wake.wait()
                    continue
                batch = bytearray()
                if self._pong_pending:
                    # stamp our wall clock into the pong so the pinger can
                    # estimate clock skew from the RTT midpoint
                    batch += _encode_packet_pong(time.time_ns())
                    self._pong_pending = False
                # coalesce a few packets per flush (the reference's
                # 100ms flush throttle analog — we flush per loop, batching
                # whatever is ready)
                n_packets = 0
                flushed: dict[int, tuple[int, int]] = {}  # cid -> (bytes, msgs)
                while ch is not None and n_packets < 16:
                    chunk, eof = ch.next_packet()
                    pkt = _encode_packet_msg(ch.desc.id, eof, chunk)
                    ch.send_bytes += len(pkt)
                    b, m = flushed.get(ch.desc.id, (0, 0))
                    flushed[ch.desc.id] = (b + len(pkt), m + (1 if eof else 0))
                    batch += pkt
                    n_packets += 1
                    ch = self._pick_channel()
                if batch:
                    # ALWAYS update the monitor (rate_limit=0 keeps it
                    # non-throttling): accounting must not depend on
                    # throttling being enabled
                    delay = self._send_monitor.update(len(batch))
                    if delay > 0:
                        self._stall_rate_limit_s += delay
                        await asyncio.sleep(delay)
                    t0 = time.monotonic()
                    await self._conn.write(bytes(batch))
                    self._stall_write_s += time.monotonic() - t0
                    self._flush_metrics(flushed, send=True)
                # decay scheduling counters
                for c in self._channels.values():
                    c.recently_sent = int(c.recently_sent * 0.8)
        except asyncio.CancelledError:
            raise
        except Exception as e:  # noqa: BLE001
            await self._error(e)

    def _flush_metrics(self, per_chan: dict, send: bool) -> None:
        """Hand aggregated per-channel (bytes, msgs) deltas to the owning
        switch's P2PMetrics (bounded-cardinality peer labels live there).
        Metrics failures must never error a connection."""
        m = self.metrics
        if m is None or not per_chan:
            return
        try:
            m.record_conn_traffic(self.peer_label, per_chan, send=send)
        except Exception:  # noqa: BLE001
            pass

    # ---------------------------------------------------------------- recv

    async def _recv_routine(self) -> None:
        # metric deltas accumulate here and flush on message boundaries
        # (or every 32 packets mid-message) — the recv hot loop must not
        # pay two locked counter updates per 1 KB packet when the send
        # side batches up to 16 packets per flush
        pending: dict[int, tuple[int, int]] = {}
        pending_packets = 0
        try:
            while True:
                packet, wire_len = await self._read_packet()
                # ALWAYS update (accounting without throttling — see send);
                # wire_len includes the varint length prefix, matching the
                # sender's encoded-packet accounting byte for byte
                delay = self._recv_monitor.update(wire_len)
                if delay > 0:
                    await asyncio.sleep(delay)
                kind, chan_id, eof, data, pong_wall = _decode_packet(packet)
                if kind == 1:  # ping
                    self._pong_pending = True
                    self._send_wake.set()
                elif kind == 2:  # pong
                    # an extended pong carries the responder's wall clock
                    # for the skew estimator (0 from old senders)
                    self._last_pong_wall_ns = pong_wall
                    self._pong_received.set()
                elif kind == 3:
                    ch = self._channels.get(chan_id)
                    if ch is None:
                        raise ValueError(f"unknown channel {chan_id:#x}")
                    ch.recv_bytes += wire_len
                    ch.recv_packets += 1
                    ch.recving += data
                    if len(ch.recving) > ch.desc.recv_message_capacity:
                        raise ValueError(
                            f"recv message exceeds capacity on channel {chan_id:#x}"
                        )
                    b, m = pending.get(chan_id, (0, 0))
                    pending[chan_id] = (b + wire_len, m + (1 if eof else 0))
                    pending_packets += 1
                    if eof:
                        ch.recv_msgs += 1
                        msg = bytes(ch.recving)
                        ch.recving.clear()
                        self._flush_metrics(pending, send=False)
                        pending = {}
                        pending_packets = 0
                        await self._on_receive(chan_id, msg)
                    elif pending_packets >= 32:
                        self._flush_metrics(pending, send=False)
                        pending = {}
                        pending_packets = 0
        except asyncio.CancelledError:
            raise
        except Exception as e:  # noqa: BLE001
            await self._error(e)

    async def _read_packet(self) -> tuple[bytes, int]:
        """Read one varint-delimited packet from the secret connection.
        Returns (body, wire_len) where wire_len includes the length
        prefix — the recv accounting must match the sender's
        encoded-packet byte counts, not undercount by the varint."""
        # read varint length byte-by-byte (<=5 bytes for our sizes)
        hdr = b""
        while True:
            b = await self._conn.readexactly(1)
            hdr += b
            if not b[0] & 0x80:
                break
            if len(hdr) > 5:
                raise ValueError("packet length varint too long")
        n, _ = decode_uvarint(hdr)
        if n > self.config.max_packet_msg_payload_size + 64:
            raise ValueError(f"packet too large: {n}")
        return await self._conn.readexactly(n), len(hdr) + n

    async def _ping_routine(self) -> None:
        """Keepalive + dead-peer detection: a ping that is not answered
        within pong_timeout errors the connection (connection.go:429-520
        pongTimeoutCh)."""
        while True:
            await asyncio.sleep(self.config.ping_interval)
            try:
                self._pong_received.clear()
                self._last_pong_wall_ns = 0
                ping = _encode_packet_ping()
                self._send_monitor.update(len(ping))  # keepalives count too
                t0 = time.monotonic()
                t0_wall = time.time_ns()
                await self._conn.write(ping)
                try:
                    await asyncio.wait_for(
                        self._pong_received.wait(), self.config.pong_timeout
                    )
                except asyncio.TimeoutError:
                    raise ConnectionError("pong timeout") from None
                rtt = time.monotonic() - t0
                self._note_ping_rtt(rtt)
                if self._last_pong_wall_ns and self.peer_id:
                    # RTT-midpoint skew sample: the responder stamped its
                    # wall clock; ours at the midpoint is t0 + rtt/2
                    linkmodel.skew().observe_ping(
                        self.peer_id, self._last_pong_wall_ns,
                        t0_wall + int(rtt * 5e8), rtt)
            except asyncio.CancelledError:
                raise
            except Exception as e:  # noqa: BLE001
                await self._error(e)
                return

    def _note_ping_rtt(self, rtt: float) -> None:
        """Ping->pong round trip: EWMA per peer + the process-wide p2p
        link model (net_telemetry's aggregate view). The pong rode the
        send routine's batching, so this is an upper bound on the raw
        link RTT — which is the honest number for protocol planning: a
        vote pays the same queueing."""
        self._ping_rtt_last_s = rtt
        self._ping_samples += 1
        self._ping_rtt_s = (rtt if self._ping_samples == 1
                            else self._ping_rtt_s + 0.2 * (rtt - self._ping_rtt_s))
        linkmodel.p2p().observe_rtt(rtt)
        m = self.metrics
        if m is not None:
            try:
                m.peer_ping_rtt.labels(self.peer_label or "other").set(rtt)
            except Exception:  # noqa: BLE001
                pass

    async def _error(self, e: Exception) -> None:
        if self._stopped:
            return
        self._stopped = True
        try:
            await self._on_error(e)
        except Exception:  # noqa: BLE001 - error path must not raise
            pass

    # ---------------------------------------------------------------- misc

    def status(self) -> dict:
        """Connection status incl. the wire-plane accounting: monitor
        totals/averages, per-channel byte/msg/packet counters both ways,
        queue depth + high-water, send-routine stall split, ping RTT EWMA.
        net_info / net_telemetry serve this per peer."""
        return {
            "send_rate": self._send_monitor.rate(),
            "recv_rate": self._recv_monitor.rate(),
            "send": self._send_monitor.stats(),
            "recv": self._recv_monitor.stats(),
            "send_stall_seconds": round(
                self._stall_rate_limit_s + self._stall_write_s, 6),
            "send_stall_split_seconds": {
                "rate_limit": round(self._stall_rate_limit_s, 6),
                "socket_write": round(self._stall_write_s, 6),
            },
            "ping_rtt_ms": round(self._ping_rtt_s * 1e3, 3),
            "ping_rtt_last_ms": round(self._ping_rtt_last_s * 1e3, 3),
            "ping_samples": self._ping_samples,
            "channels": {
                f"{cid:#x}": {
                    "queued": ch.send_queue.qsize(),
                    "queue_hwm": ch.queue_hwm,
                    "recently_sent": ch.recently_sent,
                    "send_bytes": ch.send_bytes,
                    "send_msgs": ch.send_msgs,
                    "send_packets": ch.send_packets,
                    "recv_bytes": ch.recv_bytes,
                    "recv_msgs": ch.recv_msgs,
                    "recv_packets": ch.recv_packets,
                }
                for cid, ch in self._channels.items()
            },
        }


# ------------------------------------------------------------- packet codec


def _encode_packet_ping() -> bytes:
    body = Writer().message(1, b"", always=True).output()
    return encode_uvarint(len(body)) + body


def _encode_packet_pong(wall_ns: int = 0) -> bytes:
    """Pong, optionally carrying the responder's wall clock (uvarint
    field 1 of the pong submessage). Forward-compatible: old decoders
    skip the submessage content of fields 1/2, so an extended pong reads
    as a plain pong to them."""
    inner = Writer().uvarint(1, wall_ns).output() if wall_ns else b""
    body = Writer().message(2, inner, always=True).output()
    return encode_uvarint(len(body)) + body


def _encode_packet_msg(chan_id: int, eof: bool, data: bytes) -> bytes:
    inner = Writer().uvarint(1, chan_id).bool(2, eof).bytes(3, data).output()
    body = Writer().message(3, inner, always=True).output()
    return encode_uvarint(len(body)) + body


def _decode_packet(body: bytes) -> tuple[int, int, bool, bytes, int]:
    """Return (kind, chan_id, eof, data, pong_wall_ns); kind 1=ping
    2=pong 3=msg. pong_wall_ns is the responder clock an extended pong
    carried (0 for a plain pong or any other packet kind)."""
    r = Reader(body)
    kind = chan_id = 0
    eof = False
    data = b""
    pong_wall_ns = 0
    while not r.at_end():
        f, w = r.read_tag()
        if f == 1:
            r.skip(w)
            kind = f
        elif f == 2:
            kind = f
            mr = r.read_message()
            while not mr.at_end():
                mf, mw = mr.read_tag()
                if mf == 1:
                    pong_wall_ns = mr.read_uvarint()
                else:
                    mr.skip(mw)
        elif f == 3:
            kind = 3
            mr = r.read_message()
            while not mr.at_end():
                mf, mw = mr.read_tag()
                if mf == 1:
                    chan_id = mr.read_uvarint()
                elif mf == 2:
                    eof = mr.read_uvarint() != 0
                elif mf == 3:
                    data = mr.read_bytes()
                else:
                    mr.skip(mw)
        else:
            r.skip(w)
    if kind == 0:
        raise ValueError("empty packet")
    return kind, chan_id, eof, data, pong_wall_ns
