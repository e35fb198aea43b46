"""JSON-RPC 2.0 server over HTTP (+ URI GET convenience routes).

Reference: rpc/jsonrpc/server/http_server.go + http_uri_handler.go. A
hand-rolled asyncio HTTP/1.1 server (stdlib-only, like everything else):
POST / with a JSON-RPC envelope, or GET /<route>?k=v with query params —
both hit the same Environment handlers. WebSocket subscriptions arrive
with the pubsub EventBus (rpc/core/events.go analog).

The port's copy of cometbft_tpu/rpc/server.py.
"""

from __future__ import annotations

import asyncio
import base64
import hashlib
import json
import urllib.parse

from cometbft_tpu_torch.libs import log as cmtlog
from cometbft_tpu_torch.libs.service import BaseService, TaskRunner
from cometbft_tpu_torch.rpc.core import Environment, QuotedStr, RPCError, UriStr


class _RawText:
    """Marker for non-JSON HTTP responses (the /metrics exposition)."""

    def __init__(self, text: str):
        self.text = text

MAX_BODY = 1_000_000
MAX_HEADERS = 64

# Overload route classes (libs/overload.py): write routes inject work
# into the node (mempool, evidence) and get the smaller budget; reads
# only serve existing state. Control/ops routes are exempt — an
# operator must be able to ask a saturated node how saturated it is.
WRITE_ROUTES = frozenset({
    "broadcast_tx_async", "broadcast_tx_sync", "broadcast_tx_commit",
    "broadcast_evidence", "check_tx",
})
EXEMPT_ROUTES = frozenset({
    "health", "status", "crypto_health", "storage_health", "net_info",
    "net_telemetry", "dial_seeds", "dial_peers",
})
WS_GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"  # RFC 6455 §1.3
WS_MAX_FRAME = 1 << 20
WS_MAX_MESSAGE = 1 << 21  # aggregate cap across fragments (HTTP has MAX_BODY)


_openapi_cache: str | None = None


def _openapi_spec() -> str:
    global _openapi_cache
    if _openapi_cache is None:
        import os as _os

        path = _os.path.join(
            _os.path.dirname(_os.path.abspath(__file__)), "openapi.yaml")
        with open(path) as f:
            _openapi_cache = f.read()
    return _openapi_cache


class RPCServer(BaseService):
    def __init__(self, node, config, logger: cmtlog.Logger | None = None,
                 env=None):
        """node may be None when `env` supplies the routes (light proxy) —
        then logger is required and node-backed extras (metrics endpoint,
        websocket subscriptions) are disabled."""
        super().__init__("RPC", logger or node.logger.with_fields(module="rpc"))
        self.node = node
        self.config = config
        self.env = env if env is not None else Environment(node)
        self.routes = self.env.routes()
        self._server: asyncio.Server | None = None
        # open client connections, closed on stop: since Python 3.12.1
        # Server.wait_closed waits for every connection, so a websocket
        # or keep-alive client would hold the stop forever
        self._writers: set[asyncio.StreamWriter] = set()
        self.bound_addr = ""
        # overload guard: bounded per-route-class in-flight budgets with
        # a short queue deadline, then shed (-32005 + retry hint). All
        # single-event-loop state — no lock needed.
        self._budgets = {
            "read": getattr(config, "overload_read_inflight", 256),
            "write": getattr(config, "overload_write_inflight", 64),
        }
        self._inflight = {"read": 0, "write": 0}
        self._queue_timeout = getattr(config, "overload_queue_timeout", 0.05)
        self._write_timeout = getattr(config, "slow_client_timeout", 10.0)

    async def on_start(self) -> None:
        addr = self.config.laddr.removeprefix("tcp://")
        host, _, port = addr.rpartition(":")
        self._server = await asyncio.start_server(
            self._handle_conn, host or "127.0.0.1", int(port)
        )
        sock = self._server.sockets[0].getsockname()
        self.bound_addr = f"{sock[0]}:{sock[1]}"
        reg = getattr(self.node, "overload", None)
        if reg is not None:
            reg.register("rpc", self._rpc_utilization)
        self.logger.info("RPC listening", addr=self.bound_addr)

    async def on_stop(self) -> None:
        reg = getattr(self.node, "overload", None)
        if reg is not None:
            reg.unregister("rpc")
        if self._server is not None:
            self._server.close()
            for w in list(self._writers):
                w.close()
            await self._server.wait_closed()
        # env-held services (the light fleet's head watcher) must not
        # outlive the RPC plane
        closer = getattr(self.env, "close", None)
        if closer is not None:
            try:
                await closer()
            except Exception:  # noqa: BLE001 - shutdown is best-effort
                pass

    # ------------------------------------------------------------- serving

    async def _handle_conn(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter) -> None:
        self._writers.add(writer)
        try:
            while True:
                request_line = await reader.readline()
                if not request_line:
                    return
                parts = request_line.decode("latin-1").split()
                if len(parts) != 3:
                    return
                method, target, _version = parts
                headers = {}
                for _ in range(MAX_HEADERS):
                    line = await reader.readline()
                    if line in (b"\r\n", b"\n", b""):
                        break
                    k, _, v = line.decode("latin-1").partition(":")
                    headers[k.strip().lower()] = v.strip()
                if headers.get("upgrade", "").lower() == "websocket":
                    await self._handle_websocket(reader, writer, headers)
                    return
                body = b""
                n = int(headers.get("content-length", 0) or 0)
                if n > MAX_BODY:
                    await self._respond(writer, 413, {"error": "body too large"})
                    return
                if n:
                    body = await reader.readexactly(n)
                keep_alive = headers.get("connection", "").lower() != "close"
                status, payload = await self._dispatch(method, target, body)
                await self._respond(writer, status, payload, keep_alive)
                if not keep_alive:
                    return
        except (asyncio.IncompleteReadError, ConnectionError):
            pass
        except Exception as e:  # noqa: BLE001 - a bad request must not kill the server
            self.logger.error("rpc connection error", err=str(e))
        finally:
            self._writers.discard(writer)
            try:
                writer.close()
            except Exception:  # noqa: BLE001
                pass

    async def _dispatch(self, method: str, target: str, body: bytes):
        if method == "POST":
            try:
                req = json.loads(body or b"{}")
            except json.JSONDecodeError:
                return 400, _err_envelope(None, -32700, "parse error")
            if isinstance(req, list):  # batch
                out = [await self._call_one(r) for r in req]
                return 200, out
            return 200, await self._call_one(req)
        if method == "GET":
            path, _, query = target.partition("?")
            route = path.strip("/")
            if route == "":
                return 200, {"routes": sorted(self.routes)}
            if route == "metrics":
                # Prometheus text exposition (config.instrumentation;
                # reference serves this on prometheus_laddr — one process
                # port here, same scrape contract). The crypto backend-
                # health plane lives in the process-global registry (the
                # device is shared across in-proc nodes) and is appended
                # after the node's own series.
                reg = getattr(self.node, "metrics_registry", None)
                if reg is None:
                    return 404, {"error": "metrics disabled"}
                from cometbft_tpu_torch.libs import metrics as cmtmetrics

                body = reg.render()
                if reg is not cmtmetrics.global_registry():
                    cmtmetrics.crypto_metrics()    # ensure series exist
                    cmtmetrics.netchaos_metrics()  # (net-chaos plane too)
                    cmtmetrics.sched_metrics()     # (verify scheduler)
                    cmtmetrics.light_fleet_metrics()  # (serving plane)
                    cmtmetrics.overload_metrics()  # (overload plane)
                    body += cmtmetrics.global_registry().render()
                return 200, _RawText(body)
            if route == "openapi.yaml":
                # the machine-readable API description (reference:
                # rpc/openapi/openapi.yaml) — immutable at runtime, read
                # once (blocking file I/O must not recur on the event loop)
                return 200, _RawText(_openapi_spec())
            params = {k: v[0] for k, v in urllib.parse.parse_qs(query).items()}
            # quoted URI params are string literals, unquoted hex/number
            # (http_uri_handler.go); keep which on the value so []byte args
            # decode correctly — JSON-body params stay plain str (base64)
            params = {
                k: QuotedStr(v[1:-1]) if len(v) >= 2 and v[0] == v[-1] == '"' else UriStr(v)
                for k, v in params.items()
            }
            envelope = {"jsonrpc": "2.0", "id": -1, "method": route, "params": params}
            return 200, await self._call_one(envelope)
        return 405, {"error": "method not allowed"}

    # ------------------------------------------------------ overload guard

    @staticmethod
    def _route_class(method: str) -> str | None:
        """None = exempt from the overload guard (control plane)."""
        if method in EXEMPT_ROUTES or method.startswith("unsafe_"):
            return None
        return "write" if method in WRITE_ROUTES else "read"

    def _rpc_utilization(self) -> float:
        """The rpc plane's signal for the overload registry: the most
        loaded route class's in-flight fraction."""
        return max(
            (self._inflight[k] / b
             for k, b in self._budgets.items() if b > 0),
            default=0.0)

    async def _admit(self, klass: str) -> bool:
        """Take an in-flight slot for `klass`, waiting out at most the
        queue deadline for one to free. False = shed the request."""
        budget = self._budgets.get(klass, 0)
        if budget <= 0:  # unguarded class (budget disabled)
            self._inflight[klass] = self._inflight.get(klass, 0) + 1
            return True
        if self._inflight[klass] < budget:
            self._inflight[klass] += 1
            return True
        loop = asyncio.get_running_loop()
        deadline = loop.time() + self._queue_timeout
        while loop.time() < deadline:
            await asyncio.sleep(0.005)
            if self._inflight[klass] < budget:
                self._inflight[klass] += 1
                return True
        return False

    def _shed_envelope(self, rid, klass: str) -> dict:
        from cometbft_tpu_torch.libs import overload as _ovl

        reg = getattr(self.node, "overload", None)
        retry = _ovl.RETRY_AFTER_MS[_ovl.SATURATED]
        if reg is not None:
            reg.shed("rpc")
            retry = reg.retry_after_ms("rpc") or retry
        return _err_envelope(
            rid, -32005,
            f"rpc overloaded: {klass} budget exhausted "
            f"({self._budgets[klass]} in flight)",
            {"plane": "rpc", "retry_after_ms": retry})

    async def _call_one(self, req: dict) -> dict:
        rid = req.get("id", -1)
        method = req.get("method", "")
        handler = self.routes.get(method)
        if handler is None:
            return _err_envelope(rid, -32601, f"method {method!r} not found")
        params = req.get("params") or {}
        if not isinstance(params, dict):
            return _err_envelope(rid, -32602, "params must be a map")
        klass = self._route_class(method)
        if klass is not None and not await self._admit(klass):
            return self._shed_envelope(rid, klass)
        try:
            result = await handler(params)
        except RPCError as e:
            return _err_envelope(rid, e.code, str(e),
                                 getattr(e, "data", None))
        except Exception as e:  # noqa: BLE001
            self.logger.error("rpc handler failed", method=method, err=str(e))
            return _err_envelope(rid, -32603, f"internal error: {e}")
        finally:
            if klass is not None:
                self._inflight[klass] -= 1
        return {"jsonrpc": "2.0", "id": rid, "result": result}

    async def _respond(self, writer: asyncio.StreamWriter, status: int,
                       payload, keep_alive: bool = False) -> None:
        if isinstance(payload, _RawText):
            body = payload.text.encode()
            ctype = "text/plain; version=0.0.4"
        else:
            body = json.dumps(payload).encode()
            ctype = "application/json"
        reason = {200: "OK", 400: "Bad Request", 404: "Not Found",
                  405: "Method Not Allowed",
                  413: "Payload Too Large"}.get(status, "Error")
        conn = "keep-alive" if keep_alive else "close"
        head = (
            f"HTTP/1.1 {status} {reason}\r\n"
            f"Content-Type: {ctype}\r\n"
            f"Content-Length: {len(body)}\r\n"
            f"Connection: {conn}\r\n\r\n"
        )
        writer.write(head.encode() + body)
        # slow-client write timeout: a reader that stops draining must
        # not pin this handler (and its response buffer) forever — time
        # the flush out and let the connection-level handler close it
        try:
            await asyncio.wait_for(writer.drain(), self._write_timeout)
        except asyncio.TimeoutError:
            raise ConnectionError(
                "slow client: response flush timed out") from None


    # ---------------------------------------------------------- websocket
    # Reference: rpc/jsonrpc/server/ws_handler.go + rpc/core/events.go —
    # JSON-RPC over an RFC 6455 socket, with subscribe/unsubscribe backed
    # by the EventBus; matching events are pushed as they fire.

    async def _handle_websocket(self, reader, writer, headers) -> None:
        key = headers.get("sec-websocket-key", "")
        if not key:
            await self._respond(writer, 400, {"error": "missing Sec-WebSocket-Key"})
            return
        accept = base64.b64encode(
            hashlib.sha1((key + WS_GUID).encode()).digest()).decode()
        writer.write(
            ("HTTP/1.1 101 Switching Protocols\r\nUpgrade: websocket\r\n"
             f"Connection: Upgrade\r\nSec-WebSocket-Accept: {accept}\r\n\r\n").encode())
        await writer.drain()

        peer = writer.get_extra_info("peername")
        client_id = f"ws-{peer[0]}:{peer[1]}" if peer else f"ws-{id(writer)}"
        tasks = TaskRunner(client_id)
        send_lock = asyncio.Lock()

        async def send_json(payload: dict) -> None:
            async with send_lock:
                await _ws_send(writer, json.dumps(payload).encode())

        try:
            while True:
                opcode, data, controls = await _ws_recv(reader)
                for cop, cdata in controls + [(opcode, data)]:
                    if cop == 0x9:  # ping -> pong
                        async with send_lock:
                            await _ws_send(writer, cdata, opcode=0xA)
                if opcode == 0x8:  # close
                    return
                if opcode not in (0x1, 0x2):
                    continue
                try:
                    req = json.loads(data)
                except json.JSONDecodeError:
                    await send_json(_err_envelope(None, -32700, "parse error"))
                    continue
                await self._ws_call(req, client_id, tasks, send_json)
        except (asyncio.IncompleteReadError, ConnectionError):
            pass
        finally:
            await tasks.cancel_all()
            closer = getattr(self.env, "ws_client_closed", None)
            if closer is not None:
                try:
                    await closer(client_id)
                except Exception:  # noqa: BLE001
                    pass
            try:
                if getattr(self.node, "event_bus", None) is not None:
                    self.node.event_bus.unsubscribe_all(client_id)
            except Exception:  # noqa: BLE001
                pass

    async def _ws_call(self, req: dict, client_id: str, tasks: TaskRunner,
                       send_json) -> None:
        rid = req.get("id", -1)
        method = req.get("method", "")
        params = req.get("params") or {}
        if method in ("light_subscribe", "light_unsubscribe"):
            # the serving plane's streaming route (light/fleet.py):
            # verified headers pushed as heights commit, with
            # backpressure and per-client send budgets enforced by the
            # fleet — independent of the event bus
            handler = getattr(
                self.env,
                "ws_light_subscribe" if method == "light_subscribe"
                else "ws_light_unsubscribe", None)
            if handler is None:
                await send_json(_err_envelope(
                    rid, -32601, "light streaming unavailable on this "
                                 "endpoint"))
                return
            await handler(req, client_id, tasks, send_json)
            return
        bus = getattr(self.node, "event_bus", None)
        if bus is None:
            # node-less servers (light proxy) may relay subscriptions
            # upstream via an env-provided hook
            ws_proxy = getattr(self.env, "ws_passthrough", None)
            if ws_proxy is not None and method in (
                    "subscribe", "unsubscribe", "unsubscribe_all"):
                await ws_proxy(req, client_id, tasks, send_json)
                return
            await send_json(_err_envelope(
                rid, -32601, "subscriptions unavailable on this endpoint"))
            return
        if method == "subscribe":
            query = params.get("query", "")
            if not query:
                await send_json(_err_envelope(rid, -32602, "missing query"))
                return
            if (bus.server.num_client_subscriptions(client_id)
                    >= self.config.max_subscriptions_per_client):
                await send_json(_err_envelope(rid, -32603, "too many subscriptions"))
                return
            try:
                sub = bus.subscribe(client_id, query)
            except Exception as e:  # noqa: BLE001
                await send_json(_err_envelope(rid, -32602, f"subscribe failed: {e}"))
                return
            tasks.spawn(self._pump_events(sub, query, rid, send_json),
                        name=f"ws-sub-{len(query)}")
            await send_json({"jsonrpc": "2.0", "id": rid, "result": {}})
        elif method == "unsubscribe":
            try:
                bus.unsubscribe(client_id, params.get("query", ""))
                await send_json({"jsonrpc": "2.0", "id": rid, "result": {}})
            except Exception as e:  # noqa: BLE001
                await send_json(_err_envelope(rid, -32603, str(e)))
        elif method == "unsubscribe_all":
            try:
                bus.unsubscribe_all(client_id)
            except Exception:  # noqa: BLE001
                pass
            await send_json({"jsonrpc": "2.0", "id": rid, "result": {}})
        else:
            await send_json(await self._call_one(req))

    async def _pump_events(self, sub, query: str, rid, send_json) -> None:
        """events.go:105: forward matching events until cancellation."""
        while True:
            msg = await sub.out.get()
            if msg is None:  # canceled
                # tell the client its subscription died (slow consumer /
                # server shutdown) — a silent stop would leave it waiting
                # forever on a healthy TCP conn (ref ws_handler.go sends
                # the cancellation reason)
                try:
                    await send_json(_err_envelope(
                        f"{rid}#event", -32000,
                        f"subscription canceled: {sub.canceled or 'server closed it'} "
                        f"(query: {query})"))
                except (ConnectionError, asyncio.IncompleteReadError, OSError):
                    pass
                return
            await send_json({
                "jsonrpc": "2.0",
                "id": f"{rid}#event",
                "result": {
                    "query": query,
                    "data": _event_value(msg.data),
                    "events": msg.events,
                },
            })


def _event_value(data) -> dict:
    """Serialize event payloads for RPC consumers (shape follows the
    reference's result_event types loosely)."""
    from cometbft_tpu_torch.abci import codec as abci_codec
    from cometbft_tpu_torch.types import event_bus as eb

    if isinstance(data, eb.EventDataTx):
        return {"type": "tendermint/event/Tx", "value": {
            "TxResult": {
                "height": str(data.height), "index": data.index,
                "tx": base64.b64encode(data.tx).decode(),
                "result": abci_codec._to_jsonable(data.result),
            }}}
    if isinstance(data, eb.EventDataNewBlock):
        blk = data.block
        return {"type": "tendermint/event/NewBlock", "value": {
            "block": {
                "header": {"height": str(blk.header.height),
                           "chain_id": blk.header.chain_id,
                           "app_hash": blk.header.app_hash.hex().upper()},
                "num_txs": str(len(blk.data.txs)),
            }}}
    if isinstance(data, eb.EventDataRoundState):
        return {"type": "tendermint/event/RoundState", "value": {
            "height": str(data.height), "round": data.round_, "step": data.step}}
    return {"type": f"tendermint/event/{type(data).__name__}", "value": {}}


async def _ws_recv(reader) -> tuple[int, bytes, list[tuple[int, bytes]]]:
    """Read one (possibly fragmented) RFC 6455 message from a client.
    Control frames may legally interleave with message fragments
    (RFC 6455 §5.4); they are collected and returned alongside the data
    message so no fragment state is lost. A close control short-circuits.
    Returns (opcode, payload, controls-seen-before-completion)."""
    opcode = None
    buf = b""
    controls: list[tuple[int, bytes]] = []
    while True:
        h = await reader.readexactly(2)
        fin = h[0] & 0x80
        op = h[0] & 0x0F
        masked = h[1] & 0x80
        ln = h[1] & 0x7F
        if ln == 126:
            ln = int.from_bytes(await reader.readexactly(2), "big")
        elif ln == 127:
            ln = int.from_bytes(await reader.readexactly(8), "big")
        if ln > WS_MAX_FRAME or len(buf) + ln > WS_MAX_MESSAGE:
            raise ConnectionError("ws frame/message too large")
        mask = await reader.readexactly(4) if masked else b""
        payload = await reader.readexactly(ln)
        if masked:
            payload = bytes(b ^ mask[i % 4] for i, b in enumerate(payload))
        if op == 0x8:  # close ends everything, fragments moot
            return op, payload, controls
        if op in (0x9, 0xA):
            if opcode is None and not buf:
                return op, payload, controls  # no fragmentation in flight
            controls.append((op, payload))
            continue
        opcode = opcode if op == 0 else op
        buf += payload
        if fin:
            return opcode or 0x1, buf, controls


async def _ws_send(writer, payload: bytes, opcode: int = 0x1) -> None:
    ln = len(payload)
    head = bytes([0x80 | opcode])
    if ln < 126:
        head += bytes([ln])
    elif ln < (1 << 16):
        head += bytes([126]) + ln.to_bytes(2, "big")
    else:
        head += bytes([127]) + ln.to_bytes(8, "big")
    writer.write(head + payload)
    await writer.drain()


def _err_envelope(rid, code: int, message: str, data: dict | None = None) -> dict:
    err: dict = {"code": code, "message": message}
    if data is not None:
        err["data"] = data
    return {"jsonrpc": "2.0", "id": rid, "error": err}
