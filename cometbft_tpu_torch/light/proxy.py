"""Light-client proxy: a local RPC endpoint whose answers are VERIFIED.

Reference: light/proxy/proxy.go:20-80 + light/rpc/client.go — the
`cometbft light <chainID> --primary --witness ...` daemon. Every block-ish
route answers from (or is cross-checked against) a light-client-verified
header chain:

  - light_block / header / header_by_hash / commit / validators answer
    straight from verified light blocks (bisection against the primary,
    divergence cross-check against witnesses — light/client.py);
  - block / block_by_hash fetch the raw block from the primary, then prove
    the payload against the VERIFIED header: the tx set must hash to the
    verified data_hash, and the served header IS the verified one — a lying
    primary cannot alter a single byte of what this proxy returns;
  - broadcast_tx_* / abci_query / status pass through to the primary,
    marked unverified (abci_query proof-op verification is app-specific;
    the reference's KeyPathFn hook is likewise opt-in).

A primary caught lying fails verification (wrong commit signatures over a
forged header → ErrVerification; conflicting-but-valid headers → witness
divergence handling with attack evidence, light/client.py:298-380); the
proxy surfaces the error instead of the forged data.

Serving plumbing reuses rpc/server.RPCServer with this module's route
table (no node behind it). Websocket subscriptions are RELAYED to the
primary's /websocket endpoint (reference: light/proxy/proxy.go wires the
node's event routes through light/rpc.Client): subscribe/unsubscribe and
the resulting event stream pass through UNVERIFIED — like the reference,
event payloads carry no commit proof; verified state always comes from
the block-ish routes above.

The port's copy of cometbft_tpu/light/proxy.py.
"""

from __future__ import annotations

import asyncio
import base64
import hashlib
import json
import os
import urllib.parse
import urllib.request

from cometbft_tpu_torch.libs import log as cmtlog
from cometbft_tpu_torch.libs.service import BaseService
from cometbft_tpu_torch.light.rpc_provider import normalize_rpc_url
from cometbft_tpu_torch.rpc.core import RPCError, _b64, _hex, header_dict
from cometbft_tpu_torch.rpc.server import RPCServer
from cometbft_tpu_torch.types.block import Data


class _PrimaryRPC:
    """Raw JSON-RPC calls to the primary node (unverified plane). Uses
    POST with a JSON-RPC body so params keep their exact JSON types — a
    GET re-encode would strip quoting and retype base64/bool params on the
    primary's URI handler."""

    def __init__(self, base_url: str, timeout: float = 10.0):
        self.base_url = normalize_rpc_url(base_url)
        self.timeout = timeout

    async def call(self, route: str, params: dict | None = None) -> dict:
        body = json.dumps({
            "jsonrpc": "2.0", "id": 1, "method": route,
            "params": params or {},
        }).encode()

        def _post():
            req = urllib.request.Request(
                self.base_url + "/", data=body,
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=self.timeout) as r:
                return json.load(r)

        doc = await asyncio.to_thread(_post)
        if "error" in doc:
            e = doc["error"]
            raise RPCError(e.get("code", -32603), f"primary: {e.get('message', '')}")
        return doc["result"]


class _UpstreamWS:
    """Minimal RFC 6455 client to the primary's /websocket endpoint
    (client->server frames masked, as the RFC requires)."""

    def __init__(self, base_url: str):
        u = urllib.parse.urlparse(normalize_rpc_url(base_url))
        if u.scheme in ("https", "wss"):
            # this client speaks plaintext only; silently opening a clear
            # socket to an https primary would leak the relay's traffic
            raise ValueError(
                f"light proxy: TLS primaries are not supported for the "
                f"websocket relay (got {base_url!r}); use an http:// "
                "primary or terminate TLS in front of the proxy")
        self.host = u.hostname or "127.0.0.1"
        self.port = u.port or 80
        self.reader: asyncio.StreamReader | None = None
        self.writer: asyncio.StreamWriter | None = None

    async def connect(self, timeout: float = 10.0) -> None:
        self.reader, self.writer = await asyncio.wait_for(
            asyncio.open_connection(self.host, self.port), timeout)
        key = base64.b64encode(os.urandom(16)).decode()
        self.writer.write(
            (f"GET /websocket HTTP/1.1\r\nHost: {self.host}:{self.port}\r\n"
             "Upgrade: websocket\r\nConnection: Upgrade\r\n"
             f"Sec-WebSocket-Key: {key}\r\nSec-WebSocket-Version: 13\r\n"
             "\r\n").encode())
        await self.writer.drain()
        status = await self.reader.readline()
        if b"101" not in status:
            raise ConnectionError(f"ws upgrade rejected: {status!r}")
        from cometbft_tpu_torch.rpc.server import WS_GUID

        want = base64.b64encode(
            hashlib.sha1((key + WS_GUID).encode()).digest()).decode()
        accept = ""
        while True:
            line = await self.reader.readline()
            if line in (b"\r\n", b""):
                break
            name, _, val = line.decode().partition(":")
            if name.strip().lower() == "sec-websocket-accept":
                accept = val.strip()
        if accept != want:
            raise ConnectionError("ws upgrade: bad Sec-WebSocket-Accept")

    async def send_json(self, payload: dict) -> None:
        data = json.dumps(payload).encode()
        mask = os.urandom(4)
        ln = len(data)
        head = b"\x81"  # FIN + text
        if ln < 126:
            head += bytes([0x80 | ln])
        elif ln < (1 << 16):
            head += bytes([0x80 | 126]) + ln.to_bytes(2, "big")
        else:
            head += bytes([0x80 | 127]) + ln.to_bytes(8, "big")
        body = bytes(b ^ mask[i % 4] for i, b in enumerate(data))
        self.writer.write(head + mask + body)
        await self.writer.drain()

    async def recv_json(self) -> dict | None:
        """Next data message as JSON; None on close. Server frames are
        unmasked; rpc/server._ws_recv handles either."""
        from cometbft_tpu_torch.rpc.server import _ws_recv

        while True:
            opcode, data, _controls = await _ws_recv(self.reader)
            if opcode == 0x8:
                return None
            if opcode in (0x1, 0x2):
                return json.loads(data)

    def close(self) -> None:
        if self.writer is not None:
            self.writer.close()
            self.writer = None


class ProxyEnv:
    """Route environment for the verified proxy (mirrors rpc/core
    Environment's handler signature: async fn(params) -> result dict)."""

    def __init__(self, client, primary_url: str):
        self.client = client  # light.Client
        self.primary = _PrimaryRPC(primary_url)
        self.primary_url = primary_url
        self._upstreams: dict[str, _UpstreamWS] = {}
        # fail at construction, not inside some client's first ws
        # subscribe: the websocket relay cannot speak TLS (_UpstreamWS
        # raises the same error as defense in depth)
        if urllib.parse.urlparse(
                normalize_rpc_url(primary_url)).scheme in ("https", "wss"):
            raise ValueError(
                f"light proxy: TLS primaries are not supported for the "
                f"websocket relay (got {primary_url!r}); use an http:// "
                "primary or terminate TLS in front of the proxy")

    async def _verified(self, params: dict):
        h = params.get("height")
        if h in (None, ""):
            lb = await self.client.update()
            if lb is None:
                lb = self.client.store.latest_light_block()
            if lb is None:
                raise RPCError(-32603, "no trusted light block yet")
            return lb
        return await self.client.verify_light_block_at_height(int(h))

    # ------------------------------------------------------ verified plane

    async def light_block(self, params: dict) -> dict:
        lb = await self._verified(params)
        return {"height": str(lb.height), "light_block": _b64(lb.to_proto())}

    async def header(self, params: dict) -> dict:
        lb = await self._verified(params)
        return {"header": header_dict(lb.signed_header.header)}

    async def header_by_hash(self, params: dict) -> dict:
        want = bytes.fromhex(params["hash"])
        lb = self.client.store.light_block_by_hash(want)
        if lb is None:
            raise RPCError(-32603, "header not found among trusted light blocks")
        return {"header": header_dict(lb.signed_header.header)}

    @staticmethod
    def _commit_dict(c) -> dict:
        return {
            "height": str(c.height),
            "round": c.round_,
            "block_id": {
                "hash": _hex(c.block_id.hash),
                "parts": {
                    "total": c.block_id.part_set_header.total,
                    "hash": _hex(c.block_id.part_set_header.hash)},
            },
            "signatures": [
                {
                    "block_id_flag": int(cs.block_id_flag),
                    "validator_address": _hex(cs.validator_address),
                    "timestamp": str(cs.timestamp),
                    "signature": _b64(cs.signature) if cs.signature else None,
                }
                for cs in c.signatures
            ],
        }

    async def commit(self, params: dict) -> dict:
        lb = await self._verified(params)
        return {
            "canonical": True,
            "signed_header": {
                "header": header_dict(lb.signed_header.header),
                "commit": self._commit_dict(lb.signed_header.commit),
            },
        }

    async def validators(self, params: dict) -> dict:
        lb = await self._verified(params)
        return {
            "block_height": str(lb.height),
            "validators": [
                {
                    "address": _hex(v.address),
                    "pub_key": {"type": v.pub_key.type_(),
                                "value": _b64(v.pub_key.bytes_())},
                    "voting_power": str(v.voting_power),
                    "proposer_priority": str(v.proposer_priority),
                }
                for v in lb.validator_set.validators
            ],
            "count": str(len(lb.validator_set.validators)),
            "total": str(len(lb.validator_set.validators)),
        }

    async def block(self, params: dict) -> dict:
        """Raw block from the primary, proven against the verified header:
        served header = verified header; primary txs must hash to its
        data_hash; last_commit is the VERIFIED commit for height-1 (block
        h's last_commit IS the canonical commit for h-1, which the light
        chain already carries), cross-checked against last_commit_hash.
        Evidence entries pass through as unverified summaries (they are
        summaries on the node RPC too; the evidence_hash in the verified
        header is the authoritative statement)."""
        lb = await self._verified(params)
        raw = await self.primary.call("block", {"height": str(lb.height)})
        txs = [base64.b64decode(t) for t in raw["block"]["data"]["txs"]]
        got = Data(txs=txs).hash()
        want = lb.signed_header.header.data_hash
        if got != want:
            raise RPCError(
                -32603,
                f"primary returned txs not matching the verified data_hash "
                f"at height {lb.height} (got {got.hex()}, want {want.hex()})")
        last_commit = None
        if lb.height > 1:
            prev = await self.client.verify_light_block_at_height(lb.height - 1)
            c = prev.signed_header.commit
            if c.hash() != lb.signed_header.header.last_commit_hash:
                raise RPCError(
                    -32603,
                    f"verified commit for {lb.height - 1} does not hash to "
                    f"the verified header's last_commit_hash")
            last_commit = self._commit_dict(c)
        return {
            "block_id": {"hash": _hex(lb.signed_header.header.hash())},
            "block": {
                "header": header_dict(lb.signed_header.header),
                "data": {"txs": [_b64(t) for t in txs]},
                "evidence": raw["block"].get("evidence", {"evidence": []}),
                "last_commit": last_commit,
            },
        }

    # ---------------------------------------------------- unverified plane

    async def health(self, _params: dict) -> dict:
        return {}

    async def status(self, _params: dict) -> dict:
        res = await self.primary.call("status")
        res["light_client_info"] = {
            "primary": self.client.primary.id_(),
            "witnesses": [w.id_() for w in self.client.witnesses],
            "first_trusted_height": str(self.client.first_trusted_height()),
            "last_trusted_height": str(self.client.last_trusted_height()),
        }
        return res

    async def abci_query(self, params: dict) -> dict:
        return await self.primary.call("abci_query", params)

    async def abci_info(self, _params: dict) -> dict:
        return await self.primary.call("abci_info")

    async def broadcast_tx_sync(self, params: dict) -> dict:
        return await self.primary.call("broadcast_tx_sync", params)

    async def broadcast_tx_async(self, params: dict) -> dict:
        return await self.primary.call("broadcast_tx_async", params)

    async def broadcast_tx_commit(self, params: dict) -> dict:
        return await self.primary.call("broadcast_tx_commit", params)

    # ------------------------------------------- websocket passthrough

    async def ws_passthrough(self, req: dict, client_id: str, tasks,
                             send_json) -> None:
        """Relay subscribe/unsubscribe to the primary's /websocket and pump
        its event stream back to the local client — UNVERIFIED, as in the
        reference's light proxy (events carry no commit proof either way)."""
        up = self._upstreams.get(client_id)
        if up is None:
            up = _UpstreamWS(self.primary_url)
            try:
                await up.connect()
            except (ConnectionError, OSError, asyncio.TimeoutError) as e:
                await send_json({
                    "jsonrpc": "2.0", "id": req.get("id", -1),
                    "error": {"code": -32603,
                              "message": f"primary ws unavailable: {e}"}})
                return
            self._upstreams[client_id] = up

            async def pump():
                try:
                    while True:
                        msg = await up.recv_json()
                        if msg is None:
                            return
                        await send_json(msg)
                except (ConnectionError, asyncio.IncompleteReadError, OSError):
                    pass

            tasks.spawn(pump(), name=f"ws-upstream-{client_id}")
        await up.send_json(req)

    async def ws_client_closed(self, client_id: str) -> None:
        up = self._upstreams.pop(client_id, None)
        if up is not None:
            up.close()

    def routes(self) -> dict:
        return {
            "health": self.health,
            "status": self.status,
            "light_block": self.light_block,
            "header": self.header,
            "header_by_hash": self.header_by_hash,
            "commit": self.commit,
            "validators": self.validators,
            "block": self.block,
            "abci_query": self.abci_query,
            "abci_info": self.abci_info,
            "broadcast_tx_sync": self.broadcast_tx_sync,
            "broadcast_tx_async": self.broadcast_tx_async,
            "broadcast_tx_commit": self.broadcast_tx_commit,
        }


class LightProxy(BaseService):
    """The daemon: a light.Client plus an RPCServer serving ProxyEnv."""

    def __init__(self, client, primary_url: str, listen_addr: str,
                 logger: cmtlog.Logger | None = None):
        super().__init__("LightProxy", logger or cmtlog.default().with_fields(
            module="light-proxy"))
        self.client = client
        self.env = ProxyEnv(client, primary_url)

        class _Cfg:
            laddr = listen_addr

        self.server = RPCServer(
            None, _Cfg(), logger=self.logger, env=self.env)

    @property
    def bound_addr(self) -> str:
        return self.server.bound_addr

    async def on_start(self) -> None:
        await self.client.initialize()
        await self.server.start()

    async def on_stop(self) -> None:
        await self.server.stop()
