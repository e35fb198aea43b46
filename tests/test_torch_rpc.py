"""The port's RPC (rpc/core.py, rpc/server.py) against the JAX package's: a
single-validator Node of each package, from copies of one home, with RPC
on and both packages' clocks on one stepping clock (as
tests/test_torch_node.py runs them), commits the same txs to height 3 and
is then held there. Every route of the reference's table then answers the
same JSON over URI GET for the same height, and JSON-RPC POST answers as GET
does. A websocket subscribed to NewBlock and Tx from the start saw the same
events. Bit-equal but for the fields EXCEPT lists, which name the backend,
the version, the listen address, this process's global state or a wall
clock; the light fleet's routes, which the port refuses, answer the same
error code with a message naming light/fleet.py.
"""

from __future__ import annotations

import asyncio
import base64
import hashlib
import json
import shutil

import pytest

from cometbft_tpu.config.config import Config as JConfig
from cometbft_tpu.node import Node as JNode
from cometbft_tpu_torch.config.config import Config as TConfig
from cometbft_tpu_torch.node import Node as TNode
from cometbft_tpu_torch.rpc import core as tcore
from tests import torch_rpc_client as rpc
from tests.test_torch_consensus import stepping_clocks
from tests.test_torch_node import _off, _one_home, hold_at
from tests.torch_consumers import fresh_backends

HEIGHT = 3  # the nodes are held at this height
TXS = [b"key%d=value%d" % (i, i) for i in range(4)]

# every route of the reference's table (rpc/core.py _routes_table), with
# the params it is asked with; {tx} and {block} are filled from the chain
ROUTES = [
    ("health", ""), ("crypto_health", ""), ("storage_health", ""), ("trace_dump", ""),
    ("consensus_timeline", ""), ("postmortems", ""), ("status", ""), ("net_info", ""),
    ("net_telemetry", ""), ("genesis", ""), ("block", "height=2"), ("block", ""),
    ("block_by_hash", "hash=0x{block}"), ("block_results", "height=2"), ("header", "height=3"),
    ("header_by_hash", "hash=0x{block}"), ("blockchain", "minHeight=1&maxHeight=3"),
    ("commit", "height=2"), ("commit", "height=1"), ("consensus_params", "height=2"),
    ("dump_consensus_state", ""), ("check_tx", 'tx="zz=9"'), ("genesis_chunked", "chunk=0"),
    ("light_block", "height=2"), ("light_verify", "height=2"),
    ("commit_certificate", "height=2"), ("validators", "height=2"), ("validators", ""),
    ("validators", "height=2&page=1&per_page=1"), ("consensus_state", ""), ("abci_info", ""),
    ("abci_query", "path=%22/store%22&data=0x6b657931"), ("tx", "hash=0x{tx}"),
    ("tx_search", "query=%22tx.height%3E0%22"), ("block_search", "query=%22block.height%3E1%22"),
    ("unconfirmed_txs", ""), ("num_unconfirmed_txs", ""),
    ("broadcast_evidence", "evidence=0x"), ("broadcast_tx_async", 'tx="async=1"'),
    ("broadcast_tx_sync", 'tx="sync=1"'), ("blockchain", "minHeight=x"), ("block", "height=99"),
]

# fields that differ by design, by route: the version and backend
# (`versions`, node_info.version), the listen address, this process's
# global device, trace and link state, and wall clocks
EXCEPT = {
    "status": (("node_info", "listen_addr"), ("node_info", "version"), ("versions",)),
    "net_info": (("listeners",),),
    "health": (("overload",),),
    "crypto_health": "keys",
    "storage_health": "keys",
    "trace_dump": "keys",
    "net_telemetry": (("listen_addr",), ("tunnel",), ("p2p_link",), ("totals",),
                      ("channels",)),
    "consensus_timeline": (("now_wall_ns",), ("heights",), ("skew",)),
    "light_verify": (("error", "message"),),
}


@pytest.fixture(autouse=True)
def _fresh():
    yield from fresh_backends()


def _strip(env: dict, route: str) -> dict:
    rule = EXCEPT.get(route)
    env = json.loads(json.dumps(env))
    if rule == "keys":
        return {"result_keys": sorted(env.get("result", {}))}
    for path in rule or ():
        d = env.get("result", env) if path[0] != "error" else env
        for k in path[:-1]:
            d = d.get(k, {})
        d.pop(path[-1], None)
    return env


async def _drive(Node, Config, home: str) -> dict:
    """Run `home`'s node with RPC on to HEIGHT, hold it there, and ask every
    route; returns {label: envelope} and the websocket's events."""
    cfg = _off(Config.load(home))
    cfg.rpc.laddr = "tcp://127.0.0.1:0"
    node = Node(cfg)
    held = hold_at(node, HEIGHT)
    await node.start()
    out: dict = {}
    try:
        addr = node.rpc_server.bound_addr
        ws = await rpc.WS.connect(addr)
        acks = [await ws.subscribe("tm.event = 'NewBlock'", rid=1),
                await ws.subscribe("tm.event = 'Tx'", rid=2)]
        for tx in TXS:
            await node.mempool.check_tx(tx)
        await asyncio.wait_for(held.wait(), 60.0)
        await asyncio.sleep(0.2)  # the indexer drains the event bus
        events = []
        while len([e for e in events if "NewBlock" in json.dumps(e)]) < HEIGHT:
            events.append(await asyncio.wait_for(ws.recv(), 10.0))
        await ws.send({"jsonrpc": "2.0", "id": 3, "method": "unsubscribe_all", "params": {}})
        while (ack := await asyncio.wait_for(ws.recv(), 10.0)).get("id") != 3:
            events.append(ack)
        acks.append(ack)
        await ws.close()
        out["ws"] = {"acks": acks, "events": events}
        block = node.block_store.load_block(2).hash().hex()
        tx = node.tx_indexer.search("tx.height > 0")[0].tx
        fill = {"block": block, "tx": hashlib.sha256(tx).hexdigest()}
        for i, (route, q) in enumerate(ROUTES):
            q = q.format(**fill)
            out[f"{i}:{route}"] = await rpc.get(addr, f"/{route}" + (f"?{q}" if q else ""))
        # JSON-RPC POST answers as GET does (base64 and hex params in JSON)
        out["post:block"] = await rpc.post(addr, "block", {"height": "2"})
        out["post:tx"] = await rpc.post(addr, "tx", {"hash": fill["tx"]})
        out["post:tx_search"] = await rpc.post(addr, "tx_search", {"query": "tx.height > 0"})
        out["post:check_tx"] = await rpc.post(addr, "check_tx", {"tx": rpc.b64(b"zz=9")})
        out["post:unknown"] = await rpc.post(addr, "no_such_route", {})
        out["heights"] = (node.block_store.height(), node.state_store.load().last_block_height)
        out["raw:openapi"] = (await rpc.get_raw(addr, "/openapi.yaml"))[0]
    finally:
        await node.stop()
    return out


@pytest.fixture(scope="module")
def answers(tmp_path_factory):
    root = tmp_path_factory.mktemp("rpc")
    home = _one_home(root)
    got = {}
    backends = fresh_backends()
    next(backends)
    try:
        for side, (Node, Config) in (("jax", (JNode, JConfig)), ("port", (TNode, TConfig))):
            h = str(root / side)
            shutil.copytree(home, h)
            with stepping_clocks():
                got[side] = asyncio.run(_drive(Node, Config, h))
    finally:
        next(backends, None)
    return got


def test_both_nodes_are_held_at_the_same_height(answers):
    assert answers["port"]["heights"] == answers["jax"]["heights"] == (HEIGHT, HEIGHT)


@pytest.mark.parametrize("label", [f"{i}:{r}" for i, (r, _) in enumerate(ROUTES)])
def test_route_answers_the_reference_s_json(answers, label):
    route = label.split(":", 1)[1]
    j, t = answers["jax"][label], answers["port"][label]
    assert _strip(t, route) == _strip(j, route)
    assert ("error" in t) == ("error" in j)


def test_post_answers_as_get_does(answers):
    t, j = answers["port"], answers["jax"]
    for k in ("post:block", "post:tx", "post:tx_search", "post:check_tx", "post:unknown"):
        assert {**t[k], "id": 1} == {**j[k], "id": 1}
    i = next(i for i, (r, q) in enumerate(ROUTES) if (r, q) == ("block", "height=2"))
    assert t["post:block"]["result"] == t[f"{i}:block"]["result"]
    assert t["post:unknown"]["error"]["code"] == -32601
    assert t["raw:openapi"] == j["raw:openapi"] == 200


def test_websocket_saw_the_same_events(answers):
    t, j = answers["port"]["ws"], answers["jax"]["ws"]
    assert t == j
    heights = [int(e["result"]["data"]["value"]["block"]["header"]["height"])
               for e in t["events"] if "NewBlock" in e["result"]["query"]]
    assert heights == list(range(1, HEIGHT + 1))
    assert sum("'Tx'" in e["result"]["query"] for e in t["events"]) == len(TXS)


def test_refused_routes(answers):
    t = answers["port"]
    light = t[next(f"{i}:light_verify" for i, (r, _) in enumerate(ROUTES) if r == "light_verify")]
    assert light["error"]["code"] == -32601
    assert light["error"]["message"] == tcore.LIGHT_FLEET_WAITS
    cert = t[next(f"{i}:commit_certificate" for i, (r, _) in enumerate(ROUTES)
                  if r == "commit_certificate")]
    assert cert["error"] == {"code": -32601,
                             "message": "certificate plane disabled (set cert.enabled)"}


def test_validators_pages_as_cometbft_does():
    """`page`/`per_page` (the port's addition, ROADMAP Queue 3): 150
    validators at 100 a page leave 50 on page 2."""
    env = tcore.Environment(None)
    assert env._page({}, 150) == slice(None)
    assert env._page({"per_page": "100", "page": "2"}, 150) == slice(100, 200)
    assert len(list(range(150))[env._page({"per_page": "100", "page": "2"}, 150)]) == 50
    assert env._page({"per_page": "500"}, 150) == slice(0, 100)
    with pytest.raises(tcore.RPCError):
        env._page({"page": "3", "per_page": "100"}, 150)


def test_light_subscribe_over_the_websocket_is_refused(tmp_path):
    async def main():
        cfg = _off(TConfig.load(_one_home(tmp_path)))
        cfg.rpc.laddr = "tcp://127.0.0.1:0"
        node = TNode(cfg)
        await node.start()
        try:
            ws = await rpc.WS.connect(node.rpc_server.bound_addr)
            await ws.send({"jsonrpc": "2.0", "id": 7, "method": "light_subscribe",
                           "params": {}})
            got = await asyncio.wait_for(ws.recv(), 10.0)
            await ws.close()
        finally:
            await node.stop()
        return got

    got = asyncio.run(main())
    assert got == {"jsonrpc": "2.0", "id": 7,
                   "error": {"code": -32601, "message": tcore.LIGHT_FLEET_WAITS}}


def test_encoded_tx_param_forms():
    """A URI's quoted string, its hex and a JSON body's base64 give the
    same tx bytes in both packages."""
    from cometbft_tpu.rpc import core as jcore

    for env_mod in (jcore, tcore):
        env = env_mod.Environment(None)
        assert env._tx_param({"tx": env_mod.QuotedStr("a=b")}) == b"a=b"
        assert env._tx_param({"tx": env_mod.UriStr("0x613d62")}) == b"a=b"
        assert env._tx_param({"tx": base64.b64encode(b"a=b").decode()}) == b"a=b"


def test_stop_closes_open_clients(tmp_path):
    """A node stops while a websocket and a keep-alive client are still
    connected: RPCServer.on_stop closes them (Python 3.12's
    Server.wait_closed waits for every connection; ROADMAP Queue 3)."""

    async def main():
        cfg = _off(TConfig.load(_one_home(tmp_path)))
        cfg.rpc.laddr = "tcp://127.0.0.1:0"
        node = TNode(cfg)
        await node.start()
        addr = node.rpc_server.bound_addr
        ws = await rpc.WS.connect(addr)
        ack = await ws.subscribe("tm.event = 'NewBlock'")
        host, port = addr.rsplit(":", 1)
        reader, writer = await asyncio.open_connection(host, int(port))
        writer.write(b"GET /health HTTP/1.1\r\nHost: x\r\n\r\n")  # keep-alive
        await writer.drain()
        await reader.readuntil(b"\r\n\r\n")
        await asyncio.wait_for(node.stop(), 10.0)
        tail = await asyncio.wait_for(reader.read(), 10.0)
        writer.close()
        await ws.close()
        return ack, tail

    ack, tail = asyncio.run(main())
    assert ack == {"jsonrpc": "2.0", "id": 1, "result": {}}
    assert b"overload" in tail  # the keep-alive response's body, then EOF
