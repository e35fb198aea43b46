"""The port's RPC light provider (light/rpc_provider.py) and light proxy
(light/proxy.py) against the JAX package's on the CPU.

- RPCProvider against either package's RPC server (a single-validator
  Node of each package, held at height 3): both packages' providers fetch
  the same LightBlock bytes, refuse a height past the head with the same
  error, find no certificate on a node without the plane, and retry a
  fetch the `light.fetch` chaos site fails transiently, as many times;
- the light proxy: a port LightProxy and a reference LightProxy, each
  with its package's light client over RPC providers, in front of one port
  Node held at height 3. Every route answers the same JSON through either
  proxy, and the verified ones carry the node's own blocks; a height past
  the head and an unknown header hash are errors through both; both refuse
  a TLS primary for the websocket relay.
"""

from __future__ import annotations

import asyncio
import base64

import pytest

from cometbft_tpu import light as jlight
from cometbft_tpu.config.config import Config as JConfig
from cometbft_tpu.libs import chaos as jchaos
from cometbft_tpu.light.proxy import LightProxy as JLightProxy
from cometbft_tpu.light.rpc_provider import RPCProvider as JRPCProvider
from cometbft_tpu.light.store import LightStore as JLightStore
from cometbft_tpu.node import Node as JNode
from cometbft_tpu.store.db import MemDB as JMemDB
from cometbft_tpu_torch import light as tlight
from cometbft_tpu_torch.config.config import Config as TConfig
from cometbft_tpu_torch.libs import chaos as tchaos
from cometbft_tpu_torch.light.proxy import LightProxy as TLightProxy
from cometbft_tpu_torch.light.rpc_provider import RPCProvider as TRPCProvider
from cometbft_tpu_torch.light.store import LightStore as TLightStore
from cometbft_tpu_torch.node import Node as TNode
from cometbft_tpu_torch.store import MemDB as TMemDB
from tests import torch_rpc_client as rpc
from tests.test_torch_node import _held_node, _one_home
from tests.torch_consumers import fresh_backends

CHAIN_ID = "node-chain"  # _one_home's
PERIOD_NS = 10 * 365 * 86400 * 10**9


@pytest.fixture(autouse=True)
def _fresh():
    yield from fresh_backends()
    tchaos.reset()
    jchaos.reset()


# ------------------------------------------------------------ RPCProvider


async def _provider_answers(url: str) -> dict:
    out = {}
    for side, Provider in (("jax", JRPCProvider), ("port", TRPCProvider)):
        p = Provider(CHAIN_ID, url, retry_attempts=3, backoff_base=0.0, backoff_cap=0.0)
        got = [(await p.light_block(h)).to_proto() for h in (1, 3)]
        try:
            await p.light_block(99)
        except Exception as e:  # noqa: BLE001 - the class is compared
            got.append(type(e).__name__)
        got.append(await p.commit_certificate(2))
        got.append(p.id_() == url)
        out[side] = got
    # the light.fetch site fails two attempts, the third serves
    for side, Provider, chaos in (("jax", JRPCProvider, jchaos), ("port", TRPCProvider, tchaos)):
        chaos.arm("light.fetch", "transient", 2)
        p = Provider(CHAIN_ID, url, retry_attempts=3, backoff_base=0.0, backoff_cap=0.0)
        lb = await p.light_block(2)
        out[side].append((lb.to_proto(), p.retries, chaos.fired("light.fetch")))
        chaos.arm("light.fetch", "permanent", 1)
        try:
            await p.light_block(2)
        except Exception as e:  # noqa: BLE001 - the class is compared
            out[side].append((type(e).__name__, p.retries))
        chaos.reset()
    return out


@pytest.mark.parametrize("server", ["jax", "port"])
def test_rpc_provider_fetches_as_the_reference_s(tmp_path, server):
    home = _one_home(tmp_path)
    Node, Config = (JNode, JConfig) if server == "jax" else (TNode, TConfig)

    async def main():
        node = await _held_node(Node, Config, home)
        try:
            got = await _provider_answers(f"http://{node.rpc_server.bound_addr}")
            return got, node.block_store.load_block(3).hash()
        finally:
            await node.stop()

    got, h3 = asyncio.run(main())
    assert got["port"] == got["jax"]
    assert got["port"][2:4] == ["ErrLightBlockNotFound", None]
    assert got["port"][5][1:] == (2, 2) and got["port"][6] == ("ErrLightBlockNotFound", 2)
    from cometbft_tpu_torch.types.light import LightBlock

    assert LightBlock.from_proto(got["port"][1]).hash() == h3


# ------------------------------------------------------------- the proxy

# (route, query) asked through both proxies; {hash} is block 2's
PROXY_ROUTES = [
    ("health", ""), ("light_block", "height=2"), ("header", "height=3"),
    ("header_by_hash", "hash={hash}"), ("commit", "height=2"), ("validators", "height=3"),
    ("block", "height=3"), ("abci_info", ""), ("abci_query", "path=%22/store%22&data=0x6b6579"),
    ("header", "height=99"), ("header_by_hash", "hash=" + "ab" * 32),
]


async def _proxy_answers(url: str, block2: str) -> dict:
    out = {}
    for side, light, Provider, Proxy, Store, MemDB in (
            ("jax", jlight, JRPCProvider, JLightProxy, JLightStore, JMemDB),
            ("port", tlight, TRPCProvider, TLightProxy, TLightStore, TMemDB)):
        root = await Provider(CHAIN_ID, url).light_block(1)
        client = light.Client(
            CHAIN_ID, light.TrustOptions(period_ns=PERIOD_NS, height=1, hash_=root.hash()),
            Provider(CHAIN_ID, url), [Provider(CHAIN_ID, url)], Store(MemDB()))
        proxy = Proxy(client, url, "tcp://127.0.0.1:0")
        await proxy.start()
        try:
            got = {}
            for i, (route, q) in enumerate(PROXY_ROUTES):
                q = q.format(hash=block2)
                got[f"{i}:{route}"] = await asyncio.wait_for(
                    rpc.get(proxy.bound_addr, f"/{route}" + (f"?{q}" if q else "")), 60.0)
            status = (await rpc.get(proxy.bound_addr, "/status"))["result"]
            got["status"] = (status["node_info"]["network"], status["light_client_info"])
            out[side] = got
        finally:
            await proxy.stop()
    return out


def test_proxy_routes_answer_the_reference_proxy_s_json(tmp_path):
    home = _one_home(tmp_path)

    async def main():
        node = await _held_node(TNode, TConfig, home)
        try:
            url = f"http://{node.rpc_server.bound_addr}"
            block2 = node.block_store.load_block(2).hash().hex()
            got = await _proxy_answers(url, block2)
            direct = {r: await rpc.get(node.rpc_server.bound_addr, f"/{r}?height=3")
                      for r in ("commit", "block")}
            return got, direct, node.block_store.load_block(3)
        finally:
            await node.stop()

    got, direct, b3 = asyncio.run(main())
    t, j = got["port"], got["jax"]
    for key in j:
        assert t[key] == j[key], key
    assert t["status"][0] == CHAIN_ID
    assert int(t["status"][1]["last_trusted_height"]) >= 3
    blk = t[next(k for k in t if k.endswith(":block"))]["result"]
    assert blk["block_id"]["hash"] == b3.hash().hex().upper()
    assert [base64.b64decode(x) for x in blk["block"]["data"]["txs"]] == list(b3.data.txs)
    assert blk["block"]["header"]["app_hash"] == b3.header.app_hash.hex().upper()
    assert "error" in t["9:header"] and "error" in t["10:header_by_hash"]
    assert direct["block"]["result"]["block_id"]["hash"] == blk["block_id"]["hash"]


def test_proxy_refuses_a_tls_primary_as_the_reference():
    from cometbft_tpu.light.proxy import _UpstreamWS as JUp
    from cometbft_tpu_torch.light.proxy import _UpstreamWS as TUp

    for Up in (JUp, TUp):
        with pytest.raises(ValueError, match="TLS"):
            Up("https://rpc.example.com:26657")
    ws = TUp("http://127.0.0.1:26657")
    assert (ws.host, ws.port) == ("127.0.0.1", 26657)

