"""The port's gRPC surfaces against the JAX package's.

- rpc/grpc_services.py: a single-validator Node of each package with the
  public and the privileged gRPC listeners on, from copies of one home on
  one stepping clock, held at height 3 (as tests/test_torch_rpc.py holds
  them), answers the Version, Block, BlockResults and Pruning services with
  the same bytes on the reference's proto paths and the same JSON on the
  framework's paths; either package's GRPCServicesClient reads either's
  server. Excepted: GetVersion's `node` field, the version string.
- abci/grpc.py: either package's GRPCClient drives either's serve_grpc on
  the kvstore, over the proto and the JSON services, with equal responses;
  proxy.grpc_client_creator serves AppConns.
Bit-equal otherwise.
"""

from __future__ import annotations

import asyncio
import shutil

import pytest

grpc = pytest.importorskip("grpc")

from cometbft_tpu.abci import grpc as jagrpc  # noqa: E402
from cometbft_tpu.abci import kvstore as jkv  # noqa: E402
from cometbft_tpu.abci import types as jabci  # noqa: E402
from cometbft_tpu.config.config import Config as JConfig  # noqa: E402
from cometbft_tpu.node import Node as JNode  # noqa: E402
from cometbft_tpu.rpc import grpc_services as jgs  # noqa: E402
from cometbft_tpu.utils import protobuf as pb  # noqa: E402
from cometbft_tpu_torch.abci import grpc as tagrpc  # noqa: E402
from cometbft_tpu_torch.abci import kvstore as tkv  # noqa: E402
from cometbft_tpu_torch.abci import types as tabci  # noqa: E402
from cometbft_tpu_torch.config.config import Config as TConfig  # noqa: E402
from cometbft_tpu_torch.node import Node as TNode  # noqa: E402
from cometbft_tpu_torch.proxy import AppConns, grpc_client_creator  # noqa: E402
from cometbft_tpu_torch.rpc import grpc_services as tgs  # noqa: E402
from tests.test_torch_abci_socket import _session  # noqa: E402
from tests.test_torch_consensus import stepping_clocks  # noqa: E402
from tests.test_torch_node import _off, _one_home, hold_at  # noqa: E402
from tests.torch_consumers import fresh_backends  # noqa: E402

HEIGHT = 3

PROTO_CALLS = [  # (listener, path, request body)
    ("pub", "/tendermint.services.version.v1.VersionService/GetVersion", b""),
    *[("pub", "/tendermint.services.block.v1.BlockService/GetByHeight",
       pb.Writer().varint_i64(1, h).output()) for h in range(1, HEIGHT + 1)],
    ("pub", "/tendermint.services.block.v1.BlockService/GetLatest", b""),
    *[("pub", "/tendermint.services.block_results.v1.BlockResultsService/GetBlockResults",
       pb.Writer().varint_i64(1, h).output()) for h in range(1, HEIGHT + 1)],
    ("priv", "/tendermint.services.pruning.v1.PruningService/SetBlockRetainHeight",
     pb.Writer().uvarint(1, 2).output()),
    ("priv", "/tendermint.services.pruning.v1.PruningService/GetBlockRetainHeight", b""),
    ("priv", "/tendermint.services.pruning.v1.PruningService/SetTxIndexerRetainHeight",
     pb.Writer().uvarint(1, 2).output()),
    ("priv", "/tendermint.services.pruning.v1.PruningService/GetTxIndexerRetainHeight", b""),
]
JSON_CALLS = [
    ("VersionService", "GetVersion", None),
    *[("BlockService", "GetByHeight", {"height": h}) for h in range(1, HEIGHT + 1)],
    ("BlockService", "GetLatest", None),
    *[("BlockResultsService", "GetBlockResults", {"height": h}) for h in range(1, HEIGHT + 1)],
]


@pytest.fixture(autouse=True)
def _fresh():
    yield from fresh_backends()


def _ident(b):
    return b


async def _drive(Node, Config, home: str, Client) -> dict:
    cfg = _off(Config.load(home))
    cfg.grpc.laddr = "tcp://127.0.0.1:0"
    cfg.grpc.privileged_laddr = "tcp://127.0.0.1:0"
    node = Node(cfg)
    held = hold_at(node, HEIGHT)
    await node.start()
    chans = {}
    out: dict = {}
    try:
        for tx in (b"g1=a", b"g2=b"):
            await node.mempool.check_tx(tx)
        await asyncio.wait_for(held.wait(), 60.0)
        chans = {"pub": grpc.aio.insecure_channel(node.grpc_bound),
                 "priv": grpc.aio.insecure_channel(node.grpc_priv_bound)}
        out["proto"] = [await chans[lst].unary_unary(
            path, request_serializer=_ident, response_deserializer=_ident)(body)
            for lst, path, body in PROTO_CALLS]
        # the other package's client on this package's server
        client = Client(node.grpc_bound)
        try:
            out["json"] = [await client.call(s, m, req) for s, m, req in JSON_CALLS]
        finally:
            await client.close()
        try:
            await chans["pub"].unary_unary(
                "/tendermint.services.pruning.v1.PruningService/GetBlockRetainHeight",
                request_serializer=_ident, response_deserializer=_ident)(b"")
            out["pruning_on_public"] = "served"
        except grpc.aio.AioRpcError as e:
            out["pruning_on_public"] = e.code().name
    finally:
        for ch in chans.values():
            await ch.close()
        await node.stop()
    return out


@pytest.fixture(scope="module")
def answers(tmp_path_factory):
    root = tmp_path_factory.mktemp("grpc")
    home = _one_home(root)
    got = {}
    backends = fresh_backends()
    next(backends)
    try:
        for side, Node, Config, Client in (("jax", JNode, JConfig, tgs.GRPCServicesClient),
                                           ("port", TNode, TConfig, jgs.GRPCServicesClient)):
            h = str(root / side)
            shutil.copytree(home, h)
            with stepping_clocks():
                got[side] = asyncio.run(_drive(Node, Config, h, Client))
    finally:
        next(backends, None)
    return got


def _version_fields(raw: bytes) -> dict:
    r = pb.Reader(raw)
    fields = {}
    while not r.at_end():
        f, w = r.read_tag()
        fields[f] = r.read_bytes() if w == 2 else r.read_uvarint()
    return fields


@pytest.mark.allow_task_leaks  # a grpc.aio channel's close can outlive the check
@pytest.mark.parametrize("i", range(len(PROTO_CALLS)),
                         ids=[p.rsplit("/", 1)[1] + str(i) for i, (_, p, _) in
                              enumerate(PROTO_CALLS)])
def test_proto_service_bytes(answers, i):
    j, t = answers["jax"]["proto"][i], answers["port"]["proto"][i]
    if PROTO_CALLS[i][1].endswith("GetVersion"):
        j, t = _version_fields(j), _version_fields(t)
        assert t.pop(1) == b"0.1.0-gpu"  # the version string, excepted
        j.pop(1)
    assert t == j
    assert t or "/Set" in PROTO_CALLS[i][1]  # a Set answers an empty body


@pytest.mark.allow_task_leaks
@pytest.mark.parametrize("i", range(len(JSON_CALLS)),
                         ids=[f"{s}.{m}{i}" for i, (s, m, _) in enumerate(JSON_CALLS)])
def test_json_services_across_packages(answers, i):
    j, t = answers["jax"]["json"][i], answers["port"]["json"][i]
    if JSON_CALLS[i][1] == "GetVersion":
        assert t.pop("node") == "0.1.0-gpu"
        j.pop("node")
    assert t == j


@pytest.mark.allow_task_leaks
def test_pruning_only_on_the_privileged_listener(answers):
    assert answers["port"]["pruning_on_public"] == answers["jax"]["pruning_on_public"] \
        == "UNIMPLEMENTED"


@pytest.mark.allow_task_leaks
@pytest.mark.parametrize("wire", ["proto", "json"])
@pytest.mark.parametrize("server,client", [("jax", "port"), ("port", "jax"), ("port", "port")])
def test_abci_grpc_interop_on_the_kvstore(wire, server, client):
    sides = {"jax": (jabci, jkv, jagrpc), "port": (tabci, tkv, tagrpc)}

    def run(server_side, client_side):
        _, kv, srv_mod = server_side
        abci, _, cli_mod = client_side
        srv, bound = srv_mod.serve_grpc(kv.KVStoreApplication(), "grpc://127.0.0.1:0")
        try:
            async def main():
                cli = cli_mod.GRPCClient(bound, wire=wire)
                try:
                    return await _session(abci, cli)
                finally:
                    await cli.close()

            return asyncio.run(main())
        finally:
            srv.stop(None)

    want = run(sides["jax"], sides["jax"])
    assert run(sides[server], sides[client]) == want


@pytest.mark.allow_task_leaks
def test_grpc_client_creator_serves_app_conns():
    srv, bound = jagrpc.serve_grpc(jkv.KVStoreApplication(), "grpc://127.0.0.1:0")
    try:
        async def main():
            conns = AppConns(grpc_client_creator(bound))
            await conns.start()
            try:
                r = await conns.mempool.check_tx(tabci.RequestCheckTx(tx=b"a=b"))
                fin = await conns.consensus.finalize_block(
                    tabci.RequestFinalizeBlock(txs=[b"a=b"], height=1))
                await conns.consensus.commit(tabci.RequestCommit())
                q = await conns.query.query(tabci.RequestQuery(path="/store", data=b"a"))
            finally:
                await conns.stop()
            return r, fin, q

        r, fin, q = asyncio.run(main())
    finally:
        srv.stop(None)
    assert r.code == 0 and fin.tx_results[0].code == 0 and q.value == b"b"
