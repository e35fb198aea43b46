"""The port's ABCI socket wire (abci/server.ABCIServer, abci/client.
SocketClient, proxy socket_client_creator), abci-cli and the grammar checker
against the JAX package's: each package's client drives the other's server
on the kvstore over the JSON and the proto wires, and every response equals
the one the JAX package's client gets from its own server; the grammar
parses (and refuses) the same traces; an abci-cli `batch` script prints the
same text. Bit-equal: responses are compared by their reprs (the dataclass
reprs do not name the package).
"""

from __future__ import annotations

import asyncio
import contextlib
import io
import sys
import threading

import numpy as np
import pytest

from cometbft_tpu.abci import cli as jcli
from cometbft_tpu.abci import grammar as jgrammar
from cometbft_tpu.abci import kvstore as jkv
from cometbft_tpu.abci import types as jabci
from cometbft_tpu.abci.client import SocketClient as JSocketClient
from cometbft_tpu.abci.server import ABCIServer as JServer
from cometbft_tpu_torch.abci import cli as tcli
from cometbft_tpu_torch.abci import grammar as tgrammar
from cometbft_tpu_torch.abci import kvstore as tkv
from cometbft_tpu_torch.abci import types as tabci
from cometbft_tpu_torch.abci.client import SocketClient as TSocketClient
from cometbft_tpu_torch.abci.server import ABCIServer as TServer
from cometbft_tpu_torch.proxy import AppConns as TAppConns
from cometbft_tpu_torch.proxy import socket_client_creator

JAX = (jabci, jkv, JServer, JSocketClient)
PORT = (tabci, tkv, TServer, TSocketClient)
SEED = 19


def _txs(n: int = 6) -> list[bytes]:
    rng = np.random.default_rng(SEED)
    return [b"k%d=%s" % (i, rng.integers(0, 1 << 62).tobytes().hex().encode())
            for i in range(n)]


async def _session(abci, client) -> list[str]:
    """One clean-start kvstore session, every response's repr in order."""
    txs = _txs()
    out = [await client.echo("ping")]
    out.append(await client.info(abci.RequestInfo(version="0.38")))
    out.append(await client.init_chain(abci.RequestInitChain(chain_id="sock-chain")))
    for h in (1, 2):
        block = txs[3 * (h - 1):3 * h]
        for tx in block:
            out.append(await client.check_tx(abci.RequestCheckTx(tx=tx)))
        pp = await client.prepare_proposal(abci.RequestPrepareProposal(
            max_tx_bytes=1 << 20, txs=block, height=h))
        out.append(pp)
        out.append(await client.process_proposal(abci.RequestProcessProposal(
            txs=pp.txs, height=h)))
        out.append(await client.finalize_block(abci.RequestFinalizeBlock(
            txs=pp.txs, height=h)))
        out.append(await client.commit(abci.RequestCommit()))
    out.append(await client.query(abci.RequestQuery(path="/store", data=b"k4")))
    out.append(await client.info(abci.RequestInfo()))
    await client.flush()
    return [repr(r) for r in out]


def _run(server_side, client_side, wire: str) -> list[str]:
    _, kv, Server, _ = server_side
    abci, _, _, Client = client_side

    async def main():
        srv = Server(kv.KVStoreApplication(), "tcp://127.0.0.1:0")
        await srv.start()
        try:
            client = Client(srv.bound_addr(), wire=wire)
            try:
                return await _session(abci, client)
            finally:
                await client.close()
        finally:
            await srv.stop()

    return asyncio.run(main())


@pytest.mark.parametrize("wire", ["json", "proto"])
@pytest.mark.parametrize("server,client", [("jax", "port"), ("port", "jax"), ("port", "port")])
def test_socket_interop_on_the_kvstore(wire, server, client):
    sides = {"jax": JAX, "port": PORT}
    want = _run(JAX, JAX, wire)
    assert _run(sides[server], sides[client], wire) == want


def test_unix_socket_and_proxy_creator(tmp_path):
    """AppConns over the port's socket_client_creator against the JAX
    package's server on a unix socket: the four connections answer as the
    JAX package's own client does."""
    addr = f"unix://{tmp_path}/app.sock"

    async def main():
        srv = JServer(jkv.KVStoreApplication(), addr)
        await srv.start()
        conns = TAppConns(socket_client_creator(addr))
        await conns.start()
        try:
            r = await conns.mempool.check_tx(tabci.RequestCheckTx(tx=b"a=b"))
            fin = await conns.consensus.finalize_block(tabci.RequestFinalizeBlock(
                txs=[b"a=b"], height=1))
            await conns.consensus.commit(tabci.RequestCommit())
            q = await conns.query.query(tabci.RequestQuery(path="/store", data=b"a"))
            return r, fin, q
        finally:
            await conns.stop()
            await srv.stop()

    r, fin, q = asyncio.run(main())
    assert r.code == 0 and fin.tx_results[0].code == 0 and q.value == b"b"


TRACES = [
    (["init_chain", "prepare_proposal", "process_proposal", "finalize_block", "commit",
      "process_proposal", "finalize_block", "commit"], True),
    (["init_chain", "offer_snapshot", "offer_snapshot", "apply_snapshot_chunk",
      "apply_snapshot_chunk", "finalize_block", "commit"], True),
    (["finalize_block", "commit", "prepare_proposal", "finalize_block", "commit"], False),
    (["prepare_proposal", "finalize_block", "commit"], True),
    (["init_chain", "finalize_block", "finalize_block", "commit"], True),
    (["init_chain", "commit"], True),
    (["init_chain"], True),
    (["init_chain", "finalize_block", "commit", "prepare_proposal"], True),
]


def _verdict(grammar, trace, clean_start):
    try:
        grammar.check(list(trace), clean_start=clean_start)
        return "ok"
    except grammar.GrammarError as e:
        return f"refused at {e.pos}: {e}"


@pytest.mark.parametrize("trace,clean_start", TRACES, ids=range(len(TRACES)))
def test_grammar_parses_alike(trace, clean_start):
    assert _verdict(tgrammar, trace, clean_start) == _verdict(jgrammar, trace, clean_start)


def test_recorded_trace_over_the_proto_wire():
    """A RecordingApplication behind each package's server records the same
    calls for the same session, and both parse as a clean start."""
    traces = []
    for abci, kv, Server, Client, grammar in ((*JAX, jgrammar), (*PORT, tgrammar)):
        async def main():
            rec = grammar.RecordingApplication(kv.KVStoreApplication())
            srv = Server(rec, "tcp://127.0.0.1:0")
            await srv.start()
            client = Client(srv.bound_addr(), wire="proto")
            try:
                await _session(abci, client)
            finally:
                await client.close()
                await srv.stop()
            return rec.trace

        trace = asyncio.run(main())
        grammar.check(trace, clean_start=True)
        traces.append(trace)
    assert traces[0] == traces[1]


class _ServerThread:
    """A server of either package on its own event loop in a thread, so a
    CLI's asyncio.run can talk to it."""

    def __init__(self, Server, kv):
        self._loop = asyncio.new_event_loop()
        self._thread = threading.Thread(target=self._loop.run_forever, daemon=True)
        self._thread.start()
        self.srv = Server(kv.KVStoreApplication(), "tcp://127.0.0.1:0")
        asyncio.run_coroutine_threadsafe(self.srv.start(), self._loop).result(10)

    def close(self) -> None:
        asyncio.run_coroutine_threadsafe(self.srv.stop(), self._loop).result(10)
        self._loop.call_soon_threadsafe(self._loop.stop)
        self._thread.join(10)
        self._loop.close()


BATCH = """# abci-cli batch script
echo hello
info
check_tx k1=v1
check_tx 0x6b323d7632
prepare_proposal k1=v1 k2=v2
process_proposal k1=v1 k2=v2
finalize_block k1=v1 k2=v2
commit
query k1
query --path /store 0x6b32
"""


def _batch(cli, Server, kv, wire: str) -> str:
    server = _ServerThread(Server, kv)
    out = io.StringIO()
    stdin = sys.stdin
    try:
        sys.stdin = io.StringIO(BATCH)
        with contextlib.redirect_stdout(out):
            rc = cli.main(["--address", server.srv.bound_addr(), "--wire", wire, "batch"])
    finally:
        sys.stdin = stdin
        server.close()
    assert rc == 0
    return out.getvalue()


@pytest.mark.parametrize("wire", ["proto", "json"])
def test_cli_batch_prints_the_same(wire):
    want = _batch(jcli, JServer, jkv, wire)
    assert "hello" in want and want.count("\n") > 20
    assert _batch(tcli, TServer, tkv, wire) == want
    # the port's abci-cli against the JAX package's server
    assert _batch(tcli, JServer, jkv, wire) == want


def test_first_calls_at_once_share_one_connection():
    """Eight first calls at once on a fresh port SocketClient (as the RPC's
    concurrent broadcast_tx_sync calls reach a node's mempool connection)
    all answer: the client connects once, under its lock (ROADMAP Queue 3)."""

    async def main():
        srv = JServer(jkv.KVStoreApplication(), "tcp://127.0.0.1:0")
        await srv.start()
        client = TSocketClient(srv.bound_addr(), wire="proto")
        try:
            return await asyncio.gather(*(client.check_tx(tabci.RequestCheckTx(tx=tx))
                                          for tx in _txs(8)))
        finally:
            await client.close()
            await srv.stop()

    assert [r.code for r in asyncio.run(main())] == [0] * 8
