"""The port's pprof server (node/pprof.py) and inspect mode (node/inspect.py),
on the CPU:

- a single-validator port Node with rpc.pprof_laddr set starts the
  PprofServer, whose routes answer while the node commits (index, stacks,
  a text and a marshalled profile, the heap twice, a bad route, bad
  seconds), and stops it with the node;
- over copies of that stopped home, the port's InspectNode and the JAX
  package's, each behind its package's RPC server, serve the same JSON on
  every data-backed route; and `python -m cometbft_tpu_torch inspect`
  serves the same status, then exits on SIGINT.
"""

from __future__ import annotations

import asyncio
import marshal
import os
import shutil
import signal
import subprocess
import sys
import time

import pytest

from cometbft_tpu.config.config import Config as JConfig
from cometbft_tpu.libs import log as jlog
from cometbft_tpu.node.inspect import InspectNode as JInspect
from cometbft_tpu.rpc.server import RPCServer as JRPCServer
from cometbft_tpu_torch.config.config import Config as TConfig
from cometbft_tpu_torch.libs import log as tlog
from cometbft_tpu_torch.node import Node as TNode
from cometbft_tpu_torch.node.inspect import InspectNode as TInspect
from cometbft_tpu_torch.rpc.server import RPCServer as TRPCServer
from tests import torch_rpc_client as rpc
from tests.test_torch_node import _off, _one_home
from tests.torch_consumers import fresh_backends

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HEIGHTS = 4


@pytest.fixture(autouse=True)
def _fresh():
    yield from fresh_backends()


async def _pprof_routes(addr: str) -> dict:
    out = {}
    for path in ("/", "/debug/pprof/stacks", "/debug/pprof/profile?seconds=0.3&format=text",
                 "/debug/pprof/profile?seconds=0.1", "/debug/pprof/heap",
                 "/debug/pprof/heap?format=text", "/debug/pprof/nope",
                 "/debug/pprof/profile?seconds=nan"):
        out[path] = await rpc.get_raw(addr, path)
    return out


@pytest.fixture(scope="module")
def chain_home(tmp_path_factory):
    """A single-validator port home that committed HEIGHTS blocks with
    kvstore txs, its node run with the pprof server on; the pprof
    answers taken while it ran."""
    root = tmp_path_factory.mktemp("inspect")
    home = _one_home(root)
    got = {}

    async def run():
        cfg = _off(TConfig.load(home))
        cfg.rpc.pprof_laddr = "127.0.0.1:0"
        cfg.base.log_level = "error"
        node = TNode(cfg)
        await node.start()
        try:
            for i in range(6):
                await node.mempool.check_tx(b"inspect%d=v%d" % (i, i))
            while node.block_store.height() < HEIGHTS + 1:
                assert not node.consensus_state.failed
                await asyncio.sleep(0.02)
            addr = node.pprof_server.bound_addr
            got["pprof"] = await _pprof_routes(addr)
            await asyncio.sleep(0.3)  # let the indexer drain
        finally:
            await node.stop()
        got["pprof_addr"] = addr
        got["pprof_running_after_stop"] = node.pprof_server.is_running

    asyncio.run(run())
    return home, got


def test_pprof_routes_answer_while_the_node_runs(chain_home):
    _, got = chain_home
    r = got["pprof"]
    assert r["/"][0] == 200 and b"/debug/pprof/profile" in r["/"][1]
    assert r["/debug/pprof/stacks"][0] == 200 and b"--- thread" in r["/debug/pprof/stacks"][1]
    status, text = r["/debug/pprof/profile?seconds=0.3&format=text"]
    assert status == 200 and b"function calls" in text
    status, raw = r["/debug/pprof/profile?seconds=0.1"]
    assert status == 200 and isinstance(marshal.loads(raw), dict)
    assert r["/debug/pprof/heap"][0] == 200 and b"tracemalloc started" in r["/debug/pprof/heap"][1]
    status, heap = r["/debug/pprof/heap?format=text"]
    assert status == 200 and heap.startswith(b"heap: ")
    assert r["/debug/pprof/nope"][0] == 404
    assert r["/debug/pprof/profile?seconds=nan"][0] == 400
    assert got["pprof_running_after_stop"] is False

    async def closed():
        with pytest.raises(OSError):
            await rpc.get_raw(got["pprof_addr"], "/")

    asyncio.run(closed())


def _routes(h: int) -> list[str]:
    return ["/status", f"/block?height={h}", f"/commit?height={h}",
            f"/validators?height={h}", f"/block?height={h + 1}", "/blockchain",
            f"/blockchain?minHeight=1&maxHeight={h}", f"/block_results?height={h}",
            "/header?height=2", "/genesis", "/abci_info", "/net_info",
            f'/tx_search?query="tx.height={h}"', '/block_search?query="block.height>1"',
            "/num_unconfirmed_txs", "/nope", f"/block?height={HEIGHTS * 100}"]


async def _serve_inspect(Inspect, Server, log, Config, home):
    cfg = Config.load(home)
    cfg.rpc.laddr = "tcp://127.0.0.1:0"
    node = Inspect(cfg, log.nop())
    server = Server(node, cfg.rpc, logger=log.nop())
    await server.start()
    return node, server


# what names each package's own build (version.py): the port's "-gpu"
# semver and crypto-backend version key against the reference's "-tpu"
_BUILD_NAMES = {"gpu_crypto_backend": "crypto_backend", "tpu_crypto_backend": "crypto_backend",
                "0.1.0-gpu": "0.1.0", "0.1.0-tpu": "0.1.0"}


def _without_addrs(doc):
    """The answers less the fields that name each server's own port, with
    each package's build names made one."""
    if isinstance(doc, dict):
        return {_BUILD_NAMES.get(k, k): _without_addrs(v) for k, v in doc.items()
                if k not in ("listen_addr", "rpc_address")}
    if isinstance(doc, list):
        return [_without_addrs(v) for v in doc]
    return _BUILD_NAMES.get(doc, doc) if isinstance(doc, str) else doc


def test_inspect_serves_the_reference_s_answers_over_a_stopped_home(chain_home, tmp_path):
    home, _ = chain_home
    homes = {"j": str(tmp_path / "j"), "t": str(tmp_path / "t")}
    for h in homes.values():
        shutil.copytree(home, h)

    async def run():
        got = {}
        for side, (Inspect, Server, log, Config) in (
                ("j", (JInspect, JRPCServer, jlog, JConfig)),
                ("t", (TInspect, TRPCServer, tlog, TConfig))):
            node, server = await _serve_inspect(Inspect, Server, log, Config, homes[side])
            try:
                top = node.block_store.height()
                got[side] = {"top": top, "routes": {
                    r: _without_addrs(await rpc.get(server.bound_addr, r))
                    for r in _routes(top - 1)}}
            finally:
                await server.stop()
                node.block_store.db.close()
                node.state_store.db.close()
        return got

    got = asyncio.run(run())
    assert got["t"]["top"] == got["j"]["top"] >= HEIGHTS + 1
    for route, want in got["j"]["routes"].items():
        assert got["t"]["routes"][route] == want, route
    status = got["t"]["routes"]["/status"]["result"]
    assert int(status["sync_info"]["latest_block_height"]) == got["t"]["top"]
    assert status["node_info"]["moniker"].endswith("(inspect)")
    block = got["t"]["routes"][f"/block?height={got['t']['top'] - 1}"]["result"]
    assert int(block["block"]["header"]["height"]) == got["t"]["top"] - 1


def test_cli_inspect_serves_a_stopped_home_until_sigint(chain_home, tmp_path):
    home, _ = chain_home
    t_home = str(tmp_path / "t")
    shutil.copytree(home, t_home)
    port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "cometbft_tpu_torch", "--home", t_home, "inspect",
         "--rpc.laddr", f"tcp://127.0.0.1:{port}"], cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    try:
        deadline = time.time() + 60
        doc = None
        while doc is None:
            assert proc.poll() is None, proc.stdout.read().decode()[-2000:]
            assert time.time() < deadline, "inspect never listened"
            try:
                doc = asyncio.run(rpc.get(f"127.0.0.1:{port}", "/status"))
            except OSError:
                time.sleep(0.2)
        want = TConfig.load(home)
        assert doc["result"]["node_info"]["moniker"] == want.base.moniker + " (inspect)"
        got_h = int(doc["result"]["sync_info"]["latest_block_height"])
        assert got_h >= HEIGHTS + 1
        blk = asyncio.run(rpc.get(f"127.0.0.1:{port}", f"/block?height={got_h}"))
        assert blk["result"]["block_id"]["hash"] == doc["result"]["sync_info"]["latest_block_hash"]
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stdout.close()


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_inspect_builds_and_launches_no_kernel(chain_home, tmp_path, monkeypatch):
    """inspect opens the stores and nothing else: with every kernel build
    and load made to raise, it serves a block and a commit, and no kernel
    counter moves."""
    from cometbft_tpu_torch.ops import _build, challenge, integrity, verify_kernel

    def refuse(*a, **k):
        raise AssertionError("inspect reached a kernel build")

    monkeypatch.setattr(_build, "build", refuse)
    monkeypatch.setattr(_build, "library", refuse)
    home, _ = chain_home
    t_home = str(tmp_path / "t")
    shutil.copytree(home, t_home)
    before = {**verify_kernel.LAUNCHES, **challenge.LAUNCHES, **integrity.LAUNCHES}

    async def run():
        node, server = await _serve_inspect(TInspect, TRPCServer, tlog, TConfig, t_home)
        try:
            top = node.block_store.height()
            return [await rpc.get(server.bound_addr, r)
                    for r in (f"/block?height={top}", f"/commit?height={top - 1}")]
        finally:
            await server.stop()
            node.block_store.db.close()
            node.state_store.db.close()

    answers = asyncio.run(run())
    assert all("result" in a for a in answers)
    assert {**verify_kernel.LAUNCHES, **challenge.LAUNCHES, **integrity.LAUNCHES} == before
