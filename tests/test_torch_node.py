"""The port's node (node/node.py, config/, cmd.py) held against the JAX
package's on the CPU, both on their "cpu" backends.

- `init` and `testnet` write the reference's layout and files;
- a single-validator Node on sqlite, in both packages from copies of one
  home and both packages' clocks on one stepping clock: the same block
  hashes, app hashes and State bytes over 3 heights, the indexer finding
  the same txs, the pruner keeping the same heights;
- the port's Handshaker on a home the reference's node wrote replays into
  a fresh kvstore app to the reference's State, and the port's Node then
  keeps committing on that home;
- the crash matrix: `python -m cometbft_tpu_torch ... start` killed at
  each commit-path fail point stops where the reference's CLI does on a
  copy of the home, the two Handshakers recover the same State, and the
  port's node then keeps a linked chain;
- a fresh Node syncs a torch_tcp_harness chain to its blocks and State;
- every plane the port does not hold yet (pprof, byzantine, fuzz), an
  "auto" or "tpu" backend and a "gpu" backend without a card raise at
  construction, the planes held since the bootstrap slice (certificates,
  state sync, the SQL indexer) construct, and each plane held since the
  RPC slice (RPC, gRPC, privileged gRPC, PEX, a socket and a gRPC app) or
  the bootstrap slice (certificates, the SQL indexer) starts in a Node;
- the CLI's key and reset commands act as the reference's, its RPC
  clients (trace-dump, netinfo, heightline) print what the reference's
  print against a live node of each package, `rollback`, `compact-db`
  and `light` answer as the reference's, the queued commands raise, and a
  home `init` wrote starts unedited.
"""

from __future__ import annotations

import asyncio
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from cometbft_tpu import cmd as jcmd
from cometbft_tpu.config.config import Config as JConfig
from cometbft_tpu.node import Node as JNode
from cometbft_tpu.node import init_files as j_init
from cometbft_tpu.store.db import open_db as j_open_db
from cometbft_tpu_torch import cmd as tcmd
from cometbft_tpu_torch.abci.kvstore import KVStoreApplication as TKV
from cometbft_tpu_torch.config.config import Config as TConfig
from cometbft_tpu_torch.config.config import test_config as t_test_config
from cometbft_tpu_torch.consensus.config import test_consensus_config as _ms_timeouts
from cometbft_tpu_torch.consensus.replay import Handshaker
from cometbft_tpu_torch.node import Node as TNode
from cometbft_tpu_torch.node import init_files as t_init
from cometbft_tpu_torch.proxy import AppConns, local_client_creator
from cometbft_tpu_torch.state import StateStore
from cometbft_tpu_torch.store import BlockStore
from cometbft_tpu_torch.store.db import open_db as t_open_db
from cometbft_tpu_torch.types.genesis import GenesisDoc
from tests.test_torch_consensus import stepping_clocks
from tests.torch_consumers import fresh_backends

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _fresh():
    yield from fresh_backends()


def _off(cfg, db: str = "sqlite"):
    """A node config both packages run: RPC, PEX and certificates off (the
    tests that want them turn them on), the "cpu" backend, millisecond
    timeouts, any free port."""
    cfg.consensus = type(cfg.consensus)(**vars(_ms_timeouts()))
    cfg.base.db_backend = db
    cfg.rpc.laddr = ""
    cfg.p2p.pex = False
    cfg.cert.enabled = False
    cfg.p2p.laddr = "tcp://127.0.0.1:0"
    cfg.crypto.backend = "cpu"
    return cfg


def _files(root: str) -> list[str]:
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


# ------------------------------------------------------------ init, testnet


def test_init_files_write_the_reference_s_layout(tmp_path):
    j_init(str(tmp_path / "j"), chain_id="layout", moniker="m0")
    t_init(str(tmp_path / "t"), chain_id="layout", moniker="m0")
    assert _files(str(tmp_path / "t")) == _files(str(tmp_path / "j")) == [
        "config/config.toml", "config/genesis.json", "config/node_key.json",
        "config/priv_validator_key.json"]
    assert os.path.isdir(tmp_path / "t" / "data")
    jt = open(tmp_path / "j/config/config.toml").read().splitlines()
    tt = open(tmp_path / "t/config/config.toml").read().splitlines()
    assert [(a, b) for a, b in zip(jt, tt) if a != b] == [('backend = "auto"', 'backend = "gpu"')]
    jg, tg = (json.load(open(tmp_path / s / "config/genesis.json")) for s in "jt")
    assert sorted(tg) == sorted(jg) and tg["chain_id"] == "layout"
    assert [sorted(v) for v in tg["validators"]] == [sorted(v) for v in jg["validators"]]
    for rel in ("config/priv_validator_key.json", "config/node_key.json"):
        assert sorted(json.load(open(tmp_path / "t" / rel))) == sorted(
            json.load(open(tmp_path / "j" / rel)))


def test_testnet_writes_the_reference_s_homes(tmp_path, capsys):
    args = ["testnet", "--v", "3", "--chain-id", "tn", "--starting-port", "30100"]
    assert jcmd.main(args + ["--o", str(tmp_path / "j")]) == 0
    assert tcmd.main(args + ["--o", str(tmp_path / "t")]) == 0
    assert _files(str(tmp_path / "t")) == _files(str(tmp_path / "j"))
    for i in range(3):
        homes = {s: str(tmp_path / s / f"node{i}") for s in "jt"}
        cfgs = {s: TConfig.load(h) for s, h in homes.items()}
        ids = {s: [p.split("@")[0] for p in c.p2p.persistent_peer_list()]
               for s, c in cfgs.items()}
        text = {s: open(os.path.join(h, "config/config.toml")).read() for s, h in homes.items()}
        for s in "jt":
            for k in ids[s]:
                text[s] = text[s].replace(k, "<id>")
        # the backend line alone differs: the port's testnet keeps "gpu"
        jt, tt = text["j"].splitlines(), text["t"].splitlines()
        assert len(tt) == len(jt)
        assert [(a, b) for a, b in zip(jt, tt) if a != b] == [('backend = "cpu"', 'backend = "gpu"')]
        assert cfgs["t"].crypto.backend == "gpu" and cfgs["t"].rpc.laddr.endswith(str(31100 + i))
        gj, gt = (json.load(open(os.path.join(homes[s], "config/genesis.json"))) for s in "jt")
        assert len(gt["validators"]) == 3 and [v["power"] for v in gt["validators"]] == [
            v["power"] for v in gj["validators"]]


# ---------------------------------------------------- the single validator


def _one_home(root, name="solo-home", side: str = "port") -> str:
    """A single-validator home written by `side`'s init_files, set by
    _off (so its config.toml's backend line is "cpu")."""
    home = str(root / name)
    init, Config = (t_init, TConfig) if side == "port" else (j_init, JConfig)
    init(home, chain_id="node-chain", moniker="solo")
    _off(Config.load(home)).save()
    return home


async def _drive_node(Node, Config, home: str, heights: int, txs: int = 4):
    """Run a Node on `home` until it has committed `heights` blocks; submit
    `txs` kvstore txs first. Returns block hashes, app hashes, the State's
    bytes at `heights`, tx search results and the node."""
    node = Node(_off(Config.load(home)))
    at_height: list[bytes] = []
    cs = node.consensus_state
    update_to_state = cs.update_to_state

    def capture(state):
        if state.last_block_height == heights and not at_height:
            at_height.append(state.to_bytes())
        update_to_state(state)

    cs.update_to_state = capture
    await node.start()
    try:
        for i in range(txs):
            await node.mempool.check_tx(b"key%d=value%d" % (i, i))

        async def poll():
            while not at_height or node.block_store.height() < heights:
                assert not cs.failed
                await asyncio.sleep(0.01)

        await asyncio.wait_for(poll(), 60.0)
        # let the indexer drain what the event bus handed it
        await asyncio.sleep(0.2)
    finally:
        await node.stop()
    bs = node.block_store
    found = [(r.height, r.index, r.tx) for r in node.tx_indexer.search("app.key EXISTS")]
    return ([bs.load_block(h).hash() for h in range(1, heights + 1)],
            [bs.load_block(h).header.app_hash for h in range(1, heights + 1)],
            at_height[0], found, node)


def test_single_validator_node_is_bit_equal_to_the_reference_s(tmp_path):
    home = _one_home(tmp_path)
    homes = {"jax": str(tmp_path / "j"), "port": str(tmp_path / "t")}
    for h in homes.values():
        shutil.copytree(home, h)
    out = {}
    for side, (Node, Config) in (("jax", (JNode, JConfig)), ("port", (TNode, TConfig))):
        with stepping_clocks():
            out[side] = asyncio.run(_drive_node(Node, Config, homes[side], 3))
    j, t = out["jax"], out["port"]
    assert len(t[0]) == 3 and len(t[3]) == 4
    assert t[:4] == j[:4]
    tnode = t[4]
    assert tnode.consensus_metrics.height.value() >= 3
    assert tnode.metrics_registry.render().count("cometbft_build_info{") == 1


@pytest.mark.parametrize("retain", [2, 4])
def test_pruner_keeps_the_reference_s_heights(tmp_path, retain):
    """The app's retain height through each package's pruner over copies
    of one chain: the same base, blocks, states and indexed txs kept."""
    home = _one_home(tmp_path)
    asyncio.run(_drive_node(TNode, TConfig, home, 5))
    kept = {}
    for side in ("jax", "port"):
        h = str(tmp_path / side)
        shutil.copytree(home, h)
        if side == "jax":
            from cometbft_tpu.state import StateStore as SS
            from cometbft_tpu.state.pruner import Pruner
            from cometbft_tpu.state.txindex import TxIndexer
            from cometbft_tpu.store import BlockStore as BS
            op = j_open_db
        else:
            from cometbft_tpu_torch.state.pruner import Pruner
            from cometbft_tpu_torch.state.txindex import TxIndexer
            BS, SS, op = BlockStore, StateStore, t_open_db
        d = os.path.join(h, "data")
        bs = BS(op("sqlite", os.path.join(d, "blockstore.db"), checksum=True))
        ss = SS(op("sqlite", os.path.join(d, "state.db"), checksum=True))
        idx_db = op("sqlite", os.path.join(d, "tx_index.db"))
        txi = TxIndexer(idx_db)
        pr = Pruner(ss, bs, tx_indexer=txi)
        pr.set_application_block_retain_height(retain)
        with pytest.raises(ValueError):
            pr.set_application_block_retain_height(retain - 1)
        got = pr.prune_once()
        kept[side] = (got, bs.base(), bs.height(),
                      [bs.load_block(x) is not None for x in range(1, 6)],
                      [ss.load_validators(x) is not None for x in range(1, 6)],
                      sorted(r.height for r in txi.search("app.key EXISTS")),
                      pr.get_block_retain_height())
        for db in (bs.db, ss.db, idx_db):
            db.close()
    assert kept["port"][1] == retain
    assert kept["port"] == kept["jax"]


async def _replay(home: str, side: str):
    """A Handshaker of `side`'s package over `home`'s stores and a fresh
    kvstore app: the State it returns, the blocks it replayed and the
    app's height and hash after it."""
    if side == "jax":
        from cometbft_tpu.abci import types as abci
        from cometbft_tpu.abci.kvstore import KVStoreApplication as App
        from cometbft_tpu.consensus.replay import Handshaker as HS
        from cometbft_tpu.proxy import AppConns as Conns
        from cometbft_tpu.proxy import local_client_creator as local
        from cometbft_tpu.state import StateStore as SS
        from cometbft_tpu.store import BlockStore as BS
        from cometbft_tpu.types.genesis import GenesisDoc as GD
        op = j_open_db
    else:
        from cometbft_tpu_torch.abci import types as abci
        App, HS, Conns, local, SS, BS, GD, op = (TKV, Handshaker, AppConns, local_client_creator,
                                                 StateStore, BlockStore, GenesisDoc, t_open_db)
    d = os.path.join(home, "data")
    bs = BS(op("sqlite", os.path.join(d, "blockstore.db"), checksum=True))
    ss = SS(op("sqlite", os.path.join(d, "state.db"), checksum=True))
    conns = Conns(local(App()))
    await conns.start()
    try:
        before = ss.load()
        hs = HS(ss, bs, GD.from_json(open(os.path.join(home, "config/genesis.json")).read()))
        state = await hs.handshake(conns)
        info = await conns.query.info(abci.RequestInfo())
        return (state.to_bytes(), hs.n_blocks_replayed, info.last_block_height,
                info.last_block_app_hash, bs.height(),
                None if before is None else before.last_block_height)
    finally:
        await conns.stop()
        bs.db.close()
        ss.db.close()


def test_port_replays_a_home_the_reference_s_node_wrote(tmp_path):
    """The reference's node commits on sqlite in a home the reference's
    init wrote; on copies of that home, the port's Handshaker and the
    reference's replay the chain into a fresh kvstore app to the same
    State, and the port's Node then keeps committing from the reference's
    WAL and stores."""
    home = _one_home(tmp_path, side="jax")
    j = asyncio.run(_drive_node(JNode, JConfig, home, 3))
    shutil.copytree(home, str(tmp_path / "copy"))
    jrep = asyncio.run(_replay(str(tmp_path / "copy"), "jax"))
    trep = asyncio.run(_replay(home, "port"))
    top = trep[4]
    assert top >= 3 and trep[1] == trep[2] == top
    assert trep == jrep
    t = asyncio.run(_drive_node(TNode, TConfig, home, top + 2, txs=1))
    assert t[0][:3] == j[0]
    assert t[4].block_store.height() >= top + 2


def test_node_block_syncs_a_harness_chain_to_its_state(tmp_path):
    """A fresh non-validator Node on its own kvstore app syncs a chain
    torch_tcp_harness.build_chain made (chip_smoke's node sync150, at 4
    validators and 12 blocks) from serve_node: the harness's chain starts
    from InitChain's app hash as the Node's handshake does, so the synced
    blocks and State are the chain's."""
    from tests import torch_net_harness as NH
    from tests import torch_tcp_harness as T

    privs = [NH.gen_priv("ed25519", i, 0) for i in range(4)]
    by_addr = {p.pub_key().address(): p for p in privs}
    gdoc = NH.genesis(privs, "node-sync-chain")
    n_blocks, top = 12, 11  # the tip waits for its successor's commit
    chain = asyncio.run(T.build_chain(gdoc, n_blocks, lambda a, m: by_addr[a].sign(m)))
    home = str(tmp_path / "sync")
    t_init(home, chain_id=gdoc.chain_id, moniker="sync")
    with open(os.path.join(home, "config/genesis.json"), "w") as f:
        f.write(gdoc.to_json())

    async def run():
        hkey, htr, hsw = T.serve_node("honest", gdoc, chain.block_store)
        haddr = await htr.listen("127.0.0.1:0")
        cfg = _off(TConfig.load(home))
        cfg.p2p.persistent_peers = f"{hkey.id()}@{haddr}"
        cfg.save()
        await hsw.start()
        node = TNode(TConfig.load(home))
        assert node.blocksync_active and type(node.app) is TKV
        try:
            await node.start()

            async def poll():
                while node.block_store.height() < top or node.blocksync_reactor.active:
                    await asyncio.sleep(0.01)

            await asyncio.wait_for(poll(), 60.0)
        finally:
            await node.stop()
            await hsw.stop()
        return node

    node = asyncio.run(run())
    assert [node.block_store.load_block(h).hash() for h in range(1, top + 1)] == [
        chain.block_store.load_block(h).hash() for h in range(1, top + 1)]
    state = node.state_store.load()
    assert state.last_block_height >= top
    if state.last_block_height == top:
        assert state.to_bytes() == chain.states[top]
    assert state.app_hash == chain.block_store.load_block(state.last_block_height + 1
                                                         ).header.app_hash


# ------------------------------------------------------------- crash matrix


def _crash_home(tmp_path) -> str:
    home = str(tmp_path / "home")
    t_init(home, chain_id="crash-chain", moniker="c0")
    cfg = _off(t_test_config(home=home))
    cfg.save()
    return home


@pytest.mark.parametrize("fail_index", [1, 2, 3, 4])
def test_crash_at_commit_point_recovers(tmp_path, fail_index):
    """tests/test_crash_recovery.py's matrix through the port's CLI:
      1: block saved, no WAL EndHeight       -> WAL replay re-commits
      2: EndHeight fsynced, state not saved  -> handshake applies stored block
      3: FinalizeBlock response saved, state not saved -> same window
      4: state saved, app Commit lost        -> handshake replays to app
    The reference's CLI crashes at the same fail index on a copy of the
    same home: both stop at the same block and State heights, and each
    package's Handshaker recovers its home to the same State, replaying
    the same blocks into a fresh kvstore app."""
    home = _crash_home(tmp_path)
    jhome = str(tmp_path / "jhome")
    shutil.copytree(home, jhome)
    env = dict(os.environ, FAIL_TEST_INDEX=str(fail_index), JAX_PLATFORMS="cpu")
    # both homes' config.toml say backend = "cpu"; the flag is the port's
    procs = {side: subprocess.Popen(
        [sys.executable, "-m", mod, "--home", h, "start", "--log_level", "error", *flag],
        cwd=REPO, env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
        for side, mod, h, flag in (("port", "cometbft_tpu_torch", home, ["--crypto_backend", "cpu"]),
                                   ("jax", "cometbft_tpu", jhome, []))}
    for side, proc in procs.items():
        _, err = proc.communicate(timeout=90)
        assert proc.returncode == 99, (side, err.decode()[-2000:])
        assert f"fail-point {fail_index} triggered" in err.decode(), side
    rep = {}
    for side, h in (("port", home), ("jax", jhome)):
        shutil.copytree(h, h + "-replay")
        state, *rest = asyncio.run(_replay(h + "-replay", side))
        # the two processes' clocks differ: the block's time, and so its
        # hash, are each process's own; every other field of State agrees
        doc = json.loads(state)
        del doc["last_block_time"], doc["last_block_id"]
        rep[side] = (doc, *rest)
    # the crash at height 1: its block stored, its State saved at fail
    # point 4 alone
    assert rep["port"][4] == 1 and rep["port"][5] == (1 if fail_index == 4 else 0)
    assert rep["port"] == rep["jax"]

    async def recover():
        node = TNode(_off(TConfig.load(home)))
        crash_h = node.block_store.height()
        st0 = node.state_store.load()
        await node.start()
        try:
            target = max(crash_h, 1) + 2

            async def poll():
                while (node.state_store.load() or st0).last_block_height < target:
                    await asyncio.sleep(0.02)

            await asyncio.wait_for(poll(), 30)
        finally:
            await node.stop()
        return node, crash_h

    node, crash_h = asyncio.run(recover())
    assert node.state_store.load().last_block_height >= max(crash_h, 1) + 2
    for h in range(2, node.block_store.height() + 1):
        blk = node.block_store.load_block(h)
        meta = node.block_store.load_block_meta(h - 1)
        assert blk.header.last_block_id.hash == meta.block_id.hash, f"broken link at {h}"


# ------------------------------------------- the planes refused until they landed


# each plane the node refused while its module waited for a later slice;
# the node builds every one of them now (the pprof server at its start)
PLANES = [
    ("pprof", lambda c: setattr(c.rpc, "pprof_laddr", "127.0.0.1:0"), None),
    ("cert", lambda c: setattr(c.cert, "enabled", True), None),
    ("statesync", lambda c: (setattr(c.state_sync, "enable", True),
                             setattr(c.state_sync, "rpc_servers", ["127.0.0.1:1", "127.0.0.1:2"]),
                             setattr(c.state_sync, "trust_height", 1),
                             setattr(c.state_sync, "trust_hash", "00" * 32)), None),
    ("byzantine", lambda c: setattr(c.consensus, "byzantine", "equivocation"),
     "equivocate"),
    ("fuzz", lambda c: (setattr(c.p2p, "test_fuzz", True),
                        setattr(c.p2p, "test_fuzz_mode", "delay")), None),
    ("sql", lambda c: setattr(c.tx_index, "indexer", "sql"), None),
]


@pytest.mark.parametrize("plane,set_,refused", PLANES, ids=[p[0] for p in PLANES])
def test_node_refuses_planes_it_does_not_hold_yet(tmp_path, plane, set_, refused):
    """Every plane the node refused while it waited for its slice is built
    now: certificates, state sync, the SQL indexer, the pprof server (at
    the node's start), the byzantine harness over the node's consensus and
    the fuzzed transport. A byzantine behaviour the harness does not know
    (`refused`) fails the node's construction with the reference's
    ValueError."""
    home = _one_home(tmp_path)
    cfg = _off(TConfig.load(home))
    set_(cfg)
    if refused is not None:
        errs = {}
        for side, (Node, Config) in (("j", (JNode, JConfig)), ("t", (TNode, TConfig))):
            c = _off(Config.load(home))
            set_(c)
            c.consensus.byzantine = refused
            with pytest.raises(ValueError) as e:
                Node(c)
            errs[side] = str(e.value)
        assert errs["t"] == errs["j"] and refused in errs["t"]
    node = TNode(cfg)
    try:
        if plane == "cert":
            assert node.cert_plane is not None and node.pruner.cert_store is node.cert_plane.store
        elif plane == "statesync":
            assert node.statesync_active and node.statesync_reactor.syncer is not None
            assert "STATESYNC" in node.switch.reactors
        elif plane == "pprof":
            assert node.pprof_server is None and node.config.rpc.pprof_laddr == "127.0.0.1:0"
        elif plane == "byzantine":
            from cometbft_tpu_torch.consensus import byzantine

            assert isinstance(node._byzantine, byzantine.ByzantineHarness)
            assert node._byzantine.behavior == "equivocation"
            assert isinstance(node.consensus_state.priv_validator, byzantine.UnsafeSigner)
        elif plane == "fuzz":
            fc = node.transport.fuzz_config
            assert fc.mode == "delay" and fc.max_delay == cfg.p2p.test_fuzz_max_delay
        else:
            assert node._sql_sink is not None and node.indexer_service is not None
    finally:
        for db in (node.block_store.db, node.state_store.db, node._evidence_db, node._cert_db):
            if db is not None:
                db.close()
        if node._sql_sink is not None:
            node._sql_sink.close()


@pytest.mark.parametrize("backend", ["auto", "tpu"])
def test_node_refuses_the_reference_s_backends(tmp_path, backend):
    home = _one_home(tmp_path)
    cfg = _off(TConfig.load(home))
    cfg.crypto.backend = backend
    with pytest.raises(ValueError, match='"gpu".*"cpu"'):
        TNode(cfg)


@pytest.mark.skipif(torch.cuda.is_available(), reason="the check is for a machine with no card")
def test_gpu_node_without_a_card_raises(tmp_path):
    home = _one_home(tmp_path)
    cfg = _off(TConfig.load(home))
    cfg.crypto.backend = "gpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TNode(cfg)


# ----------------------------------------------------------------- the CLI


def _cli(mod, argv, capsys) -> tuple[int, str]:
    rc = mod.main(argv)
    return rc, capsys.readouterr().out


def test_cli_key_and_reset_commands_act_as_the_reference_s(tmp_path, capsys):
    home = _one_home(tmp_path)
    homes = {"j": str(tmp_path / "j"), "t": str(tmp_path / "t")}
    for h in homes.values():
        shutil.copytree(home, h)
    out = {}
    for s, mod in (("j", jcmd), ("t", tcmd)):
        h = homes[s]
        res = [_cli(mod, ["--home", h, c], capsys) for c in ("show-node-id", "show-validator")]
        rc, gv = _cli(mod, ["gen-validator"], capsys)
        doc = json.loads(gv)
        res.append((rc, sorted(doc), doc["pub_key"]["type"]))
        # gen-node-key refuses a home that has one
        res.append(mod.main(["--home", h, "gen-node-key"]))
        capsys.readouterr()
        os.remove(os.path.join(h, "config/node_key.json"))
        rc, nid = _cli(mod, ["--home", h, "gen-node-key"], capsys)
        res.append((rc, len(nid.strip())))
        # a WAL with a torn tail: wal-repair reports clean (the tail is a
        # crash artifact, truncated on replay), then the resets
        os.makedirs(os.path.join(h, "data/cs.wal"), exist_ok=True)
        rc, txt = _cli(mod, ["--home", h, "wal-repair"], capsys)
        res.append((rc, txt.strip()))
        open(os.path.join(h, "data/state.db"), "wb").close()
        rc, txt = _cli(mod, ["--home", h, "unsafe-reset-all"], capsys)
        res.append((rc, txt.replace(h, "<h>")))
        res.append(_cli(mod, ["--home", h, "unsafe-reset-priv-validator"], capsys)[0])
        res.append(_cli(mod, ["--home", h, "reset-state"], capsys)[0])
        res.append(sorted(json.load(open(os.path.join(h, "data/priv_validator_state.json")))))
        out[s] = res
    assert out["t"] == out["j"]
    rc, v = _cli(tcmd, ["version"], capsys)
    assert rc == 0 and v.strip() == "0.1.0-gpu"
    assert tcmd.main(["--home", homes["t"], "reset-priv-validator"]) == 0


# the commands queued until their slices landed (compact-db, light and
# rollback with the bootstrap slice, debug, inspect and loadtime since); each
# answers as the reference's does
CLI_QUEUED = ("compact-db", "debug", "inspect", "light", "loadtime", "rollback")


@pytest.mark.parametrize("command", CLI_QUEUED)
def test_cli_queued_commands_raise(tmp_path, command, capsys):
    """Each once-queued command, on a home that holds nothing, acts as the
    reference's: the same return code or error, and the same output."""
    assert not hasattr(tcmd, "QUEUED")
    argv = {"light": ["light", "c", "--primary", "127.0.0.1:1", "--trusted-height", "1",
                      "--trusted-hash", "00"],
            "loadtime": ["loadtime", "run"],
            # nothing listens there: every route's error lands in the bundle
            "debug": ["debug", "--rpc.laddr", "tcp://127.0.0.1:1", "--output",
                      "<h>/bundle.tar.gz"]}.get(command, [command])
    extra = ["--crypto_backend", "cpu"] if command == "light" else []
    got = {}
    for side, mod in (("j", jcmd), ("t", tcmd)):
        home = str(tmp_path / side)
        if command == "debug":
            os.makedirs(home)
        args = [a.replace("<h>", home) for a in argv]
        try:
            got[side] = ("rc", mod.main(["--home", home] + args + (extra if side == "t" else [])))
        except Exception as e:  # noqa: BLE001 - the two must fail alike
            got[side] = (type(e).__name__, str(e).replace(home, "<h>"))
        got[side] += (capsys.readouterr().out.replace(home, "<h>"),)
    assert got["t"] == got["j"]
    if command == "debug":
        import tarfile

        with tarfile.open(tmp_path / "t" / "bundle.tar.gz") as tar:
            names = tar.getnames()
        assert set(names) >= {"status.json", "net_info.json"}


def test_cli_start_refuses_a_default_home(tmp_path):
    """A home `init` wrote keeps the reference's defaults (RPC, PEX and
    certificates on). `start` refused it until the certificate plane was
    ported; now it starts it unedited and commits with the plane on (only
    the listen addresses are given on the command line, so parallel runs
    do not share a port)."""
    home = str(tmp_path / "h")
    tcmd.main(["--home", home, "init"])
    code = (
        "import asyncio, sys\n"
        "from cometbft_tpu_torch.cmd import main\n"
        "from cometbft_tpu_torch.node import node as n\n"
        "seen = {}\n"
        "real_start = n.Node.on_start\n"
        "async def on_start(self):\n"
        "    seen['node'] = self\n"
        "    await real_start(self)\n"
        "n.Node.on_start = on_start\n"
        "real_run = asyncio.run\n"
        "async def bounded(coro):\n"
        "    task = asyncio.ensure_future(coro)\n"
        "    while 'node' not in seen or seen['node'].block_store.height() < 2:\n"
        "        assert not task.done(), task.exception()\n"
        "        await asyncio.sleep(0.05)\n"
        "    task.cancel()\n"
        "    try:\n"
        "        await task\n"
        "    except asyncio.CancelledError:\n"
        "        pass\n"
        "asyncio.run = lambda coro: real_run(asyncio.wait_for(bounded(coro), 60))\n"
        f"main(['--home', {home!r}, 'start', '--crypto_backend', 'cpu', '--log_level', 'error',\n"
        "      '--p2p.laddr', 'tcp://127.0.0.1:0', '--rpc.laddr', 'tcp://127.0.0.1:0'])\n"
        "node = seen['node']\n"
        "assert node.config.cert.enabled and node.cert_plane is not None\n"
        "print('started', node.block_store.height(), node.cert_plane.uncertifiable > 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.split()[0] == "started" and int(proc.stdout.split()[1]) >= 2


# ------------------------------------------------- planes held since the RPC slice


async def _plane_node(cfg, until: int = 2):
    node = TNode(cfg)
    await node.start()
    try:
        async def poll():
            while node.block_store.height() < until:
                assert not node.consensus_state.failed
                await asyncio.sleep(0.02)

        await asyncio.wait_for(poll(), 60.0)
        return node, await _ask_plane(node, cfg)
    finally:
        await node.stop()


async def _ask_plane(node, cfg):
    from tests import torch_rpc_client as rpc

    if cfg.rpc.laddr:
        addr = node.rpc_server.bound_addr
        got = await rpc.post(addr, "broadcast_tx_commit", {"tx": rpc.b64(b"plane=rpc")})
        return (await rpc.get(addr, "/status"))["result"]["node_info"]["id"], got["result"]
    if cfg.grpc.laddr:
        from cometbft_tpu_torch.rpc.grpc_services import GRPCServicesClient

        client = GRPCServicesClient(node.grpc_bound)
        try:
            return await client.call("VersionService", "GetVersion")
        finally:
            await client.close()
    if cfg.grpc.privileged_laddr:
        from cometbft_tpu_torch.rpc.grpc_services import GRPCServicesClient

        client = GRPCServicesClient(node.grpc_priv_bound)
        try:
            await client.call("PruningService", "SetBlockRetainHeight", {"height": 1})
            return await client.call("PruningService", "GetBlockRetainHeight")
        finally:
            await client.close()
    return None


def _socket_app(cfg):
    from cometbft_tpu_torch.abci.server import ABCIServer

    srv = ABCIServer(TKV(), "tcp://127.0.0.1:0")

    async def run():
        await srv.start()
        cfg.base.proxy_app = "tcp://" + srv.bound_addr().removeprefix("tcp://")
        try:
            return await _plane_node(cfg)
        finally:
            await srv.stop()

    return asyncio.run(run())


def _grpc_app(cfg):
    from cometbft_tpu_torch.abci.grpc import serve_grpc

    srv, bound = serve_grpc(TKV(), "grpc://127.0.0.1:0")
    cfg.base.proxy_app = "grpc://" + bound.removeprefix("grpc://")
    try:
        return asyncio.run(_plane_node(cfg))
    finally:
        srv.stop(None)


LANDED = [
    ("rpc", lambda c: setattr(c.rpc, "laddr", "tcp://127.0.0.1:0")),
    ("grpc", lambda c: setattr(c.grpc, "laddr", "tcp://127.0.0.1:0")),
    ("grpc_priv", lambda c: setattr(c.grpc, "privileged_laddr", "tcp://127.0.0.1:0")),
    ("pex", lambda c: setattr(c.p2p, "pex", True)),
    ("socket_app", None),
    ("grpc_app", None),
]


@pytest.mark.allow_task_leaks  # a grpc.aio channel's close can outlive the check
@pytest.mark.parametrize("plane,set_", LANDED, ids=[p[0] for p in LANDED])
def test_node_starts_each_plane_it_holds(tmp_path, plane, set_):
    home = _one_home(tmp_path)
    cfg = _off(TConfig.load(home))
    if set_ is not None:
        set_(cfg)
    if plane == "socket_app":
        node, got = _socket_app(cfg)
    elif plane == "grpc_app":
        node, got = _grpc_app(cfg)
    else:
        node, got = asyncio.run(_plane_node(cfg))
    assert node.block_store.height() >= 2
    if plane == "rpc":
        nid, commit = got
        assert nid == node.node_key.id()
        assert commit["check_tx"]["code"] == 0 and commit["tx_result"]["code"] == 0
        assert int(commit["height"]) >= 1
    elif plane == "grpc":
        assert got["node"] == "0.1.0-gpu" and got["block"] == 11
    elif plane == "grpc_priv":
        assert got["pruning_service_retain_height"] == "1" and node.pruner.companion_enabled
    elif plane == "pex":
        assert "PEX" in node.switch.reactors and node.addr_book is not None
        assert os.path.exists(os.path.join(home, "config", "addrbook.json"))
    else:
        # the app ran in its server: the node's own app object is unused
        assert node.app is None


# ------------------------------------------------- the CLI's RPC clients


def hold_at(node, height: int) -> asyncio.Event:
    """Hold a node of either package at `height`: once it commits that
    height, its next height waits an hour for its first round. The event is
    set then."""
    cs = node.consensus_state
    held = asyncio.Event()
    update_to_state = cs.update_to_state

    def hold(state):
        if state.last_block_height == height:
            cs.config.timeout_commit = 3600.0
            cs.config.skip_timeout_commit = False
            held.set()
        update_to_state(state)

    cs.update_to_state = hold
    return held


async def _held_node(Node, Config, home: str, height: int = 3):
    """A node of either package with RPC on, held at `height`."""
    cfg = _off(Config.load(home))
    cfg.rpc.laddr = "tcp://127.0.0.1:0"
    cfg.base.log_level = "error"
    node = Node(cfg)
    held = hold_at(node, height)
    await node.start()
    await asyncio.wait_for(held.wait(), 60.0)
    return node


@pytest.mark.parametrize("command", ["trace-dump", "netinfo", "heightline"])
def test_cli_rpc_clients_print_what_the_reference_s_print(tmp_path, capsys, command):
    home = _one_home(tmp_path)

    async def drive(Node, Config, h):
        node = await _held_node(Node, Config, h)
        loop = asyncio.get_running_loop()
        addr = node.rpc_server.bound_addr
        out = {}
        try:
            for side, mod in (("j", jcmd), ("t", tcmd)):
                argv = {"trace-dump": ["trace-dump", "--rpc.laddr", addr,
                                       "--output", str(tmp_path / f"{side}.json")],
                        "netinfo": ["netinfo", "--rpc.laddr", addr, "--compact"],
                        "heightline": ["heightline", "--rpc.laddr", addr, "--json",
                                       "--compact"]}[command]
                rc = await loop.run_in_executor(None, mod.main, argv)
                text = capsys.readouterr().out.replace(str(tmp_path / f"{side}.json"), "<out>")
                if command == "trace-dump":
                    text += (tmp_path / f"{side}.json").read_text()
                out[side] = (rc, text)
        finally:
            await node.stop()
        return out

    for side, (Node, Config) in (("jax", (JNode, JConfig)), ("port", (TNode, TConfig))):
        h = str(tmp_path / side)
        shutil.copytree(home, h)
        got = asyncio.run(drive(Node, Config, h))
        assert got["t"] == got["j"], side
        assert got["t"][0] == 0 and got["t"][1]
