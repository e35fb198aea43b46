"""The node's support libraries in the port, held against the JAX
package's on the CPU: metrics exposition, overload decisions, pubsub and
the event bus, the kv indexers, the disk stores with their CRC envelope,
the disk-fault seams, the config file and crypto/batch.configure.

Each check drives both packages with the same inputs and compares what
comes out: text, decisions, search results or raised errors.
"""

from __future__ import annotations

import asyncio
import errno

import pytest

from cometbft_tpu.abci import types as jabci
from cometbft_tpu.config import config as jcfg
from cometbft_tpu.libs import diskchaos as jdc
from cometbft_tpu.libs import diskio as jdio
from cometbft_tpu.libs import metrics as jm
from cometbft_tpu.libs import overload as jo
from cometbft_tpu.libs import pubsub as jps
from cometbft_tpu.state import txindex as jti
from cometbft_tpu.store import db as jdb
from cometbft_tpu.types import event_bus as jeb
from cometbft_tpu_torch.abci import types as tabci
from cometbft_tpu_torch.config import config as tcfg
from cometbft_tpu_torch.crypto import batch as tbatch
from cometbft_tpu_torch.libs import diskchaos as tdc
from cometbft_tpu_torch.libs import diskio as tdio
from cometbft_tpu_torch.libs import metrics as tm
from cometbft_tpu_torch.libs import overload as to
from cometbft_tpu_torch.libs import pubsub as tps
from cometbft_tpu_torch.state import txindex as tti
from cometbft_tpu_torch.store import db as tdb
from cometbft_tpu_torch.types import event_bus as teb

SIDES = {
    "jax": dict(m=jm, o=jo, ps=jps, eb=jeb, abci=jabci, ti=jti, db=jdb, dc=jdc, dio=jdio,
                cfg=jcfg),
    "port": dict(m=tm, o=to, ps=tps, eb=teb, abci=tabci, ti=tti, db=tdb, dc=tdc, dio=tdio,
                 cfg=tcfg),
}


@pytest.fixture(autouse=True)
def _disarmed():
    for dc in (jdc, tdc):
        dc.reset()
    yield
    for dc in (jdc, tdc):
        dc.reset()


# ------------------------------------------------------------- metrics


def _observe(m) -> str:
    """One observation sequence over the node's metric sets; the text
    exposition of the registry."""
    reg = m.Registry()
    cs = m.ConsensusMetrics(reg)
    mp = m.MempoolMetrics(reg)
    p2p = m.P2PMetrics(reg, peer_cap=2)
    ev = m.EvidenceMetrics(reg)
    st = m.StateMetrics(reg)
    sto = m.StorageMetrics(reg)
    ovl = m.OverloadMetrics(reg)
    for h in range(1, 4):
        cs.height.set(h)
        cs.rounds.set(h % 2)
        cs.num_txs.set(2 * h)
        cs.total_txs.inc(2 * h)
        cs.block_size.set(1000 + h)
        cs.block_interval.observe(0.1 * h)
        cs.validators.set(4)
        cs.validators_power.set(40)
        cs.batch_flushes.inc()
        cs.batch_lanes.inc(3)
    cs.vote_extension_received.labels("accepted").inc(2)
    cs.vote_extension_received.labels("rejected").inc()
    mp.size.set(7)
    mp.size_bytes.set(700)
    mp.failed_txs.inc(2)
    mp.recheck_times.inc()
    labels = [p2p.peer_label(f"{i:040x}") for i in range(3)]
    for i, lab in enumerate(labels):
        p2p.record_conn_traffic(lab, {0x20: (100 * (i + 1), 1), 0x22: (64, 2)}, send=True)
        p2p.record_conn_traffic(lab, {0x21: (50, 1)}, send=False)
        p2p.peer_ping_rtt.labels(lab).set(0.001 * (i + 1))
    p2p.peers.set(3)
    p2p.peer_misbehavior.labels("bad_sig").inc()
    p2p.peer_bans.inc()
    p2p.release_peer(f"{0:040x}")
    ev.evidence_committed.inc(2)
    ev.evidence_pending.set(1)
    st.block_processing_time.observe(0.02)
    sto.observe_wal_fsync(0.004)
    sto.observe_db_write(0.0007)
    sto.wal_truncations.inc()
    sto.corruption_detected.inc()
    ovl.level.labels("mempool").set(1)
    ovl.sheds.labels("mempool").inc(3)
    return reg.render()


def test_metrics_exposition_is_the_reference_s():
    jax, port = _observe(jm), _observe(tm)
    assert "cometbft_consensus_height 3" in port and "peer=\"other\"" in port
    assert port == jax


def test_crypto_backend_gauge_takes_the_port_s_backends():
    g = tm.crypto_metrics().backend_active
    try:
        tbatch.set_backend("gpu")
        assert (g.value("gpu"), g.value("cpu")) == (1.0, 0.0)
        tbatch.set_backend("cpu")
        assert (g.value("gpu"), g.value("cpu")) == (0.0, 1.0)
        for bad in ("auto", "tpu"):
            with pytest.raises(ValueError, match="'gpu', 'cpu'"):
                tbatch.set_backend(bad)
        assert tbatch.get_backend() == "cpu"
    finally:
        tbatch.set_backend("cpu")


# ------------------------------------------------------------- overload


class _Signal:
    def __init__(self):
        self.v = 0.0

    def __call__(self):
        return self.v


def _pressure(o, m) -> list:
    """Levels, retry hints and sheds over one pressure sequence."""
    t = [0.0]
    reg = o.OverloadRegistry(clock=lambda: t[0])
    sig, other = _Signal(), _Signal()
    reg.register("mempool", sig)
    reg.register("sched", other)
    reg.register("events", lambda: 1 / 0)  # a broken signal reads normal
    out = []
    for i, v in enumerate((0.1, 0.6, 0.59, 0.55, 0.49, 0.95, 0.85, 0.79, 0.2, 1.3)):
        t[0] = float(i)
        sig.v, other.v = v, 1.0 - v
        out.append((reg.level("mempool"), reg.level("sched"), reg.level("events"),
                    reg.overall(), reg.retry_after_ms("mempool"), reg.retry_after_ms("sched")))
        if reg.level("mempool") >= o.SATURATED:
            reg.shed("mempool", i)
    h = reg.health()
    out.append((reg.sheds("mempool"), reg.total_sheds(),
                {k: (p["level"], p["transitions"]) for k, p in h["planes"].items()}))
    return out


def test_overload_decisions_are_the_reference_s():
    jax, port = _pressure(jo, jm), _pressure(to, tm)
    assert any(r[0] == to.SATURATED for r in port[:-1])
    assert port == jax


# ------------------------------------------------------ pubsub, event bus


def _finalize_result(abci):
    ev = abci.Event
    at = abci.EventAttribute
    txs = [b"k0=v0", b"name=satoshi", b"k/2=v/2"]
    results = [
        abci.ExecTxResult(code=0, events=[
            ev("app", [at("creator", "Cosmoshi Netowoko"), at("key", t.split(b"=")[0].decode()),
                       at("index_key", "index is working"), at("noindex_key", "x", index=False)])])
        for t in txs]
    results[1].events.append(ev("transfer", [at("amount", "42"), at("recipient", "b'o=b")]))
    resp = abci.ResponseFinalizeBlock(
        events=[ev("begin", [at("height", "5")]), ev("", [at("dropped", "1")])],
        tx_results=results, app_hash=b"\x01" * 8)
    return txs, resp


QUERIES = (
    "tm.event = 'Tx'",
    "tm.event = 'NewBlock'",
    "app.creator = 'Cosmoshi Netowoko'",
    "app.key = 'name' AND tm.event = 'Tx'",
    "transfer.amount > 41",
    "transfer.amount >= 43",
    "app.index_key CONTAINS 'working'",
    "app.noindex_key EXISTS",
    "begin.height = 5",
    "tx.height = 5 AND app.key = 'k/2'",
    "transfer.recipient = 'b\\'o=b'",
)


async def _bus_run(s) -> list:
    bus = s["eb"].EventBus()
    subs = [bus.subscribe(f"c{i}", q) for i, q in enumerate(QUERIES)]
    txs, resp = _finalize_result(s["abci"])
    await bus.publish_event_new_block("block", "block-id", resp)
    for i, tx in enumerate(txs):
        await bus.publish_event_tx(5, tx, i, resp.tx_results[i])
    out = []
    for q, sub in zip(QUERIES, subs):
        got = []
        while not sub.out.empty():
            msg = sub.out.get_nowait()
            d = msg.data
            got.append((type(d).__name__, getattr(d, "index", None), getattr(d, "tx", None),
                        sorted(msg.events.items())))
        out.append((q, got))
    return out


def test_event_bus_matches_the_reference_s():
    jax, port = asyncio.run(_bus_run(SIDES["jax"])), asyncio.run(_bus_run(SIDES["port"]))
    assert [len(g) for _, g in port] == [3, 1, 3, 1, 1, 0, 3, 0, 1, 1, 1]
    assert port == jax


@pytest.mark.parametrize("query", ["a.b = 'x' AND", "a.b => 3", "a.b = x'", "= 'x'"])
def test_query_errors_are_the_reference_s(query):
    errs = []
    for ps in (jps, tps):
        with pytest.raises(ps.QueryError) as e:
            ps.Query(query)
        errs.append(str(e.value))
    assert errs[0] == errs[1]


# ----------------------------------------------------------- kv indexers


def _index_and_search(s) -> list:
    ti, abci = s["ti"], s["abci"]
    db = s["db"].MemDB()
    txi, bli = ti.TxIndexer(db), ti.BlockIndexer(db)
    for h in (3, 4, 5, 6):
        txs, resp = _finalize_result(abci)
        for i, tx in enumerate(txs):
            txi.index(ti.TxResult(h, i, tx + b"@%d" % h, resp.tx_results[i]))
        bli.index(h, resp.events)
    qs = ["tx.height = 5", "tx.height >= 4 AND app.key = 'name'", "app.creator = 'Cosmoshi Netowoko'",
          "transfer.amount > 41", "transfer.amount < 41", "app.index_key CONTAINS 'work'",
          "app.key EXISTS AND tx.height < 4", "app.noindex_key EXISTS", "tm.event = 'Tx'"]
    out = [[(r.height, r.index, r.tx) for r in txi.search(q)] for q in qs]
    h = ti.TxResult(5, 1, b"name=satoshi@5", None)
    from_hash = txi.search(f"tx.hash = '{_tx_hash(h.tx)}'")
    out.append([(r.height, r.index, r.tx, r.result.events[0].attributes[0].value)
                for r in from_hash])
    out.append([bli.search(q) for q in ("begin.height = 5", "block.height >= 5", "begin.height > 2")])
    out.append((txi.prune(5), bli.prune(5), [k for k, _ in db.iterate()]))
    return out


def _tx_hash(tx: bytes) -> str:
    import hashlib

    return hashlib.sha256(tx).hexdigest().upper()


def test_kv_indexer_search_and_prune_are_the_reference_s():
    jax, port = _index_and_search(SIDES["jax"]), _index_and_search(SIDES["port"])
    assert len(port[0]) == 3 and port[1] == [(4, 1, b"name=satoshi@4"), (5, 1, b"name=satoshi@5"),
                                              (6, 1, b"name=satoshi@6")]
    assert port == jax


# -------------------------------------------------------- disk stores


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_sqlite_crc_store_reads_across_packages(tmp_path, writer):
    reader = "port" if writer == "jax" else "jax"
    path = str(tmp_path / "s.db")
    w = SIDES[writer]["db"].open_db("sqlite", path, synchronous="FULL", checksum=True)
    w.batch_set([(b"a", b"1"), (b"b", b"22"), (b"c", None), (b"d", b"\x00" * 40)])
    w.set(b"e", b"five")
    w.delete(b"b")
    w.close()
    values = {}
    for side in (writer, reader):
        r = SIDES[side]["db"].open_db("sqlite", path, checksum=True)
        values[side] = (list(r.iterate()), r.get(b"e"), r.get(b"b"), r.has(b"a"))
        r.close()
    assert values[writer] == values[reader]
    assert values["port"][0] == [(b"a", b"1"), (b"d", b"\x00" * 40), (b"e", b"five")]


@pytest.mark.parametrize("damage", ["flip_payload", "flip_crc", "drop_tag", "truncate"])
def test_crc_store_corruption_raises_the_reference_s_error(tmp_path, damage):
    msgs = {}
    for side in ("jax", "port"):
        db = SIDES[side]["db"]
        path = str(tmp_path / f"{side}.db")
        raw = db.SQLiteDB(path)
        db.CRCStore(raw).set(b"H:1", b"block-bytes")
        v = bytearray(raw.get(b"H:1"))
        if damage == "flip_payload":
            v[3] ^= 0x10
        elif damage == "flip_crc":
            v[-1] ^= 0x01
        elif damage == "drop_tag":
            v = v[1:]
        else:
            v = v[:3]
        raw.set(b"H:1", bytes(v))
        with pytest.raises(db.ErrCorruptValue) as e:
            db.CRCStore(raw).get(b"H:1")
        msgs[side] = (str(e.value), e.value.key)
        raw.close()
    assert msgs["jax"] == msgs["port"]


@pytest.mark.parametrize("site,kind,op", [
    ("db.write", "enospc", "set"), ("db.write", "eio", "batch"), ("db.read", "eio", "get"),
    ("privval.save", "eio", "replace"), ("wal.rotate", "enospc", "replace"),
    ("db.read", "bitrot", "get")])
def test_disk_fault_seams_are_the_reference_s(tmp_path, site, kind, op):
    """The same armed fault at the same seam: the same errno, or the same
    rotted bytes, and the same fired count."""
    seen = {}
    for side in ("jax", "port"):
        s = SIDES[side]
        d = tmp_path / side
        d.mkdir()
        store = s["db"].SQLiteDB(str(d / "kv.db"))
        store.set(b"k", b"value-bytes")
        src = d / "src"
        src.write_bytes(b"new")
        s["dc"].arm(site, kind, 1)
        try:
            if op == "set":
                store.set(b"x", b"y")
            elif op == "batch":
                store.batch_set([(b"x", b"1"), (b"y", b"2"), (b"z", b"3")])
            elif op == "get":
                got = store.get(b"k")
                seen[side] = ("value", got, s["dc"].fired(site))
            else:
                s["dio"].durable_replace(str(src), str(d / "dst"), site=site)
        except OSError as e:
            seen[side] = ("errno", e.errno, s["dc"].fired(site),
                          sorted(k for k, _ in store.iterate()))
        finally:
            store.close()
            s["dc"].reset()
    assert seen["jax"] == seen["port"]
    assert seen["port"][0] == ("value" if kind == "bitrot" else "errno")
    if kind != "bitrot":
        assert seen["port"][1] in (errno.EIO, errno.ENOSPC)


def test_disk_fault_specs_parse_as_the_reference_s():
    spec = "wal.fsync=fsync_lie:1,db.read=bitrot,blockstore.save=enospc:2"
    assert tdc.parse_spec(spec) == jdc.parse_spec(spec)
    for bad in ("nowhere=eio", "db.read=melt", "db.read"):
        with pytest.raises(ValueError):
            tdc.parse_spec(bad)
        with pytest.raises(ValueError):
            jdc.parse_spec(bad)


# ---------------------------------------------------------------- config


def test_config_toml_is_the_reference_s_but_the_backend_line(tmp_path):
    jc, tc = jcfg.Config(home=str(tmp_path / "j")), tcfg.Config(home=str(tmp_path / "t"))
    for c in (jc, tc):
        c.base.moniker = "m0"
        c.p2p.persistent_peers = "ab@127.0.0.1:1,cd@127.0.0.1:2"
        c.state_sync.rpc_servers = ["a:1", "b \"quoted\" \\ 2"]
        c.crypto.sched_mempool_deadline = 0.02
    jt, tt = open(jc.save()).read().splitlines(), open(tc.save()).read().splitlines()
    diff = [(a, b) for a, b in zip(jt, tt) if a != b]
    assert len(jt) == len(tt) and diff == [('backend = "auto"', 'backend = "gpu"')]
    back = tcfg.Config.load(tc.home)
    assert back.to_toml() == tc.to_toml() and back.crypto.backend == "gpu"
    assert back.state_sync.rpc_servers == ["a:1", "b \"quoted\" \\ 2"]
    # a file the reference saved loads in the port, every field but the backend
    jfile = tcfg.Config.load(jc.home)
    jfile.crypto.backend = "gpu"
    assert jfile.to_toml() == tc.to_toml()


@pytest.mark.parametrize("backend", ["auto", "tpu", "cuda", ""])
def test_config_refuses_backends_the_port_does_not_have(backend):
    c = tcfg.Config()
    c.crypto.backend = backend
    with pytest.raises(ValueError, match='"gpu".*"cpu"'):
        c.validate_basic()
    c.crypto.backend = "cpu"
    c.validate_basic()


def test_crypto_configure_sets_every_knob_it_has():
    from cometbft_tpu_torch import sched
    from cometbft_tpu_torch.crypto import bls12381
    from cometbft_tpu_torch.libs import chaos
    from cometbft_tpu_torch.ops import challenge, dispatch, residency
    from cometbft_tpu_torch.parallel import mesh

    c = tcfg.Config().crypto
    c.backend = "cpu"
    c.sched_max_lanes = 512
    c.sched_sync_deadline = 0.003
    c.mesh_placement = "spread"
    c.wire_indexed_sends = False
    c.wire_table_rows = 1024
    c.wire_device_challenge = False
    c.bls_enabled = False
    c.breaker_failure_threshold = 5
    c.watchdog_timeout = 60.0
    c.chaos = "ed25519.dispatch=transient:1"
    try:
        tbatch.configure(c)
        s = sched.get()
        assert tbatch.get_backend() == "cpu" and s.max_lanes == 512
        assert s.class_deadline[sched.SYNC] == 0.003
        assert mesh._cfg["placement"] == "spread"
        assert not residency.enabled() and residency._cfg["rows"] == 1024
        assert not challenge.enabled() and challenge.plan_batch([b"m"] * 8, [True] * 8) is None
        assert not bls12381.enabled()
        assert dispatch._config["failure_threshold"] == 5 and dispatch.watchdog_timeout() == 60.0
        assert chaos.armed("ed25519.dispatch") == "transient"
        c.max_batch_size = 8192
        with pytest.raises(NotImplementedError, match="max_batch_size"):
            tbatch.configure(c)
    finally:
        tbatch.configure(tcfg.Config().crypto)
        tbatch.set_backend("cpu")
        chaos.reset()
        sched.reset()
    assert residency.enabled() and challenge.enabled() and bls12381.enabled()
    assert sched.get().max_lanes == 16384


def test_residency_off_stages_the_full_path():
    """wire_indexed_sends off: a batch's keys take the full path, and its
    verdicts do not change."""
    from cometbft_tpu_torch.crypto import ed25519
    from cometbft_tpu_torch.ops import ed25519_kernel as EK
    from cometbft_tpu_torch.ops import residency

    privs = [ed25519.gen_priv_key_from_secret(b"res%d" % i) for i in range(6)]
    msgs = [b"msg-%d" % i for i in range(6)]
    sigs = [p.sign(m) for p, m in zip(privs, msgs)]
    sigs[2] = sigs[3]
    pubs = [p.pub_key().bytes_() for p in privs]
    out = {}
    try:
        for on in (True, False):
            residency.configure(enabled=on)
            residency.reset_send_stats()
            mask = EK.resolve_batches([EK.verify_batch_async(
                EK.ED25519, pubs, msgs, sigs, device="cpu")])[0]
            stats = residency.send_stats()
            out[on] = ([bool(x) for x in mask], {p: stats[p]["sends"] > 0 for p in ("indexed", "full")})
    finally:
        residency.configure(enabled=True)
    assert out[True][0] == out[False][0] == [True, True, False, True, True, True]
    assert out[True][1]["indexed"]
    assert out[False][1]["full"] and not out[False][1]["indexed"]
