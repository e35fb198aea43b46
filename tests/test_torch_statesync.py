"""The port's state sync (statesync/) against the JAX package's on the CPU:
the same seeded inputs through both packages, bit for bit.

- the bytes of every statesync message, and their decoding;
- SnapshotPool's ranking and its memory of rejected snapshots, formats
  and peers under one seeded sequence of offers and rejections;
- ChunkQueue's allocation, ordered delivery and retries;
- the outcome of each Syncer case against a scripted kvstore app (restore,
  a lying app hash, no snapshots, each OfferSnapshot and
  ApplySnapshotChunk verdict): the exception, the restored app's height,
  hash and state, and what the pool keeps;
- LightClientStateProvider's app hash, commit and State at a height of a
  light chain carried into the port through its proto bytes;
- one state sync between two port Nodes on the CPU: a fresh node with
  statesync.enable restores a live node's snapshot, anchored by its light
  client over the live node's RPC, and block-syncs past it.
"""

from __future__ import annotations

import asyncio
import hashlib
import random

import pytest

from cometbft_tpu import light as jlight
from cometbft_tpu import statesync as jss
from cometbft_tpu.abci import types as jabci
from cometbft_tpu.abci.kvstore import KVStoreApplication as JKV
from cometbft_tpu.light.provider import MemProvider as JMemProvider
from cometbft_tpu.light.store import LightStore as JLightStore
from cometbft_tpu.proxy import AppConns as JAppConns
from cometbft_tpu.proxy import local_client_creator as j_local
from cometbft_tpu.state.state import State as JState
from cometbft_tpu.statesync import messages as jsm
from cometbft_tpu.store.db import MemDB as JMemDB
from cometbft_tpu_torch import light as tlight
from cometbft_tpu_torch import statesync as tss
from cometbft_tpu_torch.abci import types as tabci
from cometbft_tpu_torch.abci.kvstore import KVStoreApplication as TKV
from cometbft_tpu_torch.light.provider import MemProvider as TMemProvider
from cometbft_tpu_torch.light.store import LightStore as TLightStore
from cometbft_tpu_torch.proxy import AppConns as TAppConns
from cometbft_tpu_torch.proxy import local_client_creator as t_local
from cometbft_tpu_torch.state.state import State as TState
from cometbft_tpu_torch.statesync import messages as tsm
from cometbft_tpu_torch.store import MemDB as TMemDB
from tests.torch_consumers import CHAIN, PERIOD_NS, Chain, fresh_backends

SIDES = {
    "jax": dict(ss=jss, sm=jsm, abci=jabci, KV=JKV, AppConns=JAppConns, local=j_local,
                State=JState),
    "port": dict(ss=tss, sm=tsm, abci=tabci, KV=TKV, AppConns=TAppConns, local=t_local,
                 State=TState),
}


@pytest.fixture(autouse=True)
def _fresh():
    yield from fresh_backends()


# ------------------------------------------------------------- messages

MESSAGES = [
    ("snapshots_request", "SnapshotsRequest", {}),
    ("snapshots_response", "SnapshotsResponse",
     dict(height=120, format=1, chunks=5, hash_=b"\x11" * 32, metadata=b"meta")),
    ("snapshots_response_empty", "SnapshotsResponse", {}),
    ("chunk_request", "ChunkRequest", dict(height=120, format=1, index=3)),
    ("chunk_response", "ChunkResponse",
     dict(height=120, format=1, index=3, chunk=bytes(range(256)) * 4)),
    ("chunk_response_missing", "ChunkResponse",
     dict(height=120, format=1, index=4, missing=True)),
]


@pytest.mark.parametrize("label,cls,fields", MESSAGES, ids=[m[0] for m in MESSAGES])
def test_message_bytes_are_the_reference_s(label, cls, fields):
    jraw = jsm.encode(getattr(jsm, cls)(**fields))
    traw = tsm.encode(getattr(tsm, cls)(**fields))
    assert traw == jraw
    back = tsm.decode(traw)
    assert type(back).__name__ == cls
    assert vars(back) == vars(jsm.decode(jraw))


# ----------------------------------------------------------- snapshot pool


def _pool_script(side: str, seed: int) -> list:
    """One seeded sequence of offers, rejections and peer removals; every
    answer and every best() on the way."""
    ss = SIDES[side]["ss"]
    rng = random.Random(seed)
    pool = ss.SnapshotPool()
    snaps = [ss.Snapshot(height=rng.randrange(1, 6) * 10, format=rng.randrange(1, 3),
                         chunks=rng.randrange(1, 4), hash_=bytes([i]) * 32)
             for i in range(10)]
    peers = [f"peer{i}" for i in range(5)]
    out = []
    for _ in range(80):
        op = rng.randrange(10)
        if op < 5:
            s = rng.choice(snaps)
            out.append(("add", pool.add(rng.choice(peers), s)))
        elif op == 5:
            best = pool.best()
            if best is not None:
                pool.reject(best)
            out.append(("reject", best and best.key()))
        elif op == 6:
            f = rng.randrange(1, 3)
            pool.reject_format(f)
            out.append(("reject_format", f))
        elif op == 7:
            p = rng.choice(peers)
            pool.reject_peer(p)
            out.append(("reject_peer", p))
        else:
            p = rng.choice(peers)
            pool.remove_peer(p)
            out.append(("remove_peer", p))
        best = pool.best()
        out.append(("best", best and best.key(), best and pool.peers_of(best), len(pool)))
    return out


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_snapshot_pool_ranks_and_rejects_as_the_reference(seed):
    assert _pool_script("port", seed) == _pool_script("jax", seed)


# ------------------------------------------------------------- chunk queue


def _queue_script(side: str) -> list:
    ss = SIDES[side]["ss"]

    async def main():
        q = ss.ChunkQueue(4)
        out = [await q.allocate() for _ in range(5)]
        for i, c in ((2, b"c"), (0, b"a"), (0, b"dup"), (7, b"x"), (1, b"b")):
            out.append(await q.add(i, c, f"p{i}"))
        out += [await q.next_chunk(1) for _ in range(3)]
        out.append((q.done(), q.sender_of(1)))
        await q.retry(1)
        out.append(await q.allocate())
        out.append(await q.add(1, b"b2", "p9"))
        out.append(await q.add(3, b"d", "p3"))
        out += [await q.next_chunk(1) for _ in range(3)]
        out.append((q.done(), q.sender_of(1)))
        await q.retry_all()
        out.append([await q.allocate() for _ in range(5)])
        await q.close()
        try:
            await q.allocate()
        except Exception as e:  # noqa: BLE001 - the class is compared
            out.append(type(e).__name__)
        out.append(await q.add(0, b"late", "p"))
        return out

    return asyncio.run(main())


def test_chunk_queue_orders_and_retries_as_the_reference():
    assert _queue_script("port") == _queue_script("jax")


# ------------------------------------------------------------ the syncer


def _serving_app(side: str, n_keys: int = 48, interval: int = 4, heights: int = 8):
    """A kvstore that committed `heights` blocks, snapshotting every
    `interval` in chunks of 256 bytes."""
    s = SIDES[side]
    app = s["KV"]()
    app.SNAPSHOT_CHUNK_SIZE = 256
    app.snapshot_interval = interval
    for h in range(1, heights + 1):
        txs = [f"k{h}-{i}=v{i}".encode() for i in range(n_keys // heights)]
        app.finalize_block(s["abci"].RequestFinalizeBlock(txs=txs, height=h))
        app.commit(s["abci"].RequestCommit())
    return app


class _Direct:
    """A StateProvider pinning given trusted data."""

    def __init__(self, app_hash, state, commit):
        self._app_hash, self._state, self._commit = app_hash, state, commit

    async def app_hash(self, height):
        return self._app_hash

    async def commit(self, height):
        return self._commit

    async def state(self, height):
        return self._state


def _scripted_app(side: str, offers: list, applies: list):
    """A kvstore app whose OfferSnapshot and ApplySnapshotChunk answer from
    the scripts (names of the result enums) before it answers itself."""
    s = SIDES[side]
    abci = s["abci"]

    class Scripted(s["KV"]):
        def offer_snapshot(self, req):
            if offers:
                return abci.ResponseOfferSnapshot(
                    result=getattr(abci.OfferSnapshotResult, offers.pop(0)))
            return super().offer_snapshot(req)

        def apply_snapshot_chunk(self, req):
            if applies:
                name, refetch, reject = applies.pop(0)
                return abci.ResponseApplySnapshotChunk(
                    result=getattr(abci.ApplySnapshotChunkResult, name),
                    refetch_chunks=list(refetch), reject_senders=list(reject))
            return super().apply_snapshot_chunk(req)

    return Scripted()


# (label, OfferSnapshot script, ApplySnapshotChunk script, the app hash the
# provider anchors: "true" or "lie", snapshots offered: "both" or "none")
SYNC_CASES = [
    ("restore", [], [], "true", "both"),
    ("lying_app_hash", [], [], "lie", "both"),
    ("no_snapshots", [], [], "true", "none"),
    ("offer_abort", ["ABORT"], [], "true", "both"),
    ("offer_reject_then_older", ["REJECT"], [], "true", "both"),
    ("offer_reject_format", ["REJECT_FORMAT"], [], "true", "both"),
    ("offer_reject_sender", ["REJECT_SENDER"], [], "true", "both"),
    ("apply_retry_snapshot", [], [("RETRY_SNAPSHOT", (), ())], "true", "both"),
    ("apply_reject_snapshot", [], [("REJECT_SNAPSHOT", (), ())], "true", "both"),
    ("apply_abort", [], [("ABORT", (), ())], "true", "both"),
    ("apply_retry_refetch", [], [("RETRY", (0,), ())], "true", "both"),
    ("apply_reject_senders", [], [("ACCEPT", (), ("peer2",))], "true", "both"),
]


def _sync_case(side: str, offers, applies, anchor, offered) -> tuple:
    s = SIDES[side]
    ss, abci = s["ss"], s["abci"]

    async def main():
        server = _serving_app(side)
        newest, older = server.snapshots[-1][0], server.snapshots[-2][0]
        client = _scripted_app(side, list(offers), list(applies))
        conns = s["AppConns"](s["local"](client))
        await conns.start()
        try:
            def request_chunk(peer_id, snapshot, index):
                resp = server.load_snapshot_chunk(abci.RequestLoadSnapshotChunk(
                    height=snapshot.height, format_=snapshot.format, chunk=index))
                asyncio.get_running_loop().create_task(
                    syncer.add_chunk(index, resp.chunk, peer_id))

            app_hash = server.app_hash if anchor == "true" else hashlib.sha256(b"lies").digest()
            state = s["State"](chain_id="ss-chain", initial_height=1,
                               last_block_height=newest.height, app_hash=app_hash)
            syncer = ss.Syncer(_Direct(app_hash, state, None), conns.snapshot, request_chunk,
                               chunk_timeout=5.0)
            if offered == "both":
                for peer in ("peer1", "peer2"):
                    for snap in (newest, older):
                        syncer.add_snapshot(peer, ss.Snapshot(
                            height=snap.height, format=snap.format_, chunks=snap.chunks,
                            hash_=snap.hash))
            try:
                st, _ = await asyncio.wait_for(syncer.sync_any(), 30.0)
                got = ("ok", st.last_block_height)
            except Exception as e:  # noqa: BLE001 - the class is compared
                got = (type(e).__name__,)
            best = syncer.pool.best()
            return (got, client.height, client.app_hash.hex(), sorted(client.state.items()),
                    best and best.height, len(syncer.pool),
                    sorted(syncer.pool._rejected_peers), sorted(syncer.pool._rejected_formats))
        finally:
            await conns.stop()

    return asyncio.run(main())


@pytest.mark.parametrize("label,offers,applies,anchor,offered", SYNC_CASES,
                         ids=[c[0] for c in SYNC_CASES])
def test_syncer_case_ends_as_the_reference(label, offers, applies, anchor, offered):
    t = _sync_case("port", offers, applies, anchor, offered)
    j = _sync_case("jax", offers, applies, anchor, offered)
    assert t == j
    if label == "restore":
        assert t[0] == ("ok", 8) and t[1] == 8


# ------------------------------------------------- the light-client provider


@pytest.fixture(scope="module")
def lchain():
    return Chain(14, n_vals=4, tag=b"statesync")


def _provider_answers(side: str, lchain, h: int):
    if side == "jax":
        blocks, light, MemProvider, LightStore, MemDB, ss = (
            lchain.blocks, jlight, JMemProvider, JLightStore, JMemDB, jss)
    else:
        blocks, light, MemProvider, LightStore, MemDB, ss = (
            lchain.port_blocks(), tlight, TMemProvider, TLightStore, TMemDB, tss)

    async def main():
        lc = light.Client(
            CHAIN, light.TrustOptions(period_ns=PERIOD_NS, height=1, hash_=blocks[1].hash()),
            MemProvider(CHAIN, blocks, name="p"), [MemProvider(CHAIN, blocks, name="w")],
            LightStore(MemDB()))
        provider = ss.LightClientStateProvider(lc, initial_height=1)
        app_hash = await provider.app_hash(h)
        commit = await provider.commit(h)
        state = await provider.state(h)
        return app_hash, commit.to_proto(), state.to_bytes(), sorted(lc.store._heights)

    return asyncio.run(main())


@pytest.mark.parametrize("h", [2, 9, 12])
def test_light_client_state_provider_is_the_reference_s(lchain, h):
    t = _provider_answers("port", lchain, h)
    assert t == _provider_answers("jax", lchain, h)
    assert t[0] == lchain.blocks[h + 1].header.app_hash


# ------------------------------------------- one state sync between two Nodes


def test_fresh_port_node_state_syncs_from_a_live_port_node(tmp_path):
    """Node A (a single validator, snapshots every 4 heights, RPC on)
    commits txs; node B, fresh, with statesync.enable and A twice in
    rpc_servers, restores A's newest snapshot through its light client and
    block-syncs past it. B's first block is A's and its app holds A's txs."""
    from cometbft_tpu_torch.light.rpc_provider import RPCProvider
    from cometbft_tpu_torch.node import Node, init_files
    from tests.test_torch_node import _off

    async def main():
        cfg_a = _off(init_files(str(tmp_path / "a"), chain_id="ss-e2e"))
        cfg_a.rpc.laddr = "tcp://127.0.0.1:0"
        app_a = TKV()
        app_a.snapshot_interval = 4
        node_a = Node(cfg_a, app=app_a)
        await node_a.start()
        loop = asyncio.get_running_loop()
        deadline = loop.time() + 90
        try:
            for i in range(5):
                await node_a.mempool.check_tx(f"sskey{i}=ssval{i}".encode())
            while node_a.block_store.height() < 9 or not app_a.snapshots:
                assert loop.time() < deadline, node_a.block_store.height()
                await asyncio.sleep(0.05)
            snap_height = app_a.snapshots[-1][0].height
            rpc_a = f"http://{node_a.rpc_server.bound_addr}"
            root = await RPCProvider("ss-e2e", rpc_a).light_block(1)
            cfg_b = _off(init_files(str(tmp_path / "b"), chain_id="ss-e2e"))
            cfg_b.p2p.persistent_peers = f"{node_a.node_key.id()}@{node_a.node_info.listen_addr}"
            cfg_b.state_sync.enable = True
            cfg_b.state_sync.rpc_servers = [rpc_a, rpc_a]
            cfg_b.state_sync.trust_height = 1
            cfg_b.state_sync.trust_hash = root.hash().hex()
            cfg_b.state_sync.discovery_time = 0.3
            app_b = TKV()
            node_b = Node(cfg_b, app=app_b, genesis_doc=node_a.genesis_doc)
            await node_b.start()
            try:
                def applied() -> bool:
                    st = node_b.state_store.load()
                    return st is not None and st.last_block_height >= max(
                        snap_height + 2, node_b.block_store.base() + 1)

                while not applied():
                    assert loop.time() < deadline, (
                        f"B at {node_b.block_store.height()}, snapshot {snap_height}")
                    await asyncio.sleep(0.05)
                base = node_b.block_store.base()
                return (snap_height, base,
                        node_b.block_store.load_block_meta(base).block_id.hash,
                        node_a.block_store.load_block_meta(base).block_id.hash,
                        {f"sskey{i}": app_b.state.get(f"sskey{i}") for i in range(5)})
            finally:
                await node_b.stop()
        finally:
            await node_a.stop()

    snap_height, base, b_hash, a_hash, kv = asyncio.run(main())
    assert base >= snap_height + 1
    assert b_hash == a_hash
    assert kv == {f"sskey{i}": f"ssval{i}" for i in range(5)}
