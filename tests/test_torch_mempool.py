"""The port's CListMempool (mempool/mempool.py) against the JAX package's,
each over its own kvstore (signed txs: pub || sig || payload) through its
AppConns, under tx_verify="ed25519": the same check_tx sequence admits and
rejects the same txs with the same errors (2 forged signatures, a short tx,
duplicates, a full pool), gives the same reap order, update and recheck.
The port's signature rows go through its scheduler as MEMPOOL work and are
verified by the kernels' plain versions (its "cpu" backend); the
reference's by its "cpu" backend. Exact: outcomes, error classes and first
lines, pool contents in order.
"""

from __future__ import annotations

import asyncio

import pytest

from cometbft_tpu.abci import kvstore as jkv
from cometbft_tpu.abci import types as jabci
from cometbft_tpu.crypto import ed25519 as jed
from cometbft_tpu.mempool import mempool as jmp
from cometbft_tpu.proxy import AppConns as JAppConns
from cometbft_tpu.proxy import local_client_creator as jlocal
from cometbft_tpu_torch import sched as tsched
from cometbft_tpu_torch.abci import types as tabci
from cometbft_tpu_torch.mempool import mempool as tmp
from cometbft_tpu_torch.proxy import AppConns as TAppConns
from cometbft_tpu_torch.proxy import local_client_creator as tlocal
from tests.torch_consumers import first_line, fresh_backends
from tests.torch_net_harness import SignedKVStoreApplication, signed_tx


class JaxSignedKV(jkv.KVStoreApplication):
    def _parse_kv(self, tx: bytes):
        return super()._parse_kv(tx[jmp.TX_SIG_OVERHEAD:])


SIDES = {"jax": (jmp, jabci, JaxSignedKV, JAppConns, jlocal),
         "port": (tmp, tabci, SignedKVStoreApplication, TAppConns, tlocal)}
PRIVS = [jed.gen_priv_key_from_secret(b"mempool-%d" % i) for i in range(4)]


def _tx(i: int, forge: bool = False) -> bytes:
    return signed_tx(PRIVS[i % 4], b"k%d=v%d" % (i, i), forge)


@pytest.fixture(autouse=True)
def _fresh():
    yield from fresh_backends()


async def _outcome(coro):
    try:
        res = await coro
        return ("ok", res.code, res.log)
    except Exception as e:  # noqa: BLE001 - the outcome is what is compared
        return first_line(e)


async def _drive(side: str):
    mp_mod, abci, app_cls, AppConns, local = SIDES[side]
    app = app_cls()
    conns = AppConns(local(app))
    await conns.start()
    cfg = mp_mod.MempoolConfig(size=7, tx_verify="ed25519", cache_size=64)
    cfg.validate_basic()
    pool = mp_mod.CListMempool(cfg, conns.mempool)
    out = []
    try:
        # one wave: 5 good, 2 forged, a short tx, a non-kv payload, and a
        # duplicate of a good tx while its first copy is in flight
        wave = [_tx(0), _tx(1), _tx(2, forge=True), _tx(3), b"short" * 5, _tx(4),
                _tx(5, forge=True), _tx(0), signed_tx(PRIVS[1], b"\xff\xfe"), _tx(6)]
        out.append(await asyncio.gather(*(_outcome(pool.check_tx(tx, sender=f"p{i}"))
                                          for i, tx in enumerate(wave))))
        out.append([await _outcome(pool.check_tx(tx)) for tx in
                    (_tx(1), _tx(2, forge=True), _tx(7), _tx(8), _tx(9), _tx(10))])
        out.append((pool.size(), pool.size_bytes(), [m.tx for m in pool.iter_txs()],
                    [m.sender for m in pool.iter_txs()]))
        out.append((pool.reap_max_txs(3), pool.reap_max_bytes_max_gas(2 * len(_tx(0)) + 1, -1),
                    pool.reap_max_bytes_max_gas(-1, 4), pool.reap_max_txs(-1)))
        committed = pool.reap_max_txs(2)
        results = [abci.ExecTxResult(code=0), abci.ExecTxResult(code=1, log="bad")]
        await pool.update(1, committed, results)
        out.append((pool.size(), pool.recheck_windows_last, pool.cache.has(committed[0]),
                    pool.cache.has(committed[1]), pool.reap_max_txs(-1)))
        out.append([await _outcome(pool.check_tx(tx)) for tx in (committed[0], committed[1])])
        await pool.flush()
        out.append((pool.size(), pool.has_txs()))
    finally:
        await conns.stop()
    return out


def test_admission_reap_update_and_recheck_are_the_reference_s():
    jax, port = asyncio.run(_drive("jax")), asyncio.run(_drive("port"))
    assert jax == port
    wave = port[0]
    assert [o[0] for o in wave].count("ErrTxBadSignature") == 3  # 2 forged, 1 short
    assert wave[7] == wave[0] == ("ok", 0, "")  # the in-flight duplicate: the first result
    assert wave[8] == ("ok", 1, "tx must be utf-8 key=value")  # signed, but not key=value
    assert [o[0] for o in port[1]] == ["ErrTxInCache", "ErrTxBadSignature", "ok", "ok",
                                       "ErrMempoolIsFull", "ErrMempoolIsFull"]
    assert port[4][:4] == (5, 1, True, False)  # 2 committed (one invalid), 5 rechecked
    assert tsched.get().health()["class_rows"]["mempool"] > 0


async def _drive_overload(side: str):
    """A pool of 10 with the mempool metrics and an overload registry on a
    fixed clock: filled past the saturated watermark, the next new tx is
    shed at the door; a commit at the elevated watermark expires the
    oldest txs eagerly; gossip's budget follows the level."""
    from cometbft_tpu.libs import metrics as jm
    from cometbft_tpu.libs import overload as jo
    from cometbft_tpu.mempool import reactor as jreactor
    from cometbft_tpu_torch.libs import metrics as tm
    from cometbft_tpu_torch.libs import overload as to
    from cometbft_tpu_torch.mempool import reactor as treactor

    m, o, reactor = (tm, to, treactor) if side == "port" else (jm, jo, jreactor)
    mp_mod, abci, app_cls, AppConns, local = SIDES[side]
    conns = AppConns(local(app_cls()))
    await conns.start()
    reg = m.Registry()
    ovl = o.OverloadRegistry(clock=lambda: 0.0)
    cfg = mp_mod.MempoolConfig(size=10, tx_verify="ed25519", cache_size=64)
    if side == "port":
        pool = mp_mod.CListMempool(cfg, conns.mempool, metrics=m.MempoolMetrics(reg),
                                   overload=ovl)
    else:
        pool = mp_mod.CListMempool(cfg, conns.mempool)
        pool.metrics = m.MempoolMetrics(reg)
        pool.attach_overload(ovl)
    budget = reactor.MempoolReactor(pool)._gossip_budget
    out = []
    try:
        for i in range(11):
            out.append((await _outcome(pool.check_tx(_tx(i, forge=i == 3))),
                        ovl.level("mempool"), budget()))
        try:
            await pool.check_tx(_tx(20))
        except mp_mod.ErrMempoolIsFull as e:
            out.append(("shed", e.plane, e.retry_after_ms))
        committed = pool.reap_max_txs(1)
        await pool.update(1, committed, [abci.ExecTxResult(code=0)])
        out.append((pool.size(), pool.eager_expired, ovl.level("mempool"), budget(),
                    ovl.sheds("mempool"), [mt.tx for mt in pool.iter_txs()]))
    finally:
        await conns.stop()
    return out, reg.render()


def test_port_mempool_takes_no_metrics_or_overload_registry():
    """The metrics and overload hooks, filled by the node's slice, against
    the reference's: the same decisions, expiries and exposition."""
    jax, port = asyncio.run(_drive_overload("jax")), asyncio.run(_drive_overload("port"))
    decisions = port[0]
    assert decisions[-2][0] == "shed" and decisions[-1][1] > 0
    assert "cometbft_mempool_failed_txs 1" in port[1]
    assert port == jax


@pytest.mark.parametrize("tx_verify", ["", "ed25519", "rsa"])
def test_config_validation_is_the_reference_s(tx_verify):
    got = []
    for m in (jmp, tmp):
        try:
            m.MempoolConfig(tx_verify=tx_verify, recheck_window=-1 if tx_verify else 0
                            ).validate_basic()
            got.append("ok")
        except ValueError as e:
            got.append(str(e))
    assert got[0] == got[1]


def test_tx_cache_lru_is_the_reference_s():
    got = []
    for m in (jmp, tmp):
        c = m.TxCache(3)
        seq = [c.push(b"a"), c.push(b"b"), c.push(b"a"), c.push(b"c"), c.push(b"d"),
               c.has(b"a"), c.has(b"b"), c.push(b"b")]
        c.remove(b"c")
        seq += [c.has(b"c"), c.push(b"c")]
        c.reset()
        seq.append(c.has(b"d"))
        got.append(seq)
    assert got[0] == got[1]
