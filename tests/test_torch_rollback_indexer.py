"""The port's rollback (state/rollback.py, `cmd.py rollback` and
`compact-db`) and SQL event sink (state/indexer_sql.py) against the JAX
package's on the CPU.

- a port Node commits a few heights on a home; copies of the home are
  rolled back by either package's CLI, soft then hard, then once more:
  the same printed lines, State bytes and block-store heights, and the
  same refusal on a home with no state; `compact-db` prints the same
  sizes;
- rollback() itself on stores whose block store is one ahead of the
  state: the same no-op answer;
- the SQL sink: the same block and tx events through either package's
  SQLEventSink give the same rows in every table (the wall-clock column
  pinned), the same DDL and statements in both dialects, and a Node with
  tx_index.indexer = "sql" writes its committed txs' events.
"""

from __future__ import annotations

import asyncio
import os
import shutil
import sqlite3

import pytest

from cometbft_tpu import cmd as jcmd
from cometbft_tpu.abci import types as jabci
from cometbft_tpu.config.config import Config as JConfig
from cometbft_tpu.state import indexer_sql as jsql
from cometbft_tpu.state.rollback import rollback as jrollback
from cometbft_tpu.state.store import StateStore as JStateStore
from cometbft_tpu.state.txindex import TxResult as JTxResult
from cometbft_tpu.store import BlockStore as JBlockStore
from cometbft_tpu.store.db import open_db as j_open_db
from cometbft_tpu_torch import cmd as tcmd
from cometbft_tpu_torch.abci import types as tabci
from cometbft_tpu_torch.config.config import Config as TConfig
from cometbft_tpu_torch.node import Node as TNode
from cometbft_tpu_torch.state import indexer_sql as tsql
from cometbft_tpu_torch.state.rollback import rollback as trollback
from cometbft_tpu_torch.state.store import StateStore as TStateStore
from cometbft_tpu_torch.state.txindex import TxResult as TTxResult
from cometbft_tpu_torch.store import BlockStore as TBlockStore
from cometbft_tpu_torch.store.db import open_db as t_open_db
from tests.test_torch_node import _drive_node, _one_home
from tests.torch_consumers import fresh_backends

SIDES = {"j": (jcmd, JConfig, JBlockStore, JStateStore, j_open_db, jrollback),
         "t": (tcmd, TConfig, TBlockStore, TStateStore, t_open_db, trollback)}


@pytest.fixture(autouse=True)
def _fresh():
    yield from fresh_backends()


@pytest.fixture(scope="module")
def chain_home(tmp_path_factory):
    """A home on which a port Node committed 5 heights or more (4 kvstore
    txs)."""
    root = tmp_path_factory.mktemp("rollback")
    home = _one_home(root)
    gen = fresh_backends()
    next(gen)
    try:
        asyncio.run(_drive_node(TNode, TConfig, home, heights=5))
    finally:
        next(gen, None)
    return home


def _stores(side: str, home: str):
    _, Config, BlockStore, StateStore, open_db, _ = SIDES[side]
    cfg = Config.load(home)
    return (BlockStore(open_db(cfg.base.db_backend, cfg.db_path("blockstore"),
                               checksum=cfg.storage.checksum)),
            StateStore(open_db(cfg.base.db_backend, cfg.db_path("state"),
                               checksum=cfg.storage.checksum)))


def _cli_rollbacks(side: str, home: str, capsys) -> list:
    mod = SIDES[side][0]
    out = []
    for argv in (["rollback"], ["rollback", "--hard"], ["rollback"]):
        try:
            rc = mod.main(["--home", home] + argv)
        except Exception as e:  # noqa: BLE001 - the class and message are compared
            rc = (type(e).__name__, str(e))
        out.append((rc, capsys.readouterr().out))
        bs, ss = _stores(side, home)
        try:
            out.append((bs.height(), ss.load().to_bytes()))
        finally:
            bs.db.close()
            ss.db.close()
    return out


def test_cli_rollback_acts_as_the_reference_s(chain_home, tmp_path, capsys):
    got = {}
    for side in ("j", "t"):
        home = str(tmp_path / side)
        shutil.copytree(chain_home, home)
        got[side] = _cli_rollbacks(side, home, capsys)
    assert got["t"] == got["j"]
    assert got["t"][0][1].startswith("Rolled back state to height ")
    assert got["t"][3][0] == got["t"][1][0] - 1  # the hard rollback removed a block


def test_rollback_refuses_a_home_without_state(tmp_path, capsys):
    got = {}
    for side in ("j", "t"):
        home = str(tmp_path / side)
        SIDES[side][0].main(["--home", home, "init"])
        capsys.readouterr()
        try:
            SIDES[side][0].main(["--home", home, "rollback"])
        except Exception as e:  # noqa: BLE001 - the class and message are compared
            got[side] = (type(e).__name__, str(e))
    assert got["t"] == got["j"] == ("ErrRollback", "no state found")


def test_rollback_with_the_block_store_one_ahead_is_the_reference_s(chain_home, tmp_path):
    got = {}
    for side in ("j", "t"):
        home = str(tmp_path / side)
        shutil.copytree(chain_home, home)
        bs, ss = _stores(side, home)
        try:
            rollback = SIDES[side][5]
            first = rollback(bs, ss)  # the state one height back: blocks one ahead
            again = rollback(bs, ss)  # the non-atomic case: no change
            hard = rollback(bs, ss, remove_block=True)
            got[side] = (first, again, hard, bs.height(), ss.load().to_bytes())
        finally:
            bs.db.close()
            ss.db.close()
    assert got["t"] == got["j"]
    assert got["t"][1][0] == got["t"][0][0] and got["t"][3] == got["t"][0][0]


def test_cli_compact_db_prints_what_the_reference_s_prints(chain_home, tmp_path, capsys):
    got = {}
    for side in ("j", "t"):
        home = str(tmp_path / side)
        shutil.copytree(chain_home, home)
        rc = SIDES[side][0].main(["--home", home, "compact-db"])
        got[side] = (rc, capsys.readouterr().out)
    assert got["t"] == got["j"]
    assert got["t"][0] == 0 and "compacted blockstore:" in got["t"][1]


# ------------------------------------------------------------------ SQL sink


def _events(abci):
    return [abci.Event(type_="begin", attributes=[
                abci.EventAttribute(key="k", value="v", index=True),
                abci.EventAttribute(key="n", value="1", index=False)]),
            abci.Event(type_="end", attributes=[])]


def _tx_result(abci, TxResult, height: int, index: int, who: str):
    res = abci.ExecTxResult(code=0, data=b"\x01", log="ok", gas_wanted=5, gas_used=3, events=[
        abci.Event(type_="app", attributes=[
            abci.EventAttribute(key="who", value=who, index=True),
            abci.EventAttribute(key="key", value=f"k{index}", index=True)])])
    return TxResult(height=height, index=index, tx=b"t%d=%d" % (height, index), result=res)


def _sink_rows(side: str, path: str, monkeypatch) -> dict:
    sql, abci, TxResult = (jsql, jabci, JTxResult) if side == "j" else (tsql, tabci, TTxResult)
    monkeypatch.setattr(sql, "_now", lambda: "2024-01-02T03:04:05Z")
    sink = sql.SQLEventSink(path, "sql-chain")
    for h in (1, 2):
        sink.index_block_events(h, _events(abci))
        sink.index_tx_events([_tx_result(abci, TxResult, h, i, f"who{h}{i}") for i in range(3)])
    sink.index_block_events(2, _events(abci)[:1])  # re-delivered: replaced
    sink.index_tx_events([_tx_result(abci, TxResult, 2, 0, "again")])  # re-delivered: kept
    sink.close()
    db = sqlite3.connect(path)
    try:
        tables = [r[0] for r in db.execute(
            "SELECT name FROM sqlite_master WHERE type IN ('table', 'view') ORDER BY name")]
        return {t: db.execute(f"SELECT * FROM {t} ORDER BY 1, 2").fetchall() for t in tables}
    finally:
        db.close()


def test_sql_sink_rows_are_the_reference_s(tmp_path, monkeypatch):
    t = _sink_rows("t", str(tmp_path / "t.sqlite"), monkeypatch)
    j = _sink_rows("j", str(tmp_path / "j.sqlite"), monkeypatch)
    assert t == j
    assert len(t["blocks"]) == 2 and len(t["tx_results"]) == 6
    assert any("who20" in r for r in t["tx_events"])


@pytest.mark.parametrize("dialect", ["sqlite", "postgresql"])
def test_sql_dialects_render_as_the_reference(dialect):
    assert tsql.schema_sql(dialect) == jsql.schema_sql(dialect)
    assert tsql.statements(dialect) == jsql.statements(dialect)
    with pytest.raises(ValueError):
        tsql.schema_sql("mysql")


def test_node_with_the_sql_indexer_writes_its_txs(tmp_path):
    home = _one_home(tmp_path)
    cfg = TConfig.load(home)
    cfg.tx_index.indexer = "sql"
    cfg.save()
    asyncio.run(_drive_node(TNode, TConfig, home, heights=3))
    db = sqlite3.connect(TConfig.load(home).db_path("tx_events"))
    try:
        keys = {r[0] for r in db.execute(
            "SELECT value FROM tx_events WHERE composite_key = 'app.key'")}
        heights = [r[0] for r in db.execute("SELECT height FROM blocks ORDER BY height")]
    finally:
        db.close()
    assert {"key0", "key1", "key2", "key3"} <= keys
    assert heights[:3] == [1, 2, 3]
    assert not os.path.exists(TConfig.load(home).db_path("tx_index"))
