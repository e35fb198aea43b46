"""SQL event sink: the psql-sink schema over sqlite.

Reference: state/indexer/sink/psql (psql.go:40-120 + schema.sql) — a
relational event sink for operators who query events with SQL instead of
the KV indexer's query language. Same four tables + joined views
(blocks / tx_results / events / attributes, event_attributes /
block_events / tx_events).

Engine portability is a first-class contract, not a comment: every DML
statement lives in _STMTS using only the SQL subset both engines accept
(RETURNING instead of lastrowid, ON CONFLICT instead of INSERT OR IGNORE),
and schema_sql()/statements() render the DDL/DML for a named dialect —
"sqlite" (the engine the node runs) or "postgresql"
(AUTOINCREMENT->BIGSERIAL, BLOB->BYTEA, ?->%s). The tests guard the
postgresql rendering against sqlite-isms so the sink stays a
connection-string change away from psql.

Like the reference's psql sink it is WRITE-ONLY from the node's
perspective: tx_search/block_search stay on the KV indexer; SQL consumers
query the database directly (sink/psql/psql.go:33-38 documents the same
contract).

The port's copy of cometbft_tpu/state/indexer_sql.py.
"""

from __future__ import annotations

import sqlite3
import time

_SCHEMA = """
CREATE TABLE IF NOT EXISTS blocks (
  rowid      INTEGER PRIMARY KEY AUTOINCREMENT,
  height     INTEGER NOT NULL,
  chain_id   TEXT NOT NULL,
  created_at TEXT NOT NULL,
  UNIQUE (height, chain_id)
);
CREATE INDEX IF NOT EXISTS idx_blocks_height_chain ON blocks(height, chain_id);

CREATE TABLE IF NOT EXISTS tx_results (
  rowid      INTEGER PRIMARY KEY AUTOINCREMENT,
  block_id   INTEGER NOT NULL REFERENCES blocks(rowid),
  "index"    INTEGER NOT NULL,
  created_at TEXT NOT NULL,
  tx_hash    TEXT NOT NULL,
  tx_result  BLOB NOT NULL,
  UNIQUE (block_id, "index")
);

CREATE TABLE IF NOT EXISTS events (
  rowid    INTEGER PRIMARY KEY AUTOINCREMENT,
  block_id INTEGER NOT NULL REFERENCES blocks(rowid),
  tx_id    INTEGER NULL REFERENCES tx_results(rowid),
  type     TEXT NOT NULL
);

CREATE TABLE IF NOT EXISTS attributes (
  event_id      INTEGER NOT NULL REFERENCES events(rowid),
  key           TEXT NOT NULL,
  composite_key TEXT NOT NULL,
  value         TEXT NULL,
  UNIQUE (event_id, key)
);

CREATE VIEW IF NOT EXISTS event_attributes AS
  SELECT block_id, tx_id, type, key, composite_key, value
  FROM events LEFT JOIN attributes ON (events.rowid = attributes.event_id);

CREATE VIEW IF NOT EXISTS block_events AS
  SELECT blocks.rowid as block_id, height, chain_id, type, key,
         composite_key, value
  FROM blocks JOIN event_attributes ON (blocks.rowid = event_attributes.block_id)
  WHERE event_attributes.tx_id IS NULL;

CREATE VIEW IF NOT EXISTS tx_events AS
  SELECT height, "index", chain_id, type, key, composite_key, value,
         tx_results.created_at
  FROM blocks JOIN tx_results ON (blocks.rowid = tx_results.block_id)
  JOIN event_attributes ON (tx_results.rowid = event_attributes.tx_id);
"""


def _now() -> str:
    return time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())


# every DML statement, in the engine-portable subset ("?" placeholders are
# rendered per dialect)
_STMTS = {
    "upsert_block": (
        "INSERT INTO blocks (height, chain_id, created_at) VALUES (?,?,?) "
        "ON CONFLICT (height, chain_id) DO UPDATE SET created_at = "
        "blocks.created_at RETURNING rowid"),
    "delete_block_attrs": (
        "DELETE FROM attributes WHERE event_id IN "
        "(SELECT rowid FROM events WHERE block_id = ? AND tx_id IS NULL)"),
    "delete_block_events": (
        "DELETE FROM events WHERE block_id = ? AND tx_id IS NULL"),
    "insert_event": (
        "INSERT INTO events (block_id, tx_id, type) VALUES (?,?,?) "
        "RETURNING rowid"),
    "insert_attr": (
        "INSERT INTO attributes (event_id, key, composite_key, value) "
        "VALUES (?,?,?,?) ON CONFLICT (event_id, key) DO NOTHING"),
    "insert_tx": (
        'INSERT INTO tx_results (block_id, "index", created_at, tx_hash, '
        "tx_result) VALUES (?,?,?,?,?) "
        'ON CONFLICT (block_id, "index") DO NOTHING RETURNING rowid'),
}

_DIALECTS = ("sqlite", "postgresql")

# RETURNING landed in SQLite 3.35 (2021); older embedded libsqlite still
# ships on some hosts. The sink degrades to lastrowid/SELECT lookups there
# — same rows, one extra statement per upsert.
_RETURNING_OK = sqlite3.sqlite_version_info >= (3, 35, 0)

_STMTS_NO_RETURNING = {
    k: v.replace(" RETURNING rowid", "") for k, v in _STMTS.items()
}
_SELECT_BLOCK_ROWID = (
    "SELECT rowid FROM blocks WHERE height = ? AND chain_id = ?")


def schema_sql(dialect: str = "sqlite") -> str:
    """The sink DDL rendered for `dialect`."""
    if dialect not in _DIALECTS:
        raise ValueError(f"unknown SQL dialect {dialect!r}")
    if dialect == "sqlite":
        return _SCHEMA
    return (_SCHEMA
            .replace("INTEGER PRIMARY KEY AUTOINCREMENT",
                     "BIGSERIAL PRIMARY KEY")
            .replace("BLOB", "BYTEA")
            # PostgreSQL has no IF NOT EXISTS for plain views
            .replace("CREATE VIEW IF NOT EXISTS", "CREATE OR REPLACE VIEW"))


def statements(dialect: str = "sqlite") -> dict[str, str]:
    """Every DML statement the sink executes, rendered for `dialect`
    (placeholder style is the only difference — the statements themselves
    are restricted to the engine-portable subset)."""
    if dialect not in _DIALECTS:
        raise ValueError(f"unknown SQL dialect {dialect!r}")
    if dialect == "sqlite":
        return dict(_STMTS)
    return {k: v.replace("?", "%s") for k, v in _STMTS.items()}


class SQLEventSink:
    """psql.go EventSink: IndexBlockEvents + IndexTxEvents."""

    def __init__(self, path: str, chain_id: str):
        self.chain_id = chain_id
        self._db = sqlite3.connect(path)
        self._db.executescript(_SCHEMA)
        self._db.commit()

    # --------------------------------------------------------------- write

    def _block_rowid(self, cur, height: int) -> int:
        if _RETURNING_OK:
            cur.execute(_STMTS["upsert_block"],
                        (height, self.chain_id, _now()))
            return cur.fetchone()[0]
        cur.execute(_STMTS_NO_RETURNING["upsert_block"],
                    (height, self.chain_id, _now()))
        cur.execute(_SELECT_BLOCK_ROWID, (height, self.chain_id))
        return cur.fetchone()[0]

    def _insert_events(self, cur, block_rowid: int, tx_rowid, events) -> None:
        for ev in events or []:
            if not ev.type_:
                continue
            if _RETURNING_OK:
                cur.execute(_STMTS["insert_event"],
                            (block_rowid, tx_rowid, ev.type_))
                event_id = cur.fetchone()[0]
            else:
                cur.execute(_STMTS_NO_RETURNING["insert_event"],
                            (block_rowid, tx_rowid, ev.type_))
                event_id = cur.lastrowid
            for attr in ev.attributes:
                if not attr.key:
                    continue
                cur.execute(
                    _STMTS["insert_attr"],
                    (event_id, attr.key, f"{ev.type_}.{attr.key}", attr.value))

    def index_block_events(self, height: int, events) -> None:
        """psql.go IndexBlockEvents. Idempotent under re-delivery (indexer
        re-feed after a crash): prior block-level events for the height are
        replaced, not duplicated."""
        cur = self._db.cursor()
        rowid = self._block_rowid(cur, height)
        cur.execute(_STMTS["delete_block_attrs"], (rowid,))
        cur.execute(_STMTS["delete_block_events"], (rowid,))
        self._insert_events(cur, rowid, None, events)
        self._db.commit()

    def index_tx_events(self, tx_results) -> None:
        """psql.go IndexTxEvents: tx_results carry (height, index, tx,
        result) — the state.txindex.TxResult shape."""
        from cometbft_tpu_torch.abci import codec as abci_codec
        from cometbft_tpu_torch.types.block import tx_hash

        import json as _json

        cur = self._db.cursor()
        for res in tx_results:
            rowid = self._block_rowid(cur, res.height)
            params = (
                rowid, res.index, _now(), tx_hash(res.tx).hex().upper(),
                _json.dumps(abci_codec._to_jsonable(res.result)).encode())
            if _RETURNING_OK:
                cur.execute(_STMTS["insert_tx"], params)
                row = cur.fetchone()
                if row is None:
                    continue  # re-delivered tx: events already recorded
                tx_rowid = row[0]
            else:
                cur.execute(_STMTS_NO_RETURNING["insert_tx"], params)
                if cur.rowcount == 0:
                    continue  # conflict DO NOTHING: re-delivered tx
                tx_rowid = cur.lastrowid
            self._insert_events(
                cur, rowid, tx_rowid, getattr(res.result, "events", []))
        self._db.commit()

    def close(self) -> None:
        self._db.close()
