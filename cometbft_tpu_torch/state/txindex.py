"""Transaction + block indexing from the event bus.

Reference: state/txindex/kv/kv.go (tx indexer), state/indexer/block/kv/
(block indexer), state/txindex/indexer_service.go (the service pumping the
EventBus into both).

KV layout (same idea as the reference):
  TX:<hash>                        -> json(TxResult)
  TXE:<key>/<value>/<height>/<idx> -> hash      (event-attr secondary index)
  TXH:<height>/<idx>               -> hash      (reserved tx.height index)
  BLE:<key>/<value>/<height>       -> height    (block event index)
  BLH:<height>                     -> 1         (block indexed marker)

Search supports the pubsub query grammar (libs/pubsub.Query), matching the
reference's tx_search/block_search surface: equality and CONTAINS hit the
secondary indexes; ranged numeric conditions scan the height index.

The port's copy of cometbft_tpu/state/txindex.py.
"""

from __future__ import annotations

import asyncio
import json
from dataclasses import dataclass, field

from cometbft_tpu_torch.libs import pubsub
from cometbft_tpu_torch.libs.service import BaseService, TaskRunner
from cometbft_tpu_torch.store.db import KVStore
from cometbft_tpu_torch.types import event_bus as eb
from cometbft_tpu_torch.types.block import tx_hash


@dataclass
class TxResult:
    """abci/types TxResult: a tx + where it landed + how it executed."""

    height: int
    index: int
    tx: bytes
    result: object  # abci.ExecTxResult

    def to_json(self) -> bytes:
        from cometbft_tpu_torch.abci import codec

        return json.dumps({
            "height": self.height, "index": self.index,
            "tx": self.tx.hex(), "result": codec._to_jsonable(self.result),
        }).encode()

    @classmethod
    def from_json(cls, raw: bytes) -> "TxResult":
        from cometbft_tpu_torch.abci import codec
        from cometbft_tpu_torch.abci.types import ExecTxResult

        d = json.loads(raw)
        return cls(
            height=d["height"], index=d["index"], tx=bytes.fromhex(d["tx"]),
            result=codec._from_jsonable(ExecTxResult, d["result"]),
        )


def _esc(s: str) -> str:
    return s.replace("/", "%2F")


class TxIndexer:
    """state/txindex/kv/kv.go KV tx indexer."""

    def __init__(self, db: KVStore):
        self.db = db

    def index(self, res: TxResult) -> None:
        h = tx_hash(res.tx)
        pairs: list[tuple[bytes, bytes | None]] = [(b"TX:" + h, res.to_json())]
        pairs.append((
            f"TXH:{res.height:020d}/{res.index:06d}".encode(), h))
        for ev in getattr(res.result, "events", []) or []:
            if not ev.type_:
                continue
            for attr in ev.attributes:
                if not attr.key or not attr.index:
                    continue
                key = f"TXE:{_esc(ev.type_)}.{_esc(attr.key)}/{_esc(attr.value)}/{res.height:020d}/{res.index:06d}"
                pairs.append((key.encode(), h))
        self.db.batch_set(pairs)

    def get(self, hash_: bytes) -> TxResult | None:
        raw = self.db.get(b"TX:" + hash_)
        return TxResult.from_json(raw) if raw is not None else None

    def prune(self, retain_height: int) -> int:
        """Delete index rows for txs below retain_height (the pruner
        service's analog of kv.go pruning). The TXE event rows embed the
        height two path segments from the end; a full-prefix scan per pass
        is acceptable at the pruner's cadence."""
        pairs: list[tuple[bytes, bytes | None]] = []
        pruned = 0
        end = f"TXH:{retain_height:020d}".encode()
        for k, v in list(self.db.iterate(b"TXH:", end)):
            pairs.append((k, None))
            pairs.append((b"TX:" + v, None))
            pruned += 1
        for k, _ in list(self.db.iterate(b"TXE:", b"TXE;")):
            try:
                h = int(k.decode().rsplit("/", 2)[-2])
            except (ValueError, IndexError):
                continue
            if h < retain_height:
                pairs.append((k, None))
        self.db.batch_set(pairs)
        return pruned

    def search(self, query: str | pubsub.Query, limit: int = 100) -> list[TxResult]:
        """kv.go Search: intersect per-condition hash sets; tx.hash short-
        circuits; ranged height conditions scan the TXH index."""
        q = query if isinstance(query, pubsub.Query) else pubsub.Query(query)
        result_sets: list[set[bytes]] = []
        post_filters: list[pubsub.Condition] = []
        for c in q.conditions:
            if c.key == eb.TX_HASH_KEY and c.op == "=":
                h = bytes.fromhex(str(c.operand))
                return [r for r in [self.get(h)] if r is not None]
            if c.key == eb.EVENT_TYPE_KEY:
                continue  # every indexed tx is a Tx event
            if c.key == eb.TX_HEIGHT_KEY:
                result_sets.append(self._scan_heights(c))
            elif c.op in ("=", "CONTAINS", "EXISTS"):
                result_sets.append(self._scan_events(c))
            else:
                # ranged op over an arbitrary event key: scan + post-filter
                result_sets.append(self._scan_events(
                    pubsub.Condition(c.key, "EXISTS")))
                post_filters.append(c)
        if not result_sets:
            hashes = {v for _, v in self.db.iterate(b"TXH:", b"TXH;")}
        else:
            hashes = set.intersection(*result_sets) if result_sets else set()
        out = []
        for h in hashes:
            r = self.get(h)
            if r is None:
                continue
            if post_filters and not all(
                f.matches(_attr_values(r.result, f.key)) for f in post_filters
            ):
                continue
            out.append(r)
        out.sort(key=lambda r: (r.height, r.index))
        return out[:limit]

    def _scan_heights(self, c: pubsub.Condition) -> set[bytes]:
        out = set()
        for k, v in self.db.iterate(b"TXH:", b"TXH;"):
            height = int(k.decode().split(":")[1].split("/")[0])
            if c.matches([str(height)]):
                out.add(v)
        return out

    def _scan_events(self, c: pubsub.Condition) -> set[bytes]:
        prefix = f"TXE:{_esc(c.key)}/".encode()
        out = set()
        for k, v in self.db.iterate(prefix, prefix[:-1] + b"0"):
            value = k.decode().split("/", 1)[1].rsplit("/", 2)[0]
            if c.matches([value.replace("%2F", "/")]):
                out.add(v)
        return out


def _attr_values(result, key: str) -> list[str]:
    out = []
    for ev in getattr(result, "events", []) or []:
        for attr in ev.attributes:
            if f"{ev.type_}.{attr.key}" == key:
                out.append(attr.value)
    return out


class BlockIndexer:
    """state/indexer/block/kv: FinalizeBlock events by height."""

    def __init__(self, db: KVStore):
        self.db = db

    def index(self, height: int, events) -> None:
        pairs: list[tuple[bytes, bytes | None]] = [
            (f"BLH:{height:020d}".encode(), b"1")]
        for ev in events or []:
            if not ev.type_:
                continue
            for attr in ev.attributes:
                if not attr.key or not attr.index:
                    continue
                key = f"BLE:{_esc(ev.type_)}.{_esc(attr.key)}/{_esc(attr.value)}/{height:020d}"
                pairs.append((key.encode(), str(height).encode()))
        self.db.batch_set(pairs)

    def has(self, height: int) -> bool:
        return self.db.has(f"BLH:{height:020d}".encode())

    def prune(self, retain_height: int) -> int:
        """Delete block-event index rows below retain_height."""
        pairs: list[tuple[bytes, bytes | None]] = []
        pruned = 0
        end = f"BLH:{retain_height:020d}".encode()
        for k, _ in list(self.db.iterate(b"BLH:", end)):
            pairs.append((k, None))
            pruned += 1
        for k, v in list(self.db.iterate(b"BLE:", b"BLE;")):
            try:
                if int(v) < retain_height:
                    pairs.append((k, None))
            except ValueError:
                continue
        self.db.batch_set(pairs)
        return pruned

    def search(self, query: str | pubsub.Query, limit: int = 100) -> list[int]:
        q = query if isinstance(query, pubsub.Query) else pubsub.Query(query)
        sets: list[set[int]] = []
        for c in q.conditions:
            if c.key == eb.EVENT_TYPE_KEY:
                continue
            if c.key == "block.height":
                heights = set()
                for k, _ in self.db.iterate(b"BLH:", b"BLH;"):
                    h = int(k.decode().split(":")[1])
                    if c.matches([str(h)]):
                        heights.add(h)
                sets.append(heights)
                continue
            prefix = f"BLE:{_esc(c.key)}/".encode()
            heights = set()
            for k, v in self.db.iterate(prefix, prefix[:-1] + b"0"):
                value = k.decode().split("/", 1)[1].rsplit("/", 1)[0]
                if c.matches([value.replace("%2F", "/")]):
                    heights.add(int(v))
            sets.append(heights)
        if not sets:
            return []
        return sorted(set.intersection(*sets))[:limit]


class NullTxIndexer:
    """config tx_index.indexer = "null"."""

    def index(self, res) -> None:
        pass

    def get(self, hash_: bytes) -> None:
        return None

    def search(self, query, limit: int = 100) -> list:
        return []

    def prune(self, retain_height: int) -> int:
        return 0


class IndexerService(BaseService):
    """state/txindex/indexer_service.go: subscribes to the event bus and
    feeds both indexers."""

    def __init__(self, tx_indexer, block_indexer, event_bus, logger=None,
                 sql_sink=None):
        super().__init__("IndexerService", logger)
        self.tx_indexer = tx_indexer
        self.block_indexer = block_indexer
        self.event_bus = event_bus
        self.sql_sink = sql_sink  # state.indexer_sql.SQLEventSink | None
        self._tasks = TaskRunner("indexer")

    async def on_start(self) -> None:
        # capacity=0: unbounded (SubscribeUnbuffered, indexer_service.go:43)
        # — the indexer must never be dropped for falling behind, or every
        # later tx would silently go unindexed
        block_sub = self.event_bus.subscribe("indexer", eb.QUERY_NEW_BLOCK, capacity=0)
        tx_sub = self.event_bus.subscribe("indexer", eb.QUERY_TX, capacity=0)
        self._tasks.spawn(self._run(block_sub, tx_sub), name="indexer-run")

    async def on_stop(self) -> None:
        await self._tasks.cancel_all()
        try:
            self.event_bus.unsubscribe_all("indexer")
        except Exception:  # noqa: BLE001
            pass

    async def _run(self, block_sub, tx_sub) -> None:
        async def pump_blocks():
            while True:
                msg = await block_sub.out.get()
                if msg is None:
                    return
                d = msg.data
                events = getattr(d.result_finalize_block, "events", [])
                if self.block_indexer is not None:
                    self.block_indexer.index(d.block.header.height, events)
                if self.sql_sink is not None:
                    self.sql_sink.index_block_events(d.block.header.height, events)

        async def pump_txs():
            while True:
                msg = await tx_sub.out.get()
                if msg is None:
                    return
                d = msg.data
                res = TxResult(d.height, d.index, d.tx, d.result)
                self.tx_indexer.index(res)
                if self.sql_sink is not None:
                    self.sql_sink.index_tx_events([res])

        await asyncio.gather(pump_blocks(), pump_txs())
