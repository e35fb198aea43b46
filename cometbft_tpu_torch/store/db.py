"""Key-value backend interface (reference: cometbft-db's DB interface, used
by store/store.go, state/store.go, indexers, evidence pool, light store).

Two backends: MemDB (tests, light stores) and SQLiteDB (durable, the
default node backend — sqlite is this stack's goleveldb: embedded,
crash-safe, zero-install). Iteration is ordered by raw key bytes, matching
the reference's iterator contract.

Storage-fault plane hardening:
  - every SQLiteDB write runs in an EXPLICIT transaction (a torn batch
    can only ever roll back, never half-apply),
  - the sqlite `synchronous` pragma is a knob (`storage.synchronous`,
    NORMAL|FULL) applied to EVERY minted connection — the original code
    set it on the first thread's connection only, silently leaving other
    threads on the sqlite default,
  - close() closes every connection the store ever minted, whichever
    thread minted it (thread-local conns used to leak on close),
  - CRCStore wraps the block/state DBs with per-value CRC32 guards: a
    flipped disk bit surfaces as a typed ErrCorruptValue naming the key
    and the repair path, never as a silently mis-parsed record,
  - SQLiteDB ops ride the `db.write`/`db.read` disk-chaos seams
    (libs/diskchaos) and feed the db-write-latency storage metrics.

The port's copy of cometbft_tpu/store/db.py: a store either package wrote
reads back in the other, CRC envelopes included.
"""

from __future__ import annotations

import sqlite3
import threading
import time
import zlib
from typing import Iterator

from cometbft_tpu_torch.libs import diskchaos

SYNCHRONOUS_MODES = ("NORMAL", "FULL")


class ErrCorruptValue(Exception):
    """A CRC-guarded record failed its checksum: the stored bytes rotted
    on disk (or an injected bitrot fault fired). Named repair path: stop
    the node, `cometbft rollback` past the damaged height or re-sync the
    store from peers; `storage.checksum = false` disables the guard."""

    def __init__(self, key: bytes, detail: str):
        super().__init__(
            f"corrupt value for key {key.hex()}: {detail} — the record "
            f"failed its CRC32 guard (storage.checksum). Repair: "
            f"`cometbft rollback` past the damaged height or re-sync "
            f"this store from peers; the bytes on disk are not "
            f"trustworthy. (A store written BEFORE the guard existed "
            f"fails this way on every key — set `storage.checksum = "
            f"false` for pre-guard data, or re-sync onto a fresh home.)")
        self.key = key


class KVStore:
    def get(self, key: bytes) -> bytes | None: ...

    def set(self, key: bytes, value: bytes) -> None: ...

    def delete(self, key: bytes) -> None: ...

    def has(self, key: bytes) -> bool:
        return self.get(key) is not None

    def iterate(self, start: bytes = b"", end: bytes | None = None) -> Iterator[tuple[bytes, bytes]]:
        """Ordered iteration over [start, end)."""
        ...

    def batch_set(self, pairs: list[tuple[bytes, bytes | None]]) -> None:
        """Atomic write batch; value None = delete."""
        for k, v in pairs:
            if v is None:
                self.delete(k)
            else:
                self.set(k, v)

    def close(self) -> None: ...


class MemDB(KVStore):
    def __init__(self):
        self._data: dict[bytes, bytes] = {}
        self._lock = threading.Lock()

    def get(self, key: bytes) -> bytes | None:
        with self._lock:
            return self._data.get(key)

    def set(self, key: bytes, value: bytes) -> None:
        with self._lock:
            self._data[bytes(key)] = bytes(value)

    def delete(self, key: bytes) -> None:
        with self._lock:
            self._data.pop(key, None)

    def iterate(self, start: bytes = b"", end: bytes | None = None):
        with self._lock:
            keys = sorted(k for k in self._data if k >= start and (end is None or k < end))
        for k in keys:
            v = self.get(k)
            if v is not None:
                yield k, v

    def close(self) -> None:
        pass


def _observe_db_write(t0: float) -> None:
    from cometbft_tpu_torch.libs import metrics as cmtmetrics

    cmtmetrics.storage_metrics().observe_db_write(time.perf_counter() - t0)


class SQLiteDB(KVStore):
    """One table of (key BLOB PRIMARY KEY, value BLOB); WAL mode for
    concurrent readers + crash safety. `synchronous` (NORMAL|FULL) is a
    per-connection pragma: NORMAL fsyncs the sqlite WAL at checkpoints
    (a power cut can lose the tail of recently-committed transactions,
    never corrupt), FULL fsyncs every commit (nothing acked is ever
    lost). The privval sign-state does NOT live here — the one
    FULL-grade-always write goes through privval/file_pv.py's
    durable atomic write."""

    def __init__(self, path: str, synchronous: str = "NORMAL"):
        if synchronous not in SYNCHRONOUS_MODES:
            raise ValueError(
                f"unknown sqlite synchronous mode {synchronous!r} "
                f"(expected one of {SYNCHRONOUS_MODES})")
        self.path = path
        self.synchronous = synchronous
        self._local = threading.local()
        self._conns_lock = threading.Lock()
        self._conns: list[sqlite3.Connection] = []
        conn = self._conn()
        conn.execute("CREATE TABLE IF NOT EXISTS kv (k BLOB PRIMARY KEY, v BLOB NOT NULL)")
        conn.commit()

    def _conn(self) -> sqlite3.Connection:
        conn = getattr(self._local, "conn", None)
        if conn is None:
            # a use after close() mints a fresh connection (reopen
            # semantics): tests and the inspect/rollback CLIs routinely
            # read a store after the node released it
            # check_same_thread=False so close() may close conns minted
            # by OTHER threads; each conn is still only ever USED by its
            # minting thread (the thread-local), which is the actual
            # sqlite3 safety requirement
            conn = sqlite3.connect(self.path, timeout=30,
                                   check_same_thread=False)
            # pragmas are PER CONNECTION (journal_mode persists in the
            # file, synchronous does not): every minted conn gets both
            conn.execute("PRAGMA journal_mode=WAL")
            conn.execute(f"PRAGMA synchronous={self.synchronous}")
            self._local.conn = conn
            with self._conns_lock:
                self._conns.append(conn)
        return conn

    def get(self, key: bytes) -> bytes | None:
        row = self._conn().execute("SELECT v FROM kv WHERE k = ?", (key,)).fetchone()
        if row is None:
            return None
        return diskchaos.fault_read("db.read", row[0])

    def set(self, key: bytes, value: bytes) -> None:
        diskchaos.fault_op("db.write")
        t0 = time.perf_counter()
        c = self._conn()
        with c:  # explicit transaction: commit or roll back, never a tear
            c.execute("INSERT OR REPLACE INTO kv (k, v) VALUES (?, ?)", (key, value))
        _observe_db_write(t0)

    def delete(self, key: bytes) -> None:
        diskchaos.fault_op("db.write")
        t0 = time.perf_counter()
        c = self._conn()
        with c:
            c.execute("DELETE FROM kv WHERE k = ?", (key,))
        _observe_db_write(t0)

    def iterate(self, start: bytes = b"", end: bytes | None = None):
        c = self._conn()
        if end is None:
            cur = c.execute("SELECT k, v FROM kv WHERE k >= ? ORDER BY k", (start,))
        else:
            cur = c.execute(
                "SELECT k, v FROM kv WHERE k >= ? AND k < ? ORDER BY k", (start, end)
            )
        yield from cur

    def batch_set(self, pairs: list[tuple[bytes, bytes | None]]) -> None:
        t0 = time.perf_counter()
        c = self._conn()
        with c:  # transaction
            for i, (k, v) in enumerate(pairs):
                if i == len(pairs) // 2:
                    # the torn-batch fault point, deliberately INSIDE the
                    # open transaction (set/delete fire the seam before
                    # theirs): an ENOSPC or death here half-applies the
                    # statements — commit-or-rollback must make the torn
                    # half invisible, never expose half the pairs
                    diskchaos.fault_op("db.write")
                if v is None:
                    c.execute("DELETE FROM kv WHERE k = ?", (k,))
                else:
                    c.execute("INSERT OR REPLACE INTO kv (k, v) VALUES (?, ?)", (k, v))
        _observe_db_write(t0)

    def close(self) -> None:
        """Close EVERY connection this store minted, whichever thread
        minted it. Safe because each conn's minting thread only touches
        it between operations (and a closed node has stopped issuing
        them); sqlite3 allows the cross-thread close itself via
        check_same_thread=False. A later use reopens (fresh conn)."""
        with self._conns_lock:
            conns, self._conns = list(self._conns), []
        for conn in conns:
            try:
                conn.close()
            except sqlite3.Error:
                pass
        self._local = threading.local()


_CRC_TAG = b"\x01"  # value-format version byte for CRC-guarded records


class CRCStore(KVStore):
    """CRC32 guard over an inner store: set() wraps values as
    [0x01 | payload | crc32(payload)]; get() verifies and unwraps,
    raising ErrCorruptValue on any mismatch. This is the block/state
    record guard the storage plane promises: a rotted bit becomes a
    typed, actionable halt — never an accepted block or a mis-parsed
    header."""

    def __init__(self, inner: KVStore):
        self.inner = inner

    @staticmethod
    def _wrap(value: bytes) -> bytes:
        return _CRC_TAG + value + (zlib.crc32(value) & 0xFFFFFFFF).to_bytes(4, "big")

    @staticmethod
    def _unwrap(key: bytes, raw: bytes) -> bytes:
        if len(raw) < 5 or raw[:1] != _CRC_TAG:
            # a rotted TAG byte lands here, not in the crc branch: both
            # are detections and both must count
            CRCStore._count_corruption()
            raise ErrCorruptValue(
                key, f"missing CRC envelope (len {len(raw)}, "
                     f"tag {raw[:1].hex() if raw else 'empty'})")
        payload, want = raw[1:-4], int.from_bytes(raw[-4:], "big")
        got = zlib.crc32(payload) & 0xFFFFFFFF
        if got != want:
            CRCStore._count_corruption()
            raise ErrCorruptValue(
                key, f"crc32 {got:08x} != stored {want:08x}")
        return payload

    @staticmethod
    def _count_corruption() -> None:
        from cometbft_tpu_torch.libs import metrics as cmtmetrics

        cmtmetrics.storage_metrics().corruption_detected.inc()

    def get(self, key: bytes) -> bytes | None:
        raw = self.inner.get(key)
        return None if raw is None else self._unwrap(key, raw)

    def set(self, key: bytes, value: bytes) -> None:
        self.inner.set(key, self._wrap(value))

    def delete(self, key: bytes) -> None:
        self.inner.delete(key)

    def iterate(self, start: bytes = b"", end: bytes | None = None):
        for k, raw in self.inner.iterate(start, end):
            yield k, self._unwrap(k, raw)

    def batch_set(self, pairs: list[tuple[bytes, bytes | None]]) -> None:
        self.inner.batch_set(
            [(k, None if v is None else self._wrap(v)) for k, v in pairs])

    def close(self) -> None:
        self.inner.close()


def open_db(backend: str, path: str | None = None,
            synchronous: str = "NORMAL", checksum: bool = False) -> KVStore:
    if backend == "memdb":
        db: KVStore = MemDB()
    elif backend == "sqlite":
        if not path:
            raise ValueError("sqlite backend requires a path")
        db = SQLiteDB(path, synchronous=synchronous)
    else:
        raise ValueError(f"unknown db backend {backend!r}")
    return CRCStore(db) if checksum else db
