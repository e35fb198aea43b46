"""CertStore: durable commit certificates on the storage plane.

One KVStore (normally an `open_db(..., checksum=True)` CRC-guarded
SQLite db, so every read/write rides the diskchaos `db.read`/`db.write`
seams and every value carries a crc32 envelope) holding one certificate
per height under a fixed-width big-endian key — range iteration walks
heights in order, which is what pruning and backfill gap-scans need.

Corruption policy mirrors the block store's quarantine rule: a value
that fails the CRC envelope or the certificate codec is DELETED and
counted, and the reader sees "no certificate" — consumers then run the
classic per-vote path. A bad byte on disk can cost a fallback, never a
wrong verdict and never a crash loop.

The port's copy of cometbft_tpu/cert/store.py.
"""

from __future__ import annotations

import struct
import threading

from cometbft_tpu_torch.cert.certificate import CommitCertificate
from cometbft_tpu_torch.store.db import ErrCorruptValue, KVStore

_PREFIX = b"cert:"


def _key(height: int) -> bytes:
    return _PREFIX + struct.pack(">Q", height)


def _height_of(key: bytes) -> int:
    return struct.unpack(">Q", key[len(_PREFIX):])[0]


class CertStore:
    def __init__(self, db: KVStore):
        self.db = db
        self._lock = threading.RLock()
        self.quarantined = 0  # corrupt values deleted on read

    def put(self, cert: CommitCertificate) -> None:
        with self._lock:
            self.db.set(_key(cert.height), cert.encode())

    def has(self, height: int) -> bool:
        with self._lock:
            return self.db.has(_key(height))

    def get(self, height: int) -> CommitCertificate | None:
        """The decoded certificate, or None (absent OR quarantined)."""
        raw = self.get_raw(height)
        if raw is None:
            return None
        try:
            return CommitCertificate.decode(raw)
        except ValueError:
            self._quarantine(height)
            return None

    def get_raw(self, height: int) -> bytes | None:
        """The encoded certificate bytes (serving paths ship these
        verbatim), or None."""
        with self._lock:
            try:
                return self.db.get(_key(height))
            except ErrCorruptValue:
                self._quarantine(height)
                return None

    def _quarantine(self, height: int) -> None:
        with self._lock:
            self.quarantined += 1
            try:
                self.db.delete(_key(height))
            except Exception:  # noqa: BLE001 - best-effort removal
                pass

    def _scan_keys(self, start: bytes, end: bytes) -> list[bytes]:
        """Key-only range scan tolerant of corrupt VALUES: a CRC-guarded
        iterator raises mid-scan on a rotted record, which would let one
        bad byte veto pruning and backfill planning for every other
        height. Quarantine the offender and resume past it instead."""
        keys: list[bytes] = []
        while True:
            try:
                for k, _ in self.db.iterate(start, end):
                    keys.append(k)
                return keys
            except ErrCorruptValue as e:
                self._quarantine(_height_of(e.key))
                start = e.key + b"\x00"

    def heights(self) -> list[int]:
        """All certified heights, ascending."""
        with self._lock:
            return [_height_of(k)
                    for k in self._scan_keys(_PREFIX, _PREFIX + b"\xff")]

    def missing_in(self, base: int, head: int, limit: int) -> list[int]:
        """Up to `limit` uncertified heights in [base, head], ascending —
        the backfill worker's batch planner."""
        if head < base or limit <= 0:
            return []
        with self._lock:
            have = {_height_of(k)
                    for k in self._scan_keys(_key(base), _key(head + 1))}
        out = []
        for h in range(base, head + 1):
            if h not in have:
                out.append(h)
                if len(out) >= limit:
                    break
        return out

    def count(self) -> int:
        with self._lock:
            return len(self._scan_keys(_PREFIX, _PREFIX + b"\xff"))

    def prune(self, retain_height: int) -> int:
        """Delete certificates for heights < retain_height (the block
        pruner's discipline: strictly below retain is gone, at/above is
        kept). Returns the number pruned."""
        with self._lock:
            doomed = self._scan_keys(_PREFIX, _key(retain_height))
            if doomed:
                self.db.batch_set([(k, None) for k in doomed])
            return len(doomed)

    def close(self) -> None:
        self.db.close()
