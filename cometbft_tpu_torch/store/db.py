"""Key-value backend interface (reference: cometbft-db's DB interface, used
by store/store.go, state/store.go, indexers, evidence pool, light store).
Iteration is ordered by raw key bytes, matching the reference's iterator
contract.

The port's copy of KVStore and MemDB of cometbft_tpu/store/db.py (the
light client's store sits on them). SQLiteDB, CRCStore and open_db, with
their disk-fault sites and storage metrics, come with the node.
"""

from __future__ import annotations

import threading
from typing import Iterator


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
