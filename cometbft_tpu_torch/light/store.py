"""Trusted light-block store.

Reference: light/store/store.go (interface) + light/store/db/db.go (the
only implementation: size-tracked, pruning, first/last scans). Backed by
the same KVStore abstraction as every other store in the framework
(store/db.py: MemDB / SQLite), keyed lb/<height:020d>.

The port's copy of cometbft_tpu/light/store.py.
"""

from __future__ import annotations

from typing import Optional

from cometbft_tpu_torch.store.db import KVStore
from cometbft_tpu_torch.types.light import LightBlock

_PREFIX = b"lb/"


def _key(height: int) -> bytes:
    return _PREFIX + b"%020d" % height


class LightStore:
    """light/store/db/db.go:24-214."""

    def __init__(self, db: KVStore):
        self.db = db
        self._heights: list[int] = sorted(
            int(k[len(_PREFIX):])
            for k, _ in db.iterate(_PREFIX, _PREFIX + b"\xff")
        )

    def save_light_block(self, lb: LightBlock) -> None:
        if lb.height <= 0:
            raise ValueError("lightBlock.Height <= 0")
        self.db.set(_key(lb.height), lb.to_proto())
        if not self._heights or lb.height != self._heights[-1]:
            import bisect

            i = bisect.bisect_left(self._heights, lb.height)
            if i >= len(self._heights) or self._heights[i] != lb.height:
                self._heights.insert(i, lb.height)

    def light_block(self, height: int) -> Optional[LightBlock]:
        data = self.db.get(_key(height))
        return LightBlock.from_proto(data) if data is not None else None

    def latest_light_block(self) -> Optional[LightBlock]:
        return self.light_block(self._heights[-1]) if self._heights else None

    def first_light_block(self) -> Optional[LightBlock]:
        return self.light_block(self._heights[0]) if self._heights else None

    def light_block_before(self, height: int) -> Optional[LightBlock]:
        """db.go:170-189 LightBlockBefore: greatest stored height < height."""
        import bisect

        i = bisect.bisect_left(self._heights, height)
        return self.light_block(self._heights[i - 1]) if i > 0 else None

    def light_block_by_hash(self, want: bytes) -> Optional[LightBlock]:
        """Linear scan over trusted blocks (proxy header_by_hash; the store
        is bounded by prune())."""
        for h in self._heights:
            lb = self.light_block(h)
            if lb is not None and lb.signed_header.header.hash() == want:
                return lb
        return None

    def delete_light_block(self, height: int) -> None:
        self.db.delete(_key(height))
        try:
            self._heights.remove(height)
        except ValueError:
            pass

    def prune(self, size: int) -> None:
        """db.go:129-160: keep the newest `size` blocks."""
        while len(self._heights) > size:
            self.delete_light_block(self._heights[0])

    def prune_expired(self, trusting_period_ns: int, now) -> int:
        """Drop every block whose trusting period has lapsed at `now` —
        an expired header can no longer anchor any verification, so
        keeping it only wastes the size budget. Returns the count pruned.
        (The serving plane's checkpoint cache applies the same rule
        in-memory; this is the persistent-store twin.)"""
        pruned = 0
        for h in list(self._heights):
            lb = self.light_block(h)
            if lb is None:
                continue
            if lb.time.unix_ns() + trusting_period_ns <= now.unix_ns():
                self.delete_light_block(h)
                pruned += 1
            else:
                break  # heights ascend and so do header times
        return pruned

    def size(self) -> int:
        return len(self._heights)
