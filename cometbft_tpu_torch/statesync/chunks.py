"""Chunk queue (reference: statesync/chunks.go).

Ordered delivery of snapshot chunks to the applier with out-of-order
arrival, retry, and per-chunk sender tracking. The reference spools chunks
to temp files (they can be large); this keeps them in memory with the same
interface — a disk spill belongs at the node layer once snapshots exceed
RAM.

The port's copy of cometbft_tpu/statesync/chunks.py.
"""

from __future__ import annotations

import asyncio
from typing import Optional


class ErrQueueClosed(Exception):
    pass


class ChunkQueue:
    """chunks.go:24-260, asyncio-shaped: allocate() hands out the next
    chunk index to a fetcher; add() stores an arrived chunk and wakes the
    applier; next_chunk() yields chunks strictly in order."""

    def __init__(self, num_chunks: int):
        self.num_chunks = num_chunks
        self._chunks: dict[int, bytes] = {}
        self._senders: dict[int, str] = {}
        self._allocated: set[int] = set()
        self._returned: set[int] = set()
        self._next = 0
        self._closed = False
        self._cond = asyncio.Condition()

    async def allocate(self) -> Optional[int]:
        """Next never-allocated (or retry-returned) index; None when all
        are allocated (fetchers then idle until retry or close)."""
        async with self._cond:
            if self._closed:
                raise ErrQueueClosed
            for i in range(self.num_chunks):
                if i in self._returned:
                    self._returned.discard(i)
                    return i
                if i not in self._allocated and i not in self._chunks:
                    self._allocated.add(i)
                    return i
            return None

    async def add(self, index: int, chunk: bytes, sender: str = "") -> bool:
        """Store an arrived chunk. Returns False for dupes/out-of-range."""
        async with self._cond:
            if self._closed:
                return False
            if not 0 <= index < self.num_chunks or index in self._chunks:
                return False
            self._chunks[index] = chunk
            self._senders[index] = sender
            self._allocated.discard(index)
            self._cond.notify_all()
            return True

    async def next_chunk(self, timeout: float = 60.0) -> tuple[int, bytes]:
        """Block until the next in-order chunk is present."""
        async with self._cond:
            want = self._next

            def ready():
                return self._closed or want in self._chunks

            try:
                await asyncio.wait_for(
                    self._cond.wait_for(ready), timeout)
            except asyncio.TimeoutError:
                raise TimeoutError(f"timed out waiting for chunk {want}") from None
            if self._closed:
                raise ErrQueueClosed
            self._next += 1
            return want, self._chunks[want]

    def sender_of(self, index: int) -> str:
        return self._senders.get(index, "")

    async def retry(self, index: int) -> None:
        """chunks.go Retry: discard + refetch a chunk (app asked)."""
        async with self._cond:
            self._chunks.pop(index, None)
            self._allocated.discard(index)
            self._returned.add(index)
            self._next = min(self._next, index)
            self._cond.notify_all()

    async def retry_all(self) -> None:
        async with self._cond:
            self._chunks.clear()
            self._allocated.clear()
            self._returned = set(range(self.num_chunks))
            self._next = 0
            self._cond.notify_all()

    async def close(self) -> None:
        async with self._cond:
            self._closed = True
            self._cond.notify_all()

    def done(self) -> bool:
        return self._next >= self.num_chunks
