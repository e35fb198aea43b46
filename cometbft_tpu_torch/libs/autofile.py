"""Rotating file groups (reference: libs/autofile/group.go).

A Group is a head file plus numbered chunks (`path`, `path.000`,
`path.001`, ...): writers append to the head; when the head passes
chunk_size (checked at record boundaries so records never split), it
rotates to the next numbered chunk and a fresh head opens. Total size is
bounded by pruning the oldest chunks (group.go:36 headSizeLimit /
totalSizeLimit). Readers see one logical stream across chunks in order.

Storage-fault plane: every append rides the `wal.write` disk-chaos seam,
every fsync the `wal.fsync` seam, and the rotation rename is a
durable_replace through `wal.rotate` — the head->chunk rename is only
durable after the directory fsync, and a crash between the rename and
the next write must leave a replayable group (tests: autofile
rotation-crash cases in test_storage_crash_matrix.py).

The port's copy of cometbft_tpu/libs/autofile.py.
"""

from __future__ import annotations

import os
import re
from typing import Iterator

from cometbft_tpu_torch.libs import diskchaos, diskio

DEFAULT_CHUNK_SIZE = 10 * 1024 * 1024   # group.go:41 defaultHeadSizeLimit
DEFAULT_TOTAL_SIZE = 1024 * 1024 * 1024  # group.go:42 defaultTotalSizeLimit


class Group:
    def __init__(self, head_path: str,
                 chunk_size: int = DEFAULT_CHUNK_SIZE,
                 total_size: int = DEFAULT_TOTAL_SIZE):
        self.head_path = head_path
        self.chunk_size = chunk_size
        self.total_size = total_size
        os.makedirs(os.path.dirname(head_path) or ".", exist_ok=True)
        # UNBUFFERED on purpose: a user-space Python buffer made every
        # append's durability a lie — a kill -9 dropped records that
        # write() had "accepted" but never handed to the OS. Unbuffered,
        # a process kill loses nothing (the page cache survives); only
        # power loss can, and that is exactly what the fsync discipline
        # (and the fsync_lie chaos model) governs.
        self._head = open(head_path, "ab", buffering=0)
        # fsync-lie rewind anchor: bytes on disk at open are durable
        diskchaos.track_open(head_path)

    # ------------------------------------------------------------- write

    def write(self, data: bytes) -> None:
        diskchaos.fault_write("wal.write", self._head, data)

    def flush(self) -> None:
        self._head.flush()

    def fsync(self) -> None:
        self._head.flush()
        diskchaos.fault_fsync("wal.fsync", self._head.fileno(), self.head_path)

    def maybe_rotate(self) -> bool:
        """Call at a record boundary; rotates the head into a numbered
        chunk when it exceeds chunk_size (group.go:190 checkHeadSizeLimit).
        Returns True if a rotation happened. The rename is durable (dir
        fsync) before the fresh head opens — a crash anywhere in between
        leaves either the old head or the completed chunk, never a
        half-renamed group."""
        if self._head.tell() < self.chunk_size:
            return False
        self.fsync()
        self._head.close()
        idx = self._chunk_indexes()
        nxt = (idx[-1] + 1) if idx else 0
        diskio.durable_replace(
            self.head_path, f"{self.head_path}.{nxt:03d}", site="wal.rotate")
        self._head = open(self.head_path, "ab", buffering=0)
        # fresh=True: the head path is a NEW empty file now — the renamed
        # chunk's durable anchor must not ride along
        diskchaos.track_open(self.head_path, fresh=True)
        self._prune()
        return True

    def _prune(self) -> None:
        """Drop oldest chunks while total size exceeds the limit
        (group.go:216 checkTotalSizeLimit)."""
        while True:
            paths = self.chunk_paths()
            total = sum(os.path.getsize(p) for p in paths if os.path.exists(p))
            idx = self._chunk_indexes()
            if total <= self.total_size or not idx:
                return
            os.remove(f"{self.head_path}.{idx[0]:03d}")

    def close(self) -> None:
        try:
            self.fsync()
        except (OSError, ValueError):
            pass
        self._head.close()

    def abandon(self) -> None:
        """Crash-simulation teardown: close the raw handle WITHOUT the
        close() fsync — the disk keeps exactly what the process had
        handed the OS at 'death', so the crash-matrix harness examines
        the same bytes a kill -9 would leave behind."""
        try:
            self._head.close()  # raw unbuffered: close never fsyncs
        except (OSError, ValueError):
            pass

    # -------------------------------------------------------------- read

    def _chunk_indexes(self) -> list[int]:
        d = os.path.dirname(self.head_path) or "."
        base = os.path.basename(self.head_path)
        pat = re.compile(re.escape(base) + r"\.(\d{3,})$")
        out = []
        for name in os.listdir(d):
            m = pat.match(name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def chunk_paths(self) -> list[str]:
        """Oldest chunk first, the head last — the logical stream order."""
        paths = [f"{self.head_path}.{i:03d}" for i in self._chunk_indexes()]
        paths.append(self.head_path)
        return paths

    def iter_bytes(self) -> Iterator[tuple[str, bytes]]:
        for p in self.chunk_paths():
            if os.path.exists(p):
                with open(p, "rb") as f:
                    yield p, f.read()
