"""Snapshot pool (reference: statesync/snapshots.go).

Tracks snapshots offered by peers, keyed by (height, format, chunks, hash);
ranks candidates best-first (newest height, then newest format, then most
peers); remembers rejections of snapshots, formats, and peers so a bad
offer is never retried.

The port's copy of cometbft_tpu/statesync/snapshots.py.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field


@dataclass(frozen=True)
class Snapshot:
    """snapshots.go:22-45."""

    height: int
    format: int
    chunks: int
    hash_: bytes
    metadata: bytes = b""

    def key(self) -> bytes:
        """snapshots.go:48-60: identity over all fields."""
        h = hashlib.sha256()
        h.update(self.height.to_bytes(8, "big"))
        h.update(self.format.to_bytes(4, "big"))
        h.update(self.chunks.to_bytes(4, "big"))
        h.update(self.hash_)
        h.update(self.metadata)
        return h.digest()[:16]


@dataclass
class _Entry:
    snapshot: Snapshot
    peers: set[str] = field(default_factory=set)
    trusted_app_hash: bytes = b""


class SnapshotPool:
    """snapshots.go:63-260."""

    def __init__(self):
        self._entries: dict[bytes, _Entry] = {}
        self._rejected: set[bytes] = set()
        self._rejected_formats: set[int] = set()
        self._rejected_peers: set[str] = set()

    def add(self, peer_id: str, snapshot: Snapshot) -> bool:
        """Returns True if this (snapshot, any-peer) pair is new."""
        if (
            snapshot.format in self._rejected_formats
            or peer_id in self._rejected_peers
        ):
            return False
        key = snapshot.key()
        if key in self._rejected:
            return False
        entry = self._entries.get(key)
        if entry is None:
            self._entries[key] = _Entry(snapshot, {peer_id})
            return True
        added = peer_id not in entry.peers
        entry.peers.add(peer_id)
        return added

    def best(self) -> Snapshot | None:
        """snapshots.go:166-185 Best: height desc, format desc, peers desc."""
        ranked = sorted(
            self._entries.values(),
            key=lambda e: (e.snapshot.height, e.snapshot.format, len(e.peers)),
            reverse=True,
        )
        return ranked[0].snapshot if ranked else None

    def peers_of(self, snapshot: Snapshot) -> list[str]:
        entry = self._entries.get(snapshot.key())
        return sorted(entry.peers) if entry else []

    def reject(self, snapshot: Snapshot) -> None:
        key = snapshot.key()
        self._rejected.add(key)
        self._entries.pop(key, None)

    def reject_format(self, format_: int) -> None:
        self._rejected_formats.add(format_)
        for key, e in list(self._entries.items()):
            if e.snapshot.format == format_:
                self._entries.pop(key)

    def reject_peer(self, peer_id: str) -> None:
        self._rejected_peers.add(peer_id)
        self.remove_peer(peer_id)

    def remove_peer(self, peer_id: str) -> None:
        for key, e in list(self._entries.items()):
            e.peers.discard(peer_id)
            if not e.peers:
                self._entries.pop(key)

    def __len__(self) -> int:
        return len(self._entries)
