"""RFC-6962 merkle trees (reference: crypto/merkle/tree.go:11-101, proof.go).

Used for block-part sets, tx roots, validator-set hashes, header hashes.
Leaf hash = SHA256(0x00 || leaf); inner = SHA256(0x01 || left || right);
split point = largest power of two strictly less than n; empty tree hash =
SHA256("").

The port's copy of cometbft_tpu/crypto/merkle.py.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field

_LEAF_PREFIX = b"\x00"
_INNER_PREFIX = b"\x01"


def _sha256(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()


def empty_hash() -> bytes:
    return _sha256(b"")


def leaf_hash(leaf: bytes) -> bytes:
    return _sha256(_LEAF_PREFIX + leaf)


def inner_hash(left: bytes, right: bytes) -> bytes:
    return _sha256(_INNER_PREFIX + left + right)


def get_split_point(n: int) -> int:
    """Largest power of 2 strictly less than n (reference tree.go:93-101)."""
    if n < 2:
        raise ValueError("n must be >= 2")
    return 1 << ((n - 1).bit_length() - 1)


def hash_from_byte_slices(items: list[bytes]) -> bytes:
    n = len(items)
    if n == 0:
        return empty_hash()
    if n == 1:
        return leaf_hash(items[0])
    k = get_split_point(n)
    return inner_hash(hash_from_byte_slices(items[:k]), hash_from_byte_slices(items[k:]))


@dataclass
class Proof:
    """Merkle inclusion proof (reference: crypto/merkle/proof.go:20-33)."""

    total: int
    index: int
    leaf_hash: bytes
    aunts: list[bytes] = field(default_factory=list)

    def verify(self, root_hash: bytes, leaf: bytes) -> bool:
        if self.total < 0 or self.index < 0:
            return False
        if leaf_hash(leaf) != self.leaf_hash:
            return False
        computed = self.compute_root_hash()
        return computed is not None and computed == root_hash

    def compute_root_hash(self) -> bytes | None:
        return _compute_hash_from_aunts(self.index, self.total, self.leaf_hash, self.aunts)


def _compute_hash_from_aunts(index: int, total: int, leaf: bytes,
                             aunts: list[bytes]) -> bytes | None:
    """reference: crypto/merkle/proof.go:161-191."""
    if index >= total or index < 0 or total <= 0:
        return None
    if total == 1:
        if aunts:
            return None
        return leaf
    if not aunts:
        return None
    k = get_split_point(total)
    if index < k:
        left = _compute_hash_from_aunts(index, k, leaf, aunts[:-1])
        if left is None:
            return None
        return inner_hash(left, aunts[-1])
    right = _compute_hash_from_aunts(index - k, total - k, leaf, aunts[:-1])
    if right is None:
        return None
    return inner_hash(aunts[-1], right)


def proofs_from_byte_slices(items: list[bytes]) -> tuple[bytes, list[Proof]]:
    """Root hash + one proof per item (reference: proof.go:61-78)."""
    trails, root = _trails_from_byte_slices(items)
    root_hash = root.hash
    proofs = []
    for i, trail in enumerate(trails):
        proofs.append(Proof(total=len(items), index=i, leaf_hash=trail.hash,
                            aunts=trail.flatten_aunts()))
    return root_hash, proofs


class _ProofNode:
    __slots__ = ("hash", "parent", "left", "right")

    def __init__(self, h: bytes):
        self.hash = h
        self.parent: _ProofNode | None = None
        self.left: _ProofNode | None = None   # left sibling (aunt)
        self.right: _ProofNode | None = None  # right sibling (aunt)

    def flatten_aunts(self) -> list[bytes]:
        aunts: list[bytes] = []
        node: _ProofNode | None = self
        while node is not None:
            if node.left is not None:
                aunts.append(node.left.hash)
            elif node.right is not None:
                aunts.append(node.right.hash)
            node = node.parent
        return aunts


def _trails_from_byte_slices(items: list[bytes]) -> tuple[list[_ProofNode], _ProofNode]:
    n = len(items)
    if n == 0:
        return [], _ProofNode(empty_hash())
    if n == 1:
        node = _ProofNode(leaf_hash(items[0]))
        return [node], node
    k = get_split_point(n)
    lefts, left_root = _trails_from_byte_slices(items[:k])
    rights, right_root = _trails_from_byte_slices(items[k:])
    root = _ProofNode(inner_hash(left_root.hash, right_root.hash))
    left_root.parent = root
    left_root.right = right_root
    right_root.parent = root
    right_root.left = left_root
    return lefts + rights, root
