"""RFC-6962 merkle roots (reference: crypto/merkle/tree.go:11-101).

Used for validator-set and commit hashes.
Leaf hash = SHA256(0x00 || leaf); inner = SHA256(0x01 || left || right);
split point = largest power of two strictly less than n; empty tree hash =
SHA256("").

The port's copy of the roots of cometbft_tpu/crypto/merkle.py (its
inclusion proofs are not ported: nothing in the port uses them).
"""

from __future__ import annotations

import hashlib

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
