"""Host-side numpy packing between wire bytes and device limb arrays.

Field elements are radix-2^13 limbs, 20 of them (260 bits), little-endian
int32. Point encodings and scalars cross to the device as packed
little-endian 32-bit words, (8, B) per 32-byte item, batch-minor; the
device side unpacks them (ops/unpack.py, and the verify kernel's prologue).
"""

from __future__ import annotations

import numpy as np

RADIX = 13
NLIMBS = 20  # 20 * 13 = 260 bits >= 255
MASK = (1 << RADIX) - 1


def int_to_limbs(x: int) -> np.ndarray:
    """Single Python int -> (20,) int32 limb array."""
    out = np.zeros(NLIMBS, dtype=np.int32)
    for i in range(NLIMBS):
        out[i] = x & MASK
        x >>= RADIX
    if x:
        raise ValueError("value exceeds 260 bits")
    return out


def limbs_to_int(limbs: np.ndarray) -> int:
    """(20,) limb array -> Python int (limbs may be redundant or signed)."""
    acc = 0
    for i in reversed(range(NLIMBS)):
        acc = (acc << RADIX) + int(limbs[i])
    return acc


def bytes_to_words(raw: np.ndarray) -> np.ndarray:
    """(B, 32) uint8 -> (B, 8) uint32 little-endian words — the packed
    host->device wire layout."""
    return np.ascontiguousarray(raw).view("<u4").reshape(raw.shape[0], 8)
