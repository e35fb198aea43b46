"""SHA-256 hashing (reference: crypto/tmhash/hash.go).

SIZE is the hash size the block IDs check; sum_() the 32-byte hash.

The port's copy of the part of cometbft_tpu/crypto/tmhash.py that the
types use.
"""

import hashlib

SIZE = 32


def sum_(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()
