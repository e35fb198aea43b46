"""Ed25519 keys over the port's ZIP-215 oracle (crypto/ed25519_math.py).

Key type string, sizes and address derivation follow CometBFT's
crypto/ed25519. Signing and single verification run in pure Python here;
batch verification goes through crypto.batch to the device kernel.
"""

from __future__ import annotations

import hashlib
import secrets

from cometbft_tpu_torch import crypto
from cometbft_tpu_torch.crypto import ed25519_math

KEY_TYPE = "ed25519"
PUB_KEY_SIZE = 32
PRIV_KEY_SIZE = 64  # seed || pubkey, Go's ed25519.PrivateKey layout
SIGNATURE_SIZE = 64
SEED_SIZE = 32


class PubKey(crypto.PubKey):
    __slots__ = ("_bytes",)

    def __init__(self, data: bytes):
        if len(data) != PUB_KEY_SIZE:
            raise crypto.ErrInvalidKey(f"ed25519 pubkey must be {PUB_KEY_SIZE} bytes")
        self._bytes = bytes(data)

    def address(self) -> bytes:
        return hashlib.sha256(self._bytes).digest()[:crypto.ADDRESS_SIZE]

    def bytes_(self) -> bytes:
        return self._bytes

    def type_(self) -> str:
        return KEY_TYPE

    def verify_signature(self, msg: bytes, sig: bytes) -> bool:
        if len(sig) != SIGNATURE_SIZE:
            return False
        return ed25519_math.verify_zip215(self._bytes, bytes(msg), sig)

    def __repr__(self) -> str:
        return f"PubKeyEd25519{{{self._bytes.hex().upper()}}}"


class PrivKey(crypto.PrivKey):
    __slots__ = ("_seed", "_pub")

    def __init__(self, data: bytes):
        # a 32-byte seed or the 64-byte seed || pub (Go layout)
        if len(data) == SEED_SIZE:
            seed = bytes(data)
        elif len(data) == PRIV_KEY_SIZE:
            seed = bytes(data[:SEED_SIZE])
        else:
            raise crypto.ErrInvalidKey("ed25519 privkey must be 32 or 64 bytes")
        self._seed = seed
        self._pub = PubKey(ed25519_math.public_key_from_seed(seed))

    def bytes_(self) -> bytes:
        return self._seed + self._pub.bytes_()

    def sign(self, msg: bytes) -> bytes:
        return ed25519_math.sign(self._seed, bytes(msg))

    def pub_key(self) -> PubKey:
        return self._pub

    def type_(self) -> str:
        return KEY_TYPE


def gen_priv_key() -> PrivKey:
    """A fresh key from the operating system's randomness (CometBFT's
    GenPrivKey)."""
    return PrivKey(secrets.token_bytes(SEED_SIZE))


def gen_priv_key_from_secret(secret: bytes) -> PrivKey:
    """Deterministic key from a secret: seed = SHA-256(secret) (CometBFT's
    GenPrivKeyFromSecret). Testing only."""
    return PrivKey(hashlib.sha256(secret).digest())
