"""sr25519 keys over the port's schnorrkel oracle (crypto/sr25519_math.py).

Key type string, sizes and address derivation follow CometBFT's
crypto/sr25519 (pubkey.go: SHA-256 of the raw ristretto bytes, truncated to
20). Signing and single verification run in pure Python here; batch
verification goes through crypto.batch to the device kernel
(ops/sr25519_kernel.py), or CPUBatchVerifier's per-signature loop.
"""

from __future__ import annotations

import hashlib
import secrets

from cometbft_tpu_torch import crypto
from cometbft_tpu_torch.crypto import sr25519_math as srm

KEY_TYPE = "sr25519"
PUB_KEY_SIZE = 32
PRIV_KEY_SIZE = 32  # the MiniSecretKey (privkey.go)
SIGNATURE_SIZE = 64


class PubKey(crypto.PubKey):
    __slots__ = ("_bytes",)

    def __init__(self, data: bytes):
        if len(data) != PUB_KEY_SIZE:
            raise crypto.ErrInvalidKey(f"sr25519 pubkey must be {PUB_KEY_SIZE} bytes")
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
        return srm.verify(self._bytes, bytes(msg), sig)

    def __repr__(self) -> str:
        return f"PubKeySr25519{{{self._bytes.hex().upper()}}}"


class PrivKey(crypto.PrivKey):
    __slots__ = ("_mini", "_pair", "_pub")

    def __init__(self, data: bytes):
        if len(data) != PRIV_KEY_SIZE:
            raise crypto.ErrInvalidKey("sr25519 privkey must be 32 bytes (mini secret)")
        self._mini = bytes(data)
        self._pair = srm.keypair_from_mini(self._mini)
        self._pub = PubKey(self._pair[2])

    def bytes_(self) -> bytes:
        return self._mini

    def sign(self, msg: bytes) -> bytes:
        return srm.sign(self._pair, bytes(msg))

    def pub_key(self) -> PubKey:
        return self._pub

    def type_(self) -> str:
        return KEY_TYPE


def gen_priv_key() -> PrivKey:
    return PrivKey(secrets.token_bytes(PRIV_KEY_SIZE))


def gen_priv_key_from_secret(secret: bytes) -> PrivKey:
    """Deterministic key from a secret: mini secret = SHA-256(secret).
    Testing only."""
    return PrivKey(hashlib.sha256(secret).digest())


class CPUBatchVerifier(crypto.BatchVerifier):
    """The host oracle one signature at a time — no device, no batching."""

    def __init__(self) -> None:
        self._items: list[tuple[PubKey, bytes, bytes]] = []

    def add(self, pub_key: crypto.PubKey, msg: bytes, sig: bytes) -> None:
        if not isinstance(pub_key, PubKey):
            raise crypto.ErrInvalidKey("sr25519 batch verifier got a non-sr25519 key")
        if len(sig) != SIGNATURE_SIZE:
            raise crypto.ErrInvalidSignature("bad signature length")
        self._items.append((pub_key, bytes(msg), bytes(sig)))

    def verify(self) -> tuple[bool, list[bool]]:
        mask = [pk.verify_signature(msg, sig) for pk, msg, sig in self._items]
        return all(mask), mask

    def count(self) -> int:
        return len(self._items)
