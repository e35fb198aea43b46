"""secp256k1 keys (reference: crypto/secp256k1/secp256k1.go). The port's
copy of cometbft_tpu/crypto/secp256k1.py, with its own copy of the
pure-Python ECDSA of cometbft_tpu/crypto/fallback.py (the secp256k1
section: RFC 6979 deterministic nonces, SEC 1 point compression).

Wire formats mirror the reference: 33-byte compressed pubkeys, 64-byte R||S
signatures with S canonicalized to the lower half-order (secp256k1.go:180-190
— malleability guard), and Bitcoin-style addresses RIPEMD160(SHA256(pubkey))
(secp256k1.go:23-41).

The port takes the pure-Python path only: the `cryptography` package that
the reference prefers is not a dependency of the port. Signing and
verification cost milliseconds each; secp256k1 keys sign rarely and verify
serially.

No batch path: secp256k1 has no safe batch verification (crypto/batch
excludes it, batch.go:26-32), so commits containing secp256k1 validators
fall back to per-signature verification (types/validation.py _ADD_ERRORS)
— same behavior as the reference.
"""

from __future__ import annotations

import hashlib
import hmac as _hmac
import secrets as _secrets

from cometbft_tpu_torch import crypto

KEY_TYPE = "secp256k1"
PUB_KEY_SIZE = 33
PRIV_KEY_SIZE = 32
SIGNATURE_SIZE = 64

# SEC 2 curve: field prime, group order (canonical signatures use
# s <= N/2), generator
SECP_P = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEFFFFFC2F
N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
_HALF_N = N // 2
_SECP_G = (
    0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798,
    0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8,
)


# ---------------------------------------------------------------------------
# ECDSA over secp256k1 (affine coordinates; None is the point at infinity)
# ---------------------------------------------------------------------------


def _secp_add(p, q):
    if p is None:
        return q
    if q is None:
        return p
    x1, y1 = p
    x2, y2 = q
    if x1 == x2 and (y1 + y2) % SECP_P == 0:
        return None
    if p == q:
        lam = (3 * x1 * x1) * pow(2 * y1, SECP_P - 2, SECP_P) % SECP_P
    else:
        lam = (y2 - y1) * pow(x2 - x1, SECP_P - 2, SECP_P) % SECP_P
    x3 = (lam * lam - x1 - x2) % SECP_P
    return x3, (lam * (x1 - x3) - y1) % SECP_P


def _secp_mul(k: int, p):
    acc = None
    while k:
        if k & 1:
            acc = _secp_add(acc, p)
        p = _secp_add(p, p)
        k >>= 1
    return acc


def secp_point_decompress(data: bytes):
    """33-byte SEC compressed encoding -> (x, y) or None."""
    if len(data) != 33 or data[0] not in (2, 3):
        return None
    x = int.from_bytes(data[1:], "big")
    if x >= SECP_P:
        return None
    y2 = (pow(x, 3, SECP_P) + 7) % SECP_P
    y = pow(y2, (SECP_P + 1) // 4, SECP_P)
    if y * y % SECP_P != y2:
        return None
    if y & 1 != data[0] & 1:
        y = SECP_P - y
    return x, y


def secp_point_compress(p) -> bytes:
    x, y = p
    return bytes([2 | (y & 1)]) + x.to_bytes(32, "big")


def secp_pub_from_priv(d: int) -> bytes:
    return secp_point_compress(_secp_mul(d, _SECP_G))


def _rfc6979_k(d: int, h1: bytes) -> int:
    """RFC 6979 §3.2 deterministic nonce for SHA-256/secp256k1."""
    x = d.to_bytes(32, "big")
    # bits2octets: reduce the hash mod N before keying HMAC (§2.3.4)
    h1 = (int.from_bytes(h1, "big") % N).to_bytes(32, "big")
    v = b"\x01" * 32
    k = b"\x00" * 32
    k = _hmac.new(k, v + b"\x00" + x + h1, hashlib.sha256).digest()
    v = _hmac.new(k, v, hashlib.sha256).digest()
    k = _hmac.new(k, v + b"\x01" + x + h1, hashlib.sha256).digest()
    v = _hmac.new(k, v, hashlib.sha256).digest()
    while True:
        v = _hmac.new(k, v, hashlib.sha256).digest()
        cand = int.from_bytes(v, "big")
        if 0 < cand < N:
            return cand
        k = _hmac.new(k, v + b"\x00", hashlib.sha256).digest()
        v = _hmac.new(k, v, hashlib.sha256).digest()


def secp_sign(d: int, msg: bytes) -> tuple[int, int]:
    """ECDSA-SHA256 -> (r, s); the caller canonicalizes S."""
    h1 = hashlib.sha256(msg).digest()
    z = int.from_bytes(h1, "big") % N
    while True:
        k = _rfc6979_k(d, h1)
        pt = _secp_mul(k, _SECP_G)
        r = pt[0] % N
        if r == 0:
            continue
        s = (z + r * d) * pow(k, N - 2, N) % N
        if s == 0:
            continue
        return r, s


def secp_verify(pub33: bytes, msg: bytes, r: int, s: int) -> bool:
    pt = secp_point_decompress(pub33)
    if pt is None or not (0 < r < N and 0 < s < N):
        return False
    z = int.from_bytes(hashlib.sha256(msg).digest(), "big") % N
    w = pow(s, N - 2, N)
    res = _secp_add(_secp_mul(z * w % N, _SECP_G), _secp_mul(r * w % N, pt))
    return res is not None and res[0] % N == r


# ---------------------------------------------------------------------------
# keys
# ---------------------------------------------------------------------------


class PubKey(crypto.PubKey):
    __slots__ = ("_bytes",)

    def __init__(self, data: bytes):
        if len(data) != PUB_KEY_SIZE:
            raise crypto.ErrInvalidKey(f"secp256k1 pubkey must be {PUB_KEY_SIZE} bytes")
        self._bytes = bytes(data)

    def address(self) -> bytes:
        """secp256k1.go:23-41: RIPEMD160(SHA256(compressed pubkey))."""
        sha = hashlib.sha256(self._bytes).digest()
        return hashlib.new("ripemd160", sha).digest()

    def bytes_(self) -> bytes:
        return self._bytes

    def type_(self) -> str:
        return KEY_TYPE

    def verify_signature(self, msg: bytes, sig: bytes) -> bool:
        """64-byte R||S; rejects non-canonical S (upper half-order),
        matching secp256k1.go:192-210 VerifyBytes."""
        if len(sig) != SIGNATURE_SIZE:
            return False
        if type(msg) is not bytes:
            msg = bytes(msg)  # shared-prefix factored rows (prefixrows)
        r = int.from_bytes(sig[:32], "big")
        s = int.from_bytes(sig[32:], "big")
        if not (0 < r < N and 0 < s <= _HALF_N):
            return False
        return secp_verify(self._bytes, msg, r, s)

    def __repr__(self) -> str:
        return f"PubKeySecp256k1{{{self._bytes.hex().upper()}}}"


class PrivKey(crypto.PrivKey):
    __slots__ = ("_bytes", "_pub")

    def __init__(self, data: bytes):
        if len(data) != PRIV_KEY_SIZE:
            raise crypto.ErrInvalidKey("secp256k1 privkey must be 32 bytes")
        self._bytes = bytes(data)
        d = int.from_bytes(data, "big")
        if not 0 < d < N:
            raise crypto.ErrInvalidKey("secp256k1 privkey out of range")
        self._pub = PubKey(secp_pub_from_priv(d))

    def bytes_(self) -> bytes:
        return self._bytes

    def sign(self, msg: bytes) -> bytes:
        """64-byte R||S with low-S canonicalization (secp256k1.go:160-178)."""
        r, s = secp_sign(int.from_bytes(self._bytes, "big"), bytes(msg))
        if s > _HALF_N:
            s = N - s
        return r.to_bytes(32, "big") + s.to_bytes(32, "big")

    def pub_key(self) -> PubKey:
        return self._pub

    def type_(self) -> str:
        return KEY_TYPE


def gen_priv_key() -> PrivKey:
    while True:
        d = _secrets.token_bytes(PRIV_KEY_SIZE)
        if 0 < int.from_bytes(d, "big") < N:
            return PrivKey(d)


def gen_priv_key_from_secret(secret: bytes) -> PrivKey:
    """Deterministic key: SHA256(secret) clamped into range (testing only)."""
    d = int.from_bytes(hashlib.sha256(secret).digest(), "big") % (N - 1) + 1
    return PrivKey(d.to_bytes(32, "big"))
