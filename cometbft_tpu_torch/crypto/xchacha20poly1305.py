"""XChaCha20-Poly1305 AEAD (24-byte nonces).

Reference: crypto/xchacha20poly1305/xchachapoly.go — HChaCha20 derives a
subkey from the key and the nonce's first 16 bytes, then standard
ChaCha20-Poly1305 (RFC 8439; the `cryptography` package provides the
constant-time primitive) runs with a 12-byte nonce of 4 zero bytes + the
XNonce's last 8. HChaCha20 is implemented from the draft-irtf-cfrg-xchacha
specification and checked against its published vectors.

The port's copy of cometbft_tpu/crypto/xchacha20poly1305.py. Where
`cryptography` is missing, the AEAD is the port's crypto/fallback.py
ChaCha20Poly1305 (libcrypto through ctypes, else numpy/Python); the bytes
are the same on every rung and on every machine, card or not: nothing
here touches a device.
"""

from __future__ import annotations

import struct

KEY_SIZE = 32
NONCE_SIZE = 24
TAG_SIZE = 16

_SIGMA = (0x61707865, 0x3320646E, 0x79622D32, 0x6B206574)
_M32 = 0xFFFFFFFF


def _rotl32(v: int, n: int) -> int:
    return ((v << n) | (v >> (32 - n))) & _M32


def _quarter(st: list[int], a: int, b: int, c: int, d: int) -> None:
    st[a] = (st[a] + st[b]) & _M32
    st[d] = _rotl32(st[d] ^ st[a], 16)
    st[c] = (st[c] + st[d]) & _M32
    st[b] = _rotl32(st[b] ^ st[c], 12)
    st[a] = (st[a] + st[b]) & _M32
    st[d] = _rotl32(st[d] ^ st[a], 8)
    st[c] = (st[c] + st[d]) & _M32
    st[b] = _rotl32(st[b] ^ st[c], 7)


def hchacha20(key: bytes, nonce16: bytes) -> bytes:
    """32-byte subkey from (32-byte key, 16-byte nonce) — 20 ChaCha rounds,
    output words 0-3 and 12-15 (no feed-forward)."""
    assert len(key) == KEY_SIZE and len(nonce16) == 16
    st = list(_SIGMA) + list(struct.unpack("<8L", key)) \
        + list(struct.unpack("<4L", nonce16))
    for _ in range(10):
        _quarter(st, 0, 4, 8, 12)
        _quarter(st, 1, 5, 9, 13)
        _quarter(st, 2, 6, 10, 14)
        _quarter(st, 3, 7, 11, 15)
        _quarter(st, 0, 5, 10, 15)
        _quarter(st, 1, 6, 11, 12)
        _quarter(st, 2, 7, 8, 13)
        _quarter(st, 3, 4, 9, 14)
    return struct.pack("<8L", *(st[i] for i in (0, 1, 2, 3, 12, 13, 14, 15)))


def _aead(key: bytes, nonce: bytes):
    try:
        from cryptography.hazmat.primitives.ciphers.aead import ChaCha20Poly1305
    except ImportError:  # degraded: pure-Python AEAD (crypto/fallback.py)
        from cometbft_tpu_torch.crypto.fallback import ChaCha20Poly1305

    if len(key) != KEY_SIZE:
        raise ValueError("xchacha20poly1305: bad key length")
    if len(nonce) != NONCE_SIZE:
        raise ValueError("xchacha20poly1305: bad nonce length")
    subkey = hchacha20(key, nonce[:16])
    return ChaCha20Poly1305(subkey), b"\x00" * 4 + nonce[16:]


def seal(key: bytes, nonce: bytes, plaintext: bytes,
         additional_data: bytes = b"") -> bytes:
    """-> ciphertext || 16-byte tag (xchachapoly.go Seal)."""
    aead, n12 = _aead(key, nonce)
    return aead.encrypt(n12, plaintext, additional_data or None)


def open_(key: bytes, nonce: bytes, ciphertext: bytes,
          additional_data: bytes = b"") -> bytes:
    """Raises ValueError on authentication failure (xchachapoly.go Open)."""
    try:
        from cryptography.exceptions import InvalidTag
    except ImportError:
        from cometbft_tpu_torch.crypto.fallback import InvalidTag

    aead, n12 = _aead(key, nonce)
    if len(ciphertext) < TAG_SIZE:
        raise ValueError("xchacha20poly1305: ciphertext too short")
    try:
        return aead.decrypt(n12, ciphertext, additional_data or None)
    except InvalidTag as e:
        raise ValueError("xchacha20poly1305: message authentication failed") from e
