"""XSalsa20-Poly1305 symmetric encryption (NaCl secretbox format).

Reference: crypto/xsalsa20symmetric/symmetric.go:26-60 — EncryptSymmetric/
DecryptSymmetric over golang.org/x/crypto/nacl/secretbox, used for
passphrase-encrypted key export (secret = sha256(bcrypt(passphrase)) in the
callers). Wire format: nonce(24) || poly1305 tag(16) || ciphertext.

The Salsa20 core and HSalsa20 are implemented from the Salsa20
specification (checked against the eSTREAM vectors); Poly1305 uses the
`cryptography` package's constant-time primitive, keyed per the secretbox
construction (the first 32 keystream bytes of block 0).

The port's copy of cometbft_tpu/crypto/xsalsa20symmetric.py. Without
`cryptography`, Poly1305 is the port's crypto/fallback.poly1305_mac.
Nothing here touches a device.
"""

from __future__ import annotations

import os
import struct

NONCE_LEN = 24
SECRET_LEN = 32
TAG_LEN = 16

_SIGMA = (0x61707865, 0x3320646E, 0x79622D32, 0x6B206574)
_M32 = 0xFFFFFFFF


def _rotl32(v: int, n: int) -> int:
    return ((v << n) | (v >> (32 - n))) & _M32


def _salsa20_rounds(st: list[int]) -> list[int]:
    x = list(st)
    for _ in range(10):  # 20 rounds = 10 double-rounds
        # column round
        x[4] ^= _rotl32((x[0] + x[12]) & _M32, 7)
        x[8] ^= _rotl32((x[4] + x[0]) & _M32, 9)
        x[12] ^= _rotl32((x[8] + x[4]) & _M32, 13)
        x[0] ^= _rotl32((x[12] + x[8]) & _M32, 18)
        x[9] ^= _rotl32((x[5] + x[1]) & _M32, 7)
        x[13] ^= _rotl32((x[9] + x[5]) & _M32, 9)
        x[1] ^= _rotl32((x[13] + x[9]) & _M32, 13)
        x[5] ^= _rotl32((x[1] + x[13]) & _M32, 18)
        x[14] ^= _rotl32((x[10] + x[6]) & _M32, 7)
        x[2] ^= _rotl32((x[14] + x[10]) & _M32, 9)
        x[6] ^= _rotl32((x[2] + x[14]) & _M32, 13)
        x[10] ^= _rotl32((x[6] + x[2]) & _M32, 18)
        x[3] ^= _rotl32((x[15] + x[11]) & _M32, 7)
        x[7] ^= _rotl32((x[3] + x[15]) & _M32, 9)
        x[11] ^= _rotl32((x[7] + x[3]) & _M32, 13)
        x[15] ^= _rotl32((x[11] + x[7]) & _M32, 18)
        # row round
        x[1] ^= _rotl32((x[0] + x[3]) & _M32, 7)
        x[2] ^= _rotl32((x[1] + x[0]) & _M32, 9)
        x[3] ^= _rotl32((x[2] + x[1]) & _M32, 13)
        x[0] ^= _rotl32((x[3] + x[2]) & _M32, 18)
        x[6] ^= _rotl32((x[5] + x[4]) & _M32, 7)
        x[7] ^= _rotl32((x[6] + x[5]) & _M32, 9)
        x[4] ^= _rotl32((x[7] + x[6]) & _M32, 13)
        x[5] ^= _rotl32((x[4] + x[7]) & _M32, 18)
        x[11] ^= _rotl32((x[10] + x[9]) & _M32, 7)
        x[8] ^= _rotl32((x[11] + x[10]) & _M32, 9)
        x[9] ^= _rotl32((x[8] + x[11]) & _M32, 13)
        x[10] ^= _rotl32((x[9] + x[8]) & _M32, 18)
        x[12] ^= _rotl32((x[15] + x[14]) & _M32, 7)
        x[13] ^= _rotl32((x[12] + x[15]) & _M32, 9)
        x[14] ^= _rotl32((x[13] + x[12]) & _M32, 13)
        x[15] ^= _rotl32((x[14] + x[13]) & _M32, 18)
    return x


def _salsa20_block(key: bytes, nonce8: bytes, counter: int) -> bytes:
    k = struct.unpack("<8L", key)
    n = struct.unpack("<2L", nonce8)
    st = [
        _SIGMA[0], k[0], k[1], k[2],
        k[3], _SIGMA[1], n[0], n[1],
        counter & _M32, (counter >> 32) & _M32, _SIGMA[2], k[4],
        k[5], k[6], k[7], _SIGMA[3],
    ]
    x = _salsa20_rounds(st)
    return struct.pack("<16L", *((a + b) & _M32 for a, b in zip(x, st)))


def hsalsa20(key: bytes, nonce16: bytes) -> bytes:
    """32-byte subkey: Salsa20 rounds WITHOUT feed-forward; output words
    0, 5, 10, 15, 6, 7, 8, 9 (the NaCl XSalsa20 derivation)."""
    k = struct.unpack("<8L", key)
    n = struct.unpack("<4L", nonce16)
    st = [
        _SIGMA[0], k[0], k[1], k[2],
        k[3], _SIGMA[1], n[0], n[1],
        n[2], n[3], _SIGMA[2], k[4],
        k[5], k[6], k[7], _SIGMA[3],
    ]
    x = _salsa20_rounds(st)
    return struct.pack("<8L", *(x[i] for i in (0, 5, 10, 15, 6, 7, 8, 9)))


def _xsalsa20_xor(key: bytes, nonce24: bytes, data: bytes) -> tuple[bytes, bytes]:
    """-> (poly1305 one-time key, data ^ keystream[32:]) — the secretbox
    layout: keystream block 0's first 32 bytes key the MAC, the message
    starts at offset 32."""
    subkey = hsalsa20(key, nonce24[:16])
    nonce8 = nonce24[16:]
    block0 = _salsa20_block(subkey, nonce8, 0)
    poly_key = block0[:32]
    stream = bytearray(block0[32:])
    counter = 1
    while len(stream) < len(data):
        stream.extend(_salsa20_block(subkey, nonce8, counter))
        counter += 1
    out = bytes(d ^ stream[i] for i, d in enumerate(data))
    return poly_key, out


def _poly1305(key32: bytes, msg: bytes) -> bytes:
    try:
        from cryptography.hazmat.primitives import poly1305
    except ImportError:  # degraded: pure-Python MAC (crypto/fallback.py)
        from cometbft_tpu_torch.crypto.fallback import poly1305_mac

        return poly1305_mac(key32, msg)

    p = poly1305.Poly1305(key32)
    p.update(msg)
    return p.finalize()


def encrypt_symmetric(plaintext: bytes, secret: bytes) -> bytes:
    """nonce(24) || tag(16) || ciphertext — symmetric.go EncryptSymmetric
    (the nonce is random; the secret must be 32 bytes, e.g.
    sha256(bcrypt(passphrase)))."""
    if len(secret) != SECRET_LEN:
        raise ValueError(f"secret must be {SECRET_LEN} bytes, got {len(secret)}")
    nonce = os.urandom(NONCE_LEN)
    poly_key, ct = _xsalsa20_xor(secret, nonce, plaintext)
    tag = _poly1305(poly_key, ct)
    return nonce + tag + ct


def decrypt_symmetric(ciphertext: bytes, secret: bytes) -> bytes:
    """Raises ValueError on truncation or authentication failure
    (symmetric.go DecryptSymmetric error cases)."""
    if len(secret) != SECRET_LEN:
        raise ValueError(f"secret must be {SECRET_LEN} bytes, got {len(secret)}")
    if len(ciphertext) <= NONCE_LEN + TAG_LEN:
        raise ValueError("xsalsa20symmetric: ciphertext is too short")
    nonce = ciphertext[:NONCE_LEN]
    tag = ciphertext[NONCE_LEN:NONCE_LEN + TAG_LEN]
    ct = ciphertext[NONCE_LEN + TAG_LEN:]
    poly_key, pt = _xsalsa20_xor(secret, nonce, ct)
    import hmac as _hmac

    if not _hmac.compare_digest(_poly1305(poly_key, ct), tag):
        raise ValueError("xsalsa20symmetric: ciphertext decryption failed")
    return pt
