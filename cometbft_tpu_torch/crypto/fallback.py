"""Python stand-ins for the OpenSSL-backed AEAD and X25519.

The port's copy of the ChaCha20-Poly1305 (RFC 8439) and X25519 (RFC 7748)
part of cometbft_tpu/crypto/fallback.py. The p2p secret connection
(p2p/conn/secret_connection.py) takes the `cryptography` package when it
imports, else libcrypto through ctypes (crypto/_libcrypto.py), else this
module's numpy/Python rung; all three give the same bytes. `native=False`
forces the Python rung.
"""

from __future__ import annotations

import hmac as _hmac
import struct

# ---------------------------------------------------------------------------
# ChaCha20 (RFC 8439 §2.3)
# ---------------------------------------------------------------------------

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


def _chacha20_block(key: bytes, counter: int, nonce12: bytes) -> bytes:
    st = (list(_SIGMA) + list(struct.unpack("<8L", key)) + [counter & _M32]
          + list(struct.unpack("<3L", nonce12)))
    ws = list(st)
    for _ in range(10):
        _quarter(ws, 0, 4, 8, 12)
        _quarter(ws, 1, 5, 9, 13)
        _quarter(ws, 2, 6, 10, 14)
        _quarter(ws, 3, 7, 11, 15)
        _quarter(ws, 0, 5, 10, 15)
        _quarter(ws, 1, 6, 11, 12)
        _quarter(ws, 2, 7, 8, 13)
        _quarter(ws, 3, 4, 9, 14)
    return struct.pack("<16L", *((w + s) & _M32 for w, s in zip(ws, st)))


def _chacha20_keystream_np(key: bytes, counter: int, nonce12: bytes,
                           nblocks: int) -> bytes:
    """All `nblocks` 64-byte keystream blocks at once, quarter rounds
    vectorized over the counter axis with numpy uint32 — the p2p secret
    connection pushes every wire byte through this, so the per-byte Python
    loop of the naive version is not an option."""
    import numpy as np

    st = np.empty((16, nblocks), dtype=np.uint32)
    st[0:4, :] = np.array(_SIGMA, dtype=np.uint32)[:, None]
    st[4:12, :] = np.frombuffer(key, dtype="<u4").astype(np.uint32)[:, None]
    st[12, :] = (np.arange(counter, counter + nblocks, dtype=np.uint64)
                 & 0xFFFFFFFF).astype(np.uint32)
    st[13:16, :] = np.frombuffer(nonce12, dtype="<u4").astype(
        np.uint32)[:, None]
    ws = st.copy()

    def rotl(v, n):
        return (v << np.uint32(n)) | (v >> np.uint32(32 - n))

    def quarter(a, b, c, d):
        ws[a] += ws[b]
        ws[d] = rotl(ws[d] ^ ws[a], 16)
        ws[c] += ws[d]
        ws[b] = rotl(ws[b] ^ ws[c], 12)
        ws[a] += ws[b]
        ws[d] = rotl(ws[d] ^ ws[a], 8)
        ws[c] += ws[d]
        ws[b] = rotl(ws[b] ^ ws[c], 7)

    with np.errstate(over="ignore"):
        for _ in range(10):
            quarter(0, 4, 8, 12)
            quarter(1, 5, 9, 13)
            quarter(2, 6, 10, 14)
            quarter(3, 7, 11, 15)
            quarter(0, 5, 10, 15)
            quarter(1, 6, 11, 12)
            quarter(2, 7, 8, 13)
            quarter(3, 4, 9, 14)
        ws += st
    # (16, N) words -> per-block little-endian byte serialization
    return ws.T.astype("<u4").tobytes()


def chacha20_xor(key: bytes, nonce12: bytes, data: bytes,
                 counter: int = 1) -> bytes:
    import numpy as np

    n = len(data)
    if n == 0:
        return b""
    nblocks = (n + 63) // 64
    stream = _chacha20_keystream_np(key, counter, nonce12, nblocks)
    buf = np.frombuffer(data, dtype=np.uint8)
    ks = np.frombuffer(stream, dtype=np.uint8)[:n]
    return (buf ^ ks).tobytes()


# ---------------------------------------------------------------------------
# Poly1305 (RFC 8439 §2.5)
# ---------------------------------------------------------------------------

_P1305 = (1 << 130) - 5
_RMASK = 0x0FFFFFFC0FFFFFFC0FFFFFFC0FFFFFFF


def poly1305_mac(key32: bytes, msg: bytes) -> bytes:
    r = int.from_bytes(key32[:16], "little") & _RMASK
    s = int.from_bytes(key32[16:32], "little")
    acc = 0
    for i in range(0, len(msg), 16):
        chunk = msg[i:i + 16]
        n = int.from_bytes(chunk, "little") + (1 << (8 * len(chunk)))
        acc = ((acc + n) * r) % _P1305
    return ((acc + s) & ((1 << 128) - 1)).to_bytes(16, "little")


class ChaCha20Poly1305:
    """RFC 8439 AEAD, API-compatible with
    cryptography.hazmat.primitives.ciphers.aead.ChaCha20Poly1305. Uses the
    process libcrypto via ctypes when present and `native` is not False
    (crypto/_libcrypto.py: the p2p frame path is throughput-critical);
    numpy/Python otherwise."""

    def __init__(self, key: bytes, native: bool | None = None):
        if len(key) != 32:
            raise ValueError("ChaCha20Poly1305 key must be 32 bytes")
        self._key = bytes(key)
        from cometbft_tpu_torch.crypto import _libcrypto

        use = _libcrypto.available() if native is None else native
        self._native = _libcrypto if use else None

    def _tag(self, nonce: bytes, ct: bytes, aad: bytes) -> bytes:
        poly_key = _chacha20_block(self._key, 0, nonce)[:32]
        mac_data = (aad + b"\x00" * (-len(aad) % 16)
                    + ct + b"\x00" * (-len(ct) % 16)
                    + struct.pack("<QQ", len(aad), len(ct)))
        return poly1305_mac(poly_key, mac_data)

    def encrypt(self, nonce: bytes, data: bytes, aad: bytes | None) -> bytes:
        if len(nonce) != 12:
            raise ValueError("nonce must be 12 bytes")
        aad = aad or b""
        if self._native is not None:
            return self._native.aead_seal(self._key, nonce, data, aad)
        ct = chacha20_xor(self._key, nonce, data)
        return ct + self._tag(nonce, ct, aad)

    def decrypt(self, nonce: bytes, data: bytes, aad: bytes | None) -> bytes:
        if len(nonce) != 12:
            raise ValueError("nonce must be 12 bytes")
        if len(data) < 16:
            raise InvalidTag("ciphertext too short")
        aad = aad or b""
        if self._native is not None:
            try:
                return self._native.aead_open(self._key, nonce, data, aad)
            except ValueError as e:
                raise InvalidTag(str(e)) from None
        ct, tag = data[:-16], data[-16:]
        if not _hmac.compare_digest(self._tag(nonce, ct, aad), tag):
            raise InvalidTag("poly1305 tag mismatch")
        return chacha20_xor(self._key, nonce, ct)


class InvalidTag(Exception):
    """Mirror of cryptography.exceptions.InvalidTag for gated imports."""


# ---------------------------------------------------------------------------
# X25519 (RFC 7748 §5)
# ---------------------------------------------------------------------------

_P255 = 2**255 - 19
_A24 = 121665


def _x25519_ladder(k: int, u: int) -> int:
    x1, x2, z2, x3, z3 = u, 1, 0, u, 1
    swap = 0
    for t in range(254, -1, -1):
        k_t = (k >> t) & 1
        if swap ^ k_t:
            x2, x3 = x3, x2
            z2, z3 = z3, z2
        swap = k_t
        a = (x2 + z2) % _P255
        aa = a * a % _P255
        b = (x2 - z2) % _P255
        bb = b * b % _P255
        e = (aa - bb) % _P255
        c = (x3 + z3) % _P255
        d = (x3 - z3) % _P255
        da = d * a % _P255
        cb = c * b % _P255
        x3 = (da + cb) % _P255
        x3 = x3 * x3 % _P255
        z3 = (da - cb) % _P255
        z3 = z3 * z3 % _P255
        z3 = z3 * x1 % _P255
        x2 = aa * bb % _P255
        z2 = e * (aa + _A24 * e) % _P255
    if swap:
        x2, x3 = x3, x2
        z2, z3 = z3, z2
    return x2 * pow(z2, _P255 - 2, _P255) % _P255


def x25519(scalar: bytes, u_bytes: bytes, native: bool | None = None) -> bytes:
    """RFC 7748 X25519(k, u) with standard clamping. libcrypto when present
    and `native` is not False; the Python Montgomery ladder otherwise."""
    from cometbft_tpu_torch.crypto import _libcrypto

    if native is None:
        native = _libcrypto.available()
    if native:
        return _libcrypto.x25519(scalar, u_bytes)
    k = int.from_bytes(scalar, "little")
    k &= ~(7 | (1 << 255))
    k |= 1 << 254
    u = int.from_bytes(u_bytes, "little") & ((1 << 255) - 1)
    out = _x25519_ladder(k, u)
    if out == 0:
        raise ValueError("x25519: low-order point (all-zero shared secret)")
    return out.to_bytes(32, "little")


X25519_BASEPOINT = (9).to_bytes(32, "little")
