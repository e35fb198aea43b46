"""ctypes bindings to the process's libcrypto (OpenSSL >= 1.1.1): the
ChaCha20-Poly1305 AEAD and X25519 that the p2p secret connection needs.

The port's copy of the AEAD and X25519 entry points of
cometbft_tpu/crypto/_libcrypto.py. It is the middle rung of the secret
connection's cipher (p2p/conn/secret_connection.py): the `cryptography`
package when it imports, else libcrypto through this module, else the
numpy/Python copy in crypto/fallback.py. Hosts without `cryptography`
almost always still carry libcrypto, since CPython's own `ssl` module links
it, and every wire byte goes through the AEAD.

`available()` is False when libcrypto or any symbol this module uses is
missing; callers then take the Python rung.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import threading

_EVP_CTRL_AEAD_SET_IVLEN = 0x9
_EVP_CTRL_AEAD_GET_TAG = 0x10
_EVP_CTRL_AEAD_SET_TAG = 0x11
_EVP_PKEY_X25519 = 1034

_lib = None
_lib_lock = threading.Lock()
_checked = False


def _load():
    global _lib, _checked
    if _checked:
        return _lib
    with _lib_lock:
        if _checked:
            return _lib
        try:
            name = ctypes.util.find_library("crypto") or "libcrypto.so"
            lib = ctypes.CDLL(name)
            # the full symbol surface this module uses; AttributeError on
            # any -> no libcrypto backend
            lib.EVP_CIPHER_CTX_new.restype = ctypes.c_void_p
            lib.EVP_CIPHER_CTX_free.argtypes = [ctypes.c_void_p]
            lib.EVP_chacha20_poly1305.restype = ctypes.c_void_p
            for fn in ("EVP_EncryptInit_ex", "EVP_DecryptInit_ex"):
                getattr(lib, fn).argtypes = [
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_char_p, ctypes.c_char_p]
            for fn in ("EVP_EncryptUpdate", "EVP_DecryptUpdate"):
                getattr(lib, fn).argtypes = [
                    ctypes.c_void_p, ctypes.c_char_p,
                    ctypes.POINTER(ctypes.c_int), ctypes.c_char_p,
                    ctypes.c_int]
            lib.EVP_EncryptFinal_ex.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_int)]
            lib.EVP_DecryptFinal_ex.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_int)]
            lib.EVP_CIPHER_CTX_ctrl.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
            lib.EVP_PKEY_new_raw_private_key.restype = ctypes.c_void_p
            lib.EVP_PKEY_new_raw_private_key.argtypes = [
                ctypes.c_int, ctypes.c_void_p, ctypes.c_char_p,
                ctypes.c_size_t]
            lib.EVP_PKEY_new_raw_public_key.restype = ctypes.c_void_p
            lib.EVP_PKEY_new_raw_public_key.argtypes = [
                ctypes.c_int, ctypes.c_void_p, ctypes.c_char_p,
                ctypes.c_size_t]
            lib.EVP_PKEY_get_raw_public_key.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_size_t)]
            lib.EVP_PKEY_free.argtypes = [ctypes.c_void_p]
            lib.EVP_PKEY_CTX_new.restype = ctypes.c_void_p
            lib.EVP_PKEY_CTX_new.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
            lib.EVP_PKEY_CTX_free.argtypes = [ctypes.c_void_p]
            lib.EVP_PKEY_derive_init.argtypes = [ctypes.c_void_p]
            lib.EVP_PKEY_derive_set_peer.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p]
            lib.EVP_PKEY_derive.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_size_t)]
            _lib = lib
        except (OSError, AttributeError):
            _lib = None
        _checked = True
        return _lib


def available() -> bool:
    return _load() is not None


# ------------------------------------------------------------------- AEAD


def aead_seal(key: bytes, nonce12: bytes, data: bytes, aad: bytes) -> bytes:
    """ChaCha20-Poly1305 seal -> ciphertext || 16-byte tag."""
    lib = _load()
    ctx = lib.EVP_CIPHER_CTX_new()
    try:
        outl = ctypes.c_int(0)
        if not lib.EVP_EncryptInit_ex(
                ctx, lib.EVP_chacha20_poly1305(), None, None, None):
            raise RuntimeError("EVP init failed")
        lib.EVP_CIPHER_CTX_ctrl(ctx, _EVP_CTRL_AEAD_SET_IVLEN, 12, None)
        if not lib.EVP_EncryptInit_ex(ctx, None, None, key, nonce12):
            raise RuntimeError("EVP key/iv init failed")
        if aad:
            lib.EVP_EncryptUpdate(ctx, None, ctypes.byref(outl), aad, len(aad))
        out = ctypes.create_string_buffer(len(data) + 16)
        n = 0
        if data:
            lib.EVP_EncryptUpdate(ctx, out, ctypes.byref(outl), data, len(data))
            n = outl.value
        fin = ctypes.create_string_buffer(16)
        lib.EVP_EncryptFinal_ex(ctx, fin, ctypes.byref(outl))
        tag = ctypes.create_string_buffer(16)
        lib.EVP_CIPHER_CTX_ctrl(ctx, _EVP_CTRL_AEAD_GET_TAG, 16, tag)
        return out.raw[:n] + tag.raw
    finally:
        lib.EVP_CIPHER_CTX_free(ctx)


def aead_open(key: bytes, nonce12: bytes, data: bytes, aad: bytes) -> bytes:
    """ChaCha20-Poly1305 open; raises ValueError on a bad tag."""
    lib = _load()
    if len(data) < 16:
        raise ValueError("ciphertext too short")
    ct, tag = data[:-16], data[-16:]
    ctx = lib.EVP_CIPHER_CTX_new()
    try:
        outl = ctypes.c_int(0)
        if not lib.EVP_DecryptInit_ex(
                ctx, lib.EVP_chacha20_poly1305(), None, None, None):
            raise RuntimeError("EVP init failed")
        lib.EVP_CIPHER_CTX_ctrl(ctx, _EVP_CTRL_AEAD_SET_IVLEN, 12, None)
        if not lib.EVP_DecryptInit_ex(ctx, None, None, key, nonce12):
            raise RuntimeError("EVP key/iv init failed")
        if aad:
            lib.EVP_DecryptUpdate(ctx, None, ctypes.byref(outl), aad, len(aad))
        out = ctypes.create_string_buffer(max(1, len(ct)))
        n = 0
        if ct:
            lib.EVP_DecryptUpdate(ctx, out, ctypes.byref(outl), ct, len(ct))
            n = outl.value
        tag_buf = ctypes.create_string_buffer(tag, 16)
        lib.EVP_CIPHER_CTX_ctrl(ctx, _EVP_CTRL_AEAD_SET_TAG, 16, tag_buf)
        fin = ctypes.create_string_buffer(16)
        if lib.EVP_DecryptFinal_ex(ctx, fin, ctypes.byref(outl)) <= 0:
            raise ValueError("chacha20poly1305: tag mismatch")
        return out.raw[:n]
    finally:
        lib.EVP_CIPHER_CTX_free(ctx)


# ----------------------------------------------------------------- x25519


def x25519_pub(scalar: bytes) -> bytes:
    lib = _load()
    pkey = lib.EVP_PKEY_new_raw_private_key(
        _EVP_PKEY_X25519, None, scalar, 32)
    if not pkey:
        raise ValueError("bad x25519 scalar")
    try:
        buf = ctypes.create_string_buffer(32)
        ln = ctypes.c_size_t(32)
        if not lib.EVP_PKEY_get_raw_public_key(pkey, buf, ctypes.byref(ln)):
            raise RuntimeError("raw public key extraction failed")
        return buf.raw[:ln.value]
    finally:
        lib.EVP_PKEY_free(pkey)


def x25519(scalar: bytes, point: bytes) -> bytes:
    """X25519(k, u); raises ValueError on the all-zero shared secret (the
    same contract as cryptography's exchange())."""
    lib = _load()
    pkey = lib.EVP_PKEY_new_raw_private_key(
        _EVP_PKEY_X25519, None, scalar, 32)
    peer = lib.EVP_PKEY_new_raw_public_key(_EVP_PKEY_X25519, None, point, 32)
    if not pkey or not peer:
        for p in (pkey, peer):
            if p:
                lib.EVP_PKEY_free(p)
        raise ValueError("bad x25519 key material")
    ctx = lib.EVP_PKEY_CTX_new(pkey, None)
    try:
        if (lib.EVP_PKEY_derive_init(ctx) <= 0
                or lib.EVP_PKEY_derive_set_peer(ctx, peer) <= 0):
            raise ValueError("x25519 derive init failed")
        out = ctypes.create_string_buffer(32)
        ln = ctypes.c_size_t(32)
        if lib.EVP_PKEY_derive(ctx, out, ctypes.byref(ln)) <= 0:
            raise ValueError("x25519: derive failed (low-order point)")
        return out.raw[:ln.value]
    finally:
        lib.EVP_PKEY_CTX_free(ctx)
        lib.EVP_PKEY_free(peer)
        lib.EVP_PKEY_free(pkey)
