"""Batch-axis host hashing: N Keccak-f[1600] states under one permutation
call (the sr25519 staging transcript), N SHA-512 digests per call with their
reduction mod L (the ed25519 classic-path challenges), and the reassembly of
factored shared-prefix rows (libs/prefixrows.py) on the batch axis.

The port's copy of cometbft_tpu/ops/hashvec.py. Rungs, chosen per call by
``CBFT_HASHVEC``:

  native   8-lane SIMD C (native/hashvec.c, built at first use with cc into
           build/, ISA from /proc/cpuinfo): Keccak, SHA-512 of pre-padded
           same-block-count groups, and the Barrett reduction mod L;
  numpy    the batch-axis numpy cores below (all N rows through each round
           together), bit for bit equal;
  serial   per-row hashlib for SHA-512, also for groups under
           VEC_MIN_ROWS (ragged stragglers), and the numpy reduction;
  auto     (the default, and any unknown value) native when the library
           loads, else numpy for Keccak and the reduction and serial for
           SHA-512 (without the SIMD core, serial OpenSSL is the fastest
           correct SHA-512).

``CBFT_HASHVEC=native`` raises when the library does not load;
``active_rung()`` names the rung the next batch rides and ``stats()``
counts rows per core and rung. Every rung is bit for bit hashlib.sha512,
the serial Keccak of crypto/sr25519_math.py and int % L
(tests/test_torch_native.py, tests/test_torch_microbench.py).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import threading

import numpy as np

from cometbft_tpu_torch.crypto.ed25519_math import L as L_ED25519

# below this many rows a group takes the serial rung: per-row hash calls
# beat the batch call's overhead for a handful of stragglers
VEC_MIN_ROWS = 8

# ------------------------------------------------------------ native rung

_native_lock = threading.Lock()
_native_lib: list = []  # [lib or None] once tried


def _native():
    """The loaded native/hashvec.c library with its C signatures declared,
    or None when it does not build here (native.build_error says why).
    Built on first use, never at import."""
    if not _native_lib:
        with _native_lock:
            if not _native_lib:
                from cometbft_tpu_torch import native

                lib = native.load("hashvec", native.isa_cflags())
                if lib is not None:
                    lib.keccak_many.argtypes = [ctypes.c_void_p, ctypes.c_long]
                    lib.sha512_many.argtypes = [ctypes.c_void_p, ctypes.c_long,
                                                ctypes.c_long, ctypes.c_void_p]
                    lib.reduce512_mod_l_many.argtypes = [ctypes.c_void_p, ctypes.c_long,
                                                         ctypes.c_void_p]
                _native_lib.append(lib)
    return _native_lib[0]


def native_available() -> bool:
    """Does native/hashvec.c build and load on this host?"""
    return _native() is not None


_VALID_MODES = ("auto", "native", "numpy", "serial")


def _mode() -> str:
    m = os.environ.get("CBFT_HASHVEC", "auto")
    return m if m in _VALID_MODES else "auto"


def _use_native() -> bool:
    """Does this call take the native rung? Forced native without the
    library raises."""
    mode = _mode()
    if mode == "native":
        if _native() is None:
            from cometbft_tpu_torch import native

            raise RuntimeError("CBFT_HASHVEC=native but native/hashvec.c did not load: "
                               f"{native.build_error('hashvec')}")
        return True
    return mode == "auto" and _native() is not None


def active_rung() -> str:
    """The rung the next batch hash rides given CBFT_HASHVEC and what
    loaded: "native", "numpy" or "serial"."""
    mode = _mode()
    if mode in ("auto", "native"):
        return "native" if _use_native() else "numpy"
    return mode


_stats_lock = threading.Lock()
_stats: dict[str, int] = {}


def _count(core: str, rung: str, rows: int) -> None:
    with _stats_lock:
        key = f"{core}_{rung}_rows"
        _stats[key] = _stats.get(key, 0) + rows


def stats() -> dict[str, int]:
    """Rows hashed per core and rung since the last reset_stats()."""
    with _stats_lock:
        return dict(_stats)


def reset_stats() -> None:
    with _stats_lock:
        _stats.clear()


# ---------------------------------------------------------------- keccak
#
# State layout matches crypto/sr25519_math.keccak_f1600: lane i = x + 5*y,
# little-endian uint64 lanes, as an (N, 25) uint64 array (one row per
# independent sponge).

_KECCAK_RC = np.array([
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
], dtype=np.uint64)

_ROTC = [[0, 36, 3, 41, 18], [1, 44, 10, 45, 2], [62, 6, 43, 15, 61],
         [28, 55, 25, 21, 56], [27, 20, 39, 8, 14]]

# rho+pi fused as one gather + one vector rotate: out[j] = rotl(in[SRC[j]])
_PI_SRC = np.zeros(25, dtype=np.intp)
_RHO = np.zeros((25, 1), dtype=np.uint64)
for _x in range(5):
    for _y in range(5):
        _PI_SRC[_y + 5 * ((2 * _x + 3 * _y) % 5)] = _x + 5 * _y
        _RHO[_y + 5 * ((2 * _x + 3 * _y) % 5), 0] = _ROTC[_x][_y]
# (64 - r) & 63 keeps the r == 0 lane shift-safe: t<<0 | t>>0 == t
_RHO_INV = (np.uint64(64) - _RHO) & np.uint64(63)
_CHI1 = np.array([(i % 5 + 1) % 5 + 5 * (i // 5) for i in range(25)],
                 dtype=np.intp)
_CHI2 = np.array([(i % 5 + 2) % 5 + 5 * (i // 5) for i in range(25)],
                 dtype=np.intp)
_D_IDX = np.array([i % 5 for i in range(25)], dtype=np.intp)
_C_L = np.array([(x - 1) % 5 for x in range(5)], dtype=np.intp)
_C_R = np.array([(x + 1) % 5 for x in range(5)], dtype=np.intp)
_U1 = np.uint64(1)
_U63 = np.uint64(63)


def _keccak_batch_numpy(states: np.ndarray) -> None:
    """In-place Keccak-f[1600] over (N, 25) uint64 states (all N sponges
    advance under one permutation)."""
    a = states.T.copy()  # (25, N): lane-major for whole-lane vector ops
    for r in range(24):
        c = np.bitwise_xor.reduce(a.reshape(5, 5, -1), axis=0)  # theta: (5,N)
        cr = c[_C_R]
        d = c[_C_L] ^ ((cr << _U1) | (cr >> _U63))
        a ^= d[_D_IDX]
        t = a[_PI_SRC]  # rho + pi
        t = (t << _RHO) | (t >> _RHO_INV)
        a = t ^ (~t[_CHI1] & t[_CHI2])  # chi
        a[0] ^= _KECCAK_RC[r]  # iota
    states[:] = a.T


def keccak_f1600_many(states: np.ndarray) -> None:
    """Advance N independent Keccak-f[1600] states (one (N, 25) uint64
    array, modified in place) under one permutation call: native SIMD when
    the rung is native, else the numpy batch rung."""
    if states.dtype != np.uint64 or states.ndim != 2 or states.shape[1] != 25:
        raise ValueError("states must be an (N, 25) uint64 array")
    n = states.shape[0]
    if n == 0:
        return
    if _use_native():
        buf = np.ascontiguousarray(states)
        _native().keccak_many(buf.ctypes.data, n)
        if buf is not states:
            states[:] = buf
        _count("keccak", "native", n)
        return
    _keccak_batch_numpy(states)
    _count("keccak", "numpy", n)


# --------------------------------------------------------------- SHA-512 rung

_SHA_K = np.array([
    0x428a2f98d728ae22, 0x7137449123ef65cd, 0xb5c0fbcfec4d3b2f,
    0xe9b5dba58189dbbc, 0x3956c25bf348b538, 0x59f111f1b605d019,
    0x923f82a4af194f9b, 0xab1c5ed5da6d8118, 0xd807aa98a3030242,
    0x12835b0145706fbe, 0x243185be4ee4b28c, 0x550c7dc3d5ffb4e2,
    0x72be5d74f27b896f, 0x80deb1fe3b1696b1, 0x9bdc06a725c71235,
    0xc19bf174cf692694, 0xe49b69c19ef14ad2, 0xefbe4786384f25e3,
    0x0fc19dc68b8cd5b5, 0x240ca1cc77ac9c65, 0x2de92c6f592b0275,
    0x4a7484aa6ea6e483, 0x5cb0a9dcbd41fbd4, 0x76f988da831153b5,
    0x983e5152ee66dfab, 0xa831c66d2db43210, 0xb00327c898fb213f,
    0xbf597fc7beef0ee4, 0xc6e00bf33da88fc2, 0xd5a79147930aa725,
    0x06ca6351e003826f, 0x142929670a0e6e70, 0x27b70a8546d22ffc,
    0x2e1b21385c26c926, 0x4d2c6dfc5ac42aed, 0x53380d139d95b3df,
    0x650a73548baf63de, 0x766a0abb3c77b2a8, 0x81c2c92e47edaee6,
    0x92722c851482353b, 0xa2bfe8a14cf10364, 0xa81a664bbc423001,
    0xc24b8b70d0f89791, 0xc76c51a30654be30, 0xd192e819d6ef5218,
    0xd69906245565a910, 0xf40e35855771202a, 0x106aa07032bbd1b8,
    0x19a4c116b8d2d0c8, 0x1e376c085141ab53, 0x2748774cdf8eeb99,
    0x34b0bcb5e19b48a8, 0x391c0cb3c5c95a63, 0x4ed8aa4ae3418acb,
    0x5b9cca4f7763e373, 0x682e6ff3d6b2b8a3, 0x748f82ee5defb2fc,
    0x78a5636f43172f60, 0x84c87814a1f0ab72, 0x8cc702081a6439ec,
    0x90befffa23631e28, 0xa4506cebde82bde9, 0xbef9a3f7b2c67915,
    0xc67178f2e372532b, 0xca273eceea26619c, 0xd186b8c721c0c207,
    0xeada7dd6cde0eb1e, 0xf57d4f7fee6ed178, 0x06f067aa72176fba,
    0x0a637dc5a2c898a6, 0x113f9804bef90dae, 0x1b710b35131c471b,
    0x28db77f523047d84, 0x32caab7b40c72493, 0x3c9ebe0a15c9bebc,
    0x431d67c49c100d4c, 0x4cc5d4becb3e42b6, 0x597f299cfc657e2a,
    0x5fcb6fab3ad6faec, 0x6c44198c4a475817], dtype=np.uint64)

_SHA_H0 = np.array([
    0x6a09e667f3bcc908, 0xbb67ae8584caa73b, 0x3c6ef372fe94f82b,
    0xa54ff53a5f1d36f1, 0x510e527fade682d1, 0x9b05688c2b3e6c1f,
    0x1f83d9abfb41bd6b, 0x5be0cd19137e2179], dtype=np.uint64)


def _batch_sha512_active() -> bool:
    """Is a batch compression (native SIMD, or numpy when forced) in play?
    In auto mode without the native library, serial OpenSSL is the fastest
    correct SHA-512, so batch grouping is skipped."""
    mode = _mode()
    if mode == "numpy":
        return True
    if mode == "serial":
        return False
    return _use_native()


def _rotr(x: np.ndarray, n: int) -> np.ndarray:
    n = np.uint64(n)
    return (x >> n) | (x << (np.uint64(64) - n))


def _sha512_blocks_numpy(w_in: np.ndarray) -> np.ndarray:
    """(N, nb, 16) uint64 big-endian message words -> (N, 8) uint64 final
    state: the batch-axis compression (FIPS 180-4, all N messages through
    each round together)."""
    n, nb, _ = w_in.shape
    h = [np.full(n, _SHA_H0[i], dtype=np.uint64) for i in range(8)]
    for bi in range(nb):
        w = [w_in[:, bi, t].copy() for t in range(16)]
        a, b, c, d, e, f, g, hh = h
        for t in range(80):
            if t >= 16:
                w15 = w[(t - 15) % 16]
                w2 = w[(t - 2) % 16]
                s0 = _rotr(w15, 1) ^ _rotr(w15, 8) ^ (w15 >> np.uint64(7))
                s1 = _rotr(w2, 19) ^ _rotr(w2, 61) ^ (w2 >> np.uint64(6))
                w[t % 16] = w[t % 16] + s0 + w[(t - 7) % 16] + s1
            s1e = _rotr(e, 14) ^ _rotr(e, 18) ^ _rotr(e, 41)
            ch = g ^ (e & (f ^ g))
            t1 = hh + s1e + ch + _SHA_K[t] + w[t % 16]
            s0a = _rotr(a, 28) ^ _rotr(a, 34) ^ _rotr(a, 39)
            mj = (a & (b | c)) | (b & c)
            t2 = s0a + mj
            hh, g, f, e = g, f, e, d + t1
            d, c, b, a = c, b, a, t1 + t2
        h = [h[0] + a, h[1] + b, h[2] + c, h[3] + d,
             h[4] + e, h[5] + f, h[6] + g, h[7] + hh]
    return np.stack(h, axis=1)


def _sha512_pad(rows: np.ndarray) -> tuple[np.ndarray, int]:
    """(N, L) uint8 same-length messages -> ((N, nb*128) padded buffer,
    nb): FIPS 180-4 padding across the batch."""
    n, ln = rows.shape
    nb = (ln + 17 + 127) // 128
    buf = np.zeros((n, nb * 128), dtype=np.uint8)
    buf[:, :ln] = rows
    buf[:, ln] = 0x80
    buf[:, -16:] = np.frombuffer((ln * 8).to_bytes(16, "big"), dtype=np.uint8)
    return buf, nb


def _sha512_compress(buf: np.ndarray, nb: int) -> np.ndarray:
    """Padded (N, nb*128) buffer -> (N, 64) uint8 digests through a batch
    rung: native unless numpy is forced."""
    n = buf.shape[0]
    if _mode() != "numpy" and _use_native():
        buf = np.ascontiguousarray(buf)
        out = np.empty((n, 64), dtype=np.uint8)
        _native().sha512_many(buf.ctypes.data, n, nb, out.ctypes.data)
        _count("sha512", "native", n)
        return out
    w = buf.reshape(n, nb, 16, 8).view(">u8")[..., 0].astype(np.uint64)
    h = _sha512_blocks_numpy(w)
    _count("sha512", "numpy", n)
    return np.ascontiguousarray(h).astype(">u8").view(np.uint8).reshape(n, 64)


def _sha512_serial(datas, out: np.ndarray, idxs) -> None:
    for i in idxs:
        out[i] = np.frombuffer(hashlib.sha512(datas[i]).digest(), dtype=np.uint8)
    _count("sha512", "serial", len(idxs))


def sha512_rows(rows: np.ndarray) -> np.ndarray:
    """(N, L) uint8 same-length messages -> (N, 64) uint8 digests,
    bit-for-bit hashlib.sha512: the uniform-length entry of the staging
    paths (a commit's sign-bytes share one length)."""
    n = rows.shape[0]
    if n == 0:
        return np.zeros((0, 64), dtype=np.uint8)
    if not _batch_sha512_active() or n < VEC_MIN_ROWS:
        out = np.empty((n, 64), dtype=np.uint8)
        _sha512_serial([r.tobytes() for r in rows], out, range(n))
        return out
    return _sha512_compress(*_sha512_pad(rows))


def sha512_many(datas: list[bytes]) -> np.ndarray:
    """N messages of any lengths -> (N, 64) uint8 digests. Rows group by
    padded block count and each group compresses in one batch call; groups
    below VEC_MIN_ROWS take the serial rung."""
    n = len(datas)
    out = np.empty((n, 64), dtype=np.uint8)
    if n == 0:
        return out
    if not _batch_sha512_active():
        _sha512_serial(datas, out, range(n))
        return out
    lens = set(map(len, datas))
    if len(lens) == 1:  # the dominant commit shape: no per-row grouping
        ln = lens.pop()
        return sha512_rows(np.frombuffer(b"".join(datas), dtype=np.uint8).reshape(n, ln))
    by_nb: dict[int, dict[int, list[int]]] = {}
    for i, d in enumerate(datas):
        by_nb.setdefault((len(d) + 17 + 127) // 128, {}).setdefault(len(d), []).append(i)
    for nb, by_len in by_nb.items():
        if sum(len(v) for v in by_len.values()) < VEC_MIN_ROWS:
            for idxs in by_len.values():
                _sha512_serial(datas, out, idxs)
            continue
        bufs, order = [], []
        for ln, idxs in by_len.items():
            flat = np.frombuffer(b"".join(datas[i] for i in idxs), dtype=np.uint8)
            bufs.append(_sha512_pad(flat.reshape(len(idxs), ln))[0])
            order.extend(idxs)
        out[np.asarray(order, dtype=np.intp)] = _sha512_compress(np.concatenate(bufs), nb)
    return out


# --------------------------------------------------- Barrett reduction mod L
#
# k = digest mod L for N 512-bit little-endian digests at once, as the
# packed (N, 8) uint32 little-endian words the kernels take. The numpy rung
# works in base-2^16 limbs in uint64 (products < 2^32, 17-term sums
# < 2^37): HAC Algorithm 14.42 with k = 16 limbs, q3 = floor(floor(x /
# b^15) * mu / b^17), r = x - q3*L mod b^17, then at most two conditional
# subtractions of L. The native rung is the same algorithm in 64-bit limbs.

_BARRETT_MU = (1 << 512) // L_ED25519  # 261 bits -> 17 base-2^16 limbs


def _to_limbs16(x: int, n: int) -> np.ndarray:
    return np.array([(x >> (16 * i)) & 0xFFFF for i in range(n)], dtype=np.uint64)


_MU17 = _to_limbs16(_BARRETT_MU, 17)
_L17 = _to_limbs16(L_ED25519, 17)
_U16MASK = np.uint64(0xFFFF)
_U16 = np.uint64(16)
_U63SIGN = np.uint64(63)


def _carry16(acc: np.ndarray) -> np.ndarray:
    """Propagate base-2^16 carries along the limb axis of a limb-major
    (limbs, N) accumulator; overflow off the top limb is dropped."""
    c = np.zeros(acc.shape[1], dtype=np.uint64)
    for j in range(acc.shape[0]):
        t = acc[j] + c
        acc[j] = t & _U16MASK
        c = t >> _U16
    return acc


def _reduce512_mod_l_numpy(digests: np.ndarray) -> np.ndarray:
    """The batch-axis numpy Barrett rung (limb-major (17, N) layout)."""
    n = digests.shape[0]
    x = np.ascontiguousarray(digests).view("<u2").astype(np.uint64).T  # (32, N)
    q1 = x[15:]  # floor(x / b^15): 17 limbs
    q2 = np.zeros((34, n), dtype=np.uint64)
    for i in range(17):
        q2[i:i + 17] += q1 * _MU17[i]
    _carry16(q2)
    q3 = q2[17:]  # floor(q2 / b^17): 17 limbs
    r2 = np.zeros((17, n), dtype=np.uint64)  # q3*L mod b^17
    for i in range(17):
        if _L17[i]:
            r2[i:] += q3[:17 - i] * _L17[i]
    _carry16(r2)
    # r = x - r2 mod b^17; the uint64 sign bit flags a wrapped limb
    r = np.zeros((17, n), dtype=np.uint64)
    borrow = np.zeros(n, dtype=np.uint64)
    for j in range(17):
        t = x[j] - r2[j] - borrow
        r[j] = t & _U16MASK
        borrow = t >> _U63SIGN
    for _ in range(2):  # r < 3L: at most two conditional subtractions
        t = np.zeros_like(r)
        borrow = np.zeros(n, dtype=np.uint64)
        for j in range(17):
            d = r[j] - _L17[j] - borrow
            t[j] = d & _U16MASK
            borrow = d >> _U63SIGN
        ge = borrow == 0
        r[:, ge] = t[:, ge]
    return np.ascontiguousarray(r[:16].T.astype(np.uint16)).view("<u4").reshape(n, 8)


def reduce512_mod_l(digests: np.ndarray) -> np.ndarray:
    """(N, 64) uint8 little-endian 512-bit values -> (N, 8) uint32
    little-endian words of (value mod L), the ed25519 group order: native
    Barrett unless numpy or serial is forced, else the numpy Barrett, bit
    for bit equal."""
    n = digests.shape[0]
    if n == 0:
        return np.zeros((0, 8), dtype=np.uint32)
    if _mode() in ("auto", "native") and _use_native():
        buf = np.ascontiguousarray(digests, dtype=np.uint8)
        out = np.empty((n, 8), dtype=np.uint32)
        _native().reduce512_mod_l_many(buf.ctypes.data, n, out.ctypes.data)
        return out
    return _reduce512_mod_l_numpy(digests)


def sha512_mod_l_words(datas: list[bytes]) -> np.ndarray:
    """SHA-512 digests reduced mod L as packed device words: the ed25519
    challenge pipeline (hash, wide reduction, wire words) in two calls."""
    return reduce512_mod_l(sha512_many(datas))


# ---------------------------------------------------- shared-prefix rows


def assemble_prefixed_rows(msgs, mlen: int) -> np.ndarray:
    """Uniform-length messages -> an (N, mlen) uint8 matrix on the batch
    axis. Runs of PrefixedMsg rows sharing the same prefix object write the
    prefix once as a broadcast column block and join only their suffixes;
    plain bytes rows join as they are (libs/prefixrows.py)."""
    from cometbft_tpu_torch.libs.prefixrows import PrefixedMsg

    n = len(msgs)
    out = np.empty((n, mlen), dtype=np.uint8)
    i = 0
    while i < n:
        m = msgs[i]
        j = i
        if isinstance(m, PrefixedMsg):
            p = m.prefix
            while j < n and isinstance(msgs[j], PrefixedMsg) and msgs[j].prefix is p:
                j += 1
            out[i:j, :len(p)] = np.frombuffer(p, dtype=np.uint8)
            sfx = b"".join(msgs[k].suffix for k in range(i, j))
            out[i:j, len(p):] = np.frombuffer(sfx, dtype=np.uint8).reshape(j - i, mlen - len(p))
        else:
            while j < n and not isinstance(msgs[j], PrefixedMsg):
                j += 1
            out[i:j] = np.frombuffer(b"".join(msgs[i:j]), dtype=np.uint8).reshape(j - i, mlen)
        i = j
    return out


def sha256_many(datas: list[bytes]) -> np.ndarray:
    """N messages -> (N, 32) uint8 digests, bit for bit hashlib.sha256 (the
    BLS hash-to-field's expand_message_xmd; one call per round across a
    batch), counted as the "sha256" core's serial rung."""
    n = len(datas)
    out = np.empty((n, 32), dtype=np.uint8)
    for i, d in enumerate(datas):
        out[i] = np.frombuffer(hashlib.sha256(d).digest(), dtype=np.uint8)
    if n:
        _count("sha256", "serial", n)
    return out
