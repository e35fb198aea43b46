"""sr25519 (schnorrkel) host oracle: ristretto255 group, Merlin transcripts
(STROBE-128 over Keccak-f[1600]), signing context, sign/verify.

The port's own copy of cometbft_tpu/crypto/sr25519_math.py. The Strobe128
class here is pure Python (the oracle's transcript). The batch challenges
ride two rungs: groups of VEC_MIN_ROWS or more rows of one message length
advance as a batch transcript (BatchStrobe128: N sponges under one
Keccak-f[1600] call of ops/hashvec.py, the native SIMD core when it loads);
smaller groups, and every group under CBFT_HASHVEC=serial, take the serial
rung, the native strobe.c sr25519_batch_challenge over chunks of rows on
threads (serial_rung() says "native"), else the Python transcript. All
agree byte for byte.

  sign:  t = SigningContext("")          (merlin transcript "SigningContext"
                                          + appended context bytes)
         t.append_message("sign-bytes", msg)
         t.proto_name("Schnorr-sig"); append pk, R
         k = t.challenge_scalar("sign:c")   (64-byte wide reduction mod L)
         s = k*secret + r  mod L
         signature = R_ristretto(32) || s(32) with bit 255 SET (the
         schnorrkel marker, cleared before use)

  verify: recompute k, accept iff  [4](sB - kA - R) == identity  — the
         cofactor-4 coset check IS ristretto equality (two edwards points
         encode to the same ristretto string iff they differ by E[4]).

Field and curve arithmetic reuse the ed25519 oracle (the same edwards25519
curve under the ristretto quotient). Python bignums and a pure-Python
Keccak cost milliseconds per verification: this is a reference, not a
production path.
"""

from __future__ import annotations

import concurrent.futures
import copy
import ctypes
import hashlib
import os
import secrets as _secrets
import threading

import numpy as np

from cometbft_tpu_torch.crypto import ed25519_math as ed
from cometbft_tpu_torch.ops import hashvec

P = ed.P
L = ed.L
D = ed.D

# ---------------------------------------------------------------------------
# Keccak-f[1600]
# ---------------------------------------------------------------------------

_KECCAK_RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A, 0x8000000080008000,
    0x000000000000808B, 0x0000000080000001, 0x8000000080008081, 0x8000000000008009,
    0x000000000000008A, 0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089, 0x8000000000008003,
    0x8000000000008002, 0x8000000000000080, 0x000000000000800A, 0x800000008000000A,
    0x8000000080008081, 0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]
_ROTC = [
    [0, 36, 3, 41, 18],
    [1, 44, 10, 45, 2],
    [62, 6, 43, 15, 61],
    [28, 55, 25, 21, 56],
    [27, 20, 39, 8, 14],
]
_M64 = (1 << 64) - 1


def _rotl(x: int, n: int) -> int:
    n %= 64
    return ((x << n) | (x >> (64 - n))) & _M64


def keccak_f1600(state: bytearray) -> None:
    """In-place permutation of the 200-byte state."""
    a = [[int.from_bytes(state[8 * (x + 5 * y): 8 * (x + 5 * y) + 8], "little")
          for y in range(5)] for x in range(5)]
    for rc in _KECCAK_RC:
        # theta
        c = [a[x][0] ^ a[x][1] ^ a[x][2] ^ a[x][3] ^ a[x][4] for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rotl(c[(x + 1) % 5], 1) for x in range(5)]
        for x in range(5):
            for y in range(5):
                a[x][y] ^= d[x]
        # rho + pi
        b = [[0] * 5 for _ in range(5)]
        for x in range(5):
            for y in range(5):
                b[y][(2 * x + 3 * y) % 5] = _rotl(a[x][y], _ROTC[x][y])
        # chi
        for x in range(5):
            for y in range(5):
                a[x][y] = b[x][y] ^ ((~b[(x + 1) % 5][y]) & b[(x + 2) % 5][y] & _M64)
        # iota
        a[0][0] ^= rc
    for x in range(5):
        for y in range(5):
            state[8 * (x + 5 * y): 8 * (x + 5 * y) + 8] = a[x][y].to_bytes(8, "little")


# ---------------------------------------------------------------------------
# STROBE-128 (the subset merlin uses: meta-AD, AD, PRF, KEY), per the STROBE
# v1.0.2 spec and merlin's strobe128.rs.
# ---------------------------------------------------------------------------

_STROBE_R = 166  # 1600/8 - (2*128)/8 - 2

_FLAG_I = 1
_FLAG_A = 1 << 1
_FLAG_C = 1 << 2
_FLAG_T = 1 << 3
_FLAG_M = 1 << 4
_FLAG_K = 1 << 5

_STROBE_SEED = b"\x01" + bytes([_STROBE_R + 2]) + b"\x01\x00\x01\x60" + b"STROBEv1.0.2"


class Strobe128:
    def __init__(self, protocol_label: bytes):
        self.state = bytearray(200)
        self.state[: len(_STROBE_SEED)] = _STROBE_SEED
        keccak_f1600(self.state)
        self.pos = 0
        self.pos_begin = 0
        self.cur_flags = 0
        self.meta_ad(protocol_label, False)

    # --- duplex plumbing (merlin strobe128.rs)

    def _run_f(self) -> None:
        self.state[self.pos] ^= self.pos_begin
        self.state[self.pos + 1] ^= 0x04
        self.state[_STROBE_R + 1] ^= 0x80
        keccak_f1600(self.state)
        self.pos = 0
        self.pos_begin = 0

    def _absorb(self, data: bytes) -> None:
        for byte in data:
            self.state[self.pos] ^= byte
            self.pos += 1
            if self.pos == _STROBE_R:
                self._run_f()

    def _squeeze(self, n: int) -> bytes:
        out = bytearray()
        for _ in range(n):
            out.append(self.state[self.pos])
            self.state[self.pos] = 0
            self.pos += 1
            if self.pos == _STROBE_R:
                self._run_f()
        return bytes(out)

    def _begin_op(self, flags: int, more: bool) -> None:
        if more:
            if self.cur_flags != flags:
                raise ValueError("STROBE: inconsistent `more` flags")
            return
        if flags & _FLAG_T:
            raise ValueError("STROBE: T flag not implemented (no transport)")
        old_begin = self.pos_begin
        self.pos_begin = self.pos + 1
        self.cur_flags = flags
        self._absorb(bytes([old_begin, flags]))
        force_f = bool(flags & (_FLAG_C | _FLAG_K))
        if force_f and self.pos != 0:
            self._run_f()

    # --- merlin's ops

    def meta_ad(self, data: bytes, more: bool) -> None:
        self._begin_op(_FLAG_M | _FLAG_A, more)
        self._absorb(data)

    def ad(self, data: bytes, more: bool) -> None:
        self._begin_op(_FLAG_A, more)
        self._absorb(data)

    def prf(self, n: int, more: bool = False) -> bytes:
        self._begin_op(_FLAG_I | _FLAG_A | _FLAG_C, more)
        return self._squeeze(n)

    def key(self, data: bytes, more: bool = False) -> None:
        self._begin_op(_FLAG_A | _FLAG_C, more)
        # KEY overwrites (duplex override), per strobe128.rs overwrite
        for byte in data:
            self.state[self.pos] = byte
            self.pos += 1
            if self.pos == _STROBE_R:
                self._run_f()


class BatchStrobe128:
    """N STROBE-128 sponges advancing in lockstep — the batch-axis analog
    of Strobe128 for transcripts whose op sequence is identical across
    rows (every verification challenge of a commit runs the same Merlin
    ops; only the absorbed bytes differ per row). State is an (N, 200)
    uint8 array whose (N, 25)-uint64 view advances under one batched
    Keccak-f[1600] permutation (ops/hashvec.py). pos/pos_begin/cur_flags
    stay scalars because the op sequence, and so every duplex position, is
    shared by construction. Bit for bit equal to Strobe128 on every row."""

    __slots__ = ("n", "state", "pos", "pos_begin", "cur_flags")

    def __init__(self, n: int, protocol_label: bytes):
        self.n = n
        self.state = np.zeros((n, 200), dtype=np.uint8)
        self.state[:, :len(_STROBE_SEED)] = np.frombuffer(_STROBE_SEED, dtype=np.uint8)
        self._perm()
        self.pos = 0
        self.pos_begin = 0
        self.cur_flags = 0
        self.meta_ad(protocol_label, False)

    @classmethod
    def from_snapshot(cls, n: int, snap: tuple) -> "BatchStrobe128":
        """Broadcast a single-row snapshot (shared transcript prefix) to
        N lockstep rows."""
        bs = cls.__new__(cls)
        state_row, bs.pos, bs.pos_begin, bs.cur_flags = snap
        bs.n = n
        bs.state = np.broadcast_to(state_row, (n, 200)).copy()
        return bs

    def snapshot(self) -> tuple:
        """Row-0 state + duplex position (rows are identical until
        row-dependent data is absorbed)."""
        return (self.state[0].copy(), self.pos, self.pos_begin,
                self.cur_flags)

    # --- duplex plumbing (mirrors Strobe128 exactly)

    def _perm(self) -> None:
        hashvec.keccak_f1600_many(self.state.view("<u8"))

    def _run_f(self) -> None:
        self.state[:, self.pos] ^= self.pos_begin
        self.state[:, self.pos + 1] ^= 0x04
        self.state[:, _STROBE_R + 1] ^= 0x80
        self._perm()
        self.pos = 0
        self.pos_begin = 0

    def _chunks(self, m: int):
        """Yield (offset, count) absorb/squeeze spans between permutation
        boundaries — the batched replacement for the per-byte loop."""
        off = 0
        while off < m:
            c = min(_STROBE_R - self.pos, m - off)
            yield off, c
            self.pos += c
            off += c
            if self.pos == _STROBE_R:
                self._run_f()

    def _as_rows(self, data):
        """bytes (broadcast to all rows) or (N, m) uint8 array."""
        if isinstance(data, (bytes, bytearray)):
            return np.frombuffer(bytes(data), dtype=np.uint8)[None, :], len(data)
        if data.shape[0] != self.n or data.dtype != np.uint8:
            raise ValueError(f"rows must be ({self.n}, m) uint8")
        return data, data.shape[1]

    def _absorb(self, data) -> None:
        rows, m = self._as_rows(data)
        for off, c in self._chunks(m):
            self.state[:, self.pos:self.pos + c] ^= rows[:, off:off + c]

    def _begin_op(self, flags: int, more: bool) -> None:
        if more:
            if self.cur_flags != flags:
                raise ValueError("STROBE: inconsistent `more` flags")
            return
        if flags & _FLAG_T:
            raise ValueError("STROBE: T flag not implemented")
        old_begin = self.pos_begin
        self.pos_begin = self.pos + 1
        self.cur_flags = flags
        self._absorb(bytes([old_begin, flags]))
        if (flags & (_FLAG_C | _FLAG_K)) and self.pos != 0:
            self._run_f()

    # --- merlin's ops

    def meta_ad(self, data, more: bool) -> None:
        self._begin_op(_FLAG_M | _FLAG_A, more)
        self._absorb(data)

    def ad(self, data, more: bool) -> None:
        self._begin_op(_FLAG_A, more)
        self._absorb(data)

    def prf(self, n: int, more: bool = False) -> np.ndarray:
        self._begin_op(_FLAG_I | _FLAG_A | _FLAG_C, more)
        out = np.empty((self.n, n), dtype=np.uint8)
        for off, c in self._chunks(n):
            out[:, off:off + c] = self.state[:, self.pos:self.pos + c]
            self.state[:, self.pos:self.pos + c] = 0
        return out

    def key(self, data, more: bool = False) -> None:
        self._begin_op(_FLAG_A | _FLAG_C, more)
        rows, m = self._as_rows(data)
        for off, c in self._chunks(m):
            self.state[:, self.pos:self.pos + c] = rows[:, off:off + c]


class Transcript:
    """merlin::Transcript."""

    MERLIN_LABEL = b"Merlin v1.0"

    def __init__(self, label: bytes):
        self.strobe = Strobe128(self.MERLIN_LABEL)
        self.append_message(b"dom-sep", label)

    def append_message(self, label: bytes, message: bytes) -> None:
        self.strobe.meta_ad(label, False)
        self.strobe.meta_ad(len(message).to_bytes(4, "little"), True)
        self.strobe.ad(message, False)

    def append_u64(self, label: bytes, v: int) -> None:
        self.append_message(label, v.to_bytes(8, "little"))

    def challenge_bytes(self, label: bytes, n: int) -> bytes:
        self.strobe.meta_ad(label, False)
        self.strobe.meta_ad(n.to_bytes(4, "little"), True)
        return self.strobe.prf(n)

    def clone(self) -> "Transcript":
        t = Transcript.__new__(Transcript)
        t.strobe = copy.deepcopy(self.strobe)
        return t

    # --- schnorrkel extensions (schnorrkel/src/context.rs)

    def proto_name(self, label: bytes) -> None:
        self.append_message(b"proto-name", label)

    def append_point(self, label: bytes, point_bytes: bytes) -> None:
        self.append_message(label, point_bytes)

    def challenge_scalar(self, label: bytes) -> int:
        return int.from_bytes(self.challenge_bytes(label, 64), "little") % L

    def witness_scalar(self, label: bytes, nonce_seed: bytes) -> int:
        """schnorrkel witness_scalar: fork the transcript via STROBE rekey
        with the nonce seed and 32 random bytes."""
        s = copy.deepcopy(self.strobe)
        s.meta_ad(b"", False)
        s.meta_ad(label, True)
        s.key(nonce_seed, False)
        s.key(_secrets.token_bytes(32), False)
        s.meta_ad((64).to_bytes(4, "little"), False)
        return int.from_bytes(s.prf(64), "little") % L


# ---------------------------------------------------------------------------
# ristretto255 encode/decode over the ed25519 oracle's extended coordinates
# ---------------------------------------------------------------------------

SQRT_M1 = ed.SQRT_M1


def _sqrt_ratio_m1(u: int, v: int) -> tuple[bool, int]:
    """(was_square, sqrt(u/v) or sqrt(i*u/v)), nonnegative root
    (ristretto255 spec SQRT_RATIO_M1)."""
    v3 = v * v % P * v % P
    v7 = v3 * v3 % P * v % P
    r = u * v3 % P * pow(u * v7 % P, (P - 5) // 8, P) % P
    check = v * r % P * r % P
    correct = check == u % P
    flipped = check == (-u) % P
    flipped_i = check == (-u) % P * SQRT_M1 % P
    if flipped or flipped_i:
        r = r * SQRT_M1 % P
    was_square = correct or flipped
    if r % 2 == 1:  # CT_ABS: take the nonnegative (even) root
        r = (-r) % P
    return was_square, r


# invsqrt(a - d), a = -1: the nonnegative root of 1/(a-d)
INVSQRT_A_MINUS_D = _sqrt_ratio_m1(1, (-1 - D) % P)[1]


def ristretto_decode(b: bytes) -> tuple[int, int, int, int] | None:
    """32 bytes -> extended point, or None (spec DECODE)."""
    if len(b) != 32:
        return None
    s = int.from_bytes(b, "little")
    if s >= P or s % 2 == 1:  # canonical and nonnegative
        return None
    ss = s * s % P
    u1 = (1 - ss) % P
    u2 = (1 + ss) % P
    u2_sqr = u2 * u2 % P
    v = (-(D * u1 % P * u1) - u2_sqr) % P
    was_square, invsqrt = _sqrt_ratio_m1(1, v * u2_sqr % P)
    den_x = invsqrt * u2 % P
    den_y = invsqrt * den_x % P * v % P
    x = 2 * s % P * den_x % P
    if x % 2 == 1:
        x = (-x) % P
    y = u1 * den_y % P
    t = x * y % P
    if not was_square or t % 2 == 1 or y == 0:
        return None
    return (x, y, 1, t)


def ristretto_encode(pt: tuple[int, int, int, int]) -> bytes:
    """Extended point -> canonical 32 bytes (spec ENCODE)."""
    x0, y0, z0, t0 = pt
    u1 = (z0 + y0) * (z0 - y0) % P
    u2 = x0 * y0 % P
    _, invsqrt = _sqrt_ratio_m1(1, u1 * u2 % P * u2 % P)
    den1 = invsqrt * u1 % P
    den2 = invsqrt * u2 % P
    z_inv = den1 * den2 % P * t0 % P
    ix0 = x0 * SQRT_M1 % P
    iy0 = y0 * SQRT_M1 % P
    enchanted_denominator = den1 * INVSQRT_A_MINUS_D % P
    rotate = (t0 * z_inv % P) % 2 == 1
    if rotate:
        x, y = iy0, ix0
        den_inv = enchanted_denominator
    else:
        x, y = x0, y0
        den_inv = den2
    if (x * z_inv % P) % 2 == 1:
        y = (-y) % P
    s = (z0 - y) * den_inv % P
    if s % 2 == 1:
        s = (-s) % P
    return s.to_bytes(32, "little")


# ---------------------------------------------------------------------------
# schnorrkel keys + sign/verify (signing context b"", as CometBFT's
# crypto/sr25519/privkey.go: sr25519.NewSigningContext([]byte{}))
# ---------------------------------------------------------------------------


def make_signing_transcript(msg: bytes, ctx: bytes = b"") -> Transcript:
    """sr25519.NewSigningContext(ctx).NewTranscriptBytes(msg)
    (schnorrkel signing_context(ctx).bytes(msg))."""
    t = Transcript(b"SigningContext")
    t.append_message(b"", ctx)
    t.append_message(b"sign-bytes", msg)
    return t


def expand_ed25519(mini: bytes) -> tuple[int, bytes]:
    """MiniSecretKey.ExpandEd25519: scalar = clamp(sha512(mini)[:32]) >> 3
    (divided by the cofactor — schnorrkel keeps the ed25519 bit layout
    compatible), nonce = sha512(mini)[32:]."""
    h = hashlib.sha512(mini).digest()
    key = bytearray(h[:32])
    key[0] &= 248
    key[31] &= 63
    key[31] |= 64
    scalar = int.from_bytes(bytes(key), "little") >> 3
    return scalar % L, h[32:]


def keypair_from_mini(mini: bytes) -> tuple[int, bytes, bytes]:
    """-> (secret scalar, nonce, public ristretto bytes)."""
    scalar, nonce = expand_ed25519(mini)
    pub = ristretto_encode(ed.scalar_mult(scalar, ed.B_POINT))
    return scalar, nonce, pub


def sign(mini_or_pair, msg: bytes) -> bytes:
    """64-byte schnorrkel signature: R(32) || s(32) with bit 255 set."""
    if isinstance(mini_or_pair, bytes):
        scalar, nonce, pub = keypair_from_mini(mini_or_pair)
    else:
        scalar, nonce, pub = mini_or_pair
    t = make_signing_transcript(msg)
    t.proto_name(b"Schnorr-sig")
    t.append_point(b"sign:pk", pub)
    r = t.witness_scalar(b"signing", nonce)
    r_bytes = ristretto_encode(ed.scalar_mult(r, ed.B_POINT))
    t.append_point(b"sign:R", r_bytes)
    k = t.challenge_scalar(b"sign:c")
    s = (k * scalar + r) % L
    sig = bytearray(r_bytes + s.to_bytes(32, "little"))
    sig[63] |= 128  # schnorrkel "not-ed25519" marker
    return bytes(sig)


def parse_signature(sig: bytes) -> tuple[bytes, int] | None:
    """-> (R bytes, s) or None. The marker bit must be set (schnorrkel
    rejects unmarked signatures) and s must be canonical."""
    if len(sig) != 64 or not sig[63] & 128:
        return None
    s_bytes = bytearray(sig[32:])
    s_bytes[31] &= 127
    s = int.from_bytes(bytes(s_bytes), "little")
    if s >= L:
        return None
    return sig[:32], s


def compute_challenge(pub: bytes, r_bytes: bytes, msg: bytes) -> int:
    t = make_signing_transcript(msg)
    t.proto_name(b"Schnorr-sig")
    t.append_point(b"sign:pk", pub)
    t.append_point(b"sign:R", r_bytes)
    return t.challenge_scalar(b"sign:c")


# Groups of fewer rows than this take the serial rung.
VEC_MIN_ROWS = hashvec.VEC_MIN_ROWS

# shared transcript prefix per message length: everything up to (and
# including) the "sign-bytes" length header is row-independent, so it runs
# once on a 1-row batch sponge and broadcasts (bounded cache; commit
# sign-bytes lengths are few per chain)
_PREFIX_CACHE: dict[int, tuple] = {}


def _signing_prefix(mlen: int) -> tuple:
    snap = _PREFIX_CACHE.get(mlen)
    if snap is None:
        bs = BatchStrobe128(1, Transcript.MERLIN_LABEL)
        for label, msg in ((b"dom-sep", b"SigningContext"), (b"", b"")):
            bs.meta_ad(label, False)
            bs.meta_ad(len(msg).to_bytes(4, "little"), True)
            bs.ad(msg, False)
        bs.meta_ad(b"sign-bytes", False)
        bs.meta_ad(mlen.to_bytes(4, "little"), True)
        snap = bs.snapshot()
        if len(_PREFIX_CACHE) >= 256:
            _PREFIX_CACHE.pop(next(iter(_PREFIX_CACHE)))
        _PREFIX_CACHE[mlen] = snap
    return snap


def _batch_challenge_digests(pub_rows, r_rows, msg_rows) -> np.ndarray:
    """(N, 32)/(N, 32)/(N, mlen) uint8 rows -> (N, 64) uint8 challenge
    bytes: the whole Merlin verification transcript advanced in lockstep."""
    n = pub_rows.shape[0]
    bs = BatchStrobe128.from_snapshot(n, _signing_prefix(msg_rows.shape[1]))
    bs.ad(msg_rows, False)
    bs.meta_ad(b"proto-name", False)
    bs.meta_ad(len(b"Schnorr-sig").to_bytes(4, "little"), True)
    bs.ad(b"Schnorr-sig", False)
    for label, rows in ((b"sign:pk", pub_rows), (b"sign:R", r_rows)):
        bs.meta_ad(label, False)
        bs.meta_ad((32).to_bytes(4, "little"), True)
        bs.ad(rows, False)
    bs.meta_ad(b"sign:c", False)
    bs.meta_ad((64).to_bytes(4, "little"), True)
    return bs.prf(64)


# ------------------------------------------------------------ serial rung

_strobe_lock = threading.Lock()
_strobe_lib: list = []  # [lib or None] once tried


def _native_strobe():
    """native/strobe.c with sr25519_batch_challenge declared, or None when
    it does not build here. Built on first use, never at import."""
    if not _strobe_lib:
        with _strobe_lock:
            if not _strobe_lib:
                from cometbft_tpu_torch import native

                lib = native.load("strobe")
                if lib is not None:
                    vp = ctypes.c_void_p
                    lib.sr25519_batch_challenge.argtypes = [vp, vp, vp, vp, ctypes.c_long, vp]
                    lib.sr25519_batch_challenge.restype = None
                _strobe_lib.append(lib)
    return _strobe_lib[0]


def serial_rung() -> str:
    """The serial rung's engine: "native" (strobe.c) or "python"."""
    return "native" if _native_strobe() is not None else "python"


# rows per native call below which one call does the whole group
_CHUNK_MIN = 512
_CHUNK_WORKERS = 4


def _serial_challenge_digests(pubs: list[bytes], r_rows: np.ndarray,
                              msgs: list[bytes]) -> np.ndarray:
    """(N, 64) uint8 challenge bytes through the serial rung: strobe.c's
    sr25519_batch_challenge (the whole Merlin transcript of a row in C)
    over chunks of rows on up to _CHUNK_WORKERS threads (ctypes releases
    the GIL), else the Python transcript row by row."""
    n = len(pubs)
    out = np.empty((n, 64), dtype=np.uint8)
    lib = _native_strobe()
    if lib is None:
        for i in range(n):
            t = make_signing_transcript(msgs[i])
            t.proto_name(b"Schnorr-sig")
            t.append_point(b"sign:pk", pubs[i])
            t.append_point(b"sign:R", r_rows[i].tobytes())
            out[i] = np.frombuffer(t.challenge_bytes(b"sign:c", 64), dtype=np.uint8)
        return out
    pub_buf = np.frombuffer(b"".join(pubs), dtype=np.uint8)
    r_buf = np.ascontiguousarray(r_rows, dtype=np.uint8)
    msg_buf = np.frombuffer(b"".join(msgs) or b"\0", dtype=np.uint8)
    offs = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.fromiter(map(len, msgs), np.int64, n), out=offs[1:])

    def run(start: int) -> None:
        count = min(step, n - start)
        lib.sr25519_batch_challenge(
            pub_buf.ctypes.data + 32 * start, r_buf.ctypes.data + 32 * start,
            msg_buf.ctypes.data, offs.ctypes.data + 8 * start, count,
            out.ctypes.data + 64 * start)

    workers = min(_CHUNK_WORKERS, max(1, n // _CHUNK_MIN))
    step = -(-n // workers)
    if workers > 1:
        with concurrent.futures.ThreadPoolExecutor(workers) as ex:
            list(ex.map(run, range(0, n, step)))
    else:
        run(0)
    return out


def batch_challenge_words(pubs: list[bytes], r_list: list[bytes],
                          msgs: list[bytes]) -> np.ndarray:
    """All N verification challenges as packed (N, 8) uint32 device words
    (k mod L, little-endian). Bit for bit equal to compute_challenge on
    every row."""
    n = len(pubs)
    r_rows = (np.frombuffer(b"".join(r_list), dtype=np.uint8).reshape(n, 32)
              if n else np.zeros((0, 32), dtype=np.uint8))
    return batch_challenge_words_rows(pubs, r_rows, msgs)


def batch_challenge_words_rows(pubs: list[bytes], r_rows: np.ndarray,
                               msgs: list[bytes]) -> np.ndarray:
    """batch_challenge_words with R as (N, 32) uint8 signature halves.
    Rows group by message length; a group of VEC_MIN_ROWS or more advances
    under the batch STROBE transcript, smaller groups (and every group
    under CBFT_HASHVEC=serial) take the serial rung. Digests reduce mod L
    through hashvec.reduce512_mod_l."""
    n = len(pubs)
    out = np.zeros((n, 8), dtype=np.uint32)
    by_len: dict[int, list[int]] = {}
    for i, m in enumerate(msgs):
        by_len.setdefault(len(m), []).append(i)
    serial = os.environ.get("CBFT_HASHVEC") == "serial"
    for mlen, idxs in by_len.items():
        sel = np.asarray(idxs, dtype=np.intp)
        rows_r = np.ascontiguousarray(r_rows[sel])
        if serial or len(idxs) < VEC_MIN_ROWS:
            digests = _serial_challenge_digests([pubs[i] for i in idxs], rows_r,
                                                [msgs[i] for i in idxs])
        else:
            pub_rows = np.frombuffer(
                b"".join(pubs[i] for i in idxs), dtype=np.uint8).reshape(-1, 32)
            # (rows, mlen) explicitly: -1 cannot be inferred when mlen is 0
            msg_rows = np.frombuffer(
                b"".join(msgs[i] for i in idxs), dtype=np.uint8).reshape(len(idxs), mlen)
            digests = _batch_challenge_digests(pub_rows, rows_r, msg_rows)
        out[sel] = hashvec.reduce512_mod_l(digests)
    return out


def verify(pub: bytes, msg: bytes, sig: bytes) -> bool:
    parsed = parse_signature(sig)
    if parsed is None:
        return False
    r_bytes, s = parsed
    a_pt = ristretto_decode(pub)
    r_pt = ristretto_decode(r_bytes)
    if a_pt is None or r_pt is None:
        return False
    k = compute_challenge(pub, r_bytes, msg)
    # [4](sB - kA - R) == O  <=>  ristretto equality sB - kA == R
    sb = ed.scalar_mult(s, ed.B_POINT)
    ka = ed.scalar_mult(k, a_pt)
    diff = ed.point_add(sb, ed.point_neg(ka))
    diff = ed.point_add(diff, ed.point_neg(r_pt))
    quad = ed.point_double(ed.point_double(diff))
    return ed.is_identity(quad)
