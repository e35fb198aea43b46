"""Pure-Python Ed25519 group arithmetic with ZIP-215 verification semantics.

The port's exact host oracle: the cofactored equation, non-canonical point
encodings accepted, s < L enforced (curve25519-voi's ZIP-215 mode, which
CometBFT selects). The device verify path must agree with it on every
input; it also builds the kernel's [d]B table and re-verifies the few
lanes the device rejects (ops/ed25519_kernel.recheck_failed_lanes).

Python bignums cost about a millisecond per verification: this is a
reference, not a production path.
"""

from __future__ import annotations

import hashlib

P = 2**255 - 19
L = 2**252 + 27742317777372353535851937790883648493
D = (-121665 * pow(121666, P - 2, P)) % P
D2 = (2 * D) % P
SQRT_M1 = pow(2, (P - 1) // 4, P)  # sqrt(-1)

# Base point: y = 4/5, x recovered with even sign.
_BY = (4 * pow(5, P - 2, P)) % P


def _recover_x(y: int, sign: int) -> int | None:
    """RFC 8032 §5.1.3 x-recovery. None if no square root exists or if
    x == 0 with sign == 1."""
    u = (y * y - 1) % P
    v = (D * y * y + 1) % P
    # candidate = (u/v)^((p+3)/8) = u * v^3 * (u*v^7)^((p-5)/8)
    x = (u * pow(v, 3, P) * pow(u * pow(v, 7, P) % P, (P - 5) // 8, P)) % P
    vxx = (v * x * x) % P
    if vxx == u:
        pass
    elif vxx == (-u) % P:
        x = (x * SQRT_M1) % P
    else:
        return None
    if x == 0 and sign == 1:
        return None
    if x & 1 != sign:
        x = P - x
    return x


BX = _recover_x(_BY, 0)

# Extended homogeneous coordinates (X : Y : Z : T), x = X/Z, y = Y/Z, T = XY/Z.
Point = tuple[int, int, int, int]

IDENTITY: Point = (0, 1, 1, 0)
B_POINT: Point = (BX, _BY, 1, (BX * _BY) % P)


def point_add(p1: Point, p2: Point) -> Point:
    """Complete unified addition, add-2008-hwcd-3 for a=-1."""
    X1, Y1, Z1, T1 = p1
    X2, Y2, Z2, T2 = p2
    a = (Y1 - X1) * (Y2 - X2) % P
    b = (Y1 + X1) * (Y2 + X2) % P
    c = T1 * D2 % P * T2 % P
    d = 2 * Z1 * Z2 % P
    e, f, g, h = b - a, d - c, d + c, b + a
    return (e * f % P, g * h % P, f * g % P, e * h % P)


def point_double(p1: Point) -> Point:
    """dbl-2008-hwcd."""
    X1, Y1, Z1, _ = p1
    a = X1 * X1 % P
    b = Y1 * Y1 % P
    c = 2 * Z1 * Z1 % P
    h = (a + b) % P
    e = (h - (X1 + Y1) * (X1 + Y1)) % P
    g = (a - b) % P
    f = (c + g) % P
    return (e * f % P, g * h % P, f * g % P, e * h % P)


def point_neg(p1: Point) -> Point:
    X, Y, Z, T = p1
    return ((-X) % P, Y, Z, (-T) % P)


def scalar_mult(k: int, p1: Point) -> Point:
    """Double-and-add, MSB first."""
    acc = IDENTITY
    for i in reversed(range(k.bit_length())):
        acc = point_double(acc)
        if (k >> i) & 1:
            acc = point_add(acc, p1)
    return acc


def double_scalar_mult(k1: int, p1: Point, k2: int, p2: Point) -> Point:
    """[k1]p1 + [k2]p2, interleaved (Straus)."""
    table = (IDENTITY, p1, p2, point_add(p1, p2))
    acc = IDENTITY
    for i in reversed(range(max(k1.bit_length(), k2.bit_length(), 1))):
        acc = point_double(acc)
        idx = ((k1 >> i) & 1) | (((k2 >> i) & 1) << 1)
        if idx:
            acc = point_add(acc, table[idx])
    return acc


def is_identity(p1: Point) -> bool:
    X, Y, Z, _ = p1
    return X % P == 0 and (Y - Z) % P == 0


def point_compress(p1: Point) -> bytes:
    X, Y, Z, _ = p1
    zi = pow(Z, P - 2, P)
    x = X * zi % P
    y = Y * zi % P
    return (y | ((x & 1) << 255)).to_bytes(32, "little")


def point_decompress_zip215(data: bytes) -> Point | None:
    """ZIP-215 decompression: the y candidate need not be canonical (y >= p
    is accepted and reduced mod p); x-recovery per RFC 8032 otherwise."""
    if len(data) != 32:
        return None
    enc = int.from_bytes(data, "little")
    sign = enc >> 255
    y = (enc & ((1 << 255) - 1)) % P
    x = _recover_x(y, sign)
    if x is None:
        return None
    return (x, y, 1, x * y % P)


def mul_by_cofactor(p1: Point) -> Point:
    return point_double(point_double(point_double(p1)))


def sha512_mod_l(*parts: bytes) -> int:
    h = hashlib.sha512()
    for part in parts:
        h.update(part)
    return int.from_bytes(h.digest(), "little") % L


def secret_expand(seed: bytes) -> tuple[int, bytes]:
    h = hashlib.sha512(seed).digest()
    a = int.from_bytes(h[:32], "little")
    a &= (1 << 254) - 8
    a |= 1 << 254
    return a, h[32:]


def public_key_from_seed(seed: bytes) -> bytes:
    a, _ = secret_expand(seed)
    return point_compress(scalar_mult(a, B_POINT))


def sign(seed: bytes, msg: bytes) -> bytes:
    """RFC 8032 signing."""
    a, prefix = secret_expand(seed)
    pub = point_compress(scalar_mult(a, B_POINT))
    r = int.from_bytes(hashlib.sha512(prefix + msg).digest(), "little") % L
    R = point_compress(scalar_mult(r, B_POINT))
    k = sha512_mod_l(R, pub, msg)
    s = (r + k * a) % L
    return R + s.to_bytes(32, "little")


def verify_zip215(pub: bytes, msg: bytes, sig: bytes) -> bool:
    """ZIP-215 single verification: cofactored [8][S]B == [8]R + [8][k]A with
    non-canonical A/R accepted and S < L enforced."""
    if len(sig) != 64 or len(pub) != 32:
        return False
    A = point_decompress_zip215(pub)
    if A is None:
        return False
    R = point_decompress_zip215(sig[:32])
    if R is None:
        return False
    s = int.from_bytes(sig[32:], "little")
    if s >= L:
        return False
    k = sha512_mod_l(sig[:32], pub, msg)
    sb_ka = double_scalar_mult(s, B_POINT, k, point_neg(A))
    diff = point_add(sb_ka, point_neg(R))
    return is_identity(mul_by_cofactor(diff))
