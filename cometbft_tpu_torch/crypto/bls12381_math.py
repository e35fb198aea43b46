"""The exact BLS12-381 host oracle: the port's copy of the BLS half of
cometbft_tpu/crypto/fallback.py (:377-1235).

Pure-Python integer arithmetic (min-pubkey-size scheme: 48-byte G1 pubkeys,
96-byte G2 signatures). The curve parameters are tied together by integer
identities asserted at import (r = x^4 - x^2 + 1, 3p = (x-1)^2 r + 3x), the
G2 cofactor comes from the sextic-twist order computed out of the Frobenius
trace and is checked by killing mapped points, and the SvdW hash-to-curve Z
and the final-exponentiation addition chain validate themselves before use.
Hash-to-curve follows the draft-irtf-cfrg-hash-to-curve pipeline
(expand_message_xmd/SHA-256 -> hash_to_field -> generic SvdW map of RFC 9380
§6.6.1 -> clear_cofactor) and carries its own DST (crypto/bls12381.DST).
Aggregation is the proof-of-possession flavour: identical sign-bytes across
signers aggregate their pubkeys.

It is the recheck oracle of the device path (ops/bls_kernel.py) and the
reference value of the tests; the device pipeline's constants (SvdW, the
cofactor, the Frobenius gammas) are read from here.
"""

from __future__ import annotations

import hashlib

BLS_P = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
BLS_R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001
BLS_X = -0xD201000000010000  # the BLS12-381 curve parameter (negative)

# parameter cross-checks: the family polynomials tie p, r and x together —
# a typo in any one of the three fails here at import, not in a test
assert BLS_R == BLS_X**4 - BLS_X**2 + 1, "BLS12-381 r/x mismatch"
assert 3 * BLS_P == (BLS_X - 1) ** 2 * BLS_R + 3 * BLS_X, "BLS12-381 p/x mismatch"

# generators (standard encodings' affine coordinates); both are checked
# against their curve equations at import
BLS_G1 = (
    0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB,
    0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1,
)
BLS_G2 = (
    (
        0x024AA2B2F08F0A91260805272DC51051C6E47AD4FA403B02B4510B647AE3D1770BAC0326A805BBEFD48056C8C121BDB8,
        0x13E02B6052719F607DACD3A088274F65596BD0D09920B61AB5DA61BBDC7F5049334CF11213945D57E5AC7D055D042B7E,
    ),
    (
        0x0CE5D527727D6E118CC9CDC6DA2E351AADFD9BAA8CBDD3A76D429A695160D12C923AC9CC3BACA289E193548608B82801,
        0x0606C4A02EA734CC32ACD2B02BC28B99CB3E287E85A763AF267492AB572E99AB3F370D275CEC1DA1AAA9075FF05F79BE,
    ),
)

_P = BLS_P


def _f1_add(a, b):
    return (a + b) % _P


def _f1_sub(a, b):
    return (a - b) % _P


def _f1_mul(a, b):
    return a * b % _P


def _f1_sq(a):
    return a * a % _P


def _f1_neg(a):
    return -a % _P


def _f1_inv(a):
    return pow(a, _P - 2, _P)


assert _f1_sq(BLS_G1[1]) == (BLS_G1[0] ** 3 + 4) % _P, "G1 generator off-curve"

# ---- Fp2 = Fp[u] / (u^2 + 1); elements are (a0, a1) = a0 + a1*u --------

F2_ZERO = (0, 0)
F2_ONE = (1, 0)
BLS_XI = (1, 1)  # the Fp6/Fp12 tower non-residue xi = 1 + u


def f2_add(a, b):
    return ((a[0] + b[0]) % _P, (a[1] + b[1]) % _P)


def f2_sub(a, b):
    return ((a[0] - b[0]) % _P, (a[1] - b[1]) % _P)


def f2_neg(a):
    return (-a[0] % _P, -a[1] % _P)


def f2_mul(a, b):
    a0, a1 = a
    b0, b1 = b
    t0 = a0 * b0
    t1 = a1 * b1
    t2 = (a0 + a1) * (b0 + b1)
    return ((t0 - t1) % _P, (t2 - t0 - t1) % _P)


def f2_sq(a):
    a0, a1 = a
    return ((a0 + a1) * (a0 - a1) % _P, 2 * a0 * a1 % _P)


def f2_conj(a):
    return (a[0], -a[1] % _P)


def f2_inv(a):
    n = pow((a[0] * a[0] + a[1] * a[1]) % _P, _P - 2, _P)
    return (a[0] * n % _P, -a[1] * n % _P)


def f2_mul_fp(a, k):
    return (a[0] * k % _P, a[1] * k % _P)


def f2_mul_xi(a):
    # (1 + u)(a0 + a1 u) = (a0 - a1) + (a0 + a1) u
    return ((a[0] - a[1]) % _P, (a[0] + a[1]) % _P)


def f2_pow(a, e):
    out = F2_ONE
    while e:
        if e & 1:
            out = f2_mul(out, a)
        a = f2_sq(a)
        e >>= 1
    return out


def f2_is_zero(a):
    return a[0] % _P == 0 and a[1] % _P == 0


def f2_legendre_is_square(a):
    """a is a square in Fp2 iff norm(a)^((p-1)/2) == 1 (or a == 0):
    a^((p^2-1)/2) = (a^(p+1))^((p-1)/2) = norm(a)^((p-1)/2)."""
    if f2_is_zero(a):
        return True
    n = (a[0] * a[0] + a[1] * a[1]) % _P
    return pow(n, (_P - 1) // 2, _P) == 1


def f2_sqrt(a):
    """Square root in Fp2 for p = 3 mod 4 (alg. 9, eprint 2012/685);
    returns None when a is not a square."""
    if f2_is_zero(a):
        return F2_ZERO
    a1 = f2_pow(a, (_P - 3) // 4)
    alpha = f2_mul(f2_sq(a1), a)
    x0 = f2_mul(a1, a)
    if alpha == (_P - 1, 0):
        x = f2_mul((0, 1), x0)
    else:
        b = f2_pow(f2_add(F2_ONE, alpha), (_P - 1) // 2)
        x = f2_mul(b, x0)
    return x if f2_sq(x) == (a[0] % _P, a[1] % _P) else None


def f2_sgn0(a):
    """RFC 9380 sgn0 for m = 2."""
    s0 = a[0] % 2
    z0 = a[0] % _P == 0
    return s0 | (z0 and (a[1] % 2))


_B2 = f2_mul_fp(BLS_XI, 4)  # the twist constant: E'/Fp2: y^2 = x^3 + 4(1+u)
assert f2_sq(BLS_G2[1]) == f2_add(f2_mul(f2_sq(BLS_G2[0]), BLS_G2[0]), _B2), \
    "G2 generator off-curve"


# ---- Fp6 = Fp2[v] / (v^3 - xi); elements (c0, c1, c2) ------------------

F6_ZERO = (F2_ZERO, F2_ZERO, F2_ZERO)
F6_ONE = (F2_ONE, F2_ZERO, F2_ZERO)


def f6_add(a, b):
    return (f2_add(a[0], b[0]), f2_add(a[1], b[1]), f2_add(a[2], b[2]))


def f6_sub(a, b):
    return (f2_sub(a[0], b[0]), f2_sub(a[1], b[1]), f2_sub(a[2], b[2]))


def f6_neg(a):
    return (f2_neg(a[0]), f2_neg(a[1]), f2_neg(a[2]))


def f6_mul(a, b):
    a0, a1, a2 = a
    b0, b1, b2 = b
    t0, t1, t2 = f2_mul(a0, b0), f2_mul(a1, b1), f2_mul(a2, b2)
    c0 = f2_add(t0, f2_mul_xi(f2_sub(
        f2_mul(f2_add(a1, a2), f2_add(b1, b2)), f2_add(t1, t2))))
    c1 = f2_add(f2_sub(f2_mul(f2_add(a0, a1), f2_add(b0, b1)),
                       f2_add(t0, t1)), f2_mul_xi(t2))
    c2 = f2_add(f2_sub(f2_mul(f2_add(a0, a2), f2_add(b0, b2)),
                       f2_add(t0, t2)), t1)
    return (c0, c1, c2)


def f6_sq(a):
    return f6_mul(a, a)


def f6_mul_v(a):
    """v * (c0 + c1 v + c2 v^2) = xi*c2 + c0 v + c1 v^2."""
    return (f2_mul_xi(a[2]), a[0], a[1])


def f6_inv(a):
    a0, a1, a2 = a
    c0 = f2_sub(f2_sq(a0), f2_mul_xi(f2_mul(a1, a2)))
    c1 = f2_sub(f2_mul_xi(f2_sq(a2)), f2_mul(a0, a1))
    c2 = f2_sub(f2_sq(a1), f2_mul(a0, a2))
    t = f2_inv(f2_add(f2_mul(a0, c0),
                      f2_mul_xi(f2_add(f2_mul(a2, c1), f2_mul(a1, c2)))))
    return (f2_mul(c0, t), f2_mul(c1, t), f2_mul(c2, t))


# ---- Fp12 = Fp6[w] / (w^2 - v); elements (d0, d1) ----------------------

F12_ONE = (F6_ONE, F6_ZERO)


def f12_mul(a, b):
    t0 = f6_mul(a[0], b[0])
    t1 = f6_mul(a[1], b[1])
    d1 = f6_sub(f6_sub(
        f6_mul(f6_add(a[0], a[1]), f6_add(b[0], b[1])), t0), t1)
    return (f6_add(t0, f6_mul_v(t1)), d1)


def f12_sq(a):
    return f12_mul(a, a)


def f12_conj(a):
    return (a[0], f6_neg(a[1]))


def f12_inv(a):
    t = f6_inv(f6_sub(f6_sq(a[0]), f6_mul_v(f6_sq(a[1]))))
    return (f6_mul(a[0], t), f6_neg(f6_mul(a[1], t)))


def f12_pow(a, e):
    if e < 0:
        return f12_pow(f12_inv(a), -e)
    out = F12_ONE
    while e:
        if e & 1:
            out = f12_mul(out, a)
        a = f12_sq(a)
        e >>= 1
    return out


# Frobenius: (v^i w^j)^(p^n) = v^i w^j * xi^((p^n - 1)(2i + j)/6) with the
# Fp2 coefficients taken to the p^n power (conjugated when n is odd). The
# twelve gamma constants are COMPUTED, not transcribed.
_FROB_G1 = [f2_pow(BLS_XI, k * (_P - 1) // 6) for k in range(6)]


def f12_frob(a, n=1):
    """a^(p^n) for n in (1, 2, 3, ...): apply the p-power map n times."""
    for _ in range(n):
        d0 = tuple(f2_mul(f2_conj(a[0][i]), _FROB_G1[2 * i])
                   for i in range(3))
        d1 = tuple(f2_mul(f2_conj(a[1][i]), _FROB_G1[2 * i + 1])
                   for i in range(3))
        a = (d0, d1)
    return a


# ---- Jacobian point arithmetic over a generic field --------------------
# point = None (infinity) or (X, Y, Z); curve y^2 = x^3 + b, a = 0.

class _FpOps:
    add = staticmethod(_f1_add)
    sub = staticmethod(_f1_sub)
    mul = staticmethod(_f1_mul)
    sq = staticmethod(_f1_sq)
    neg = staticmethod(_f1_neg)
    inv = staticmethod(_f1_inv)
    is_zero = staticmethod(lambda a: a % _P == 0)
    ONE = 1
    B = 4


class _Fp2Ops:
    add = staticmethod(f2_add)
    sub = staticmethod(f2_sub)
    mul = staticmethod(f2_mul)
    sq = staticmethod(f2_sq)
    neg = staticmethod(f2_neg)
    inv = staticmethod(f2_inv)
    is_zero = staticmethod(f2_is_zero)
    ONE = F2_ONE
    B = _B2


def _ec_dbl(F, p):
    if p is None or F.is_zero(p[1]):
        return None
    X, Y, Z = p
    A = F.sq(X)
    B = F.sq(Y)
    C = F.sq(B)
    D = F.sub(F.sub(F.sq(F.add(X, B)), A), C)
    D = F.add(D, D)
    E = F.add(F.add(A, A), A)
    Fv = F.sq(E)
    X3 = F.sub(Fv, F.add(D, D))
    Y3 = F.sub(F.mul(E, F.sub(D, X3)), F.add(F.add(F.add(C, C), F.add(C, C)),
                                             F.add(F.add(C, C), F.add(C, C))))
    Z3 = F.add(F.mul(Y, Z), F.mul(Y, Z))
    return (X3, Y3, Z3)


def _ec_add(F, p, q):
    if p is None:
        return q
    if q is None:
        return p
    X1, Y1, Z1 = p
    X2, Y2, Z2 = q
    Z1Z1 = F.sq(Z1)
    Z2Z2 = F.sq(Z2)
    U1 = F.mul(X1, Z2Z2)
    U2 = F.mul(X2, Z1Z1)
    S1 = F.mul(F.mul(Y1, Z2), Z2Z2)
    S2 = F.mul(F.mul(Y2, Z1), Z1Z1)
    if F.is_zero(F.sub(U1, U2)):
        if F.is_zero(F.sub(S1, S2)):
            return _ec_dbl(F, p)
        return None
    H = F.sub(U2, U1)
    I = F.sq(F.add(H, H))
    J = F.mul(H, I)
    r = F.add(F.sub(S2, S1), F.sub(S2, S1))
    V = F.mul(U1, I)
    X3 = F.sub(F.sub(F.sq(r), J), F.add(V, V))
    S1J = F.mul(S1, J)
    Y3 = F.sub(F.mul(r, F.sub(V, X3)), F.add(S1J, S1J))
    Z3 = F.mul(F.mul(H, Z1), Z2)
    Z3 = F.add(Z3, Z3)
    return (X3, Y3, Z3)


def _ec_mul(F, k, p):
    out = None
    if k < 0:
        k, p = -k, _ec_neg(p)
    while k:
        if k & 1:
            out = _ec_add(F, out, p)
        p = _ec_dbl(F, p)
        k >>= 1
    return out


def _ec_neg(p):
    if p is None:
        return None
    return (p[0], tuple((-c) % _P for c in p[1]) if isinstance(p[1], tuple)
            else (-p[1]) % _P, p[2])


def _ec_affine(F, p):
    if p is None:
        return None
    zi = F.inv(p[2])
    zi2 = F.sq(zi)
    return (F.mul(p[0], zi2), F.mul(p[1], F.mul(zi, zi2)))


def _ec_from_affine(a):
    if a is None:
        return None
    one = F2_ONE if isinstance(a[0], tuple) else 1
    return (a[0], a[1], one)


def _ec_on_curve(F, a):
    """Affine (x, y) on y^2 = x^3 + F.B (infinity counts as on-curve)."""
    if a is None:
        return True
    return F.is_zero(F.sub(F.sq(a[1]), F.add(F.mul(F.sq(a[0]), a[0]), F.B)))


# ---- optimal ate pairing ------------------------------------------------
#
# The Miller variable T walks E'(Fp2) (the sextic twist) in affine form;
# line values are mapped into Fp12 through the untwist
# (x', y') -> (x'/w^2, y'/w^3) with w^6 = xi, which lands the evaluated
# line at P = (xP, yP) in three sparse slots:
#
#   l(P) = yP  +  ((lam*x0 - y0) * xi^-1) * (v w)  +  (-lam*xP * xi^-1) * (v^2 w)
#
# where lam is the twist-coordinate slope and (x0, y0) a twist point on the
# line. Any Fp2 scaling of a line value is killed by the final
# exponentiation (the (p^6 - 1) factor), which is what makes the affine
# normalization here and the projective normalization in ops/bls12381
# interchangeable — the tests assert the two pipelines agree bit-for-bit.

_XI_INV = f2_inv(BLS_XI)


def _line_f12(lam, x0, y0, xP, yP):
    """The sparse evaluated line as a full Fp12 element."""
    c_vw = f2_mul(f2_sub(f2_mul(lam, x0), y0), _XI_INV)
    c_v2w = f2_mul(f2_mul_fp(lam, xP), _XI_INV)
    c_v2w = f2_neg(c_v2w)
    return (((yP % _P, 0), F2_ZERO, F2_ZERO), (F2_ZERO, c_vw, c_v2w))


def bls_miller_loop(p_aff, q_aff):
    """f_{|x|,Q}(P) conjugated for the negative x — one Miller loop.
    p_aff: affine G1 (x, y) ints; q_aff: affine G2 ((..), (..)) Fp2 pairs.
    Either argument None (infinity) gives the neutral 1 (the pairing with
    infinity is degenerate; callers reject infinity points upstream)."""
    if p_aff is None or q_aff is None:
        return F12_ONE
    xP, yP = p_aff
    xQ, yQ = q_aff
    f = F12_ONE
    tx, ty = xQ, yQ
    bits = bin(-BLS_X)[2:]
    for bit in bits[1:]:
        # tangent at T
        lam = f2_mul(f2_mul_fp(f2_sq(tx), 3), f2_inv(f2_add(ty, ty)))
        f = f12_mul(f12_sq(f), _line_f12(lam, tx, ty, xP, yP))
        # T = 2T (affine)
        x2 = f2_sub(f2_sq(lam), f2_add(tx, tx))
        ty = f2_sub(f2_mul(lam, f2_sub(tx, x2)), ty)
        tx = x2
        if bit == "1":
            # chord through T and Q
            lam = f2_mul(f2_sub(ty, yQ), f2_inv(f2_sub(tx, xQ)))
            f = f12_mul(f, _line_f12(lam, tx, ty, xP, yP))
            x2 = f2_sub(f2_sub(f2_sq(lam), tx), xQ)
            ty = f2_sub(f2_mul(lam, f2_sub(tx, x2)), ty)
            tx = x2
    return f12_conj(f)  # x < 0


# hard-part addition chain: (x-1)^2 (x+p) (x^2+p^2-1) + 3 computes
# 3*(p^4-p^2+1)/r — a cubed pairing, still a non-degenerate bilinear map
# (3 does not divide r). Verified here; if the identity ever failed the
# plain-exponent fallback below keeps the oracle correct.
_HARD_CHAIN_OK = (
    (BLS_X - 1) ** 2 * (BLS_X + BLS_P)
    * (BLS_X**2 + BLS_P**2 - 1) + 3
    == 3 * (BLS_P**4 - BLS_P**2 + 1) // BLS_R
)
assert (BLS_P**4 - BLS_P**2 + 1) % BLS_R == 0


def _cyclo_exp(a, e):
    """a^e for a in the cyclotomic subgroup (a^(p^6+1-ish) structure from
    the easy part): inverse is conjugation, so negative e is cheap."""
    if e < 0:
        return _cyclo_exp(f12_conj(a), -e)
    out = F12_ONE
    while e:
        if e & 1:
            out = f12_mul(out, a)
        a = f12_sq(a)
        e >>= 1
    return out


def bls_final_exp(f):
    """f^((p^12 - 1)/r) (times a harmless cube when the addition chain is
    active — both sides of every pairing comparison use the same map)."""
    # easy part: f^((p^6 - 1)(p^2 + 1))
    f = f12_mul(f12_conj(f), f12_inv(f))
    f = f12_mul(f12_frob(f, 2), f)
    if not _HARD_CHAIN_OK:  # pragma: no cover - guarded self-calibration
        return _cyclo_exp(f, (BLS_P**4 - BLS_P**2 + 1) // BLS_R)
    # hard part: f^((x-1)^2 (x+p) (x^2+p^2-1) + 3)
    y = _cyclo_exp(_cyclo_exp(f, BLS_X - 1), BLS_X - 1)
    y = f12_mul(_cyclo_exp(y, BLS_X), f12_frob(y, 1))
    y2 = _cyclo_exp(_cyclo_exp(y, BLS_X), BLS_X)
    y = f12_mul(f12_mul(y2, f12_frob(y, 2)), f12_conj(y))
    return f12_mul(y, f12_mul(f12_sq(f), f))


def bls_pairing(p_aff, q_aff):
    """e(P, Q) for affine P in E(Fp), Q in E'(Fp2)."""
    return bls_final_exp(bls_miller_loop(p_aff, q_aff))


def bls_pairing_product_is_one(pairs) -> bool:
    """prod e(P_i, Q_i) == 1 with ONE shared final exponentiation — the
    aggregate-verify core."""
    f = F12_ONE
    for p_aff, q_aff in pairs:
        f = f12_mul(f, bls_miller_loop(p_aff, q_aff))
    return bls_final_exp(f) == F12_ONE


# ---- hash-to-curve (draft-irtf-cfrg-hash-to-curve pipeline) ------------


def bls_expand_message_xmd(msg: bytes, dst: bytes, len_in_bytes: int) -> bytes:
    """expand_message_xmd with SHA-256 (RFC 9380 §5.3.1), exactly as
    specified — checked against the RFC's reference vectors in
    tests/test_bls.py. Batch call sites route through
    ops/hashvec.sha256_many for rung accounting."""
    if len(dst) > 255:
        dst = hashlib.sha256(b"H2C-OVERSIZE-DST-" + dst).digest()
    ell = -(-len_in_bytes // 32)
    if ell > 255 or len_in_bytes > 65535:
        raise ValueError("expand_message_xmd length out of range")
    dst_prime = dst + bytes([len(dst)])
    z_pad = bytes(64)  # SHA-256 block size
    l_i_b = len_in_bytes.to_bytes(2, "big")
    b0 = hashlib.sha256(z_pad + msg + l_i_b + b"\x00" + dst_prime).digest()
    out = []
    bi = hashlib.sha256(b0 + b"\x01" + dst_prime).digest()
    out.append(bi)
    for i in range(2, ell + 1):
        bi = hashlib.sha256(
            bytes(x ^ y for x, y in zip(b0, bi)) + bytes([i]) + dst_prime
        ).digest()
        out.append(bi)
    return b"".join(out)[:len_in_bytes]


_H2F_L = 64  # ceil((ceil(log2(p)) + k) / 8) for 128-bit security margin


def bls_hash_to_field_fp2(msg: bytes, dst: bytes, count: int = 2):
    """hash_to_field for Fp2 (m = 2, L = 64): `count` field elements."""
    uniform = bls_expand_message_xmd(msg, dst, count * 2 * _H2F_L)
    out = []
    for i in range(count):
        comps = []
        for j in range(2):
            off = _H2F_L * (j + i * 2)
            comps.append(int.from_bytes(uniform[off:off + _H2F_L], "big") % _P)
        out.append(tuple(comps))
    return out


def _svdw_setup_fp2():
    """Find and validate the SvdW constants for E'/Fp2 (RFC 9380 §6.6.1
    with A = 0, B = 4(1+u)). Z is searched, not transcribed; the returned
    constants are validated by mapping a few field elements and checking
    the curve equation, so a bad candidate can never install."""
    def g(x):
        return f2_add(f2_mul(f2_sq(x), x), _B2)

    three = (3, 0)
    four_inv = pow(4, _P - 2, _P)
    for cand in ((0, 1), (1, 0), (1, 1), (_P - 1, 0), (0, _P - 1),
                 (2, 0), (_P - 2, 0), (2, 1), (1, 2), (3, 0), (_P - 3, 0)):
        z = cand
        gz = g(z)
        if f2_is_zero(gz):
            continue
        h = f2_mul(three, f2_sq(z))  # 3Z^2 + 4A, A = 0
        if f2_is_zero(h):
            continue
        # -(3Z^2 + 4A) / (4 g(Z)) must be square and nonzero
        crit = f2_mul(f2_neg(h), f2_mul_fp(f2_inv(gz), four_inv))
        if f2_is_zero(crit) or not f2_legendre_is_square(crit):
            continue
        neg_z_half = f2_mul_fp(f2_neg(z), (_P + 1) // 2)
        if not (f2_legendre_is_square(gz)
                or f2_legendre_is_square(g(neg_z_half))):
            continue
        c3 = f2_sqrt(f2_mul(f2_neg(gz), h))
        if c3 is None:
            continue
        if f2_sgn0(c3) == 1:
            c3 = f2_neg(c3)
        c4 = f2_mul(f2_mul_fp(f2_neg(gz), 4), f2_inv(h))
        consts = (z, gz, neg_z_half, c3, c4)
        # self-validation: the map must land on the curve
        if all(_ec_on_curve(_Fp2Ops, _svdw_map_fp2(u, consts))
               for u in (F2_ZERO, F2_ONE, (5, 7), (1234567, 7654321))):
            return consts
    raise RuntimeError("no SvdW Z parameter found for the BLS12-381 twist")


def _svdw_map_fp2(u, consts):
    """map_to_curve_svdw (RFC 9380 §6.6.1) on E'/Fp2."""
    z, c1, c2, c3, c4 = consts

    def g(x):
        return f2_add(f2_mul(f2_sq(x), x), _B2)

    tv1 = f2_mul(f2_sq(u), c1)
    tv2 = f2_add(F2_ONE, tv1)
    tv1 = f2_sub(F2_ONE, tv1)
    tv3 = f2_mul(tv1, tv2)
    tv3 = f2_inv(tv3) if not f2_is_zero(tv3) else F2_ZERO  # inv0
    tv4 = f2_mul(f2_mul(u, tv1), f2_mul(tv3, c3))
    x1 = f2_sub(c2, tv4)
    x2 = f2_add(c2, tv4)
    x3 = f2_add(f2_mul(f2_sq(f2_mul(f2_sq(tv2), tv3)), c4), z)
    if f2_legendre_is_square(g(x1)):
        x = x1
    elif f2_legendre_is_square(g(x2)):
        x = x2
    else:
        x = x3
    y = f2_sqrt(g(x))
    if y is None:  # cannot happen with valid constants
        raise RuntimeError("SvdW: g(x) not square")
    if f2_sgn0(u) != f2_sgn0(y):
        y = f2_neg(y)
    return (x, y)


_bls_lazy: dict = {}


def _bls_setup():
    """Lazy derived constants: SvdW map constants and the G2 cofactor
    (computed from the sextic-twist order, then verified by killing
    mapped points — never transcribed)."""
    if _bls_lazy:
        return _bls_lazy
    t = BLS_X + 1  # Frobenius trace of E/Fp
    assert BLS_P + 1 - t == ((BLS_X - 1) ** 2 // 3) * BLS_R
    fsq, rem = divmod(4 * BLS_P - t * t, 3)
    assert rem == 0
    fint = _isqrt(fsq)
    assert fint * fint == fsq, "BLS trace discriminant not -3*f^2"
    t2 = t * t - 2 * BLS_P  # trace over Fp2
    f2_ = t * fint
    n = None
    for cand in (BLS_P**2 + 1 - (t2 + 3 * f2_) // 2,
                 BLS_P**2 + 1 - (t2 - 3 * f2_) // 2):
        if cand % BLS_R == 0:
            n = cand
            break
    assert n is not None, "no sextic twist order divisible by r"
    svdw = _svdw_setup_fp2()
    # verify the order: it must kill arbitrary points of E'(Fp2)
    for u in ((7, 11), (13, 17)):
        pt = _ec_from_affine(_svdw_map_fp2(u, svdw))
        assert _ec_mul(_Fp2Ops, n, pt) is None, "twist order FAILED"
    _bls_lazy.update({
        "svdw": svdw,
        "h2": n // BLS_R,
        "h1": (BLS_X - 1) ** 2 // 3,
    })
    return _bls_lazy


def _isqrt(n: int) -> int:
    import math

    return math.isqrt(n)


def bls_hash_to_g2(msg: bytes, dst: bytes):
    """hash_to_curve for G2: hash_to_field (2 elements) -> SvdW map each ->
    point add -> clear cofactor. Returns an affine Fp2 pair in the r-order
    subgroup (never infinity for any realistic input; infinity would be
    rejected by the signer/verifier path anyway)."""
    setup = _bls_setup()
    u0, u1 = bls_hash_to_field_fp2(msg, dst, 2)
    q0 = _ec_from_affine(_svdw_map_fp2(u0, setup["svdw"]))
    q1 = _ec_from_affine(_svdw_map_fp2(u1, setup["svdw"]))
    pt = _ec_mul(_Fp2Ops, setup["h2"], _ec_add(_Fp2Ops, q0, q1))
    return _ec_affine(_Fp2Ops, pt)


# ---- serialization (ZCash-style compressed encodings) ------------------

_F_COMPRESSED = 0x80
_F_INFINITY = 0x40
_F_SIGN = 0x20


def _y_is_lexi_larger(y) -> bool:
    if isinstance(y, tuple):
        if y[1] % _P != 0:
            return y[1] % _P > (_P - 1) // 2
        return y[0] % _P > (_P - 1) // 2
    return y % _P > (_P - 1) // 2


def bls_g1_compress(aff) -> bytes:
    if aff is None:
        return bytes([_F_COMPRESSED | _F_INFINITY]) + bytes(47)
    x, y = aff
    flags = _F_COMPRESSED | (_F_SIGN if _y_is_lexi_larger(y) else 0)
    out = bytearray(x.to_bytes(48, "big"))
    out[0] |= flags
    return bytes(out)


def bls_g1_decompress(data: bytes):
    """48-byte compressed G1 -> affine (x, y) | None (infinity) — raises
    ValueError on structural garbage (flags, x >= p, not on curve)."""
    if len(data) != 48:
        raise ValueError("bls12381 G1 point must be 48 bytes")
    flags = data[0]
    if not flags & _F_COMPRESSED:
        raise ValueError("uncompressed G1 encoding not supported")
    body = bytes([data[0] & 0x1F]) + data[1:]
    if flags & _F_INFINITY:
        if any(body) or flags & _F_SIGN:
            raise ValueError("malformed G1 infinity encoding")
        return None
    x = int.from_bytes(body, "big")
    if x >= _P:
        raise ValueError("G1 x out of range")
    yy = (x * x % _P * x + 4) % _P
    y = pow(yy, (_P + 1) // 4, _P)
    if y * y % _P != yy:
        raise ValueError("G1 x not on curve")
    if bool(flags & _F_SIGN) != _y_is_lexi_larger(y):
        y = _P - y
    return (x, y)


def bls_g2_compress(aff) -> bytes:
    if aff is None:
        return bytes([_F_COMPRESSED | _F_INFINITY]) + bytes(95)
    (x0, x1), y = aff
    flags = _F_COMPRESSED | (_F_SIGN if _y_is_lexi_larger(y) else 0)
    out = bytearray(x1.to_bytes(48, "big") + x0.to_bytes(48, "big"))
    out[0] |= flags
    return bytes(out)


def bls_g2_decompress(data: bytes):
    """96-byte compressed G2 (x_c1 || x_c0) -> affine pair | None."""
    if len(data) != 96:
        raise ValueError("bls12381 G2 point must be 96 bytes")
    flags = data[0]
    if not flags & _F_COMPRESSED:
        raise ValueError("uncompressed G2 encoding not supported")
    body = bytes([data[0] & 0x1F]) + data[1:]
    if flags & _F_INFINITY:
        if any(body) or flags & _F_SIGN:
            raise ValueError("malformed G2 infinity encoding")
        return None
    x1 = int.from_bytes(body[:48], "big")
    x0 = int.from_bytes(body[48:], "big")
    if x0 >= _P or x1 >= _P:
        raise ValueError("G2 x out of range")
    x = (x0, x1)
    y = f2_sqrt(f2_add(f2_mul(f2_sq(x), x), _B2))
    if y is None:
        raise ValueError("G2 x not on curve")
    if bool(flags & _F_SIGN) != _y_is_lexi_larger(y):
        y = f2_neg(y)
    return (x, y)


# ---- the signature scheme (min-pubkey-size, PoP-style aggregation) -----


def bls_pub_from_priv(sk: int) -> bytes:
    return bls_g1_compress(
        _ec_affine(_FpOps, _ec_mul(_FpOps, sk % BLS_R, _ec_from_affine(BLS_G1))))


def bls_pubkey_validate(pub: bytes) -> bool:
    """KeyValidate: decodes, rejects infinity (the zero/identity pubkey
    forges any aggregate) and points outside the r-order subgroup."""
    try:
        aff = bls_g1_decompress(pub)
    except ValueError:
        return False
    if aff is None:
        return False
    return _ec_mul(_FpOps, BLS_R, _ec_from_affine(aff)) is None


def bls_signature_validate(sig: bytes):
    """Decode + validate a G2 signature point: subgroup-checked, infinity
    rejected. Returns the affine point or None when invalid."""
    try:
        aff = bls_g2_decompress(sig)
    except ValueError:
        return None
    if aff is None:
        return None
    if _ec_mul(_Fp2Ops, BLS_R, _ec_from_affine(aff)) is not None:
        return None
    return aff


def bls_sign(sk: int, msg: bytes, dst: bytes) -> bytes:
    h = bls_hash_to_g2(msg, dst)
    return bls_g2_compress(
        _ec_affine(_Fp2Ops, _ec_mul(_Fp2Ops, sk % BLS_R, _ec_from_affine(h))))


_NEG_G1 = (BLS_G1[0], _P - BLS_G1[1])


def bls_verify(pub: bytes, msg: bytes, sig: bytes, dst: bytes) -> bool:
    """CoreVerify: e(g1, sig) == e(pk, H(msg)) via one pairing product."""
    if not bls_pubkey_validate(pub):
        return False
    sig_aff = bls_signature_validate(sig)
    if sig_aff is None:
        return False
    pk_aff = bls_g1_decompress(pub)
    h = bls_hash_to_g2(msg, dst)
    return bls_pairing_product_is_one([(_NEG_G1, sig_aff), (pk_aff, h)])


def bls_aggregate(sigs) -> bytes:
    """Sum the signature points. Raises ValueError when any input fails
    to DECODE (off-curve, non-canonical, malformed flags) or is the
    infinity point. Per-signature SUBGROUP checks are deliberately not
    repeated here: the aggregate itself is subgroup-checked by
    bls_aggregate_verify (which is what the pairing equation constrains
    — only the SUM enters it), and individual subgroup membership is
    enforced where signatures are admitted one at a time (bls_verify /
    the batched single-verify path). This is what keeps commit
    aggregation O(n) cheap point adds instead of n scalar-mul subgroup
    scans."""
    acc = None
    for s in sigs:
        try:
            aff = bls_g2_decompress(bytes(s))
        except ValueError:
            aff = None
        if aff is None:
            raise ValueError("bls12381 aggregate: invalid signature input")
        acc = _ec_add(_Fp2Ops, acc, _ec_from_affine(aff))
    if acc is None:
        raise ValueError("bls12381 aggregate: empty input")
    return bls_g2_compress(_ec_affine(_Fp2Ops, acc))


def bls_aggregate_verify(pubs, msgs, sig: bytes, dst: bytes) -> bool:
    """PoP-flavor AggregateVerify: messages may repeat (same-sign-bytes
    votes aggregate their pubkeys), every pubkey must KeyValidate, the
    aggregate signature must be a subgroup point and not infinity. One
    pairing-product check with a single final exponentiation:

        e(g1, sig) == prod over distinct m of e(sum pk_i[m_i == m], H(m))
    """
    if len(pubs) != len(msgs) or not pubs:
        return False
    sig_aff = bls_signature_validate(sig)
    if sig_aff is None:
        return False
    groups: dict[bytes, list] = {}
    for pub, msg in zip(pubs, msgs):
        if not bls_pubkey_validate(bytes(pub)):
            return False
        groups.setdefault(bytes(msg), []).append(bls_g1_decompress(bytes(pub)))
    pairs = [(_NEG_G1, sig_aff)]
    for msg, pk_affs in groups.items():
        acc = None
        for aff in pk_affs:
            acc = _ec_add(_FpOps, acc, _ec_from_affine(aff))
        if acc is None:  # pragma: no cover - groups are never empty
            return False
        pk_sum = _ec_affine(_FpOps, acc)
        if pk_sum is None:
            # pubkeys in one message group cancelled to infinity: the
            # group contributes nothing and the check degenerates —
            # reject loudly rather than accept a forgeable shape
            return False
        pairs.append((pk_sum, bls_hash_to_g2(msg, dst)))
    return bls_pairing_product_is_one(pairs)
