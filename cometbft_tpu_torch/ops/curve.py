"""edwards25519 point operations on (20, B) limb tensors — the plain version.

A point is (X, Y, Z, T) extended homogeneous coordinates, each a (20, B)
carried limb tensor (field.py); one lane = one point. All formulas are
complete (add-2008-hwcd-3 for a=-1, dbl-2008-hwcd), so identity, equal and
small-order inputs take the same path as honest ones. Semantics mirror the
host oracles (crypto/ed25519_math.py; crypto/sr25519_math.py for the
ristretto255 decode). The CUDA kernels run the same sequence of field
operations per thread.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from cometbft_tpu_torch.crypto import ed25519_math as oracle
from cometbft_tpu_torch.ops import field as F
from cometbft_tpu_torch.ops import limbs as L
from cometbft_tpu_torch.ops import unpack as U


class Point(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor
    t: torch.Tensor


def identity_like(a: torch.Tensor) -> Point:
    zero = torch.zeros_like(a)
    one = zero + F.const("ONE", a.device)
    return Point(zero, one, one, zero)


def add(p: Point, q: Point) -> Point:
    """add-2008-hwcd-3 (unified, a=-1). ~9 field muls."""
    a = F.mul(F.sub(p.y, p.x), F.sub(q.y, q.x))
    b = F.mul(F.add(p.y, p.x), F.add(q.y, q.x))
    c = F.mul(F.mul(p.t, F.const("D2", p.t.device)), q.t)
    zz = F.mul(p.z, q.z)
    d = F.add(zz, zz)
    e = F.sub(b, a)
    f = F.sub(d, c)
    g = F.add(d, c)
    h = F.add(b, a)
    return Point(F.mul(e, f), F.mul(g, h), F.mul(f, g), F.mul(e, h))


def double(p: Point) -> Point:
    """dbl-2008-hwcd. 4 squarings + 4 muls. Never reads p.t."""
    a = F.sq(p.x)
    b = F.sq(p.y)
    zz = F.sq(p.z)
    c = F.add(zz, zz)
    h = F.add(a, b)
    e = F.sub(h, F.sq(F.add(p.x, p.y)))
    g = F.sub(a, b)
    f = F.add(c, g)
    return Point(F.mul(e, f), F.mul(g, h), F.mul(f, g), F.mul(e, h))


def double_no_t(p: Point) -> Point:
    """double without T (4 sq + 3 muls). The returned T is zeros and must
    not feed an add."""
    a = F.sq(p.x)
    b = F.sq(p.y)
    zz = F.sq(p.z)
    c = F.add(zz, zz)
    h = F.add(a, b)
    e = F.sub(h, F.sq(F.add(p.x, p.y)))
    g = F.sub(a, b)
    f = F.add(c, g)
    return Point(F.mul(e, f), F.mul(g, h), F.mul(f, g), torch.zeros_like(p.x))


def neg(p: Point) -> Point:
    return Point(F.neg(p.x), p.y, p.z, F.neg(p.t))


def add_pre(p: Point, q_pre: Point, out_t: bool = True) -> Point:
    """add-2008-hwcd-3 where q.t is premultiplied by D2: 8 muls, 7 without
    the output T. p.t is the true extended coordinate."""
    a = F.mul(F.sub(p.y, p.x), F.sub(q_pre.y, q_pre.x))
    b = F.mul(F.add(p.y, p.x), F.add(q_pre.y, q_pre.x))
    c = F.mul(p.t, q_pre.t)
    zz = F.mul(p.z, q_pre.z)
    d = F.add(zz, zz)
    e = F.sub(b, a)
    f = F.sub(d, c)
    g = F.add(d, c)
    h = F.add(b, a)
    t = F.mul(e, h) if out_t else torch.zeros_like(p.x)
    return Point(F.mul(e, f), F.mul(g, h), F.mul(f, g), t)


def madd_pre(p: Point, q_pre: Point, out_t: bool = True) -> Point:
    """Mixed add: q affine (Z=1) with premultiplied T — 7 muls, 6 without
    the output T."""
    a = F.mul(F.sub(p.y, p.x), F.sub(q_pre.y, q_pre.x))
    b = F.mul(F.add(p.y, p.x), F.add(q_pre.y, q_pre.x))
    c = F.mul(p.t, q_pre.t)
    d = F.add(p.z, p.z)
    e = F.sub(b, a)
    f = F.sub(d, c)
    g = F.add(d, c)
    h = F.add(b, a)
    t = F.mul(e, h) if out_t else torch.zeros_like(p.x)
    return Point(F.mul(e, f), F.mul(g, h), F.mul(f, g), t)


def mul_by_cofactor(p: Point) -> Point:
    return double(double(double(p)))


def is_identity(p: Point) -> torch.Tensor:
    """(B,) bool: projective identity — X == 0 and Y == Z mod p."""
    return F.is_zero(p.x) & F.is_zero(F.sub(p.y, p.z))


def decompress_zip215(y: torch.Tensor, sign: torch.Tensor) -> tuple[torch.Tensor, Point]:
    """ZIP-215 decompression: y taken mod p (non-canonical encodings
    accepted), x recovered per RFC 8032 5.1.3. Returns (ok (B,) bool,
    point); where ok is False the coordinates are garbage and the caller
    masks. Oracle: ed25519_math.point_decompress_zip215."""
    dev = y.device
    yy = F.sq(y)
    one = torch.zeros_like(yy) + F.const("ONE", dev)
    u = F.sub(yy, one)
    v = F.add(F.mul(F.const("D", dev).expand_as(yy), yy), one)
    v3 = F.mul(F.sq(v), v)
    v7 = F.mul(F.sq(v3), v)
    x = F.mul(F.mul(u, v3), F.pow22523(F.mul(u, v7)))
    vxx = F.mul(v, F.sq(x))
    root1 = F.is_zero(F.sub(vxx, u))       # v*x^2 == u
    root2 = F.is_zero(F.add(vxx, u))       # v*x^2 == -u -> x *= sqrt(-1)
    x = torch.where(root1[None], x,
                    F.mul(x, F.const("SQRT_M1", dev).expand_as(x)))
    ok = root1 | root2
    xc = F.canonicalize(x)
    x_zero = (xc == 0).all(dim=0)
    ok = ok & ~(x_zero & (sign == 1))      # x=0 with sign bit set: reject
    flip = (xc[0] & 1) != sign
    x = torch.where(flip[None], F.neg(x), x)
    return ok, Point(x, y, one, F.mul(x, y))


# ---------------------------------------------------------------------------
# ristretto255 DECODE (the sr25519 pubkey and R decoding), lane-parallel:
# the counterpart of cometbft_tpu/ops/sr25519_kernel.py sqrt_ratio_m1 and
# ristretto_decode_device. Oracle: sr25519_math.ristretto_decode.
# ---------------------------------------------------------------------------


def _is_canonical_even(s: torch.Tensor, hi_bit: torch.Tensor) -> torch.Tensor:
    """ristretto255 DECODE preconditions: s < p, s even (nonnegative), bit
    255 clear."""
    is_canon = (F.canonicalize(s) == s).all(dim=0)
    even = (s[0] & 1) == 0
    return is_canon & even & (hi_bit == 0)


def sqrt_ratio_m1(u: torch.Tensor, v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """SQRT_RATIO_M1 over lanes: (was_square (B,) bool, the nonnegative
    root (20, B))."""
    sqrt_m1 = F.const("SQRT_M1", u.device).expand_as(u)
    v3 = F.mul(F.sq(v), v)
    v7 = F.mul(F.sq(v3), v)
    r = F.mul(F.mul(u, v3), F.pow22523(F.mul(u, v7)))
    check = F.mul(v, F.sq(r))
    correct = F.is_zero(F.sub(check, u))
    flipped = F.is_zero(F.add(check, u))
    flipped_i = F.is_zero(F.add(check, F.mul(u, sqrt_m1)))
    r = torch.where((flipped | flipped_i)[None], F.mul(r, sqrt_m1), r)
    was_square = correct | flipped
    # CT_ABS: take the even root
    r = torch.where((F.parity(r) == 1)[None], F.neg(r), r)
    return was_square, r


def ristretto_decode_device(w: torch.Tensor) -> tuple[torch.Tensor, Point]:
    """(8, B) int32 packed encodings -> (ok (B,) bool, extended point with
    (20, B) coordinates). Lane-parallel sr25519_math.ristretto_decode;
    where ok is False the coordinates are garbage and the caller masks."""
    s, hi = U.words_to_y_limbs(w), U.words_sign(w)
    pre_ok = _is_canonical_even(s, hi)
    one = torch.zeros_like(s) + F.const("ONE", s.device)
    ss = F.sq(s)
    u1 = F.sub(one, ss)
    u2 = F.add(one, ss)
    u2_sqr = F.sq(u2)
    d = F.const("D", s.device).expand_as(s)
    v = F.sub(F.neg(F.mul(F.mul(d, u1), u1)), u2_sqr)
    was_square, invsqrt = sqrt_ratio_m1(one, F.mul(v, u2_sqr))
    den_x = F.mul(invsqrt, u2)
    den_y = F.mul(F.mul(invsqrt, den_x), v)
    x = F.mul(F.add(s, s), den_x)
    x = torch.where((F.parity(x) == 1)[None], F.neg(x), x)
    y = F.mul(u1, den_y)
    t = F.mul(x, y)
    ok = pre_ok & was_square & (F.parity(t) == 0) & ~F.is_zero(y)
    return ok, Point(x, y, one, t)


# ---------------------------------------------------------------------------
# Signed 5-bit ladder: 51 windows x (5 doublings + 2 adds), digits in
# [-16, 15] (unpack.words_to_digits5_signed). A negative digit selects the
# negated entry (x and t sign flip), so each table keeps 17 entries.
# ---------------------------------------------------------------------------

TABLE17 = 17  # entries 0..16


def base_table17_limbs() -> np.ndarray:
    """[d]B for d in 0..16, affine with premultiplied T: (4, 17, 20) int32
    limbs of (x, y, z=1, t*2d). The kernel's shared-memory table holds the
    same values."""
    coords = np.zeros((4, TABLE17, L.NLIMBS), dtype=np.int32)
    acc = oracle.IDENTITY
    for d in range(TABLE17):
        if d:
            acc = oracle.point_add(acc, oracle.B_POINT)
        zinv = pow(acc[2], oracle.P - 2, oracle.P)
        x = acc[0] * zinv % oracle.P
        y = acc[1] * zinv % oracle.P
        for ci, v in enumerate((x, y, 1, x * y % oracle.P * oracle.D2 % oracle.P)):
            coords[ci, d] = L.int_to_limbs(v)
    return coords


_base_table_cache: dict[torch.device, tuple[torch.Tensor, ...]] = {}


def base_table17(device: torch.device) -> tuple[torch.Tensor, ...]:
    """The [d]B table as 4 tensors (17, 20, 1) on `device`."""
    t = _base_table_cache.get(device)
    if t is None:
        coords = base_table17_limbs()
        t = tuple(torch.from_numpy(coords[ci]).to(device)[:, :, None]
                  for ci in range(4))
        _base_table_cache[device] = t
    return t


def build_point_table17(a: Point) -> tuple[torch.Tensor, ...]:
    """{[0]A..[16]A} per lane with premultiplied T: coords (17, 20, B).
    15 point ops + one T-premul pass."""
    t = [identity_like(a.x), a]
    for d in range(2, TABLE17):
        t.append(double(t[d // 2]) if d % 2 == 0 else add(t[d - 1], a))
    d2 = F.const("D2", a.x.device).expand_as(a.x)
    t = [Point(p.x, p.y, p.z, F.mul(p.t, d2)) for p in t]
    return tuple(torch.stack([p[ci] for p in t], dim=0) for ci in range(4))


def _select17_signed(table: tuple[torch.Tensor, ...], digit: torch.Tensor) -> Point:
    """Signed lookup: entry |d| per lane, negated (x, t sign flip — valid
    for premultiplied t too) where d < 0. Tables are (17, 20, B) or
    (17, 20, 1) broadcast.

    Any int32 digit is defined as in the JAX package, whose lookup is a
    where-tree over bits 3..0 of |d| plus a fixup for 16: entry 16 where
    |d| == 16, else entry |d| & 15. The ladder's digits lie in [-16, 15],
    where that is |d|; the microbench feeds raw limbs."""
    neg_mask = (digit < 0)[None, :]
    mag = digit.abs()
    idx = torch.where(mag == 16, 16, mag & 15).to(torch.int64)
    b = digit.shape[0]
    idx = idx[None, None, :].expand(1, L.NLIMBS, b)
    x, y, z, t = (
        torch.gather(c.expand(TABLE17, L.NLIMBS, b), 0, idx)[0] for c in table)
    x = torch.where(neg_mask, F.neg(x), x)
    t = torch.where(neg_mask, F.neg(t), t)
    return Point(x, y, z, t)


def window_step(acc: Point, ds: torch.Tensor, dk: torch.Tensor, table_b,
                table_a, out_t: bool) -> Point:
    """One ladder window: 5 doublings (4 skipping T) + base madd + A add.
    out_t=False elides the A-add's T mul — legal on every window but the
    last, because the next window re-derives T in its final double()."""
    for _ in range(4):
        acc = double_no_t(acc)
    acc = double(acc)
    acc = madd_pre(acc, _select17_signed(table_b, ds), out_t=True)
    return add_pre(acc, _select17_signed(table_a, dk), out_t=out_t)


def windowed_double_scalar_signed(s_digits: torch.Tensor, k_digits: torch.Tensor,
                                  a: Point) -> Point:
    """[s]B + [k]A, signed 5-bit windows, most significant digit first.
    s_digits/k_digits: (51, B) int32 in [-16, 15], little-endian."""
    table_a = build_point_table17(a)
    table_b = base_table17(a.x.device)
    acc = identity_like(a.x)
    for i in range(s_digits.shape[0] - 1, 0, -1):
        acc = window_step(acc, s_digits[i], k_digits[i], table_b, table_a,
                          out_t=False)
    return window_step(acc, s_digits[0], k_digits[0], table_b, table_a,
                       out_t=True)
