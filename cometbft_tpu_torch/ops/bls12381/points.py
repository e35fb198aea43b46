"""G1/G2 point arithmetic on the batch axis: the port's copy of
cometbft_tpu/ops/bls12381/points.py.

Complete projective formulas (Renes-Costello-Batina 2015, algorithms 7 and 9
for a = 0) over a field adapter: identity, doubling and adversarial inputs
take the same instruction path. G1 runs over fp tensors, G2 over fp2
tensors. The only scalars multiplied here are fixed public constants (the
subgroup order r, the G2 cofactor).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from cometbft_tpu_torch.crypto import bls12381_math as _oracle
from cometbft_tpu_torch.ops.bls12381 import fp, fp2


class G1Field:
    """Field adapter: fp over (..., 35, B) tensors."""

    add = staticmethod(fp.add)
    sub = staticmethod(fp.sub)
    mul = staticmethod(fp.mul)
    sq = staticmethod(fp.sq)
    neg = staticmethod(fp.neg)
    select = staticmethod(fp.select)
    is_zero = staticmethod(fp.is_zero)
    mul_small = staticmethod(fp.mul_small)
    inv = staticmethod(fp.inv)

    @staticmethod
    def mul_b3(a):  # 3 * b = 12: a limb scaling, never a field mul
        return fp.mul_small(a, 12)

    @staticmethod
    def zero_like(a):
        return torch.zeros_like(a)

    @staticmethod
    def one_like(a):
        return fp.one_like(a)


class G2Field:
    """Field adapter: fp2 over (..., 2, 35, B) tensors."""

    add = staticmethod(fp2.add)
    sub = staticmethod(fp2.sub)
    mul = staticmethod(fp2.mul)
    sq = staticmethod(fp2.sq)
    neg = staticmethod(fp2.neg)
    select = staticmethod(fp2.select)
    is_zero = staticmethod(fp2.is_zero)
    mul_small = staticmethod(fp2.mul_small)
    inv = staticmethod(fp2.inv)

    @staticmethod
    def mul_b3(a):  # 3 * b = 12(1 + u): limb scaling + xi rotation
        return fp2.mul_xi(fp2.mul_small(a, 12))

    @staticmethod
    def zero_like(a):
        return torch.zeros_like(a)

    @staticmethod
    def one_like(a):
        return fp2.one_like(a)


def _stack(parts) -> torch.Tensor:
    return torch.stack(list(parts))


class Point(NamedTuple):
    """Projective (X : Y : Z); identity = (0 : 1 : 0)."""

    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor


def identity_like(F, coord) -> Point:
    return Point(F.zero_like(coord), F.one_like(coord), F.zero_like(coord))


def from_affine(F, x, y) -> Point:
    return Point(x, y, F.one_like(y))


def neg_point(F, p: Point) -> Point:
    return Point(p.x, F.neg(p.y), p.z)


def is_identity(F, p: Point) -> torch.Tensor:
    return F.is_zero(p.z)


def add(F, p: Point, q: Point) -> Point:
    """RCB 2015 algorithm 7 (complete, a = 0), multiplies stacked in two
    dependency layers of six."""
    pq = F.add(_stack([p.x, p.y, p.x]), _stack([p.y, p.z, p.z]))
    qq = F.add(_stack([q.x, q.y, q.x]), _stack([q.y, q.z, q.z]))
    l1 = F.mul(_stack([p.x, p.y, p.z, *pq.unbind(0)]), _stack([q.x, q.y, q.z, *qq.unbind(0)]))
    t0, t1, t2, mxy, myz, mxz = l1.unbind(0)
    t3 = F.sub(mxy, F.add(t0, t1))
    t4 = F.sub(myz, F.add(t1, t2))
    y3 = F.sub(mxz, F.add(t0, t2))
    x3 = F.mul_small(t0, 3)
    t2b = F.mul_b3(t2)
    z3 = F.add(t1, t2b)
    t1b = F.sub(t1, t2b)
    y3b = F.mul_b3(y3)
    p1, p2, p3, p4, p5, p6 = F.mul(_stack([t3, t4, y3b, t1b, z3, x3]),
                                   _stack([t1b, y3b, x3, z3, t4, t3])).unbind(0)
    return Point(F.sub(p1, p2), F.add(p3, p4), F.add(p5, p6))


def dbl(F, p: Point) -> Point:
    """RCB 2015 algorithm 9 (complete doubling, a = 0), two stacked
    multiply layers of four."""
    t0, t1, zz, txy = F.mul(_stack([p.y, p.y, p.z, p.x]), _stack([p.y, p.z, p.z, p.y])).unbind(0)
    t2 = F.mul_b3(zz)
    z8 = F.mul_small(t0, 8)
    y3 = F.add(t0, t2)
    t0b = F.sub(t0, F.mul_small(t2, 3))
    x3, z3, q3, q4 = F.mul(_stack([t2, t1, t0b, t0b]), _stack([z8, z8, y3, txy])).unbind(0)
    return Point(F.mul_small(q4, 2), F.add(x3, q3), z3)


def mul_const(F, p: Point, e: int) -> Point:
    """[e]P for a fixed public scalar: double-and-add MSB first (complete
    formulas: no special cases along the ladder)."""
    assert e >= 0
    acc = identity_like(F, p.y)
    for bit in fp.bits_desc(e):
        acc = dbl(F, acc)
        if bit:
            acc = add(F, acc, p)
    return acc


def in_subgroup(F, p: Point) -> torch.Tensor:
    """[r]P == O (the identity itself counts: callers reject infinity
    where the scheme does)."""
    return is_identity(F, mul_const(F, p, _oracle.BLS_R))


def on_curve(F, p: Point) -> torch.Tensor:
    """Projective membership: 3 (Y^2 Z) == 3 X^3 + b3 Z^3. The identity
    (0 : 1 : 0) satisfies it."""
    x3, z3, yyz = F.mul(F.sq(_stack([p.x, p.z, p.y])), _stack([p.x, p.z, p.z])).unbind(0)
    lhs = F.mul_small(yyz, 3)
    rhs = F.add(F.mul_small(x3, 3), F.mul_b3(z3))
    return F.is_zero(F.sub(lhs, rhs))


def to_affine(F, p: Point):
    """(x, y, is_identity): identity lanes read (0, 0)."""
    zi = F.inv(p.z)
    xy = F.mul(_stack([p.x, p.y]), zi)
    return xy[0], xy[1], is_identity(F, p)


def sum_tree(F, p: Point) -> Point:
    """Reduce a batch of points to one lane by halving adds (an odd count
    pads its high half with one identity lane). Returns a 1-lane Point."""
    while p.x.shape[-1] > 1:
        n = p.x.shape[-1]
        half = (n + 1) // 2
        lo = Point(*(a[..., :half] for a in p))
        hi = Point(*(a[..., half:] for a in p))
        if n % 2:
            ident = identity_like(F, lo.y[..., :1])
            hi = Point(*(torch.cat([a, b], -1) for a, b in zip(hi, ident)))
        p = add(F, lo, hi)
    return p


# ---- compressed-point staging -------------------------------------------


def g1_decompress(x_raw: torch.Tensor, sign_bit: torch.Tensor) -> tuple[torch.Tensor, Point]:
    """(35, B) raw x limbs and per-lane sign flags -> (ok, affine-Z1
    projective Point). The structural flag, range and infinity checks are
    the host's (ops/bls_kernel staging); this is the field half:
    y = sqrt(x^3 + 4), sign-selected; ok says the root exists."""
    x = fp.to_mont(x_raw)
    ok, y = fp.sqrt(fp.add(fp.mul(fp.sq(x), x), fp.const_like(4, x)))
    flip = _lexi_larger_fp(y) != (sign_bit != 0)
    return ok, from_affine(G1Field, x, fp.select(flip, fp.neg(y), y))


def g2_decompress(x0_raw: torch.Tensor, x1_raw: torch.Tensor, sign_bit: torch.Tensor
                  ) -> tuple[torch.Tensor, Point]:
    """The G2 counterpart: x = (x0, x1) raw limb planes, y by the Fp2 root."""
    x = fp.to_mont(torch.stack([x0_raw, x1_raw], -3))
    ok, y = fp2.sqrt(fp2.add(fp2.mul(fp2.sq(x), x), fp2.const_like(fp2.B2, x)))
    flip = _lexi_larger_fp2(y) != (sign_bit != 0)
    return ok, from_affine(G2Field, x, fp2.select(flip, fp2.neg(y), y))


def _lexi_larger_fp(y_mont: torch.Tensor) -> torch.Tensor:
    return fp.gt_half(fp.from_mont(y_mont))


def _lexi_larger_fp2(y: torch.Tensor) -> torch.Tensor:
    """The serialization's sign rule: the imaginary part decides unless it
    is zero (unlike sgn0, which looks at the real part first)."""
    r = fp.from_mont(y)
    ra, rb = fp2.re(r), fp2.im(r)
    return torch.where((rb == 0).all(-2), fp.gt_half(ra), fp.gt_half(rb))
