"""Fp2 = Fp[u]/(u^2 + 1) on the batch axis: the port's copy of
cometbft_tpu/ops/bls12381/fp2.py. An element is one (..., 2, 35, B) tensor
of Montgomery limbs, [c0, c1] on axis -3 (the reference's Fp2(a, b)); every
Fp operation that is lane-wise takes both components in one call."""

from __future__ import annotations

import torch

from cometbft_tpu_torch.crypto import bls12381_math as _oracle
from cometbft_tpu_torch.ops.bls12381 import fp


def re(x: torch.Tensor) -> torch.Tensor:
    return x[..., 0, :, :]


def im(x: torch.Tensor) -> torch.Tensor:
    return x[..., 1, :, :]


def make(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.stack([a, b], -3)


def const_like(c, like: torch.Tensor) -> torch.Tensor:
    """The oracle Fp2 constant c = (c0, c1) broadcast to `like`'s shape."""
    return make(fp.const_like(c[0], re(like)), fp.const_like(c[1], re(like)))


def zero_like(x: torch.Tensor) -> torch.Tensor:
    return torch.zeros_like(x)


def one_like(x: torch.Tensor) -> torch.Tensor:
    return make(fp.one_like(re(x)), torch.zeros_like(re(x)))


add = fp.add
sub = fp.sub
neg = fp.neg
mul_small = fp.mul_small


def mul(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Karatsuba with the three Fp products in one stacked fp.mul (the
    plain-sum third operand has limbs <= 2^13, inside the conv's bound)."""
    x, y = torch.broadcast_tensors(x, y)
    xa, xb, ya, yb = re(x), im(x), re(y), im(y)
    t0, t1, t2 = fp.mul(torch.stack([xa, xb, xa + xb]), torch.stack([ya, yb, ya + yb]))
    return make(fp.sub(t0, t1), fp.sub2(t2, t0, t1))


def sq(x: torch.Tensor) -> torch.Tensor:
    xa, xb = re(x), im(x)
    u, v = fp.mul(torch.stack([xa + xb, xa]), torch.stack([fp.sub(xa, xb), xb]))
    return make(u, fp.mul_small(v, 2))


def conj(x: torch.Tensor) -> torch.Tensor:
    return make(re(x), fp.neg(im(x)))


def mul_fp(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """x * k for k an Fp batch (..., 35, B)."""
    return fp.mul(x, k.unsqueeze(-3))


def mul_xi(x: torch.Tensor) -> torch.Tensor:
    """(1 + u) * x, the tower non-residue."""
    xa, xb = re(x), im(x)
    return make(fp.sub(xa, xb), fp.add(xa, xb))


def inv(x: torch.Tensor) -> torch.Tensor:
    """Fermat through the norm; inv(0) = 0."""
    s = fp.sq(x)
    n = fp.inv(fp.add(re(s), im(s)))
    m = fp.mul(x, n.unsqueeze(-3))
    return make(re(m), fp.neg(im(m)))


def is_zero(x: torch.Tensor) -> torch.Tensor:
    return fp.is_zero(x).all(-2)


def eq(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return is_zero(sub(x, y))


def select(m: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.where(m.unsqueeze(-2).unsqueeze(-2), x, y)


def pow_const(x: torch.Tensor, e: int) -> torch.Tensor:
    acc = one_like(x)
    for bit in fp.bits_desc(e):
        acc = sq(acc)
        if bit:
            acc = mul(acc, x)
    return acc


def _minus_one_like(a: torch.Tensor) -> torch.Tensor:
    return fp.const_like(fp.P_INT - 1, a)


def is_square(x: torch.Tensor) -> torch.Tensor:
    """norm(x)^((p-1)/2) != p - 1 (zero counts as a square)."""
    s = fp.sq(x)
    leg = fp.pow_const(fp.add(re(s), im(s)), (fp.P_INT - 1) // 2)
    return ~fp.eq(leg, _minus_one_like(leg))


def sqrt(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(ok, root): algorithm 9 of eprint 2012/685 for p = 3 mod 4,
    branch-free; ok is the final root check (False for non-squares)."""
    a1 = pow_const(x, (fp.P_INT - 3) // 4)
    alpha = mul(sq(a1), x)
    x0 = mul(a1, x)
    minus1 = make(_minus_one_like(re(x)), torch.zeros_like(re(x)))
    is_m1 = eq(alpha, minus1)
    # u * x0 branch vs (1 + alpha)^((p-1)/2) * x0 branch
    ux0 = make(fp.neg(im(x0)), re(x0))
    b = pow_const(add(one_like(x), alpha), (fp.P_INT - 1) // 2)
    cand = select(is_m1, ux0, mul(b, x0))
    return eq(sq(cand), x), cand


def sgn0(x: torch.Tensor) -> torch.Tensor:
    """RFC 9380 sgn0 for m = 2."""
    r = fp.from_mont(x)
    ra, rb = re(r), im(r)
    z0 = (ra == 0).all(-2).to(ra.dtype)
    return (ra[..., 0, :] & 1) | (z0 & (rb[..., 0, :] & 1))


def from_ints(pairs, device=None) -> torch.Tensor:
    """Oracle (c0, c1) int pairs -> a (2, 35, B) Montgomery batch."""
    return make(fp.from_ints([c[0] for c in pairs], device),
                fp.from_ints([c[1] for c in pairs], device))


def to_ints(x: torch.Tensor) -> list:
    """A (2, 35, B) batch -> oracle (c0, c1) int pairs."""
    return list(zip(fp.to_ints(re(x)), fp.to_ints(im(x))))


B2 = _oracle._B2  # the twist constant 4(1 + u)
