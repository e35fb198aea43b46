"""Fp6/Fp12 towers on the batch axis: the port's copy of
cometbft_tpu/ops/bls12381/tower.py (Fp6 = Fp2[v]/(v^3 - xi), Fp12 =
Fp6[w]/(w^2 - v)). An Fp6 is a (..., 3, 2, 35, B) tensor [c0, c1, c2], an
Fp12 a (..., 2, 3, 2, 35, B) tensor [d0, d1]. The Frobenius constants are
lifted from the oracle's computed gammas, never transcribed."""

from __future__ import annotations

import torch

from cometbft_tpu_torch.crypto import bls12381_math as _oracle
from cometbft_tpu_torch.ops.bls12381 import fp, fp2

F6 = -4  # the Fp6 component axis
F12 = -5  # the Fp12 component axis


def c(x: torch.Tensor, i: int) -> torch.Tensor:
    """Component i of an Fp6."""
    return x.select(F6, i)


def d(x: torch.Tensor, i: int) -> torch.Tensor:
    """Component i of an Fp12."""
    return x.select(F12, i)


def f6(c0, c1, c2) -> torch.Tensor:
    return torch.stack([c0, c1, c2], F6)


def f12(d0, d1) -> torch.Tensor:
    return torch.stack([d0, d1], F12)


f6_add = fp.add
f6_sub = fp.sub
f6_neg = fp.neg


def f6_mul(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Toom-style interpolation with the six Fp2 products in one stacked
    fp2.mul (18 Fp products in one conv)."""
    x, y = torch.broadcast_tensors(x, y)

    def operands(z):
        z0, z1, z2 = c(z, 0), c(z, 1), c(z, 2)
        sums = fp2.add(torch.stack([z1, z0, z0]), torch.stack([z2, z1, z2]))
        return torch.stack([z0, z1, z2, *sums.unbind(0)])

    t0, t1, t2, m12, m01, m02 = fp2.mul(operands(x), operands(y)).unbind(0)
    c0 = fp2.add(t0, fp2.mul_xi(fp2.sub(m12, fp2.add(t1, t2))))
    c1 = fp2.add(fp2.sub(m01, fp2.add(t0, t1)), fp2.mul_xi(t2))
    c2 = fp2.add(fp2.sub(m02, fp2.add(t0, t2)), t1)
    return f6(c0, c1, c2)


def f6_mul_v(x: torch.Tensor) -> torch.Tensor:
    return f6(fp2.mul_xi(c(x, 2)), c(x, 0), c(x, 1))


def f6_inv(x: torch.Tensor) -> torch.Tensor:
    x0, x1, x2 = c(x, 0), c(x, 1), c(x, 2)
    p12, p01, p02 = fp2.mul(torch.stack([x1, x0, x0]), torch.stack([x2, x1, x2])).unbind(0)
    s0, s2, s1 = fp2.sq(torch.stack([x0, x2, x1])).unbind(0)
    c0 = fp2.sub(s0, fp2.mul_xi(p12))
    c1 = fp2.sub(fp2.mul_xi(s2), p01)
    c2 = fp2.sub(s1, p02)
    q0, q2, q1 = fp2.mul(torch.stack([x0, x2, x1]), torch.stack([c0, c1, c2])).unbind(0)
    t = fp2.inv(fp2.add(q0, fp2.mul_xi(fp2.add(q2, q1))))
    return fp2.mul(f6(c0, c1, c2), t.unsqueeze(F6))


def f6_one_like(x: torch.Tensor) -> torch.Tensor:
    z = fp2.zero_like(c(x, 0))
    return f6(fp2.one_like(c(x, 0)), z, z)


def f12_one_like(x: torch.Tensor) -> torch.Tensor:
    d0 = f6_one_like(d(x, 0))
    return f12(d0, torch.zeros_like(d0))


def f12_mul(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Karatsuba with the three Fp6 products in one stacked f6_mul."""
    x, y = torch.broadcast_tensors(x, y)
    x0, x1, y0, y1 = d(x, 0), d(x, 1), d(y, 0), d(y, 1)
    t0, t1, t3 = f6_mul(torch.stack([x0, x1, f6_add(x0, x1)]),
                        torch.stack([y0, y1, f6_add(y0, y1)])).unbind(0)
    return f12(f6_add(t0, f6_mul_v(t1)), f6_sub(f6_sub(t3, t0), t1))


def f12_sq(x: torch.Tensor) -> torch.Tensor:
    """Complex squaring: the two Fp6 products in one stacked f6_mul."""
    x0, x1 = d(x, 0), d(x, 1)
    t0, a = f6_mul(torch.stack([x0, f6_add(x0, x1)]),
                   torch.stack([x1, f6_add(x0, f6_mul_v(x1))])).unbind(0)
    return f12(f6_sub(f6_sub(a, t0), f6_mul_v(t0)), f6_add(t0, t0))


def f12_conj(x: torch.Tensor) -> torch.Tensor:
    return f12(d(x, 0), f6_neg(d(x, 1)))


def f12_inv(x: torch.Tensor) -> torch.Tensor:
    s0, s1 = f6_mul(torch.stack([d(x, 0), d(x, 1)]), torch.stack([d(x, 0), d(x, 1)])).unbind(0)
    t = f6_inv(f6_sub(s0, f6_mul_v(s1)))
    m0, m1 = f6_mul(torch.stack([d(x, 0), d(x, 1)]), t).unbind(0)
    return f12(m0, f6_neg(m1))


def f12_select(m: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.where(m[..., None, None, None, None, :], x, y)


def f12_eq_one(x: torch.Tensor) -> torch.Tensor:
    """(..., B) mask: x == 1."""
    return fp2.is_zero(fp.sub(x, f12_one_like(x))).all(-2).all(-2)


def _gamma(n: int, k: int):
    """xi^(k (p^n - 1) / 6): the oracle's gammas for n = 1, else computed
    with its f2_pow."""
    if n == 1:
        return _oracle._FROB_G1[k]
    return _oracle.f2_pow(_oracle.BLS_XI, k * (_oracle.BLS_P ** n - 1) // 6)


def frob_gammas(n: int) -> list:
    """The six gammas of f12_frob(., n), in the order of the coefficients
    [d0.c0, d0.c1, d0.c2, d1.c0, d1.c1, d1.c2] (powers 0, 2, 4, 1, 3, 5)."""
    return [_gamma(n, k) for k in (0, 2, 4, 1, 3, 5)]


def f12_frob(x: torch.Tensor, n: int = 1) -> torch.Tensor:
    """x^(p^n): coefficients conjugated for odd n, times the gammas."""
    coef = x.flatten(F12, F6)  # (..., 6, 2, 35, B)
    if n % 2:
        coef = fp2.conj(coef)
    g = torch.stack([fp2.const_like(gm, coef[..., 0, :, :, :]) for gm in frob_gammas(n)], -4)
    return fp2.mul(coef, g).unflatten(-4, (2, 3))


def f12_exp_const(x: torch.Tensor, e: int) -> torch.Tensor:
    """x^e for a fixed nonnegative exponent."""
    assert e >= 0
    acc = f12_one_like(x)
    for bit in fp.bits_desc(e):
        acc = f12_sq(acc)
        if bit:
            acc = f12_mul(acc, x)
    return acc


def from_oracle(els, device=None) -> torch.Tensor:
    """Oracle nested-tuple Fp12 elements -> a (2, 3, 2, 35, B) batch."""
    comps = [fp2.from_ints([e[i][j] for e in els], device) for i in range(2) for j in range(3)]
    return torch.stack(comps).unflatten(0, (2, 3))


def to_oracle(x: torch.Tensor) -> list:
    """A (2, 3, 2, 35, B) batch -> oracle nested tuples."""
    comps = [fp2.to_ints(x[i, j]) for i in range(2) for j in range(3)]
    return [((comps[0][k], comps[1][k], comps[2][k]), (comps[3][k], comps[4][k], comps[5][k]))
            for k in range(len(comps[0]))]
