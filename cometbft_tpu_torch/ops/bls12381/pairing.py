"""The optimal-ate pairing on the batch axis, one lane a pairing: the port's
copy of cometbft_tpu/ops/bls12381/pairing.py.

The Miller variable T walks the twist E'(Fp2) in projective coordinates; the
evaluated line lands in the same three sparse Fp12 slots as the oracle's
affine derivation (bls12381_math.bls_miller_loop), scaled each step by the
Fp2 factor 2YZ^2 (tangent) or X - xQ Z (chord). The final exponentiation
kills Fp2 scalings, so the affine oracle and this projective pipeline agree
exactly after it. The final exponentiation is the oracle's chain: easy part,
then (x-1)^2 (x+p) (x^2+p^2-1) + 3 (a cubed pairing), so values compare
equal to the oracle's, not merely both equal to one."""

from __future__ import annotations

import torch

from cometbft_tpu_torch.crypto import bls12381_math as _oracle
from cometbft_tpu_torch.ops.bls12381 import fp, fp2, tower
from cometbft_tpu_torch.ops.bls12381 import points as pts

X_BITS = [int(c) for c in bin(-_oracle.BLS_X)[2:]]


def line_f12(c0: torch.Tensor, c_vw: torch.Tensor, c_v2w: torch.Tensor) -> torch.Tensor:
    """The sparse line c0 + c_vw * v w + c_v2w * v^2 w as an Fp12."""
    z = torch.zeros_like(c0)
    hi = fp2.mul(torch.stack([c_vw, c_v2w]), fp2.const_like(_oracle._XI_INV, c0))
    return tower.f12(tower.f6(c0, z, z), tower.f6(z, hi[0], hi[1]))


def miller_loop(px: torch.Tensor, py: torch.Tensor, qx: torch.Tensor, qy: torch.Tensor
                ) -> torch.Tensor:
    """f_{|x|,Q}(P), conjugated (x < 0). px/py: (35, B) Montgomery affine G1
    coordinates; qx/qy: (2, 35, B) affine twist coordinates. Identity lanes
    must be kept out by the caller (the pairing with infinity is rejected
    upstream, as in the oracle)."""
    G2 = pts.G2Field
    t = pts.from_affine(G2, qx, qy)
    q = t
    f = tower.f12_one_like(torch.zeros((2, 3) + qx.shape, dtype=qx.dtype, device=qx.device))
    for bit in X_BITS[1:]:
        # tangent line at T, scaled by 2YZ^2
        X, Y, Z = t
        xx, yz, yy = fp2.mul(torch.stack([X, Y, Y]), torch.stack([X, Z, Y])).unbind(0)
        yzz, xxz, yyz = fp2.mul(torch.stack([yz, xx, yy]), Z).unbind(0)
        c0 = fp2.mul_fp(fp2.mul_small(yzz, 2), py)
        c_vw = fp2.sub(fp2.mul(xx, fp2.mul_small(X, 3)), fp2.mul_small(yyz, 2))
        c_v2w = fp2.neg(fp2.mul_fp(fp2.mul_small(xxz, 3), px))
        f = tower.f12_mul(tower.f12_sq(f), line_f12(c0, c_vw, c_v2w))
        t = pts.dbl(G2, t)
        if bit:
            # chord through (the new) T and Q, scaled by X - xQ Z
            X, Y, Z = t
            qxz, qyz, yqx, xqy = fp2.mul(torch.stack([qx, qy, Y, X]),
                                         torch.stack([Z, Z, qx, qy])).unbind(0)
            a_c0, a_v2w = fp2.mul_fp(torch.stack([fp2.sub(X, qxz), fp2.sub(Y, qyz)]),
                                     torch.stack([py, px])).unbind(0)
            a_vw = fp2.sub(yqx, xqy)
            f = tower.f12_mul(f, line_f12(a_c0, a_vw, fp2.neg(a_v2w)))
            t = pts.add(G2, t, q)
    return tower.f12_conj(f)


def _cyclo_exp(a: torch.Tensor, e: int) -> torch.Tensor:
    if e < 0:
        return tower.f12_exp_const(tower.f12_conj(a), -e)
    return tower.f12_exp_const(a, e)


def final_exp(f: torch.Tensor) -> torch.Tensor:
    """The oracle's bls_final_exp chain, term for term."""
    f = tower.f12_mul(tower.f12_conj(f), tower.f12_inv(f))
    f = tower.f12_mul(tower.f12_frob(f, 2), f)
    x = _oracle.BLS_X
    y = _cyclo_exp(_cyclo_exp(f, x - 1), x - 1)
    y = tower.f12_mul(_cyclo_exp(y, x), tower.f12_frob(y, 1))
    y2 = _cyclo_exp(_cyclo_exp(y, x), x)
    y = tower.f12_mul(tower.f12_mul(y2, tower.f12_frob(y, 2)), tower.f12_conj(y))
    return tower.f12_mul(y, tower.f12_mul(tower.f12_sq(f), f))


def product_lanes(f: torch.Tensor) -> torch.Tensor:
    """Multiply all lanes of an Fp12 batch down to one lane (a tree fold;
    an odd count pads with one)."""
    while f.shape[-1] > 1:
        n = f.shape[-1]
        half = (n + 1) // 2
        lo, hi = f[..., :half], f[..., half:]
        if n % 2:
            hi = torch.cat([hi, tower.f12_one_like(f[..., :1])], -1)
        f = tower.f12_mul(lo, hi)
    return f
