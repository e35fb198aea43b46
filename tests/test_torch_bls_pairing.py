"""The port's plain BLS12-381 pairing-level layers (ops/bls12381/tower.py,
htc.py, pairing.py, points.in_subgroup) against the JAX package's exact
host oracle (cometbft_tpu/crypto/fallback.py), at one or two lanes: the JAX
package marks its own XLA versions of these `pairing` (their compile takes
minutes), so the oracle is the reference here, as in those tests. Exact
everywhere: the final exponentiation is the oracle's chain, so Fp12 values
compare equal, not merely both equal to one.
"""

from __future__ import annotations

import random

import pytest
import torch

from cometbft_tpu.crypto import bls12381 as jbls
from cometbft_tpu.crypto import fallback as jo
from cometbft_tpu_torch.ops.bls12381 import fp, fp2, htc, pairing, tower
from cometbft_tpu_torch.ops.bls12381 import points as pts

P = jo.BLS_P


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _g1(rng):
    return jo._ec_affine(jo._FpOps, jo._ec_mul(jo._FpOps, rng.randrange(1, jo.BLS_R),
                                               jo._ec_from_affine(jo.BLS_G1)))


def _g2(rng):
    return jo._ec_affine(jo._Fp2Ops, jo._ec_mul(jo._Fp2Ops, rng.randrange(1, jo.BLS_R),
                                                jo._ec_from_affine(jo.BLS_G2)))


def test_fp12_tower_matches_oracle():
    rng = random.Random(11)

    def rnd12():
        return tuple(tuple((rng.randrange(P), rng.randrange(P)) for _ in range(3))
                     for _ in range(2))

    xs, ys = [rnd12()], [rnd12()]
    X, Y = tower.from_oracle(xs), tower.from_oracle(ys)
    assert tower.to_oracle(tower.f12_mul(X, Y)) == [jo.f12_mul(xs[0], ys[0])]
    assert tower.to_oracle(tower.f12_sq(X)) == [jo.f12_sq(xs[0])]
    assert tower.to_oracle(tower.f12_inv(X)) == [jo.f12_inv(xs[0])]
    for n in (1, 2):
        assert tower.to_oracle(tower.f12_frob(X, n)) == [jo.f12_frob(xs[0], n)]
    assert tower.f12_eq_one(tower.f12_one_like(X)).tolist() == [True]
    assert tower.f12_eq_one(X).tolist() == [False]


def test_pairing_matches_oracle():
    """e(P, Q) through miller_loop and final_exp, value for value with
    bls_pairing, and the product of two Miller values (product_lanes) of
    e(P, Q) e(-P, Q), which is one."""
    rng = random.Random(17)
    a1, a2 = _g1(rng), _g2(rng)
    px = fp.from_ints([a1[0], a1[0]])
    py = fp.from_ints([a1[1], P - a1[1]])
    qx, qy = fp2.from_ints([a2[0]] * 2), fp2.from_ints([a2[1]] * 2)
    f = pairing.miller_loop(px, py, qx, qy)
    e = pairing.final_exp(torch.cat([f[..., :1], pairing.product_lanes(f)], -1))
    assert tower.to_oracle(e) == [jo.bls_pairing(a1, a2), jo.F12_ONE]


def test_hash_to_g2_and_svdw_match_oracle():
    """The SvdW map on u = 0 and a random u, and the whole hash-to-G2 of the
    empty message, against the oracle."""
    consts = jo._bls_setup()["svdw"]
    us = [(0, 0), (random.Random(16).randrange(P), 5)]
    x, y, ident = pts.to_affine(pts.G2Field, htc.svdw_map(fp2.from_ints(us)))
    assert not ident.any()
    assert list(zip(fp2.to_ints(x), fp2.to_ints(y))) == [jo._svdw_map_fp2(u, consts) for u in us]
    x, y, ident = pts.to_affine(pts.G2Field, htc.hash_to_g2([b""], jbls.DST))
    assert list(zip(fp2.to_ints(x), fp2.to_ints(y))) == [jo.bls_hash_to_g2(b"", jbls.DST)]
    assert htc.expand_messages([b"abc"], jbls.DST)[0] == jo.bls_expand_message_xmd(
        b"abc", jbls.DST, 256)


def test_subgroup_check_accepts_real_rejects_low_order():
    """(0, 2) lies on y^2 = x^3 + 4 with order 3: on the curve, outside G1;
    the identity counts as in the subgroup, as in the reference."""
    a = _g1(random.Random(14))
    p = pts.from_affine(pts.G1Field, fp.from_ints([a[0], 0]), fp.from_ints([a[1], 2]))
    assert pts.on_curve(pts.G1Field, p).tolist() == [True, True]
    assert pts.in_subgroup(pts.G1Field, p).tolist() == [True, False]
    ident = pts.identity_like(pts.G1Field, p.y[..., :1])
    assert pts.in_subgroup(pts.G1Field, ident).tolist() == [True]


def test_sum_tree_matches_oracle():
    """sum_tree over an odd count of points (an identity pads the high
    half) equals the oracle's sum."""
    rng = random.Random(13)
    affs = [_g1(rng) for _ in range(3)]
    p = pts.from_affine(pts.G1Field, fp.from_ints([a[0] for a in affs]),
                        fp.from_ints([a[1] for a in affs]))
    x, y, ident = pts.to_affine(pts.G1Field, pts.sum_tree(pts.G1Field, p))
    acc = None
    for a in affs:
        acc = jo._ec_add(jo._FpOps, acc, jo._ec_from_affine(a))
    assert list(zip(fp.to_ints(x), fp.to_ints(y))) == [jo._ec_affine(jo._FpOps, acc)]
    assert not ident.any()
