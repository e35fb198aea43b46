"""The port's plain BLS12-381 base layers against the JAX package's: the
field (ops/bls12381/fp.py), Fp2, the complete point formulas and G1
decompression bit for bit on limbs (the same radix-2^11 Montgomery
representation), host staging (bls_kernel.stage_batch_bls and
_structural_check) bit for bit, and the port's host oracle
(crypto/bls12381_math.py) against the JAX package's
(crypto/fallback.py) on signing, verification, (de)compression and
aggregation. Inputs are made from seeds with random.Random. Exact
everywhere.
"""

from __future__ import annotations

import functools
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cometbft_tpu.crypto import bls12381 as jbls
from cometbft_tpu.crypto import fallback as jo
from cometbft_tpu.ops import bls_kernel as JK
from cometbft_tpu.ops.bls12381 import fp as jfp
from cometbft_tpu.ops.bls12381 import fp2 as jfp2
from cometbft_tpu.ops.bls12381 import points as jpts
from cometbft_tpu_torch.crypto import bls12381 as tbls
from cometbft_tpu_torch.crypto import bls12381_math as to
from cometbft_tpu_torch.ops import bls_kernel as TK
from cometbft_tpu_torch.ops.bls12381 import fp, fp2
from cometbft_tpu_torch.ops.bls12381 import points as pts

P = to.BLS_P


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand(n, seed):
    rng = random.Random(seed)
    return [rng.randrange(P) for _ in range(n)]


def _mont(vals):
    return fp.ints_to_limbs([v * fp.R_MOD_P % P for v in vals])


def _same(t, j):
    assert np.array_equal(np.asarray(t), np.asarray(j))


def _jit(fn, *static):
    """The JAX function compiled once as a whole: run op by op, JAX compiles
    every primitive at every shape, which takes longer here."""
    return jax.jit(functools.partial(fn, *static))


def test_constants_equal_reference():
    assert (fp.R_MOD_P, fp.R2_MOD_P, fp.M_SUB_INT, fp.NPRIME_INT) == (
        jfp.R_MOD_P, jfp.R2_MOD_P, jfp.M_SUB_INT, jfp.NPRIME_INT)
    assert (to.BLS_P, to.BLS_R, to.BLS_X) == (jo.BLS_P, jo.BLS_R, jo.BLS_X)
    assert to._bls_setup()["svdw"] == jo._bls_setup()["svdw"]
    assert to._bls_setup()["h2"] == jo._bls_setup()["h2"]
    assert tbls.DST == jbls.DST


def test_fp_ops_bit_for_bit():
    xs = _rand(6, 1) + [0, 1, P - 1]
    ys = _rand(6, 2) + [P - 1] * 3
    X, Y = _mont(xs), _mont(ys)
    tx, ty, jx, jy = torch.from_numpy(X), torch.from_numpy(Y), jnp.asarray(X), jnp.asarray(Y)
    for tf, jf in ((fp.add, jfp.add), (fp.sub, jfp.sub), (fp.mul, jfp.mul)):
        _same(tf(tx, ty), jf(jx, jy))
    for tf, jf in ((fp.neg, jfp.neg), (fp.sq, jfp.sq), (fp.canon, jfp.canon),
                   (fp.from_mont, jfp.from_mont), (fp.sgn0, jfp.sgn0)):
        _same(tf(tx), jf(jx))
    _same(fp.sub2(tx, ty, tx), jfp.sub2(jx, jy, jx))
    _same(fp.mul_small(tx, 12), jfp.mul_small(jx, 12))
    _same(fp.to_mont(tx), jfp.to_mont(jx))
    _same(fp.inv(tx), jfp.inv(jx))
    ok, r = fp.sqrt(fp.sq(tx))
    assert ok.all() and [v * v % P for v in fp.to_ints(r)] == [v * v % P for v in xs]
    assert fp.to_ints(fp.mul(tx, ty)) == [a * b % P for a, b in zip(xs, ys)]


def test_fp_carried_limbs_stay_int32_safe_under_stress():
    """The reference's stress: products and add-sub chains keep limbs under
    2^13, limb for limb with the JAX module."""
    a, b = _mont(_rand(5, 3)), _mont(_rand(5, 4))
    ta, tb, ja, jb = torch.from_numpy(a), torch.from_numpy(b), jnp.asarray(a), jnp.asarray(b)

    @jax.jit
    def step(ja, jb):
        ja = jfp.mul(ja, jb)
        return ja, jfp.sub(jfp.add(jb, ja), jfp.sq(ja))

    for _ in range(25):
        ta = fp.mul(ta, tb)
        tb = fp.sub(fp.add(tb, ta), fp.sq(ta))
        ja, jb = step(ja, jb)
        assert int(tb.abs().max()) < (1 << 13)
    _same(ta, ja)
    _same(tb, jb)


def test_fp_bytes_packing_equals_reference():
    xs = _rand(7, 5) + [0, P - 1]
    be = np.stack([np.frombuffer(v.to_bytes(48, "big"), np.uint8) for v in xs])
    limbs = fp.bytes_be_to_limbs(be)
    _same(limbs, jfp.bytes_be_to_limbs(be))
    assert fp.limbs_to_ints(limbs) == xs
    _same(fp.limbs_to_bytes_be(limbs), be)


def _pairs(n, seed):
    rng = random.Random(seed)
    return [(rng.randrange(P), rng.randrange(P)) for _ in range(n)]


def test_fp2_ops_bit_for_bit():
    xs, ys = _pairs(5, 7) + [(0, 0)], _pairs(5, 8) + [(1, 0)]
    X = np.stack([_mont([a for a, _ in xs]), _mont([b for _, b in xs])])
    Y = np.stack([_mont([a for a, _ in ys]), _mont([b for _, b in ys])])
    tx, ty = torch.from_numpy(X), torch.from_numpy(Y)
    jx, jy = jfp2.Fp2(jnp.asarray(X[0]), jnp.asarray(X[1])), jfp2.Fp2(jnp.asarray(Y[0]),
                                                                       jnp.asarray(Y[1]))

    def same2(t, j):
        _same(t[0], j.a)
        _same(t[1], j.b)

    same2(fp2.mul(tx, ty), _jit(jfp2.mul)(jx, jy))
    same2(fp2.sq(tx), _jit(jfp2.sq)(jx))
    same2(fp2.add(tx, ty), _jit(jfp2.add)(jx, jy))
    same2(fp2.sub(tx, ty), _jit(jfp2.sub)(jx, jy))
    same2(fp2.mul_xi(tx), _jit(jfp2.mul_xi)(jx))
    same2(fp2.conj(tx), _jit(jfp2.conj)(jx))
    # the exponentiations against the oracle (the JAX module's scans take
    # long to run eagerly)
    assert fp2.to_ints(fp2.inv(tx)) == [jo.f2_inv(a) for a in xs]
    assert fp2.is_square(tx).tolist() == [jo.f2_legendre_is_square(a) for a in xs]
    assert fp2.sgn0(tx).tolist() == [jo.f2_sgn0(a) for a in xs]
    assert fp2.to_ints(fp2.mul(tx, ty)) == [jo.f2_mul(a, b) for a, b in zip(xs, ys)]


def _g1(n, seed):
    rng = random.Random(seed)
    g1 = to._ec_from_affine(to.BLS_G1)
    return [to._ec_affine(to._FpOps, to._ec_mul(to._FpOps, rng.randrange(1, to.BLS_R), g1))
            for _ in range(n)]


def _g2(n, seed):
    rng = random.Random(seed)
    g2 = to._ec_from_affine(to.BLS_G2)
    return [to._ec_affine(to._Fp2Ops, to._ec_mul(to._Fp2Ops, rng.randrange(1, to.BLS_R), g2))
            for _ in range(n)]


def _load(group, affs):
    """Affine points -> (port Point, JAX Point) in Montgomery limbs."""
    if group == "g1":
        cols = [_mont([a[0] for a in affs]), _mont([a[1] for a in affs])]
        return (pts.from_affine(pts.G1Field, *(torch.from_numpy(c) for c in cols)),
                jpts.from_affine(jpts.G1Field, *(jnp.asarray(c) for c in cols)))
    cols = [np.stack([_mont([a[k][0] for a in affs]), _mont([a[k][1] for a in affs])])
            for k in (0, 1)]
    return (pts.from_affine(pts.G2Field, *(torch.from_numpy(c) for c in cols)),
            jpts.from_affine(jpts.G2Field, *(jfp2.Fp2(jnp.asarray(c[0]), jnp.asarray(c[1]))
                                             for c in cols)))


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_point_add_dbl_bit_for_bit(group):
    """dbl, P + Q and P + O limb for limb with the JAX points module; the
    sums' affine values equal the oracle's, P + (-P) is the identity."""
    affs = _g1(3, 12) if group == "g1" else _g2(3, 13)
    rolled = affs[1:] + affs[:1]
    tF, jF = (pts.G1Field, jpts.G1Field) if group == "g1" else (pts.G2Field, jpts.G2Field)
    ops = to._FpOps if group == "g1" else to._Fp2Ops
    tp, jp = _load(group, affs)
    tq, jq = _load(group, rolled)

    def same_point(t, j):
        for tc, jc in zip(t, j):
            if group == "g1":
                _same(tc, jc)
            else:
                _same(tc[0], jc.a)
                _same(tc[1], jc.b)

    jadd, jdbl = _jit(jpts.add, jF), _jit(jpts.dbl, jF)
    same_point(pts.dbl(tF, tp), jdbl(jp))
    tsum = pts.add(tF, tp, tq)
    same_point(tsum, jadd(jp, jq))
    same_point(pts.add(tF, tp, pts.identity_like(tF, tp.y)),
               jadd(jp, jpts.identity_like(jF, jp.y)))
    assert pts.is_identity(tF, pts.add(tF, tp, pts.neg_point(tF, tp))).all()
    assert pts.on_curve(tF, tp).all()
    x, y, ident = pts.to_affine(tF, tsum)
    want = [to._ec_affine(ops, to._ec_add(ops, to._ec_from_affine(a), to._ec_from_affine(b)))
            for a, b in zip(affs, rolled)]
    vals = fp if group == "g1" else fp2
    assert list(zip(vals.to_ints(x), vals.to_ints(y))) == want and not ident.any()


def test_g1_decompress_bit_for_bit():
    affs = _g1(3, 15)
    affs.append((affs[0][0], P - affs[0][1]))  # the other sign bit
    enc = np.stack([np.frombuffer(to.bls_g1_compress(a), np.uint8) for a in affs])
    sign = ((enc[:, 0] & 0x20) != 0).astype(np.int32)
    body = enc.copy()
    body[:, 0] &= 0x1F
    limbs = fp.bytes_be_to_limbs(body)
    tok, tp = pts.g1_decompress(torch.from_numpy(limbs), torch.from_numpy(sign))
    jok, jp = _jit(jpts.g1_decompress)(jnp.asarray(limbs), jnp.asarray(sign))
    _same(tok, jok)
    for tc, jc in zip(tp, jp):
        _same(tc, jc)
    assert list(zip(fp.to_ints(tp.x), fp.to_ints(tp.y))) == affs


def _rows(n, seed):
    keys = [tbls.gen_priv_key_from_secret(b"stage-%d-%d" % (seed, i)) for i in range(n)]
    msgs = [b"stage-msg-%d" % i for i in range(n)]
    return [k.pub_key().bytes_() for k in keys], msgs, [k.sign(m) for k, m in zip(keys, msgs)]


def test_staging_bit_for_bit():
    """stage_batch_bls (with and without the u-planes) and _structural_check
    on good rows and structural rejects: bad lengths, an uncompressed flag,
    the infinity encodings, x >= p in the key and in either signature half,
    padded to the bucket."""
    pubs, msgs, sigs = _rows(3, 1)
    p_bytes = P.to_bytes(48, "big")
    pubs += [pubs[0][:47], bytes([0xC0]) + bytes(47), bytes([p_bytes[0] | 0x80]) + p_bytes[1:],
             bytes([pubs[0][0] & 0x7F]) + pubs[0][1:], pubs[1], pubs[2]]
    sigs += [sigs[0], sigs[0], sigs[0], sigs[0], bytes([0xC0]) + bytes(95),
             sigs[2][:48] + p_bytes]
    msgs += [b""] * 6
    n = len(sigs)
    b = TK.EK.bucket_size(n)
    got = TK._structural_check(pubs, sigs, n)
    want = JK._structural_check(pubs, sigs, n)
    for g, w in zip(got, want):
        _same(g, w)
    assert got[0].tolist() == [True] * 3 + [False] * 6
    for m in (msgs, None):
        for g, w in zip(TK.stage_batch_bls(pubs, m, sigs, b), JK.stage_batch_bls(pubs, m, sigs, b)):
            _same(g, w)


def test_host_oracle_equals_reference():
    """The port's oracle against the JAX package's: keys, signatures,
    compression both ways, verification and aggregation with a forged and
    a cancelled case."""
    sk = [to.BLS_R - 5, 7, 123456789]
    msgs = [b"", b"abc", b"abc"]
    pubs = [to.bls_pub_from_priv(k) for k in sk]
    assert pubs == [jo.bls_pub_from_priv(k) for k in sk]
    sigs = [to.bls_sign(k, m, tbls.DST) for k, m in zip(sk, msgs)]
    assert sigs == [jo.bls_sign(k, m, jbls.DST) for k, m in zip(sk, msgs)]
    for p in pubs:
        assert to.bls_g1_decompress(p) == jo.bls_g1_decompress(p)
        assert to.bls_g1_compress(to.bls_g1_decompress(p)) == p
    for s in sigs:
        assert to.bls_g2_decompress(s) == jo.bls_g2_decompress(s)
        assert to.bls_g2_compress(to.bls_g2_decompress(s)) == s
    assert to.bls_verify(pubs[1], msgs[1], sigs[1], tbls.DST)
    assert not to.bls_verify(pubs[1], b"abd", sigs[1], tbls.DST)
    agg = to.bls_aggregate(sigs)
    assert agg == jo.bls_aggregate(sigs)
    for ps, ms in ((pubs, msgs), (pubs, [b"x"] + msgs[1:])):
        assert to.bls_aggregate_verify(ps, ms, agg, tbls.DST) == \
            jo.bls_aggregate_verify(ps, ms, agg, jbls.DST)
    assert to.bls_aggregate_verify(pubs, msgs, agg, tbls.DST)
    with pytest.raises(ValueError):
        to.bls_aggregate([bytes([0xC0]) + bytes(95)])


def test_fp_mul_in_lane_pieces_equals_whole(monkeypatch):
    """Large operands form their product columns in pieces of lanes
    (fp._CONV_CHUNK): the same limbs as in one piece."""
    xs, ys = _mont(_rand(9, 21)), _mont(_rand(9, 22))
    tx, ty = torch.from_numpy(xs), torch.from_numpy(ys)
    whole = fp.mul(tx, ty)
    monkeypatch.setattr(fp, "_CONV_CHUNK", 3 * fp.NLIMBS * 2 * fp.NLIMBS)
    _same(fp.mul(tx, ty), whole)
