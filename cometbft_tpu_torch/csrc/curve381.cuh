// The BLS12-381 groups and the pairing over tower381.cuh and group381.cuh:
// G1 over Fp (y^2 = x^3 + 4), G2 on the twist over Fp2 (y^2 = x^3 +
// 4(1 + u)), complete projective formulas (Renes-Costello-Batina 2015,
// algorithms 7, 8 and 9 for a = 0), a fixed-scalar ladder, decompression,
// the SvdW hash-to-G2 map; then the bodies that run on thread groups as
// well as one lane a thread: both groups in Jacobian coordinates with their
// subgroup checks, G1's sigma(P) == [-x^2]P (Bowe 2019) and G2's psi(P) ==
// [x]P (Scott 2021), the two phases of the segmented point sum, hash to
// G2 (its cofactor clearing by psi: Budroni-Pintore, then a
// GLS split), the optimal-ate Miller loop on batches of products, and the
// segmented product with the final exponentiation (cyclotomic squares).
// Each is the plain version's function (ops/bls12381/points.py, htc.py,
// pairing.py) value for value: the Miller loop keeps the plain version's
// projective T and line scalings, so its Fp12 output equals the plain one,
// and the final exponentiation is the oracle's chain.

#pragma once

#include "group381.cuh"

namespace bls {

// ------------------------------------------------- field-generic point code

__device__ __forceinline__ void f_add(fp& o, const fp& a, const fp& b) { fp_add(o, a, b); }
__device__ __forceinline__ void f_add(fp2& o, const fp2& a, const fp2& b) { f2_add(o, a, b); }
__device__ __forceinline__ void f_sub(fp& o, const fp& a, const fp& b) { fp_sub(o, a, b); }
__device__ __forceinline__ void f_sub(fp2& o, const fp2& a, const fp2& b) { f2_sub(o, a, b); }
__device__ __forceinline__ void f_mul(fp& o, const fp& a, const fp& b) { fp_mul(o, a, b); }
__device__ __forceinline__ void f_mul(fp2& o, const fp2& a, const fp2& b) { f2_mul(o, a, b); }
__device__ __forceinline__ void f_sq(fp& o, const fp& a) { fp_sq(o, a); }
__device__ __forceinline__ void f_sq(fp2& o, const fp2& a) { f2_sq(o, a); }
__device__ __forceinline__ void f_neg(fp& o, const fp& a) { fp_neg(o, a); }
__device__ __forceinline__ void f_neg(fp2& o, const fp2& a) { f2_neg(o, a); }
__device__ __forceinline__ void f_mul3(fp& o, const fp& a) { fp_mul3(o, a); }
__device__ __forceinline__ void f_mul3(fp2& o, const fp2& a) { f2_mul3(o, a); }
__device__ __forceinline__ bool f_is_zero(const fp& a) { return fp_is_zero(a); }
__device__ __forceinline__ bool f_is_zero(const fp2& a) { return f2_is_zero(a); }
__device__ __forceinline__ bool f_eq(const fp& a, const fp& b) { return fp_eq(a, b); }
__device__ __forceinline__ bool f_eq(const fp2& a, const fp2& b) { return f2_eq(a, b); }
__device__ __forceinline__ void f_dbl(fp& o, const fp& a) { fp_dbl(o, a); }
__device__ __forceinline__ void f_dbl(fp2& o, const fp2& a) { f2_dbl(o, a); }
__device__ __forceinline__ void f_ld(fp& o, const uint32_t* p, long long B, long long j) {
  fp_ld(o, p, B, j);
}
__device__ __forceinline__ void f_ld(fp2& o, const uint32_t* p, long long B, long long j) {
  f2_ld(o, p, B, j);
}
__device__ __forceinline__ void f_st(uint32_t* p, long long B, long long j, const fp& a) {
  fp_st(p, B, j, a);
}
__device__ __forceinline__ void f_st(uint32_t* p, long long B, long long j, const fp2& a) {
  f2_st(p, B, j, a);
}
__device__ __forceinline__ void f_zero(fp& o) { fp_zero(o); }
__device__ __forceinline__ void f_zero(fp2& o) { f2_zero(o); }
__device__ __forceinline__ void f_one(fp& o) { fp_one(o); }
__device__ __forceinline__ void f_one(fp2& o) { f2_one(o); }
__device__ __forceinline__ void f_inv(fp& o, const fp& a) { fp_inv(o, a); }
__device__ __forceinline__ void f_inv(fp2& o, const fp2& a) { f2_inv(o, a); }
__device__ __forceinline__ void f_sel(fp& o, bool c, const fp& a, const fp& b) { fp_sel(o, c, a, b); }
__device__ __forceinline__ void f_sel(fp2& o, bool c, const fp2& a, const fp2& b) {
  f2_sel(o, c, a, b);
}
// 3b: 12 on G1, 12(1 + u) on G2
__device__ __forceinline__ void f_mul_b3(fp& o, const fp& a) { fp_mul12(o, a); }
__device__ __forceinline__ void f_mul_b3(fp2& o, const fp2& a) {
  fp_mul12(o.a, a.a);
  fp_mul12(o.b, a.b);
  f2_mul_xi(o, o);
}

template <class T>
struct proj {
  T x, y, z;
};

template <class T>
__device__ __forceinline__ void pt_identity(proj<T>& o) {
  f_zero(o.x);
  f_one(o.y);
  f_zero(o.z);
}

template <class T>
__device__ __forceinline__ void pt_from_affine(proj<T>& o, const T& x, const T& y) {
  o.x = x;
  o.y = y;
  f_one(o.z);
}

// RCB 2015 algorithm 7, in the plain version's order of terms
template <class T>
__device__ BLS_NOINLINE void pt_add(proj<T>& o, const proj<T>& p, const proj<T>& q) {
  T t0, t1, t2, t3, t4, y3, x3, z3, s, u;
  f_mul(t0, p.x, q.x);
  f_mul(t1, p.y, q.y);
  f_mul(t2, p.z, q.z);
  f_add(s, p.x, p.y);
  f_add(u, q.x, q.y);
  f_mul(t3, s, u);
  f_add(s, t0, t1);
  f_sub(t3, t3, s);  // mxy - (t0 + t1)
  f_add(s, p.y, p.z);
  f_add(u, q.y, q.z);
  f_mul(t4, s, u);
  f_add(s, t1, t2);
  f_sub(t4, t4, s);  // myz - (t1 + t2)
  f_add(s, p.x, p.z);
  f_add(u, q.x, q.z);
  f_mul(y3, s, u);
  f_add(s, t0, t2);
  f_sub(y3, y3, s);  // mxz - (t0 + t2)
  f_mul3(x3, t0);
  T t2b, t1b, y3b;
  f_mul_b3(t2b, t2);
  f_add(z3, t1, t2b);
  f_sub(t1b, t1, t2b);
  f_mul_b3(y3b, y3);
  T p1, p2, p3, p4, p5, p6;
  f_mul(p1, t3, t1b);
  f_mul(p2, t4, y3b);
  f_mul(p3, y3b, x3);
  f_mul(p4, t1b, z3);
  f_mul(p5, z3, t4);
  f_mul(p6, x3, t3);
  f_sub(o.x, p1, p2);
  f_add(o.y, p3, p4);
  f_add(o.z, p5, p6);
}

// RCB 2015 algorithm 8: P + Q for an affine Q = (qx, qy) (Z = 1, not the
// identity), algorithm 7 with Q's Z = 1 in the same order of terms: 11
// products for 12; complete for every P, the identity, Q and -Q included
template <class T>
__device__ BLS_NOINLINE void pt_add_aff(proj<T>& o, const proj<T>& p, const T& qx, const T& qy) {
  T t0, t1, t3, t4, y3, x3, z3, s, u;
  f_mul(t0, p.x, qx);
  f_mul(t1, p.y, qy);
  f_add(s, p.x, p.y);
  f_add(u, qx, qy);
  f_mul(t3, s, u);
  f_add(s, t0, t1);
  f_sub(t3, t3, s);  // mxy - (t0 + t1)
  f_mul(t4, qy, p.z);
  f_add(t4, t4, p.y);  // myz - (t1 + t2), t2 = Z
  f_mul(y3, qx, p.z);
  f_add(y3, y3, p.x);  // mxz - (t0 + t2)
  f_mul3(x3, t0);
  T t2b, t1b, y3b;
  f_mul_b3(t2b, p.z);
  f_add(z3, t1, t2b);
  f_sub(t1b, t1, t2b);
  f_mul_b3(y3b, y3);
  T p1, p2, p3, p4, p5, p6;
  f_mul(p1, t3, t1b);
  f_mul(p2, t4, y3b);
  f_mul(p3, y3b, x3);
  f_mul(p4, t1b, z3);
  f_mul(p5, z3, t4);
  f_mul(p6, x3, t3);
  f_sub(o.x, p1, p2);
  f_add(o.y, p3, p4);
  f_add(o.z, p5, p6);
}

// RCB 2015 algorithm 9
template <class T>
__device__ BLS_NOINLINE void pt_dbl(proj<T>& o, const proj<T>& p) {
  T t0, t1, zz, txy, t2, z8, y3, t0b, s;
  f_mul(t0, p.y, p.y);
  f_mul(t1, p.y, p.z);
  f_mul(zz, p.z, p.z);
  f_mul(txy, p.x, p.y);
  f_mul_b3(t2, zz);
  f_add(z8, t0, t0);
  f_add(z8, z8, z8);
  f_add(z8, z8, z8);
  f_add(y3, t0, t2);
  f_mul3(s, t2);
  f_sub(t0b, t0, s);
  T x3, z3, q3, q4;
  f_mul(x3, t2, z8);
  f_mul(z3, t1, z8);
  f_mul(q3, t0b, y3);
  f_mul(q4, t0b, txy);
  f_add(o.x, q4, q4);
  f_add(o.y, x3, q3);
  o.z = z3;
}

// [e]P for a fixed scalar of the table, MSB first (adds only where the
// public bit is set). No kernel runs it: the host tests hold the subgroup
// tests against [r]P == O and the cofactor clearing against [h2]P by it.
template <class T>
__device__ BLS_NOINLINE void pt_mul_const(proj<T>& o, const proj<T>& p, int e) {
  proj<T> acc;
  pt_identity(acc);
  for (int i = exp_nbits(e) - 1; i >= 0; --i) {
    pt_dbl(acc, acc);
    if (exp_bit(e, i)) pt_add(acc, acc, p);
  }
  o = acc;
}

// (x, y) affine; the identity gives (0, 0) and true
template <class T>
__device__ __forceinline__ bool pt_to_affine(T& x, T& y, const proj<T>& p) {
  T zi;
  f_inv(zi, p.z);
  f_mul(x, p.x, zi);
  f_mul(y, p.y, zi);
  return f_is_zero(p.z);
}

// ------------------------------------------------------------ decompression

// x in Montgomery form: y = sqrt(x^3 + 4) with the sign rule; returns ok
__device__ __forceinline__ bool g1_decompress(fp& y, const fp& x, bool sign) {
  fp t, b;
  fp_sq(t, x);
  fp_mul(t, t, x);
  fp_k(b, K_B1);
  fp_add(t, t, b);
  const bool ok = fp_sqrt(y, t);
  fp_neg(t, y);
  fp_sel(y, fp_lexi_larger(y) != sign, t, y);
  return ok;
}

// The root exists iff the norm of x^3 + b is a square in Fp: its binary
// Legendre symbol decides before any exponentiation. A square takes the
// root by the norm (f2_sqrt_fast: f2_sqrt's root up to sign, and the sign
// rule then picks the same y); a non-square takes f2_sqrt's candidate,
// which is the plain version's y on a lane it rejects.
__device__ __forceinline__ bool g2_decompress(fp2& y, const fp2& x, bool sign) {
  fp2 t, b;
  f2_sq(t, x);
  f2_mul(t, t, x);
  f2_k(b, K_B2);
  f2_add(t, t, b);
  const bool ok = f2_is_square(t) ? f2_sqrt_fast(y, t) : f2_sqrt(y, t);
  f2_neg(t, y);
  f2_sel(y, f2_lexi_larger(y) != sign, t, y);
  return ok;
}

// -------------------------------------------------------------- hash to G2

__device__ __forceinline__ void svdw_g(fp2& o, const fp2& x) {
  fp2 t, b;
  f2_sq(t, x);
  f2_mul(t, t, x);
  f2_k(b, K_B2);
  f2_add(o, t, b);
}

// map_to_curve_svdw on the twist (RFC 9380 §6.6.1); the square tests by the
// norm's Legendre symbol, the root by the norm (f2_sqrt_fast)
__device__ BLS_NOINLINE void svdw_map(proj<fp2>& o, const fp2& u) {
  fp2 z, c1, c2, c3, c4, one, tv1, tv2, tv3, tv4, t, x1, x2, x3, x, y, gx;
  f2_k(z, K_SVDW);
  f2_k(c1, K_SVDW + 2 * NW);
  f2_k(c2, K_SVDW + 4 * NW);
  f2_k(c3, K_SVDW + 6 * NW);
  f2_k(c4, K_SVDW + 8 * NW);
  f2_one(one);
  f2_sq(t, u);
  f2_mul(tv1, t, c1);
  f2_add(tv2, one, tv1);
  f2_sub(tv1, one, tv1);
  f2_mul(t, tv1, tv2);
  f2_inv(tv3, t);  // inv0
  f2_mul(t, u, tv1);
  f2_mul(tv4, tv3, c3);
  f2_mul(tv4, t, tv4);
  f2_sub(x1, c2, tv4);
  f2_add(x2, c2, tv4);
  f2_sq(t, tv2);
  f2_mul(t, t, tv3);
  f2_sq(t, t);
  f2_mul(t, t, c4);
  f2_add(x3, t, z);
  svdw_g(gx, x1);
  const bool e1 = f2_is_square(gx);
  svdw_g(gx, x2);
  const bool e2 = f2_is_square(gx) && !e1;
  f2_sel(x, e2, x2, x3);
  f2_sel(x, e1, x1, x);
  svdw_g(gx, x);
  f2_sqrt_fast(y, gx);
  f2_neg(t, y);
  f2_sel(y, f2_sgn0(u) != f2_sgn0(y), t, y);
  pt_from_affine(o, x, y);
}

// ------------------------------------------- Jacobian coordinates
// (x, y) = (X / Z^2, Y / Z^3), the identity Z = 0; the oracle's formulas
// (crypto/bls12381_math.py _ec_dbl, _ec_add: dbl-2009-l, add-2007-bl), on G1
// over Fp and on G2 over Fp2, each product or square a group operation: an
// Fp2 one split over the group (group381.cuh), an Fp one on its thread (G1's
// code runs one lane a thread). The branches read values every thread of a
// group holds alike.

template <class T>
struct jacT {
  T x, y, z;
};
using jac = jacT<fp2>;   // G2
using jac1 = jacT<fp>;   // G1

template <class G>
__device__ __forceinline__ void g_mul(fp& o, const fp& x, const fp& y, G&) {
  static_assert(G::N == 1, "G1's Jacobian code runs one lane a thread");
  fp_mul(o, x, y);
}
template <class G>
__device__ __forceinline__ void g_mul(fp2& o, const fp2& x, const fp2& y, G& g) {
  g2_mul(o, x, y, g);
}
template <class G>
__device__ __forceinline__ void g_sq(fp& o, const fp& x, G&) {
  static_assert(G::N == 1, "G1's Jacobian code runs one lane a thread");
  fp_sq(o, x);
}
template <class G>
__device__ __forceinline__ void g_sq(fp2& o, const fp2& x, G& g) {
  g2_sq(o, x, g);
}

template <class T>
__device__ __forceinline__ void jac_identity(jacT<T>& o) {
  f_one(o.x);
  f_one(o.y);
  f_zero(o.z);
}

// 5 squares and 2 products; o may alias p
template <class T, class G>
__device__ BLS_NOINLINE void jac_dbl(jacT<T>& o, const jacT<T>& p, G& g) {
  T a, b, c, d, e, f, t, x3, y3;
  g_sq(a, p.x, g);
  g_sq(b, p.y, g);
  g_sq(c, b, g);
  f_add(t, p.x, b);
  g_sq(d, t, g);
  f_sub(d, d, a);
  f_sub(d, d, c);
  f_dbl(d, d);
  f_mul3(e, a);
  g_sq(f, e, g);
  f_dbl(t, d);
  f_sub(x3, f, t);
  f_sub(t, d, x3);
  g_mul(y3, e, t, g);
  f_dbl(t, c);
  f_dbl(t, t);
  f_dbl(t, t);
  f_sub(y3, y3, t);
  g_mul(t, p.y, p.z, g);
  f_dbl(o.z, t);
  o.x = x3;
  o.y = y3;
}

// 4 squares and 12 products; P == Q doubles, P == -Q gives the identity; o
// may alias p or q
template <class T, class G>
__device__ BLS_NOINLINE void jac_add(jacT<T>& o, const jacT<T>& p, const jacT<T>& q, G& g) {
  if (f_is_zero(p.z)) {
    o = q;
    return;
  }
  if (f_is_zero(q.z)) {
    o = p;
    return;
  }
  T z1z1, z2z2, u1, u2, s1, s2, t;
  g_sq(z1z1, p.z, g);
  g_sq(z2z2, q.z, g);
  g_mul(u1, p.x, z2z2, g);
  g_mul(u2, q.x, z1z1, g);
  g_mul(t, p.y, q.z, g);
  g_mul(s1, t, z2z2, g);
  g_mul(t, q.y, p.z, g);
  g_mul(s2, t, z1z1, g);
  if (f_eq(u1, u2)) {
    if (f_eq(s1, s2)) {
      jac_dbl(o, p, g);
    } else {
      jac_identity(o);
    }
    return;
  }
  T h, i, j, r, v, x3, y3, z3;
  f_sub(h, u2, u1);
  f_dbl(t, h);
  g_sq(i, t, g);
  g_mul(j, h, i, g);
  f_sub(r, s2, s1);
  f_dbl(r, r);
  g_mul(v, u1, i, g);
  g_sq(x3, r, g);
  f_sub(x3, x3, j);
  f_dbl(t, v);
  f_sub(x3, x3, t);
  f_sub(t, v, x3);
  g_mul(y3, r, t, g);
  g_mul(t, s1, j, g);
  f_dbl(t, t);
  f_sub(y3, y3, t);
  g_mul(z3, h, p.z, g);
  g_mul(z3, z3, q.z, g);
  f_dbl(o.z, z3);
  o.x = x3;
  o.y = y3;
}

// P + Q for an affine Q (Z = 1, not the identity): jac_add with Q's Z = 1,
// 3 squares and 8 products; the same doubling and inverse cases; o may
// alias p
template <class T, class G>
__device__ BLS_NOINLINE void jac_add_aff(jacT<T>& o, const jacT<T>& p, const T& qx, const T& qy,
                                         G& g) {
  if (f_is_zero(p.z)) {
    o.x = qx;
    o.y = qy;
    f_one(o.z);
    return;
  }
  T z1z1, u2, s2, t;
  g_sq(z1z1, p.z, g);
  g_mul(u2, qx, z1z1, g);
  g_mul(t, qy, p.z, g);
  g_mul(s2, t, z1z1, g);
  if (f_eq(p.x, u2)) {
    if (f_eq(p.y, s2)) {
      jac_dbl(o, p, g);
    } else {
      jac_identity(o);
    }
    return;
  }
  T h, i, j, r, v, x3, y3, z3;
  f_sub(h, u2, p.x);
  f_dbl(t, h);
  g_sq(i, t, g);
  g_mul(j, h, i, g);
  f_sub(r, s2, p.y);
  f_dbl(r, r);
  g_mul(v, p.x, i, g);
  g_sq(x3, r, g);
  f_sub(x3, x3, j);
  f_dbl(t, v);
  f_sub(x3, x3, t);
  f_sub(t, v, x3);
  g_mul(y3, r, t, g);
  g_mul(t, p.y, j, g);
  f_dbl(t, t);
  f_sub(y3, y3, t);
  g_mul(z3, h, p.z, g);
  f_dbl(o.z, z3);
  o.x = x3;
  o.y = y3;
}

// psi(P) = (conj(X) cx, conj(Y) cy, conj(Z)): the twist's Frobenius
// endomorphism (acts as [x] on G2); o may alias p
template <class G>
__device__ BLS_NOINLINE void jac_psi(jac& o, const jac& p, G& g) {
  fp2 k, t;
  f2_k(k, K_PSI);
  f2_conj(t, p.x);
  g2_mul(o.x, t, k, g);
  f2_k(k, K_PSI + 2 * NW);
  f2_conj(t, p.y);
  g2_mul(o.y, t, k, g);
  f2_conj(o.z, p.z);
}

// bit b of the table's base-x digit i of c
__device__ __forceinline__ uint32_t gls_bit(int i, int b) {
  return (c_k[K_GLS + 2 * i + (b >> 5)] >> (b & 31)) & 1u;
}

// [c]Q for Q in G2 (or the identity), c = (3(x^2 - 1))^-1 mod r =
// sum d_i x^i with 0 <= d_i < |x| (the table's digits): psi acts on G2 as
// [x], so [c]Q = sum [d_i] psi^i(Q), four 64-bit digits and a last one of a
// bit. A joint ladder: the 15 sums of psi^0..3(Q), then one doubling a bit
// and one addition a non-zero column of the digits' bits (Gallant, Lambert
// and Vanstone's split, with psi as the endomorphism). The digits are
// public and alike on every lane.
template <class G>
__device__ BLS_NOINLINE void jac_mul_c(jac& o, const jac& q, G& g) {
  jac tab[16], last;
  tab[1] = q;
  jac_psi(tab[2], q, g);
  jac_psi(tab[4], tab[2], g);
  jac_psi(tab[8], tab[4], g);
  jac_psi(last, tab[8], g);
  for (int m = 3; m < 16; ++m)
    if (m & (m - 1)) jac_add(tab[m], tab[m & (m - 1)], tab[m & -m], g);
  int b = 63;
  int col = 0;
  for (; b >= 0 && !col; --b)
    col = (int)(gls_bit(0, b) | gls_bit(1, b) << 1 | gls_bit(2, b) << 2 | gls_bit(3, b) << 3);
  jac acc = tab[col];
  for (; b >= 0; --b) {
    jac_dbl(acc, acc, g);
    col = (int)(gls_bit(0, b) | gls_bit(1, b) << 1 | gls_bit(2, b) << 2 | gls_bit(3, b) << 3);
    if (col) jac_add(acc, acc, tab[col], g);
  }
  if (gls_bit(4, 0)) jac_add(acc, acc, last, g);
  o = acc;
}

// [x]P for the curve parameter x < 0: |x| by its bits, then negated
template <class G>
__device__ BLS_NOINLINE void jac_mul_x(jac& o, const jac& p, G& g) {
  jac acc = p;
  for (int i = exp_nbits(E_X) - 2; i >= 0; --i) {
    jac_dbl(acc, acc, g);
    if (exp_bit(E_X, i)) jac_add(acc, acc, p, g);
  }
  f2_neg(acc.y, acc.y);
  o = acc;
}

// o = p - q
template <class G>
__device__ __forceinline__ void jac_sub(jac& o, const jac& p, const jac& q, G& g) {
  jac n = q;
  f2_neg(n.y, n.y);
  jac_add(o, p, n, g);
}

// [h2]P, the oracle's cofactor clearing (h2 = #E'(Fp2) / r), for any twist
// point P: Budroni and Pintore's psi formula (RFC 9380 G.3) gives
// [h_eff]P = [x^2 - x - 1]P + [x - 1]psi(P) + psi^2(2P), h_eff =
// 3(x^2 - 1) h2, in G2; then [c] with c = (3(x^2 - 1))^-1 mod r by its
// base-x split. Three 64-bit ladders instead of h2's 507 bits.
template <class G>
__device__ BLS_NOINLINE void jac_clear_cofactor(jac& o, const jac& p, G& g) {
  jac t1, t2, t3;
  jac_mul_x(t1, p, g);
  jac_psi(t2, p, g);
  jac_dbl(t3, p, g);
  jac_psi(t3, t3, g);
  jac_psi(t3, t3, g);
  jac_sub(t3, t3, t2, g);
  jac_add(t2, t1, t2, g);
  jac_mul_x(t2, t2, g);
  jac_add(t3, t3, t2, g);
  jac_sub(t3, t3, t1, g);
  jac_sub(t3, t3, p, g);
  jac_mul_c(o, t3, g);
}

// RCB projective (x = X / Z) -> Jacobian
template <class T>
__device__ __forceinline__ void jac_from_proj(jacT<T>& o, const proj<T>& p) {
  T zz;
  f_mul(o.x, p.x, p.z);
  f_sq(zz, p.z);
  f_mul(o.y, p.y, zz);
  o.z = p.z;
}

// (x, y) affine; the identity gives (0, 0) and true
__device__ __forceinline__ bool jac_to_affine(fp2& x, fp2& y, const jac& p) {
  fp2 zi, zi2, zi3;
  f2_inv(zi, p.z);
  f2_sq(zi2, zi);
  f2_mul(zi3, zi2, zi);
  f2_mul(x, p.x, zi2);
  f2_mul(y, p.y, zi3);
  return f2_is_zero(p.z);
}

// P in G2 iff psi(P) == [x]P, for every point P of E'(Fp2) (Scott, "A note
// on group membership tests for G1, G2 and GT on BLS pairing-friendly
// curves", ePrint 2021/1130, section 4: psi acts as [x] on G2 and as no
// such map on the rest of E'(Fp2) for BLS12 curves): one psi and one |x|
// ladder (63 doublings, 5 additions) instead of r's 255-bit ladder. The
// two sides compare across Jacobian coordinates (X1 Z2^2 = X2 Z1^2, Y1 Z2^3
// = Y2 Z1^3); the identity counts as in the subgroup, as with [r]P == O.
template <class G>
__device__ BLS_NOINLINE bool jac_in_g2(const jac& p, G& g) {
  jac a, b;
  jac_psi(a, p, g);
  jac_mul_x(b, p, g);
  const bool za = f2_is_zero(a.z), zb = f2_is_zero(b.z);
  if (za || zb) return za && zb;
  fp2 a2, b2, a3, b3, l, r;
  g2_sq(a2, a.z, g);
  g2_sq(b2, b.z, g);
  g2_mul(l, a.x, b2, g);
  g2_mul(r, b.x, a2, g);
  if (!f2_eq(l, r)) return false;
  g2_mul(a3, a2, a.z, g);
  g2_mul(b3, b2, b.z, g);
  g2_mul(l, a.y, b3, g);
  g2_mul(r, b.y, a3, g);
  return f2_eq(l, r);
}

// G2: the one membership test of the port (B1 G2 and B3 G2)
template <class G>
__device__ __forceinline__ bool pt_in_subgroup(const proj<fp2>& p, G& g) {
  jac q;
  jac_from_proj(q, p);
  return jac_in_g2(q, g);
}

__device__ __forceinline__ bool pt_in_subgroup(const proj<fp2>& p) {
  solo g;
  return pt_in_subgroup(p, g);
}

// [x^2]P (x^2 of the table, 128 bits of weight 17): 127 doublings and 16
// additions, mixed ones (jac_add_aff) where P is affine (Z = 1); the
// additions' doubling and inverse cases occur on points with a component of
// small order (a prefix k of x^2 with [k]P = +-P)
__device__ BLS_NOINLINE void jac_mul_x2(jac1& o, const jac1& p) {
  solo g;
  const bool aff = fp_eq_k(p.z, K_ONE);
  jac1 acc = p;
  for (int i = x2_nbits() - 2; i >= 0; --i) {
    jac_dbl(acc, acc, g);
    if (x2_bit(i)) {
      if (aff) {
        jac_add_aff(acc, acc, p.x, p.y, g);
      } else {
        jac_add(acc, acc, p, g);
      }
    }
  }
  o = acc;
}

// P in G1 iff sigma(P) == [-x^2]P, sigma(x, y) = (beta x, y) with the table's
// cube root of unity beta, for every point P of E(Fp) (Bowe, "Faster
// subgroup checks for BLS12-381", ePrint 2019/814; Scott, ePrint 2021/1130,
// section 3: sigma acts as [-x^2] on G1 and as no such map on the rest of
// E(Fp)): one [x^2] ladder (127 doublings, 16 mixed additions) instead of
// r's 255-bit ladder. Tested as [x^2]P == -sigma(P) = (beta X, -Y, Z),
// across Jacobian coordinates; the identity counts as in G1 on both sides
// (sigma(P) is the identity only for P = O).
__device__ BLS_NOINLINE bool jac_in_g1(const jac1& p) {
  if (fp_is_zero(p.z)) return true;
  jac1 q;
  jac_mul_x2(q, p);
  if (fp_is_zero(q.z)) return false;
  const bool aff = fp_eq_k(p.z, K_ONE);
  fp bx, ny, qz2, qz3, z2, z3, l, r;
  fp_k(bx, K_BETA);
  fp_mul(bx, bx, p.x);
  fp_neg(ny, p.y);
  fp_sq(qz2, q.z);
  l = q.x;
  if (!aff) {
    fp_sq(z2, p.z);
    fp_mul(l, q.x, z2);
  }
  fp_mul(r, bx, qz2);
  if (!fp_eq(l, r)) return false;
  fp_mul(qz3, qz2, q.z);
  l = q.y;
  if (!aff) {
    fp_mul(z3, z2, p.z);
    fp_mul(l, q.y, z3);
  }
  fp_mul(r, ny, qz3);
  return fp_eq(l, r);
}

// G1: the one membership test of the port (B1 G1 and B3 G1)
__device__ __forceinline__ bool pt_in_subgroup(const proj<fp>& p) {
  jac1 q;
  jac_from_proj(q, p);
  return jac_in_g1(q);
}

// G1's Jacobian steps on a trio, their Fp products in rounds of at most
// three (fp_round). The doubling in three rounds (8 products for
// jac_dbl's 7): X^2, Y^2, Y Z; B^2, (X + B)^2, A^2; E D, A^3, with F = E^2
// = 9 A^2 and E F = 27 A^3 by additions, so Y3 = E (D - X3) - 8C = 3 E D -
// 27 A^3 - 8 C. o may alias p.
template <class G>
__device__ BLS_NOINLINE void jac1_dbl_trio(jac1& o, const jac1& p, G& g) {
  fp a, b, yz, c, s, a2, t, d, e, f, x3, ed, a3, y3;
  fp_round(a, b, yz, p.x, p.x, p.y, p.y, p.y, p.z, 3, g);
  fp_add(t, p.x, b);
  fp_round(c, s, a2, b, b, t, t, a, a, 3, g);
  fp_sub(d, s, a);
  fp_sub(d, d, c);
  fp_dbl(d, d);  // D = 2((X + B)^2 - A - C)
  fp_mul3(e, a);
  fp_mul3(f, a2);
  fp_mul3(f, f);  // F = 9 A^2
  fp_dbl(t, d);
  fp_sub(x3, f, t);
  fp_round(ed, a3, a3, e, d, a, a2, a, a2, 2, g);
  fp_mul3(y3, ed);
  fp_mul3(t, a3);
  fp_mul3(t, t);
  fp_mul3(t, t);  // 27 A^3
  fp_sub(y3, y3, t);
  fp_dbl(t, c);
  fp_dbl(t, t);
  fp_dbl(t, t);
  fp_sub(y3, y3, t);
  fp_dbl(o.z, yz);
  o.x = x3;
  o.y = y3;
}

// jac_add_aff on a trio, its 11 products in five rounds: Z1^2, Y2 Z1; U2,
// S2; (2H)^2, r^2, H Z1; J, V; r (V - X3), Y1 J. The same doubling and
// inverse cases; o may alias p.
template <class G>
__device__ BLS_NOINLINE void jac1_add_aff_trio(jac1& o, const jac1& p, const fp& qx,
                                               const fp& qy, G& g) {
  if (fp_is_zero(p.z)) {
    o.x = qx;
    o.y = qy;
    fp_one(o.z);
    return;
  }
  fp z1z1, t, u2, s2, h, r, w, i, r2, hz, j, v, x3, rv, yj;
  fp_round(z1z1, t, t, p.z, p.z, qy, p.z, qy, p.z, 2, g);
  fp_round(u2, s2, s2, qx, z1z1, t, z1z1, t, z1z1, 2, g);
  if (fp_eq(p.x, u2)) {
    if (fp_eq(p.y, s2)) {
      jac1_dbl_trio(o, p, g);
    } else {
      jac_identity(o);
    }
    return;
  }
  fp_sub(h, u2, p.x);
  fp_sub(r, s2, p.y);
  fp_dbl(r, r);
  fp_dbl(w, h);
  fp_round(i, r2, hz, w, w, r, r, h, p.z, 3, g);
  fp_round(j, v, v, h, i, p.x, i, p.x, i, 2, g);
  fp_sub(x3, r2, j);
  fp_dbl(w, v);
  fp_sub(x3, x3, w);
  fp_sub(w, v, x3);
  fp_round(rv, yj, yj, r, w, p.y, j, p.y, j, 2, g);
  fp_dbl(yj, yj);
  fp_sub(o.y, rv, yj);
  fp_dbl(o.z, hz);
  o.x = x3;
}

// sigma(P) == [-x^2]P (jac_in_g1) for an affine P = (x, y) on a trio: the
// [x^2] ladder's steps in rounds (127 doublings of three, 16 additions of
// five), then the compare in three
template <class G>
__device__ BLS_NOINLINE bool g1_in_subgroup_trio(const fp& x, const fp& y, G& g) {
  jac1 q{x, y, {}};
  fp_one(q.z);
  for (int i = x2_nbits() - 2; i >= 0; --i) {
    jac1_dbl_trio(q, q, g);
    if (x2_bit(i)) jac1_add_aff_trio(q, q, x, y, g);
  }
  if (fp_is_zero(q.z)) return false;
  fp beta, bx, qz2, qz3, l, ny;
  fp_k(beta, K_BETA);
  fp_round(bx, qz2, qz2, beta, x, q.z, q.z, q.z, q.z, 2, g);
  fp_round(l, qz3, qz3, bx, qz2, qz2, q.z, qz2, q.z, 2, g);
  if (!fp_eq(q.x, l)) return false;
  fp_neg(ny, y);
  fp_round(l, l, l, ny, qz3, ny, qz3, ny, qz3, 1, g);
  return fp_eq(q.y, l);
}

// ------------------------------------------------------------------ pairing
// f_{|x|,Q}(P), conjugated (x < 0), on T = Q in RCB projective coordinates
// as the plain version walks it: each doubling step f = f^2 l_T,T(P), T =
// 2T; where x's bit is set, f = f l_T,Q(P), T = T + Q. The lines keep the
// plain version's scalings (the tangent by 2 Y Z^2, the chord by X - xQ Z)
// and land in its sparse slots c0 + c_vw v w + c_v2w v^2 w, the last two
// times xi^-1 (f2_mul_xi_inv: additions). What the step costs: an Fp12
// square of 36 Fp products (the complex method), a product by the sparse
// line of 42 (f12_line_job), the tangent and the doubling sharing Y^2 and
// Y Z (40), no square and no product in the first step (f = 1: f = l).
// The products of a step go out on three batches (group381.cuh): the
// square beside the tangent's and the doubling's first products; their
// second products; the line product.

// the sparse line's coefficients, xi^-1 applied to the last two; on the
// first step f = l, else f = f l
template <class G>
__device__ __forceinline__ void miller_line(fp12& f, const fp2& c0, const fp2& c_vw,
                                            const fp2& c_v2w, bool first, G& g) {
  fp2 b1, b2;
  f2_mul_xi_inv(b1, c_vw);
  f2_mul_xi_inv(b2, c_v2w);
  if (first) {
    f12_one(f);
    f.d0.c0 = c0;
    f.d1.c1 = b1;
    f.d1.c2 = b2;
    return;
  }
  g12_mul_line(f, f, c0, b1, b2, g);
}

// f = f^2 l (the tangent at T, scaled by 2 Y Z^2); T = 2T (RCB algorithm 9)
template <class G>
__device__ BLS_NOINLINE void miller_dbl(fp12& f, proj<fp2>& t, const fp& px, const fp& py,
                                        bool first, G& g) {
  batch<G, MILLER_JOBS> b(g);
  f12_sq_job sq;
  if (!first) sq.queue(b, f);
  fp2 xx, yy, zz, yz, xy, zpy, zpx;
  b.sq(xx, t.x);
  b.sq(yy, t.y);
  b.sq(zz, t.z);
  b.mul(yz, t.y, t.z);
  b.mul(xy, t.x, t.y);
  b.mul_fp(zpy, t.z, py);
  b.mul_fp(zpx, t.z, px);
  b.run(g);
  if (!first) sq.finish(f);
  fp2 t2, z8, y3, t0b, s;
  f_mul_b3(t2, zz);
  f2_dbl(z8, yy);
  f2_dbl(z8, z8);
  f2_dbl(z8, z8);
  f2_add(y3, yy, t2);
  f2_mul3(s, t2);
  f2_sub(t0b, yy, s);
  fp2 c0, xxx, yyz, xxzpx, x3, z3, q3, q4;
  b.mul(c0, yz, zpy);
  b.mul(xxx, xx, t.x);
  b.mul(yyz, yy, t.z);
  b.mul(xxzpx, xx, zpx);
  b.mul(x3, t2, z8);
  b.mul(z3, yz, z8);
  b.mul(q3, t0b, y3);
  b.mul(q4, t0b, xy);
  b.run(g);
  f2_dbl(t.x, q4);
  f2_add(t.y, x3, q3);
  t.z = z3;
  // c0 = 2 (Y Z)(Z py), c_vw = 3 X^2 X - 2 Y^2 Z, c_v2w = -3 X^2 (Z px)
  fp2 c_vw, c_v2w;
  f2_dbl(c0, c0);
  f2_mul3(c_vw, xxx);
  f2_dbl(s, yyz);
  f2_sub(c_vw, c_vw, s);
  f2_mul3(c_v2w, xxzpx);
  f2_neg(c_v2w, c_v2w);
  miller_line(f, c0, c_vw, c_v2w, first, g);
}

// f = f l (the chord through T and Q, scaled by X - xQ Z); T = T + Q (RCB
// algorithm 7 with Q's Z = 1: the chord's products X yQ, Y xQ, xQ Z, yQ Z
// serve the addition too)
template <class G>
__device__ BLS_NOINLINE void miller_add(fp12& f, proj<fp2>& t, const fp& px, const fp& py,
                                        const fp2& qx, const fp2& qy, G& g) {
  batch<G, MILLER_JOBS> b(g);
  fp2 xqx, yqy, yqx, xqy, qxz, qyz;
  b.mul(xqx, t.x, qx);
  b.mul(yqy, t.y, qy);
  b.mul(yqx, t.y, qx);
  b.mul(xqy, t.x, qy);
  b.mul(qxz, qx, t.z);
  b.mul(qyz, qy, t.z);
  b.run(g);
  fp2 s0, s2, c_vw, t3, t4, y3, x3, t2b, z3, t1b, y3b;
  f2_sub(s0, t.x, qxz);
  f2_sub(s2, t.y, qyz);
  f2_sub(c_vw, yqx, xqy);
  f2_add(t3, xqy, yqx);
  f2_add(t4, t.y, qyz);
  f2_add(y3, t.x, qxz);
  f2_mul3(x3, xqx);
  f_mul_b3(t2b, t.z);
  f2_add(z3, yqy, t2b);
  f2_sub(t1b, yqy, t2b);
  f_mul_b3(y3b, y3);
  fp2 c0, c_v2w, p1, p2, p3, p4, p5, p6;
  b.mul_fp(c0, s0, py);
  b.mul_fp(c_v2w, s2, px);
  b.mul(p1, t3, t1b);
  b.mul(p2, t4, y3b);
  b.mul(p3, y3b, x3);
  b.mul(p4, t1b, z3);
  b.mul(p5, z3, t4);
  b.mul(p6, x3, t3);
  b.run(g);
  f2_sub(t.x, p1, p2);
  f2_add(t.y, p3, p4);
  f2_add(t.z, p5, p6);
  f2_neg(c_v2w, c_v2w);
  miller_line(f, c0, c_vw, c_v2w, false, g);
}

// P = (px, py) affine G1 and Q = (qx, qy) affine twist points, in
// Montgomery form, neither the identity
template <class G>
__device__ BLS_NOINLINE void miller_loop(fp12& f, const fp& px, const fp& py, const fp2& qx,
                                         const fp2& qy, G& g) {
  proj<fp2> t;
  pt_from_affine(t, qx, qy);
  f12_one(f);
  for (int i = exp_nbits(E_X) - 2; i >= 0; --i) {
    miller_dbl(f, t, px, py, i == exp_nbits(E_X) - 2, g);
    if (exp_bit(E_X, i)) miller_add(f, t, px, py, qx, qy, g);
  }
  f12_conj(f, f);
}

// ----------------------------------------------- the final exponentiation

// a^|x| or a^(|x| + 1) for a = conj(b), b in the cyclotomic subgroup
// (inverse = conjugate, x < 0): b^x and b^(x - 1)
template <class G>
__device__ BLS_NOINLINE void cyclo_exp_x(fp12& o, const fp12& b, bool plus_one, G& g) {
  fp12 c, acc;
  f12_conj(c, b);
  acc = c;
  for (int i = exp_nbits(E_X) - 2; i >= 0; --i) {
    g12_cyclo_sq(acc, acc, g);
    if (exp_bit(E_X, i)) g12_mul(acc, acc, c, g);
  }
  if (plus_one) g12_mul(acc, acc, c, g);
  o = acc;
}

// the oracle's bls_final_exp: easy part, then
// (x-1)^2 (x+p) (x^2+p^2-1) + 3; every square after the easy part is
// cyclotomic
template <class G>
__device__ BLS_NOINLINE void final_exp(fp12& o, const fp12& f_in, G& g) {
  fp12 f, t, y, y2;
  f12_conj(t, f_in);
  f12_inv(f, f_in);
  g12_mul(f, t, f, g);
  f12_frob(t, f, 2);
  g12_mul(f, t, f, g);
  cyclo_exp_x(y, f, true, g);
  cyclo_exp_x(y, y, true, g);
  cyclo_exp_x(t, y, false, g);
  f12_frob(y2, y, 1);
  g12_mul(y, t, y2, g);
  cyclo_exp_x(y2, y, false, g);
  cyclo_exp_x(y2, y2, false, g);
  f12_frob(t, y, 2);
  g12_mul(y2, y2, t, g);
  f12_conj(t, y);
  g12_mul(y, y2, t, g);
  g12_cyclo_sq(t, f, g);
  g12_mul(t, t, f, g);
  g12_mul(o, y, t, g);
}

// ------------------------------------------------------------ lane bodies
// What one thread of each kernel does for one lane, on the kernels' (rows,
// B) planes (row r of lane j at r * B + j). bls12381.cu launches them; a
// host build runs them lane by lane.

template <class T>
__device__ __forceinline__ void aff_ld(T& x, T& y, const uint32_t* p, long long B, long long j);
template <>
__device__ __forceinline__ void aff_ld(fp& x, fp& y, const uint32_t* p, long long B, long long j) {
  fp_ld(x, p, B, j);
  fp_ld(y, p + NW * B, B, j);
}
template <>
__device__ __forceinline__ void aff_ld(fp2& x, fp2& y, const uint32_t* p, long long B, long long j) {
  f2_ld(x, p, B, j);
  f2_ld(y, p + 2 * NW * B, B, j);
}
__device__ __forceinline__ void aff_st(uint32_t* p, long long B, long long j, const fp& x, const fp& y) {
  fp_st(p, B, j, x);
  fp_st(p + NW * B, B, j, y);
}
__device__ __forceinline__ void aff_st(uint32_t* p, long long B, long long j, const fp2& x,
                                       const fp2& y) {
  f2_st(p, B, j, x);
  f2_st(p + 2 * NW * B, B, j, y);
}

// B1 on a group: raw x planes (35 limbs a component, components B * 35
// apart) and the sign flag -> affine (x, y) and ok (the root exists, and
// with check_sub the point is in G1 or G2). Every thread of a group
// decompresses (the roots are exponentiations in Fp, not split); on a trio
// G2's subgroup test splits its Fp2 products three ways and G1's its
// Jacobian steps' rounds of Fp products. Thread 0 stores.
template <int GRP, class G>
__device__ __forceinline__ void group_decompress(const int32_t* x_raw, const int32_t* sign,
                                                 int check_sub, long long B, long long j,
                                                 uint32_t* out, int32_t* ok, G& g) {
  bool k;
  if constexpr (GRP == 1) {
    fp x, y;
    fp_from_limbs11(x, x_raw + j, B);
    k = g1_decompress(y, x, sign[j] != 0);
    if (check_sub && k) {
      if constexpr (G::N == 1) {
        jac1 p{x, y, {}};
        fp_one(p.z);
        k = jac_in_g1(p);
      } else {
        k = g1_in_subgroup_trio(x, y, g);
      }
    }
    if (g.t == 0) aff_st(out, B, j, x, y);
  } else {
    fp2 x, y;
    fp_from_limbs11(x.a, x_raw + j, B);
    fp_from_limbs11(x.b, x_raw + NL * B + j, B);
    k = g2_decompress(y, x, sign[j] != 0);
    if (check_sub && k) {
      jac p{x, y, {}};
      f2_one(p.z);
      k = jac_in_g2(p, g);
    }
    if (g.t == 0) aff_st(out, B, j, x, y);
  }
  if (g.t == 0) ok[j] = k;
}

// B1 one lane a thread
template <int GRP>
__device__ __forceinline__ void lane_decompress(const int32_t* x_raw, const int32_t* sign,
                                                int check_sub, long long B, long long j,
                                                uint32_t* out, int32_t* ok) {
  solo g;
  group_decompress<GRP>(x_raw, sign, check_sub, B, j, out, ok, g);
}

// B3, the segmented sum, in two phases where groups are wide: phase 1
// cuts each group's lanes into S slices, one block a slice, each thread
// summing a stride of its slice's lanes from their affine points
// (sum_lanes: the first point, then mixed additions), the block's threads'
// partials meeting in a tree (sum_tree_level) and the block's sum stored as
// a projective partial (proj_st); phase 2, one block a group, sums the
// group's S partials the same way (sum_parts, complete additions), then the
// tail: the sum to affine with its identity flag (sum_affine) and, with the
// check, whether it is in the subgroup. Narrow groups (S = 1) take phase 2
// alone, on their lanes. Every addition is complete (RCB), so repeated
// points, a point and its negative and identity partials need no branch;
// the affine sum is unique, whatever the order. bls12381.cu launches these
// pieces; a host build runs them thread by thread.

template <class T>
__device__ __forceinline__ void proj_ld(proj<T>& o, const uint32_t* p, long long B, long long j) {
  constexpr int W = nwords<T>;
  f_ld(o.x, p, B, j);
  f_ld(o.y, p + W * B, B, j);
  f_ld(o.z, p + 2 * W * B, B, j);
}

template <class T>
__device__ __forceinline__ void proj_st(uint32_t* p, long long B, long long j, const proj<T>& a) {
  constexpr int W = nwords<T>;
  f_st(p, B, j, a.x);
  f_st(p + W * B, B, j, a.y);
  f_st(p + 2 * W * B, B, j, a.z);
}

// slice s of S of the lanes [a, b): [lo, hi)
__device__ __forceinline__ void sum_slice(long long& lo, long long& hi, long long a, long long b,
                                          int s, int S) {
  lo = a + (b - a) * s / S;
  hi = a + (b - a) * (s + 1) / S;
}

// thread t of nt: the sum of the affine points of lanes order[lo + t],
// order[lo + t + nt], ... below hi (the identity where it has none)
template <class T>
__device__ __forceinline__ void sum_lanes(proj<T>& acc, const uint32_t* pts, long long N,
                                          const int32_t* order, long long lo, long long hi, int t,
                                          int nt) {
  pt_identity(acc);
  for (long long k = lo + t; k < hi; k += nt) {
    T x, y;
    aff_ld(x, y, pts, N, order[k]);
    if (k == lo + t) {
      pt_from_affine(acc, x, y);
    } else {
      pt_add_aff(acc, acc, x, y);
    }
  }
}

// thread t of nt: the sum of the partials in columns base + t, base + t +
// nt, ... below base + count of the (3 W, cols) partial planes
template <class T>
__device__ __forceinline__ void sum_parts(proj<T>& acc, const uint32_t* parts, long long cols,
                                          long long base, int count, int t, int nt) {
  pt_identity(acc);
  for (int k = t; k < count; k += nt) {
    proj<T> q;
    proj_ld(q, parts, cols, base + k);
    if (k == t) {
      acc = q;
    } else {
      pt_add(acc, acc, q);
    }
  }
}

// one level of the tree over the m partials part[0..m): thread t < m - h
// adds part[t + h] into part[t], h = ceil(m / 2); returns h, the partials
// left. A level's writes (below m - h) and reads (from h) never meet.
template <class T>
__device__ __forceinline__ int sum_tree_level(proj<T>* part, int t, int m) {
  const int h = (m + 1) / 2;
  if (t < m - h) pt_add(part[t], part[t], part[t + h]);
  return h;
}

// B3's tail: group g's sum to affine and its identity flag
template <class T>
__device__ __forceinline__ void sum_affine(const proj<T>& s, long long G, long long g,
                                           uint32_t* out, int32_t* is_id) {
  T x, y;
  is_id[g] = pt_to_affine(x, y, s);
  aff_st(out, G, g, x, y);
}

// B4 on a group: P affine G1 (x, y planes), Q affine twist -> the Miller
// value; thread 0 stores
template <class G>
__device__ __forceinline__ void group_miller(const uint32_t* p, const uint32_t* q, long long L,
                                             long long j, uint32_t* f, G& g) {
  fp px, py;
  fp2 qx, qy;
  aff_ld(px, py, p, L, j);
  aff_ld(qx, qy, q, L, j);
  fp12 r;
  miller_loop(r, px, py, qx, qy, g);
  if (g.t == 0) f12_st(f, L, j, r);
}

// B4 one pair a thread
__device__ __forceinline__ void lane_miller(const uint32_t* p, const uint32_t* q, long long L,
                                            long long j, uint32_t* f) {
  solo g;
  group_miller(p, q, L, j, f, g);
}

// B2 on a group: the raw hash_to_field planes (u0.c0, u0.c1, u1.c0, u1.c1,
// 35 limbs each) -> affine H(m) and whether it is the identity. On a trio
// threads 0 and 1 map u0 and u1 at once (thread 2 maps u1 again) and trade
// the points; the sum's cofactor clearing then splits each Fp2 product.
template <class G>
__device__ __forceinline__ void group_hash_to_g2(const int32_t* u, long long B, long long j,
                                                 uint32_t* out, int32_t* is_id, G& g) {
  proj<fp2> q0, q1;
  if constexpr (G::N == 1) {
    fp2 u0, u1;
    fp_from_limbs11(u0.a, u + j, B);
    fp_from_limbs11(u0.b, u + NL * B + j, B);
    fp_from_limbs11(u1.a, u + 2 * NL * B + j, B);
    fp_from_limbs11(u1.b, u + 3 * NL * B + j, B);
    svdw_map(q0, u0);
    svdw_map(q1, u1);
  } else {
    const long long k = g.t == 0 ? 0 : 2;
    fp2 uk;
    fp_from_limbs11(uk.a, u + k * NL * B + j, B);
    fp_from_limbs11(uk.b, u + (k + 1) * NL * B + j, B);
    svdw_map(q0, uk);
    tr_put(g, words_of(q0), 2 * nwords<fp2>);  // x, y (z = 1)
    from_words(q0.x, g.at(0));
    from_words(q0.y, g.at(0) + nwords<fp2>);
    from_words(q1.x, g.at(1));
    from_words(q1.y, g.at(1) + nwords<fp2>);
    f2_one(q1.z);
  }
  pt_add(q0, q0, q1);
  jac q, h;
  jac_from_proj(q, q0);
  jac_clear_cofactor(h, q, g);
  fp2 x, y;
  const bool id = jac_to_affine(x, y, h);
  if (g.t == 0) {
    is_id[j] = id;
    aff_st(out, B, j, x, y);
  }
}

// B2 one lane a thread
__device__ __forceinline__ void lane_hash_to_g2(const int32_t* u, long long B, long long j,
                                                uint32_t* out, int32_t* is_id) {
  solo g;
  group_hash_to_g2(u, B, j, out, is_id, g);
}

// B5's product on a group: trio r of the T trios that share a check
// multiplies the Miller values of lanes[a + r], lanes[a + r + T], ..., then
// the T partial products meet in a tree in `part` (T x 144 words, shared by
// the check's trios; grp syncs them). The product is the check's; on T = 1
// part is not used.
template <class G, class Grp>
__device__ __forceinline__ void group_product(fp12& acc, const uint32_t* f, long long L,
                                              const int32_t* lanes, int a, int b, int r, int T,
                                              G& g, Grp& grp, uint32_t* part) {
  bool have = false;
  for (int i = a + r; i < b; i += T) {
    fp12 v;
    f12_ld(v, f, L, lanes[i]);
    if (have) {
      g12_mul(acc, acc, v, g);
    } else {
      acc = v;
    }
    have = true;
  }
  if (!have) f12_one(acc);
  if (T == 1) return;
  constexpr int W = nwords<fp12>;
  if (g.t == 0) f12_st(part + r * W, 1, 0, acc);
  grp.sync();
  for (int m = T; m > 1;) {
    const int h = (m + 1) / 2;
    if (r < m - h) {
      fp12 x, y;
      f12_ld(x, part + r * W, 1, 0);
      f12_ld(y, part + (r + h) * W, 1, 0);
      g12_mul(x, x, y, g);
      if (g.t == 0) f12_st(part + r * W, 1, 0, x);
    }
    grp.sync();
    m = h;
  }
  f12_ld(acc, part, 1, 0);
}

// B5 on a group: check c's product (group_product), then on its first trio
// (r = 0) the final exponentiation and the compare with one, and-ed with the
// gates and forced true by `force` (any may be null). Returns the verdict on
// thread 0 of trio 0, -1 on every other thread.
template <class G, class Grp>
__device__ __forceinline__ int group_final_exp(const uint32_t* f, long long L,
                                               const int32_t* lanes, const int32_t* starts,
                                               long long C, long long c, int r, int T, G& g,
                                               Grp& grp, uint32_t* part, const int32_t* gate_a,
                                               const int32_t* gate_b, const int32_t* force,
                                               uint32_t* e_out, int32_t* ok) {
  fp12 acc, e;
  group_product(acc, f, L, lanes, starts[c], starts[c + 1], r, T, g, grp, part);
  if (r != 0) return -1;
  final_exp(e, acc, g);
  if (g.t != 0) return -1;
  f12_st(e_out, C, c, e);
  bool v = f12_is_one(e);
  if (gate_a) v = v && gate_a[c] != 0;
  if (gate_b) v = v && gate_b[c] != 0;
  if (force && force[c] != 0) v = true;
  ok[c] = v;
  return v;
}

// B5 one check a thread; returns the verdict
__device__ __forceinline__ bool lane_final_exp(const uint32_t* f, long long L, const int32_t* lanes,
                                               const int32_t* starts, long long C, long long c,
                                               const int32_t* gate_a, const int32_t* gate_b,
                                               const int32_t* force, uint32_t* e_out, int32_t* ok) {
  solo g;
  return group_final_exp(f, L, lanes, starts, C, c, 0, 1, g, g, nullptr, gate_a, gate_b, force,
                         e_out, ok) != 0;
}

}  // namespace bls
