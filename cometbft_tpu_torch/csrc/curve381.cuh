// The BLS12-381 groups and the pairing over tower381.cuh, one lane per
// thread: G1 over Fp (y^2 = x^3 + 4), G2 on the twist over Fp2
// (y^2 = x^3 + 4(1 + u)), complete projective formulas (Renes-Costello-Batina
// 2015, algorithms 7 and 9 for a = 0), the fixed-scalar ladders (the subgroup
// order r, the G2 cofactor), decompression, the SvdW hash-to-G2 map, the
// optimal-ate Miller loop and the final exponentiation. Each is the plain
// version's function (ops/bls12381/points.py, htc.py, pairing.py) value for
// value: the Miller loop keeps the plain version's projective T and line
// scalings, so its Fp12 output equals the plain one, and the final
// exponentiation is the oracle's chain.

#pragma once

#include "tower381.cuh"

namespace bls {

// ------------------------------------------------- field-generic point code

__device__ __forceinline__ void f_add(fp& o, const fp& a, const fp& b) { fp_add(o, a, b); }
__device__ __forceinline__ void f_add(fp2& o, const fp2& a, const fp2& b) { f2_add(o, a, b); }
__device__ __forceinline__ void f_sub(fp& o, const fp& a, const fp& b) { fp_sub(o, a, b); }
__device__ __forceinline__ void f_sub(fp2& o, const fp2& a, const fp2& b) { f2_sub(o, a, b); }
__device__ __forceinline__ void f_mul(fp& o, const fp& a, const fp& b) { fp_mul(o, a, b); }
__device__ __forceinline__ void f_mul(fp2& o, const fp2& a, const fp2& b) { f2_mul(o, a, b); }
__device__ __forceinline__ void f_neg(fp& o, const fp& a) { fp_neg(o, a); }
__device__ __forceinline__ void f_neg(fp2& o, const fp2& a) { f2_neg(o, a); }
__device__ __forceinline__ void f_mul3(fp& o, const fp& a) { fp_mul3(o, a); }
__device__ __forceinline__ void f_mul3(fp2& o, const fp2& a) { f2_mul3(o, a); }
__device__ __forceinline__ bool f_is_zero(const fp& a) { return fp_is_zero(a); }
__device__ __forceinline__ bool f_is_zero(const fp2& a) { return f2_is_zero(a); }
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
// public bit is set)
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

// [r]P == O; the identity counts as in the subgroup
template <class T>
__device__ __forceinline__ bool pt_in_subgroup(const proj<T>& p) {
  proj<T> r;
  pt_mul_const(r, p, E_R);
  return f_is_zero(r.z);
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

__device__ __forceinline__ bool g2_decompress(fp2& y, const fp2& x, bool sign) {
  fp2 t, b;
  f2_sq(t, x);
  f2_mul(t, t, x);
  f2_k(b, K_B2);
  f2_add(t, t, b);
  const bool ok = f2_sqrt(y, t);
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

// map_to_curve_svdw on the twist (RFC 9380 §6.6.1), branch-free
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
  f2_sqrt(y, gx);
  f2_neg(t, y);
  f2_sel(y, f2_sgn0(u) != f2_sgn0(y), t, y);
  pt_from_affine(o, x, y);
}

// SvdW both field elements, add, clear the cofactor
__device__ __forceinline__ void map_to_g2(proj<fp2>& o, const fp2& u0, const fp2& u1) {
  proj<fp2> q0, q1;
  svdw_map(q0, u0);
  svdw_map(q1, u1);
  pt_add(q0, q0, q1);
  pt_mul_const(o, q0, E_H2);
}

// ------------------------------------------------------------------ pairing

// the sparse line c0 + c_vw v w + c_v2w v^2 w
__device__ __forceinline__ void line_f12(fp12& o, const fp2& c0, const fp2& c_vw, const fp2& c_v2w) {
  fp2 xi_inv;
  f2_k(xi_inv, K_XI_INV);
  f12_one(o);
  o.d0.c0 = c0;
  f2_mul(o.d1.c1, c_vw, xi_inv);
  f2_mul(o.d1.c2, c_v2w, xi_inv);
}

// f_{|x|,Q}(P), conjugated (x < 0); P = (px, py) affine G1 and Q = (qx, qy)
// affine twist points, in Montgomery form. Non-identity inputs.
__device__ BLS_NOINLINE void miller_loop(fp12& f, const fp& px, const fp& py, const fp2& qx,
                                         const fp2& qy) {
  proj<fp2> t, q;
  pt_from_affine(q, qx, qy);
  t = q;
  f12_one(f);
  for (int i = exp_nbits(E_X) - 2; i >= 0; --i) {
    // tangent at T, scaled by 2 Y Z^2
    fp2 xx, yz, yy, c0, c_vw, c_v2w, s, u;
    fp12 l;
    f2_mul(xx, t.x, t.x);
    f2_mul(yz, t.y, t.z);
    f2_mul(yy, t.y, t.y);
    f2_mul(s, yz, t.z);
    f2_dbl(s, s);
    f2_mul_fp(c0, s, py);
    f2_mul3(s, t.x);
    f2_mul(c_vw, xx, s);
    f2_mul(s, yy, t.z);
    f2_dbl(s, s);
    f2_sub(c_vw, c_vw, s);
    f2_mul(s, xx, t.z);
    f2_mul3(s, s);
    f2_mul_fp(s, s, px);
    f2_neg(c_v2w, s);
    f12_sq(f, f);
    line_f12(l, c0, c_vw, c_v2w);
    f12_mul(f, f, l);
    pt_dbl(t, t);
    if (exp_bit(E_X, i)) {
      // chord through the new T and Q, scaled by X - xQ Z
      f2_mul(s, qx, t.z);
      f2_sub(s, t.x, s);
      f2_mul_fp(c0, s, py);
      f2_mul(s, qy, t.z);
      f2_sub(s, t.y, s);
      f2_mul_fp(s, s, px);
      f2_neg(c_v2w, s);
      f2_mul(s, t.y, qx);
      f2_mul(u, t.x, qy);
      f2_sub(c_vw, s, u);
      line_f12(l, c0, c_vw, c_v2w);
      f12_mul(f, f, l);
      pt_add(t, t, q);
    }
  }
  f12_conj(f, f);
}

// a^e for e = +-|x| or +-(|x| + 1), a in the cyclotomic subgroup (inverse =
// conjugate): x - 1 = -(|x| + 1)
__device__ __forceinline__ void cyclo_exp_x(fp12& o, const fp12& a, bool plus_one) {
  fp12 c;
  f12_conj(c, a);  // x < 0
  f12_pow(o, c, E_X);
  if (plus_one) f12_mul(o, o, c);
}

// the oracle's bls_final_exp: easy part, then
// (x-1)^2 (x+p) (x^2+p^2-1) + 3
__device__ BLS_NOINLINE void final_exp(fp12& o, const fp12& f_in) {
  fp12 f, t, y, y2;
  f12_conj(t, f_in);
  f12_inv(f, f_in);
  f12_mul(f, t, f);
  f12_frob(t, f, 2);
  f12_mul(f, t, f);
  cyclo_exp_x(y, f, true);
  cyclo_exp_x(y, y, true);
  cyclo_exp_x(t, y, false);
  f12_frob(y2, y, 1);
  f12_mul(y, t, y2);
  cyclo_exp_x(y2, y, false);
  cyclo_exp_x(y2, y2, false);
  f12_frob(t, y, 2);
  f12_mul(y2, y2, t);
  f12_conj(t, y);
  f12_mul(y, y2, t);
  f12_sq(t, f);
  f12_mul(t, t, f);
  f12_mul(o, y, t);
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

// B1: raw x planes (35 limbs a component, components B * 35 apart) and the
// sign flag -> affine (x, y) and ok (the root exists, and with check_sub
// [r]P == O)
template <int G>
__device__ __forceinline__ void lane_decompress(const int32_t* x_raw, const int32_t* sign,
                                                int check_sub, long long B, long long j,
                                                uint32_t* out, int32_t* ok) {
  bool k;
  if constexpr (G == 1) {
    fp x, y;
    fp_from_limbs11(x, x_raw + j, B);
    k = g1_decompress(y, x, sign[j] != 0);
    if (check_sub && k) {
      proj<fp> p;
      pt_from_affine(p, x, y);
      k = pt_in_subgroup(p);
    }
    aff_st(out, B, j, x, y);
  } else {
    fp2 x, y;
    fp_from_limbs11(x.a, x_raw + j, B);
    fp_from_limbs11(x.b, x_raw + NL * B + j, B);
    k = g2_decompress(y, x, sign[j] != 0);
    if (check_sub && k) {
      proj<fp2> p;
      pt_from_affine(p, x, y);
      k = pt_in_subgroup(p);
    }
    aff_st(out, B, j, x, y);
  }
  ok[j] = k;
}

// B2: the raw hash_to_field planes (u0.c0, u0.c1, u1.c0, u1.c1, 35 limbs
// each) -> affine H(m) and whether it is the identity
__device__ __forceinline__ void lane_hash_to_g2(const int32_t* u, long long B, long long j,
                                                uint32_t* out, int32_t* is_id) {
  fp2 u0, u1, x, y;
  fp_from_limbs11(u0.a, u + j, B);
  fp_from_limbs11(u0.b, u + NL * B + j, B);
  fp_from_limbs11(u1.a, u + 2 * NL * B + j, B);
  fp_from_limbs11(u1.b, u + 3 * NL * B + j, B);
  proj<fp2> h;
  map_to_g2(h, u0, u1);
  is_id[j] = pt_to_affine(x, y, h);
  aff_st(out, B, j, x, y);
}

// B3: one group's sum over lanes order[a..b) (stepping by `step` from a),
// from affine points, into acc
template <class T>
__device__ __forceinline__ void lane_partial_sum(proj<T>& acc, const uint32_t* pts, long long N,
                                                 const int32_t* order, int a, int b, int step) {
  pt_identity(acc);
  for (int k = a; k < b; k += step) {
    T x, y;
    aff_ld(x, y, pts, N, order[k]);
    proj<T> p;
    pt_from_affine(p, x, y);
    pt_add(acc, acc, p);
  }
}

// B3's last step: the sum to affine, its identity flag and, with check_sub,
// whether it is in the subgroup
template <class T>
__device__ __forceinline__ void lane_sum_out(const proj<T>& s, int check_sub, long long G,
                                             long long g, uint32_t* out, int32_t* is_id,
                                             int32_t* sub_ok) {
  T x, y;
  is_id[g] = pt_to_affine(x, y, s);
  sub_ok[g] = check_sub ? pt_in_subgroup(s) : 1;
  aff_st(out, G, g, x, y);
}

// B4: P affine G1 (x, y planes), Q affine twist -> the Miller value
__device__ __forceinline__ void lane_miller(const uint32_t* p, const uint32_t* q, long long L,
                                            long long j, uint32_t* f) {
  fp px, py;
  fp2 qx, qy;
  aff_ld(px, py, p, L, j);
  aff_ld(qx, qy, q, L, j);
  fp12 r;
  miller_loop(r, px, py, qx, qy);
  f12_st(f, L, j, r);
}

// B5: check c multiplies the Miller values of lanes[starts[c]..starts[c+1]),
// exponentiates, and compares with one; the verdict is and-ed with the
// gates and forced true by `force` (any may be null). Returns the verdict.
__device__ __forceinline__ bool lane_final_exp(const uint32_t* f, long long L, const int32_t* lanes,
                                               const int32_t* starts, long long C, long long c,
                                               const int32_t* gate_a, const int32_t* gate_b,
                                               const int32_t* force, uint32_t* e_out, int32_t* ok) {
  fp12 acc, v;
  f12_one(acc);
  for (int k = starts[c]; k < starts[c + 1]; ++k) {
    f12_ld(v, f, L, lanes[k]);
    f12_mul(acc, acc, v);
  }
  final_exp(v, acc);
  f12_st(e_out, C, c, v);
  bool r = f12_is_one(v);
  if (gate_a) r = r && gate_a[c] != 0;
  if (gate_b) r = r && gate_b[c] != 0;
  if (force && force[c] != 0) r = true;
  ok[c] = r;
  return r;
}

}  // namespace bls
