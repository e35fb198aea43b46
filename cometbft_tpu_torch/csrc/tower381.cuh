// The BLS12-381 extension tower over fp381.cuh, one lane per thread:
// Fp2 = Fp[u]/(u^2 + 1), Fp6 = Fp2[v]/(v^3 - xi), Fp12 = Fp6[w]/(w^2 - v),
// xi = 1 + u. The formulas are the oracle's (crypto/bls12381_math.py f2_*,
// f6_*, f12_*); every element is fully reduced, so values compare word for
// word with the plain version's canonical values (ops/bls12381/tower.py).
// An Fp12 is 144 words: the kernels keep it in the thread's stack frame.
// Products are out of line down to Fp2, whose Fp products inline and
// interleave.

#pragma once

#include "fp381.cuh"

namespace bls {

struct fp2 {
  fp a, b;
};
struct fp6 {
  fp2 c0, c1, c2;
};
struct fp12 {
  fp6 d0, d1;
};

// -------------------------------------------------------------------- Fp2

__device__ __forceinline__ void f2_k(fp2& o, int off) {
  fp_k(o.a, off);
  fp_k(o.b, off + NW);
}

__device__ __forceinline__ void f2_zero(fp2& o) {
  fp_zero(o.a);
  fp_zero(o.b);
}

__device__ __forceinline__ void f2_one(fp2& o) {
  fp_one(o.a);
  fp_zero(o.b);
}

__device__ __forceinline__ bool f2_is_zero(const fp2& x) { return fp_is_zero(x.a) && fp_is_zero(x.b); }

__device__ __forceinline__ bool f2_eq(const fp2& x, const fp2& y) {
  return fp_eq(x.a, y.a) && fp_eq(x.b, y.b);
}

__device__ __forceinline__ void f2_sel(fp2& o, bool c, const fp2& x, const fp2& y) {
  fp_sel(o.a, c, x.a, y.a);
  fp_sel(o.b, c, x.b, y.b);
}

__device__ __forceinline__ void f2_add(fp2& o, const fp2& x, const fp2& y) {
  fp_add(o.a, x.a, y.a);
  fp_add(o.b, x.b, y.b);
}

__device__ __forceinline__ void f2_sub(fp2& o, const fp2& x, const fp2& y) {
  fp_sub(o.a, x.a, y.a);
  fp_sub(o.b, x.b, y.b);
}

__device__ __forceinline__ void f2_neg(fp2& o, const fp2& x) {
  fp_neg(o.a, x.a);
  fp_neg(o.b, x.b);
}

__device__ __forceinline__ void f2_dbl(fp2& o, const fp2& x) { f2_add(o, x, x); }

__device__ __forceinline__ void f2_mul3(fp2& o, const fp2& x) {
  fp_mul3(o.a, x.a);
  fp_mul3(o.b, x.b);
}

__device__ __forceinline__ void f2_conj(fp2& o, const fp2& x) {
  o.a = x.a;
  fp_neg(o.b, x.b);
}

// Karatsuba: (a0 b0 - a1 b1, (a0 + a1)(b0 + b1) - a0 b0 - a1 b1); inlined
// in the cyclotomic square, f2_mul out of line elsewhere (a longer inlined
// run of products measured slower on the card: the code outgrows the
// instruction cache)
__device__ __forceinline__ void f2_mul_in(fp2& o, const fp2& x, const fp2& y) {
  fp t0, t1, sa, sb, t2;
  fp_mul(t0, x.a, y.a);
  fp_mul(t1, x.b, y.b);
  fp_add(sa, x.a, x.b);
  fp_add(sb, y.a, y.b);
  fp_mul(t2, sa, sb);
  fp_sub(o.a, t0, t1);
  fp_sub(t2, t2, t0);
  fp_sub(o.b, t2, t1);
}

__device__ BLS_NOINLINE void f2_mul(fp2& o, const fp2& x, const fp2& y) { f2_mul_in(o, x, y); }

// ((a0 + a1)(a0 - a1), 2 a0 a1)
__device__ BLS_NOINLINE void f2_sq(fp2& o, const fp2& x) {
  fp s, d, m;
  fp_add(s, x.a, x.b);
  fp_sub(d, x.a, x.b);
  fp_mul(m, x.a, x.b);
  fp_mul(o.a, s, d);
  fp_dbl(o.b, m);
}

__device__ __forceinline__ void f2_mul_fp(fp2& o, const fp2& x, const fp& k) {
  fp_mul(o.a, x.a, k);
  fp_mul(o.b, x.b, k);
}

// (1 + u) x = (a0 - a1) + (a0 + a1) u
__device__ __forceinline__ void f2_mul_xi(fp2& o, const fp2& x) {
  fp t;
  fp_sub(t, x.a, x.b);
  fp_add(o.b, x.a, x.b);
  o.a = t;
}

// xi^-1 x = (1 - u) x / 2 = ((a0 + a1) / 2, (a1 - a0) / 2): additions and
// halvings, no product (f2_mul(x, K_XI_INV)'s value)
__device__ __forceinline__ void f2_mul_xi_inv(fp2& o, const fp2& x) {
  fp s, d;
  fp_add(s, x.a, x.b);
  fp_sub(d, x.b, x.a);
  fp_half(o.a, s);
  fp_half(o.b, d);
}

__device__ __forceinline__ void f2_norm(fp& o, const fp2& x) {
  fp s, t;
  fp_sq(s, x.a);
  fp_sq(t, x.b);
  fp_add(o, s, t);
}

// through the norm; inv(0) = 0
__device__ BLS_NOINLINE void f2_inv(fp2& o, const fp2& x) {
  fp n;
  f2_norm(n, x);
  fp_inv(n, n);
  fp_mul(o.a, x.a, n);
  fp_mul(o.b, x.b, n);
  fp_neg(o.b, o.b);
}

// x^e for a fixed exponent of the table, MSB first
__device__ BLS_NOINLINE void f2_pow(fp2& o, const fp2& x, int e) {
  fp2 acc;
  f2_one(acc);
  for (int i = exp_nbits(e) - 1; i >= 0; --i) {
    f2_sq(acc, acc);
    if (exp_bit(e, i)) f2_mul(acc, acc, x);
  }
  o = acc;
}

// the norm's Legendre symbol is not -1 (zero counts as a square)
__device__ __forceinline__ bool f2_is_square(const fp2& x) {
  fp n;
  f2_norm(n, x);
  return fp_legendre(n) != -1;
}

// algorithm 9 of eprint 2012/685 (p = 3 mod 4), branch-free as the plain
// version: returns whether the candidate squares back to x
__device__ BLS_NOINLINE bool f2_sqrt(fp2& o, const fp2& x) {
  fp2 a1, alpha, x0, t, ux0, b, cand;
  f2_pow(a1, x, E_SQRT2);
  f2_sq(t, a1);
  f2_mul(alpha, t, x);
  f2_mul(x0, a1, x);
  const bool is_m1 = fp_eq_k(alpha.a, K_MINUS1) && fp_is_zero(alpha.b);
  fp_neg(ux0.a, x0.b);
  ux0.b = x0.a;
  f2_one(t);
  f2_add(t, t, alpha);
  f2_pow(b, t, E_LEG);
  f2_mul(b, b, x0);
  f2_sel(cand, is_m1, ux0, b);
  f2_sq(t, cand);
  o = cand;
  return f2_eq(t, x);
}

// a root by the norm, with roots in Fp only (Adj and Rodriguez-Henriquez
// 2012, algorithm 8 for q = 3 mod 4): s = sqrt(a0^2 + a1^2), d = (a0 + s)/2
// (or (a0 - s)/2 when that is not a square), w = d^((p-3)/4) = 1/sqrt(d),
// root = d w + (a1 w / 2) u: two exponentiations in Fp instead of two in
// Fp2. Where the candidate does not square back (x not a square, or d = 0
// with x != 0) it is f2_sqrt's, so the result and the flag are always
// f2_sqrt's up to the root's sign.
__device__ BLS_NOINLINE bool f2_sqrt_fast(fp2& o, const fp2& x) {
  fp n, s, d, w;
  f2_norm(n, x);
  fp_pow(s, n, E_SQRT);
  fp_add(d, x.a, s);
  fp_half(d, d);
  if (fp_legendre(d) == -1) {
    fp_sub(d, x.a, s);
    fp_half(d, d);
  }
  fp_pow(w, d, E_SQRT2);
  fp2 cand, t;
  fp_mul(cand.a, d, w);
  fp_mul(cand.b, x.b, w);
  fp_half(cand.b, cand.b);
  f2_sq(t, cand);
  if (f2_eq(t, x)) {
    o = cand;
    return true;
  }
  return f2_sqrt(o, x);
}

// RFC 9380 sgn0 for m = 2
__device__ __forceinline__ int f2_sgn0(const fp2& x) {
  fp ra, rb;
  fp_from_mont(ra, x.a);
  fp_from_mont(rb, x.b);
  return (int)(ra.v[0] & 1) | ((int)fp_is_zero(ra) & (int)(rb.v[0] & 1));
}

// the serialization's sign rule: the imaginary part decides unless zero
__device__ __forceinline__ bool f2_lexi_larger(const fp2& y) {
  fp ra, rb;
  fp_from_mont(ra, y.a);
  fp_from_mont(rb, y.b);
  return fp_is_zero(rb) ? raw_gt_half(ra) : raw_gt_half(rb);
}

__device__ __forceinline__ void f2_ld(fp2& o, const uint32_t* p, long long B, long long j) {
  fp_ld(o.a, p, B, j);
  fp_ld(o.b, p + NW * B, B, j);
}

__device__ __forceinline__ void f2_st(uint32_t* p, long long B, long long j, const fp2& x) {
  fp_st(p, B, j, x.a);
  fp_st(p + NW * B, B, j, x.b);
}

// -------------------------------------------------------------------- Fp6

__device__ __forceinline__ void f6_add(fp6& o, const fp6& x, const fp6& y) {
  f2_add(o.c0, x.c0, y.c0);
  f2_add(o.c1, x.c1, y.c1);
  f2_add(o.c2, x.c2, y.c2);
}

__device__ __forceinline__ void f6_sub(fp6& o, const fp6& x, const fp6& y) {
  f2_sub(o.c0, x.c0, y.c0);
  f2_sub(o.c1, x.c1, y.c1);
  f2_sub(o.c2, x.c2, y.c2);
}

__device__ __forceinline__ void f6_neg(fp6& o, const fp6& x) {
  f2_neg(o.c0, x.c0);
  f2_neg(o.c1, x.c1);
  f2_neg(o.c2, x.c2);
}

__device__ BLS_NOINLINE void f6_mul(fp6& o, const fp6& a, const fp6& b) {
  fp2 t0, t1, t2, s, u, m;
  f2_mul(t0, a.c0, b.c0);
  f2_mul(t1, a.c1, b.c1);
  f2_mul(t2, a.c2, b.c2);
  fp6 r;
  // c0 = t0 + xi ((a1 + a2)(b1 + b2) - t1 - t2)
  f2_add(s, a.c1, a.c2);
  f2_add(u, b.c1, b.c2);
  f2_mul(m, s, u);
  f2_add(s, t1, t2);
  f2_sub(m, m, s);
  f2_mul_xi(m, m);
  f2_add(r.c0, t0, m);
  // c1 = (a0 + a1)(b0 + b1) - t0 - t1 + xi t2
  f2_add(s, a.c0, a.c1);
  f2_add(u, b.c0, b.c1);
  f2_mul(m, s, u);
  f2_add(s, t0, t1);
  f2_sub(m, m, s);
  f2_mul_xi(u, t2);
  f2_add(r.c1, m, u);
  // c2 = (a0 + a2)(b0 + b2) - t0 - t2 + t1
  f2_add(s, a.c0, a.c2);
  f2_add(u, b.c0, b.c2);
  f2_mul(m, s, u);
  f2_add(s, t0, t2);
  f2_sub(m, m, s);
  f2_add(r.c2, m, t1);
  o = r;
}

// v (c0 + c1 v + c2 v^2) = xi c2 + c0 v + c1 v^2
__device__ __forceinline__ void f6_mul_v(fp6& o, const fp6& x) {
  fp2 t;
  f2_mul_xi(t, x.c2);
  o.c2 = x.c1;
  o.c1 = x.c0;
  o.c0 = t;
}

__device__ BLS_NOINLINE void f6_inv(fp6& o, const fp6& a) {
  fp2 c0, c1, c2, t, u;
  f2_sq(c0, a.c0);
  f2_mul(t, a.c1, a.c2);
  f2_mul_xi(t, t);
  f2_sub(c0, c0, t);
  f2_sq(c1, a.c2);
  f2_mul_xi(c1, c1);
  f2_mul(t, a.c0, a.c1);
  f2_sub(c1, c1, t);
  f2_sq(c2, a.c1);
  f2_mul(t, a.c0, a.c2);
  f2_sub(c2, c2, t);
  // t = 1 / (a0 c0 + xi (a2 c1 + a1 c2))
  f2_mul(t, a.c2, c1);
  f2_mul(u, a.c1, c2);
  f2_add(t, t, u);
  f2_mul_xi(t, t);
  f2_mul(u, a.c0, c0);
  f2_add(t, t, u);
  f2_inv(t, t);
  f2_mul(o.c0, c0, t);
  f2_mul(o.c1, c1, t);
  f2_mul(o.c2, c2, t);
}

// ------------------------------------------------------------------- Fp12

__device__ __forceinline__ void f12_one(fp12& o) {
  f2_one(o.d0.c0);
  f2_zero(o.d0.c1);
  f2_zero(o.d0.c2);
  f2_zero(o.d1.c0);
  f2_zero(o.d1.c1);
  f2_zero(o.d1.c2);
}

__device__ BLS_NOINLINE void f12_mul(fp12& o, const fp12& a, const fp12& b) {
  fp6 t0, t1, s, u;
  f6_mul(t0, a.d0, b.d0);
  f6_mul(t1, a.d1, b.d1);
  f6_add(s, a.d0, a.d1);
  f6_add(u, b.d0, b.d1);
  f6_mul(s, s, u);
  f6_sub(s, s, t0);
  f6_sub(o.d1, s, t1);
  f6_mul_v(t1, t1);
  f6_add(o.d0, t0, t1);
}

__device__ __forceinline__ void f12_conj(fp12& o, const fp12& a) {
  o.d0 = a.d0;
  f6_neg(o.d1, a.d1);
}

__device__ BLS_NOINLINE void f12_inv(fp12& o, const fp12& a) {
  fp6 t, u;
  f6_mul(t, a.d0, a.d0);
  f6_mul(u, a.d1, a.d1);
  f6_mul_v(u, u);
  f6_sub(t, t, u);
  f6_inv(t, t);
  f6_mul(o.d0, a.d0, t);
  f6_mul(u, a.d1, t);
  f6_neg(o.d1, u);
}

// x^(p^n) for n = 1 or 2: coefficients conjugated for odd n, times the
// table's gammas (coefficient order d0.c0, d0.c1, d0.c2, d1.c0, d1.c1, d1.c2)
__device__ BLS_NOINLINE void f12_frob(fp12& o, const fp12& a, int n) {
  const int base = n == 1 ? K_FROB1 : K_FROB2;
  const fp2* in[6] = {&a.d0.c0, &a.d0.c1, &a.d0.c2, &a.d1.c0, &a.d1.c1, &a.d1.c2};
  fp2* out[6] = {&o.d0.c0, &o.d0.c1, &o.d0.c2, &o.d1.c0, &o.d1.c1, &o.d1.c2};
  fp2 r[6];
  for (int k = 0; k < 6; ++k) {
    fp2 c, g;
    if (n & 1) {
      f2_conj(c, *in[k]);
    } else {
      c = *in[k];
    }
    f2_k(g, base + 2 * NW * k);
    f2_mul(r[k], c, g);
  }
  for (int k = 0; k < 6; ++k) *out[k] = r[k];
}

// the Fp4 square (x + y s)^2, s^2 = xi: (t0, t1) = (x^2 + xi y^2, 2 x y)
__device__ __forceinline__ void f4_sq(fp2& t0, fp2& t1, const fp2& x, const fp2& y) {
  fp2 xy, s, u;
  f2_mul_in(xy, x, y);
  f2_add(s, x, y);
  f2_mul_xi(u, y);
  f2_add(u, u, x);
  f2_mul_in(t0, s, u);
  f2_sub(t0, t0, xy);
  f2_mul_xi(u, xy);
  f2_sub(t0, t0, u);
  f2_dbl(t1, xy);
}

// the cyclotomic square's Fp4 pairs (Granger and Scott 2010): pair k is
// (x, y) = (cyclo_x(a, k), cyclo_y(a, k)) of a's coefficients
__device__ __forceinline__ const fp2& cyclo_x(const fp12& a, int k) {
  return k == 0 ? a.d0.c0 : k == 1 ? a.d1.c0 : a.d0.c1;
}
__device__ __forceinline__ const fp2& cyclo_y(const fp12& a, int k) {
  return k == 0 ? a.d1.c1 : k == 1 ? a.d0.c2 : a.d1.c2;
}
__device__ __forceinline__ const fp2& d0_c(const fp12& a, int k) {
  return k == 0 ? a.d0.c0 : k == 1 ? a.d0.c1 : a.d0.c2;
}
__device__ __forceinline__ const fp2& d1_c(const fp12& a, int k) {
  return k == 0 ? a.d1.c0 : k == 1 ? a.d1.c1 : a.d1.c2;
}

// pair k's square (t0, t1) gives two coefficients of a's square:
// d0.c[k] = 3 t0 - 2 a.d0.c[k] and d1.c[k + 1 mod 3] = 3 t1' + 2 a.d1.c[..],
// t1' = t1 (k < 2) or xi t1 (k = 2)
__device__ __forceinline__ void cyclo_pair_out(fp2& o0, fp2& o1, const fp12& a, int k,
                                               const fp2& t0, const fp2& t1) {
  fp2 u, d;
  f2_sub(d, t0, d0_c(a, k));
  f2_dbl(d, d);
  f2_add(o0, d, t0);
  f2_mul_xi(u, t1);
  f2_sel(u, k == 2, u, t1);
  f2_add(d, u, d1_c(a, (k + 1) % 3));
  f2_dbl(d, d);
  f2_add(o1, d, u);
}

// a^2 for a in the cyclotomic subgroup (every value after the easy part):
// 18 Fp products instead of 54. o may alias a.
__device__ BLS_NOINLINE void f12_cyclo_sq(fp12& o, const fp12& a) {
  fp2 t[6], r[6];
  for (int k = 0; k < 3; ++k) f4_sq(t[2 * k], t[2 * k + 1], cyclo_x(a, k), cyclo_y(a, k));
  for (int k = 0; k < 3; ++k) cyclo_pair_out(r[2 * k], r[2 * k + 1], a, k, t[2 * k], t[2 * k + 1]);
  o.d0.c0 = r[0];
  o.d1.c1 = r[1];
  o.d0.c1 = r[2];
  o.d1.c2 = r[3];
  o.d0.c2 = r[4];
  o.d1.c0 = r[5];
}

__device__ __forceinline__ bool f12_is_one(const fp12& a) {
  fp2 one;
  f2_one(one);
  return f2_eq(a.d0.c0, one) && f2_is_zero(a.d0.c1) && f2_is_zero(a.d0.c2) &&
         f2_is_zero(a.d1.c0) && f2_is_zero(a.d1.c1) && f2_is_zero(a.d1.c2);
}

// 144 (rows, B) planes in the order d0.c0.a, d0.c0.b, d0.c1.a, ... d1.c2.b
__device__ __forceinline__ void f12_ld(fp12& o, const uint32_t* p, long long B, long long j) {
  fp2* c[6] = {&o.d0.c0, &o.d0.c1, &o.d0.c2, &o.d1.c0, &o.d1.c1, &o.d1.c2};
  for (int k = 0; k < 6; ++k) f2_ld(*c[k], p + 2 * NW * B * k, B, j);
}

__device__ __forceinline__ void f12_st(uint32_t* p, long long B, long long j, const fp12& a) {
  const fp2* c[6] = {&a.d0.c0, &a.d0.c1, &a.d0.c2, &a.d1.c0, &a.d1.c1, &a.d1.c2};
  for (int k = 0; k < 6; ++k) f2_st(p + 2 * NW * B * k, B, j, *c[k]);
}

}  // namespace bls
