// Field and curve arithmetic of curve25519 for Hopper (sm_90a), one lane
// per thread: the radix-2^13 x 20 int32 limbs of the JAX package
// (cometbft_tpu/ops/field.py, curve.py) and the plain PyTorch version
// (cometbft_tpu_torch/ops/field.py, curve.py), with the same carry-round
// counts, so every intermediate equals the plain version's bit for bit.
//
// Included by decompress25519.cu (the pubkey decoders) and microbench.cu
// (the probe kernels, which time this representation). Field operations are
// inlined; point operations are __noinline__, so ptxas compiles each once
// per file. The verify kernels use fe32.cuh (8 x 32-bit limbs).
//
// Additions, subtractions and the fold of the product's high half run in
// unsigned arithmetic: within the carried-limb intervals nothing wraps, and
// on any other int32 input the result wraps modulo 2^32 as PyTorch's and
// JAX's int32 arithmetic does, where signed overflow would be undefined.
// Shifts stay on int: >> is arithmetic, flooring negative limbs as the
// plain version does.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define NL 20
#define RADIX 13
#define LMASK 8191
#define FOLD 608
#define TABLE17 17
#define THREADS 128

struct fe {
  int v[NL];
};
struct pt {
  fe x, y, z, t;
};

// Field constants (cometbft_tpu_torch/ops/field.py CONST_LIMBS; a CPU test
// holds these lines against it).
__constant__ int C_P[NL] = {8173, 8191, 8191, 8191, 8191, 8191, 8191, 8191, 8191, 8191, 8191, 8191, 8191, 8191, 8191, 8191, 8191, 8191, 8191, 255};
__constant__ int C_D[NL] = {6307, 6859, 4740, 5787, 5982, 3157, 1287, 2472, 4106, 3, 6694, 3827, 1943, 928, 3635, 8142, 2927, 1905, 219, 164};
__constant__ int C_D2[NL] = {4441, 5527, 1289, 3383, 3773, 6315, 2574, 4944, 20, 7, 5196, 7655, 3886, 1856, 7270, 8092, 5855, 3810, 438, 72};
__constant__ int C_SQRT_M1[NL] = {176, 4213, 2514, 7222, 3150, 4668, 5311, 213, 792, 6522, 5609, 7159, 2451, 1664, 3245, 7137, 4033, 1026, 201, 87};
__constant__ int C_M_SUB[NL] = {7565, 8191, 8191, 8191, 8191, 8191, 8191, 8191, 8191, 8191, 8191, 8191, 8191, 8191, 8191, 8191, 8191, 8191, 8191, 8447};

// ------------------------------------------------------------------ field

// One parallel carry round with the 2^260 = FOLD wrap (field._carry_round20).
// int >> is arithmetic, so negative limbs floor as in the plain version.
__device__ __forceinline__ void carry20(int* x) {
  int c[NL];
#pragma unroll
  for (int i = 0; i < NL; i++) {
    c[i] = x[i] >> RADIX;
    x[i] &= LMASK;
  }
  x[0] += c[NL - 1] * FOLD;
#pragma unroll
  for (int i = 1; i < NL; i++) x[i] += c[i - 1];
}

__device__ __forceinline__ void fe_copy(fe& o, const fe& a) {
#pragma unroll
  for (int i = 0; i < NL; i++) o.v[i] = a.v[i];
}

__device__ __forceinline__ void fe_const(fe& o, const int* c) {
#pragma unroll
  for (int i = 0; i < NL; i++) o.v[i] = c[i];
}

__device__ __forceinline__ void fe_zero(fe& o) {
#pragma unroll
  for (int i = 0; i < NL; i++) o.v[i] = 0;
}

__device__ __forceinline__ void fe_one(fe& o) {
  fe_zero(o);
  o.v[0] = 1;
}

__device__ __forceinline__ void fe_add(fe& o, const fe& a, const fe& b) {
#pragma unroll
  for (int i = 0; i < NL; i++) o.v[i] = (int)((unsigned)a.v[i] + (unsigned)b.v[i]);
  carry20(o.v);
}

__device__ __forceinline__ void fe_sub(fe& o, const fe& a, const fe& b) {
#pragma unroll
  for (int i = 0; i < NL; i++)
    o.v[i] = (int)((unsigned)a.v[i] + (unsigned)C_M_SUB[i] - (unsigned)b.v[i]);
  carry20(o.v);
}

__device__ __forceinline__ void fe_neg(fe& o, const fe& a) {
#pragma unroll
  for (int i = 0; i < NL; i++) o.v[i] = (int)((unsigned)C_M_SUB[i] - (unsigned)a.v[i]);
  carry20(o.v);
}

// (40 product columns, column 39 zero) -> carried 20 limbs
// (field._conv_reduce: one no-wrap round on the high half, fold, two
// wrapping rounds). Columns are accumulated unsigned: wrap-around is
// defined, and the interval proof keeps every column inside int32.
__device__ __forceinline__ void conv_reduce(fe& o, const unsigned* col) {
  int hc[NL], hi[NL];
#pragma unroll
  for (int i = 0; i < NL; i++) {
    int h = (int)col[NL + i];
    hc[i] = h >> RADIX;
    hi[i] = h & LMASK;
  }
  int top = hc[NL - 1];
#pragma unroll
  for (int i = NL - 1; i >= 1; i--) hi[i] += hc[i - 1];
#pragma unroll
  for (int i = 0; i < NL; i++) o.v[i] = (int)(col[i] + (unsigned)FOLD * (unsigned)hi[i]);
  o.v[0] = (int)((unsigned)o.v[0] + (unsigned)(FOLD * FOLD) * (unsigned)top);
  carry20(o.v);
  carry20(o.v);
}

__device__ __forceinline__ void fe_mul(fe& o, const fe& a, const fe& b) {
  unsigned col[2 * NL];
#pragma unroll
  for (int k = 0; k < 2 * NL; k++) col[k] = 0u;
#pragma unroll
  for (int i = 0; i < NL; i++) {
#pragma unroll
    for (int j = 0; j < NL; j++) col[i + j] += (unsigned)a.v[i] * (unsigned)b.v[j];
  }
  conv_reduce(o, col);
}

__device__ __forceinline__ void fe_sq(fe& o, const fe& a) {
  unsigned col[2 * NL];
#pragma unroll
  for (int k = 0; k < 2 * NL; k++) col[k] = 0u;
#pragma unroll
  for (int i = 0; i < NL; i++) {
    unsigned a2 = 2u * (unsigned)a.v[i];
    col[2 * i] += (unsigned)a.v[i] * (unsigned)a.v[i];
#pragma unroll
    for (int j = i + 1; j < NL; j++) col[i + j] += a2 * (unsigned)a.v[j];
  }
  conv_reduce(o, col);
}

__device__ __noinline__ void fe_sqn(fe& x, int n) {
#pragma unroll 1
  for (int k = 0; k < n; k++) fe_sq(x, x);
}

// z^((p-5)/8) = z^(2^252 - 3), the ref10 addition chain (field.pow22523).
__device__ __noinline__ void fe_pow22523(fe& o, const fe& z) {
  fe z2, z9, z11, t, z_5_0, z_10_0, z_20_0, z_50_0, z_100_0;
  fe_sq(z2, z);
  fe_copy(t, z2);
  fe_sqn(t, 2);
  fe_mul(z9, t, z);
  fe_mul(z11, z9, z2);
  fe_sq(t, z11);
  fe_mul(z_5_0, t, z9);
  fe_copy(t, z_5_0);
  fe_sqn(t, 5);
  fe_mul(z_10_0, t, z_5_0);
  fe_copy(t, z_10_0);
  fe_sqn(t, 10);
  fe_mul(z_20_0, t, z_10_0);
  fe_copy(t, z_20_0);
  fe_sqn(t, 20);
  fe_mul(t, t, z_20_0);  // z_40_0
  fe_sqn(t, 10);
  fe_mul(z_50_0, t, z_10_0);
  fe_copy(t, z_50_0);
  fe_sqn(t, 50);
  fe_mul(z_100_0, t, z_50_0);
  fe_copy(t, z_100_0);
  fe_sqn(t, 100);
  fe_mul(t, t, z_100_0);  // z_200_0
  fe_sqn(t, 50);
  fe_mul(t, t, z_50_0);  // z_250_0
  fe_sqn(t, 2);
  fe_mul(o, t, z);
}

// Unique representative in [0, p) (field.canonicalize).
__device__ __noinline__ void fe_canonicalize(fe& o, const fe& a) {
  int x[NL];
#pragma unroll
  for (int i = 0; i < NL; i++) x[i] = a.v[i];
  carry20(x);
  carry20(x);
  carry20(x);
#pragma unroll
  for (int r = 0; r < 3; r++) {
    int hi = x[NL - 1] >> 8;  // bits >= 255: 2^255 = 19 mod p
    x[0] += 19 * hi;
    x[NL - 1] &= 255;
    carry20(x);
  }
  // one serial carry pass: a borrow may have to cross a run of full limbs
  // (a multiple of p from fe_sub), which parallel rounds move one limb each
#pragma unroll
  for (int i = 0; i < NL - 1; i++) {
    x[i + 1] += x[i] >> RADIX;
    x[i] &= LMASK;
  }
  int s[NL];
  int borrow = 0;
#pragma unroll
  for (int i = 0; i < NL; i++) {
    int v = x[i] - C_P[i] - borrow;
    borrow = v < 0 ? 1 : 0;
    s[i] = v + (borrow << RADIX);
  }
#pragma unroll
  for (int i = 0; i < NL; i++) o.v[i] = borrow == 0 ? s[i] : x[i];
}

__device__ __forceinline__ bool fe_is_zero(const fe& a) {
  fe c;
  fe_canonicalize(c, a);
  int acc = 0;
#pragma unroll
  for (int i = 0; i < NL; i++) acc |= c.v[i];
  return acc == 0;
}

// ------------------------------------------------------------------ curve

// dbl-2008-hwcd (curve.double / double_no_t). Never reads p.t.
__device__ __noinline__ void pt_double(pt& o, const pt& p, bool out_t) {
  fe a, b, c, h, e, g, f, s;
  fe_sq(a, p.x);
  fe_sq(b, p.y);
  fe_sq(c, p.z);
  fe_add(c, c, c);
  fe_add(h, a, b);
  fe_add(s, p.x, p.y);
  fe_sq(s, s);
  fe_sub(e, h, s);
  fe_sub(g, a, b);
  fe_add(f, c, g);
  fe_mul(o.x, e, f);
  fe_mul(o.y, g, h);
  fe_mul(o.z, f, g);
  if (out_t) {
    fe_mul(o.t, e, h);
  } else {
    fe_zero(o.t);
  }
}

// add-2008-hwcd-3, a=-1, with q.t premultiplied by 2d (curve.add_pre);
// q_affine selects the mixed form (curve.madd_pre, q.z == 1).
__device__ __noinline__ void pt_add_pre(pt& o, const pt& p, const pt& q,
                                        bool q_affine, bool out_t) {
  fe a, b, c, d, e, f, g, h, u;
  fe_sub(a, p.y, p.x);
  fe_sub(u, q.y, q.x);
  fe_mul(a, a, u);
  fe_add(b, p.y, p.x);
  fe_add(u, q.y, q.x);
  fe_mul(b, b, u);
  fe_mul(c, p.t, q.t);
  if (q_affine) {
    fe_add(d, p.z, p.z);
  } else {
    fe_mul(u, p.z, q.z);
    fe_add(d, u, u);
  }
  fe_sub(e, b, a);
  fe_sub(f, d, c);
  fe_add(g, d, c);
  fe_add(h, b, a);
  if (out_t) {
    fe_mul(o.t, e, h);
  } else {
    fe_zero(o.t);
  }
  fe_mul(o.x, e, f);
  fe_mul(o.y, g, h);
  fe_mul(o.z, f, g);
}

// ZIP-215 decompression (curve.decompress_zip215). Returns ok; where ok is
// false the coordinates are garbage, as in the plain version.
__device__ __noinline__ bool pt_decompress(pt& o, const fe& y, int sign) {
  fe yy, one, u, v, v3, v7, t, x, vxx, dc;
  fe_sq(yy, y);
  fe_one(one);
  fe_sub(u, yy, one);
  fe_const(dc, C_D);
  fe_mul(v, dc, yy);
  fe_add(v, v, one);
  fe_sq(t, v);
  fe_mul(v3, t, v);
  fe_sq(t, v3);
  fe_mul(v7, t, v);
  fe_mul(t, u, v7);
  fe_pow22523(t, t);
  fe_mul(x, u, v3);
  fe_mul(x, x, t);
  fe_sq(t, x);
  fe_mul(vxx, v, t);
  fe_sub(t, vxx, u);
  bool root1 = fe_is_zero(t);
  fe_add(t, vxx, u);
  bool root2 = fe_is_zero(t);
  if (!root1) {
    fe_const(dc, C_SQRT_M1);
    fe_mul(x, x, dc);
  }
  bool ok = root1 || root2;
  fe xc;
  fe_canonicalize(xc, x);
  int nz = 0;
#pragma unroll
  for (int i = 0; i < NL; i++) nz |= xc.v[i];
  if (nz == 0 && sign == 1) ok = false;  // x = 0 with the sign bit set
  if ((xc.v[0] & 1) != sign) fe_neg(x, x);
  fe_copy(o.x, x);
  fe_copy(o.y, y);
  fe_copy(o.z, one);
  fe_mul(o.t, x, y);
  return ok;
}

// LSB of the canonical value (field.parity): the sign of an encoding.
__device__ __forceinline__ int fe_parity(const fe& a) {
  fe c;
  fe_canonicalize(c, a);
  return c.v[0] & 1;
}

// SQRT_RATIO_M1 (curve.sqrt_ratio_m1): r = the even root of u/v or of
// i*u/v; returns was_square.
__device__ __noinline__ bool fe_sqrt_ratio_m1(fe& r, const fe& u, const fe& v) {
  fe v3, v7, t, check, sm1;
  fe_sq(t, v);
  fe_mul(v3, t, v);
  fe_sq(t, v3);
  fe_mul(v7, t, v);
  fe_mul(t, u, v7);
  fe_pow22523(t, t);
  fe_mul(r, u, v3);
  fe_mul(r, r, t);
  fe_sq(t, r);
  fe_mul(check, v, t);
  fe_sub(t, check, u);
  bool correct = fe_is_zero(t);
  fe_add(t, check, u);
  bool flipped = fe_is_zero(t);
  fe_const(sm1, C_SQRT_M1);
  fe_mul(t, u, sm1);
  fe_add(t, check, t);
  bool flipped_i = fe_is_zero(t);
  if (flipped || flipped_i) fe_mul(r, r, sm1);
  if (fe_parity(r)) fe_neg(r, r);  // CT_ABS: the even root
  return correct || flipped;
}

// ristretto255 DECODE (curve.ristretto_decode_device) of the encoding
// whose low 255 bits are s and bit 255 is hi. Returns ok; where ok is
// false the coordinates are garbage, as in the plain version.
__device__ __noinline__ bool pt_ristretto_decode(pt& o, const fe& s, int hi) {
  fe sc, one, ss, u1, u2, u2sq, v, t, invsqrt, den_x, den_y;
  // s < p (s is canonical), s even, bit 255 clear
  fe_canonicalize(sc, s);
  int diff = 0;
#pragma unroll
  for (int i = 0; i < NL; i++) diff |= sc.v[i] ^ s.v[i];
  bool pre_ok = diff == 0 && (s.v[0] & 1) == 0 && hi == 0;
  fe_one(one);
  fe_sq(ss, s);
  fe_sub(u1, one, ss);
  fe_add(u2, one, ss);
  fe_sq(u2sq, u2);
  fe_const(t, C_D);
  fe_mul(t, t, u1);
  fe_mul(t, t, u1);
  fe_neg(t, t);
  fe_sub(v, t, u2sq);  // v = -d*u1^2 - u2^2
  fe_mul(t, v, u2sq);
  bool was_square = fe_sqrt_ratio_m1(invsqrt, one, t);
  fe_mul(den_x, invsqrt, u2);
  fe_mul(den_y, invsqrt, den_x);
  fe_mul(den_y, den_y, v);
  fe_add(t, s, s);
  fe_mul(o.x, t, den_x);
  if (fe_parity(o.x)) fe_neg(o.x, o.x);
  fe_mul(o.y, u1, den_y);
  fe_mul(o.t, o.x, o.y);
  fe_copy(o.z, one);
  return pre_ok && was_square && fe_parity(o.t) == 0 && !fe_is_zero(o.y);
}

// ------------------------------------------------------------- unpacking

// Bits [bit, bit + width) of the 256-bit little-endian value in w[8].
__device__ __forceinline__ unsigned word_bits(const unsigned* w, int bit, int width) {
  int wi = bit >> 5, off = bit & 31;
  unsigned v = w[wi] >> off;
  if (off > 32 - width && wi + 1 < 8) v |= w[wi + 1] << (32 - off);
  return v & ((1u << width) - 1u);
}

// unpack.words_to_y_limbs / words_sign
__device__ __forceinline__ void load_y(fe& y, int& sign, const int* words, int b, int B) {
  unsigned w[8];
#pragma unroll
  for (int i = 0; i < 8; i++) w[i] = (unsigned)words[i * B + b];
#pragma unroll
  for (int i = 0; i < NL; i++) y.v[i] = (int)word_bits(w, RADIX * i, i == NL - 1 ? 8 : RADIX);
  sign = (int)(w[7] >> 31);
}

__device__ __forceinline__ void load_fe(fe& o, const int* src, int b, int B) {
#pragma unroll
  for (int i = 0; i < NL; i++) o.v[i] = src[i * B + b];
}

__device__ __forceinline__ void store_fe(int* dst, const fe& a, int b, int B) {
#pragma unroll
  for (int i = 0; i < NL; i++) dst[i * B + b] = a.v[i];
}

// ------------------------------------------------------------------ ladder

// Entry `entry` of a table laid out [coord][entry][limb], x and t negated
// where `negate` (curve._select17_signed after its index is formed).
__device__ __forceinline__ void select_entry(pt& o, const int* tab, int entry, bool negate) {
  const int* e = tab + entry * NL;
#pragma unroll
  for (int i = 0; i < NL; i++) {
    o.x.v[i] = e[i];
    o.y.v[i] = e[TABLE17 * NL + i];
    o.z.v[i] = e[2 * TABLE17 * NL + i];
    o.t.v[i] = e[3 * TABLE17 * NL + i];
  }
  if (negate) {
    fe_neg(o.x, o.x);
    fe_neg(o.t, o.t);
  }
}

// Signed lookup of a ladder digit: entry |d|, negated where d < 0. The
// ladder's digits lie in [-16, 15] (unpack.words_to_digits5_signed), so
// |d| indexes the 17 entries directly; the plain _select17_signed also
// defines digits outside [-16, 16] (entry |d| & 15), which only the
// microbench feeds it (microbench.cu select17_any).
__device__ __forceinline__ void select_shared(pt& o, const int* tab, int d) {
  select_entry(o, tab, d < 0 ? -d : d, d < 0);
}

__device__ __forceinline__ void select_local(pt& o, const pt* tab, int d) {
  int mag = d < 0 ? -d : d;
  o = tab[mag];
  if (d < 0) {
    fe_neg(o.x, o.x);
    fe_neg(o.t, o.t);
  }
}

// One window (curve.window_step): 4 doublings without T, one with, the
// mixed base add, then the -A add (T only on the last window).
__device__ __noinline__ void window_step(pt& acc, int ds, int dk, const int* tab_b,
                                         const pt* tab_a, bool out_t) {
  pt q, r;
  pt_double(r, acc, false);
  pt_double(acc, r, false);
  pt_double(r, acc, false);
  pt_double(acc, r, false);
  pt_double(r, acc, true);
  select_shared(q, tab_b, ds);
  pt_add_pre(acc, r, q, true, true);
  select_local(q, tab_a, dk);
  pt_add_pre(r, acc, q, false, out_t);
  acc = r;
}
