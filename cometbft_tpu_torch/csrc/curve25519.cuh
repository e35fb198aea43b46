// Field and curve arithmetic of curve25519 for Hopper (sm_90a), one lane
// per thread: the radix-2^13 x 20 int32 limbs of the JAX package
// (cometbft_tpu/ops/field.py, curve.py) and the plain PyTorch version
// (cometbft_tpu_torch/ops/field.py, curve.py), with the same carry-round
// counts, so every intermediate equals the plain version's bit for bit.
//
// Included by microbench.cu only: its limb bodies (K3) and K4 time this
// representation itself. The verify kernels and the decoders run fe32.cuh
// (8 x 32-bit limbs). Every function is inlined and takes its operands as
// values, so nothing here needs a stack frame.
//
// Additions, subtractions and the fold of the product's high half run in
// unsigned arithmetic: within the carried-limb intervals nothing wraps, and
// on any other int32 input the result wraps modulo 2^32 as PyTorch's and
// JAX's int32 arithmetic does, where signed overflow would be undefined.
// Shifts stay on int: >> is arithmetic, flooring negative limbs as the
// plain version does.

#pragma once

#include <cstdint>

constexpr int NL = 20;
constexpr int RADIX = 13;
constexpr int LMASK = 8191;
constexpr int FOLD = 608;
constexpr int TABLE17 = 17;

struct fe {
  int v[NL];
};
struct pt {
  fe x, y, z, t;
};

// 33p in loose limbs, the bias that keeps a + M - b positive
// (cometbft_tpu_torch/ops/field.py CONST_LIMBS["M_SUB"]; a CPU test holds
// this line against it).
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

__device__ __forceinline__ void fe_zero(fe& o) {
#pragma unroll
  for (int i = 0; i < NL; i++) o.v[i] = 0;
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

// ------------------------------------------------------------------ curve

// dbl-2008-hwcd in place (curve.double, or double_no_t without out_t).
// Never reads p.t.
__device__ __forceinline__ void pt_double(pt& p, bool out_t) {
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
  fe_mul(p.x, e, f);
  fe_mul(p.y, g, h);
  fe_mul(p.z, f, g);
  if (out_t) {
    fe_mul(p.t, e, h);
  } else {
    fe_zero(p.t);
  }
}

// Entry `entry` of a table laid out [coord][entry][limb] (shared memory),
// read one coordinate at a time, x and t negated where `negate`
// (curve._select17_signed after its index is formed).
struct table_entry {
  const int* e;  // the entry's x limbs
  bool negate;

  __device__ __forceinline__ void coord(fe& o, int c) const {
#pragma unroll
    for (int i = 0; i < NL; i++) o.v[i] = e[c * TABLE17 * NL + i];
    if (negate && (c == 0 || c == 3)) fe_neg(o, o);
  }
};

// curve._select17_signed of any int32 digit: entry 16 where |d| == 16,
// else entry |d| & 15 (the where-tree over bits 3..0), negated where
// d < 0. |INT_MIN| wraps to INT_MIN, whose low bits select entry 0, as in
// torch.
__device__ __forceinline__ table_entry select17_any(const int* tab, int d) {
  unsigned mag = d < 0 ? 0u - (unsigned)d : (unsigned)d;
  return table_entry{tab + (mag == 16u ? 16 : (int)(mag & 15u)) * NL, d < 0};
}

// add-2008-hwcd-3, a=-1, in place, with q.t premultiplied by 2d
// (curve.add_pre); q_affine selects the mixed form (curve.madd_pre,
// q.z == 1). q is read a coordinate at a time (Q::coord), and p's
// coordinates die as soon as the formula has used them.
template <class Q>
__device__ __forceinline__ void pt_add_pre(pt& p, const Q& q, bool q_affine, bool out_t) {
  fe u, v, a, b;
  {
    fe qx, qy;
    q.coord(qx, 0);
    q.coord(qy, 1);
    fe_sub(u, qy, qx);
    fe_add(v, qy, qx);
  }
  fe_sub(a, p.y, p.x);
  fe_add(b, p.y, p.x);
  fe_mul(a, a, u);
  fe_mul(b, b, v);
  fe c, d;
  q.coord(u, 3);
  fe_mul(c, p.t, u);
  if (q_affine) {
    fe_add(d, p.z, p.z);
  } else {
    q.coord(u, 2);
    fe_mul(u, p.z, u);
    fe_add(d, u, u);
  }
  fe e, f, g, h;
  fe_sub(e, b, a);
  fe_sub(f, d, c);
  fe_add(g, d, c);
  fe_add(h, b, a);
  if (out_t) {
    fe_mul(p.t, e, h);
  } else {
    fe_zero(p.t);
  }
  fe_mul(p.x, e, f);
  fe_mul(p.y, g, h);
  fe_mul(p.z, f, g);
}

// ------------------------------------------------------------- lanes

__device__ __forceinline__ void load_fe(fe& o, const int* src, int b, int B) {
#pragma unroll
  for (int i = 0; i < NL; i++) o.v[i] = src[i * B + b];
}

__device__ __forceinline__ void store_fe(int* dst, const fe& a, int b, int B) {
#pragma unroll
  for (int i = 0; i < NL; i++) dst[i * B + b] = a.v[i];
}
