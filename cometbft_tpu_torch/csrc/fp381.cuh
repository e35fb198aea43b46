// The BLS12-381 base field in 12 x 32-bit limbs, one lane per thread, for the
// BLS kernels (bls12381.cu).
//
// An element is a 384-bit little-endian value in twelve uint32 words, in the
// Montgomery domain with R = 2^384, always fully reduced into [0, p): every
// operation ends with a conditional subtraction, so equality is word
// equality and zero has one representative. The product is CIOS Montgomery
// multiplication with 32x32 -> 64-bit multiply-adds written as (uint64_t)a * b
// in portable C++ (nvcc emits IMAD.WIDE.U32); p < 2^381 leaves two spare bits,
// so the CIOS sum stays below 2p. There is no inline assembly: a host C++
// compiler builds the same code with __device__ and __forceinline__ defined
// away (tests/test_torch_bls_host.py).
//
// Every constant (p, R^2, the Montgomery inverse, the curve and map constants,
// the Frobenius gammas, the fixed exponents and scalars) is read from one
// table, c_k, that the host fills from the oracle (crypto/bls12381_math.py)
// through bls_set_constants before the first launch on a device
// (ops/bls_launch.py constants_table): nothing is transcribed here. The
// table's layout is K_* below and must match constants_table.

#pragma once

#include <cstdint>

#ifdef __CUDACC__
#define BLS_NOINLINE __noinline__
#else
#define BLS_NOINLINE
#endif

namespace bls {

constexpr int NW = 12;  // words of a field element
constexpr int NL = 35;  // radix-2^11 limbs of the staged planes

// ------------------------------------------------------------ constant table
// Offsets in words. Field constants are Montgomery unless noted.
constexpr int K_P = 0;          // p (raw)
constexpr int K_ONE = 12;       // R mod p: one
constexpr int K_R2 = 24;        // R^2 mod p (raw): to_mont
constexpr int K_HALF = 36;      // (p - 1) / 2 (raw): the serialization sign rule
constexpr int K_N0 = 48;        // -p^-1 mod 2^32 (one word)
constexpr int K_B1 = 60;        // 4: the curve's b
constexpr int K_MINUS1 = 72;    // p - 1
constexpr int K_B2 = 84;        // Fp2 4(1 + u): the twist's b
constexpr int K_NEG_G1 = 108;   // -g1: x then y
constexpr int K_XI_INV = 132;   // Fp2 (1 + u)^-1
constexpr int K_SVDW = 156;     // Fp2 Z, c1, c2, c3, c4 of the SvdW map
constexpr int K_FROB1 = 276;    // Fp2 gammas of x^p, coefficient order
constexpr int K_FROB2 = 420;    // Fp2 gammas of x^(p^2)
constexpr int K_E_PM2 = 564;    // exponents and scalars (raw words):  p - 2
constexpr int K_E_SQRT = 576;   //   (p + 1) / 4
constexpr int K_E_SQRT2 = 588;  //   (p - 3) / 4
constexpr int K_E_LEG = 600;    //   (p - 1) / 2
constexpr int K_E_R = 612;      //   r, the subgroup order (8 words)
constexpr int K_E_H2 = 620;     //   the G2 cofactor (16 words)
constexpr int K_E_X = 636;      //   |x|, the curve parameter (2 words)
constexpr int K_NBITS = 638;    // bit lengths of the 7 exponents above, in order
constexpr int NK = 645;

enum Exp { E_PM2 = 0, E_SQRT, E_SQRT2, E_LEG, E_R, E_H2, E_X };

#ifdef __CUDACC__
__constant__ uint32_t c_k[NK];
#else
static uint32_t c_k[NK];
#endif

__device__ __forceinline__ int exp_offset(int e) {
  constexpr int offs[7] = {K_E_PM2, K_E_SQRT, K_E_SQRT2, K_E_LEG, K_E_R, K_E_H2, K_E_X};
  return offs[e];
}

__device__ __forceinline__ int exp_bit(int e, int i) {
  return (c_k[exp_offset(e) + (i >> 5)] >> (i & 31)) & 1;
}

__device__ __forceinline__ int exp_nbits(int e) { return (int)c_k[K_NBITS + e]; }

// -------------------------------------------------------------------- Fp

struct fp {
  uint32_t v[NW];
};

__device__ __forceinline__ void fp_k(fp& o, int off) {
  for (int i = 0; i < NW; ++i) o.v[i] = c_k[off + i];
}

__device__ __forceinline__ void fp_zero(fp& o) {
  for (int i = 0; i < NW; ++i) o.v[i] = 0;
}

__device__ __forceinline__ void fp_one(fp& o) { fp_k(o, K_ONE); }

__device__ __forceinline__ bool fp_is_zero(const fp& a) {
  uint32_t acc = 0;
  for (int i = 0; i < NW; ++i) acc |= a.v[i];
  return acc == 0;
}

__device__ __forceinline__ bool fp_eq(const fp& a, const fp& b) {
  uint32_t acc = 0;
  for (int i = 0; i < NW; ++i) acc |= a.v[i] ^ b.v[i];
  return acc == 0;
}

__device__ __forceinline__ bool fp_eq_k(const fp& a, int off) {
  uint32_t acc = 0;
  for (int i = 0; i < NW; ++i) acc |= a.v[i] ^ c_k[off + i];
  return acc == 0;
}

// o = c ? a : b, branch-free
__device__ __forceinline__ void fp_sel(fp& o, bool c, const fp& a, const fp& b) {
  const uint32_t m = 0u - (uint32_t)c;
  for (int i = 0; i < NW; ++i) o.v[i] = (a.v[i] & m) | (b.v[i] & ~m);
}

// x (value < 2p, with an extra top word) -> x mod p
__device__ __forceinline__ void fp_reduce_once(fp& o, const uint32_t* x, uint32_t top) {
  uint32_t s[NW];
  int64_t br = 0;
  for (int i = 0; i < NW; ++i) {
    br += (int64_t)x[i] - c_k[K_P + i];
    s[i] = (uint32_t)br;
    br >>= 32;
  }
  br += top;
  const uint32_t m = 0u - (uint32_t)(br >= 0);  // x >= p: take x - p
  for (int i = 0; i < NW; ++i) o.v[i] = (s[i] & m) | (x[i] & ~m);
}

__device__ __forceinline__ void fp_add(fp& o, const fp& a, const fp& b) {
  uint32_t t[NW];
  uint64_t c = 0;
  for (int i = 0; i < NW; ++i) {
    c += (uint64_t)a.v[i] + b.v[i];
    t[i] = (uint32_t)c;
    c >>= 32;
  }
  fp_reduce_once(o, t, (uint32_t)c);
}

__device__ __forceinline__ void fp_sub(fp& o, const fp& a, const fp& b) {
  uint32_t t[NW];
  int64_t br = 0;
  for (int i = 0; i < NW; ++i) {
    br += (int64_t)a.v[i] - b.v[i];
    t[i] = (uint32_t)br;
    br >>= 32;
  }
  const uint32_t m = 0u - (uint32_t)(br < 0);  // borrow: add p back
  uint64_t c = 0;
  for (int i = 0; i < NW; ++i) {
    c += (uint64_t)t[i] + (c_k[K_P + i] & m);
    o.v[i] = (uint32_t)c;
    c >>= 32;
  }
}

__device__ __forceinline__ void fp_neg(fp& o, const fp& a) {
  fp z;
  fp_zero(z);
  fp_sub(o, z, a);
}

__device__ __forceinline__ void fp_dbl(fp& o, const fp& a) { fp_add(o, a, a); }

// CIOS Montgomery product a * b / 2^384 mod p
__device__ BLS_NOINLINE void fp_mul(fp& o, const fp& a, const fp& b) {
  uint32_t t[NW + 2];
  for (int i = 0; i < NW + 2; ++i) t[i] = 0;
  const uint32_t n0 = c_k[K_N0];
  for (int i = 0; i < NW; ++i) {
    const uint32_t bi = b.v[i];
    uint64_t c = 0;
    for (int j = 0; j < NW; ++j) {
      c += (uint64_t)a.v[j] * bi + t[j];
      t[j] = (uint32_t)c;
      c >>= 32;
    }
    c += t[NW];
    t[NW] = (uint32_t)c;
    t[NW + 1] = (uint32_t)(c >> 32);
    const uint32_t m = t[0] * n0;
    c = ((uint64_t)m * c_k[K_P] + t[0]) >> 32;
    for (int j = 1; j < NW; ++j) {
      c += (uint64_t)m * c_k[K_P + j] + t[j];
      t[j - 1] = (uint32_t)c;
      c >>= 32;
    }
    c += t[NW];
    t[NW - 1] = (uint32_t)c;
    t[NW] = t[NW + 1] + (uint32_t)(c >> 32);
  }
  fp_reduce_once(o, t, t[NW]);
}

__device__ __forceinline__ void fp_sq(fp& o, const fp& a) { fp_mul(o, a, a); }

// small multiples by addition chains (the plain version's mul_small)
__device__ __forceinline__ void fp_mul3(fp& o, const fp& a) {
  fp t;
  fp_add(t, a, a);
  fp_add(o, t, a);
}

__device__ __forceinline__ void fp_mul12(fp& o, const fp& a) {
  fp t;
  fp_mul3(t, a);
  fp_add(t, t, t);
  fp_add(o, t, t);
}

// a^e for a fixed exponent of the table, MSB first
__device__ BLS_NOINLINE void fp_pow(fp& o, const fp& a, int e) {
  fp acc;
  fp_one(acc);
  for (int i = exp_nbits(e) - 1; i >= 0; --i) {
    fp_sq(acc, acc);
    if (exp_bit(e, i)) fp_mul(acc, acc, a);
  }
  o = acc;
}

// Fermat inverse; inv(0) = 0
__device__ __forceinline__ void fp_inv(fp& o, const fp& a) { fp_pow(o, a, E_PM2); }

// root candidate a^((p+1)/4); returns whether a is a square
__device__ __forceinline__ bool fp_sqrt(fp& o, const fp& a) {
  fp r, r2;
  fp_pow(r, a, E_SQRT);
  fp_sq(r2, r);
  o = r;
  return fp_eq(r2, a);
}

// Montgomery -> the canonical integer (raw words)
__device__ __forceinline__ void fp_from_mont(fp& o, const fp& a) {
  fp one;
  fp_zero(one);
  one.v[0] = 1;
  fp_mul(o, a, one);
}

// raw canonical words: value > (p - 1) / 2
__device__ __forceinline__ bool raw_gt_half(const fp& raw) {
  int64_t br = 0;
  for (int i = 0; i < NW; ++i) {
    br += (int64_t)c_k[K_HALF + i] - raw.v[i];
    br >>= 32;
  }
  return br < 0;
}

// the serialization's sign rule for an Fp y: canonical y > (p - 1) / 2
__device__ __forceinline__ bool fp_lexi_larger(const fp& y) {
  fp r;
  fp_from_mont(r, y);
  return raw_gt_half(r);
}

// 35 radix-2^11 limbs (canonical digits of a value < p; limb i at
// limbs[i * stride]) -> Montgomery
__device__ __forceinline__ void fp_from_limbs11(fp& o, const int32_t* limbs, long long stride) {
  fp w;
  fp_zero(w);
  for (int i = 0; i < NL; ++i) {
    const uint32_t l = (uint32_t)limbs[i * stride];
    const int bit = 11 * i, k = bit >> 5, s = bit & 31;
    w.v[k] |= l << s;
    if (s > 21 && k + 1 < NW) w.v[k + 1] |= l >> (32 - s);
  }
  fp r2;
  fp_k(r2, K_R2);
  fp_mul(o, w, r2);
}

// element (row block) loads and stores on (rows, B) planes, lane `j`
__device__ __forceinline__ void fp_ld(fp& o, const uint32_t* p, long long B, long long j) {
  for (int i = 0; i < NW; ++i) o.v[i] = p[i * B + j];
}

__device__ __forceinline__ void fp_st(uint32_t* p, long long B, long long j, const fp& a) {
  for (int i = 0; i < NW; ++i) p[i * B + j] = a.v[i];
}

}  // namespace bls
