// The BLS12-381 base field in 12 x 32-bit limbs, one lane per thread, for the
// BLS kernels (bls12381.cu).
//
// An element is a 384-bit little-endian value in twelve uint32 words, in the
// Montgomery domain with R = 2^384, always fully reduced into [0, p): every
// operation ends with a conditional subtraction, so equality is word
// equality and zero has one representative. The product is CIOS Montgomery
// multiplication: on the card in PTX carry chains (mad.lo.cc / madc.hi.cc,
// the even and the odd words of a row as two chains), on the host in its
// portable "no-carry" form (p's top word is below 2^31 - 1, so the row's two
// carry words never overflow) with (uint64_t)a * b multiply-adds; both give
// the one fully reduced value. It is inlined into its callers, so that its
// operands stay in registers. Additions, subtractions and the final
// reduction are likewise PTX carry chains on the card (add.cc / addc.cc,
// each chain two asm statements of six words with the carry handed over in
// a register: the carry flag does not live from one asm statement to the
// next, and a chain split across statements loses it) and 64-bit C++ on
// the host. Inversion and the Legendre symbol are binary (variable-time:
// every input of the BLS kernels is public), a few hundred word shifts and
// subtractions instead of a 380-bit exponentiation; fixed exponents use
// 4-bit windows. Apart from the card's product and additions, a host C++
// compiler builds the same code with __device__ and __forceinline__ defined
// away (tests/test_torch_bls_host.py, tests/test_torch_bls_formulas.py).
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
constexpr int K_R3 = 645;       // R^3 mod p (raw): the binary inverse back to Montgomery
constexpr int K_GLS = 657;      // c = (3(x^2 - 1))^-1 mod r as sum d_i x^i, 0 <= d_i < |x|:
constexpr int GLS_DIGITS = 5;   //   d_0 .. d_4, two words each
constexpr int K_PSI = K_GLS + 2 * GLS_DIGITS;  // Fp2 xi^-((p-1)/3), xi^-((p-1)/2): psi on the twist
constexpr int K_BETA = K_PSI + 4 * NW;  // beta: sigma(x, y) = (beta x, y) acts as [-x^2] on G1
constexpr int K_X2 = K_BETA + NW;       // x^2 (raw, 4 words), then its bit length (one word)
constexpr int NK = K_X2 + 5;

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

// bit i of x^2 and its bit length (G1's subgroup test)
__device__ __forceinline__ int x2_bit(int i) { return (c_k[K_X2 + (i >> 5)] >> (i & 31)) & 1; }
__device__ __forceinline__ int x2_nbits() { return (int)c_k[K_X2 + 4]; }

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

#ifdef __CUDA_ARCH__
// The card's additions: each 12-word chain as two asm blocks of six words,
// the carry (or borrow) handed from the first to the second in a register
// and turned back into the flag there (c + 0xffffffff carries iff c = 1;
// 0 - b borrows iff b = 1), so no flag lives across asm statements.
#define BLS_ADD6(O0, O1, O2, O3, O4, O5, C, A0, A1, A2, A3, A4, A5, B0, B1, B2, B3, B4, B5, CIN) \
  asm("add.cc.u32 %0, %7, 0xffffffff;\n\t"                                                       \
      "addc.cc.u32 %0, %8, %14;\n\t"                                                            \
      "addc.cc.u32 %1, %9, %15;\n\t"                                                            \
      "addc.cc.u32 %2, %10, %16;\n\t"                                                           \
      "addc.cc.u32 %3, %11, %17;\n\t"                                                           \
      "addc.cc.u32 %4, %12, %18;\n\t"                                                           \
      "addc.cc.u32 %5, %13, %19;\n\t"                                                           \
      "addc.u32 %6, 0, 0;"                                                                      \
      : "=&r"(O0), "=&r"(O1), "=&r"(O2), "=&r"(O3), "=&r"(O4), "=&r"(O5), "=r"(C)              \
      : "r"(CIN), "r"(A0), "r"(A1), "r"(A2), "r"(A3), "r"(A4), "r"(A5), "r"(B0), "r"(B1),      \
        "r"(B2), "r"(B3), "r"(B4), "r"(B5))
#define BLS_SUB6(O0, O1, O2, O3, O4, O5, C, A0, A1, A2, A3, A4, A5, B0, B1, B2, B3, B4, B5, BIN) \
  asm("sub.cc.u32 %0, 0, %7;\n\t"                                                               \
      "subc.cc.u32 %0, %8, %14;\n\t"                                                            \
      "subc.cc.u32 %1, %9, %15;\n\t"                                                            \
      "subc.cc.u32 %2, %10, %16;\n\t"                                                           \
      "subc.cc.u32 %3, %11, %17;\n\t"                                                           \
      "subc.cc.u32 %4, %12, %18;\n\t"                                                           \
      "subc.cc.u32 %5, %13, %19;\n\t"                                                           \
      "subc.u32 %6, 0, 0;"                                                                      \
      : "=&r"(O0), "=&r"(O1), "=&r"(O2), "=&r"(O3), "=&r"(O4), "=&r"(O5), "=r"(C)              \
      : "r"(BIN), "r"(A0), "r"(A1), "r"(A2), "r"(A3), "r"(A4), "r"(A5), "r"(B0), "r"(B1),      \
        "r"(B2), "r"(B3), "r"(B4), "r"(B5))

// x (value < 2p, with an extra top word) -> x mod p
__device__ __forceinline__ void fp_reduce_once(fp& o, const uint32_t* x, uint32_t top) {
  uint32_t s[NW], p[NW], br;
#pragma unroll
  for (int i = 0; i < NW; ++i) p[i] = c_k[K_P + i];
  BLS_SUB6(s[0], s[1], s[2], s[3], s[4], s[5], br, x[0], x[1], x[2], x[3], x[4], x[5], p[0], p[1],
           p[2], p[3], p[4], p[5], 0u);
  BLS_SUB6(s[6], s[7], s[8], s[9], s[10], s[11], br, x[6], x[7], x[8], x[9], x[10], x[11], p[6],
           p[7], p[8], p[9], p[10], p[11], br & 1u);
  const uint32_t m = 0u - (uint32_t)(top >= (br & 1u));  // x >= p: take x - p
#pragma unroll
  for (int i = 0; i < NW; ++i) o.v[i] = (s[i] & m) | (x[i] & ~m);
}
#else
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
#endif

#ifdef __CUDA_ARCH__
// o = a + b - p where that is >= 0, else a + b (a, b < p)
__device__ __forceinline__ void fp_add(fp& o, const fp& a, const fp& b) {
  uint32_t t[NW], s[NW], p[NW], c, top, br;
#pragma unroll
  for (int i = 0; i < NW; ++i) p[i] = c_k[K_P + i];
  BLS_ADD6(t[0], t[1], t[2], t[3], t[4], t[5], c, a.v[0], a.v[1], a.v[2], a.v[3], a.v[4],
           a.v[5], b.v[0], b.v[1], b.v[2], b.v[3], b.v[4], b.v[5], 0u);
  BLS_ADD6(t[6], t[7], t[8], t[9], t[10], t[11], top, a.v[6], a.v[7], a.v[8], a.v[9], a.v[10],
           a.v[11], b.v[6], b.v[7], b.v[8], b.v[9], b.v[10], b.v[11], c);
  BLS_SUB6(s[0], s[1], s[2], s[3], s[4], s[5], br, t[0], t[1], t[2], t[3], t[4], t[5], p[0], p[1],
           p[2], p[3], p[4], p[5], 0u);
  BLS_SUB6(s[6], s[7], s[8], s[9], s[10], s[11], br, t[6], t[7], t[8], t[9], t[10], t[11], p[6],
           p[7], p[8], p[9], p[10], p[11], br & 1u);
  const uint32_t m = 0u - (uint32_t)(top >= (br & 1u));  // the sum is >= p: take it minus p
#pragma unroll
  for (int i = 0; i < NW; ++i) o.v[i] = (s[i] & m) | (t[i] & ~m);
}

// o = a - b, plus p where that borrows (a, b < p)
__device__ __forceinline__ void fp_sub(fp& o, const fp& a, const fp& b) {
  uint32_t t[NW], q[NW], c, br;
  BLS_SUB6(t[0], t[1], t[2], t[3], t[4], t[5], br, a.v[0], a.v[1], a.v[2], a.v[3], a.v[4], a.v[5],
           b.v[0], b.v[1], b.v[2], b.v[3], b.v[4], b.v[5], 0u);
  BLS_SUB6(t[6], t[7], t[8], t[9], t[10], t[11], br, a.v[6], a.v[7], a.v[8], a.v[9], a.v[10],
           a.v[11], b.v[6], b.v[7], b.v[8], b.v[9], b.v[10], b.v[11], br & 1u);
  const uint32_t m = 0u - (br & 1u);
#pragma unroll
  for (int i = 0; i < NW; ++i) q[i] = c_k[K_P + i] & m;
  BLS_ADD6(o.v[0], o.v[1], o.v[2], o.v[3], o.v[4], o.v[5], c, t[0], t[1], t[2], t[3], t[4], t[5],
           q[0], q[1], q[2], q[3], q[4], q[5], 0u);
  BLS_ADD6(o.v[6], o.v[7], o.v[8], o.v[9], o.v[10], o.v[11], c, t[6], t[7], t[8], t[9], t[10],
           t[11], q[6], q[7], q[8], q[9], q[10], q[11], c);
}
#undef BLS_ADD6
#undef BLS_SUB6
#else
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
#endif

__device__ __forceinline__ void fp_neg(fp& o, const fp& a) {
  fp z;
  fp_zero(z);
  fp_sub(o, z, a);
}

__device__ __forceinline__ void fp_dbl(fp& o, const fp& a) { fp_add(o, a, a); }

#ifdef __CUDA_ARCH__
// t[k..k+12] += the words a0, a2, .., a10 times b at t[k], t[k+2], ..:
// lo halves at even offsets, hi halves at odd ones, one carry chain
// (mad.lo.cc / madc.hi.cc), its carry into the 13th word
#define BLS_MAD_CHAIN(T0, T1, T2, T3, T4, T5, T6, T7, T8, T9, T10, T11, T12, A0, A2, A4, A6, A8, \
                      A10, B)                                                                    \
  asm("mad.lo.cc.u32 %0, %13, %19, %0;\n\t madc.hi.cc.u32 %1, %13, %19, %1;\n\t"              \
      "madc.lo.cc.u32 %2, %14, %19, %2;\n\t madc.hi.cc.u32 %3, %14, %19, %3;\n\t"             \
      "madc.lo.cc.u32 %4, %15, %19, %4;\n\t madc.hi.cc.u32 %5, %15, %19, %5;\n\t"             \
      "madc.lo.cc.u32 %6, %16, %19, %6;\n\t madc.hi.cc.u32 %7, %16, %19, %7;\n\t"             \
      "madc.lo.cc.u32 %8, %17, %19, %8;\n\t madc.hi.cc.u32 %9, %17, %19, %9;\n\t"             \
      "madc.lo.cc.u32 %10, %18, %19, %10;\n\t madc.hi.cc.u32 %11, %18, %19, %11;\n\t"         \
      "addc.u32 %12, %12, 0;"                                                                    \
      : "+r"(T0), "+r"(T1), "+r"(T2), "+r"(T3), "+r"(T4), "+r"(T5), "+r"(T6), "+r"(T7),          \
        "+r"(T8), "+r"(T9), "+r"(T10), "+r"(T11), "+r"(T12)                                      \
      : "r"(A0), "r"(A2), "r"(A4), "r"(A6), "r"(A8), "r"(A10), "r"(B))

// CIOS Montgomery product a * b / 2^384 mod p on the card: each row adds
// a * b[i] and then m * p as two carry chains each (even and odd words),
// then drops the zero low word; t stays below 2p
__device__ __forceinline__ void fp_mul(fp& o, const fp& x, const fp& y) {
  uint32_t t0 = 0, t1 = 0, t2 = 0, t3 = 0, t4 = 0, t5 = 0, t6 = 0, t7 = 0, t8 = 0, t9 = 0,
           t10 = 0, t11 = 0, t12 = 0, t13 = 0;
  const uint32_t* a = x.v;
  uint32_t p[NW];
#pragma unroll
  for (int i = 0; i < NW; ++i) p[i] = c_k[K_P + i];
  const uint32_t n0 = c_k[K_N0];
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    const uint32_t b = y.v[i];
    BLS_MAD_CHAIN(t0, t1, t2, t3, t4, t5, t6, t7, t8, t9, t10, t11, t12, a[0], a[2], a[4], a[6],
                  a[8], a[10], b);
    BLS_MAD_CHAIN(t1, t2, t3, t4, t5, t6, t7, t8, t9, t10, t11, t12, t13, a[1], a[3], a[5], a[7],
                  a[9], a[11], b);
    const uint32_t m = t0 * n0;
    BLS_MAD_CHAIN(t0, t1, t2, t3, t4, t5, t6, t7, t8, t9, t10, t11, t12, p[0], p[2], p[4], p[6],
                  p[8], p[10], m);
    BLS_MAD_CHAIN(t1, t2, t3, t4, t5, t6, t7, t8, t9, t10, t11, t12, t13, p[1], p[3], p[5], p[7],
                  p[9], p[11], m);
    t0 = t1, t1 = t2, t2 = t3, t3 = t4, t4 = t5, t5 = t6, t6 = t7, t7 = t8, t8 = t9, t9 = t10;
    t10 = t11, t11 = t12, t12 = t13, t13 = 0;
  }
  const uint32_t t[NW] = {t0, t1, t2, t3, t4, t5, t6, t7, t8, t9, t10, t11};
  fp_reduce_once(o, t, t12);
}
#undef BLS_MAD_CHAIN
#else
// CIOS Montgomery product a * b / 2^384 mod p, no-carry form: row i adds
// a * b[i] (carry A) and m * p (carry C) in one pass; t stays below 2p. The
// host's product, and the card's reference (tests/test_torch_bls_host.py
// holds the host build against the plain versions; chip_smoke.py holds the
// card's)
__device__ __forceinline__ void fp_mul(fp& o, const fp& a, const fp& b) {
  uint32_t t[NW];
  const uint32_t n0 = c_k[K_N0];
#pragma unroll
  for (int j = 0; j < NW; ++j) t[j] = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    const uint32_t bi = b.v[i];
    uint64_t x = (uint64_t)a.v[0] * bi + t[0];
    uint32_t A = (uint32_t)(x >> 32);
    const uint32_t m = (uint32_t)x * n0;
    uint64_t y = (uint64_t)m * c_k[K_P] + (uint32_t)x;
    uint32_t C = (uint32_t)(y >> 32);
#pragma unroll
    for (int j = 1; j < NW; ++j) {
      x = (uint64_t)a.v[j] * bi + t[j] + A;
      A = (uint32_t)(x >> 32);
      y = (uint64_t)m * c_k[K_P + j] + (uint32_t)x + C;
      C = (uint32_t)(y >> 32);
      t[j - 1] = (uint32_t)y;
    }
    t[NW - 1] = C + A;
  }
  fp_reduce_once(o, t, 0);
}
#endif

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

// the 4-bit digit of exponent e at bit i (a multiple of 4)
__device__ __forceinline__ int exp_digit4(int e, int i) {
  return (int)((c_k[exp_offset(e) + (i >> 5)] >> (i & 31)) & 15);
}

// a^e for a fixed exponent of the table: fixed 4-bit windows, MSB first
__device__ BLS_NOINLINE void fp_pow(fp& o, const fp& a, int e) {
  fp tab[16];
  fp_one(tab[0]);
  tab[1] = a;
  for (int i = 2; i < 16; ++i) fp_mul(tab[i], tab[i - 1], a);
  const int top = (exp_nbits(e) - 1) & ~3;
  fp acc = tab[exp_digit4(e, top)];
  for (int i = top - 4; i >= 0; i -= 4) {
    for (int k = 0; k < 4; ++k) fp_mul(acc, acc, acc);
    const int d = exp_digit4(e, i);
    if (d) fp_mul(acc, acc, tab[d]);
  }
  o = acc;
}

// ---------------------------------------------- binary (variable-time) code
// on raw words below 2^384; the inputs are public

__device__ __forceinline__ int bls_ctz(uint32_t x) {
#ifdef __CUDA_ARCH__
  return __ffs((int)x) - 1;
#else
  return __builtin_ctz(x);
#endif
}

__device__ __forceinline__ bool w_is_zero(const uint32_t* a) {
  uint32_t acc = 0;
  for (int i = 0; i < NW; ++i) acc |= a[i];
  return acc == 0;
}

__device__ __forceinline__ bool w_is_one(const uint32_t* a) {
  uint32_t acc = a[0] ^ 1u;
  for (int i = 1; i < NW; ++i) acc |= a[i];
  return acc == 0;
}

// a < b
__device__ __forceinline__ bool w_lt(const uint32_t* a, const uint32_t* b) {
  int64_t br = 0;
  for (int i = 0; i < NW; ++i) {
    br += (int64_t)a[i] - b[i];
    br >>= 32;
  }
  return br < 0;
}

// a -= b (a >= b)
__device__ __forceinline__ void w_sub(uint32_t* a, const uint32_t* b) {
  int64_t br = 0;
  for (int i = 0; i < NW; ++i) {
    br += (int64_t)a[i] - b[i];
    a[i] = (uint32_t)br;
    br >>= 32;
  }
}

// a >>= s, 0 < s < 32
__device__ __forceinline__ void w_shr(uint32_t* a, int s) {
  for (int i = 0; i < NW - 1; ++i) a[i] = (a[i] >> s) | (a[i + 1] << (32 - s));
  a[NW - 1] >>= s;
}

// x / 2 mod p for x < p
__device__ __forceinline__ void w_half_mod_p(uint32_t* x) {
  const uint32_t m = 0u - (x[0] & 1u);
  uint64_t c = 0;
  for (int i = 0; i < NW; ++i) {
    c += (uint64_t)x[i] + (c_k[K_P + i] & m);
    x[i] = (uint32_t)c;
    c >>= 32;
  }
  w_shr(x, 1);  // x + p < 2^382: no carry out
}

// x = x - y mod p for x, y < p
__device__ __forceinline__ void w_sub_mod_p(uint32_t* x, const uint32_t* y) {
  int64_t br = 0;
  for (int i = 0; i < NW; ++i) {
    br += (int64_t)x[i] - y[i];
    x[i] = (uint32_t)br;
    br >>= 32;
  }
  const uint32_t m = 0u - (uint32_t)(br < 0);
  uint64_t c = 0;
  for (int i = 0; i < NW; ++i) {
    c += (uint64_t)x[i] + (c_k[K_P + i] & m);
    x[i] = (uint32_t)c;
    c >>= 32;
  }
}

// the inverse by the binary extended Euclidean algorithm on the Montgomery
// word A = aR: x1 A = u, x2 A = v (mod p) until u or v is 1; then
// A^-1 R^3 / R = a^-1 R. inv(0) = 0
__device__ BLS_NOINLINE void fp_inv(fp& o, const fp& a) {
  if (fp_is_zero(a)) {
    fp_zero(o);
    return;
  }
  uint32_t u[NW], v[NW], x1[NW], x2[NW];
  for (int i = 0; i < NW; ++i) {
    u[i] = a.v[i];
    v[i] = c_k[K_P + i];
    x1[i] = 0;
    x2[i] = 0;
  }
  x1[0] = 1;
  while (!w_is_one(u) && !w_is_one(v)) {
    while (!(u[0] & 1u)) {
      w_shr(u, 1);
      w_half_mod_p(x1);
    }
    while (!(v[0] & 1u)) {
      w_shr(v, 1);
      w_half_mod_p(x2);
    }
    if (!w_lt(u, v)) {
      w_sub(u, v);
      w_sub_mod_p(x1, x2);
    } else {
      w_sub(v, u);
      w_sub_mod_p(x2, x1);
    }
  }
  const bool one_u = w_is_one(u);
  fp r, r3;
  for (int i = 0; i < NW; ++i) r.v[i] = one_u ? x1[i] : x2[i];
  fp_k(r3, K_R3);
  fp_mul(o, r, r3);
}

// the Legendre symbol (a / p) by the binary Jacobi algorithm: 1, -1, or 0
// for zero. It reads a's Montgomery word aR, whose symbol is a's (R = 2^384
// is a square)
__device__ BLS_NOINLINE int fp_legendre(const fp& a) {
  uint32_t u[NW], v[NW];
  for (int i = 0; i < NW; ++i) {
    u[i] = a.v[i];
    v[i] = c_k[K_P + i];
  }
  int t = 1;
  while (!w_is_zero(u)) {
    while (u[0] == 0) {  // a whole zero word: shift by 32, an even count
      for (int i = 0; i < NW - 1; ++i) u[i] = u[i + 1];
      u[NW - 1] = 0;
    }
    const int s = bls_ctz(u[0]);
    if (s) {
      w_shr(u, s);
      const uint32_t v8 = v[0] & 7u;
      if ((s & 1) && (v8 == 3 || v8 == 5)) t = -t;
    }
    if (w_lt(u, v)) {  // reciprocity: swap, u and v odd
      for (int i = 0; i < NW; ++i) {
        const uint32_t w = u[i];
        u[i] = v[i];
        v[i] = w;
      }
      if ((u[0] & 3u) == 3 && (v[0] & 3u) == 3) t = -t;
    }
    w_sub(u, v);
  }
  return w_is_one(v) ? t : 0;
}

// a / 2 mod p
__device__ __forceinline__ void fp_half(fp& o, const fp& a) {
  o = a;
  w_half_mod_p(o.v);
}

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
