// Field and point arithmetic of curve25519 in 8 x 32-bit limbs, one lane per
// thread, for the verify kernels (verify25519.cu).
//
// A field element is a 256-bit little-endian value in eight uint32 words,
// loosely reduced: any value below 2^256 stands for itself mod p = 2^255 -
// 19. Zero therefore has three representatives (0, p, 2p); canonicalize,
// is_zero and parity reduce fully, and nothing else needs a canonical value.
// Products are 32x32 -> 64-bit multiply-adds written as (uint64_t)a * b in
// portable C++ (nvcc emits IMAD.WIDE.U32); the 512-bit product folds by 38
// (2^256 = 38 mod p) and then by 19 at bit 255 (2^255 = 19), which leaves a
// value below 2^255 + 2^11. Sums, differences and the folds are carry chains
// in uint64_t. There is no inline assembly, so a host C++ compiler builds the
// same code with __device__ and __forceinline__ defined away
// (tests/test_torch_fe32_host.py).
//
// Points are extended twisted Edwards coordinates (X, Y, Z, T), a = -1; the
// point operations of the verify kernels run on four threads
// (quad25519.cuh), and this file holds what one thread does alone: the
// decodings of R (ZIP-215 and ristretto255), -R in the cached form (Y - X,
// Y + X, 2Z, 2dT) the additions take, and the unpacking of the kernels'
// inputs. Every operation computes the plain version's value mod p
// (cometbft_tpu_torch/ops/field.py, curve.py), so verdicts taken from
// canonical values agree with it bit for bit on any input.

#pragma once

#include <cstdint>

namespace f32 {

constexpr int NW = 8;  // words of a field element

struct fe {
  uint32_t v[NW];
};

struct pt {
  fe x, y, z, t;
};

// (Y - X, Y + X, 2Z, 2dT); for an affine entry z2 is unused (Z = 1).
struct cached {
  fe ymx, ypx, z2, t2d;
};

// ------------------------------------------------------------- constants

__device__ __forceinline__ void set_words(fe& o, uint32_t w0, uint32_t w1, uint32_t w2,
                                          uint32_t w3, uint32_t w4, uint32_t w5,
                                          uint32_t w6, uint32_t w7) {
  o.v[0] = w0;
  o.v[1] = w1;
  o.v[2] = w2;
  o.v[3] = w3;
  o.v[4] = w4;
  o.v[5] = w5;
  o.v[6] = w6;
  o.v[7] = w7;
}

__device__ __forceinline__ void zero(fe& o) { set_words(o, 0, 0, 0, 0, 0, 0, 0, 0); }
__device__ __forceinline__ void one(fe& o) { set_words(o, 1, 0, 0, 0, 0, 0, 0, 0); }

// d = -121665/121666, 2d and sqrt(-1), canonical (a CPU test holds these
// words against the port's constants).
__device__ __forceinline__ void const_d(fe& o) {
  set_words(o, 0x135978a3u, 0x75eb4dcau, 0x4141d8abu, 0x00700a4du, 0x7779e898u,
            0x8cc74079u, 0x2b6ffe73u, 0x52036ceeu);
}
__device__ __forceinline__ void const_d2(fe& o) {
  set_words(o, 0x26b2f159u, 0xebd69b94u, 0x8283b156u, 0x00e0149au, 0xeef3d130u,
            0x198e80f2u, 0x56dffce7u, 0x2406d9dcu);
}
__device__ __forceinline__ void const_sqrt_m1(fe& o) {
  set_words(o, 0x4a0ea0b0u, 0xc4ee1b27u, 0xad2fe478u, 0x2f431806u, 0x3dfbd7a7u,
            0x2b4d0099u, 0x4fc1df0bu, 0x2b832480u);
}

// ------------------------------------------------------------------ field

// r (bits >= 255 already cleared) + 19 * hi, hi < 2^27: below 2^256.
__device__ __forceinline__ void fold19(fe& o, const uint32_t* r, uint32_t hi) {
  uint64_t c = (uint64_t)r[0] + 19u * hi;
  o.v[0] = (uint32_t)c;
#pragma unroll
  for (int i = 1; i < 8; i++) {
    c = (uint64_t)r[i] + (c >> 32);
    o.v[i] = (uint32_t)c;
  }
}

// 9-word value r[0..7] + top * 2^256 -> below 2^256 (top < 2^26).
__device__ __forceinline__ void fold_top(fe& o, uint32_t* r, uint32_t top) {
  uint32_t hi = (top << 1) | (r[7] >> 31);
  r[7] &= 0x7fffffffu;
  fold19(o, r, hi);
}

__device__ __forceinline__ void add(fe& o, const fe& a, const fe& b) {
  uint32_t r[8];
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    c = (uint64_t)a.v[i] + b.v[i] + (c >> 32);
    r[i] = (uint32_t)c;
  }
  fold_top(o, r, (uint32_t)(c >> 32));
}

// a - b + 4p = a + ~b + (2^256 - 75): positive and below 3 * 2^256.
__device__ __forceinline__ void sub(fe& o, const fe& a, const fe& b) {
  uint32_t r[8];
  uint64_t c = (uint64_t)a.v[0] + (uint32_t)~b.v[0] + 0xffffffb5u;
  r[0] = (uint32_t)c;
#pragma unroll
  for (int i = 1; i < 8; i++) {
    c = (uint64_t)a.v[i] + (uint32_t)~b.v[i] + 0xffffffffu + (c >> 32);
    r[i] = (uint32_t)c;
  }
  fold_top(o, r, (uint32_t)(c >> 32));
}

__device__ __forceinline__ void neg(fe& o, const fe& a) {
  fe z;
  zero(z);
  sub(o, z, a);
}

// 512-bit product t[16] -> below 2^256: t_lo + 38 * t_hi, then the fold at
// bit 255.
__device__ __forceinline__ void reduce512(fe& o, const uint32_t* t) {
  uint32_t r[8];
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    c = (uint64_t)t[8 + i] * 38u + t[i] + (c >> 32);
    r[i] = (uint32_t)c;
  }
  fold_top(o, r, (uint32_t)(c >> 32));
}

// Operand scanning: row i adds a[i] * b into t[i..i+8]; each step's sum
// a*b + t + carry is at most 2^64 - 1.
__device__ __forceinline__ void mul(fe& o, const fe& a, const fe& b) {
  uint32_t t[16];
  uint64_t c = 0;
#pragma unroll
  for (int j = 0; j < 8; j++) {
    c = (uint64_t)a.v[0] * b.v[j] + (c >> 32);
    t[j] = (uint32_t)c;
  }
  t[8] = (uint32_t)(c >> 32);
#pragma unroll
  for (int i = 1; i < 8; i++) {
    c = 0;
#pragma unroll
    for (int j = 0; j < 8; j++) {
      c = (uint64_t)a.v[i] * b.v[j] + t[i + j] + (c >> 32);
      t[i + j] = (uint32_t)c;
    }
    t[i + 8] = (uint32_t)(c >> 32);
  }
  reduce512(o, t);
}

// The 28 cross products once, doubled by a shift, then the 8 squares.
__device__ __forceinline__ void sq(fe& o, const fe& a) {
  uint32_t t[16];
  uint64_t c = 0;
  t[0] = 0;
#pragma unroll
  for (int j = 1; j < 8; j++) {
    c = (uint64_t)a.v[0] * a.v[j] + (c >> 32);
    t[j] = (uint32_t)c;
  }
  t[8] = (uint32_t)(c >> 32);
#pragma unroll
  for (int i = 1; i < 7; i++) {
    c = 0;
#pragma unroll
    for (int j = i + 1; j < 8; j++) {
      c = (uint64_t)a.v[i] * a.v[j] + t[i + j] + (c >> 32);
      t[i + j] = (uint32_t)c;
    }
    t[i + 8] = (uint32_t)(c >> 32);
  }
  t[15] = t[14] >> 31;
#pragma unroll
  for (int k = 14; k >= 1; k--) t[k] = (t[k] << 1) | (t[k - 1] >> 31);
  c = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    c = (uint64_t)a.v[i] * a.v[i] + t[2 * i] + (c >> 32);
    t[2 * i] = (uint32_t)c;
    c = (uint64_t)t[2 * i + 1] + (c >> 32);
    t[2 * i + 1] = (uint32_t)c;
  }
  reduce512(o, t);
}

__device__ __forceinline__ void sqn(fe& x, int n) {
#pragma unroll 1
  for (int k = 0; k < n; k++) sq(x, x);
}

// z^((p-5)/8) = z^(2^252 - 3), the ref10 addition chain (field.pow22523).
__device__ __forceinline__ void pow22523(fe& o, const fe& z) {
  fe z2, z9, z11, t, z_5_0, z_10_0, z_20_0, z_50_0, z_100_0;
  sq(z2, z);
  t = z2;
  sqn(t, 2);
  mul(z9, t, z);
  mul(z11, z9, z2);
  sq(t, z11);
  mul(z_5_0, t, z9);
  t = z_5_0;
  sqn(t, 5);
  mul(z_10_0, t, z_5_0);
  t = z_10_0;
  sqn(t, 10);
  mul(z_20_0, t, z_10_0);
  t = z_20_0;
  sqn(t, 20);
  mul(t, t, z_20_0);  // z_40_0
  sqn(t, 10);
  mul(z_50_0, t, z_10_0);
  t = z_50_0;
  sqn(t, 50);
  mul(z_100_0, t, z_50_0);
  t = z_100_0;
  sqn(t, 100);
  mul(t, t, z_100_0);  // z_200_0
  sqn(t, 50);
  mul(t, t, z_50_0);  // z_250_0
  sqn(t, 2);
  mul(o, t, z);
}

// The representative in [0, p): two folds at bit 255 bring any value below
// 2^256 under 2^255; what is left at or above p is at most p + 18, and it
// is p or more exactly when adding 19 reaches bit 255.
__device__ __forceinline__ void canonicalize(fe& o, const fe& a) {
  uint32_t r[8];
  fe x = a;
#pragma unroll
  for (int k = 0; k < 2; k++) {
#pragma unroll
    for (int i = 0; i < 8; i++) r[i] = x.v[i];
    fold_top(x, r, 0);
  }
  fe u;
  fold19(u, x.v, 1);
  uint32_t ge = 0u - (u.v[7] >> 31);  // all ones where x >= p
  u.v[7] &= 0x7fffffffu;
#pragma unroll
  for (int i = 0; i < 8; i++) o.v[i] = (u.v[i] & ge) | (x.v[i] & ~ge);
}

__device__ __forceinline__ bool is_zero(const fe& a) {
  fe c;
  canonicalize(c, a);
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) acc |= c.v[i];
  return acc == 0;
}

// LSB of the canonical value (field.parity): the sign of an encoding.
__device__ __forceinline__ int parity(const fe& a) {
  fe c;
  canonicalize(c, a);
  return (int)(c.v[0] & 1u);
}

// ------------------------------------------------------------ conversion

// Twenty radix-2^13 int32 limbs (the decoders' and the key cache's carried
// limbs, any int32 each) -> their value mod p: a serial signed carry leaves
// limbs 0..18 in [0, 8191] and a signed top at 2^247; the top's bits from
// 2^255 up fold by 19, and a negative fold adds p first.
__device__ __forceinline__ void from_limbs13(fe& o, const int32_t* l) {
  uint32_t r[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  int64_t c = 0;
#pragma unroll
  for (int i = 0; i < 19; i++) {
    c += l[i];
    uint32_t m = (uint32_t)(c & 8191);
    c >>= 13;  // arithmetic: floors, as the plain version's carries
    const int bit = 13 * i, w = bit >> 5, off = bit & 31;
    r[w] |= m << off;
    if (off > 19) r[w + 1] |= m >> (32 - off);
  }
  int64_t top = c + l[19];
  r[7] |= (uint32_t)(top & 255) << 23;  // bits 247..254
  int64_t s = 19 * (top >> 8);          // |s| < 2^29
  const uint32_t p_add = s < 0 ? 0xffffffffu : 0u;
  c = (int64_t)r[0] + s + (int64_t)(0xffffffedu & p_add);
  o.v[0] = (uint32_t)c;
#pragma unroll
  for (int i = 1; i < 8; i++) {
    c = (c >> 32) + (int64_t)r[i] + (int64_t)((i == 7 ? 0x7fffffffu : 0xffffffffu) & p_add);
    o.v[i] = (uint32_t)c;
  }
}

// The canonical value of a as twenty radix-2^13 limbs (the decoders'
// output, which the key cache holds): limbs 0..18 in [0, 8191] and the top,
// bits 247..254, below 2^8.
__device__ __forceinline__ void to_limbs13(int32_t* l, const fe& a) {
  fe c;
  canonicalize(c, a);
#pragma unroll
  for (int i = 0; i < 20; i++) {
    const int bit = 13 * i, w = bit >> 5, off = bit & 31;
    uint32_t v = c.v[w] >> off;
    if (off > 19 && w < 7) v |= c.v[w + 1] << (32 - off);
    l[i] = (int32_t)(v & 8191u);
  }
}

// Any value below 2^256 in eight little-endian words (already a loose
// element), and the canonical value's words.
__device__ __forceinline__ void from_words256(fe& o, const uint32_t* w) {
#pragma unroll
  for (int i = 0; i < 8; i++) o.v[i] = w[i];
}

__device__ __forceinline__ void to_words(uint32_t* w, const fe& a) {
  fe c;
  canonicalize(c, a);
#pragma unroll
  for (int i = 0; i < 8; i++) w[i] = c.v[i];
}

// The low 255 bits of a packed little-endian encoding (any value below
// 2^255 is a loose field element: ZIP-215 takes y mod p) and its bit 255.
__device__ __forceinline__ void from_words255(fe& y, int& sign, const uint32_t* w) {
#pragma unroll
  for (int i = 0; i < 8; i++) y.v[i] = w[i];
  sign = (int)(w[7] >> 31);
  y.v[7] &= 0x7fffffffu;
}

// ------------------------------------------------------------------ curve

__device__ __forceinline__ void neg(pt& o, const pt& p) {
  neg(o.x, p.x);
  o.y = p.y;
  o.z = p.z;
  neg(o.t, p.t);
}

// The cached form of q (its Y - X, Y + X, 2Z and T * 2d).
__device__ __forceinline__ void to_cached(cached& o, const pt& q) {
  fe d2;
  const_d2(d2);
  sub(o.ymx, q.y, q.x);
  add(o.ypx, q.y, q.x);
  add(o.z2, q.z, q.z);
  mul(o.t2d, q.t, d2);
}

// ZIP-215 decompression (curve.decompress_zip215): y any value below 2^256
// (taken mod p). Returns ok; where ok is false the coordinates are garbage,
// as in the plain version.
__device__ __forceinline__ bool decompress(pt& o, const fe& y, int sign) {
  fe yy, u, v, v3, v7, t, x, vxx, c;
  sq(yy, y);
  one(c);
  sub(u, yy, c);
  const_d(t);
  mul(v, t, yy);
  add(v, v, c);
  sq(t, v);
  mul(v3, t, v);
  sq(t, v3);
  mul(v7, t, v);
  mul(t, u, v7);
  pow22523(t, t);
  mul(x, u, v3);
  mul(x, x, t);
  sq(t, x);
  mul(vxx, v, t);
  sub(t, vxx, u);
  bool root1 = is_zero(t);
  add(t, vxx, u);
  bool root2 = is_zero(t);
  if (!root1) {
    const_sqrt_m1(t);
    mul(x, x, t);
  }
  bool ok = root1 || root2;
  fe xc;
  canonicalize(xc, x);
  uint32_t nz = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) nz |= xc.v[i];
  if (nz == 0 && sign == 1) ok = false;  // x = 0 with the sign bit set
  if ((int)(xc.v[0] & 1u) != sign) neg(x, x);
  o.x = x;
  o.y = y;
  one(o.z);
  mul(o.t, x, y);
  return ok;
}

// SQRT_RATIO_M1 (curve.sqrt_ratio_m1): r = the even root of u/v or of
// i*u/v; returns was_square.
__device__ __forceinline__ bool sqrt_ratio_m1(fe& r, const fe& u, const fe& v) {
  fe v3, v7, t, check, sm1;
  sq(t, v);
  mul(v3, t, v);
  sq(t, v3);
  mul(v7, t, v);
  mul(t, u, v7);
  pow22523(t, t);
  mul(r, u, v3);
  mul(r, r, t);
  sq(t, r);
  mul(check, v, t);
  sub(t, check, u);
  bool correct = is_zero(t);
  add(t, check, u);
  bool flipped = is_zero(t);
  const_sqrt_m1(sm1);
  mul(t, u, sm1);
  add(t, check, t);
  bool flipped_i = is_zero(t);
  if (flipped || flipped_i) mul(r, r, sm1);
  if (parity(r)) neg(r, r);  // CT_ABS: the even root
  return correct || flipped;
}

// ristretto255 DECODE (curve.ristretto_decode_device) of the encoding whose
// low 255 bits are s and bit 255 is hi. Returns ok; where ok is false the
// coordinates are garbage, as in the plain version.
__device__ __forceinline__ bool ristretto_decode(pt& o, const fe& s, int hi) {
  fe sc, c1, ss, u1, u2, u2sq, v, t, invsqrt, den_x, den_y;
  // s < p (canonical), s even, bit 255 clear
  canonicalize(sc, s);
  uint32_t diff = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) diff |= sc.v[i] ^ s.v[i];
  bool pre_ok = diff == 0 && (s.v[0] & 1u) == 0 && hi == 0;
  one(c1);
  sq(ss, s);
  sub(u1, c1, ss);
  add(u2, c1, ss);
  sq(u2sq, u2);
  const_d(t);
  mul(t, t, u1);
  mul(t, t, u1);
  neg(t, t);
  sub(v, t, u2sq);  // v = -d*u1^2 - u2^2
  mul(t, v, u2sq);
  bool was_square = sqrt_ratio_m1(invsqrt, c1, t);
  mul(den_x, invsqrt, u2);
  mul(den_y, invsqrt, den_x);
  mul(den_y, den_y, v);
  add(t, s, s);
  mul(o.x, t, den_x);
  if (parity(o.x)) neg(o.x, o.x);
  mul(o.y, u1, den_y);
  mul(o.t, o.x, o.y);
  one(o.z);
  return pre_ok && was_square && parity(o.t) == 0 && !is_zero(o.y);
}

// ------------------------------------------------------------ unpacking

enum Scheme { ED25519, SR25519 };

constexpr int NDIG = 51;     // signed 5-bit digits of a scalar
constexpr int ENTRIES = 17;  // table entries [0..16]

// Lane b's 8 packed words of a (8, B) int32 array.
__device__ __forceinline__ void load_words(uint32_t* w, const int* words, int b, int B) {
#pragma unroll
  for (int i = 0; i < 8; i++) w[i] = (uint32_t)words[i * B + b];
}

// Bits [bit, bit + 5) of the 256-bit little-endian value in w[8].
__device__ __forceinline__ int bits5(const uint32_t* w, int bit) {
  int wi = bit >> 5, off = bit & 31;
  uint32_t v = w[wi] >> off;
  if (off > 27 && wi + 1 < 8) v |= w[wi + 1] << (32 - off);
  return (int)(v & 31u);
}

// unpack.words_to_digits5_signed: 51 signed digits in [-16, 15] (bit 255 is
// dropped), stored at dig[j * stride].
__device__ __forceinline__ void store_digits(int8_t* dig, int stride, const int* words, int b,
                                             int B) {
  uint32_t w[8];
  load_words(w, words, b, B);
  int carry = 0;
#pragma unroll
  for (int j = 0; j < NDIG; j++) {
    int v = bits5(w, 5 * j) + carry;
    carry = v >= 16 ? 1 : 0;
    dig[j * stride] = (int8_t)(v - 32 * carry);
  }
}

// One coordinate of lane b from its (20, B) radix-2^13 limbs.
__device__ __forceinline__ void load_limbs13(fe& o, const int* src, int b, int B) {
  int32_t l[20];
#pragma unroll
  for (int i = 0; i < 20; i++) l[i] = src[i * B + b];
  from_limbs13(o, l);
}

// A coordinate's canonical radix-2^13 limbs into lane b of a (20, B) array.
__device__ __forceinline__ void store_limbs13(int* dst, const fe& a, int b, int B) {
  int32_t l[20];
  to_limbs13(l, a);
#pragma unroll
  for (int i = 0; i < 20; i++) dst[i * B + b] = l[i];
}

__device__ __forceinline__ void load_point13(pt& o, const int* ax, const int* ay, const int* az,
                                             const int* at, int b, int B) {
  load_limbs13(o.x, ax, b, B);
  load_limbs13(o.y, ay, b, B);
  load_limbs13(o.z, az, b, B);
  load_limbs13(o.t, at, b, B);
}

}  // namespace f32
