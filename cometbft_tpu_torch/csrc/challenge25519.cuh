// The per-lane body of the challenge kernel K5 (challenge25519.cu): the
// message template of a prefix-table row, a lane's variable bytes placed
// into it, SHA-512 in native 64-bit words, and the Barrett reduction mod L,
// the ed25519 group order.
//
// Host-compilable: with __device__ and __forceinline__ defined away, g++
// builds it as it stands (tests/test_torch_challenge_host.py); the CUDA-only
// pieces (the __constant__ round constants, __umul64hi, __byte_perm,
// __funnelshift_l) sit behind __CUDA_ARCH__ / __CUDACC__.
//
// Wire layout (ops/challenge.py block_words / fill_stream), one flat
// uint32 block of a batch of B lanes:
//   words[0  : 8B]   R encoding words, (8, B) word-major
//   words[8B : 16B]  s words (not read here)
//   words[16B: ...]  the descriptor stream as bytes: 2B bytes of per-lane
//                    uint16 LE descriptors (bit 15: derive on the device;
//                    bits 0-14: prefix-table row), then B lanes of `var`
//                    variable suffix bytes, lane-contiguous.
// The message of a lane is R || A || prefix || var || tail, A from the
// residency encoding plane aw (8, B), prefix and tail from row `pid` of the
// prefix table (TABLE_ROWS x PREFIX_CAP bytes: prefix then tail).
//
// Message words 0-7 (R || A) are the lane's own. Every later 64-bit
// big-endian word is the template word of the lane's row (prefix, tail,
// the 0x80 marker and the length, zero at the variable bytes), ORed with
// the lane's variable bytes where their window [64 + plen, 64 + plen + var)
// touches it: at most the four words from wv0 = (64 + plen) / 8.

#pragma once

#include <stddef.h>
#include <stdint.h>

namespace chal {

constexpr int TABLE_ROWS = 256;
constexpr int PREFIX_CAP = 160;
constexpr int MAX_BLOCKS = 3;  // 64 + MAX_MLEN (192) bytes pad to <= 3 blocks
constexpr int MAX_VAR = 24;    // ops/challenge.py MAX_VAR: the window spans <= 4 words
constexpr int VAR_WORDS = 4;

#ifdef __CUDACC__
#define CHAL_CONST __constant__
#else
#define CHAL_CONST const
#endif

static CHAL_CONST uint64_t K512[80] = {
    0x428a2f98d728ae22ULL, 0x7137449123ef65cdULL, 0xb5c0fbcfec4d3b2fULL,
    0xe9b5dba58189dbbcULL, 0x3956c25bf348b538ULL, 0x59f111f1b605d019ULL,
    0x923f82a4af194f9bULL, 0xab1c5ed5da6d8118ULL, 0xd807aa98a3030242ULL,
    0x12835b0145706fbeULL, 0x243185be4ee4b28cULL, 0x550c7dc3d5ffb4e2ULL,
    0x72be5d74f27b896fULL, 0x80deb1fe3b1696b1ULL, 0x9bdc06a725c71235ULL,
    0xc19bf174cf692694ULL, 0xe49b69c19ef14ad2ULL, 0xefbe4786384f25e3ULL,
    0x0fc19dc68b8cd5b5ULL, 0x240ca1cc77ac9c65ULL, 0x2de92c6f592b0275ULL,
    0x4a7484aa6ea6e483ULL, 0x5cb0a9dcbd41fbd4ULL, 0x76f988da831153b5ULL,
    0x983e5152ee66dfabULL, 0xa831c66d2db43210ULL, 0xb00327c898fb213fULL,
    0xbf597fc7beef0ee4ULL, 0xc6e00bf33da88fc2ULL, 0xd5a79147930aa725ULL,
    0x06ca6351e003826fULL, 0x142929670a0e6e70ULL, 0x27b70a8546d22ffcULL,
    0x2e1b21385c26c926ULL, 0x4d2c6dfc5ac42aedULL, 0x53380d139d95b3dfULL,
    0x650a73548baf63deULL, 0x766a0abb3c77b2a8ULL, 0x81c2c92e47edaee6ULL,
    0x92722c851482353bULL, 0xa2bfe8a14cf10364ULL, 0xa81a664bbc423001ULL,
    0xc24b8b70d0f89791ULL, 0xc76c51a30654be30ULL, 0xd192e819d6ef5218ULL,
    0xd69906245565a910ULL, 0xf40e35855771202aULL, 0x106aa07032bbd1b8ULL,
    0x19a4c116b8d2d0c8ULL, 0x1e376c085141ab53ULL, 0x2748774cdf8eeb99ULL,
    0x34b0bcb5e19b48a8ULL, 0x391c0cb3c5c95a63ULL, 0x4ed8aa4ae3418acbULL,
    0x5b9cca4f7763e373ULL, 0x682e6ff3d6b2b8a3ULL, 0x748f82ee5defb2fcULL,
    0x78a5636f43172f60ULL, 0x84c87814a1f0ab72ULL, 0x8cc702081a6439ecULL,
    0x90befffa23631e28ULL, 0xa4506cebde82bde9ULL, 0xbef9a3f7b2c67915ULL,
    0xc67178f2e372532bULL, 0xca273eceea26619cULL, 0xd186b8c721c0c207ULL,
    0xeada7dd6cde0eb1eULL, 0xf57d4f7fee6ed178ULL, 0x06f067aa72176fbaULL,
    0x0a637dc5a2c898a6ULL, 0x113f9804bef90daeULL, 0x1b710b35131c471bULL,
    0x28db77f523047d84ULL, 0x32caab7b40c72493ULL, 0x3c9ebe0a15c9bebcULL,
    0x431d67c49c100d4cULL, 0x4cc5d4becb3e42b6ULL, 0x597f299cfc657e2aULL,
    0x5fcb6fab3ad6faecULL, 0x6c44198c4a475817ULL};

__device__ __forceinline__ uint32_t bswap32(uint32_t x) {
#ifdef __CUDA_ARCH__
  return __byte_perm(x, 0, 0x0123);
#else
  return __builtin_bswap32(x);
#endif
}

// The upper 32 bits of (hi:lo) << sh, sh in [0, 32).
__device__ __forceinline__ uint32_t funnel_l(uint32_t lo, uint32_t hi, int sh) {
#ifdef __CUDA_ARCH__
  return __funnelshift_l(lo, hi, sh);
#else
  return (uint32_t)(((((uint64_t)hi << 32) | lo) << sh) >> 32);
#endif
}

__device__ __forceinline__ uint64_t rotr64(uint64_t x, int n) {
  return (x >> n) | (x << (64 - n));
}

// The full 128-bit product a * b as (lo, hi).
__device__ __forceinline__ void mul64(uint64_t a, uint64_t b, uint64_t& lo, uint64_t& hi) {
#ifdef __CUDA_ARCH__
  lo = a * b;
  hi = __umul64hi(a, b);
#else
  unsigned __int128 p = (unsigned __int128)a * b;
  lo = (uint64_t)p;
  hi = (uint64_t)(p >> 64);
#endif
}

// out + 2^64 * carry = a * b + acc + c (never overflows 128 bits).
__device__ __forceinline__ void mac(uint64_t a, uint64_t b, uint64_t acc, uint64_t c,
                                    uint64_t& out, uint64_t& carry) {
  uint64_t lo, hi;
  mul64(a, b, lo, hi);
  lo += acc;
  hi += lo < acc;
  lo += c;
  hi += lo < c;
  out = lo;
  carry = hi;
}

// ------------------------------------------------------------- SHA-512

struct State {
  uint64_t a, b, c, d, e, f, g, h;
};

__device__ __forceinline__ void sha512_init(uint64_t h[8]) {
  h[0] = 0x6a09e667f3bcc908ULL; h[1] = 0xbb67ae8584caa73bULL;
  h[2] = 0x3c6ef372fe94f82bULL; h[3] = 0xa54ff53a5f1d36f1ULL;
  h[4] = 0x510e527fade682d1ULL; h[5] = 0x9b05688c2b3e6c1fULL;
  h[6] = 0x1f83d9abfb41bd6bULL; h[7] = 0x5be0cd19137e2179ULL;
}

__device__ __forceinline__ State state_of(const uint64_t h[8]) {
  return State{h[0], h[1], h[2], h[3], h[4], h[5], h[6], h[7]};
}

__device__ __forceinline__ void feed_forward(uint64_t h[8], const State& s) {
  h[0] += s.a; h[1] += s.b; h[2] += s.c; h[3] += s.d;
  h[4] += s.e; h[5] += s.f; h[6] += s.g; h[7] += s.h;
}

// One round, kw = K[t] + W[t].
__device__ __forceinline__ void sha_round(State& s, uint64_t kw) {
  const uint64_t t1 = s.h + (rotr64(s.e, 14) ^ rotr64(s.e, 18) ^ rotr64(s.e, 41)) +
                      (s.g ^ (s.e & (s.f ^ s.g))) + kw;
  const uint64_t t2 = (rotr64(s.a, 28) ^ rotr64(s.a, 34) ^ rotr64(s.a, 39)) +
                      ((s.a & (s.b | s.c)) | (s.b & s.c));
  s.h = s.g;
  s.g = s.f;
  s.f = s.e;
  s.e = s.d + t1;
  s.d = s.c;
  s.c = s.b;
  s.b = s.a;
  s.a = t1 + t2;
}

// W[t + 16] into w[t], from the 16-word window w (t a constant after
// unrolling).
__device__ __forceinline__ void sched_step(uint64_t w[16], int t) {
  const uint64_t w15 = w[(t + 1) & 15], w2 = w[(t + 14) & 15];
  const uint64_t s0 = rotr64(w15, 1) ^ rotr64(w15, 8) ^ (w15 >> 7);
  const uint64_t s1 = rotr64(w2, 19) ^ rotr64(w2, 61) ^ (w2 >> 6);
  w[t] += s0 + w[(t + 9) & 15] + s1;
}

// One SHA-512 compression of the 16 big-endian message words w into h. The
// schedule lives in the 16 words (every index a constant after unrolling),
// the round constants are read from constant memory. Rounds 0-15 run
// unrolled on the message words; 16-79 as 4 rolled passes of 16 unrolled
// ones, each round with its schedule step and no branch between them, so
// the compiler interleaves the schedule with the round's dependent chain.
__device__ __forceinline__ void sha512_block(uint64_t h[8], uint64_t w[16]) {
  State s = state_of(h);
#pragma unroll
  for (int t = 0; t < 16; ++t) sha_round(s, K512[t] + w[t]);
#pragma unroll 1
  for (int r = 16; r < 80; r += 16) {
#pragma unroll
    for (int t = 0; t < 16; ++t) {
      sched_step(w, t);
      sha_round(s, K512[r + t] + w[t]);
    }
  }
  feed_forward(h, s);
}

// x (eight 64-bit little-endian limbs, a 512-bit value) mod L as eight
// little-endian 32-bit words: HAC Algorithm 14.42 with b = 2^64, k = 4
// (native/hashvec.c reduce512_mod_l_many): q3 = floor(floor(x / b^3) * mu /
// b^5), r = (x - q3 L) mod b^5, then at most two conditional subtractions.
// The result is canonical.
__device__ __forceinline__ void reduce512_mod_l(const uint64_t x[8], uint32_t k[8]) {
  const uint64_t MU[5] = {0xed9ce5a30a2c131bULL, 0x2106215d086329a7ULL,
                          0xffffffffffffffebULL, 0xffffffffffffffffULL,
                          0x000000000000000fULL};
  const uint64_t LL[5] = {0x5812631a5cf5d3edULL, 0x14def9dea2f79cd6ULL, 0, 0x1000000000000000ULL,
                          0};
  uint64_t q2[10];
#pragma unroll
  for (int i = 0; i < 10; ++i) q2[i] = 0;
#pragma unroll
  for (int i = 0; i < 5; ++i) {  // q2 = q1 * mu, q1 = x[3..7]
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < 5; ++j) mac(x[3 + i], MU[j], q2[i + j], c, q2[i + j], c);
    q2[i + 5] = c;
  }
  uint64_t r2[5] = {0, 0, 0, 0, 0};
#pragma unroll
  for (int i = 0; i < 5; ++i) {  // r2 = q3 * L mod b^5, q3 = q2[5..9]
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; i + j < 5; ++j) mac(q2[5 + i], LL[j], r2[i + j], c, r2[i + j], c);
  }
  uint64_t r[5];
  uint64_t borrow = 0;
#pragma unroll
  for (int j = 0; j < 5; ++j) {  // r = x - r2 mod b^5
    const uint64_t d = x[j] - r2[j];
    const uint64_t b1 = x[j] < r2[j];
    r[j] = d - borrow;
    borrow = b1 | (d < borrow);
  }
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {  // r < 3L: subtract L at most twice
    uint64_t t[5];
    borrow = 0;
#pragma unroll
    for (int j = 0; j < 5; ++j) {
      const uint64_t d = r[j] - LL[j];
      const uint64_t b1 = r[j] < LL[j];
      t[j] = d - borrow;
      borrow = b1 | (d < borrow);
    }
    if (!borrow) {
#pragma unroll
      for (int j = 0; j < 5; ++j) r[j] = t[j];
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    k[2 * i] = (uint32_t)r[i];
    k[2 * i + 1] = (uint32_t)(r[i] >> 32);
  }
}

// The digest state h (big-endian words, hashlib's byte order) as the
// 512-bit little-endian integer that is reduced mod L.
__device__ __forceinline__ void digest_to_le(const uint64_t h[8], uint64_t x[8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint32_t hi = (uint32_t)(h[i] >> 32), lo = (uint32_t)h[i];
    x[i] = ((uint64_t)bswap32(lo) << 32) | bswap32(hi);
  }
}

// ------------------------------------------------------ message assembly

// One batch geometry: B lanes; the message R || A || prefix (plen) || var
// || tail (tlen) is tot = 64 + plen + var + tlen bytes, padded to nb
// blocks; its variable bytes start in 64-bit word wv0 = (64 + plen) / 8.
struct Geometry {
  int B, plen, var, tlen, tot, nb, wv0;
};

__host__ __device__ __forceinline__ Geometry geometry(int B, int plen, int var, int tlen) {
  Geometry g;
  g.B = B;
  g.plen = plen;
  g.var = var;
  g.tlen = tlen;
  g.tot = 64 + plen + var + tlen;
  g.nb = (g.tot + 17 + 127) / 128;
  g.wv0 = (64 + plen) >> 3;
  return g;
}

// Byte i >= 64 of a row's template: prefix, zeros at the variable bytes,
// tail, then the 0x80 marker, zeros and the big-endian bit length in the
// last 16 bytes (tot * 8 < 2^16). `row` is the prefix-table row.
__device__ __forceinline__ uint32_t template_byte(int i, const Geometry& g, const uint8_t* row) {
  int j = i - 64;
  if (j < g.plen) return row[j];
  j -= g.plen;
  if (j < g.var) return 0;
  j -= g.var;
  if (j < g.tlen) return row[g.plen + j];
  if (i == g.tot) return 0x80u;
  const int p = i - (g.nb * 128 - 16);
  if (p >= 14) return ((uint32_t)g.tot * 8u >> (8 * (15 - p))) & 0xFFu;
  return 0;
}

// Message word m >= 8 of a row's template, big-endian.
__device__ __forceinline__ uint64_t template_word(int m, const Geometry& g, const uint8_t* row) {
  uint64_t w = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) w = (w << 8) | template_byte(8 * m + k, g, row);
  return w;
}

// The big-endian byte mask of the variable bytes in 32-bit word i (0..7)
// of the window of the four 64-bit words from wv0. Uniform over a launch.
__device__ __forceinline__ uint32_t var_mask(int i, const Geometry& g) {
  const int lo = (64 + g.plen) & 7, hi = lo + g.var;
  uint32_t m = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const int j = 4 * i + b;
    if (j >= lo && j < hi) m |= 0xFFu << (24 - 8 * b);
  }
  return m;
}

// A lane's variable bytes as the VAR_WORDS big-endian 64-bit message words
// from wv0, zero outside its window. The aligned 32-bit words that cover
// its bytes in the descriptor stream are loaded (at most 7), byte-swapped,
// and funnel-shifted into message alignment; vmask (var_mask of 0..7)
// cuts the neighbours' bytes off. Every register index is a constant.
__device__ __forceinline__ void lane_var_words(const uint32_t* flat, const Geometry& g, int lane,
                                               const uint32_t vmask[8], uint64_t v[VAR_WORDS]) {
  const size_t ob = 66 * (size_t)g.B + (size_t)lane * g.var;  // byte offset in flat
  const int sh = (int)(ob & 3);
  const int nw = g.var ? (sh + g.var + 3) >> 2 : 0;
  const uint32_t* src = flat + (ob >> 2);
  // the stream from the first loaded byte, behind two zero words
  uint32_t s[11];
  s[0] = s[1] = s[9] = s[10] = 0;
#pragma unroll
  for (int i = 0; i < 7; ++i) s[2 + i] = i < nw ? bswap32(src[i]) : 0u;
  // out byte j (from 8 wv0) is stream byte j + e, e = 8 - ((64 + plen) % 8 - sh) in [1, 11]
  const int e = 8 - (((64 + g.plen) & 7) - sh);
  const int q = e >> 2, r = 8 * (e & 3);
  uint32_t t[9];
#pragma unroll
  for (int j = 0; j < 9; ++j) t[j] = q == 0 ? s[j] : q == 1 ? s[j + 1] : s[j + 2];
#pragma unroll
  for (int k = 0; k < VAR_WORDS; ++k) {
    const uint32_t hi = funnel_l(t[2 * k + 1], t[2 * k], r) & vmask[2 * k];
    const uint32_t lo = funnel_l(t[2 * k + 2], t[2 * k + 1], r) & vmask[2 * k + 1];
    v[k] = ((uint64_t)hi << 32) | lo;
  }
}

// A lane's descriptor: bit 15 derive on the device, bits 0-14 its row.
__device__ __forceinline__ uint32_t lane_desc(const uint32_t* flat, int B, int lane) {
  return ((const uint16_t*)(flat + 16 * (size_t)B))[lane];
}

// The prefix-table row of a descriptor (a gather clamps its index).
__device__ __forceinline__ int desc_row(uint32_t desc) {
  const int pid = (int)(desc & 0x7FFFu);
  return pid > TABLE_ROWS - 1 ? TABLE_ROWS - 1 : pid;
}

// R's word t (t < 4: big-endian message word t) and A's (message word
// 4 + t), read word-major: neighbouring lanes, neighbouring addresses.
__device__ __forceinline__ uint64_t ra_word(const uint32_t* plane, int B, int lane, int t) {
  return ((uint64_t)bswap32(plane[(2 * t) * (size_t)B + lane]) << 32) |
         bswap32(plane[(2 * t + 1) * (size_t)B + lane]);
}

// Message word m >= 8 of a lane: its row's template word (trow holds words
// 8.. of the row) ORed with the lane's variable word where m is in its
// window (vw(k) reads variable word k).
template <typename VarWord>
__device__ __forceinline__ uint64_t message_word(int m, const uint64_t* trow, const Geometry& g,
                                                 VarWord vw) {
  uint64_t w = trow[m - 8];
  const unsigned k = (unsigned)(m - g.wv0);
  if (k < (unsigned)VAR_WORDS) w |= vw(k);
  return w;
}

// The challenge k of `lane` into k[8] (little-endian words): zero unless
// its descriptor's bit 15 is set, else SHA-512(R || A || prefix || var ||
// tail) mod L, assembled from the template of its row as the kernel does.
// The host's composition of the kernel's pieces, lane by lane (the kernel
// builds each row's template once a warp, in shared memory).
__device__ __forceinline__ void derive_lane(const uint32_t* flat, const uint32_t* aw,
                                            const uint8_t* ptab, const Geometry& g, int lane,
                                            uint32_t k[8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) k[i] = 0;
  const uint32_t desc = lane_desc(flat, g.B, lane);
  if (!(desc >> 15)) return;
  const uint8_t* row = ptab + (size_t)desc_row(desc) * PREFIX_CAP;
  uint64_t trow[16 * MAX_BLOCKS - 8];
  for (int m = 8; m < 16 * g.nb; ++m) trow[m - 8] = template_word(m, g, row);
  uint32_t vmask[8];
  for (int i = 0; i < 8; ++i) vmask[i] = var_mask(i, g);
  uint64_t v[VAR_WORDS];
  lane_var_words(flat, g, lane, vmask, v);
  const auto vw = [&](unsigned i) { return v[i]; };
  uint64_t h[8], w[16];
  sha512_init(h);
  for (int bi = 0; bi < g.nb; ++bi) {
    for (int t = 0; t < 16; ++t)
      w[t] = bi == 0 && t < 8 ? ra_word(t < 4 ? flat : aw, g.B, lane, t & 3)
                              : message_word(16 * bi + t, trow, g, vw);
    sha512_block(h, w);
  }
  uint64_t x[8];
  digest_to_le(h, x);
  reduce512_mod_l(x, k);
}

// SHA-512 of one pre-padded row of nb blocks (the standalone digest entry),
// read as 64-bit words (a row starts 128-byte aligned in its buffer).
__device__ __forceinline__ void sha512_row(const uint8_t* row, int nb, uint8_t* out) {
  const uint64_t* words = (const uint64_t*)row;
  uint64_t h[8], w[16];
  sha512_init(h);
#pragma unroll 1
  for (int bi = 0; bi < nb; ++bi) {
#pragma unroll
    for (int t = 0; t < 16; ++t) {
      const uint64_t v = words[16 * bi + t];
      w[t] = ((uint64_t)bswap32((uint32_t)v) << 32) | bswap32((uint32_t)(v >> 32));
    }
    sha512_block(h, w);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int q = 0; q < 8; ++q) out[8 * i + q] = (uint8_t)(h[i] >> (56 - 8 * q));
}

}  // namespace chal
