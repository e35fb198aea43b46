/* Lane-vectorized batch hash cores of the host staging rungs
 * (ops/hashvec.py), a copy of cometbft_tpu/native/hashvec.c:
 *
 *   keccak_many  — N independent Keccak-f[1600] states advanced under one
 *                  permutation call, 8 states per SIMD vector (the batch
 *                  STROBE transcript of crypto/sr25519_math.py drives this
 *                  from numpy (N, 25)-uint64 state arrays).
 *   sha512_many  — multi-buffer SHA-512: N pre-padded messages of the same
 *                  block count compressed 8 per vector (the ed25519
 *                  classic-path challenges).
 *   reduce512_mod_l_many — Barrett reduction of N 512-bit values mod L.
 *
 * Written with GCC generic vector extensions (no intrinsics): the scalar
 * algorithm on an 8-lane uint64 vector type. native/__init__.py builds it
 * with the widest ISA /proc/cpuinfo advertises (AVX-512 runs one vector per
 * instruction; AVX2 and baseline split it).
 *
 * Bit for bit equal to hashlib.sha512, the serial Keccak of
 * crypto/sr25519_math.py and Python's % L (tests/test_torch_native.py).
 */

#include <stdint.h>
#include <string.h>

#define LANES 8
typedef uint64_t vec __attribute__((vector_size(8 * LANES)));

/* ----------------------------------------------------------- keccak-f1600 */

static const uint64_t RC[24] = {
    0x0000000000000001ULL, 0x0000000000008082ULL, 0x800000000000808aULL,
    0x8000000080008000ULL, 0x000000000000808bULL, 0x0000000080000001ULL,
    0x8000000080008081ULL, 0x8000000000008009ULL, 0x000000000000008aULL,
    0x0000000000000088ULL, 0x0000000080008009ULL, 0x000000008000000aULL,
    0x000000008000808bULL, 0x800000000000008bULL, 0x8000000000008089ULL,
    0x8000000000008003ULL, 0x8000000000008002ULL, 0x8000000000000080ULL,
    0x000000000000800aULL, 0x800000008000000aULL, 0x8000000080008081ULL,
    0x8000000000008080ULL, 0x0000000080000001ULL, 0x8000000080008008ULL};

static const int ROTC[5][5] = {{0, 36, 3, 41, 18},
                               {1, 44, 10, 45, 2},
                               {62, 6, 43, 15, 61},
                               {28, 55, 25, 21, 56},
                               {27, 20, 39, 8, 14}};

/* n is a compile-time constant at every use (unrolled loops); the ternary
 * folds away and guards the n==0 lane against the UB 64-bit shift */
#define ROTV(v, n) ((n) ? (((v) << (n)) | ((v) >> (64 - (n)))) : (v))

static void keccakf_v(vec a[25]) { /* lane i = x + 5*y, as strobe.c */
  vec b[25], c[5], d[5];
  for (int r = 0; r < 24; r++) {
    for (int x = 0; x < 5; x++)
      c[x] = a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20];
    for (int x = 0; x < 5; x++)
      d[x] = c[(x + 4) % 5] ^ ROTV(c[(x + 1) % 5], 1);
    for (int x = 0; x < 5; x++)
      for (int y = 0; y < 5; y++) a[x + 5 * y] ^= d[x];
    for (int x = 0; x < 5; x++)
      for (int y = 0; y < 5; y++)
        b[y + 5 * ((2 * x + 3 * y) % 5)] = ROTV(a[x + 5 * y], ROTC[x][y]);
    for (int x = 0; x < 5; x++)
      for (int y = 0; y < 5; y++)
        a[x + 5 * y] = b[x + 5 * y] ^ ((~b[(x + 1) % 5 + 5 * y]) &
                                       b[(x + 2) % 5 + 5 * y]);
    a[0] ^= RC[r];
  }
}

/* states: n rows of 25 little-endian uint64 lanes, row-major, in place */
void keccak_many(uint64_t *states, long n) {
  long g = 0;
  for (; g < n; g += LANES) {
    int live = (n - g) < LANES ? (int)(n - g) : LANES;
    vec a[25];
    for (int i = 0; i < 25; i++) {
      for (int j = 0; j < live; j++) a[i][j] = states[(g + j) * 25 + i];
      for (int j = live; j < LANES; j++) a[i][j] = 0;
    }
    keccakf_v(a);
    for (int i = 0; i < 25; i++)
      for (int j = 0; j < live; j++) states[(g + j) * 25 + i] = a[i][j];
  }
}

/* --------------------------------------------------- SHA-512 multi-buffer */

static const uint64_t KK[80] = {
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

static const uint64_t H0[8] = {
    0x6a09e667f3bcc908ULL, 0xbb67ae8584caa73bULL, 0x3c6ef372fe94f82bULL,
    0xa54ff53a5f1d36f1ULL, 0x510e527fade682d1ULL, 0x9b05688c2b3e6c1fULL,
    0x1f83d9abfb41bd6bULL, 0x5be0cd19137e2179ULL};

#define ROTR(v, n) (((v) >> (n)) | ((v) << (64 - (n))))

/* blocks: n rows of nb*128 bytes, pre-padded per FIPS 180-4 by the caller;
 * out: n rows of 64 digest bytes (big-endian words, the hashlib layout) */
void sha512_many(const uint8_t *blocks, long n, long nb, uint8_t *out) {
  for (long g = 0; g < n; g += LANES) {
    int live = (n - g) < LANES ? (int)(n - g) : LANES;
    vec h[8];
    for (int i = 0; i < 8; i++)
      for (int j = 0; j < LANES; j++) h[i][j] = H0[i];
    for (long bi = 0; bi < nb; bi++) {
      vec w[16];
      for (int t = 0; t < 16; t++)
        for (int j = 0; j < LANES; j++) {
          long row = g + (j < live ? j : 0); /* dead lanes mirror row 0 */
          uint64_t x;
          memcpy(&x, blocks + (row * nb + bi) * 128 + t * 8, 8);
          w[t][j] = __builtin_bswap64(x);
        }
      vec a = h[0], b = h[1], c = h[2], d = h[3];
      vec e = h[4], f = h[5], gg = h[6], hh = h[7];
      for (int t = 0; t < 80; t++) {
        if (t >= 16) {
          vec w15 = w[(t - 15) & 15], w2 = w[(t - 2) & 15];
          vec s0 = ROTR(w15, 1) ^ ROTR(w15, 8) ^ (w15 >> 7);
          vec s1 = ROTR(w2, 19) ^ ROTR(w2, 61) ^ (w2 >> 6);
          w[t & 15] = w[t & 15] + s0 + w[(t - 7) & 15] + s1;
        }
        vec S1 = ROTR(e, 14) ^ ROTR(e, 18) ^ ROTR(e, 41);
        vec ch = gg ^ (e & (f ^ gg));
        vec t1 = hh + S1 + ch + KK[t] + w[t & 15];
        vec S0 = ROTR(a, 28) ^ ROTR(a, 34) ^ ROTR(a, 39);
        vec mj = (a & (b | c)) | (b & c);
        vec t2 = S0 + mj;
        hh = gg; gg = f; f = e; e = d + t1;
        d = c; c = b; b = a; a = t1 + t2;
      }
      h[0] += a; h[1] += b; h[2] += c; h[3] += d;
      h[4] += e; h[5] += f; h[6] += gg; h[7] += hh;
    }
    for (int j = 0; j < live; j++)
      for (int i = 0; i < 8; i++) {
        uint64_t x = __builtin_bswap64(h[i][j]);
        memcpy(out + (g + j) * 64 + i * 8, &x, 8);
      }
  }
}

/* ------------------------------------------- Barrett reduction mod L
 * k = digest mod L (the ed25519 group order) for N 512-bit little-endian
 * values — the wide-reduction step of both schemes' challenge pipelines.
 * HAC Algorithm 14.42 with b = 2^64, k = 4: q3 = floor(floor(x/b^3)*mu /
 * b^5), r = (x - q3*L) mod b^5, then at most two conditional subtractions.
 * Bit-for-bit equal to Python's int.from_bytes(d, "little") % L. */

typedef unsigned __int128 u128;

static const uint64_t MU5[5] = {/* floor(2^512 / L), 261 bits */
    0xed9ce5a30a2c131bULL, 0x2106215d086329a7ULL, 0xffffffffffffffebULL,
    0xffffffffffffffffULL, 0x000000000000000fULL};
static const uint64_t L5[5] = {
    0x5812631a5cf5d3edULL, 0x14def9dea2f79cd6ULL, 0x0000000000000000ULL,
    0x1000000000000000ULL, 0x0000000000000000ULL};

/* in: n rows of 64 little-endian bytes; out: n rows of 32 bytes (mod L) */
void reduce512_mod_l_many(const uint8_t *in, long n, uint8_t *out) {
  for (long row = 0; row < n; row++) {
    uint64_t x[8];
    memcpy(x, in + row * 64, 64);
    const uint64_t *q1 = x + 3; /* floor(x / b^3): 5 limbs */
    uint64_t q2[10] = {0};
    for (int i = 0; i < 5; i++) { /* q2 = q1 * mu */
      u128 c = 0;
      for (int j = 0; j < 5; j++) {
        u128 s = (u128)q1[i] * MU5[j] + q2[i + j] + c;
        q2[i + j] = (uint64_t)s;
        c = s >> 64;
      }
      q2[i + 5] = (uint64_t)c;
    }
    const uint64_t *q3 = q2 + 5; /* floor(q2 / b^5): 5 limbs */
    uint64_t r2[5] = {0};
    for (int i = 0; i < 5; i++) { /* r2 = q3 * L mod b^5 */
      u128 c = 0;
      for (int j = 0; j + i < 5; j++) {
        u128 s = (u128)q3[i] * L5[j] + r2[i + j] + c;
        r2[i + j] = (uint64_t)s;
        c = s >> 64;
      }
    }
    uint64_t r[5];
    uint64_t borrow = 0;
    for (int j = 0; j < 5; j++) { /* r = x - r2 mod b^5 */
      u128 d = (u128)x[j] - r2[j] - borrow;
      r[j] = (uint64_t)d;
      borrow = (uint64_t)(d >> 64) & 1;
    }
    for (int pass = 0; pass < 2; pass++) { /* r < 3L: subtract L <= twice */
      uint64_t t[5];
      borrow = 0;
      for (int j = 0; j < 5; j++) {
        u128 d = (u128)r[j] - L5[j] - borrow;
        t[j] = (uint64_t)d;
        borrow = (uint64_t)(d >> 64) & 1;
      }
      if (!borrow) memcpy(r, t, sizeof(r));
    }
    memcpy(out + row * 32, r, 32);
  }
}
