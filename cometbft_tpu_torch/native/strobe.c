/* STROBE-128 duplex core (the subset merlin uses: meta-AD, AD, PRF, KEY)
 * and the batch schnorrkel challenge, a copy of cometbft_tpu/native/strobe.c:
 * the native serial rung of crypto/sr25519_math.py, whose per-row Merlin
 * transcript in Python costs milliseconds. Semantics mirror the Python
 * Strobe128 class byte for byte (tests/test_torch_native.py).
 *
 * State layout (packed, 203 bytes, shared with Python as a raw buffer):
 *   [0..199]  keccak-f1600 state
 *   [200]     pos
 *   [201]     pos_begin
 *   [202]     cur_flags
 */

#include <stdint.h>
#include <string.h>

#define R_RATE 166 /* 1600/8 - 2*128/8 - 2 */

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

static inline uint64_t rotl(uint64_t v, int n) {
  return n ? (v << n) | (v >> (64 - n)) : v;
}

static void keccakf(uint64_t a[25]) { /* lane i = x + 5*y, little-endian */
  uint64_t b[25], c[5], d[5];
  for (int r = 0; r < 24; r++) {
    for (int x = 0; x < 5; x++)
      c[x] = a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20];
    for (int x = 0; x < 5; x++)
      d[x] = c[(x + 4) % 5] ^ rotl(c[(x + 1) % 5], 1);
    for (int x = 0; x < 5; x++)
      for (int y = 0; y < 5; y++) a[x + 5 * y] ^= d[x];
    for (int x = 0; x < 5; x++)
      for (int y = 0; y < 5; y++)
        b[y + 5 * ((2 * x + 3 * y) % 5)] = rotl(a[x + 5 * y], ROTC[x][y]);
    for (int x = 0; x < 5; x++)
      for (int y = 0; y < 5; y++)
        a[x + 5 * y] = b[x + 5 * y] ^ ((~b[(x + 1) % 5 + 5 * y]) &
                                       b[(x + 2) % 5 + 5 * y]);
    a[0] ^= RC[r];
  }
}

typedef struct {
  uint8_t st[200];
  uint8_t pos;
  uint8_t pos_begin;
  uint8_t cur_flags;
} strobe_t;

static void perm(strobe_t *s) {
  uint64_t lanes[25];
  memcpy(lanes, s->st, 200);
  keccakf(lanes);
  memcpy(s->st, lanes, 200);
}

static void run_f(strobe_t *s) {
  s->st[s->pos] ^= s->pos_begin;
  s->st[s->pos + 1] ^= 0x04;
  s->st[R_RATE + 1] ^= 0x80;
  perm(s);
  s->pos = 0;
  s->pos_begin = 0;
}

static void absorb(strobe_t *s, const uint8_t *d, long n) {
  for (long i = 0; i < n; i++) {
    s->st[s->pos] ^= d[i];
    if (++s->pos == R_RATE) run_f(s);
  }
}

/* flags: I=1 A=2 C=4 T=8 M=16 K=32 */
static void begin_op(strobe_t *s, uint8_t flags, int more) {
  if (more) return; /* caller guarantees same flags (Python asserts) */
  uint8_t hdr[2];
  hdr[0] = s->pos_begin;
  hdr[1] = flags;
  s->pos_begin = s->pos + 1;
  s->cur_flags = flags;
  absorb(s, hdr, 2);
  if ((flags & 0x24) && s->pos != 0) run_f(s);
}

void strobe_new(strobe_t *s, const uint8_t *label, long label_len) {
  static const uint8_t seed[18] = {0x01, R_RATE + 2, 0x01, 0x00, 0x01, 0x60,
                                   'S',  'T',        'R',  'O',  'B',  'E',
                                   'v',  '1',        '.',  '0',  '.',  '2'};
  memset(s, 0, sizeof(*s));
  memcpy(s->st, seed, sizeof(seed));
  perm(s);
  begin_op(s, 0x12 /* M|A */, 0);
  absorb(s, label, label_len);
}

void strobe_meta_ad(strobe_t *s, const uint8_t *d, long n, int more) {
  begin_op(s, 0x12 /* M|A */, more);
  absorb(s, d, n);
}

void strobe_ad(strobe_t *s, const uint8_t *d, long n, int more) {
  begin_op(s, 0x02 /* A */, more);
  absorb(s, d, n);
}

void strobe_prf(strobe_t *s, uint8_t *out, long n, int more) {
  begin_op(s, 0x07 /* I|A|C */, more);
  for (long i = 0; i < n; i++) {
    out[i] = s->st[s->pos];
    s->st[s->pos] = 0;
    if (++s->pos == R_RATE) run_f(s);
  }
}

void strobe_key(strobe_t *s, const uint8_t *d, long n, int more) {
  begin_op(s, 0x06 /* A|C */, more);
  for (long i = 0; i < n; i++) {
    s->st[s->pos] = d[i];
    if (++s->pos == R_RATE) run_f(s);
  }
}

/* ---- batch schnorrkel verification challenges --------------------------
 * One C call for N rows replaces N Python->ctypes round trips of ~6 STROBE
 * ops each; the per-row Merlin transcript cost drops from ~30 us to a few
 * us, which is what the mixed mega-commit's host staging is made of.
 * Transcript sequence mirrors sr25519_math.compute_challenge exactly
 * (schnorrkel's SigningContext("").bytes(msg) transcript). */

static void append_message(strobe_t *s, const uint8_t *label, long ll,
                           const uint8_t *msg, long ml) {
  uint8_t len4[4] = {(uint8_t)(ml & 0xff), (uint8_t)((ml >> 8) & 0xff),
                     (uint8_t)((ml >> 16) & 0xff), (uint8_t)((ml >> 24) & 0xff)};
  strobe_meta_ad(s, label, ll, 0);
  strobe_meta_ad(s, len4, 4, 1);
  strobe_ad(s, msg, ml, 0);
}

void sr25519_batch_challenge(const uint8_t *pubs, /* n*32 */
                             const uint8_t *rs,   /* n*32 */
                             const uint8_t *msg_buf,
                             const int64_t *msg_off, /* n+1 offsets */
                             long n,
                             uint8_t *out /* n*64 */) {
  /* shared transcript prefix: Transcript("SigningContext") + empty ctx */
  strobe_t base;
  strobe_new(&base, (const uint8_t *)"Merlin v1.0", 11);
  append_message(&base, (const uint8_t *)"dom-sep", 7,
                 (const uint8_t *)"SigningContext", 14);
  append_message(&base, (const uint8_t *)"", 0, (const uint8_t *)"", 0);
  for (long i = 0; i < n; i++) {
    strobe_t s = base;
    append_message(&s, (const uint8_t *)"sign-bytes", 10,
                   msg_buf + msg_off[i], msg_off[i + 1] - msg_off[i]);
    append_message(&s, (const uint8_t *)"proto-name", 10,
                   (const uint8_t *)"Schnorr-sig", 11);
    append_message(&s, (const uint8_t *)"sign:pk", 7, pubs + 32 * i, 32);
    append_message(&s, (const uint8_t *)"sign:R", 6, rs + 32 * i, 32);
    /* challenge_bytes("sign:c", 64) */
    uint8_t len4[4] = {64, 0, 0, 0};
    strobe_meta_ad(&s, (const uint8_t *)"sign:c", 6, 0);
    strobe_meta_ad(&s, len4, 4, 1);
    strobe_prf(&s, out + 64 * i, 64, 0);
  }
}
