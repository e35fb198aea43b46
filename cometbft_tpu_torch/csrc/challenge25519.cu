// The ed25519 challenge kernel K5 for Hopper (sm_90a): per lane, k =
// SHA-512(R || A || prefix || var || tail) mod L from the device-challenge
// wire block, in native 64-bit integer arithmetic.
//
// Replaces the XLA program cometbft_tpu/ops/challenge.py:730 derive_fn (over
// its 32-bit pair emulation of SHA-512 and its base-2^16 Barrett,
// challenge.py:114-325) and the standalone programs _digest_fn (:328) and
// _reduce_fn (:351), whose device functions are K5's here: two thin entries,
// sha512_rows_kernel and reduce512_kernel.
//
// What bounds it on this card: integer issue of one warp on one scheduler.
// A lane is 80 rounds of ~28 32-bit instructions and 64 schedule steps of
// ~20 a SHA-512 block (two blocks for a 186-byte vote message), then 40
// 64 x 64-bit products for the Barrett reduction, ~10,000 instructions; its
// bytes (R, A, 2 + var descriptor bytes in, 32 bytes of k out) are ~100.
// 10,240 lanes are only 320 warps for the card's 528 schedulers: each
// scheduler issues at most one warp's stream, a dependent chain a round, so
// the time is one warp's, not the card's operations bound.
//
// What the design does about it:
//   - a message template per prefix-table row, built once a warp: the warp
//     dedupes its lanes' rows (__match_any_sync), stages each row in shared
//     memory with 16-byte loads and builds the row's big-endian message
//     words after R || A (prefix, tail, 0x80, length; zero at the variable
//     bytes), 32 neighbouring bytes at a time. A lane then loads only its
//     own bytes: R and A word-major, its variable bytes as the aligned
//     32-bit words that cover them, placed by funnel shifts under byte masks
//     computed once a block, and ORed into the <= 4 template words they
//     touch (challenge25519.cuh): no byte loads from global memory and no
//     per-byte branch chain a lane;
//   - blocks of at most 32 lanes (one warp of lanes), B / SMs of them when
//     that is fewer, so that every SM holds work at 256, 6,144 and 10,240
//     lanes; one wave; the SM count asked once per device (sm_count.cuh);
//   - one thread a lane: the state, the 16-word schedule and the
//     reduction's limbs in registers (every index a constant after
//     unrolling), the round constants in __constant__ memory. A
//     warp-specialised pair (one warp on the rounds, one expanding the
//     schedule a ring of chunks ahead) was timed beside it and not kept:
//     it was slower at 10,240 lanes and saved < 0.004 ms a launch below
//     (PERF.md);
//   - nothing in local memory: 0 B stack, no spills (-Xptxas -v).
// The fallback-k scatter (fkw at fidx) is the wrapper's index_copy_ after
// this launch.

#include <cuda_runtime.h>

#include "challenge25519.cuh"
#include "sm_count.cuh"

constexpr int WARP = 32;
constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr int ROW_VECS = chal::PREFIX_CAP / 16;
constexpr int MAX_THREADS = 256;  // the standalone entries' blocks

// The warp's templates: its lanes' distinct rows (one slot each), staged in
// `rows` with 16-byte loads, and their message words 8 .. 16 nb - 1 built
// into `tmpl` ([slot][word]). Every thread of the warp calls it. Returns
// the lane's slot (0 for a lane that derives nothing).
__device__ __forceinline__ int stage_templates(const uint8_t* __restrict__ ptab,
                                               const chal::Geometry& g, bool use, int row, int l,
                                               uint64_t* tmpl, uint8_t* rows, int* slot_row) {
  const unsigned peers = __match_any_sync(FULL_MASK, use ? row : -1);
  const int first = __ffs(peers) - 1;
  const bool leader = use && first == l;
  const unsigned leaders = __ballot_sync(FULL_MASK, leader);
  const int slot = use ? __popc(leaders & ((1u << first) - 1u)) : 0;
  if (leader) slot_row[slot] = row;
  __syncwarp();
  const int nslots = __popc(leaders), nbytes = 8 * (16 * g.nb - 8);
  for (int i = l; i < nslots * ROW_VECS; i += WARP) {
    const int s = i / ROW_VECS, c = i % ROW_VECS;
    ((uint4*)(rows + s * chal::PREFIX_CAP))[c] =
        __ldg((const uint4*)(ptab + (size_t)slot_row[s] * chal::PREFIX_CAP) + c);
  }
  __syncwarp();
  // a slot's template bytes 32 at a time, neighbouring threads on
  // neighbouring bytes (one branch of template_byte for most of the warp);
  // byte k of a big-endian word is byte 7 - k of the stored uint64
  uint8_t* tb = (uint8_t*)tmpl;
  for (int s = 0; s < nslots; ++s)
    for (int j = l; j < nbytes; j += WARP)
      tb[s * nbytes + (j ^ 7)] =
          (uint8_t)chal::template_byte(64 + j, g, rows + s * chal::PREFIX_CAP);
  __syncwarp();
  return slot;
}

// Shared memory of a block of lpb lanes, nb message blocks: templates
// [lpb][16 nb - 8], variable words [VAR_WORDS][lpb], then the staged rows
// [lpb][PREFIX_CAP].
static size_t smem_bytes(int lpb, int nb) {
  return 8 * (size_t)lpb * (16 * nb - 8 + chal::VAR_WORDS) + (size_t)lpb * chal::PREFIX_CAP;
}

__global__ void __launch_bounds__(WARP)
derive_kernel(const uint32_t* __restrict__ flat, const uint32_t* __restrict__ aw,
              const uint8_t* __restrict__ ptab, uint32_t* __restrict__ kw, chal::Geometry g,
              int lpb) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int slot_row[WARP];
  __shared__ uint32_t vmask[8];
  const int nwt = 16 * g.nb - 8;
  uint64_t* tmpl = (uint64_t*)smem;
  uint64_t* vw = tmpl + lpb * nwt;
  uint8_t* rows = (uint8_t*)(vw + chal::VAR_WORDS * lpb);
  const int l = threadIdx.x;
  const int col = l < lpb ? l : 0;  // threads past the block's lanes read column 0
  const int lane = blockIdx.x * lpb + l;
  const bool live = l < lpb && lane < g.B;
  const uint32_t desc = live ? chal::lane_desc(flat, g.B, lane) : 0u;
  const bool use = (desc >> 15) != 0;

  const int slot = stage_templates(ptab, g, use, chal::desc_row(desc), l, tmpl, rows, slot_row);
  if (l < 8) vmask[l] = chal::var_mask(l, g);
  __syncwarp();
  uint64_t v[chal::VAR_WORDS] = {0, 0, 0, 0};
  uint64_t ra[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  if (use) {
    chal::lane_var_words(flat, g, lane, vmask, v);
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      ra[t] = chal::ra_word(flat, g.B, lane, t);
      ra[4 + t] = chal::ra_word(aw, g.B, lane, t);
    }
  }
  if (l < lpb) {
#pragma unroll
    for (int k = 0; k < chal::VAR_WORDS; ++k) vw[k * lpb + l] = v[k];
  }
  const uint64_t* trow = tmpl + slot * nwt;
  const auto var_word = [&](unsigned k) { return vw[k * lpb + col]; };
  uint64_t h[8], w[16];
  chal::sha512_init(h);
#pragma unroll 1
  for (int bi = 0; bi < g.nb; ++bi) {
#pragma unroll
    for (int t = 0; t < 16; ++t)
      w[t] = bi == 0 && t < 8 ? ra[t] : chal::message_word(16 * bi + t, trow, g, var_word);
    if (use) chal::sha512_block(h, w);
  }
  if (!live) return;
  uint32_t k[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  if (use) {
    uint64_t x[8];
    chal::digest_to_le(h, x);
    chal::reduce512_mod_l(x, k);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) kw[i * (size_t)g.B + lane] = k[i];
}

__global__ void __launch_bounds__(MAX_THREADS)
sha512_rows_kernel(const uint8_t* __restrict__ buf, int n, int nb, uint8_t* __restrict__ out) {
  const int row = (int)(blockIdx.x * blockDim.x + threadIdx.x);
  if (row >= n) return;
  chal::sha512_row(buf + (size_t)row * nb * 128, nb, out + (size_t)row * 64);
}

__global__ void __launch_bounds__(MAX_THREADS)
reduce512_kernel(const uint64_t* __restrict__ x, int n, uint32_t* __restrict__ out) {
  const int row = (int)(blockIdx.x * blockDim.x + threadIdx.x);
  if (row >= n) return;
  uint64_t v[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = x[(size_t)row * 8 + i];
  uint32_t k[8];
  chal::reduce512_mod_l(v, k);
#pragma unroll
  for (int i = 0; i < 8; ++i) out[(size_t)row * 8 + i] = k[i];
}

// ------------------------------------------------------------ C interface
// Pointers are device pointers from torch tensors; stream is the caller's
// cudaStream_t. Each returns a cudaError_t (0 on success).

// Lanes per derive block for B lanes on `sms` SMs: a warp of lanes, or
// B / sms when that leaves SMs idle.
static int derive_lanes_per_block(int B, int sms) {
  int lpb = B / sms;
  if (lpb > WARP) lpb = WARP;
  if (lpb < 1) lpb = 1;
  return lpb;
}

// Threads per block of the standalone entries for n rows: one wave over
// the SMs, whole warps, at most MAX_THREADS.
static int rows_per_block(int n, int sms) {
  int t = (n + sms - 1) / sms;
  t = (t + WARP - 1) / WARP * WARP;
  return t > MAX_THREADS ? MAX_THREADS : t;
}

// k words (8, B) of a batch: flat is the wire block, aw the (8, B)
// encoding words, ptab the (TABLE_ROWS, PREFIX_CAP) prefix table (16-byte
// aligned).
extern "C" int challenge_derive(const void* flat, const void* aw, const void* ptab, void* kw,
                                int B, int plen, int var, int tlen, void* stream) {
  if (B <= 0) return 0;
  const chal::Geometry g = chal::geometry(B, plen, var, tlen);
  if (plen < 0 || var < 0 || tlen < 0 || var > chal::MAX_VAR ||
      plen + tlen > chal::PREFIX_CAP || g.nb > chal::MAX_BLOCKS || ((size_t)ptab & 15))
    return (int)cudaErrorInvalidValue;
  const int lpb = derive_lanes_per_block(B, sm_count());
  derive_kernel<<<(B + lpb - 1) / lpb, WARP, smem_bytes(lpb, g.nb), (cudaStream_t)stream>>>(
      (const uint32_t*)flat, (const uint32_t*)aw, (const uint8_t*)ptab, (uint32_t*)kw, g, lpb);
  return (int)cudaGetLastError();
}

// (n, 64) digests of n pre-padded rows of nb blocks each.
extern "C" int challenge_sha512_rows(const void* buf, int n, int nb, void* out, void* stream) {
  if (n <= 0) return 0;
  const int t = rows_per_block(n, sm_count());
  sha512_rows_kernel<<<(n + t - 1) / t, t, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)buf, n, nb, (uint8_t*)out);
  return (int)cudaGetLastError();
}

// (n, 8) words of n little-endian 512-bit values mod L.
extern "C" int challenge_reduce512(const void* x, int n, void* out, void* stream) {
  if (n <= 0) return 0;
  const int t = rows_per_block(n, sm_count());
  reduce512_kernel<<<(n + t - 1) / t, t, 0, (cudaStream_t)stream>>>(
      (const uint64_t*)x, n, (uint32_t*)out);
  return (int)cudaGetLastError();
}

// The launch shape of entry (0 derive, 1 sha512 rows, 2 reduce) for n lanes
// (derive at MAX_BLOCKS message blocks): lanes per block, blocks, threads
// per block, resident blocks per SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), the SM count, and the
// loaded kernel's local memory per thread and registers
// (cudaFuncGetAttributes), into out[0..6]. Returns a cudaError_t.
extern "C" int challenge_launch_shape(int entry, int n, int* out) {
  if (n <= 0 || entry < 0 || entry > 2) return (int)cudaErrorInvalidValue;
  const int sms = sm_count();
  const void* kernel = entry == 1   ? (const void*)sha512_rows_kernel
                       : entry == 2 ? (const void*)reduce512_kernel
                                    : (const void*)derive_kernel;
  int lanes, threads;
  size_t smem = 0;
  if (entry == 0) {
    lanes = derive_lanes_per_block(n, sms);
    threads = WARP;
    smem = smem_bytes(lanes, chal::MAX_BLOCKS);
  } else {
    lanes = threads = rows_per_block(n, sms);
  }
  int per_sm = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr = {};
  err = cudaFuncGetAttributes(&attr, kernel);
  out[0] = lanes;
  out[1] = (n + lanes - 1) / lanes;
  out[2] = threads;
  out[3] = per_sm;
  out[4] = sms;
  out[5] = (int)attr.localSizeBytes;
  out[6] = attr.numRegs;
  return (int)err;
}
