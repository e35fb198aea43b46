// The ed25519 challenge kernel K5 for Hopper (sm_90a): per lane, k =
// SHA-512(R || A || prefix || var || tail) mod L from the device-challenge
// wire block, in native 64-bit integer arithmetic, one lane a thread.
//
// Replaces the XLA program cometbft_tpu/ops/challenge.py:730 derive_fn (over
// its 32-bit pair emulation of SHA-512 and its base-2^16 Barrett,
// challenge.py:114-325) and the standalone programs _digest_fn (:328) and
// _reduce_fn (:351), whose device functions are K5's here: two thin entries,
// sha512_rows_kernel and reduce512_kernel.
//
// What bounds it: 64-bit integer operations. SHA-512 is ~80 rounds x ~45
// 64-bit operations a block (each two 32-bit instructions on the integer
// pipes), 2 blocks for a 186-byte vote message, and the Barrett reduction
// ~60 64-bit products; against ~100 bytes a lane of memory traffic (R, A,
// 2 + var descriptor bytes in, 32 bytes of k out; the prefix row is shared
// and cached). So it is bound by integer issue, far from the bytes.
//
// What the design does about it:
//   - one thread a lane, the state, the 16-word schedule and the reduction's
//     limbs in registers (every index a constant after unrolling), nothing
//     in local memory;
//   - the round constants in __constant__ memory: every thread of a warp
//     reads the same word;
//   - R and A read word-major (coalesced), the prefix row through L1 (the
//     lanes of a commit share one row);
//   - one wave: lanes per block = ceil(B / SMs) rounded up to whole warps,
//     at most MAX_THREADS.
// The per-lane body is derive_lane in challenge25519.cuh. The fallback-k
// scatter (fkw at fidx) is the wrapper's index_copy_ after this launch.

#include <cuda_runtime.h>

#include "challenge25519.cuh"

constexpr int MAX_THREADS = 256;

__global__ void __launch_bounds__(MAX_THREADS)
derive_kernel(const uint32_t* __restrict__ flat, const uint32_t* __restrict__ aw,
              const uint8_t* __restrict__ ptab, uint32_t* __restrict__ kw, chal::Geometry g) {
  const int lane = (int)(blockIdx.x * blockDim.x + threadIdx.x);
  if (lane >= g.B) return;
  uint32_t k[8];
  chal::derive_lane(flat, aw, ptab, g, lane, k);
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

// Lanes (threads) per block for n lanes on the current device: one wave
// over the SMs, whole warps, at most MAX_THREADS.
static int lanes_per_block(int n, int* sms_out) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (sms <= 0) sms = 1;
  int t = (n + sms - 1) / sms;
  t = (t + 31) / 32 * 32;
  if (t > MAX_THREADS) t = MAX_THREADS;
  if (sms_out) *sms_out = sms;
  return t;
}

static const void* kernel_of(int entry) {
  if (entry == 0) return (const void*)derive_kernel;
  if (entry == 1) return (const void*)sha512_rows_kernel;
  if (entry == 2) return (const void*)reduce512_kernel;
  return nullptr;
}

// k words (8, B) of a batch: flat is the wire block, aw the (8, B)
// encoding words, ptab the (TABLE_ROWS, PREFIX_CAP) prefix table.
extern "C" int challenge_derive(const void* flat, const void* aw, const void* ptab, void* kw,
                                int B, int plen, int var, int tlen, void* stream) {
  if (B <= 0) return 0;
  chal::Geometry g;
  g.B = B;
  g.plen = plen;
  g.var = var;
  g.tlen = tlen;
  g.tot = 64 + plen + var + tlen;
  g.nb = (g.tot + 17 + 127) / 128;
  if (plen < 0 || var < 0 || tlen < 0 || plen + tlen > chal::PREFIX_CAP ||
      g.nb > chal::MAX_BLOCKS)
    return (int)cudaErrorInvalidValue;
  const int t = lanes_per_block(B, nullptr);
  derive_kernel<<<(B + t - 1) / t, t, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)flat, (const uint32_t*)aw, (const uint8_t*)ptab, (uint32_t*)kw, g);
  return (int)cudaGetLastError();
}

// (n, 64) digests of n pre-padded rows of nb blocks each.
extern "C" int challenge_sha512_rows(const void* buf, int n, int nb, void* out, void* stream) {
  if (n <= 0) return 0;
  const int t = lanes_per_block(n, nullptr);
  sha512_rows_kernel<<<(n + t - 1) / t, t, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)buf, n, nb, (uint8_t*)out);
  return (int)cudaGetLastError();
}

// (n, 8) words of n little-endian 512-bit values mod L.
extern "C" int challenge_reduce512(const void* x, int n, void* out, void* stream) {
  if (n <= 0) return 0;
  const int t = lanes_per_block(n, nullptr);
  reduce512_kernel<<<(n + t - 1) / t, t, 0, (cudaStream_t)stream>>>(
      (const uint64_t*)x, n, (uint32_t*)out);
  return (int)cudaGetLastError();
}

// The launch shape of entry (0 derive, 1 sha512 rows, 2 reduce) for n lanes:
// lanes per block, blocks, threads per block, resident blocks per SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), the SM count, and the
// loaded kernel's local memory per thread and registers
// (cudaFuncGetAttributes), into out[0..6]. Returns a cudaError_t.
extern "C" int challenge_launch_shape(int entry, int n, int* out) {
  const void* kernel = kernel_of(entry);
  if (kernel == nullptr || n <= 0) return (int)cudaErrorInvalidValue;
  int sms = 0;
  const int t = lanes_per_block(n, &sms);
  int per_sm = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, t, 0);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr = {};
  err = cudaFuncGetAttributes(&attr, kernel);
  out[0] = t;
  out[1] = (n + t - 1) / t;
  out[2] = t;
  out[3] = per_sm;
  out[4] = sms;
  out[5] = (int)attr.localSizeBytes;
  out[6] = attr.numRegs;
  return (int)err;
}
