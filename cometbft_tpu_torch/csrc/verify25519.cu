// Ed25519 ZIP-215 (K1) and sr25519 (K2) batch verification for Hopper
// (sm_90a): four threads per signature, 8 x 32-bit limbs.
//
// Replaces the Pallas TPU kernel cometbft_tpu/ops/pallas_verify.py
// _verify_block_kernel, scheme "ed25519" (K1) and scheme "sr25519" (K2),
// with its bisection knobs (_verify_pallas_bench) as a third instantiation.
// The pubkey decoders are decompress25519.cu.
//
// What bounds it: 32-bit integer multiply-adds. A signature costs about
// 2,800 field multiplications (R decoding ~280, the -A table ~110, the
// 51-window ladder ~2,400, the cofactor check ~20-30); in 8 x 32-bit limbs a
// multiplication is 64 32x32 -> 64-bit products plus 8 folding by 38, a
// square 36 + 8, and each product is two IMADs (low and high half): 358,424
// IMADs per ed25519 signature, 0.22 ms for 10,240 signatures at the H100's
// IMAD rate. Memory traffic is ~1 KB per signature and never matters. The
// carry chains between the products (uint64_t adds: IADD3 on the integer
// pipe, which runs at the IMAD pipe's rate) cost as many instructions again.
//
// What the design does about it:
//   - the field is fe32.cuh: 8 x 32-bit limbs, products by IMAD.WIDE.U32,
//     values loosely reduced below 2^256 and canonical only for is_zero and
//     parity (radix-2^13 limbs take ~2.8x the IMADs);
//   - four threads per signature (a quad), thread q owning coordinate q of
//     the accumulator, so every point operation runs its multiplications
//     four at a time: 4x the warps of one thread per signature, each with a
//     quarter of the serial chain, which the latency of one warp per
//     scheduler bounded (see the quads below);
//   - nothing lives in local memory: every field and point operation is
//     inlined and takes values; the quads' tables of [d](-A), d = 0..16
//     (17 x 4 x 32 B = 2,176 B a signature), live in shared memory laid out
//     [limb][entry][signature][coord], so a warp's 32 reads fall in 32 banks
//     whatever the digits; the [d]B table and the signed digits of s and k
//     sit beside them;
//   - the grid is one wave: signatures per block = ceil(B / SMs) rounded up
//     to 8 (a warp of quads), at most MAX_SIGS, which one SM's shared memory
//     bounds (verify_launch_shape reports the occupancy);
//   - the window and doubling loops stay rolled (#pragma unroll 1), so the
//     inlined code fits the instruction cache;
//   - R is decoded after the ladder, by all four threads of the quad: its
//     square root has no 4-way form, and a warp issues the same instructions
//     whether one thread of each quad or all four run them.
// The sequence of field operations is the plain version's (ops/curve.py,
// verify_kernel.verify_math), so masks agree with it bit for bit on any
// input; only intermediates' representations differ.

#include <cuda_runtime.h>

#include "quad25519.cuh"

using namespace f32;

__host__ __device__ constexpr size_t smem_bytes(int sigs) {
  return 4 * (size_t)(BASE_WORDS + table_words(sigs)) + 2 * NDIG * (size_t)sigs;
}

// Signatures per block at most: the most whole warps of quads whose shared
// memory fits the 232,448 bytes a block may have (96 in 8 x 32-bit limbs).
constexpr int MAX_SIGS = (int)((232448 - smem_bytes(0)) / (smem_bytes(1) - smem_bytes(0))) / 8 * 8;

// One signature per quad (quad25519.cuh verify_quad): thread 0 of the quad
// writes mask[b], and the block's warps clear *allok where any signature
// failed. Shared memory holds the block's [d]B table, its quads' tables of
// [d](-A) and their signed digits. A quad past the batch's end works on the
// last signature's inputs and writes nothing, so every shuffle has its
// whole warp.
//
// verify_kernel<SCHEME> is the production kernel. verify_kernel<ED25519,
// int, int> is the microbench's (the Pallas kernel's n_windows/stages knobs,
// ops/microbench.py probe_bisect): knobs = (n_windows, nodecomp). The knobs
// are a parameter pack, empty for the production kernels, whose code the
// bench's never reaches.
template <int SCHEME, typename... Knobs>
__global__ void __launch_bounds__(4 * MAX_SIGS)
verify_kernel(const int* __restrict__ ax, const int* __restrict__ ay,
              const int* __restrict__ az, const int* __restrict__ at,
              const int* __restrict__ rw, const int* __restrict__ sw,
              const int* __restrict__ kw, const int* __restrict__ base_table,
              int* __restrict__ mask, int* __restrict__ allok, int B, Knobs... knobs) {
  constexpr bool BENCH = sizeof...(Knobs) == 2;
  static_assert(BENCH || sizeof...(Knobs) == 0, "knobs are (n_windows, nodecomp)");
  extern __shared__ uint32_t smem[];
  const int sigs = blockDim.x >> 2, sig = threadIdx.x >> 2;
  uint32_t* tb = smem;
  uint32_t* ta = smem + BASE_WORDS;
  int8_t* dig = (int8_t*)(ta + table_words(sigs));
  load_base_table(tb, base_table, threadIdx.x, blockDim.x);
  __syncthreads();

  const int b0 = blockIdx.x * sigs + sig;
  const bool live = b0 < B;
  const int b = live ? b0 : B - 1;
  int n_windows = 0, nodecomp = 0;
  if constexpr (BENCH) {
    const int kn[] = {knobs...};
    n_windows = kn[0];
    nodecomp = kn[1];
  }
  const quad Q = quad_of(threadIdx.x);
  const quad_table tab{ta + sig * 4, sigs * 4};
  const bool ok = verify_quad<SCHEME, BENCH>(Q, ax, ay, az, at, rw, sw, kw, tb, tab, dig + sig,
                                             dig + NDIG * sigs + sig, sigs, b, B, n_windows,
                                             nodecomp);
  if (live && Q.q == 0) mask[b] = ok ? 1 : 0;
  const int valid = live && !ok ? 0 : 1;
  if (!__all_sync(FULL, valid) && (threadIdx.x & 31) == 0) atomicAnd(allok, 0);
}

// ------------------------------------------------------------ C interface
// Pointers are device pointers from torch tensors; stream is the caller's
// cudaStream_t. Each returns the launch's cudaError_t (0 on success).

// Signatures per block for a batch of B on the current device: one wave
// over the SMs, a multiple of 8 (a warp of quads), at most MAX_SIGS.
static int sigs_per_block(int B, int* sms_out) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (sms <= 0) sms = 1;
  int n = (B + sms - 1) / sms;
  n = (n + 7) / 8 * 8;
  if (n > MAX_SIGS) n = MAX_SIGS;
  if (n < 8) n = 8;
  if (sms_out) *sms_out = sms;
  return n;
}

template <int SCHEME, typename... Knobs>
static int launch_verify(const void* ax, const void* ay, const void* az, const void* at,
                         const void* rw, const void* sw, const void* kw, const void* base_table,
                         void* mask, void* allok, int B, void* stream, Knobs... knobs) {
  if (B <= 0) return 0;
  auto kernel = verify_kernel<SCHEME, Knobs...>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem_bytes(MAX_SIGS));
  if (err != cudaSuccess) return (int)err;
  const int sigs = sigs_per_block(B, nullptr);
  kernel<<<(B + sigs - 1) / sigs, 4 * sigs, smem_bytes(sigs), (cudaStream_t)stream>>>(
      (const int*)ax, (const int*)ay, (const int*)az, (const int*)at, (const int*)rw,
      (const int*)sw, (const int*)kw, (const int*)base_table, (int*)mask, (int*)allok, B,
      knobs...);
  return (int)cudaGetLastError();
}

extern "C" int ed25519_verify(const void* ax, const void* ay, const void* az,
                              const void* at, const void* rw, const void* sw,
                              const void* kw, const void* base_table, void* mask,
                              void* allok, int B, void* stream) {
  return launch_verify<ED25519>(ax, ay, az, at, rw, sw, kw, base_table, mask, allok, B,
                                stream);
}

extern "C" int sr25519_verify(const void* ax, const void* ay, const void* az,
                              const void* at, const void* rw, const void* sw,
                              const void* kw, const void* base_table, void* mask,
                              void* allok, int B, void* stream) {
  return launch_verify<SR25519>(ax, ay, az, at, rw, sw, kw, base_table, mask, allok, B,
                                stream);
}

// The bench kernel: n_windows (0 = all 51) and nodecomp as above.
extern "C" int ed25519_verify_bench(const void* ax, const void* ay, const void* az,
                                    const void* at, const void* rw, const void* sw,
                                    const void* kw, const void* base_table, void* mask,
                                    void* allok, int B, int n_windows, int nodecomp,
                                    void* stream) {
  if (n_windows < 0 || n_windows > NDIG) return (int)cudaErrorInvalidValue;
  return launch_verify<ED25519, int, int>(ax, ay, az, at, rw, sw, kw, base_table, mask,
                                          allok, B, stream, n_windows, nodecomp);
}

// The launch shape of a batch of B for entry `which` (0 ed25519, 1 sr25519,
// 2 the bench kernel): signatures per block, blocks, threads per block,
// resident blocks per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor at
// that block size and shared memory), the SM count, and the loaded kernel's
// local memory per thread and registers (cudaFuncGetAttributes), into
// out[0..6]. Returns a cudaError_t.
extern "C" int verify_launch_shape(int which, int B, int* out) {
  const void* kernels[] = {(const void*)verify_kernel<ED25519>,
                           (const void*)verify_kernel<SR25519>,
                           (const void*)verify_kernel<ED25519, int, int>};
  if (which < 0 || which > 2 || B <= 0) return (int)cudaErrorInvalidValue;
  int sms = 0;
  const int sigs = sigs_per_block(B, &sms);
  cudaError_t err = cudaFuncSetAttribute(kernels[which],
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem_bytes(MAX_SIGS));
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernels[which], 4 * sigs,
                                                      smem_bytes(sigs));
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr = {};
  err = cudaFuncGetAttributes(&attr, kernels[which]);
  out[0] = sigs;
  out[1] = (B + sigs - 1) / sigs;
  out[2] = 4 * sigs;
  out[3] = per_sm;
  out[4] = sms;
  out[5] = (int)attr.localSizeBytes;
  out[6] = attr.numRegs;
  return (int)err;
}
