// Ed25519 ZIP-215 and sr25519 pubkey decoding for Hopper (sm_90a), 8 x
// 32-bit limbs, one key a thread.
//
// Replaces the XLA pubkey decoders cometbft_tpu/ops/ed25519_kernel.py
// _decompress_kernel (ZIP-215) and cometbft_tpu/ops/sr25519_kernel.py
// _decompress_kernel (ristretto255). The output keeps their format, X, Y,
// Z, T as (20, B) radix-2^13 int32 limbs, which the key cache holds and the
// verify kernels (verify25519.cu) take as A; here the limbs are canonical
// (fe32.cuh to_limbs13), the plain version's are carried: the two agree as
// field values, and ok bit for bit.
//
// What bounds it: 32-bit integer multiply-adds, ~275 field products per key
// (pow22523's 250 squarings), against 32 bytes in and 324 out. A key is one
// dependent chain, so the card is latency-bound: at 10,240 keys a one-wave
// grid gives each scheduler under one warp.
//
// What the design does about it:
//   - the field is fe32.cuh (radix-2^13 limbs cost ~2.8x the IMADs), every
//     function inlined, nothing in local memory;
//   - the grid is one wave: keys per block = ceil(B / SMs), rounded up to
//     whole warps, at most MAX_THREADS a block.
// decode_key<SCHEME> (decode25519.cuh) is the per-key body.

#include <cuda_runtime.h>

#include "decode25519.cuh"

using namespace f32;

constexpr int MAX_THREADS = 256;

template <int SCHEME>
__global__ void __launch_bounds__(MAX_THREADS)
decompress_kernel(const int* __restrict__ words, int* __restrict__ ok,
                  int* __restrict__ ox, int* __restrict__ oy,
                  int* __restrict__ oz, int* __restrict__ ot, int B) {
  const int key = (int)(blockIdx.x * blockDim.x + threadIdx.x);
  if (key < B) decode_key<SCHEME>(words, ok, ox, oy, oz, ot, key, B);
}

// ------------------------------------------------------------ C interface
// Pointers are device pointers from torch tensors; stream is the caller's
// cudaStream_t. Each returns a cudaError_t (0 on success).

// Keys (threads) per block for a batch of B on the current device: one wave
// over the SMs, whole warps, at most MAX_THREADS.
static int keys_per_block(int B, int* sms_out) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (sms <= 0) sms = 1;
  int n = (B + sms - 1) / sms;
  n = (n + 31) / 32 * 32;
  if (n > MAX_THREADS) n = MAX_THREADS;
  if (sms_out) *sms_out = sms;
  return n;
}

static const void* kernel_of(int scheme) {
  if (scheme == 0) return (const void*)decompress_kernel<ED25519>;
  if (scheme == 1) return (const void*)decompress_kernel<SR25519>;
  return nullptr;
}

// Decode B keys of `scheme` (0 ed25519, 1 sr25519).
static int launch_decompress(int scheme, const void* words, void* ok, void* ox, void* oy,
                             void* oz, void* ot, int B, void* stream) {
  if (B <= 0) return 0;
  const int keys = keys_per_block(B, nullptr);
  const int* w = (const int*)words;
  int *o = (int*)ok, *x = (int*)ox, *y = (int*)oy, *z = (int*)oz, *t = (int*)ot;
  void* args[] = {&w, &o, &x, &y, &z, &t, &B};
  return (int)cudaLaunchKernel(kernel_of(scheme), dim3((B + keys - 1) / keys), dim3(keys),
                               args, 0, (cudaStream_t)stream);
}

extern "C" int ed25519_decompress(const void* words, void* ok, void* ox, void* oy,
                                  void* oz, void* ot, int B, void* stream) {
  return launch_decompress(0, words, ok, ox, oy, oz, ot, B, stream);
}

extern "C" int sr25519_decompress(const void* words, void* ok, void* ox, void* oy,
                                  void* oz, void* ot, int B, void* stream) {
  return launch_decompress(1, words, ok, ox, oy, oz, ot, B, stream);
}

// The launch shape of a batch of B for `scheme`: keys per block, blocks,
// threads per block, resident blocks per SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), the SM count, and the
// loaded kernel's local memory per thread and registers
// (cudaFuncGetAttributes), into out[0..6]. Returns a cudaError_t.
extern "C" int decompress_launch_shape(int scheme, int B, int* out) {
  const void* kernel = kernel_of(scheme);
  if (kernel == nullptr || B <= 0) return (int)cudaErrorInvalidValue;
  int sms = 0;
  const int keys = keys_per_block(B, &sms);
  int per_sm = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, keys, 0);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr = {};
  err = cudaFuncGetAttributes(&attr, kernel);
  out[0] = keys;
  out[1] = (B + keys - 1) / keys;
  out[2] = keys;
  out[3] = per_sm;
  out[4] = sms;
  out[5] = (int)attr.localSizeBytes;
  out[6] = attr.numRegs;
  return (int)err;
}
