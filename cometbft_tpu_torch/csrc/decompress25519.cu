// Ed25519 ZIP-215 and sr25519 pubkey decoding for Hopper (sm_90a), one key
// per thread.
//
// Replaces the XLA pubkey decoders cometbft_tpu/ops/ed25519_kernel.py
// _decompress_kernel (ZIP-215) and cometbft_tpu/ops/sr25519_kernel.py
// _decompress_kernel (ristretto255). Their output is the JAX package's
// radix-2^13 x 20 limbs, which the key cache holds and the verify kernels
// (verify25519.cu) take as A.
//
// What bounds it: 32-bit integer multiply-adds, ~275 field multiplications
// per key (the square root's pow22523), against 32 bytes in and 324 out.
// Each key's state stays in registers, one lane per thread with no
// cross-thread traffic; the field and curve code is curve25519.cuh, shared
// with microbench.cu, and every intermediate equals the plain version's.
// The decoders run once per validator-set change (a key-cache miss).

#include "curve25519.cuh"

enum Scheme { ED25519, SR25519 };

// The key's decoding: ZIP-215 decompression (ed25519) or ristretto255 DECODE
// (sr25519); y holds the encoding's low 255 bits, sign its bit 255.
template <int SCHEME>
__device__ __forceinline__ bool decode_point(pt& o, const fe& y, int sign) {
  if constexpr (SCHEME == SR25519) {
    return pt_ristretto_decode(o, y, sign);
  } else {
    return pt_decompress(o, y, sign);
  }
}

// Pubkey decoding: ok and the extended coordinates, one key per thread.
template <int SCHEME>
__global__ void __launch_bounds__(THREADS)
decompress_kernel(const int* __restrict__ words, int* __restrict__ ok,
                  int* __restrict__ ox, int* __restrict__ oy,
                  int* __restrict__ oz, int* __restrict__ ot, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  fe y;
  int sign;
  load_y(y, sign, words, b, B);
  pt p;
  bool good = decode_point<SCHEME>(p, y, sign);
  ok[b] = good ? 1 : 0;
  store_fe(ox, p.x, b, B);
  store_fe(oy, p.y, b, B);
  store_fe(oz, p.z, b, B);
  store_fe(ot, p.t, b, B);
}

// ------------------------------------------------------------ C interface
// Pointers are device pointers from torch tensors; stream is the caller's
// cudaStream_t. Each returns the launch's cudaError_t (0 on success).

template <int SCHEME>
static int launch_decompress(const void* words, void* ok, void* ox, void* oy, void* oz,
                             void* ot, int B, void* stream) {
  if (B <= 0) return 0;
  dim3 grid((B + THREADS - 1) / THREADS);
  decompress_kernel<SCHEME><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)words, (int*)ok, (int*)ox, (int*)oy, (int*)oz, (int*)ot, B);
  return (int)cudaGetLastError();
}

extern "C" int ed25519_decompress(const void* words, void* ok, void* ox, void* oy,
                                  void* oz, void* ot, int B, void* stream) {
  return launch_decompress<ED25519>(words, ok, ox, oy, oz, ot, B, stream);
}

extern "C" int sr25519_decompress(const void* words, void* ok, void* ox, void* oy,
                                  void* oz, void* ot, int B, void* stream) {
  return launch_decompress<SR25519>(words, ok, ox, oy, oz, ot, B, stream);
}
