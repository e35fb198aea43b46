// The integrity kernel K6 for Hopper (sm_90a): the staging checksum of up
// to three staged arrays, and from it and the verify kernel's verdicts the
// reduced-fetch header and the full payload, in one launch.
//
// Replaces the XLA programs cometbft_tpu/ops/ed25519_kernel.py:209
// _device_checksum_expr, :251 _integrity_parts_expr and :271
// _integrity_parts_arrs_expr:
//   checksum = sum over the arrays' uint32 words, in ravel order across the
//              arrays, of word * (idx * 2654435761 + 1), all mod 2^32;
//   ok       = checksum == expected (the host's checksum of what it sent);
//   tok      = checksum ^ (all-ok && ok ? OK_MAGIC : BAD_MAGIC);
//   header   = [tok, ~tok]                      (2,) uint32
//   payload  = [mask, ~mask, ok]                (2B + 1,) bool
// With no mask the launch computes the checksum alone (header[0]), as
// _device_checksum does for the key-table and prefix-table uploads.
//
// What bounds it: bytes. Each staged word is read once and multiplied once
// (~0.8 MB at 10,240 lanes on the device-challenge path); the header and
// payload are ~20 KB.
//
// What the design does about it: a grid-stride loop over the words, a
// warp-shuffle and shared-memory block reduction, and one uint32 atomicAdd a
// block (addition mod 2^32 commutes: the sum is the same in any order, so
// the result is deterministic). The grid is at most one wave. The last block
// to finish (a counter taken after a __threadfence) reads the sum, zeroes the
// two scratch words for the next launch on the stream (so a launch needs no
// memset of its own), and writes the header and the checksum bit; every
// thread writes its share of the mask and its complement on the way.

#include <cuda_runtime.h>
#include <stdint.h>

constexpr int THREADS = 256;
constexpr uint32_t OK_MAGIC = 0x600DFA57u;
constexpr uint32_t BAD_MAGIC = ~0x600DFA57u;
constexpr uint32_t CHK_MULT = 2654435761u;

struct Arrays {
  const uint32_t* a[3];
  long long n[3];
};

__global__ void __launch_bounds__(THREADS)
integrity_kernel(Arrays arrs, const uint8_t* __restrict__ mask, const uint8_t* __restrict__ allok,
                 int B, uint32_t expected, uint32_t* __restrict__ scratch,
                 uint32_t* __restrict__ header, uint8_t* __restrict__ payload) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  uint32_t acc = 0;
  long long off = 0;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const uint32_t* __restrict__ a = arrs.a[k];
    const long long n = arrs.n[k];
    for (long long i = tid; i < n; i += stride)
      acc += a[i] * ((uint32_t)(off + i) * CHK_MULT + 1u);
    off += n;
  }
  if (mask != nullptr) {
    for (long long i = tid; i < B; i += stride) {
      const uint8_t m = mask[i] != 0;
      payload[i] = m;
      payload[B + i] = !m;
    }
  }
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, s);
  __shared__ uint32_t warp_sums[THREADS / 32];
  __shared__ bool last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    uint32_t s = 0;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) s += warp_sums[w];
    atomicAdd(&scratch[0], s);
    __threadfence();
    last = atomicAdd(&scratch[1], 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last || threadIdx.x != 0) return;
  const uint32_t chk = atomicAdd(&scratch[0], 0u);  // every block's sum is in
  scratch[0] = 0u;  // every other block is done with the scratch
  scratch[1] = 0u;
  if (mask == nullptr) {
    header[0] = chk;
    return;
  }
  const bool ok = chk == expected;
  const uint32_t tok = chk ^ ((allok[0] != 0 && ok) ? OK_MAGIC : BAD_MAGIC);
  header[0] = tok;
  header[1] = ~tok;
  payload[2 * (long long)B] = ok;
}

// ------------------------------------------------------------ C interface
// Pointers are device pointers from torch tensors; stream is the caller's
// cudaStream_t. Each returns a cudaError_t (0 on success).

// Blocks for `work` elements: enough to cover them, at most one wave (the
// occupancy calculator's resident blocks per SM times the SMs). The SM count
// and the occupancy are asked once per device: the queries cost more host
// time than the kernel takes.
static int blocks_for(long long work, int* sms_out, int* per_sm_out) {
  constexpr int MAX_DEVICES = 64;
  static int sms_of[MAX_DEVICES], per_sm_of[MAX_DEVICES];
  int dev = 0;
  cudaGetDevice(&dev);
  int sms = 1, per_sm = 1;
  if (dev >= 0 && dev < MAX_DEVICES && sms_of[dev] > 0) {
    sms = sms_of[dev];
    per_sm = per_sm_of[dev];
  } else {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, (const void*)integrity_kernel,
                                                  THREADS, 0);
    if (sms <= 0) sms = 1;
    if (per_sm <= 0) per_sm = 1;
    if (dev >= 0 && dev < MAX_DEVICES) {
      per_sm_of[dev] = per_sm;
      sms_of[dev] = sms;
    }
  }
  long long blocks = (work + THREADS - 1) / THREADS;
  if (blocks > (long long)sms * per_sm) blocks = (long long)sms * per_sm;
  if (blocks < 1) blocks = 1;
  if (sms_out) *sms_out = sms;
  if (per_sm_out) *per_sm_out = per_sm;
  return (int)blocks;
}

// Header (2,) and payload (2B+1,) from the arrays a0..a2 (n0..n2 uint32
// words each; a null array with n = 0 is absent), the verify mask (B,)
// bool and all-ok (1,) bool. With a null mask, the checksum alone into
// header[0]. scratch is two uint32, zero before the launch and zero again
// after it: one scratch serves every launch on one stream.
extern "C" int integrity_parts(const void* a0, long long n0, const void* a1, long long n1,
                               const void* a2, long long n2, const void* mask,
                               const void* allok, int B, unsigned int expected, void* scratch,
                               void* header, void* payload, void* stream) {
  Arrays arrs;
  arrs.a[0] = (const uint32_t*)a0;
  arrs.a[1] = (const uint32_t*)a1;
  arrs.a[2] = (const uint32_t*)a2;
  arrs.n[0] = a0 ? n0 : 0;
  arrs.n[1] = a1 ? n1 : 0;
  arrs.n[2] = a2 ? n2 : 0;
  long long work = arrs.n[0] + arrs.n[1] + arrs.n[2];
  if (mask && B > work) work = B;
  const int blocks = blocks_for(work, nullptr, nullptr);
  integrity_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      arrs, (const uint8_t*)mask, (const uint8_t*)allok, B, (uint32_t)expected,
      (uint32_t*)scratch, (uint32_t*)header, (uint8_t*)payload);
  return (int)cudaGetLastError();
}

// The launch shape for `work` elements: threads per block in out[0],
// blocks, threads, resident blocks per SM, SMs, local memory per thread,
// registers (as challenge_launch_shape). Returns a cudaError_t.
extern "C" int integrity_launch_shape(long long work, int* out) {
  if (work <= 0) return (int)cudaErrorInvalidValue;
  int sms = 0, per_sm = 0;
  const int blocks = blocks_for(work, &sms, &per_sm);
  cudaFuncAttributes attr = {};
  cudaError_t err = cudaFuncGetAttributes(&attr, (const void*)integrity_kernel);
  out[0] = THREADS;
  out[1] = blocks;
  out[2] = THREADS;
  out[3] = per_sm;
  out[4] = sms;
  out[5] = (int)attr.localSizeBytes;
  out[6] = attr.numRegs;
  return (int)err;
}
