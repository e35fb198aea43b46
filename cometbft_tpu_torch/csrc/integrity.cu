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
// The mask and all-ok are the verify kernel's raw int32 verdicts (non-zero
// is valid), read as it wrote them. With no mask the launch computes the
// checksum alone (header[0]), as _device_checksum does for the key-table
// and prefix-table uploads.
//
// What bounds it on this card: bytes, ~0.8 MB at 10,240 lanes on the
// device-challenge path (each staged word read once, the header and payload
// ~20 KB written), 0.25 us at 3.35 TB/s; the launch, the cross-block sum and
// its place on the stream behind the verify kernel cost more.
//
// What the design does about it:
//   - at most one block of 256 threads an SM, each walking its share of
//     every array with 16-byte loads (a scalar head up to 16-byte alignment
//     and a tail), so the cross-block sum is one atomicAdd a block (132 at
//     most); the weight of a word is stepped by one add, not recomputed;
//     addition mod 2^32 commutes, so the sum is the same in any order and
//     the result is deterministic;
//   - the payload written four bytes at a time from four mask words
//     (~m as m ^ 0x01010101);
//   - programmatic dependent launch behind the verify kernel: on the verify
//     path the wrapper launches with cudaLaunchAttributeProgrammatic-
//     StreamSerialization, so this grid starts while the verify kernel's
//     blocks exit. It checksums first: the staged arrays come from host-to-
//     device copies that precede the derive and verify kernels, so they are
//     complete when the verify kernel starts. Only then does it wait
//     (griddepcontrol.wait) for the verify kernel's grid to complete and its
//     writes to be visible, before it reads the mask and all-ok or touches
//     the scratch words. The checksum-only entry (the key-table uploads) is
//     launched in plain stream order, where the wait returns at once: its
//     arrays may be written by the kernel before it;
//   - the last block to finish (a counter taken after a __threadfence)
//     reads the sum, zeroes the two scratch words for the next launch on the
//     stream (a launch needs no memset of its own), and writes the header
//     and the checksum bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sm_count.cuh"

constexpr int THREADS = 256;
constexpr uint32_t OK_MAGIC = 0x600DFA57u;
constexpr uint32_t BAD_MAGIC = ~0x600DFA57u;
constexpr uint32_t CHK_MULT = 2654435761u;

struct Arrays {
  const uint32_t* a[3];
  long long n[3];
};

// Words [0, n) of array a, whose word 0 has the ravel index off, weighted
// and summed by thread tid of `stride`.
__device__ __forceinline__ uint32_t array_sum(const uint32_t* __restrict__ a, long long n,
                                              uint32_t off, long long tid, long long stride) {
  long long head = (long long)((0u - (uint32_t)((uintptr_t)a >> 2)) & 3u);
  if (head > n) head = n;
  const long long nv = (n - head) >> 2, tail = head + 4 * nv;
  uint32_t acc = 0;
  if (tid < head) acc += a[tid] * ((off + (uint32_t)tid) * CHK_MULT + 1u);
  if (tid < n - tail) acc += a[tail + tid] * ((off + (uint32_t)(tail + tid)) * CHK_MULT + 1u);
  const uint4* __restrict__ v = (const uint4*)(a + head);
  const uint32_t step = (uint32_t)(4 * stride) * CHK_MULT;
  uint32_t w = (off + (uint32_t)(head + 4 * tid)) * CHK_MULT + 1u;
  for (long long i = tid; i < nv; i += stride, w += step) {
    const uint4 x = __ldg(v + i);
    const uint32_t w1 = w + CHK_MULT, w2 = w1 + CHK_MULT, w3 = w2 + CHK_MULT;
    acc += x.x * w + x.y * w1 + x.z * w2 + x.w * w3;
  }
  return acc;
}

__global__ void __launch_bounds__(THREADS)
integrity_kernel(Arrays arrs, const int* __restrict__ mask, const int* __restrict__ allok, int B,
                 uint32_t expected, uint32_t* __restrict__ scratch, uint32_t* __restrict__ header,
                 uint8_t* __restrict__ payload) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  uint32_t acc = 0, off = 0;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    acc += array_sum(arrs.a[k], arrs.n[k], off, tid, stride);
    off += (uint32_t)arrs.n[k];
  }
  // the verify kernel's grid (the primary of a programmatic launch) is
  // complete and its writes visible past this point
  asm volatile("griddepcontrol.wait;" ::: "memory");
  if (mask != nullptr) {
    if ((B & 3) == 0 && ((uintptr_t)mask & 15) == 0) {
      for (long long i = tid; i < B / 4; i += stride) {
        const int4 m = ((const int4*)mask)[i];
        const uint32_t b = (uint32_t)(m.x != 0) | (uint32_t)(m.y != 0) << 8 |
                           (uint32_t)(m.z != 0) << 16 | (uint32_t)(m.w != 0) << 24;
        ((uint32_t*)payload)[i] = b;
        ((uint32_t*)(payload + B))[i] = b ^ 0x01010101u;
      }
    } else {
      for (long long i = tid; i < B; i += stride) {
        const uint8_t m = mask[i] != 0;
        payload[i] = m;
        payload[B + i] = m ^ 1;
      }
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

// Blocks for `words` staged words and `B` mask words: one a 1,024 words
// (a 16-byte load a thread), at most one an SM.
static int blocks_for(long long words, long long B, int sms) {
  if (B > words) words = B;
  long long blocks = (words + 4 * THREADS - 1) / (4 * THREADS);
  if (blocks > sms) blocks = sms;
  return blocks < 1 ? 1 : (int)blocks;
}

// Header (2,) and payload (2B+1,) from the arrays a0..a2 (n0..n2 uint32
// words each; a null array with n = 0 is absent), the verify kernel's
// int32 mask (B,) and all-ok (1,). With a null mask, the checksum alone
// into header[0]. scratch is two uint32, zero before the launch and zero
// again after it: one scratch serves every launch on one stream. With
// `overlap` the launch is a programmatic dependent launch behind the
// kernel before it on the stream, whose writes the arrays must not be.
extern "C" int integrity_parts(const void* a0, long long n0, const void* a1, long long n1,
                               const void* a2, long long n2, const void* mask,
                               const void* allok, int B, unsigned int expected, void* scratch,
                               void* header, void* payload, int overlap, void* stream) {
  Arrays arrs;
  arrs.a[0] = (const uint32_t*)a0;
  arrs.a[1] = (const uint32_t*)a1;
  arrs.a[2] = (const uint32_t*)a2;
  arrs.n[0] = a0 ? n0 : 0;
  arrs.n[1] = a1 ? n1 : 0;
  arrs.n[2] = a2 ? n2 : 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks_for(arrs.n[0] + arrs.n[1] + arrs.n[2], mask ? B : 0, sm_count()));
  cfg.blockDim = dim3(THREADS);
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = overlap ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, integrity_kernel, arrs, (const int*)mask, (const int*)allok, B, (uint32_t)expected,
      (uint32_t*)scratch, (uint32_t*)header, (uint8_t*)payload);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// The launch shape for `work` staged words and no mask: threads per block
// in out[0], blocks, threads, resident blocks per SM, SMs, local memory per
// thread, registers (as challenge_launch_shape). Returns a cudaError_t.
extern "C" int integrity_launch_shape(long long work, int* out) {
  if (work <= 0) return (int)cudaErrorInvalidValue;
  const int sms = sm_count();
  int per_sm = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, (const void*)integrity_kernel, THREADS, 0);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr = {};
  err = cudaFuncGetAttributes(&attr, (const void*)integrity_kernel);
  out[0] = THREADS;
  out[1] = blocks_for(work, 0, sms);
  out[2] = THREADS;
  out[3] = per_sm;
  out[4] = sms;
  out[5] = (int)attr.localSizeBytes;
  out[6] = attr.numRegs;
  return (int)err;
}
