// The five BLS12-381 kernels for Hopper (sm_90a), over fp381.cuh (Fp in 12 x
// 32-bit Montgomery limbs), tower381.cuh (Fp2/Fp6/Fp12) and curve381.cuh (G1,
// G2, hash-to-G2, the pairing and the per-lane bodies):
//
//   B1 bls_decompress_kernel<G>  x -> y = sqrt(x^3 + b) with the sign rule,
//      ok = the root exists (and with check_sub, [r]P == O); affine out.
//      Replaces cometbft_tpu/ops/bls_kernel.py:180 _jit_decompress, :191
//      _jit_subgroup_g1, :198 _jit_subgroup_g2 (points.py:172, 233, 248).
//   B2 bls_hash_to_g2_kernel     the raw hash_to_field planes -> SvdW map
//      twice, add, cofactor clearing ([h2], h2 = #E'(Fp2) / r, the
//      oracle's) -> affine H(m). Replaces :205 _jit_hash_msgs (htc.py:70,
//      102, points.to_affine).
//   B3 bls_point_sum_kernel<G>   a segmented sum: group g sums the affine
//      points of lanes order[starts[g]..starts[g+1]), to affine, with the
//      identity flag and (check_sub) the subgroup check of the sum. Replaces
//      points.sum_tree in _aggregate_device (bls_kernel.py:546-571), which
//      runs one masked full-width tree a group.
//   B4 bls_miller_kernel         f_{|x|,Q}(P) conjugated, one pair a lane.
//      Replaces :221 _jit_miller (pairing.py:38).
//   B5 bls_final_exp_kernel      a segmented product of Miller values, the
//      final exponentiation, == 1, gated and forced per check, and the
//      all-ok word. Replaces :229 _jit_pair_halves, pairing.py:105
//      product_lanes, :140-188 final_exp_composed and :239 _jit_eq_one.
//
// Inputs are the staged radix-2^11 planes (35 int32 limbs a value, as the
// reference stages them and K6 checksums them), converted on load; every
// other array is (rows, lanes) planes of 32-bit Montgomery words, one lane
// a column, so a warp's loads of one row are coalesced.
//
// What bounds them on this card: operations. A 12 x 32-bit Montgomery
// product is about 590 IMADs, and a lane of the single-verify path needs
// ~10^5 of them (the two subgroup ladders, the cofactor ladder of H(m), two
// Miller loops and a final exponentiation), so the IMAD peak sets the bound
// and the bytes moved are negligible.
//
// What the design does about it. B1, B3 and B4: one lane a thread, in
// blocks of 32 lanes so that small batches spread over the SMs; the tower
// and point operations are out-of-line functions (their operands in the
// thread's stack frame), the Fp product inlined into them; the fixed
// exponents and scalars are public, so the ladders branch on their bits
// uniformly across a warp. B3 gives each group a block of 128 threads, each
// summing a stride of the group's lanes, then a tree in shared memory.
//
// B2 and B5 run one lane's serial chain of products, whatever the width of
// the call (one message or one check is a whole aggregate check), so they
// cut the chain rather than the total: fewer products (B2: roots by the
// norm, binary Legendre symbols and inverses, the cofactor by psi; B5:
// Granger-Scott cyclotomic squares) and a few threads a lane
// (group381.cuh). B2: one message a trio (ten a warp), its two SvdW maps on
// two threads at once, then every Fp2 product split three ways. B5: T
// sextets a check (five a warp; T = 5 where a check has more than two
// Miller values), each multiplying a stride of the check's values, then a
// tree across the T; the check's first sextet then runs the final
// exponentiation with each Fp12 product split six ways (three Fp2 products
// a thread) and each cyclotomic square six ways (one). Calls wider than
// the card's sub-partitions hold in such warps (B2's 10,240 messages, B5's
// 10,240 checks of two) take one lane a thread instead (lane_kernel).

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "curve381.cuh"
#include "sm_count.cuh"

using namespace bls;

constexpr int THREADS = 32;
constexpr int SUM_THREADS = 128;
constexpr int TRIOS = 10;         // B2's trios a warp (lanes 0-29)
constexpr int SEXTETS = 5;        // B5's sextets a warp (lanes 0-29)
constexpr int H2G_SLOT = 2 * nwords<fp2>;  // B2's exchange: an affine point, or an Fp product
constexpr int FE_SLOT = nwords<fp6>;        // B5's exchange: three Fp2 or an Fp6 product
constexpr int F12_WORDS = nwords<fp12>;

template <int G>
__global__ void bls_decompress_kernel(const int32_t* x_raw, const int32_t* sign, int check_sub,
                                      int B, uint32_t* out, int32_t* ok) {
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j < B) lane_decompress<G>(x_raw, sign, check_sub, B, j, out, ok);
}

// one warp a block: message blockIdx.x * TRIOS + lane / 3 on trio lane / 3
__global__ void bls_hash_to_g2_kernel(const int32_t* u, int B, uint32_t* out, int32_t* is_id) {
  __shared__ uint32_t xbuf[TRIOS * 6 * H2G_SLOT];
  const int lane = threadIdx.x;
  if (lane >= 3 * TRIOS) return;
  const int k = lane / 3;
  const long long j = (long long)blockIdx.x * TRIOS + k;
  if (j >= B) return;  // a trio leaves whole: no other lane syncs with it
  trio g{lane % 3, 7u << (3 * k), xbuf + k * 6 * H2G_SLOT, H2G_SLOT, 0};
  group_hash_to_g2(u, B, j, out, is_id, g);
}

// one message a thread, for the widest calls
__global__ void bls_hash_to_g2_lane_kernel(const int32_t* u, int B, uint32_t* out,
                                           int32_t* is_id) {
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j < B) lane_hash_to_g2(u, B, j, out, is_id);
}

template <int G>
__global__ void bls_point_sum_kernel(const uint32_t* pts, long long N, const int32_t* order,
                                     const int32_t* starts, int n_groups, int check_sub,
                                     uint32_t* out, int32_t* is_id, int32_t* sub_ok) {
  using T = typename std::conditional<G == 1, fp, fp2>::type;
  __shared__ proj<T> part[SUM_THREADS];
  const int g = blockIdx.x;
  proj<T> acc;
  lane_partial_sum(acc, pts, N, order, starts[g] + (int)threadIdx.x, starts[g + 1],
                   SUM_THREADS);
  part[threadIdx.x] = acc;
  __syncthreads();
  for (int s = SUM_THREADS / 2; s > 0; s >>= 1) {
    if ((int)threadIdx.x < s) pt_add(part[threadIdx.x], part[threadIdx.x], part[threadIdx.x + s]);
    __syncthreads();
  }
  if (threadIdx.x == 0) lane_sum_out(part[0], check_sub, n_groups, g, out, is_id, sub_ok);
}

__global__ void bls_miller_kernel(const uint32_t* p, const uint32_t* q, int L, uint32_t* f) {
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j < L) lane_miller(p, q, L, j, f);
}

// one warp a block: SEXTETS / T checks, sextet r of check q at sextets
// q T + r
__global__ void bls_final_exp_kernel(const uint32_t* f, int L, const int32_t* lanes,
                                     const int32_t* starts, int C, const int32_t* gate_a,
                                     const int32_t* gate_b, const int32_t* force,
                                     uint32_t* e_out, int32_t* ok, int32_t* allok, int T) {
  __shared__ uint32_t xbuf[SEXTETS * 12 * FE_SLOT];
  __shared__ uint32_t part[SEXTETS * F12_WORDS];
  const int lane = threadIdx.x;
  if (lane >= 6 * SEXTETS) return;
  const int k = lane / 6, q = k / T, r = k % T;
  const long long c = (long long)blockIdx.x * (SEXTETS / T) + q;
  if (c >= C) return;  // a check's sextets leave together
  sextet g{lane % 6, 0x3Fu << (6 * k), xbuf + k * 12 * FE_SLOT, FE_SLOT, 0};
  lanes_group grp{((1u << (6 * T)) - 1u) << (6 * q * T)};
  if (group_final_exp(f, L, lanes, starts, C, c, r, T, g, grp, part + q * T * F12_WORDS, gate_a,
                      gate_b, force, e_out, ok) == 0)
    atomicAnd(allok, 0);
}

// one check a thread, for the widest calls of checks of two values
__global__ void bls_final_exp_lane_kernel(const uint32_t* f, int L, const int32_t* lanes,
                                          const int32_t* starts, int C, const int32_t* gate_a,
                                          const int32_t* gate_b, const int32_t* force,
                                          uint32_t* e_out, int32_t* ok, int32_t* allok) {
  const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  if (!lane_final_exp(f, L, lanes, starts, C, c, gate_a, gate_b, force, e_out, ok))
    atomicAnd(allok, 0);
}

// ------------------------------------------------------------ C interface
// Pointers are device pointers from torch tensors; stream is the caller's
// cudaStream_t. Each returns a cudaError_t (0 on success).

static int launched(cudaError_t err) {
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

static int blocks(long long n, int threads) { return (int)((n + threads - 1) / threads); }

// B2 and B5 run a group a lane while its warps are one an SM sub-partition
// at most (`per_warp` lanes a warp); wider, one thread a lane (a group's
// exchanges and the additions every thread repeats then cost more than its
// shorter chain saves)
static bool lane_kernel(long long units, int per_warp) {
  return blocks(units, per_warp) > 4 * sm_count();
}

// B5's sextets a check for `values` Miller values a check (rounded up): one
// for pairs, else the warp's five
static int sextets_per_check(long long values) { return values <= 2 ? 1 : SEXTETS; }

// The constant table (fp381.cuh K_*) into the current device's c_k.
extern "C" int bls_set_constants(const uint32_t* host, int n) {
  if (n != NK) return (int)cudaErrorInvalidValue;
  return (int)cudaMemcpyToSymbol(c_k, host, sizeof(uint32_t) * NK);
}

// B1. g = 1: x_raw (35, B); g = 2: (2, 35, B) c0 then c1. out (24 g, B).
extern "C" int bls_decompress(int g, const void* x_raw, const void* sign, int check_sub, int B,
                              void* out, void* ok, void* stream) {
  const dim3 grid(blocks(B, THREADS)), block(THREADS);
  cudaStream_t s = (cudaStream_t)stream;
  if (g == 1)
    bls_decompress_kernel<1><<<grid, block, 0, s>>>((const int32_t*)x_raw, (const int32_t*)sign,
                                                    check_sub, B, (uint32_t*)out, (int32_t*)ok);
  else
    bls_decompress_kernel<2><<<grid, block, 0, s>>>((const int32_t*)x_raw, (const int32_t*)sign,
                                                    check_sub, B, (uint32_t*)out, (int32_t*)ok);
  return launched(cudaSuccess);
}

// B2. u (4, 35, B) raw; out (48, B) affine x, y; is_id (B,).
extern "C" int bls_hash_to_g2(const void* u, int B, void* out, void* is_id, void* stream) {
  if (lane_kernel(B, TRIOS))
    bls_hash_to_g2_lane_kernel<<<blocks(B, THREADS), THREADS, 0, (cudaStream_t)stream>>>(
        (const int32_t*)u, B, (uint32_t*)out, (int32_t*)is_id);
  else
    bls_hash_to_g2_kernel<<<blocks(B, TRIOS), THREADS, 0, (cudaStream_t)stream>>>(
        (const int32_t*)u, B, (uint32_t*)out, (int32_t*)is_id);
  return launched(cudaSuccess);
}

// B3. pts (24 g, N) affine; order (M,) lane indices grouped; starts (G + 1,);
// out (24 g, G) affine sums; is_id, sub_ok (G,).
extern "C" int bls_point_sum(int g, const void* pts, long long N, const void* order,
                             const void* starts, int n_groups, int check_sub, void* out,
                             void* is_id, void* sub_ok, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (g == 1)
    bls_point_sum_kernel<1><<<n_groups, SUM_THREADS, 0, s>>>(
        (const uint32_t*)pts, N, (const int32_t*)order, (const int32_t*)starts, n_groups,
        check_sub, (uint32_t*)out, (int32_t*)is_id, (int32_t*)sub_ok);
  else
    bls_point_sum_kernel<2><<<n_groups, SUM_THREADS, 0, s>>>(
        (const uint32_t*)pts, N, (const int32_t*)order, (const int32_t*)starts, n_groups,
        check_sub, (uint32_t*)out, (int32_t*)is_id, (int32_t*)sub_ok);
  return launched(cudaSuccess);
}

// B4. p (24, L) affine G1; q (48, L) affine twist; f (144, L).
extern "C" int bls_miller(const void* p, const void* q, int L, void* f, void* stream) {
  bls_miller_kernel<<<blocks(L, THREADS), THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)p, (const uint32_t*)q, L, (uint32_t*)f);
  return launched(cudaSuccess);
}

// B5. f (144, L); lanes (M,), starts (C + 1,); gates and force (C,) or null;
// e_out (144, C); ok (C,); allok (1,), 1 before the launch. The sextets a
// check follow L / C, the Miller values a check on average.
extern "C" int bls_final_exp(const void* f, int L, const void* lanes, const void* starts, int C,
                             const void* gate_a, const void* gate_b, const void* force,
                             void* e_out, void* ok, void* allok, void* stream) {
  const int T = sextets_per_check(((long long)L + C - 1) / C);
  if (T == 1 && lane_kernel(C, SEXTETS))
    bls_final_exp_lane_kernel<<<blocks(C, THREADS), THREADS, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)f, L, (const int32_t*)lanes, (const int32_t*)starts, C,
        (const int32_t*)gate_a, (const int32_t*)gate_b, (const int32_t*)force,
        (uint32_t*)e_out, (int32_t*)ok, (int32_t*)allok);
  else
    bls_final_exp_kernel<<<blocks(C, SEXTETS / T), THREADS, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)f, L, (const int32_t*)lanes, (const int32_t*)starts, C,
        (const int32_t*)gate_a, (const int32_t*)gate_b, (const int32_t*)force,
        (uint32_t*)e_out, (int32_t*)ok, (int32_t*)allok, T);
  return launched(cudaSuccess);
}

// The launch shape of entry e (0 decompress<1>, 1 decompress<2>, 2
// hash_to_g2, 3 point_sum<1>, 4 point_sum<2>, 5 miller, 6 final_exp) at `n`
// lanes (groups for B3, checks for B5, with `values` Miller values in all),
// as the entry launches it: threads per block, blocks, resident blocks per
// SM, SMs, local memory per thread, registers, static shared memory, B5's
// sextets a check (0 where none), and 1 where B2 or B5 take their one-lane
// kernel. Returns a cudaError_t.
extern "C" int bls_launch_shape(int e, int n, int values, int* out) {
  if (e < 0 || e > 6 || n <= 0) return (int)cudaErrorInvalidValue;
  const int T = e == 6 ? sextets_per_check(((long long)values + n - 1) / n) : 0;
  const bool lane =
      (e == 2 && lane_kernel(n, TRIOS)) || (e == 6 && T == 1 && lane_kernel(n, SEXTETS));
  const void* fns[7] = {(const void*)bls_decompress_kernel<1>,
                        (const void*)bls_decompress_kernel<2>,
                        lane ? (const void*)bls_hash_to_g2_lane_kernel
                             : (const void*)bls_hash_to_g2_kernel,
                        (const void*)bls_point_sum_kernel<1>,
                        (const void*)bls_point_sum_kernel<2>,
                        (const void*)bls_miller_kernel,
                        lane ? (const void*)bls_final_exp_lane_kernel
                             : (const void*)bls_final_exp_kernel};
  const int threads = (e == 3 || e == 4) ? SUM_THREADS : THREADS;
  int per_sm = 0, dev = 0, sms = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fns[e], threads, 0);
  if (err != cudaSuccess) return (int)err;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaFuncAttributes attr = {};
  err = cudaFuncGetAttributes(&attr, fns[e]);
  out[0] = threads;
  out[1] = (e == 3 || e == 4) ? n
           : lane            ? blocks(n, threads)
           : e == 2          ? blocks(n, TRIOS)
           : e == 6          ? blocks(n, SEXTETS / T)
                             : blocks(n, threads);
  out[2] = per_sm;
  out[3] = sms;
  out[4] = (int)attr.localSizeBytes;
  out[5] = attr.numRegs;
  out[6] = (int)attr.sharedSizeBytes;
  out[7] = lane ? 0 : T;
  out[8] = lane;
  return (int)err;
}
