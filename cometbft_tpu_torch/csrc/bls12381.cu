// The five BLS12-381 kernels for Hopper (sm_90a), over fp381.cuh (Fp in 12 x
// 32-bit Montgomery limbs), tower381.cuh (Fp2/Fp6/Fp12), group381.cuh (thread
// groups and batches of products) and curve381.cuh (G1, G2, hash-to-G2, the
// pairing and the per-lane and per-group bodies):
//
//   B1 bls_decompress_kernel<G>  x -> y = sqrt(x^3 + b) with the sign rule,
//      ok = the root exists (and with check_sub, P in G1: [r]P == O; in G2:
//      psi(P) == [x]P); affine out. Replaces cometbft_tpu/ops/bls_kernel.py:180
//      _jit_decompress, :191 _jit_subgroup_g1, :198 _jit_subgroup_g2
//      (points.py:172, 233, 248).
//   B2 bls_hash_to_g2_kernel     the raw hash_to_field planes -> SvdW map
//      twice, add, cofactor clearing ([h2], h2 = #E'(Fp2) / r, the
//      oracle's) -> affine H(m). Replaces :205 _jit_hash_msgs (htc.py:70,
//      102, points.to_affine).
//   B3 bls_point_sum_kernel<G>   a segmented sum: group g sums the affine
//      points of lanes order[starts[g]..starts[g+1]), to affine, with the
//      identity flag and (check_sub) the subgroup check of the sum (G2: the
//      psi test). Replaces points.sum_tree in _aggregate_device
//      (bls_kernel.py:546-571), which runs one masked full-width tree a group.
//   B4 bls_miller_group_kernel<N> / bls_miller_kernel  f_{|x|,Q}(P)
//      conjugated, one pair a lane. Replaces :221 _jit_miller (pairing.py:38).
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
// ~10^4 of them (the subgroup tests, the cofactor ladder of H(m), two
// Miller loops and a final exponentiation), so the IMAD peak sets the bound
// and the bytes moved are negligible.
//
// What the design does about it. Every kernel runs one lane's serial chain
// of products, and most calls are far narrower than the card (an aggregate
// check is one message, one sum and two Miller loops), so the kernels cut
// the chain rather than the total: fewer products (roots by the norm,
// binary Legendre symbols and inverses, cofactor clearing and the G2
// subgroup test by psi, cyclotomic squares, the Miller step's dedicated
// square and sparse line product) and a few threads a lane
// (group381.cuh). B1 G2 with the subgroup check: one lane a trio (ten a
// warp), each thread decompressing, then the psi test's Fp2 products split
// three ways. B2: one message a trio, its two SvdW maps on two threads at
// once, then every Fp2 product split three ways. B4: one pair a half-warp
// (two a warp) or, on wider calls, a sextet (five a warp), each Miller
// step's products on three batches split sixteen or six ways. B5: T
// sextets a check (T = 5 where a check has more than two Miller
// values), each multiplying a stride of the check's values, then a tree
// across the T; the check's first sextet then runs the final
// exponentiation with each Fp12 product split six ways (three Fp2 products
// a thread) and each cyclotomic square six ways (one). Calls wider than
// the card holds in such warps (B1 G2's and B2's 10,240 lanes, B4's 20,480
// pairs, B5's 10,240 checks of two) take one lane a thread instead
// (lane_kernel), as do B1 G1, B1 without the check and B3, in blocks of 32
// lanes so that small batches spread over the SMs. B3 gives each group a
// block of 128 threads, each summing a stride of the group's lanes, then a
// tree in shared memory. The tower and point operations are out-of-line
// functions (their operands in the thread's stack frame), the Fp product
// inlined into them; the fixed exponents and scalars are public, so the
// ladders branch on their bits uniformly across a warp.

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
// A group thread's exchange slot, in words, made odd: the warp's groups
// and a group's threads then start their slots in different shared-memory
// banks, and the same word of every slot is read without bank conflicts.
constexpr int odd_slot(int words) { return words | 1; }
constexpr int H2G_SLOT = odd_slot(2 * nwords<fp2>);  // B2: an affine point, or an Fp product
constexpr int FE_SLOT = odd_slot(nwords<fp6>);        // B5: three Fp2 or an Fp6 product
constexpr int F12_WORDS = nwords<fp12>;
constexpr int DEC_SLOT = odd_slot(nwords<fp>);        // B1 G2: an Fp product
// B4's groups: a half-warp (16 threads) or a sextet a pair
constexpr int HALF = 16;
constexpr int SEXTET = 6;
template <int NN>
constexpr int ML_SLOT = odd_slot(batch<lanes_of<NN>, MILLER_JOBS>::SLOT);  // B4: a batch's share

template <int G>
__global__ void bls_decompress_kernel(const int32_t* x_raw, const int32_t* sign, int check_sub,
                                      int B, uint32_t* out, int32_t* ok) {
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j < B) lane_decompress<G>(x_raw, sign, check_sub, B, j, out, ok);
}

// B1 G2, one warp a block: lane blockIdx.x * TRIOS + lane / 3 on trio lane / 3
__global__ void bls_decompress_g2_trio_kernel(const int32_t* x_raw, const int32_t* sign,
                                              int check_sub, int B, uint32_t* out, int32_t* ok) {
  __shared__ uint32_t xbuf[TRIOS * 6 * DEC_SLOT];
  const int lane = threadIdx.x;
  if (lane >= 3 * TRIOS) return;
  const int k = lane / 3;
  const long long j = (long long)blockIdx.x * TRIOS + k;
  if (j >= B) return;  // a trio leaves whole
  trio g{lane % 3, 7u << (3 * k), xbuf + k * 6 * DEC_SLOT, DEC_SLOT, 0};
  group_decompress<2>(x_raw, sign, check_sub, B, j, out, ok, g);
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

// B4 one pair a thread, for the widest calls
__global__ void bls_miller_kernel(const uint32_t* p, const uint32_t* q, int L, uint32_t* f) {
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j < L) lane_miller(p, q, L, j, f);
}

// B4, one warp a block: pair blockIdx.x * (32 / NN) + lane / NN on group
// lane / NN of NN threads (a half-warp or a sextet)
template <int NN>
__global__ void bls_miller_group_kernel(const uint32_t* p, const uint32_t* q, int L,
                                        uint32_t* f) {
  constexpr int PER_WARP = 32 / NN, SLOT = ML_SLOT<NN>;
  __shared__ uint32_t xbuf[PER_WARP * 2 * NN * SLOT];
  const int lane = threadIdx.x;
  if (lane >= NN * PER_WARP) return;
  const int k = lane / NN;
  const long long j = (long long)blockIdx.x * PER_WARP + k;
  if (j >= L) return;  // a group leaves whole
  lanes_of<NN> g{lane % NN, ((1u << NN) - 1u) << (NN * k), xbuf + k * 2 * NN * SLOT, SLOT, 0};
  group_miller(p, q, L, j, f, g);
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

// The group kernels (B1 G2, B2, B4, B5) run while their warps are at most
// `per_sm` an SM (`per_warp` lanes a warp); wider, one thread a lane (a
// group's exchanges and the additions every thread repeats then cost more
// than its shorter chain saves). Measured on the card on both sides
// (PERF.md): B2's and B5's group warps pay up to one an SM sub-partition,
// B1 G2's trios likewise; B4's half-warps (two pairs a warp) up to three
// quarters of one an SM, then its sextets (five, 12 KB of stack a thread)
// up to about one and a half.
constexpr double B1_GROUP_WARPS = 4;    // B1 G2 trios: to 5,280 lanes on 132 SMs
constexpr double B2_GROUP_WARPS = 4;    // B2 trios: to 5,280 messages
constexpr double B4_HALF_WARPS = 0.75;  // B4 half-warps: to 198 pairs
constexpr double B4_GROUP_WARPS = 1.5;  // B4 sextets: to 990 pairs
constexpr double B5_GROUP_WARPS = 4;    // B5 sextets: to 2,640 checks of two
static bool lane_kernel(long long units, int per_warp, double per_sm) {
  return blocks(units, per_warp) > per_sm * sm_count();
}

// kernel choice of an entry: 0 the crossover's, 1 the group kernel, 2 one
// lane a thread
static bool use_lane(int kernel, long long units, int per_warp, double per_sm) {
  return kernel == 2 || (kernel == 0 && lane_kernel(units, per_warp, per_sm));
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
// kernel: 0 the crossover's, 1 the trio kernel (G2), 2 one lane a thread.
// G1 and calls without the subgroup check run one lane a thread. *lane: 1
// where one lane a thread ran.
extern "C" int bls_decompress(int g, const void* x_raw, const void* sign, int check_sub, int B,
                              void* out, void* ok, void* stream, int kernel, int* lane) {
  cudaStream_t s = (cudaStream_t)stream;
  const bool trio = g == 2 && (kernel == 1 || (check_sub && !use_lane(kernel, B, TRIOS,
                                                                      B1_GROUP_WARPS)));
  *lane = !trio;
  if (g == 1)
    bls_decompress_kernel<1><<<blocks(B, THREADS), THREADS, 0, s>>>(
        (const int32_t*)x_raw, (const int32_t*)sign, check_sub, B, (uint32_t*)out, (int32_t*)ok);
  else if (trio)
    bls_decompress_g2_trio_kernel<<<blocks(B, TRIOS), THREADS, 0, s>>>(
        (const int32_t*)x_raw, (const int32_t*)sign, check_sub, B, (uint32_t*)out, (int32_t*)ok);
  else
    bls_decompress_kernel<2><<<blocks(B, THREADS), THREADS, 0, s>>>(
        (const int32_t*)x_raw, (const int32_t*)sign, check_sub, B, (uint32_t*)out, (int32_t*)ok);
  return launched(cudaSuccess);
}

// B2. u (4, 35, B) raw; out (48, B) affine x, y; is_id (B,).
extern "C" int bls_hash_to_g2(const void* u, int B, void* out, void* is_id, void* stream) {
  if (lane_kernel(B, TRIOS, B2_GROUP_WARPS))
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

// B4's kernel for L pairs: 2 one pair a thread, 1 a sextet, 3 a half-warp
// a pair; `kernel` 0 the crossovers' choice, else that one
static int miller_kernel(int kernel, long long L) {
  if (kernel) return kernel;
  if (lane_kernel(L, 32 / SEXTET, B4_GROUP_WARPS)) return 2;
  return lane_kernel(L, 32 / HALF, B4_HALF_WARPS) ? 1 : 3;
}

// B4. p (24, L) affine G1; q (48, L) affine twist; f (144, L). kernel: 0
// the crossovers', 1 the sextet kernel, 2 one pair a thread, 3 the
// half-warp kernel. *used: the kernel that ran, as `kernel` names them.
extern "C" int bls_miller(const void* p, const void* q, int L, void* f, void* stream, int kernel,
                          int* used) {
  cudaStream_t s = (cudaStream_t)stream;
  const uint32_t *pp = (const uint32_t*)p, *qq = (const uint32_t*)q;
  *used = miller_kernel(kernel, L);
  if (*used == 2)
    bls_miller_kernel<<<blocks(L, THREADS), THREADS, 0, s>>>(pp, qq, L, (uint32_t*)f);
  else if (*used == 1)
    bls_miller_group_kernel<SEXTET><<<blocks(L, 32 / SEXTET), THREADS, 0, s>>>(pp, qq, L,
                                                                              (uint32_t*)f);
  else
    bls_miller_group_kernel<HALF><<<blocks(L, 32 / HALF), THREADS, 0, s>>>(pp, qq, L,
                                                                          (uint32_t*)f);
  return launched(cudaSuccess);
}

// B5. f (144, L); lanes (M,), starts (C + 1,); gates and force (C,) or null;
// e_out (144, C); ok (C,); allok (1,), 1 before the launch. The sextets a
// check follow L / C, the Miller values a check on average.
extern "C" int bls_final_exp(const void* f, int L, const void* lanes, const void* starts, int C,
                             const void* gate_a, const void* gate_b, const void* force,
                             void* e_out, void* ok, void* allok, void* stream) {
  const int T = sextets_per_check(((long long)L + C - 1) / C);
  if (T == 1 && lane_kernel(C, SEXTETS, B5_GROUP_WARPS))
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
// lanes (groups for B3, checks for B5, with `values` Miller values in all;
// for B1 `values` is check_sub), with `kernel` as the entry takes it (B1,
// B4; 0 elsewhere), as the entry launches it: threads per block, blocks,
// resident blocks per SM, SMs, local memory per thread, registers, static
// shared memory, B5's sextets a check (0 where none), 1 where the entry
// takes its one-lane kernel though it has a group kernel, and the threads
// a lane (1, 3 or 6). Returns a cudaError_t.
extern "C" int bls_launch_shape(int e, int n, int values, int kernel, int* out) {
  if (e < 0 || e > 6 || n <= 0 || kernel < 0 || kernel > (e == 5 ? 3 : 2))
    return (int)cudaErrorInvalidValue;
  const int mk = e == 5 ? miller_kernel(kernel, n) : 0;
  const int T = e == 6 ? sextets_per_check(((long long)values + n - 1) / n) : 0;
  const bool trio = e == 1 && (kernel == 1 || (values && !use_lane(kernel, n, TRIOS,
                                                                   B1_GROUP_WARPS)));
  const bool lane = (e == 1 && !trio) || (e == 2 && lane_kernel(n, TRIOS, B2_GROUP_WARPS)) ||
                    (e == 5 && mk == 2) ||
                    (e == 6 && T == 1 && lane_kernel(n, SEXTETS, B5_GROUP_WARPS));
  const void* fns[7] = {(const void*)bls_decompress_kernel<1>,
                        trio ? (const void*)bls_decompress_g2_trio_kernel
                             : (const void*)bls_decompress_kernel<2>,
                        lane ? (const void*)bls_hash_to_g2_lane_kernel
                             : (const void*)bls_hash_to_g2_kernel,
                        (const void*)bls_point_sum_kernel<1>,
                        (const void*)bls_point_sum_kernel<2>,
                        mk == 2   ? (const void*)bls_miller_kernel
                        : mk == 1 ? (const void*)bls_miller_group_kernel<SEXTET>
                                  : (const void*)bls_miller_group_kernel<HALF>,
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
  const int group = trio || (e == 2 && !lane) ? 3
                    : e == 5 && !lane ? (mk == 1 ? SEXTET : HALF)
                    : e == 6 && !lane ? 6
                                      : 1;
  out[0] = threads;
  out[1] = (e == 3 || e == 4) ? n
           : lane || group == 1 ? blocks(n, threads)
           : group == 3        ? blocks(n, TRIOS)
           : e == 6            ? blocks(n, SEXTETS / T)
                               : blocks(n, 32 / group);
  out[2] = per_sm;
  out[3] = sms;
  out[4] = (int)attr.localSizeBytes;
  out[5] = attr.numRegs;
  out[6] = (int)attr.sharedSizeBytes;
  out[7] = lane ? 0 : T;
  out[8] = lane;
  out[9] = group;
  return (int)err;
}
