// The five BLS12-381 kernels for Hopper (sm_90a), over fp381.cuh (Fp in 12 x
// 32-bit Montgomery limbs), tower381.cuh (Fp2/Fp6/Fp12), group381.cuh (thread
// groups and batches of products) and curve381.cuh (G1, G2, hash-to-G2, the
// pairing and the per-lane and per-group bodies):
//
//   B1 bls_decompress_kernel<G>  x -> y = sqrt(x^3 + b) with the sign rule,
//      ok = the root exists (and with check_sub, P in G1: sigma(P) ==
//      [-x^2]P; in G2: psi(P) == [x]P); affine out. Replaces
//      cometbft_tpu/ops/bls_kernel.py:180
//      _jit_decompress, :191 _jit_subgroup_g1, :198 _jit_subgroup_g2
//      (points.py:172, 233, 248).
//   B2 bls_hash_to_g2_kernel     the raw hash_to_field planes -> SvdW map
//      twice, add, cofactor clearing ([h2], h2 = #E'(Fp2) / r, the
//      oracle's) -> affine H(m). Replaces :205 _jit_hash_msgs (htc.py:70,
//      102, points.to_affine).
//   B3 bls_point_sum_part_kernel<G> + bls_point_sum_kernel<G>  a segmented
//      sum: group g sums the affine points of lanes
//      order[starts[g]..starts[g+1]), to affine, with the identity flag and
//      (check_sub) the subgroup check of the sum (G2: the psi test, G1: the
//      sigma test). Replaces points.sum_tree in _aggregate_device
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
// (group381.cuh). B1 with the subgroup check: one lane a trio (ten a
// warp), each thread decompressing, then the psi test's Fp2 products (G2)
// or the sigma test's rounds of Fp products (G1) split three ways. B2: one
// message a trio, its two SvdW maps on two threads at once, then every Fp2
// product split three ways. B4: one pair a half-warp
// (two a warp) or, on wider calls, a sextet (five a warp), each Miller
// step's products on three batches split sixteen or six ways. B5: T
// sextets a check (T = 5 where a check has more than two Miller
// values), each multiplying a stride of the check's values, then a tree
// across the T; the check's first sextet then runs the final
// exponentiation with each Fp12 product split six ways (three Fp2 products
// a thread) and each cyclotomic square six ways (one). Calls wider than
// the card holds in such warps (B1 G2's and B2's 10,240 lanes, B4's 20,480
// pairs, B5's 10,240 checks of two) take one lane a thread instead
// (lane_kernel), as do B1 without the check, in blocks of 32 lanes so that
// small batches spread over the SMs. B1 G1's check is sigma(P) ==
// [-x^2]P, a 128-bit ladder for r's 255; on a trio its Jacobian steps'
// products go in rounds of three (a doubling in three rounds, an addition
// in five). B3's chain is its depth: a wide
// group (more than SUM_SHORT points on average) is cut into slices of about
// two points a thread over as many blocks of 64 threads (phase 1: a mixed
// addition, then a tree in shared memory), whose partials one block a group
// sums by a tree (phase 2) before the tail, in which warp 1 takes the sum
// to affine while warp 0 checks it (G2: psi on a trio); a narrow group runs
// phase 2 alone on its lanes. The tower and point operations are out-of-line
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
constexpr int SUM_THREADS = 64;                // B3's blocks: two warps (the tail uses both)
constexpr long long SUM_CHUNK = 2 * SUM_THREADS;  // B3 phase 1: two points a thread
// B3: phase 2 alone to this many points a group on average (measured: a
// block alone level with the split at 150 points, behind it from 256)
constexpr long long SUM_SHORT = 192;
constexpr long long SUM_MAX_SLICES = 4 * SUM_THREADS;  // at most four partials a phase-2 thread
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

// B1 with the check on trios, one warp a block: lane blockIdx.x * TRIOS +
// lane / 3 on trio lane / 3
template <int G>
__global__ void bls_decompress_trio_kernel(const int32_t* x_raw, const int32_t* sign,
                                           int check_sub, int B, uint32_t* out, int32_t* ok) {
  __shared__ uint32_t xbuf[TRIOS * 6 * DEC_SLOT];
  const int lane = threadIdx.x;
  if (lane >= 3 * TRIOS) return;
  const int k = lane / 3;
  const long long j = (long long)blockIdx.x * TRIOS + k;
  if (j >= B) return;  // a trio leaves whole
  trio g{lane % 3, 7u << (3 * k), xbuf + k * 6 * DEC_SLOT, DEC_SLOT, 0};
  group_decompress<G>(x_raw, sign, check_sub, B, j, out, ok, g);
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
using sum_field = typename std::conditional<G == 1, fp, fp2>::type;

// the block's m partials in part[] (one a thread, m <= SUM_THREADS) summed
// into part[0] by a tree, one level a sync
template <class T>
__device__ __forceinline__ void block_tree(proj<T>* part, long long m) {
  for (int k = (int)(m < SUM_THREADS ? m : SUM_THREADS); k > 1;) {
    k = sum_tree_level(part, (int)threadIdx.x, k);
    __syncthreads();
  }
}

// B3 phase 1: block b = g S + s sums slice s of group g's lanes into
// partial column b
template <int G>
__global__ void bls_point_sum_part_kernel(const uint32_t* pts, long long N, const int32_t* order,
                                          const int32_t* starts, int S, uint32_t* parts,
                                          long long cols) {
  using T = sum_field<G>;
  __shared__ proj<T> part[SUM_THREADS];
  const long long b = blockIdx.x;
  const int g = (int)(b / S), s = (int)(b % S);
  long long lo, hi;
  sum_slice(lo, hi, starts[g], starts[g + 1], s, S);
  proj<T> acc;
  sum_lanes(acc, pts, N, order, lo, hi, (int)threadIdx.x, SUM_THREADS);
  part[threadIdx.x] = acc;
  __syncthreads();
  block_tree(part, hi - lo);
  if (threadIdx.x == 0) proj_st(parts, cols, b, part[0]);
}

// B3 phase 2 (S > 1: group g's S partials) or alone (S = 1: its lanes),
// then the tail: warp 1's first thread takes the sum to affine while warp
// 0 checks it (G2: psi on a trio, G1: sigma on one thread)
template <int G>
__global__ void bls_point_sum_kernel(const uint32_t* pts, long long N, const int32_t* order,
                                     const int32_t* starts, int n_groups, int S,
                                     const uint32_t* parts, int check_sub, uint32_t* out,
                                     int32_t* is_id, int32_t* sub_ok) {
  using T = sum_field<G>;
  __shared__ proj<T> part[SUM_THREADS];
  __shared__ uint32_t xbuf[6 * DEC_SLOT];
  const int t = threadIdx.x, g = blockIdx.x;
  proj<T> acc;
  long long m;
  if (S > 1) {
    sum_parts(acc, parts, (long long)n_groups * S, (long long)g * S, S, t, SUM_THREADS);
    m = S;
  } else {
    sum_lanes(acc, pts, N, order, starts[g], starts[g + 1], t, SUM_THREADS);
    m = starts[g + 1] - starts[g];
  }
  part[t] = acc;
  __syncthreads();
  block_tree(part, m);
  // the tail reads the sum in place, in shared memory: taken to affine from
  // a local copy, the card's build returned x = 1 on every group (y right)
  if (t == 32) {
    sum_affine(part[0], n_groups, g, out, is_id);
  } else if (t < 3) {
    bool ok = true;
    if constexpr (G == 2) {
      trio tr{t, 7u, xbuf, DEC_SLOT, 0};
      if (check_sub) ok = pt_in_subgroup(part[0], tr);
    } else {
      if (check_sub && t == 0) ok = pt_in_subgroup(part[0]);
    }
    if (t == 0) sub_ok[g] = ok;
  }
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

// The group kernels (B1, B2, B4, B5) run while their warps are at most
// `per_sm` an SM (`per_warp` lanes a warp); wider, one thread a lane (a
// group's exchanges and the additions every thread repeats then cost more
// than its shorter chain saves). Measured on the card on both sides
// (PERF.md): B2's and B5's group warps pay up to one an SM sub-partition,
// B1's trios likewise (G1's and G2's); B4's half-warps (two pairs a warp) up to three
// quarters of one an SM, then its sextets (five, 12 KB of stack a thread)
// up to about one and a half.
constexpr double B1_GROUP_WARPS = 4;    // B1 G2 trios: to 5,280 lanes on 132 SMs
constexpr double B1G1_GROUP_WARPS = 4;  // B1 G1 trios: to 5,280 lanes
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

// B1's kernel for B lanes of group g: true for the trio kernel (kernel 1,
// or with the check below the crossover), false for one lane a thread
static bool decompress_trio(int g, int check_sub, long long B, int kernel) {
  return kernel == 1 || (check_sub && !use_lane(kernel, B, TRIOS,
                                                g == 1 ? B1G1_GROUP_WARPS : B1_GROUP_WARPS));
}

// B1. g = 1: x_raw (35, B); g = 2: (2, 35, B) c0 then c1. out (24 g, B).
// kernel: 0 the crossover's, 1 the trio kernel, 2 one lane a thread. Calls
// without the subgroup check run one lane a thread. *lane: 1 where one lane
// a thread ran.
extern "C" int bls_decompress(int g, const void* x_raw, const void* sign, int check_sub, int B,
                              void* out, void* ok, void* stream, int kernel, int* lane) {
  cudaStream_t s = (cudaStream_t)stream;
  const bool trio = decompress_trio(g, check_sub, B, kernel);
  *lane = !trio;
  const int32_t *x = (const int32_t*)x_raw, *sg = (const int32_t*)sign;
  if (trio && g == 1)
    bls_decompress_trio_kernel<1><<<blocks(B, TRIOS), THREADS, 0, s>>>(
        x, sg, check_sub, B, (uint32_t*)out, (int32_t*)ok);
  else if (trio)
    bls_decompress_trio_kernel<2><<<blocks(B, TRIOS), THREADS, 0, s>>>(
        x, sg, check_sub, B, (uint32_t*)out, (int32_t*)ok);
  else if (g == 1)
    bls_decompress_kernel<1><<<blocks(B, THREADS), THREADS, 0, s>>>(
        x, sg, check_sub, B, (uint32_t*)out, (int32_t*)ok);
  else
    bls_decompress_kernel<2><<<blocks(B, THREADS), THREADS, 0, s>>>(
        x, sg, check_sub, B, (uint32_t*)out, (int32_t*)ok);
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

// B3's slices a group for `points` lanes (the order's length) in `groups`
// groups: 1, phase 2 alone, while a group averages at most SUM_SHORT points
// (kernel 0) or where kernel is 1; else about SUM_CHUNK points a phase-1
// block, at least 2 (kernel 2 forces phase 1) and at most SUM_MAX_SLICES.
extern "C" int bls_point_sum_slices(long long points, int groups, int kernel) {
  const long long avg = (points + groups - 1) / (groups > 0 ? groups : 1);
  if (kernel == 1 || (kernel == 0 && avg <= SUM_SHORT)) return 1;
  const long long s = (avg + SUM_CHUNK - 1) / SUM_CHUNK;
  return (int)(s < 2 ? 2 : s > SUM_MAX_SLICES ? SUM_MAX_SLICES : s);
}

// B3. pts (24 g, N) affine; order (M,) lane indices grouped; starts (G + 1,);
// S slices a group (bls_point_sum_slices); parts (36 g, G S) scratch for
// the partials where S > 1 (else null); out (24 g, G) affine sums; is_id,
// sub_ok (G,). S > 1 launches phase 1, then phase 2; S = 1 phase 2 alone.
// *split: 1 where phase 1 ran.
extern "C" int bls_point_sum(int g, const void* pts, long long N, const void* order,
                             const void* starts, int n_groups, int check_sub, void* out,
                             void* is_id, void* sub_ok, void* stream, int S, void* parts,
                             int* split) {
  cudaStream_t s = (cudaStream_t)stream;
  if (S < 1 || (S > 1 && !parts)) return (int)cudaErrorInvalidValue;
  *split = S > 1;
  const long long cols = (long long)n_groups * S;
  const uint32_t* p = (const uint32_t*)pts;
  const int32_t *o = (const int32_t*)order, *st = (const int32_t*)starts;
  if (S > 1) {
    if (g == 1)
      bls_point_sum_part_kernel<1><<<(unsigned)cols, SUM_THREADS, 0, s>>>(
          p, N, o, st, S, (uint32_t*)parts, cols);
    else
      bls_point_sum_part_kernel<2><<<(unsigned)cols, SUM_THREADS, 0, s>>>(
          p, N, o, st, S, (uint32_t*)parts, cols);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (g == 1)
    bls_point_sum_kernel<1><<<n_groups, SUM_THREADS, 0, s>>>(
        p, N, o, st, n_groups, S, (const uint32_t*)parts, check_sub, (uint32_t*)out,
        (int32_t*)is_id, (int32_t*)sub_ok);
  else
    bls_point_sum_kernel<2><<<n_groups, SUM_THREADS, 0, s>>>(
        p, N, o, st, n_groups, S, (const uint32_t*)parts, check_sub, (uint32_t*)out,
        (int32_t*)is_id, (int32_t*)sub_ok);
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
// lanes (groups for B3 with `values` points in all, checks for B5 with
// `values` Miller values in all; for B1 `values` is check_sub), with
// `kernel` as the entry takes it (B1, B3, B4; 0 elsewhere), as the entry
// launches it: threads per block, blocks, resident blocks per SM, SMs,
// local memory per thread, registers, static shared memory, B5's sextets a
// check (0 where none), 1 where the entry takes its one-lane kernel though
// it has a group kernel, the threads a lane (1, 3 or 6); for B3 (else 0)
// its slices a group, and phase 1's blocks, registers and local memory a
// thread (0 where phase 2 runs alone; the fields before are phase 2's).
// Returns a cudaError_t.
extern "C" int bls_launch_shape(int e, int n, int values, int kernel, int* out) {
  if (e < 0 || e > 6 || n <= 0 || kernel < 0 || kernel > (e == 5 ? 3 : 2))
    return (int)cudaErrorInvalidValue;
  const int mk = e == 5 ? miller_kernel(kernel, n) : 0;
  const int T = e == 6 ? sextets_per_check(((long long)values + n - 1) / n) : 0;
  const bool sum = e == 3 || e == 4;
  const int S = sum ? bls_point_sum_slices(values, n, kernel) : 0;
  const bool trio = e <= 1 && decompress_trio(e + 1, values, n, kernel);
  const bool lane = (e <= 1 && !trio) || (e == 2 && lane_kernel(n, TRIOS, B2_GROUP_WARPS)) ||
                    (e == 5 && mk == 2) ||
                    (e == 6 && T == 1 && lane_kernel(n, SEXTETS, B5_GROUP_WARPS));
  const void* fns[7] = {trio ? (const void*)bls_decompress_trio_kernel<1>
                             : (const void*)bls_decompress_kernel<1>,
                        trio ? (const void*)bls_decompress_trio_kernel<2>
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
  const int threads = sum ? SUM_THREADS : THREADS;
  int per_sm = 0, dev = 0, sms = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fns[e], threads, 0);
  if (err != cudaSuccess) return (int)err;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaFuncAttributes attr = {};
  err = cudaFuncGetAttributes(&attr, fns[e]);
  if (err != cudaSuccess) return (int)err;
  const int group = trio || (e == 2 && !lane) ? 3
                    : e == 5 && !lane ? (mk == 1 ? SEXTET : HALF)
                    : e == 6 && !lane ? 6
                                      : 1;
  out[0] = threads;
  out[1] = sum                  ? n
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
  out[10] = S;
  out[11] = out[12] = out[13] = 0;
  if (S > 1) {
    cudaFuncAttributes part = {};
    err = cudaFuncGetAttributes(&part, e == 3 ? (const void*)bls_point_sum_part_kernel<1>
                                              : (const void*)bls_point_sum_part_kernel<2>);
    out[11] = S * n;
    out[12] = part.numRegs;
    out[13] = (int)part.localSizeBytes;
  }
  return (int)err;
}
