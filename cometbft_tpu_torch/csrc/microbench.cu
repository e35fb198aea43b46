// Device microbench probes for Hopper (sm_90a): the loop kernel (K3) and
// the stacked-conv kernel (K4).
//
// Replace the Pallas TPU kernels of cometbft_tpu/ops/microbench.py:
//   - K3 _loop_kernel_factory (pallas_call at :88): state = body(state),
//     `iters` times, for one of the probe bodies (field ops, the
//     experimental reduce variants, point ops, a ladder window);
//   - K4 probe_stacked (pallas_call at :280): s = conv(s, b)[:20] & 0x1FFF
//     on four coordinates, `iters` times.
// The plain versions are cometbft_tpu_torch/ops/microbench.py, whose
// BODIES registry numbers the bodies as BodyId below.
//
// The probes exist to time what the verify kernels run, so K3 has two kinds
// of body:
//   - value bodies (MUL, SQ, ADD, SUB, DOUBLE_NO_T, DOUBLE, DBL5) compute a
//     function mod p, which any representation may compute. They run the
//     production code (probe32.cuh): fe32.cuh's 8 x 32-bit field on one
//     thread a lane, as a thread of K1/K2 and of the decoders does, and
//     the point bodies as quad25519.cuh's quad doubling, four threads a
//     lane, as K1's ladder does. State in as radix-2^13 limbs (any int32),
//     canonical limbs out: equal to the plain version by canonical value
//     (microbench.loop_err);
//   - limb bodies (RAW_ADD, CARRY20, CONV, LOOP, MUL_V2, MUL_SPLIT, MADD,
//     SELECT17, WINDOW) time the radix-2^13 representation itself
//     (curve25519.cuh), or take a digit from limb 0 of the carried X, which
//     no other representation gives. They equal the plain version bit for
//     bit on any int32 state.
//
// What bounds them: the integer multiply-adds of the body once per
// iteration, against 2 x n_state x 80 bytes of memory traffic per lane for
// the whole launch (a 32-bit-limb multiply is 64 + 8 32x32->64-bit
// products, two IMADs each). A lane is one dependent chain, so at the
// probes' lane counts the kernel is latency-bound: at 10,240 lanes a
// one-thread body gives each scheduler under one warp.
//
// What the design does about it: the state stays in registers for the
// whole loop, every function is inlined and nothing is kept in local
// memory (WINDOW forms only the entry of its -A table that its digit
// selects, from the [d]B table in shared memory; the additions read their
// addend a coordinate at a time); the loop is not unrolled, so one
// iteration's cost is one body; the body is a template parameter, so each
// compiles to its own loop and register allocation; and the grid is one
// wave over the SMs (lanes per block = ceil(B / SMs) in whole warps, four
// threads a lane for the quad bodies), as the decoders and K1 launch.
//
// Wrap-around in the limb bodies: several grow without bound ("conv only"
// feeds 40-column sums back, "loop overhead" adds 1), so every sum and
// product is taken in unsigned arithmetic (curve25519.cuh does the same),
// which wraps modulo 2^32 as the plain int32 tensors do. Shifts stay
// arithmetic on int.
//
// Several of the JAX package's probe names compute the same function: its
// variants differed in TPU vector layout (rolled vs padded rows, split vs
// 40-column accumulators), which one thread's scalar code does not have.
// "conv only", "conv_roll only" and "conv_split only" are the low 20
// columns of the product; "reduce_v2 mul" and "roll-conv mul" are one
// reduction; "add(3-round carry)" and "add 1-round" are one field addition.
// Each group is one body here.

#include <cuda_runtime.h>

#include "probe32.cuh"
#include "curve25519.cuh"

enum BodyId {
  MUL, SQ, ADD, SUB, RAW_ADD, CARRY20, CONV, LOOP, MUL_V2, MUL_SPLIT,
  DOUBLE_NO_T, DOUBLE, MADD, SELECT17, WINDOW, DBL5, N_BODIES
};

enum Kind { LIMB, VALUE, QUAD };

__host__ __device__ constexpr Kind kind_of(int body) {
  return body == MUL || body == SQ || body == ADD || body == SUB ? VALUE
         : body == DOUBLE_NO_T || body == DOUBLE || body == DBL5 ? QUAD
                                                                 : LIMB;
}

__host__ __device__ constexpr int value_op(int body) {
  return body == MUL ? f32::OP_MUL : body == SQ ? f32::OP_SQ : body == ADD ? f32::OP_ADD
                                                                           : f32::OP_SUB;
}

// Threads a block at most: 256 leaves a one-thread lane 255 registers; a
// quad's thread needs fewer, and 512 keeps 10,240 lanes in one wave.
constexpr int MAX_THREADS = 256, MAX_QUAD_THREADS = 512;

__host__ __device__ constexpr int max_threads(int body) {
  return kind_of(body) == QUAD ? MAX_QUAD_THREADS : MAX_THREADS;
}

// K4's block, as ported.
constexpr int K4_THREADS = 128;

// ------------------------------------------------------- limb state

template <int N>
struct Fes {
  fe v[N];
};

template <int N>
__device__ __forceinline__ void load_state(Fes<N>& s, const int* in, int b, int B) {
#pragma unroll
  for (int k = 0; k < N; k++) load_fe(s.v[k], in + k * NL * B, b, B);
}

template <int N>
__device__ __forceinline__ void store_state(int* out, const Fes<N>& s, int b, int B) {
#pragma unroll
  for (int k = 0; k < N; k++) store_fe(out + k * NL * B, s.v[k], b, B);
}

__device__ __forceinline__ void load_state(pt& s, const int* in, int b, int B) {
  load_fe(s.x, in, b, B);
  load_fe(s.y, in + NL * B, b, B);
  load_fe(s.z, in + 2 * NL * B, b, B);
  load_fe(s.t, in + 3 * NL * B, b, B);
}

__device__ __forceinline__ void store_state(int* out, const pt& s, int b, int B) {
  store_fe(out, s.x, b, B);
  store_fe(out + NL * B, s.y, b, B);
  store_fe(out + 2 * NL * B, s.z, b, B);
  store_fe(out + 3 * NL * B, s.t, b, B);
}

// ------------------------------------------------------ variant pieces

__device__ __forceinline__ int wrap_add(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}

// The 40 product columns of a x b (column 39 zero), wrapping.
__device__ __forceinline__ void conv40(unsigned* col, const fe& a, const fe& b) {
#pragma unroll
  for (int k = 0; k < 2 * NL; k++) col[k] = 0u;
#pragma unroll
  for (int i = 0; i < NL; i++) {
#pragma unroll
    for (int j = 0; j < NL; j++) col[i + j] += (unsigned)a.v[i] * (unsigned)b.v[j];
  }
}

// microbench._carry_round40: one carry round over 40 columns; column 39's
// carry (weight 2^520 = FOLD * 2^260) enters column 20.
__device__ __forceinline__ void carry40(int* x) {
  int c[2 * NL];
#pragma unroll
  for (int i = 0; i < 2 * NL; i++) {
    c[i] = x[i] >> RADIX;
    x[i] &= LMASK;
  }
#pragma unroll
  for (int i = 2 * NL - 1; i >= 1; i--) x[i] = wrap_add(x[i], c[i - 1]);
  x[NL] = wrap_add(x[NL], (int)((unsigned)c[2 * NL - 1] * (unsigned)FOLD));
}

// x = lo + FOLD * hi, wrapping.
__device__ __forceinline__ void fold20(fe& o, const int* lo, const int* hi) {
#pragma unroll
  for (int i = 0; i < NL; i++) o.v[i] = (int)((unsigned)lo[i] + (unsigned)FOLD * (unsigned)hi[i]);
}

// microbench._mul_v2: 2 x carry40, fold, 3 x carry20.
__device__ __forceinline__ void mul_v2(fe& o, const fe& a, const fe& b) {
  unsigned col[2 * NL];
  conv40(col, a, b);
  int x[2 * NL];
#pragma unroll
  for (int k = 0; k < 2 * NL; k++) x[k] = (int)col[k];
  carry40(x);
  carry40(x);
  fold20(o, x, x + NL);
  carry20(o.v);
  carry20(o.v);
  carry20(o.v);
}

// microbench._mul_split: lo = columns 0..19, hi = columns 20..39 (the
// cyclic split's accumulators), hi carried twice with the 2^260 wrap,
// folded, 4 x carry20.
__device__ __forceinline__ void mul_split(fe& o, const fe& a, const fe& b) {
  unsigned col[2 * NL];
  conv40(col, a, b);
  int lo[NL], hi[NL];
#pragma unroll
  for (int k = 0; k < NL; k++) {
    lo[k] = (int)col[k];
    hi[k] = (int)col[NL + k];
  }
  carry20(hi);
  carry20(hi);
  fold20(o, lo, hi);
  carry20(o.v);
  carry20(o.v);
  carry20(o.v);
  carry20(o.v);
}

// One coordinate element for all four coordinates of an addend: the WINDOW
// probe's -A table entry.
struct same_coords {
  const fe& v;

  __device__ __forceinline__ void coord(fe& o, int) const { o = v; }
};

// ----------------------------------------------------------- limb bodies

template <int BODY>
struct Body;

template <>
struct Body<RAW_ADD> {  // ((s0 + s1) & 0x1FFF, s0)
  using S = Fes<2>;
  __device__ static void step(S& s, const int*) {
    fe o;
#pragma unroll
    for (int i = 0; i < NL; i++) o.v[i] = wrap_add(s.v[0].v[i], s.v[1].v[i]) & 0x1FFF;
    s.v[1] = s.v[0];
    s.v[0] = o;
  }
};

template <>
struct Body<CARRY20> {  // (carry_round20(s0),)
  using S = Fes<1>;
  __device__ static void step(S& s, const int*) { carry20(s.v[0].v); }
};

template <>
struct Body<CONV> {  // (conv(s0, s1)[:20], s0)
  using S = Fes<2>;
  __device__ static void step(S& s, const int*) {
    unsigned col[2 * NL];
    conv40(col, s.v[0], s.v[1]);
    s.v[1] = s.v[0];
#pragma unroll
    for (int i = 0; i < NL; i++) s.v[0].v[i] = (int)col[i];
  }
};

template <>
struct Body<LOOP> {  // (s0 + 1,)
  using S = Fes<1>;
  __device__ static void step(S& s, const int*) {
#pragma unroll
    for (int i = 0; i < NL; i++) s.v[0].v[i] = wrap_add(s.v[0].v[i], 1);
  }
};

template <>
struct Body<MUL_V2> {  // (_mul_v2(s0, s1), s0)
  using S = Fes<2>;
  __device__ static void step(S& s, const int*) {
    fe o;
    mul_v2(o, s.v[0], s.v[1]);
    s.v[1] = s.v[0];
    s.v[0] = o;
  }
};

template <>
struct Body<MUL_SPLIT> {  // (_mul_split(s0, s1), s0)
  using S = Fes<2>;
  __device__ static void step(S& s, const int*) {
    fe o;
    mul_split(o, s.v[0], s.v[1]);
    s.v[1] = s.v[0];
    s.v[0] = o;
  }
};

template <>
struct Body<MADD> {  // madd_pre(P, select17([d]B, x limb 0))
  using S = pt;
  __device__ static void step(S& p, const int* tab_b) {
    pt_add_pre(p, select17_any(tab_b, p.x.v[0]), true, true);
  }
};

template <>
struct Body<SELECT17> {  // (select17([d]B, s0 limb 0).x, s0, s1, s2)
  using S = pt;
  __device__ static void step(S& p, const int* tab_b) {
    fe x;
    select17_any(tab_b, p.x.v[0]).coord(x, 0);
    p.t = p.z;
    p.z = p.y;
    p.y = p.x;
    p.x = x;
  }
};

template <>
struct Body<WINDOW> {  // window_step(P, d, d, [d]B, table_a, out_t=False)
  using S = pt;
  // Every coordinate of table_a's entry e is s0 + ([e]B).x, limb by limb,
  // and d = s0 limb 0 & 15 lies in [0, 15]: the -A add takes entry d,
  // formed here alone.
  __device__ static void step(S& p, const int* tab_b) {
    const int d = p.x.v[0] & 15;
    fe entry;
#pragma unroll
    for (int i = 0; i < NL; i++) entry.v[i] = wrap_add(p.x.v[i], tab_b[d * NL + i]);
    // one copy of the doubling's code, not five: inlined, a window's
    // radix-2^13 code outgrows the instruction cache
#pragma unroll 1
    for (int j = 0; j < 5; j++) pt_double(p, j == 4);
    pt_add_pre(p, select17_any(tab_b, d), true, true);
    pt_add_pre(p, same_coords{entry}, false, false);
  }
};

// ------------------------------------------------------------ kernels

// K3: state (n_state, 20, B) in, the same out; base_table is the [d]B table
// (4, 17, 20) of the limb bodies that select from it, staged into shared
// memory. Value bodies run one lane a thread, quad bodies one lane a quad
// (probe32.cuh), limb bodies one lane a thread on radix-2^13 limbs.
template <int BODY>
__global__ void __launch_bounds__(max_threads(BODY))
loop_kernel(const int* __restrict__ in, int* __restrict__ out,
            const int* __restrict__ base_table, int iters, int B) {
  const int tid = (int)(blockIdx.x * blockDim.x + threadIdx.x);
  if constexpr (kind_of(BODY) == VALUE) {
    if (tid < B) f32::value_lane<value_op(BODY)>(in, out, iters, tid, B);
  } else if constexpr (kind_of(BODY) == QUAD) {
    const int lane = tid >> 2;
    f32::quad_lane<BODY == DBL5 ? 5 : 1, BODY == DOUBLE_NO_T>(
        f32::quad_of(threadIdx.x), in, out, iters, lane < B ? lane : B - 1, B, lane < B);
  } else {
    __shared__ int tab_b[4 * TABLE17 * NL];
    constexpr bool uses_table = BODY == MADD || BODY == SELECT17 || BODY == WINDOW;
    if constexpr (uses_table) {
      for (int k = threadIdx.x; k < 4 * TABLE17 * NL; k += blockDim.x) tab_b[k] = base_table[k];
      __syncthreads();
    }
    if (tid >= B) return;
    typename Body<BODY>::S s;
    load_state(s, in, tid, B);
#pragma unroll 1
    for (int it = 0; it < iters; it++) Body<BODY>::step(s, tab_b);
    store_state(out, s, tid, B);
  }
}

// K4: a, b (4, 20, B) -> out (4, 20, B). The coordinates are independent,
// so one is worked at a time: its 20 limbs of s and of b in registers, the
// 20 low columns (all the masked feedback keeps) accumulated unsigned.
__global__ void __launch_bounds__(K4_THREADS)
stacked_conv_kernel(const int* __restrict__ a, const int* __restrict__ bb,
                    int* __restrict__ out, int iters, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
#pragma unroll 1
  for (int c = 0; c < 4; c++) {
    fe s, m;
    load_fe(s, a + c * NL * B, b, B);
    load_fe(m, bb + c * NL * B, b, B);
#pragma unroll 1
    for (int it = 0; it < iters; it++) {
      unsigned col[NL];
#pragma unroll
      for (int k = 0; k < NL; k++) col[k] = 0u;
#pragma unroll
      for (int i = 0; i < NL; i++) {
#pragma unroll
        for (int j = 0; i + j < NL; j++) col[i + j] += (unsigned)s.v[i] * (unsigned)m.v[j];
      }
#pragma unroll
      for (int k = 0; k < NL; k++) s.v[k] = (int)(col[k] & 0x1FFFu);
    }
    store_fe(out + c * NL * B, s, b, B);
  }
}

// ------------------------------------------------------------ C interface
// Pointers are device pointers from torch tensors; stream is the caller's
// cudaStream_t. Each returns a cudaError_t (0 on success).

static const void* const LOOP_KERNELS[N_BODIES] = {
    (const void*)loop_kernel<MUL>,         (const void*)loop_kernel<SQ>,
    (const void*)loop_kernel<ADD>,         (const void*)loop_kernel<SUB>,
    (const void*)loop_kernel<RAW_ADD>,     (const void*)loop_kernel<CARRY20>,
    (const void*)loop_kernel<CONV>,        (const void*)loop_kernel<LOOP>,
    (const void*)loop_kernel<MUL_V2>,      (const void*)loop_kernel<MUL_SPLIT>,
    (const void*)loop_kernel<DOUBLE_NO_T>, (const void*)loop_kernel<DOUBLE>,
    (const void*)loop_kernel<MADD>,        (const void*)loop_kernel<SELECT17>,
    (const void*)loop_kernel<WINDOW>,      (const void*)loop_kernel<DBL5>};

// Threads per block of body `body` for a batch of B lanes on the current
// device: one wave over the SMs, ceil(B / SMs) lanes a block (four threads
// a lane for the quad bodies) in whole warps, at most max_threads(body).
static int loop_threads(int body, int B, int* sms_out) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (sms <= 0) sms = 1;
  const int per_lane = kind_of(body) == QUAD ? 4 : 1;
  int n = (B + sms - 1) / sms * per_lane;
  n = (n + 31) / 32 * 32;
  if (n > max_threads(body)) n = max_threads(body);
  if (sms_out) *sms_out = sms;
  return n;
}

static int loop_blocks(int body, int B, int threads) {
  const int per_lane = kind_of(body) == QUAD ? 4 : 1;
  return (int)(((long long)B * per_lane + threads - 1) / threads);
}

extern "C" int microbench_loop(int body, const void* in, void* out, const void* base_table,
                               int iters, int B, void* stream) {
  if (body < 0 || body >= N_BODIES || B <= 0 || iters < 0) return (int)cudaErrorInvalidValue;
  const int threads = loop_threads(body, B, nullptr);
  const int* i = (const int*)in;
  int* o = (int*)out;
  const int* t = (const int*)base_table;
  void* args[] = {&i, &o, &t, &iters, &B};
  return (int)cudaLaunchKernel(LOOP_KERNELS[body], dim3(loop_blocks(body, B, threads)),
                               dim3(threads), args, 0, (cudaStream_t)stream);
}

// The launch shape of body `body` for a batch of B: lanes per block,
// blocks, threads per block, resident blocks per SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), the SM count, and the
// loaded kernel's local memory per thread and registers
// (cudaFuncGetAttributes), into out[0..6]. Returns a cudaError_t.
extern "C" int microbench_launch_shape(int body, int B, int* out) {
  if (body < 0 || body >= N_BODIES || B <= 0) return (int)cudaErrorInvalidValue;
  int sms = 0;
  const int threads = loop_threads(body, B, &sms);
  int per_sm = 0;
  cudaError_t err =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, LOOP_KERNELS[body], threads, 0);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr = {};
  err = cudaFuncGetAttributes(&attr, LOOP_KERNELS[body]);
  out[0] = threads / (kind_of(body) == QUAD ? 4 : 1);
  out[1] = loop_blocks(body, B, threads);
  out[2] = threads;
  out[3] = per_sm;
  out[4] = sms;
  out[5] = (int)attr.localSizeBytes;
  out[6] = attr.numRegs;
  return (int)err;
}

extern "C" int microbench_stacked(const void* a, const void* b, void* out, int iters, int B,
                                  void* stream) {
  if (B <= 0 || iters < 0) return (int)cudaErrorInvalidValue;
  stacked_conv_kernel<<<(B + K4_THREADS - 1) / K4_THREADS, K4_THREADS, 0,
                        (cudaStream_t)stream>>>((const int*)a, (const int*)b, (int*)out,
                                                iters, B);
  return (int)cudaGetLastError();
}
