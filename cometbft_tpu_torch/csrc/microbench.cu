// Device microbench probes for Hopper (sm_90a): the loop kernel (K3) and
// the stacked-conv kernel (K4), one lane per thread.
//
// Replace the Pallas TPU kernels of cometbft_tpu/ops/microbench.py:
//   - K3 _loop_kernel_factory (pallas_call at :88): state = body(state),
//     `iters` times, for one of the probe bodies (field ops, the
//     experimental reduce variants, point ops, a ladder window);
//   - K4 probe_stacked (pallas_call at :280): s = conv(s, b)[:20] & 0x1FFF
//     on four coordinates, `iters` times.
// The plain versions are cometbft_tpu_torch/ops/microbench.py, whose
// BODIES registry numbers the bodies as BodyId below; the kernels equal
// them bit for bit on any int32 state.
//
// What bounds them: the integer multiply-adds of the body (a field
// multiplication is 400 limb products plus ~150 carry operations), once
// per iteration, against 2 x n_state x 80 bytes of memory traffic per lane
// for the whole launch. The state therefore stays in registers (point
// bodies: in the thread's local frame, as the verify kernel's accumulator)
// for the whole loop, the loop is not unrolled so one iteration's cost is
// one body, and the body is a template parameter, so each body compiles to
// its own loop with its own register allocation.
//
// Wrap-around: several bodies grow without bound ("conv only" feeds 40-column
// sums back, "loop overhead" adds 1), so every sum and product is taken in
// unsigned arithmetic (curve25519.cuh does the same), which wraps modulo
// 2^32 as the plain int32 tensors do. Shifts stay arithmetic on int.
//
// Several of the JAX package's probe names compute the same function: its
// variants differed in TPU vector layout (rolled vs padded rows, split vs
// 40-column accumulators), which one thread's scalar code does not have.
// "conv only", "conv_roll only" and "conv_split only" are the low 20
// columns of the product; "reduce_v2 mul" and "roll-conv mul" are one
// reduction; "add(3-round carry)" and "add 1-round" are one carry round
// (the field's ADD_ROUNDS is 1). Each group is one body here.

#include "curve25519.cuh"

enum BodyId {
  MUL, SQ, ADD, SUB, RAW_ADD, CARRY20, CONV, LOOP, MUL_V2, MUL_SPLIT,
  DOUBLE_NO_T, DOUBLE, MADD, SELECT17, WINDOW, DBL5, N_BODIES
};

// ------------------------------------------------------------ state

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

// curve._select17_signed on any int32 digit: entry 16 where |d| == 16,
// else entry |d| & 15 (the where-tree over bits 3..0), negated where d < 0.
// |INT_MIN| wraps to INT_MIN, whose low bits select entry 0, as in torch.
__device__ __forceinline__ void select17_any(pt& o, const int* tab, int d) {
  unsigned mag = d < 0 ? 0u - (unsigned)d : (unsigned)d;
  select_entry(o, tab, mag == 16u ? 16 : (int)(mag & 15u), d < 0);
}

// ------------------------------------------------------------ bodies

template <int BODY>
struct Body;

template <>
struct Body<MUL> {  // (mul(s0, s1), s0)
  using S = Fes<2>;
  __device__ static void step(S& s, const int*) {
    fe o;
    fe_mul(o, s.v[0], s.v[1]);
    s.v[1] = s.v[0];
    s.v[0] = o;
  }
};

template <>
struct Body<SQ> {  // (sq(s0),)
  using S = Fes<1>;
  __device__ static void step(S& s, const int*) {
    fe o;
    fe_sq(o, s.v[0]);
    s.v[0] = o;
  }
};

template <>
struct Body<ADD> {  // (add(s0, s1), s0)
  using S = Fes<2>;
  __device__ static void step(S& s, const int*) {
    fe o;
    fe_add(o, s.v[0], s.v[1]);
    s.v[1] = s.v[0];
    s.v[0] = o;
  }
};

template <>
struct Body<SUB> {  // (sub(s0, s1), s0)
  using S = Fes<2>;
  __device__ static void step(S& s, const int*) {
    fe o;
    fe_sub(o, s.v[0], s.v[1]);
    s.v[1] = s.v[0];
    s.v[0] = o;
  }
};

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
struct Body<DOUBLE_NO_T> {  // double_no_t(P)
  using S = pt;
  __device__ static void step(S& p, const int*) { pt_double(p, p, false); }
};

template <>
struct Body<DOUBLE> {  // double(P)
  using S = pt;
  __device__ static void step(S& p, const int*) { pt_double(p, p, true); }
};

template <>
struct Body<MADD> {  // madd_pre(P, select17([d]B, x limb 0))
  using S = pt;
  __device__ static void step(S& p, const int* tab_b) {
    pt q, o;
    select17_any(q, tab_b, p.x.v[0]);
    pt_add_pre(o, p, q, true, true);
    p = o;
  }
};

template <>
struct Body<SELECT17> {  // (select17([d]B, s0 limb 0).x, s0, s1, s2)
  using S = pt;
  __device__ static void step(S& p, const int* tab_b) {
    pt q;
    select17_any(q, tab_b, p.x.v[0]);
    p.t = p.z;
    p.z = p.y;
    p.y = p.x;
    p.x = q.x;
  }
};

template <>
struct Body<WINDOW> {  // window_step(P, d, d, [d]B, table_a, out_t=False)
  using S = pt;
  // table_a: every coordinate of entry e is s0 + ([e]B).x, limb-wise;
  // d = s0 limb 0 & 15
  __device__ static void step(S& p, const int* tab_b) {
    pt tab_a[TABLE17];
#pragma unroll 1
    for (int e = 0; e < TABLE17; e++) {
#pragma unroll
      for (int i = 0; i < NL; i++) {
        int v = wrap_add(p.x.v[i], tab_b[e * NL + i]);
        tab_a[e].x.v[i] = v;
        tab_a[e].y.v[i] = v;
        tab_a[e].z.v[i] = v;
        tab_a[e].t.v[i] = v;
      }
    }
    int d = p.x.v[0] & 15;
    window_step(p, d, d, tab_b, tab_a, false);
  }
};

template <>
struct Body<DBL5> {  // 4 x double_no_t, then double
  using S = pt;
  __device__ static void step(S& p, const int*) {
    pt_double(p, p, false);
    pt_double(p, p, false);
    pt_double(p, p, false);
    pt_double(p, p, false);
    pt_double(p, p, true);
  }
};

// ------------------------------------------------------------ kernels

// K3: state (n_state, 20, B) in, the same out; base_table is the [d]B table
// (4, 17, 20), staged into shared memory for the bodies that select from it.
template <int BODY>
__global__ void __launch_bounds__(THREADS)
loop_kernel(const int* __restrict__ in, int* __restrict__ out,
            const int* __restrict__ base_table, int iters, int B) {
  __shared__ int tab_b[4 * TABLE17 * NL];
  constexpr bool uses_table = BODY == MADD || BODY == SELECT17 || BODY == WINDOW;
  if constexpr (uses_table) {
    for (int k = threadIdx.x; k < 4 * TABLE17 * NL; k += blockDim.x) tab_b[k] = base_table[k];
    __syncthreads();
  }
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  typename Body<BODY>::S s;
  load_state(s, in, b, B);
#pragma unroll 1
  for (int it = 0; it < iters; it++) Body<BODY>::step(s, tab_b);
  store_state(out, s, b, B);
}

// K4: a, b (4, 20, B) -> out (4, 20, B). The coordinates are independent,
// so one is worked at a time: its 20 limbs of s and of b in registers, the
// 20 low columns (all the masked feedback keeps) accumulated unsigned.
__global__ void __launch_bounds__(THREADS)
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
// cudaStream_t. Each returns the launch's cudaError_t (0 on success).

template <int BODY>
static int launch_loop(const void* in, void* out, const void* base_table, int iters, int B,
                       cudaStream_t stream) {
  loop_kernel<BODY><<<(B + THREADS - 1) / THREADS, THREADS, 0, stream>>>(
      (const int*)in, (int*)out, (const int*)base_table, iters, B);
  return (int)cudaGetLastError();
}

extern "C" int microbench_loop(int body, const void* in, void* out, const void* base_table,
                               int iters, int B, void* stream) {
  if (B <= 0 || iters < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (body) {
    case MUL: return launch_loop<MUL>(in, out, base_table, iters, B, st);
    case SQ: return launch_loop<SQ>(in, out, base_table, iters, B, st);
    case ADD: return launch_loop<ADD>(in, out, base_table, iters, B, st);
    case SUB: return launch_loop<SUB>(in, out, base_table, iters, B, st);
    case RAW_ADD: return launch_loop<RAW_ADD>(in, out, base_table, iters, B, st);
    case CARRY20: return launch_loop<CARRY20>(in, out, base_table, iters, B, st);
    case CONV: return launch_loop<CONV>(in, out, base_table, iters, B, st);
    case LOOP: return launch_loop<LOOP>(in, out, base_table, iters, B, st);
    case MUL_V2: return launch_loop<MUL_V2>(in, out, base_table, iters, B, st);
    case MUL_SPLIT: return launch_loop<MUL_SPLIT>(in, out, base_table, iters, B, st);
    case DOUBLE_NO_T: return launch_loop<DOUBLE_NO_T>(in, out, base_table, iters, B, st);
    case DOUBLE: return launch_loop<DOUBLE>(in, out, base_table, iters, B, st);
    case MADD: return launch_loop<MADD>(in, out, base_table, iters, B, st);
    case SELECT17: return launch_loop<SELECT17>(in, out, base_table, iters, B, st);
    case WINDOW: return launch_loop<WINDOW>(in, out, base_table, iters, B, st);
    case DBL5: return launch_loop<DBL5>(in, out, base_table, iters, B, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int microbench_stacked(const void* a, const void* b, void* out, int iters, int B,
                                  void* stream) {
  if (B <= 0 || iters < 0) return (int)cudaErrorInvalidValue;
  stacked_conv_kernel<<<(B + THREADS - 1) / THREADS, THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)a, (const int*)b, (int*)out, iters, B);
  return (int)cudaGetLastError();
}
