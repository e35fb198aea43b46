// Ed25519 ZIP-215 and sr25519 batch verification for Hopper (sm_90a), one
// thread per signature.
//
// Replaces the Pallas TPU kernel cometbft_tpu/ops/pallas_verify.py
// _verify_block_kernel — scheme "ed25519" (K1) and scheme "sr25519" (K2) —
// and the XLA pubkey decoders cometbft_tpu/ops/ed25519_kernel.py
// _decompress_kernel (ZIP-215) and cometbft_tpu/ops/sr25519_kernel.py
// _decompress_kernel (ristretto255).
//
// The two schemes share everything but the decoding of R and the cofactor:
// ed25519 decompresses R under ZIP-215 and checks [8]([s]B - [k]A - R) == O;
// sr25519 (schnorrkel over ristretto255) decodes R as a ristretto255
// element and checks [4](...) == O, which is ristretto equality. One
// template body per kernel takes the scheme as a compile-time parameter;
// the ladder and every point operation are one shared copy.
//
// What bounds it: 32-bit integer multiply-adds. A signature costs about
// 2,800 field multiplications (R decoding ~280, the -A table ~110, the
// 51-window ladder ~2,400, the cofactor check ~20-30); each is a 20x20
// limb product (400 IMADs, 210 for a square) plus ~150 shift/mask/add
// carry operations. Memory traffic is ~1 KB per signature and never
// matters. The design therefore keeps every field element in registers,
// one lane per thread with no cross-thread traffic, so the SMs' integer
// pipes do nothing but the ladder:
//   - limbs are the JAX package's radix-2^13 x 20 int32 limbs with the
//     same carry-round counts, so the carried-limb interval proof
//     (tests/test_field_intervals.py) covers this kernel, and every
//     intermediate equals the plain PyTorch version's bit for bit;
//   - squares use the symmetric product (210 multiply-adds, not 400);
//   - field constants live in __constant__ (every lane reads the same
//     word: a broadcast); the [d]B table, where every lane reads its own
//     entry, is staged once per block into shared memory;
//   - the per-lane table of -A (17 entries x 4 coords x 20 limbs = 5,440 B)
//     lives in local memory, read once per window;
//   - signed 5-bit digit recoding and the R unpack run per thread as a
//     prologue, from the packed wire words;
//   - the batch-wide all-ok is a warp vote plus one atomicAnd per warp
//     with a failing lane (blocks run in any order on the GPU).
// The field and curve code is curve25519.cuh, shared with microbench.cu.
// Point operations are __noinline__ so ptxas compiles each once for both
// schemes; field operations are inlined into them.

#include "curve25519.cuh"

enum Scheme { ED25519, SR25519 };

// R's decoding: ZIP-215 decompression (ed25519) or ristretto255 DECODE
// (sr25519); y holds the encoding's low 255 bits, sign its bit 255.
template <int SCHEME>
__device__ __forceinline__ bool decode_point(pt& o, const fe& y, int sign) {
  if constexpr (SCHEME == SR25519) {
    return pt_ristretto_decode(o, y, sign);
  } else {
    return pt_decompress(o, y, sign);
  }
}

// R of lane b: unpacked and decoded. In the bench instantiation
// nodecomp = 1 skips the decoding and takes R = A with ok (the Pallas
// kernel's stages="nodecomp"): a wrong verdict that slopes out the
// decoding's cost.
template <int SCHEME, bool BENCH>
__device__ __forceinline__ bool load_r(pt& r, const int* rw, const int* ax, const int* ay,
                                       const int* az, const int* at, int nodecomp, int b,
                                       int B) {
  if constexpr (BENCH) {
    if (nodecomp) {
      load_fe(r.x, ax, b, B);
      load_fe(r.y, ay, b, B);
      load_fe(r.z, az, b, B);
      load_fe(r.t, at, b, B);
      return true;
    }
  }
  fe y;
  int sign;
  load_y(y, sign, rw, b, B);
  return decode_point<SCHEME>(r, y, sign);
}

// One signature per thread: R decoded, [s]B + [k](-A) by the signed 5-bit
// ladder, then [cofactor](acc - R) == O; mask[b] is the verdict and the
// block's warps clear *allok where any lane failed.
//
// verify_kernel<SCHEME> is the production kernel. verify_kernel<ED25519,
// int, int> is the microbench's (the Pallas kernel's n_windows/stages
// knobs, ops/microbench.py probe_bisect): knobs = (n_windows, nodecomp);
// n_windows > 0 runs windows n_windows-1 .. 1 and then window 0, and
// nodecomp skips R's decoding. Both give wrong verdicts. The knobs are a
// parameter pack so that the production kernels take no knob argument and
// compile exactly as before; if constexpr drops the bench code from them.
template <int SCHEME, typename... Knobs>
__global__ void __launch_bounds__(THREADS)
verify_kernel(const int* __restrict__ ax, const int* __restrict__ ay,
              const int* __restrict__ az, const int* __restrict__ at,
              const int* __restrict__ rw, const int* __restrict__ sw,
              const int* __restrict__ kw, const int* __restrict__ base_table,
              int* __restrict__ mask, int* __restrict__ allok, int B, Knobs... knobs) {
  constexpr bool BENCH = sizeof...(Knobs) == 2;
  static_assert(BENCH || sizeof...(Knobs) == 0, "knobs are (n_windows, nodecomp)");
  __shared__ int tab_b[4 * TABLE17 * NL];
  for (int k = threadIdx.x; k < 4 * TABLE17 * NL; k += blockDim.x) tab_b[k] = base_table[k];
  __syncthreads();

  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  int valid = 1;
  if (b < B) {
    // R: unpack and decode
    pt r;
    int n_windows = 0, nodecomp = 0;
    if constexpr (BENCH) {
      const int kn[] = {knobs...};
      n_windows = kn[0];
      nodecomp = kn[1];
    }
    bool ok_r = load_r<SCHEME, BENCH>(r, rw, ax, ay, az, at, nodecomp, b, B);

    // signed digits of s and k
    signed char sd[NDIG], kd[NDIG];
    load_digits(sd, sw, b, B);
    load_digits(kd, kw, b, B);

    // table of [d](-A), d = 0..16, T premultiplied by 2d
    pt tab_a[TABLE17];
    pt a;
    load_fe(a.x, ax, b, B);
    load_fe(a.y, ay, b, B);
    load_fe(a.z, az, b, B);
    load_fe(a.t, at, b, B);
    pt_neg(tab_a[1], a);
    pt_identity(tab_a[0]);
#pragma unroll 1
    for (int d = 2; d < TABLE17; d++) {
      if (d % 2 == 0) {
        pt_double(tab_a[d], tab_a[d / 2], true);
      } else {
        pt_add(tab_a[d], tab_a[d - 1], tab_a[1]);
      }
    }
    fe d2;
    fe_const(d2, C_D2);
#pragma unroll 1
    for (int d = 0; d < TABLE17; d++) fe_mul(tab_a[d].t, tab_a[d].t, d2);

    // [s]B + [k](-A), most significant window first
    pt acc;
    pt_identity(acc);
    int nw = NDIG;
    if constexpr (BENCH) nw = n_windows > 0 ? n_windows : NDIG;
#pragma unroll 1
    for (int i = nw - 1; i >= 1; i--) window_step(acc, sd[i], kd[i], tab_b, tab_a, false);
    window_step(acc, sd[0], kd[0], tab_b, tab_a, true);

    // [8](acc - R) == identity for ZIP-215; [4] for sr25519, which is
    // ristretto equality. pt_double reads all of p before writing o.
    constexpr int doublings = SCHEME == SR25519 ? 2 : 3;
    pt nr, diff;
    pt_neg(nr, r);
    pt_add(diff, acc, nr);
#pragma unroll 1
    for (int i = 0; i < doublings; i++) pt_double(diff, diff, true);
    fe t;
    fe_sub(t, diff.y, diff.z);
    bool ok = ok_r && fe_is_zero(diff.x) && fe_is_zero(t);
    valid = ok ? 1 : 0;
    mask[b] = valid;
  }
  if (!__all_sync(0xffffffffu, valid) && (threadIdx.x & 31) == 0) atomicAnd(allok, 0);
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
static int launch_verify(const void* ax, const void* ay, const void* az, const void* at,
                         const void* rw, const void* sw, const void* kw,
                         const void* base_table, void* mask, void* allok, int B,
                         void* stream) {
  if (B <= 0) return 0;
  dim3 grid((B + THREADS - 1) / THREADS);
  verify_kernel<SCHEME><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)ax, (const int*)ay, (const int*)az, (const int*)at, (const int*)rw,
      (const int*)sw, (const int*)kw, (const int*)base_table, (int*)mask, (int*)allok, B);
  return (int)cudaGetLastError();
}

template <int SCHEME>
static int launch_decompress(const void* words, void* ok, void* ox, void* oy, void* oz,
                             void* ot, int B, void* stream) {
  if (B <= 0) return 0;
  dim3 grid((B + THREADS - 1) / THREADS);
  decompress_kernel<SCHEME><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)words, (int*)ok, (int*)ox, (int*)oy, (int*)oz, (int*)ot, B);
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
  if (B <= 0) return 0;
  dim3 grid((B + THREADS - 1) / THREADS);
  verify_kernel<ED25519, int, int><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)ax, (const int*)ay, (const int*)az, (const int*)at, (const int*)rw,
      (const int*)sw, (const int*)kw, (const int*)base_table, (int*)mask, (int*)allok, B,
      n_windows, nodecomp);
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
