// The microbench's value probes (microbench.cu loop_kernel) on the verify
// kernels' own arithmetic: one lane's loop of a field operation of fe32.cuh
// on one thread, or of the quad doubling of quad25519.cuh on a quad of four
// threads, as a thread of K1/K2 and of the decoders runs them.
//
// A lane's state is n_state coordinates of twenty radix-2^13 int32 limbs
// (the probes' (n_state, 20, B) layout). It is loaded with from_limbs13
// (any int32 limbs, taken mod p), iterated in registers, and stored as
// canonical limbs (to_limbs13). The plain versions (ops/microbench.py
// BODIES) run the radix-2^13 field on the same state: the two agree mod p
// wherever the plain int32 arithmetic does not wrap, and are compared by
// canonical value.
//
// Host C++ as well: tests/test_torch_probe32_host.py runs these lanes on
// the CPU, the quad as four host threads.

#pragma once

#include "quad25519.cuh"

namespace f32 {

// The one-thread value bodies: (mul(s0, s1), s0), (sq(s0),), (add(s0, s1),
// s0), (sub(s0, s1), s0).
enum ValueOp { OP_MUL, OP_SQ, OP_ADD, OP_SUB };

__host__ __device__ constexpr int value_states(int op) { return op == OP_SQ ? 1 : 2; }

template <int OP>
__device__ __forceinline__ void value_step(fe* s) {
  if constexpr (OP == OP_SQ) {
    sq(s[0], s[0]);
  } else {
    fe o;
    if constexpr (OP == OP_MUL) {
      mul(o, s[0], s[1]);
    } else if constexpr (OP == OP_ADD) {
      add(o, s[0], s[1]);
    } else {
      sub(o, s[0], s[1]);
    }
    s[1] = s[0];
    s[0] = o;
  }
}

// Lane b of a value body: `iters` steps of OP on its state in (n_state, 20,
// B) `in`, canonical limbs to `out`.
template <int OP>
__device__ __forceinline__ void value_lane(const int* in, int* out, int iters, int b, int B) {
  constexpr int N = value_states(OP);
  fe s[N];
#pragma unroll
  for (int k = 0; k < N; k++) load_limbs13(s[k], in + k * 20 * B, b, B);
#pragma unroll 1
  for (int it = 0; it < iters; it++) value_step<OP>(s);
#pragma unroll
  for (int k = 0; k < N; k++) store_limbs13(out + k * 20 * B, s[k], b, B);
}

// Lane b of a point body on its quad: thread q holds coordinate q of the
// (4, 20, B) state and runs DBLS quad doublings (qdbl, K1's ladder
// doubling, which always forms T) an iteration. With NO_T the stored T is
// zeros after one or more iterations, as the plain double_no_t writes it
// (the doublings never read T). Only a live quad stores: a quad past the
// batch's end runs on the last lane's state, so its warp stays whole.
template <int DBLS, bool NO_T, class Quad>
__device__ __forceinline__ void quad_lane(const Quad& Q, const int* in, int* out, int iters,
                                          int b, int B, bool live) {
  fe c;
  load_limbs13(c, in + Q.q * 20 * B, b, B);
#pragma unroll 1
  for (int it = 0; it < iters; it++) {
#pragma unroll 1
    for (int j = 0; j < DBLS; j++) qdbl(c, Q);
  }
  if (NO_T && Q.q == 3 && iters > 0) zero(c);
  if (live) store_limbs13(out + Q.q * 20 * B, c, b, B);
}

}  // namespace f32
