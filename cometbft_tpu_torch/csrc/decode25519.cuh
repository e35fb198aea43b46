// One pubkey's decoding for the decoders (decompress25519.cu), on one
// thread over the 8 x 32-bit field of fe32.cuh: fe32.cuh's decompress
// (ZIP-215) or ristretto_decode, the functions K1/K2 run on R, and the
// canonical radix-2^13 limbs of X, Y, Z, T. Every value equals the plain
// version's mod p (cometbft_tpu_torch/ops/curve.py): both run the same
// sequence of ring operations.
//
// This file is host C++ as well: tests/test_torch_decode_host.py runs
// decode_key on the CPU.

#pragma once

#include "fe32.cuh"

namespace f32 {

// Key b's decoding, ZIP-215 (ed25519) or ristretto255 (sr25519): ok[b] and
// the canonical limbs of X, Y, Z, T.
template <int SCHEME>
__device__ __forceinline__ void decode_key(const int* words, int* ok, int* ox, int* oy,
                                           int* oz, int* ot, int b, int B) {
  uint32_t w[8];
  load_words(w, words, b, B);
  fe y;
  int sign;
  from_words255(y, sign, w);
  pt p;
  bool good;
  if constexpr (SCHEME == SR25519) {
    good = ristretto_decode(p, y, sign);
  } else {
    good = decompress(p, y, sign);
  }
  ok[b] = good ? 1 : 0;
  store_limbs13(ox, p.x, b, B);
  store_limbs13(oy, p.y, b, B);
  store_limbs13(oz, p.z, b, B);
  store_limbs13(ot, p.t, b, B);
}

}  // namespace f32
