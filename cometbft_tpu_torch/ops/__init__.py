"""Device layer of the port.

  limbs.py            host numpy packing: ints/bytes <-> limbs and words
  field.py            GF(2^255-19), radix-2^13 x 20 int32 limbs (plain torch)
  curve.py            edwards25519 point ops, ZIP-215 decompression,
                      ristretto255 decode, signed ladder
  unpack.py           packed words -> y limbs, sign bits, signed digits
  verify_kernel.py    wrappers of the CUDA verify/decompress kernels and
                      their plain versions
  _build.py           nvcc build of csrc/*.cu, loaded with ctypes
  ed25519_kernel.py   ed25519 host staging; the verify path both schemes
                      share (pubkey cache, device glue, host recheck)
  sr25519_kernel.py   sr25519 host staging (Merlin challenges), its scheme
  hashvec.py          batch-axis Keccak and mod-L reduction for staging
  batch_verifier.py   crypto.BatchVerifiers backed by the kernels
"""
