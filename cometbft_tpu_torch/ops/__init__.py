"""Device layer of the port.

  limbs.py            host numpy packing: ints/bytes <-> limbs and words
  field.py            GF(2^255-19), radix-2^13 x 20 int32 limbs (plain torch)
  curve.py            edwards25519 point ops, decompression, signed ladder
  unpack.py           packed words -> y limbs, sign bits, signed digits
  verify_kernel.py    wrappers of the CUDA verify/decompress kernels and
                      their plain versions
  _build.py           nvcc build of csrc/*.cu, loaded with ctypes
  ed25519_kernel.py   host staging, pubkey cache, verify_batch
  batch_verifier.py   crypto.BatchVerifier backed by the kernel
"""
