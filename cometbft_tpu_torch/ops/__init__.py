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
                      share (verify_batch_async stages and launches,
                      resolve_batches fetches many batches' headers at once;
                      verify_rows is the two for one batch: the
                      device-challenge and classic paths, pubkey cache, key
                      staging, header, recheck with per-group budgets)
  dispatch.py         the dispatch streams (one a fault domain) and lock, and
                      the supervision layer: failure classes, circuit
                      breakers, supervisors, the in-flight gate
  sr25519_kernel.py   sr25519 host staging (Merlin challenges), its scheme
  hashvec.py          host hash rungs (native, numpy, serial): Keccak,
                      SHA-512, mod L, prefixed-row reassembly
  residency.py        device-resident key tables (indexed sends)
  challenge.py        device challenges: prefix table, plan_batch, the
                      wrapper of K5 (csrc/challenge25519.cu) and its plain
                      version
  integrity.py        staging checksum, reduced-fetch header and payload:
                      the wrapper of K6 (csrc/integrity.cu) and its plain
                      version
  batch_verifier.py   crypto.BatchVerifiers backed by the kernels
  microbench.py       the device microbench: probe kernels K3/K4 and their
                      plain versions, the verify kernel's bench knobs
"""
