"""BLS12-381 arithmetic on the batch axis in plain PyTorch: the port's copy of
cometbft_tpu/ops/bls12381/ and the plain versions of the BLS kernels
(ops/bls_launch.py, csrc/bls12381.cu).

The reference's representation, so that limbs compare bit for bit with the
JAX modules: an Fp element is radix-2^11, 35 int32 limbs, limb axis second
to last and the lane axis last, Montgomery with R = 2^385 (fp.py). Where the
reference keeps tower and point coordinates in NamedTuples, these modules
stack them on leading axes, so that one torch op serves every component:

  Fp    (..., 35, B)
  Fp2   (..., 2, 35, B)              [c0, c1]               (fp2.py)
  Fp6   (..., 3, 2, 35, B)           [c0, c1, c2]           (tower.py)
  Fp12  (..., 2, 3, 2, 35, B)        [d0, d1]               (tower.py)
  Point NamedTuple (x, y, z) of field tensors                (points.py)

Every operation is lane-wise (or sums along the limb axis), so a stacked
call computes the same limbs as the reference's separate calls. Where the
reference selects between a computed and a kept value by a bit of a fixed
public exponent (pow_const, mul_const, the Miller loop), these modules skip
the computation whose result the bit discards: the same limbs, fewer ops.
"""
