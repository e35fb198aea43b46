"""Hash-to-curve for G2 on the batch axis: the port's copy of
cometbft_tpu/ops/bls12381/htc.py (the draft-irtf-cfrg-hash-to-curve
pipeline with the generic SvdW map; the oracle's twin is
bls12381_math.bls_hash_to_g2).

expand_message_xmd is SHA-256 work on the host (ops/hashvec.sha256_many,
batched across messages), and so is the reduction of each 64-byte chunk mod
p; the SvdW map, the point add and the cofactor clearing are batch field
arithmetic."""

from __future__ import annotations

import hashlib

import torch

from cometbft_tpu_torch.crypto import bls12381_math as _oracle
from cometbft_tpu_torch.ops.bls12381 import fp, fp2
from cometbft_tpu_torch.ops.bls12381 import points as pts

_LEN = 2 * 2 * _oracle._H2F_L  # 256 uniform bytes per message


def expand_messages(msgs: list[bytes], dst: bytes) -> list[bytes]:
    """expand_message_xmd over a batch: 9 sha256_many calls of B rows each
    instead of 9 * B hashlib calls."""
    from cometbft_tpu_torch.ops import hashvec

    if len(dst) > 255:
        dst = hashlib.sha256(b"H2C-OVERSIZE-DST-" + dst).digest()
    ell = -(-_LEN // 32)
    dst_prime = dst + bytes([len(dst)])
    z_pad = bytes(64)
    l_i_b = _LEN.to_bytes(2, "big")
    b0 = hashvec.sha256_many([z_pad + m + l_i_b + b"\x00" + dst_prime for m in msgs])
    prev = hashvec.sha256_many([bytes(b0[j]) + b"\x01" + dst_prime for j in range(len(msgs))])
    chunks = [prev]
    for i in range(2, ell + 1):
        prev = hashvec.sha256_many([(b0[j] ^ prev[j]).tobytes() + bytes([i]) + dst_prime
                                    for j in range(len(msgs))])
        chunks.append(prev)
    return [b"".join(bytes(ch[j]) for ch in chunks)[:_LEN] for j in range(len(msgs))]


def hash_to_field_limbs(msgs: list[bytes], dst: bytes):
    """B messages -> the two Fp2 elements of each as RAW (non-Montgomery)
    limb planes (u0a, u0b, u1a, u1b), each (35, B) int32 numpy: each
    64-byte chunk reduced mod p in exact host integers."""
    uniform = expand_messages(msgs, dst)
    step = _oracle._H2F_L
    return tuple(fp.ints_to_limbs([int.from_bytes(u[step * k:step * (k + 1)], "big")
                                   % _oracle.BLS_P for u in uniform]) for k in range(4))


def svdw_map(u: torch.Tensor) -> pts.Point:
    """Branch-free map_to_curve_svdw on the twist, u an Fp2 batch (constants
    from the oracle's self-validated setup)."""
    z, c1, c2, c3, c4 = _oracle._bls_setup()["svdw"]

    def k(cst):
        return fp2.const_like(cst, u)

    def g(x):
        return fp2.add(fp2.mul(fp2.sq(x), x), k(fp2.B2))

    one = fp2.one_like(u)
    tv1 = fp2.mul(fp2.sq(u), k(c1))
    tv2 = fp2.add(one, tv1)
    tv1 = fp2.sub(one, tv1)
    tv3 = fp2.inv(fp2.mul(tv1, tv2))  # inv0 built in
    tv4 = fp2.mul(fp2.mul(u, tv1), fp2.mul(tv3, k(c3)))
    x1 = fp2.sub(k(c2), tv4)
    x2 = fp2.add(k(c2), tv4)
    x3 = fp2.add(fp2.mul(fp2.sq(fp2.mul(fp2.sq(tv2), tv3)), k(c4)), k(z))
    sq1, sq2 = fp2.is_square(g(torch.stack([x1, x2]))).unbind(0)
    e2 = sq2 & ~sq1
    x = fp2.select(sq1, x1, fp2.select(e2, x2, x3))
    _, y = fp2.sqrt(g(x))
    flip = fp2.sgn0(u) != fp2.sgn0(y)
    return pts.from_affine(pts.G2Field, x, fp2.select(flip, fp2.neg(y), y))


def map_to_g2(u0: torch.Tensor, u1: torch.Tensor) -> pts.Point:
    """SvdW both field elements (one stacked map), add, clear the cofactor:
    a projective point in the r-order subgroup."""
    q = svdw_map(torch.stack([u0, u1]))
    q0 = pts.Point(*(a[0] for a in q))
    q1 = pts.Point(*(a[1] for a in q))
    return pts.mul_const(pts.G2Field, pts.add(pts.G2Field, q0, q1), _oracle._bls_setup()["h2"])


def hash_to_g2(msgs: list[bytes], dst: bytes, device=None) -> pts.Point:
    """The pipeline for a batch of messages (host expand, batch map)."""
    planes = [torch.from_numpy(a).to(device) for a in hash_to_field_limbs(msgs, dst)]
    u = fp.to_mont(torch.stack(planes).unflatten(0, (2, 2)))
    return map_to_g2(u[0], u[1])
