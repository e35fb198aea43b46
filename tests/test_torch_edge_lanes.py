"""The edge lanes that chip_smoke.py holds the card's verify kernels to, on
the CPU: the port's plain verify against the JAX package's XLA reference
(the CPU twin of its Pallas kernel) and against the serial oracles.

ed25519: the ZIP-215 cases of chip_smoke.edge_lanes, with the torsion and
encoding cases of chip_smoke.torsion_cases — R or A with a component of
order 8 (valid only under the cofactored check), y = p (a point of order 4)
and y = p + 1 (the identity) as R and as A, R = (x = 0, sign bit set).
sr25519: chip_smoke.edge_lanes_sr with the lane whose check lands on a
multiple of p (ROADMAP Queue 3 item 1), which the JAX reference rejects.

All arithmetic is integer: every comparison is exact.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import torch

import chip_smoke as CS
from cometbft_tpu.ops import ed25519_kernel as JK
from cometbft_tpu.ops import sr25519_kernel as SRK
from cometbft_tpu_torch.crypto import ed25519_math as oracle
from cometbft_tpu_torch.crypto import sr25519_math as srm
from cometbft_tpu_torch.ops import ed25519_kernel as TK
from cometbft_tpu_torch.ops import verify_kernel as VK

CPU = torch.device("cpu")
N = 20  # 16 edge lanes of ed25519, then ordinary ones; bucket 32


def _ed_batch():
    pubs, msgs, sigs = CS.make_commit(N, 11)
    want = CS.edge_lanes(pubs, msgs, sigs)
    return pubs, msgs, sigs, want


def test_torsion_cases_need_the_cofactor():
    """Lanes 0 and 1 are valid only because the check multiplies by 8: the
    unmultiplied [s]B - [k]A - R is a point of order 8."""
    msgs = CS.commit_msgs(8, 3)
    cases, want = CS.torsion_cases(msgs)
    assert want == CS.TORSION_VERDICTS
    for pub, msg, sig in cases[:2]:
        a = oracle.point_decompress_zip215(pub)
        r = oracle.point_decompress_zip215(sig[:32])
        s = int.from_bytes(sig[32:], "little")
        k = oracle.sha512_mod_l(sig[:32], pub, msg)
        diff = oracle.point_add(
            oracle.double_scalar_mult(s, oracle.B_POINT, k, oracle.point_neg(a)),
            oracle.point_neg(r))
        assert not oracle.is_identity(diff)
        assert not oracle.is_identity(oracle.scalar_mult(4, diff))
        assert oracle.is_identity(oracle.mul_by_cofactor(diff))


def test_ed25519_edge_lanes_plain_equals_jax_and_oracle():
    pubs, msgs, sigs, want = _ed_batch()
    b = TK.bucket_size(N)
    pre_ok, safe, r, s, k = JK.stage_batch(pubs, msgs, sigs, b)
    enc = np.frombuffer(b"".join(safe), dtype=np.uint8).reshape(N, 32)
    ok_a, coords = JK.decompress_points(enc)
    a = JK.pad_coords_batch_minor(coords, b)
    jmask, jall = JK._verify_kernel_ok(*(jnp.asarray(x) for x in a + (r, s, k)))
    t = TK.staged_from_numpy(*a, r, s, k, device=CPU)
    mask, allok = VK.verify_math_ok(*t)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    assert bool(allok) == bool(jall) is False
    final = mask.numpy()[:N] & pre_ok & ok_a
    oracle_mask = [oracle.verify_zip215(p, m, sg) for p, m, sg in zip(pubs, msgs, sigs)]
    assert final.tolist() == oracle_mask
    assert final[:16].tolist() == want
    # and the port's own staging and decoding give the same kernel inputs
    tpre, tsafe, *twords = TK.stage_batch(pubs, msgs, sigs, b)
    tok, tcoords = TK.decompress_points(enc, CPU)
    assert tsafe == safe and tpre.tolist() == pre_ok.tolist()
    assert np.asarray(tok).tolist() == np.asarray(ok_a).tolist()


def test_sr25519_edge_lanes_plain_equals_oracle_and_jax_but_the_ripple_lane():
    pubs, msgs, sigs = CS.make_commit_sr(N, 12)
    want = CS.edge_lanes_sr(pubs, msgs, sigs)
    ripple = len(want) - 1
    assert want[ripple] is True
    b = TK.bucket_size(N)
    pre_ok, safe, r, s, k = SRK.stage_rows_sr(pubs, msgs, sigs, b)
    enc = np.frombuffer(b"".join(safe), dtype=np.uint8).reshape(N, 32)
    ok_a, coords = SRK.decompress_points(enc)
    a = JK.pad_coords_batch_minor(coords, b)
    jmask, _ = SRK._verify_kernel_ok(*(jnp.asarray(x) for x in a + (r, s, k)))
    t = TK.staged_from_numpy(*a, r, s, k, device=CPU)
    mask, allok = VK.verify_math_sr_ok(*t)
    final = mask.numpy()[:N] & pre_ok & ok_a
    assert final.tolist() == [srm.verify(p, m, sg) for p, m, sg in zip(pubs, msgs, sigs)]
    assert final[: len(want)].tolist() == want
    # the reference's canonicalize leaves that lane's zero non-canonical
    jm = np.asarray(jmask)
    diff = np.flatnonzero(mask.numpy() != jm).tolist()
    assert diff == [ripple] and not jm[ripple]
    assert bool(allok) is False
