"""The port's sr25519 path (cometbft_tpu_torch) against the JAX package's
and the schnorrkel oracle: Keccak, STROBE and the batch Merlin challenges
at message lengths around the STROBE rate, the ristretto255 decode,
verify_math_sr_ok on staged batches (buckets 8 and 128) with edge lanes,
staging, verify_batch and the BatchVerifier seam, the sr25519 pubkey
cache, and the mixed ed25519 + sr25519 verifier.

All arithmetic is integer, so every comparison is exact equality: bytes,
words, limbs, masks and all-ok flags.

JAX's CPU reference for the sr25519 Pallas kernel (K2) is its XLA twin
``sr25519_kernel._verify_kernel_ok``; the CUDA kernels themselves are held
against the port's plain versions on the card
(tests/test_torch_kernels_cuda.py and chip_smoke.py).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as CS
from cometbft_tpu.crypto import batch as jbatch
from cometbft_tpu.crypto import ed25519 as jed
from cometbft_tpu.crypto import sr25519 as jsr
from cometbft_tpu.crypto import sr25519_math as jsrm
from cometbft_tpu.ops import ed25519_kernel as JK
from cometbft_tpu.ops import sr25519_kernel as SRK
from cometbft_tpu_torch import crypto as tcrypto
from cometbft_tpu_torch.crypto import batch as tbatch
from cometbft_tpu_torch.crypto import ed25519 as ted
from cometbft_tpu_torch.crypto import sr25519 as tsr
from cometbft_tpu_torch.crypto import sr25519_math as srm
from cometbft_tpu_torch.ops import batch_verifier as TBV
from cometbft_tpu_torch.ops import curve as TC
from cometbft_tpu_torch.ops import ed25519_kernel as TK
from cometbft_tpu_torch.ops import residency as TR
from cometbft_tpu_torch.ops import hashvec
from cometbft_tpu_torch.ops import limbs as TL
from cometbft_tpu_torch.ops import sr25519_kernel as TS
from cometbft_tpu_torch.ops import verify_kernel as VK

CPU = torch.device("cpu")
P, L = srm.P, srm.L

# Message lengths straddling the STROBE rate (166 bytes): the sign-bytes
# absorb crosses zero, one or two permutation boundaries.
LENGTHS = [0, 1, 165, 166, 167, 500]


def _eq(got, want) -> None:
    """Exact equality (integer arithmetic: no tolerance)."""
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _nonsquare_enc() -> bytes:
    """The smallest even canonical encoding that does not decode (its
    square root does not exist)."""
    s = 2
    while srm.ristretto_decode(s.to_bytes(32, "little")) is not None:
        s += 2
    return s.to_bytes(32, "little")


def _set_byte(b: bytes, i: int, v: int) -> bytes:
    out = bytearray(b)
    out[i] = v
    return bytes(out)


def _signed(n: int, tag: bytes):
    privs = [jsr.gen_priv_key_from_secret(tag + b"%d" % i) for i in range(n)]
    pubs = [p.pub_key().bytes_() for p in privs]
    msgs = [b"vote-%s-%d" % (tag, i) for i in range(n)]
    sigs = [p.sign(m) for p, m in zip(privs, msgs)]
    return pubs, msgs, sigs


def _edge_batch(n: int, tag: bytes):
    """n signed lanes whose first 8 are: a tampered s, a signature over
    another message, s >= L, the marker bit cleared, R >= p, R odd, R with
    bit 255 set, and a pubkey that does not decode."""
    pubs, msgs, sigs = _signed(n, tag)
    sigs[0] = _set_byte(sigs[0], 40, sigs[0][40] ^ 4)
    msgs[1] = msgs[1] + b"!"
    s_big = (L + 5).to_bytes(32, "little")
    sigs[2] = sigs[2][:32] + _set_byte(s_big, 31, s_big[31] | 0x80)
    sigs[3] = _set_byte(sigs[3], 63, sigs[3][63] & 0x7F)
    sigs[4] = (P + 1).to_bytes(32, "little") + sigs[4][32:]
    sigs[5] = (3).to_bytes(32, "little") + sigs[5][32:]
    sigs[6] = _set_byte(sigs[6], 31, sigs[6][31] | 0x80)
    pubs[7] = _nonsquare_enc()
    return pubs, msgs, sigs


def _oracle_mask(pubs, msgs, sigs) -> list[bool]:
    return [srm.verify(p, m, s) for p, m, s in zip(pubs, msgs, sigs)]


# ------------------------------------------------------------ hashing


@pytest.mark.parametrize("mlen", LENGTHS)
def test_keccak_strobe_and_challenges_match_jax(mlen):
    rng = np.random.default_rng(1000 + mlen)
    # Keccak-f[1600]: the batch rung against the JAX package's serial one
    states = np.frombuffer(rng.bytes(200 * 5), dtype=np.uint8).reshape(5, 200).copy()
    want = []
    for row in states:
        st = bytearray(row.tobytes())
        jsrm.keccak_f1600(st)
        want.append(bytes(st))
    hashvec.keccak_f1600_many(states.view("<u8"))
    assert [r.tobytes() for r in states] == want

    # the serial and batch STROBE: meta-AD, AD, PRF and KEY of mlen bytes
    rows = np.frombuffer(rng.bytes(4 * mlen), dtype=np.uint8).reshape(4, mlen)
    batch = srm.BatchStrobe128(4, b"proto")
    batch.meta_ad(b"label", False)
    batch.ad(rows, False)
    batch.key(rows[:, ::-1].copy(), False)
    got = batch.prf(64 + mlen)
    for i in range(4):
        outs = []
        for s in (srm.Strobe128(b"proto"), jsrm.Strobe128(b"proto")):
            s.meta_ad(b"label", False)
            s.ad(rows[i].tobytes(), False)
            s.key(rows[i, ::-1].tobytes(), False)
            outs.append(s.prf(64 + mlen))
        assert outs[0] == outs[1] == got[i].tobytes()

    # Merlin challenges: a batch group (>= VEC_MIN_ROWS rows of this
    # length) and a serial straggler group (another length)
    n = srm.VEC_MIN_ROWS + 3
    pubs = [rng.bytes(32) for _ in range(n + 2)]
    r_rows = np.frombuffer(rng.bytes(32 * (n + 2)), dtype=np.uint8).reshape(-1, 32)
    msgs = [rng.bytes(mlen) for _ in range(n)] + [rng.bytes(mlen + 7) for _ in range(2)]
    words = srm.batch_challenge_words_rows(pubs, r_rows, msgs)
    if mlen:
        # the JAX package's batch rung cannot shape a group of empty
        # messages (a reshape of -1 by 0); its serial rung covers mlen 0
        _eq(words, jsrm.batch_challenge_words_rows(pubs, r_rows, msgs))
    for i in range(n + 2):
        k = jsrm.compute_challenge(pubs[i], r_rows[i].tobytes(), msgs[i])
        assert words[i].tobytes() == k.to_bytes(32, "little")
    assert srm.compute_challenge(pubs[0], r_rows[0].tobytes(), msgs[0]) == \
        jsrm.compute_challenge(pubs[0], r_rows[0].tobytes(), msgs[0])


# ------------------------------------------------------------ decoding


def _decode_encodings() -> np.ndarray:
    """Valid pubkeys and the identity, then s >= p, s odd, bit 255 set,
    a non-square, and random bytes."""
    rng = np.random.default_rng(11)
    encs = [jsr.gen_priv_key_from_secret(b"dec%d" % i).pub_key().bytes_() for i in range(4)]
    encs += [bytes(32), (P + 1).to_bytes(32, "little"), (P - 2).to_bytes(32, "little"),
             (3).to_bytes(32, "little"), _set_byte(encs[0], 31, encs[0][31] | 0x80),
             _nonsquare_enc()]
    encs += [rng.bytes(32) for _ in range(2)]
    return np.frombuffer(b"".join(encs), dtype=np.uint8).reshape(-1, 32)


def test_ristretto_decode_matches_jax_and_oracle():
    enc = _decode_encodings()
    words = np.ascontiguousarray(TL.bytes_to_words(enc).T)
    jok, *jc = SRK._decompress_kernel(jnp.asarray(words))
    ok, p = TC.ristretto_decode_device(torch.from_numpy(words.view(np.int32)))
    _eq(ok.numpy(), np.asarray(jok))
    for got, want in zip(p, jc):
        _eq(got.numpy(), np.asarray(want))
    assert ok.tolist() == [srm.ristretto_decode(e.tobytes()) is not None for e in enc]
    assert ok.tolist()[:5] == [True] * 5 and not any(ok.tolist()[5:10])
    # the wrapper takes the plain version on the CPU
    wok, *wc = VK.decompress_sr(torch.from_numpy(words.view(np.int32)))
    assert torch.equal(wok, ok) and all(torch.equal(a, b) for a, b in zip(wc, p))
    # decompress_points (bucketed, zero-padded) equals the JAX package's
    tok, tcoords = TS.decompress_points(enc, CPU)
    jok2, jcoords = SRK.decompress_points(enc)
    _eq(tok, jok2)
    _eq(tcoords, jcoords)


# ------------------------------------------------------------ staging, verify


def test_stage_rows_sr_matches_jax():
    pubs, msgs, sigs = _edge_batch(10, b"st")
    sigs[9] = sigs[9][:63]  # a ragged row: length check fails
    got = TS.stage_rows_sr(pubs, msgs, sigs, 16)
    want = SRK.stage_rows_sr(pubs, msgs, sigs, 16)
    _eq(got[0], want[0])
    assert got[1] == want[1]
    for g, w in zip(got[2:], want[2:]):
        _eq(g, w)
    assert got[0].tolist() == [True, True, False, False, True, True, True, True, True, False]


@pytest.mark.parametrize("n,bucket", [(8, 8), (100, 128)])
def test_verify_math_sr_ok_matches_jax(n, bucket):
    pubs, msgs, sigs = _edge_batch(n, b"vm%d" % n)
    pre_ok, safe, r, s, k = SRK.stage_rows_sr(pubs, msgs, sigs, bucket)
    enc = np.frombuffer(b"".join(safe), dtype=np.uint8).reshape(n, 32)
    ok_a, coords = SRK.decompress_points(enc)
    a = JK.pad_coords_batch_minor(coords, bucket)
    jmask, jall = SRK._verify_kernel_ok(*(jnp.asarray(x) for x in a + (r, s, k)))
    t = TK.staged_from_numpy(*a, r, s, k, device=CPU)
    mask, allok = VK.verify_math_sr_ok(*t)
    _eq(mask.numpy(), np.asarray(jmask))
    assert bool(allok) == bool(jall) is False
    wmask, wall = VK.verify_sr_ok(*t)
    assert torch.equal(wmask, mask) and bool(wall) == bool(allok)
    final = mask.numpy()[:n] & pre_ok & ok_a
    assert final.tolist() == _oracle_mask(pubs, msgs, sigs)
    assert final[:8].tolist() == [False] * 8 and final[8:].all()


def test_verify_batch_and_seam_match_jax_and_oracle():
    pubs, msgs, sigs = _edge_batch(12, b"vb")
    want = _oracle_mask(pubs, msgs, sigs)
    ok, mask = TS.verify_batch(pubs, msgs, sigs, device=CPU)
    # the JAX package's device (XLA) path needs its cache passed explicitly
    jok, jmask = SRK.verify_batch(pubs, msgs, sigs, cache=SRK._default_cache)
    assert mask == jmask == want and ok == jok is False
    v = TBV.SrCUDABatchVerifier(device=CPU)
    for p, m, s in zip(pubs, msgs, sigs):
        v.add(tsr.PubKey(p), m, s)
    assert v.verify() == (False, want) and v.recheck_flips == 0
    with pytest.raises(tcrypto.ErrInvalidKey):
        v.add(ted.PubKey(bytes(32)), b"m", bytes(64))


def test_valid_lane_needing_a_full_carry_ripple_verifies():
    """chip_smoke.RIPPLE_LANE: the JAX package's device path rejects it."""
    pub, msg, sig = (bytes.fromhex(h) for h in CS.RIPPLE_LANE)
    assert srm.verify(pub, msg, sig) and jsrm.verify(pub, msg, sig)
    mask, flips = TK.verify_rows(TS.SR25519, [pub], [msg], [sig],
                                 cache=TK.PubKeyCache(CPU, TS.SR25519))
    assert mask.tolist() == [True] and flips == 0


def test_sr_cache_seeded_from_jax_coords():
    pubs, msgs, sigs = _edge_batch(8, b"pc")
    _, safe, *_ = SRK.stage_rows_sr(pubs, msgs, sigs, 8)
    enc = np.frombuffer(b"".join(safe), dtype=np.uint8).reshape(8, 32)
    ok_a, coords = SRK.decompress_points(enc)
    cache = TK.PubKeyCache(CPU, TS.SR25519)
    cache.load(safe, ok_a, coords)
    mask, flips = TK.verify_rows(TS.SR25519, pubs, msgs, sigs, cache=cache)
    assert mask.tolist() == _oracle_mask(pubs, msgs, sigs) and flips == 0
    # the key table decodes through the cache's host level: every key seeded
    st = cache.stats()
    assert st["host_misses"] == 0 and st["host_hits"] == len(set(safe))
    assert TR.table_for(cache).stats()["delta_rows"] == len(set(safe))
    TK.verify_rows(TS.SR25519, pubs, msgs, sigs, cache=cache)
    table = TR.table_for(cache).stats()
    assert table["delta_rows"] == len(set(safe)) and table["indexed_batches"] == 2
    # an ed25519 cache decodes the same bytes to other points: refused
    with pytest.raises(ValueError, match="ed25519 keys"):
        TK.verify_rows(TS.SR25519, pubs, msgs, sigs, cache=TK.PubKeyCache(CPU))


def test_sr25519_keys_interoperate_with_jax():
    tpriv = tsr.gen_priv_key_from_secret(b"interop")
    jpriv = jsr.gen_priv_key_from_secret(b"interop")
    assert tpriv.pub_key().bytes_() == jpriv.pub_key().bytes_()
    assert tpriv.pub_key().address() == jpriv.pub_key().address()
    msg = b"sign-bytes"
    assert jpriv.pub_key().verify_signature(msg, tpriv.sign(msg))
    assert tpriv.pub_key().verify_signature(msg, jpriv.sign(msg))
    assert not tpriv.pub_key().verify_signature(msg + b"!", tpriv.sign(msg))
    cpu = tsr.CPUBatchVerifier()
    cpu.add(tpriv.pub_key(), msg, tpriv.sign(msg))
    cpu.add(tpriv.pub_key(), msg + b"!", tpriv.sign(msg))
    assert cpu.verify() == (False, [True, False])


def test_mixed_batch_verifier_matches_jax():
    """BASELINE config 5 in miniature: even lanes ed25519, odd lanes
    sr25519, one bad lane in each scheme; the mask comes back in input
    order."""
    n = 12
    jprivs = [jed.gen_priv_key_from_secret(b"mx%d" % i) if i % 2 == 0
              else jsr.gen_priv_key_from_secret(b"mx%d" % i) for i in range(n)]
    msgs = [b"mixed-vote-%d" % i for i in range(n)]
    sigs = [p.sign(m) for p, m in zip(jprivs, msgs)]
    sigs[4] = sigs[2]  # ed25519 lane: another lane's signature
    msgs[7] = msgs[7] + b"!"  # sr25519 lane: another message
    jkeys = [p.pub_key() for p in jprivs]
    tkeys = [ted.PubKey(k.bytes_()) if k.type_() == "ed25519" else tsr.PubKey(k.bytes_())
             for k in jkeys]
    tbatch.set_backend("cpu")
    try:
        v = tbatch.create_mixed_batch_verifier()
        for key, m, s in zip(tkeys, msgs, sigs):
            v.add(key, m, s)
        ok, mask = v.verify()
    finally:
        tbatch.set_backend("gpu")
    jv = jbatch.MixedBatchVerifier()
    for key, m, s in zip(jkeys, msgs, sigs):
        jv.add(key, m, s)
    jok, jmask = jv.verify()
    assert (ok, mask) == (jok, jmask)
    assert [i for i in range(n) if not mask[i]] == [4, 7]
    assert v.count() == n and v.recheck_flips == 0
