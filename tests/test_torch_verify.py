"""The port's verify path (cometbft_tpu_torch) against the JAX package's and
the ZIP-215 oracle: staging, pubkey decompression, verify_math_ok on staged
batches (buckets 8 and 128) with a set of bad lanes, the pubkey cache, the
BatchVerifier seam on a 150-validator commit, and the port's import and
device rules.

All arithmetic is integer, so every comparison is exact equality: masks,
all-ok flags, packed words and limbs.

JAX's CPU reference for the Pallas verify kernel is its XLA twin
``ed25519_kernel.verify_math_ok``; the CUDA kernels themselves are held
against the port's plain versions on the card
(tests/test_torch_kernels_cuda.py and chip_smoke.py).
"""

from __future__ import annotations

import hashlib
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cometbft_tpu.crypto import ed25519 as jed
from cometbft_tpu.ops import ed25519_kernel as JK
from cometbft_tpu.types.basic import BlockID, BlockIDFlag, PartSetHeader
from cometbft_tpu.types.commit import Commit, CommitSig
from cometbft_tpu.utils import cmttime
from cometbft_tpu_torch.crypto import batch as tbatch
from cometbft_tpu_torch.crypto import ed25519 as ted
from cometbft_tpu_torch.crypto import ed25519_math as oracle
from cometbft_tpu_torch.ops import ed25519_kernel as TK
from cometbft_tpu_torch.ops import residency as TR
from cometbft_tpu_torch.ops import verify_kernel as VK

REPO = pathlib.Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")

_IDENT = (1).to_bytes(32, "little")
_NONCANON_IDENT = (oracle.P + 1).to_bytes(32, "little")  # y = p + 1 = 1 mod p
_NO_SQRT = (2).to_bytes(32, "little")  # y = 2 is not on the curve


def _signed(n: int, tag: bytes):
    privs = [jed.gen_priv_key_from_secret(tag + b"%d" % i) for i in range(n)]
    pubs = [p.pub_key().bytes_() for p in privs]
    msgs = [b"vote-%s-%d" % (tag, i) for i in range(n)]
    sigs = [p.sign(m) for p, m in zip(privs, msgs)]
    return pubs, msgs, sigs


def _bad_lane_batch(n: int, tag: bytes):
    """n signed lanes whose first 7 are: a tampered signature, a signature
    over another message, s >= L, non-canonical y for A and R (ZIP-215
    accepts), a small-order pubkey (the identity; valid), R that fails
    decompression, and a pubkey that fails decompression."""
    pubs, msgs, sigs = _signed(n, tag)
    sigs[0] = sigs[0][:40] + bytes([sigs[0][40] ^ 1]) + sigs[0][41:]
    msgs[1] = msgs[1] + b"!"
    sigs[2] = sigs[2][:32] + (oracle.L + 3).to_bytes(32, "little")
    pubs[3], sigs[3] = _NONCANON_IDENT, _NONCANON_IDENT + bytes(32)
    pubs[4], sigs[4] = _IDENT, _IDENT + bytes(32)
    sigs[5] = _NO_SQRT + sigs[5][32:]
    pubs[6] = _NO_SQRT
    return pubs, msgs, sigs


def _oracle_mask(pubs, msgs, sigs) -> list[bool]:
    return [oracle.verify_zip215(p, m, s) for p, m, s in zip(pubs, msgs, sigs)]


def _jax_staged(pubs, msgs, sigs, bucket: int):
    """The JAX package's staging and decompression, as in
    __graft_entry__._prep_batch: numpy arrays."""
    pre_ok, safe, r, s, k = JK.stage_batch(pubs, msgs, sigs, bucket)
    enc = np.frombuffer(b"".join(safe), dtype=np.uint8).reshape(len(pubs), 32)
    ok_a, coords = JK.decompress_points(enc)
    return pre_ok, safe, ok_a, coords, (r, s, k)


@pytest.mark.parametrize("n,bucket", [(8, 8), (100, 128)])
def test_verify_math_ok_matches_jax(n, bucket):
    pubs, msgs, sigs = _bad_lane_batch(n, b"vm%d" % n)
    pre_ok, _, ok_a, coords, words = _jax_staged(pubs, msgs, sigs, bucket)
    a = JK.pad_coords_batch_minor(coords, bucket)
    jmask, jall = JK._verify_kernel_ok(*(jnp.asarray(x) for x in a + words))
    t = TK.staged_from_numpy(*a, *words, device=CPU)
    mask, allok = VK.verify_math_ok(*t)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    assert bool(allok) == bool(jall) is False
    # the wrapper takes the plain version for CPU tensors
    wmask, wall = VK.verify_ok(*t)
    assert torch.equal(wmask, mask) and bool(wall) == bool(allok)
    # after the host masks, the lanes equal the oracle
    final = mask.numpy()[:n] & pre_ok & ok_a
    assert final.tolist() == _oracle_mask(pubs, msgs, sigs)
    assert final[:7].tolist() == [False, False, False, True, True, False, False]


def test_staging_and_decompression_match_jax():
    pubs, msgs, sigs = _bad_lane_batch(8, b"st")
    pre_ok, safe, ok_a, coords, words = _jax_staged(pubs, msgs, sigs, 8)
    tpre, tsafe, *twords = TK.stage_batch(pubs, msgs, sigs, 8)
    np.testing.assert_array_equal(tpre, pre_ok)
    assert tsafe == safe
    for got, want in zip(twords, words):
        np.testing.assert_array_equal(got, want)
    enc = np.frombuffer(b"".join(safe), dtype=np.uint8).reshape(8, 32)
    tok, tcoords = TK.decompress_points(enc, CPU)
    np.testing.assert_array_equal(tok, ok_a)
    np.testing.assert_array_equal(tcoords, coords)
    assert TK.bucket_size(150) == JK.bucket_size(150) == 256
    assert TK.bucket_size(10_240) == JK.bucket_size(10_240) == 10_240


def test_pubkey_cache_seeded_from_jax_coords():
    pubs, msgs, sigs = _bad_lane_batch(8, b"pc")
    _, safe, ok_a, coords, _ = _jax_staged(pubs, msgs, sigs, 8)
    cache = TK.PubKeyCache(CPU)
    cache.load(safe, ok_a, coords)
    mask, flips = TK.verify_rows(TK.ED25519, pubs, msgs, sigs, cache=cache)
    assert mask.tolist() == _oracle_mask(pubs, msgs, sigs) and flips == 0
    # the key table decodes through the cache's host level: every key seeded
    st = cache.stats()
    assert st["host_misses"] == 0 and st["host_hits"] == len(set(safe))
    table = TR.table_for(cache).stats()
    assert table["delta_rows"] == len(set(safe)) and table["indexed_batches"] == 1
    mask2, _ = TK.verify_rows(TK.ED25519, pubs, msgs, sigs, cache=cache)
    table = TR.table_for(cache).stats()
    assert table["delta_rows"] == len(set(safe)) and table["indexed_batches"] == 2
    np.testing.assert_array_equal(mask2, mask)


def test_recheck_flips_only_eligible_lanes():
    pubs, msgs, sigs = _signed(3, b"rc")
    mask = np.array([False, True, False])
    eligible = np.array([True, True, False])
    got, flips = TK.recheck_failed_lanes(mask.copy(), eligible, pubs, msgs, sigs)
    assert got.tolist() == [True, True, False] and flips == 1


def _commit_150(chain_id: str):
    """A 150-validator commit: real sign-bytes from the JAX package's
    Commit.vote_sign_bytes_all, each signed by its validator."""
    n = 150
    privs = [jed.gen_priv_key_from_secret(b"seam-%d" % i) for i in range(n)]
    block_id = BlockID(hash=hashlib.sha256(b"blk").digest(),
                       part_set_header=PartSetHeader(1, b"\x22" * 32))
    csigs = [CommitSig(block_id_flag=BlockIDFlag.COMMIT,
                       validator_address=p.pub_key().address(),
                       timestamp=cmttime.Timestamp(1_700_000_000, 1000 * i))
             for i, p in enumerate(privs)]
    commit = Commit(height=7, round_=0, block_id=block_id, signatures=csigs)
    rows = commit.vote_sign_bytes_all(chain_id)
    msgs = [bytes(rows[i]) for i in range(n)]
    sigs = [p.sign(m) for p, m in zip(privs, msgs)]
    return [p.pub_key().bytes_() for p in privs], msgs, sigs


def test_batch_verifier_seam_150_matches_jax_and_oracle():
    pubs, msgs, sigs = _commit_150("seam-chain")
    bad = [0, 17, 77, 149]
    sigs[0] = sigs[0][:33] + bytes([sigs[0][33] ^ 1]) + sigs[0][34:]
    msgs[17] = msgs[17][:-1] + bytes([msgs[17][-1] ^ 1])
    sigs[77] = sigs[76]
    sigs[149] = sigs[149][:32] + (oracle.L + 1).to_bytes(32, "little")
    tbatch.set_backend("cpu")
    try:
        v = tbatch.create_batch_verifier(ted.PubKey(pubs[0]))
        for p, m, s in zip(pubs, msgs, sigs):
            v.add(ted.PubKey(p), m, s)
        ok, mask = v.verify()
    finally:
        tbatch.set_backend("gpu")
    assert not ok and v.recheck_flips == 0
    assert [i for i, good in enumerate(mask) if not good] == bad
    assert mask == _oracle_mask(pubs, msgs, sigs)
    jok, jmask = JK.verify_batch(pubs, msgs, sigs)
    assert mask == jmask and ok == jok


def test_gpu_backend_raises_without_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    key = ted.PubKey(_signed(1, b"g")[0][0])
    assert tbatch.get_backend() == "gpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbatch.create_batch_verifier(key)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TK.verify_batch([key.bytes_()], [b"m"], [bytes(64)])
    with pytest.raises(ValueError):
        tbatch.set_backend("auto")


def test_port_imports_no_jax_and_no_jax_package():
    code = (
        "import pkgutil, importlib, sys\n"
        "import cometbft_tpu_torch\n"
        "for m in pkgutil.walk_packages(cometbft_tpu_torch.__path__, 'cometbft_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'cometbft_tpu' or m.startswith('cometbft_tpu.')]\n"
        "print(len([m for m in sys.modules if m.startswith('cometbft_tpu_torch')]))\n"
        "assert not bad, bad\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 14
