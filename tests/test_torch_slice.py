"""The port's staging and reduced-fetch path as a whole, on the CPU, against
the JAX package's verify_batch (verify_batch_async with an explicit cache)
on the same commits: masks equal bit for bit, and the port's path counters
say which path ran.

  factored commit   sign-bytes as SharedPrefixRows (the JAX package's
                    Commit.vote_sign_bytes_all, carried over into the
                    port's class): the device-challenge path, k derived by
                    the plain version of K5, header by K6's;
  plain commit      the same rows as bytes: the classic path (host k
                    through the native rungs);
  mixed commit      ed25519 and sr25519 validators interleaved, factored,
                    through the port's mixed verifier;
each with tampered lanes, and an untampered one for the happy header.
"""

from __future__ import annotations

import hashlib

import numpy as np
import pytest

from cometbft_tpu.crypto import ed25519 as jed
from cometbft_tpu.crypto import sr25519 as jsr
from cometbft_tpu.ops import challenge as JC
from cometbft_tpu.ops import dispatch as JD
from cometbft_tpu.ops import ed25519_kernel as JK
from cometbft_tpu.ops import residency as JR
from cometbft_tpu.ops import sr25519_kernel as SRK
from cometbft_tpu.types.basic import BlockID, BlockIDFlag, PartSetHeader
from cometbft_tpu.types.commit import Commit, CommitSig
from cometbft_tpu.utils import cmttime
from cometbft_tpu_torch.crypto import batch as tbatch
from cometbft_tpu_torch.crypto import ed25519 as ted
from cometbft_tpu_torch.crypto import sr25519 as tsr
from cometbft_tpu_torch.libs.prefixrows import PrefixedMsg, SharedPrefixRows
from cometbft_tpu_torch.ops import challenge as TC
from cometbft_tpu_torch.ops import ed25519_kernel as TK
from cometbft_tpu_torch.ops import hashvec as TH
from cometbft_tpu_torch.ops import residency as TR

N = 8  # bucket 8: the JAX reference compiles its programs at one small shape


@pytest.fixture(autouse=True)
def _fresh():
    for m in (TC, TR, JC, JR):
        m.reset()
    tbatch.reset_path_stats()
    JD.reset_supervision()
    tbatch.set_backend("cpu")
    yield
    tbatch.set_backend("gpu")
    for m in (TC, TR):
        m.reset()


def _commit(privs, tag: bytes):
    """Real sign-bytes of a commit of len(privs) validators
    (Commit.vote_sign_bytes_all of the JAX package), signed. Returns (pubs,
    the JAX package's factored rows, the port's factored rows, sigs)."""
    n = len(privs)
    block_id = BlockID(hash=hashlib.sha256(tag).digest(),
                       part_set_header=PartSetHeader(1, b"\x22" * 32))
    csigs = [CommitSig(block_id_flag=BlockIDFlag.COMMIT,
                       validator_address=p.pub_key().address(),
                       timestamp=cmttime.Timestamp(1_700_000_000, (1 << 28) + 1000 * i))
             for i, p in enumerate(privs)]
    rows = Commit(height=7, round_=0, block_id=block_id,
                  signatures=csigs).vote_sign_bytes_all("slice-chain")
    assert not rows.exceptions
    trows = SharedPrefixRows(rows.prefix, list(rows.suffixes))
    sigs = [p.sign(rows[i]) for i, p in enumerate(privs)]
    return ([p.pub_key().bytes_() for p in privs], rows.rows_for(range(n)),
            trows.rows_for(range(n)), sigs)


def _tamper(msgs_j, msgs_t, sigs, idx: list[int]) -> None:
    """A flipped s bit, another timestamp (same length), a flipped R bit."""
    for j, i in enumerate(idx):
        if j % 3 == 0:
            sigs[i] = sigs[i][:33] + bytes([sigs[i][33] ^ 1]) + sigs[i][34:]
        elif j % 3 == 1:
            sfx = bytearray(msgs_t[i].suffix)
            sfx[3] ^= 1
            msgs_t[i] = PrefixedMsg(msgs_t[i].prefix, bytes(sfx))
            msgs_j[i] = type(msgs_j[i])(msgs_j[i].prefix, bytes(sfx))
        else:
            sigs[i] = sigs[i][:5] + bytes([sigs[i][5] ^ 0x10]) + sigs[i][6:]


def _verify_port(key_cls, pubs, msgs, sigs):
    v = tbatch.create_batch_verifier(key_cls(pubs[0]))
    for p, m, s in zip(pubs, msgs, sigs):
        v.add(key_cls(p), m, s)
    ok, mask = v.verify()
    assert v.recheck_flips == 0
    return ok, mask


def test_factored_commit_takes_device_challenge_path():
    privs = [jed.gen_priv_key_from_secret(b"slice-%d" % i) for i in range(N)]
    pubs, msgs_j, msgs_t, sigs = _commit(privs, b"factored")
    bad = [1, 4, 6]
    _tamper(msgs_j, msgs_t, sigs, bad)
    ok, mask = _verify_port(ted.PubKey, pubs, msgs_t, sigs)
    assert [i for i in range(N) if not mask[i]] == bad
    jok, jmask = JK.verify_batch(pubs, msgs_j, sigs, cache=JK.PubKeyCache())
    assert mask == jmask and ok == jok is False
    st = tbatch.path_stats()
    assert st["challenge"] == {"plans": 1, "lanes_device": N, "lanes_host_fallback": 0}
    assert st["fetch"]["full_fetches"] == 1 and st["fetch"]["happy_fetches"] == 0
    assert st["sends"]["indexed"]["sigs"] == N and st["hash_rung"] == TH.active_rung()
    # the untampered commit: the 8-byte header alone crosses back
    pubs, msgs_j, msgs_t, sigs = _commit(privs, b"factored")
    ok, mask = _verify_port(ted.PubKey, pubs, msgs_t, sigs)
    assert ok and mask == JK.verify_batch(pubs, msgs_j, sigs, cache=JK.PubKeyCache())[1]
    st = tbatch.path_stats()
    assert st["fetch"]["happy_fetches"] == 1 and st["challenge"]["plans"] == 2
    assert TR.table_for(TK.default_cache("cpu")).stats()["indexed_batches"] >= 2


def test_plain_commit_takes_classic_path():
    privs = [jed.gen_priv_key_from_secret(b"slice-%d" % i) for i in range(N)]
    pubs, msgs_j, _, sigs = _commit(privs, b"plain")
    msgs = [bytes(m) for m in msgs_j]
    bad = [0, 3, 7]
    sigs[0] = sigs[0][:33] + bytes([sigs[0][33] ^ 1]) + sigs[0][34:]
    msgs[3] = msgs[3][:-1] + bytes([msgs[3][-1] ^ 1])
    sigs[7] = sigs[6]
    ok, mask = _verify_port(ted.PubKey, pubs, msgs, sigs)
    assert [i for i in range(N) if not mask[i]] == bad
    assert (ok, mask) == JK.verify_batch(pubs, msgs, sigs, cache=JK.PubKeyCache())
    st = tbatch.path_stats()
    assert "plans" not in st["challenge"] and st["challenge"]["plan_oversize_var"] == 1
    assert st["fetch"]["full_fetches"] == 1


def test_key_table_overflow_keeps_the_device_challenge():
    """A factored commit with more unique keys than the key table has rows
    takes the full key path, and k is still derived on the device (the
    unique keys' encoding words ride with their coordinates): the same mask
    as through a table that holds the keys."""
    n = 64
    privs = [jed.gen_priv_key_from_secret(b"slice-%d" % i) for i in range(n)]
    pubs, msgs_j, msgs_t, sigs = _commit(privs, b"full")
    _tamper(msgs_j, msgs_t, sigs, [2, 40])
    held = _verify_port(ted.PubKey, pubs, msgs_t, sigs)
    assert tbatch.path_stats()["sends"]["indexed"]["sigs"] == n
    TR.reset()
    TC.reset()
    tbatch.reset_path_stats()
    TR.configure(rows=64)  # 63 rows for keys: 64 unique keys overflow
    try:
        over = _verify_port(ted.PubKey, pubs, msgs_t, sigs)
    finally:
        TR.configure(rows=16384)
    assert over == held and [i for i in range(n) if not over[1][i]] == [2, 40]
    st = tbatch.path_stats()
    assert st["challenge"] == {"plans": 1, "lanes_device": n, "lanes_host_fallback": 0}
    assert st["sends"]["full"]["sigs"] == n and st["sends"]["indexed"]["sigs"] == 0


def test_mixed_commit_matches_jax_per_scheme():
    privs = []
    for i in range(2 * N):
        gen = jed.gen_priv_key_from_secret if i % 2 == 0 else jsr.gen_priv_key_from_secret
        privs.append(gen(b"mixed-%d" % i))
    pubs, msgs_j, msgs_t, sigs = _commit(privs, b"mixed")
    bad = [2, 5, 8, 11]
    _tamper(msgs_j, msgs_t, sigs, bad)
    v = tbatch.create_mixed_batch_verifier()
    for i, (p, m, s) in enumerate(zip(pubs, msgs_t, sigs)):
        v.add((ted.PubKey if i % 2 == 0 else tsr.PubKey)(p), m, s)
    ok, mask = v.verify()
    assert not ok and v.recheck_flips == 0
    assert [i for i in range(2 * N) if not mask[i]] == bad
    jed_mask = JK.verify_batch(pubs[0::2], msgs_j[0::2], sigs[0::2], cache=JK.PubKeyCache())[1]
    jsr_mask = SRK.verify_batch(pubs[1::2], msgs_j[1::2], sigs[1::2],
                                cache=SRK._default_cache)[1]
    assert mask[0::2] == jed_mask and mask[1::2] == jsr_mask
    st = tbatch.path_stats()
    # ed25519 derives its k on the device; sr25519 stays classic (Merlin)
    assert st["challenge"]["plans"] == 1 and st["challenge"]["lanes_device"] == N
    # both schemes' batches resolve with one fetch
    assert st["sends"]["indexed"]["sigs"] == 2 * N and st["fetch"]["full_fetches"] == 1
