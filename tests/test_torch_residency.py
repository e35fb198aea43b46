"""The port's device-resident key tables (ops/residency.py KeyTable) against
the JAX package's KeyTable fed the same keys in the same order: gathered A
coordinates, encoding words and ok flags equal bit for bit, the same rows
taken and evicted. Covered: the delta insert, the indexed steady state, LRU
eviction, rows protected by the batch being staged, overflow to the full
path, and the identity row of padding lanes. Both tables run on the CPU
(JAX_PLATFORMS=cpu; the port's plain decoder).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from cometbft_tpu.ops import ed25519_kernel as JK
from cometbft_tpu.ops import residency as JR
from cometbft_tpu_torch.crypto import ed25519 as ted
from cometbft_tpu_torch.ops import ed25519_kernel as TK
from cometbft_tpu_torch.ops import residency as TR

ROWS = 16  # 15 usable rows and the identity row
NO_SQRT = (2).to_bytes(32, "little")  # y = 2: no curve point, ok False


@pytest.fixture(scope="module")
def keys():
    return [ted.gen_priv_key_from_secret(b"res-%d" % i).pub_key().bytes_() for i in range(24)]


@pytest.fixture
def tables():
    TR.reset()
    JR.reset()
    return TR.KeyTable(TK.PubKeyCache("cpu"), ROWS), JR.KeyTable("ed25519", JK.PubKeyCache(), ROWS)


def _stage_both(tables, pubs, bucket):
    """Stage on both tables; assert equal gathers; return the port's ok."""
    t, j = tables
    tok, tcoords, tenc, tbytes = t.stage(pubs, bucket, want_enc=True)
    jok, jcoords, jenc, jbytes = j.stage(pubs, bucket, want_enc=True)
    np.testing.assert_array_equal(tok, jok)
    for a, b in zip(tcoords, jcoords):
        assert tuple(a.shape) == (20, bucket)
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(tenc.numpy().view(np.uint32), np.asarray(jenc))
    assert tbytes == jbytes == 2 * bucket
    return tok


def _same_rows(tables, pubs):
    t, j = tables
    assert t.rows_of(pubs) == [j._rows[p] for p in pubs]
    assert list(t._rows) == list(j._rows)  # the same LRU order


def test_delta_insert_then_indexed(tables, keys):
    pubs = keys[:5] + [NO_SQRT] + keys[:2]  # repeats and an undecodable key
    ok = _stage_both(tables, pubs, 8)
    assert ok.tolist() == [True] * 5 + [False] + [True] * 2
    _same_rows(tables, pubs)
    st = tables[0].stats()
    assert st["delta_rows"] == 6 and st["delta_updates"] == 1 and st["indexed_batches"] == 1
    _stage_both(tables, pubs[::-1], 8)  # all resident: no delta
    st = tables[0].stats()
    assert st["delta_rows"] == 6 and st["indexed_batches"] == 2


def test_identity_pad_lanes(tables, keys):
    t, _ = tables
    _stage_both(tables, keys[:3], 8)
    _, coords, enc, _ = t.stage(keys[:3], 8, want_enc=True)
    for c, want in zip(coords, (0, 1, 1, 0)):  # X=0, Y=1, Z=1, T=0
        assert (c[1:, 3:] == 0).all() and (c[0, 3:] == want).all()
    assert (enc[0, 3:] == 1).all() and (enc[1:, 3:] == 0).all()
    assert t.id_row == ROWS - 1


def test_lru_eviction_matches(tables, keys):
    for lo in range(0, 15, 5):  # fill the 15 usable rows, 5 at a time
        _stage_both(tables, keys[lo:lo + 5], 8)
    _stage_both(tables, keys[0:3], 8)  # touch 0-2: 3-7 are now the oldest
    _stage_both(tables, keys[15:19], 8)  # 4 unseen keys evict 3, 4, 5, 6
    _same_rows(tables, keys[15:19] + keys[0:3] + keys[7:15])
    t, j = tables
    assert t.stats()["evictions"] == j.stats()["evictions"] == 4
    assert not set(keys[3:7]) & set(t._rows)


def test_batch_rows_protected_then_full_path(tables, keys):
    for lo in range(0, 15, 5):
        _stage_both(tables, keys[lo:lo + 5], 8)
    _stage_both(tables, keys[10:15], 8)  # 0-9 are now the oldest rows
    # 10 resident keys and 5 unseen: room is made from the 5 rows outside
    # the batch, never from the batch's own (older) rows
    _stage_both(tables, keys[:10] + keys[15:20], 16)
    t, j = tables
    assert set(t._rows) == set(j._rows) == set(keys[:10] + keys[15:20])
    assert t.stats()["evictions"] == j.stats()["evictions"] == 5
    # 16 unique keys exceed the 15 rows: both refuse, the rows stay
    with pytest.raises(TR._NoRoom):
        t.stage(keys[:16], 16)
    with pytest.raises(JR._NoRoom):
        j.stage(keys[:16], 16)
    _same_rows(tables, keys[:10] + keys[15:20])


def test_overflow_takes_full_path(keys):
    """A table of rows=64 holds 63 keys: 64 unique keys overflow it and the
    batch takes the unique-key full path, whose gathers equal those of a
    table that holds them, encoding words and identity padding included."""
    many = keys + [ted.gen_priv_key_from_secret(b"res-%d" % i).pub_key().bytes_()
                   for i in range(len(keys), 64)]
    small, large = TK.PubKeyCache("cpu"), TK.PubKeyCache("cpu")
    TR.reset()
    TR.configure(rows=64)
    try:
        assert TR.stage(small, many[:63], 64) is not None
        assert TR.stage(small, many, 64) is None
    finally:
        TR.configure(rows=16384)
    pubs = many + [many[0], NO_SQRT]
    bucket = TK.bucket_size(len(pubs))
    ok_i, a_i, enc_i, path_i, _ = TK._stage_gather(large, pubs, bucket, want_enc=True)
    ok_f, a_f, enc_f, path_f, nbytes = TK._stage_gather(small, pubs, bucket, want_enc=True)
    assert (path_i, path_f, nbytes) == ("indexed", "full", 4 * bucket)
    assert ok_f.tolist() == ok_i.tolist() == [True] * 65 + [False]
    for a, b in zip(a_i + (enc_i,), a_f + (enc_f,)):
        assert tuple(b.shape) == tuple(a.shape) and b.dtype == a.dtype == torch.int32
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert TR.send_stats()["full"]["sends"] == 1 and TR.send_stats()["delta"]["sends"] >= 1
    TR.reset()


# ------------------------------------------------------------ epoch pins


def _announced(sets: list[tuple[bytes, list[bytes]]]) -> dict:
    import hashlib

    return {h: (hashlib.sha256(b"".join(ks)).digest(), tuple(ks)) for h, ks in sets}


def test_pinned_set_survives_rider_churn_like_reference(tables, keys):
    """An announced set of 8 keys is pinned; 16 rider keys pass through the
    7 rows left, evicting one another but never a pinned row, in both
    tables, with equal gathers."""
    t, j = tables
    ann = _announced([(b"set", keys[:8])])
    for tbl in (t, j):
        tbl.stage(keys[:2], 8, announced=ann)
    pinned = t.rows_of(keys[:8])
    assert pinned == [j._rows[k] for k in keys[:8]]
    for i in range(8, 24, 4):
        got = t.stage(keys[i:i + 4], 8, announced=ann)
        want = j.stage(keys[i:i + 4], 8, announced=ann)
        for a, b in zip(got[1], want[1]):
            assert np.array_equal(a.numpy(), np.asarray(b))
    assert t.rows_of(keys[:8]) == pinned == [j._rows[k] for k in keys[:8]]
    assert t.stats()["pinned_rows"] == j.stats()["pinned_rows"] == 8
    assert t.stats()["evictions"] == j.counters["evictions"] > 0


def test_hash_mismatch_unpins_and_uploads_again_like_reference(tables, keys):
    t, j = tables
    for tbl in (t, j):
        tbl.stage(keys[:2], 8, announced=_announced([(b"h", keys[:4])]))
        tbl.stage(keys[:2], 8, announced=_announced([(b"h", keys[4:8])]))
    for k in ("hash_mismatches", "full_set_uploads"):
        assert t.counters[k] == j.counters[k] == 1
    assert t.pinned() == {b"h": 4}
    assert TR.send_stats()["full"]["sends"] == 1


def test_two_sets_too_large_together_do_not_evict_each_other(tables, keys):
    """Two announced sets of 10 keys cannot both pin in 15 rows. The newest
    stays pinned and batch after batch nothing is uploaded again; the JAX
    package's table, reconciling at every batch oldest first, re-uploads a
    set each batch (ROADMAP Queue 3)."""
    t, j = tables
    ann = _announced([(b"old", keys[:10]), (b"new", keys[10:20])])
    for _ in range(3):
        t.stage(keys[10:12], 8, announced=ann, version=1)
        j.stage(keys[10:12], 8, announced=ann)
    assert t.pinned() == {b"new": 10}
    assert t.counters["delta_updates"] == 1
    assert j.counters["delta_updates"] >= 4
    # a new announcement version reconciles again: the same choice, no upload
    t.stage(keys[10:12], 8, announced=ann, version=2)
    assert t.pinned() == {b"new": 10} and t.counters["delta_updates"] == 1


def test_announce_validator_set_stamps_the_object(keys):
    TR.reset()

    class Vals:
        def __init__(self):
            self.validators = []
            self.hashes = 0

        def hash(self):
            self.hashes += 1
            return b"vals"

    class V:
        def __init__(self, k):
            self.pub_key = ted.PubKey(k)

    vals = Vals()
    vals.validators = [V(k) for k in keys[:5]]
    TR.announce_validator_set(vals)
    TR.announce_validator_set(vals)
    assert vals.hashes == 1 and vals._wire_announced
    cache = TK.PubKeyCache("cpu")
    TR.stage(cache, keys[:1], 8)
    assert TR.table_for(cache).pinned() == {b"vals": 5}
    TR.clear_announced()
    TR.stage(cache, keys[:1], 8)
    assert TR.table_for(cache).pinned() == {}
    TR.reset()
