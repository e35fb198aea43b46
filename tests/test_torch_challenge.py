"""The port's device-challenge planning and derivation (ops/challenge.py)
against the JAX package's ops/challenge.py on the CPU: PrefixTable rows and
eviction, plan_batch's fields and reasons, fill_stream's bytes, the plain
derive (the plain version of the challenge kernel K5) against derive_fn run
by JAX and against hashlib with % L, with and without host-k fallback
lanes, and the standalone SHA-512 and mod-L rungs. Bit for bit throughout.
"""

from __future__ import annotations

import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cometbft_tpu.libs.prefixrows import PrefixedMsg as JPrefixedMsg
from cometbft_tpu.ops import challenge as JC
from cometbft_tpu.ops import dispatch as JD
from cometbft_tpu.ops import hashvec as JH
from cometbft_tpu_torch.libs.prefixrows import PrefixedMsg
from cometbft_tpu_torch.ops import challenge as TC

L = 2**252 + 27742317777372353535851937790883648493
PREFIX = b"\x08\x02\x11" + b"H" * 100  # a ~103-byte shared sign-bytes head
TAIL = b"\x32\x09chain-xyz"


@pytest.fixture(autouse=True)
def _fresh():
    TC.reset()
    JC.reset()
    JD.reset_supervision()
    yield
    TC.reset()
    JC.reset()


def _votes(n: int, cls=PrefixedMsg, prefix: bytes = PREFIX):
    """n vote-shaped rows: a shared prefix, 12 timestamp-ish variable
    bytes, a common chain-id tail."""
    return [cls(prefix, b"\x2a\x0c" + i.to_bytes(6, "big") + b"\x00" * 4 + TAIL)
            for i in range(n)]


def _twin(msgs):
    """The same rows in the JAX package's PrefixedMsg (one prefix object
    per run, as SharedPrefixRows builds them)."""
    prefixes: dict[int, bytes] = {}
    out = []
    for m in msgs:
        if isinstance(m, PrefixedMsg):
            p = prefixes.setdefault(id(m.prefix), m.prefix)
            out.append(JPrefixedMsg(p, m.suffix))
        else:
            out.append(m)
    return out


PLAN_FIELDS = ("plen", "tlen", "var", "slen", "n", "n_eligible", "n_fallback")


def _plans(msgs, pre_ok):
    tp = TC.plan_batch(msgs, pre_ok, device="cpu")
    jp = JC.plan_batch(_twin(msgs), pre_ok)
    return tp, jp


def _same_plan(tp, jp):
    assert (tp is None) == (jp is None)
    if tp is None:
        return
    for f in PLAN_FIELDS:
        assert getattr(tp, f) == getattr(jp, f), f
    np.testing.assert_array_equal(tp.pids, jp.pids)
    np.testing.assert_array_equal(tp.eligible, jp.eligible)
    np.testing.assert_array_equal(tp.vbytes, jp.vbytes)
    np.testing.assert_array_equal(tp.dev_tab.numpy(), np.asarray(jp.dev_tab))


def test_prefix_table_rows_and_lru_match_jax():
    t, j = TC.PrefixTable(device="cpu"), JC.PrefixTable()
    rows = [(b"p%03d" % i * 10, b"tail") for i in range(TC.TABLE_ROWS)]
    for p, tl in rows:
        assert t.ensure(p, tl) == j.ensure(p, tl)
    assert t.ensure(*rows[0]) == j.ensure(*rows[0]) == 0  # a hit refreshes row 0
    protect = {1, 2}
    # full table: the oldest rows outside `protect` go first (row 0 was touched)
    for i in range(3):
        assert t.ensure(b"new%d" % i, b"", protect) == j.ensure(b"new%d" % i, b"", protect) == 3 + i
    assert t.ensure(b"x" * 200, b"") is j.ensure(b"x" * 200, b"") is None  # over PREFIX_CAP
    everything = set(range(TC.TABLE_ROWS))
    assert t.ensure(b"none", b"", everything) is j.ensure(b"none", b"", everything) is None
    np.testing.assert_array_equal(t._host, j._host)
    np.testing.assert_array_equal(t.sync().numpy(), np.asarray(j.sync()))
    assert t.stats()["evictions"] == j.stats()["evictions"] == 3


def test_prefix_table_sync_checksum():
    t = TC.PrefixTable(device="cpu")
    t.ensure(PREFIX, TAIL)
    tab = t.sync()
    assert tab[0, :len(PREFIX + TAIL)].numpy().tobytes() == PREFIX + TAIL
    idx = np.array([0, 0], dtype=np.int64)
    vals = t._host[idx]
    assert TC._host_tab_chk(idx, vals) == JC._host_tab_chk(idx, vals)
    fresh = torch.zeros((TC.TABLE_ROWS, TC.PREFIX_CAP), dtype=torch.uint8)
    assert TC._tab_scatter(fresh, torch.from_numpy(idx), torch.from_numpy(vals)) \
        == TC._host_tab_chk(idx, vals)


def test_plan_vote_batch_and_fill_stream_match_jax():
    msgs = _votes(32)
    pre_ok = np.ones(32, dtype=bool)
    tp, jp = _plans(msgs, pre_ok)
    _same_plan(tp, jp)
    assert tp.plen == 103 and tp.tlen >= len(TAIL) and tp.var <= TC.MAX_VAR
    for bucket in (32, 64):
        tb = np.zeros(TC.block_words(bucket, tp.var), dtype=np.uint32)
        jb = np.zeros(JC.block_words(bucket, jp.var), dtype=np.uint32)
        TC.fill_stream(tb, bucket, tp)
        JC.fill_stream(jb, bucket, jp)
        np.testing.assert_array_equal(tb, jb)


def test_plan_mixed_lanes_match_jax():
    msgs = _votes(24)
    msgs[5] = PrefixedMsg(b"other-prefix!", b"odd-suffix-here")
    msgs[9] = b"a plain bytes message....."
    pre_ok = np.ones(24, dtype=bool)
    pre_ok[11] = False
    tp, jp = _plans(msgs, pre_ok)
    _same_plan(tp, jp)
    assert tp.n_eligible == 21 and tp.n_fallback == 2
    assert TC.stats() == {"plans": 1, "lanes_device": 21, "lanes_host_fallback": 2}


def test_plan_reasons_match_jax():
    ok16 = np.ones(16, dtype=bool)
    rng = np.random.default_rng(3)
    cases = {
        "plan_small": (_votes(3), np.ones(3, dtype=bool)),
        "plan_oversize_var": ([PrefixedMsg(b"P" * 40, rng.bytes(60)) for _ in range(16)], ok16),
        "plan_oversize": ([PrefixedMsg(b"P" * 300, b"s" * 8) for _ in range(16)], ok16),
        "plan_no_ok_lanes": (_votes(16), np.zeros(16, dtype=bool)),
        # a commit as plain bytes: the whole row is the suffix, far over MAX_VAR
        "plain_bytes": ([bytes(m) for m in _votes(16)], ok16),
    }
    for reason, (msgs, ok) in cases.items():
        tp, jp = _plans(msgs, ok)
        assert tp is None and jp is None, reason
    st, jst = TC.stats(), JC.stats()
    assert st == jst
    assert st["plan_small"] == 1 and st["plan_oversize"] == 1
    assert st["plan_oversize_var"] == 2 and st["plan_no_ok_lanes"] == 1


def test_plan_snapshot_outlives_later_evictions():
    """A plan's copy of the device table keeps its rows after later plans
    evict them and scatter other rows into the table; a plan whose lanes
    got too few rows takes no copy and syncs nothing."""
    t = TC.PrefixTable(device="cpu")
    rows, snap = t.snapshot([PREFIX] * 4, TAIL, 4)
    body = PREFIX + TAIL
    row = rows[PREFIX]
    for i in range(TC.TABLE_ROWS):
        t.ensure(b"later%d" % i, b"")
    live = t.sync()
    assert (PREFIX, TAIL) not in t._rows
    assert live[row, :len(body)].numpy().tobytes() != body
    assert snap[row, :len(body)].numpy().tobytes() == body
    syncs = t.stats()["syncs"]
    rows, none = t.snapshot([b"x" * 200] * 4, b"", 4)  # over PREFIX_CAP: no row
    assert rows == {b"x" * 200: None} and none is None and t.stats()["syncs"] == syncs


def _derive_inputs(n: int, bucket: int, seed: int):
    rng = np.random.default_rng(seed)
    msgs = _votes(n)
    msgs[7] = PrefixedMsg(b"weird", b"nonconforming-suffix-length")
    pre_ok = np.ones(n, dtype=bool)
    pre_ok[3] = False  # a structurally bad lane: no k at all
    tp, jp = _plans(msgs, pre_ok)
    _same_plan(tp, jp)
    r = rng.integers(0, 256, size=(n, 32), dtype=np.uint8)
    a = rng.integers(0, 256, size=(n, 32), dtype=np.uint8)
    block = np.zeros(TC.block_words(bucket, tp.var), dtype=np.uint32)
    block[:8 * bucket].reshape(8, bucket)[:, :n] = r.view("<u4").T
    TC.fill_stream(block, bucket, tp)
    aw = np.zeros((8, bucket), dtype=np.uint32)
    aw[:, :n] = a.view("<u4").T
    want = np.zeros((8, bucket), dtype=np.uint32)
    for i in range(n):
        if pre_ok[i]:
            d = hashlib.sha512(r[i].tobytes() + a[i].tobytes() + bytes(msgs[i])).digest()
            k = int.from_bytes(d, "little") % L
            want[:, i] = np.frombuffer(k.to_bytes(32, "little"), dtype="<u4")
    return tp, jp, block, aw, want, pre_ok


@pytest.mark.parametrize("with_fallback", [False, True], ids=["fb0", "fb2"])
def test_plain_derive_matches_jax_and_hashlib(with_fallback):
    n, bucket = 24, 32
    tp, jp, block, aw, want, pre_ok = _derive_inputs(n, bucket, 0xDE51)
    lanes = np.flatnonzero(pre_ok & ~tp.eligible)  # lane 7
    fb = 2 if with_fallback else 0
    args, jargs = (), ()
    if fb:
        fidx = np.full(fb, lanes[-1], dtype=np.int32)
        fidx[:lanes.size] = lanes
        fkw = want[:, fidx].copy()
        args = (torch.from_numpy(fkw.view(np.int32)), torch.from_numpy(fidx))
        jargs = (jnp.asarray(fkw), jnp.asarray(fidx))
    else:
        want[:, lanes] = 0  # without the fallback write, k stays 0 there
    got = TC.derive(torch.from_numpy(block.view(np.int32)), torch.from_numpy(aw.view(np.int32)),
                    tp.dev_tab, bucket, tp.var, tp.plen, tp.tlen, *args)
    _, jkw = JC.derive_fn(bucket, jp.var, jp.plen, jp.tlen, fb, False)(
        jnp.asarray(block), jnp.asarray(aw), jp.dev_tab, *jargs)
    got = got.numpy().view(np.uint32)
    np.testing.assert_array_equal(got, np.asarray(jkw))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("length", [0, 1, 111, 112, 239, 240])
def test_standalone_sha512_rows_match_jax_and_hashlib(length):
    rng = np.random.default_rng(length)
    rows = rng.integers(0, 256, size=(9, length), dtype=np.uint8)
    got = TC.sha512_rows_device(rows, device="cpu")
    np.testing.assert_array_equal(got, JH.sha512_rows(rows))
    assert [r.tobytes() for r in got] == [hashlib.sha512(r.tobytes()).digest() for r in rows]
    if length in (111, 112):  # the JAX lane-pair program, one and two blocks
        np.testing.assert_array_equal(got, JC.sha512_rows_device(rows))


def test_standalone_reduce_matches_jax_and_ints():
    rng = np.random.default_rng(8)
    d = rng.integers(0, 256, size=(33, 64), dtype=np.uint8)
    for i, v in enumerate([2**512 - 1, 0, L - 1, L, 3 * L - 1]):
        d[i] = np.frombuffer(v.to_bytes(64, "little"), dtype=np.uint8)
    got = TC.reduce512_mod_l_device(d, device="cpu")
    np.testing.assert_array_equal(got, JC.reduce512_mod_l_device(d))
    for i in range(d.shape[0]):
        assert int.from_bytes(got[i].tobytes(), "little") == \
            int.from_bytes(d[i].tobytes(), "little") % L
