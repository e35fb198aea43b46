"""The port's VoteSet (types/vote_set.py) against the JAX package's on the
same signed votes: serial add_vote against the batch path (add_pending +
flush_pending), the per-vote statuses in order, conflicts (the order of
ErrVoteConflictingVotes.results and .conflicts), the auto-flush boundaries
(batch size, then the 2/3 boundary), vote extensions (a bad extension
signature, a 63-byte one, nil votes, the second batch's rows), a mixed
ed25519 + sr25519 set, and commit_to_vote_set / make_commit /
make_extended_commit bytes. Exact: equal statuses, exception classes and
first lines, and proto bytes.

The port runs on its "cpu" backend (the kernels' plain versions) through
its scheduler, the reference on its "cpu" backend.
"""

from __future__ import annotations

import pytest

from cometbft_tpu.store import blockstore as jblockstore
from cometbft_tpu.types import evidence as jevidence
from cometbft_tpu.types import vote_set as jvs
from cometbft_tpu.types.basic import BlockID, SignedMsgType
from cometbft_tpu.types.commit import CommitSig
from cometbft_tpu_torch.crypto import batch as tbatch
from cometbft_tpu_torch.types import commit as tcommit
from cometbft_tpu_torch.types import evidence as tevidence
from cometbft_tpu_torch.types import vote as tvote
from cometbft_tpu_torch.types import vote_set as tvs
from cometbft_tpu_torch.utils import cmttime as ttime
from tests.torch_consumers import (CHAIN, block_id, first_line, fresh_backends, outcome,
                                   port_vals, priv, signed_commit, tamper_commit, valset, vote)

H, R = 42, 0
PRE = SignedMsgType.PRECOMMIT


@pytest.fixture(autouse=True)
def _fresh():
    yield from fresh_backends()


def _set(n: int, kinds=("ed25519",), tag: bytes = b"vs"):
    jvals, privs = valset([priv(kinds[i % len(kinds)], tag, i) for i in range(n)])
    return jvals, port_vals(jvals), privs


def _t(v):
    return tvote.Vote.from_proto(v.to_proto())


def _bad(v):
    """`v` with one bit of its signature flipped."""
    s = bytearray(v.signature)
    s[40] ^= 1
    v.signature = bytes(s)
    return v


def _pair(jvals, tvals, **kw):
    return (jvs.VoteSet(CHAIN, H, R, PRE, jvals, **kw),
            tvs.VoteSet(CHAIN, H, R, PRE, tvals, **kw))


def _statuses(results):
    return [(v.to_proto(), s) for v, s in results]


def _flush(vset):
    """flush_pending's results and the conflict it raised, if any."""
    try:
        return _statuses(vset.flush_pending()), None
    except (jvs.ErrVoteConflictingVotes, tvs.ErrVoteConflictingVotes) as e:
        return _statuses(e.results), (first_line(e), [
            (c.vote_a.to_proto(), c.vote_b.to_proto()) for c in e.conflicts])


class _BatchSpy:
    """Counts the rows of every batch the port's VoteSet verifies."""

    def __init__(self, monkeypatch):
        self.rows: list[int] = []
        make = tbatch.create_batch_verifier

        def spy(pub_key):
            bv = make(pub_key)
            verify = bv.verify

            def counted():
                self.rows.append(bv.count())
                return verify()
            bv.verify = counted
            return bv
        monkeypatch.setattr(tbatch, "create_batch_verifier", spy)


def test_add_vote_and_batch_path_equal_reference(monkeypatch):
    jvals, tvals, privs = _set(8)
    a = block_id(b"a")
    votes = [vote(privs, i, H, R, a) for i in range(7)] + [vote(privs, 7, H, R, BlockID())]
    _bad(votes[3])
    # serial path: the outcome of every add_vote, then the commit
    js, ts = _pair(jvals, tvals)
    assert [outcome(ts.add_vote, _t(v)) for v in votes] == \
        [outcome(js.add_vote, v) for v in votes]
    assert outcome(ts.add_vote, _t(votes[0])) == outcome(js.add_vote, votes[0]) == ("ok", False)
    # batch path: one flush of everything staged, the same statuses
    spy = _BatchSpy(monkeypatch)
    jb, tb = _pair(jvals, tvals, auto_flush=False)
    assert [tb.add_pending(_t(v)) for v in votes] == [jb.add_pending(v) for v in votes]
    assert _flush(tb) == _flush(jb)
    assert spy.rows == [8]
    assert tb.two_thirds_majority()[0].to_proto() == jb.two_thirds_majority()[0].to_proto() \
        == ts.two_thirds_majority()[0].to_proto()
    commit = jb.make_commit().to_proto()
    assert tb.make_commit().to_proto() == ts.make_commit().to_proto() == commit
    assert tb.bit_array().to_bytes() == jb.bit_array().to_bytes()
    assert (tb.has_two_thirds_any(), tb.has_all(), tb.is_commit()) == \
        (jb.has_two_thirds_any(), jb.has_all(), jb.is_commit())
    # staging errors: exact duplicates, a non-deterministic signature, the
    # wrong step, a short signature, an unknown index
    late = vote(privs, 3, H, R, a)
    other = vote(privs, 3, H, R + 1, a)
    short = vote(privs, 5, H, R, block_id(b"c"))
    short.signature = short.signature[:63]
    for v in (votes[0], _bad(vote(privs, 0, H, R, a)), other, short):
        assert outcome(tb.add_pending, _t(v)) == outcome(jb.add_pending, v)
    assert tb.add_pending(_t(late)) == jb.add_pending(late)
    assert _flush(tb) == _flush(jb)
    stranger = vote(privs, 1, H, R, a)
    stranger.validator_index = 8
    assert outcome(tb.add_pending, _t(stranger)) == outcome(jb.add_pending, stranger)


def test_conflicts_keep_the_reference_order():
    jvals, tvals, privs = _set(6, tag=b"conflict")
    a, b = block_id(b"a"), block_id(b"b")
    staged = [vote(privs, 0, H, R, a), vote(privs, 5, H, R, a), vote(privs, 2, H, R, b),
              vote(privs, 1, H, R, a), vote(privs, 5, H, R, b), vote(privs, 2, H, R, a),
              vote(privs, 3, H, R, a), vote(privs, 4, H, R, a)]
    jb, tb = _pair(jvals, tvals, auto_flush=False)
    for v in staged:
        assert tb.add_pending(_t(v)) == jb.add_pending(v)
    got, want = _flush(tb), _flush(jb)
    assert got == want
    assert [s for _, s in want[0]].count(jvs.FLUSH_CONFLICT) == 2 and want[1] is not None
    assert tb.make_commit().to_proto() == jb.make_commit().to_proto()
    # the conflicts become the same evidence
    tev = tevidence.DuplicateVoteEvidence.new(
        tvote.Vote.from_proto(got[1][1][0][0]), tvote.Vote.from_proto(got[1][1][0][1]),
        ttime.Timestamp(1_700_000_000, 0), tvals)
    jev = jevidence.DuplicateVoteEvidence.new(
        *[type(staged[0]).from_proto(x) for x in want[1][1][0]],
        type(staged[0].timestamp)(1_700_000_000, 0), jvals)
    assert tev.to_proto() == jev.to_proto() and tev.hash() == jev.hash()
    # the serial path raises the same conflict
    js, ts = _pair(jvals, tvals)
    assert [outcome(ts.add_vote, _t(v)) for v in staged] == \
        [outcome(js.add_vote, v) for v in staged]


def test_auto_flush_boundaries_equal_reference(monkeypatch):
    """Batch size 4 on 10 equal validators: a flush at the 4th vote (the
    batch is full), the next at the 7th (the staged tally crosses 2/3)."""
    jvals, tvals, privs = _set(10, tag=b"auto")
    a = block_id(b"a")
    spy = _BatchSpy(monkeypatch)
    jb, tb = _pair(jvals, tvals, batch_flush_size=4)
    trace_t, trace_j = [], []
    for i in range(9):
        v = vote(privs, i, H, R, a)
        tb.add_pending(_t(v))
        jb.add_pending(v)
        trace_t.append((len(tb._pending), tb.sum, tb.has_two_thirds_majority()))
        trace_j.append((len(jb._pending), jb.sum, jb.has_two_thirds_majority()))
    assert trace_t == trace_j
    assert [i for i, (p, _, _) in enumerate(trace_j) if p == 0] == [3, 6]
    assert spy.rows == [4, 3]
    assert _flush(tb) == _flush(jb)
    assert tb.make_commit().to_proto() == jb.make_commit().to_proto()


def test_extensions_equal_reference(monkeypatch):
    """13 validators, extensions on: 0-8 valid with extensions, 9 a bad vote
    signature, 10 a bad extension signature, 11 a 63-byte extension
    signature, 12 a nil vote. The second batch takes only the rows that
    passed the first and are not nil, and not the short signature."""
    jvals, tvals, privs = _set(13, tag=b"ext")
    a = block_id(b"a")
    votes = [vote(privs, i, H, R, a, extension=b"ext-%d" % i) for i in range(12)]
    votes.append(vote(privs, 12, H, R, BlockID()))
    _bad(votes[9])
    votes[10].extension_signature = privs[10].sign(b"something else")
    votes[11].extension_signature = votes[11].extension_signature[:63]
    spy = _BatchSpy(monkeypatch)
    jb, tb = _pair(jvals, tvals, extensions_enabled=True, auto_flush=False)
    for v in votes:
        assert tb.add_pending(_t(v)) == jb.add_pending(v)
    got = _flush(tb)
    assert got == _flush(jb)
    assert [s for _, s in got[0]] == ["added"] * 9 + ["invalid"] * 3 + ["added"]
    assert spy.rows == [13, 10]
    # the extended commit, in the reference block store's encoding
    jec = jb.make_extended_commit()
    data = jblockstore._extended_to_proto(jec)
    tec = tb.make_extended_commit()
    assert tec.to_proto() == data
    assert tcommit.ExtendedCommit.from_proto(data).to_proto() == data
    assert tec.to_commit().to_proto() == jec.to_commit().to_proto()
    for req in (True, False):
        assert outcome(tec.ensure_extensions, req) == outcome(jec.ensure_extensions, req)
    assert tec.get_extended_vote(3).to_proto() == jec.get_extended_vote(3).to_proto()
    # and back into vote sets, every extension verified serially
    assert tvs.extended_commit_to_vote_set(CHAIN, tec, tvals).make_commit().to_proto() == \
        jvs.extended_commit_to_vote_set(CHAIN, jec, jvals).make_commit().to_proto()
    # the serial path's verdicts on the same votes
    js, ts = _pair(jvals, tvals, extensions_enabled=True)
    assert [outcome(ts.add_vote, _t(v)) for v in votes] == \
        [outcome(js.add_vote, v) for v in votes]
    # extension data on a set without extensions is refused
    jn, tn = _pair(jvals, tvals)
    assert outcome(tn.add_pending, _t(votes[0])) == outcome(jn.add_pending, votes[0])


def test_mixed_ed25519_sr25519_set_equals_reference(monkeypatch):
    jvals, tvals, privs = _set(8, kinds=("ed25519", "sr25519"), tag=b"mixed")
    a = block_id(b"a")
    votes = [vote(privs, i, H, R, a) for i in range(8)]
    kinds = [p.pub_key().type_() for p in privs]
    _bad(votes[kinds.index("sr25519")])
    _bad(votes[kinds.index("ed25519")])
    spy = _BatchSpy(monkeypatch)
    jb, tb = _pair(jvals, tvals, auto_flush=False)
    for v in votes:
        tb.add_pending(_t(v))
        jb.add_pending(v)
    got = _flush(tb)
    assert got == _flush(jb)
    assert [s for _, s in got[0]].count("invalid") == 2 and spy.rows == [8]
    assert tb.make_commit().to_proto() == jb.make_commit().to_proto()


def test_commit_to_vote_set_equals_reference():
    jvals, tvals, privs = _set(7, tag=b"c2vs")
    a = block_id(b"a")
    jc = signed_commit(privs, H, a, round_=0, absent=(2,))
    jc.signatures[5] = CommitSig(jc.signatures[5].block_id_flag.NIL,
                                 jc.signatures[5].validator_address,
                                 jc.signatures[5].timestamp)
    jc.signatures[5].signature = privs[5].sign(jc.vote_sign_bytes(CHAIN, 5))
    jc._sign_rows = None
    tc = tcommit.Commit.from_proto(jc.to_proto())
    tset = tvs.commit_to_vote_set(CHAIN, tc, tvals)
    jset = jvs.commit_to_vote_set(CHAIN, jc, jvals)
    assert tset.make_commit().to_proto() == jset.make_commit().to_proto() == jc.to_proto()
    bad_j = tamper_commit(jc, 4)
    bad_t = tcommit.Commit.from_proto(bad_j.to_proto())
    assert outcome(tvs.commit_to_vote_set, CHAIN, bad_t, tvals) == \
        outcome(jvs.commit_to_vote_set, CHAIN, bad_j, jvals)


@pytest.mark.parametrize("chain", [CHAIN, ""])
def test_flush_rows_are_the_reference_sign_bytes(chain):
    """The port's flush stages the rows factored (vote.sign_rows): each row
    the reference's sign bytes, the votes for one block with timestamps of
    one encoded length sharing one prefix object."""
    jvals, tvals, privs = _set(6, tag=b"rows")
    a = block_id(b"a")
    votes = [vote(privs, i, H, R, a if i % 3 else BlockID(), chain=chain) for i in range(6)]
    votes[2].timestamp = type(votes[2].timestamp)(5, 7)  # a shorter encoding
    rows = tvote.sign_rows(chain, [_t(v) for v in votes])
    assert [bytes(r) for r in rows] == [v.sign_bytes(chain) for v in votes]
    assert len({id(rows[i].prefix) for i in (1, 4, 5)}) == 1
    assert len({id(r.prefix) for r in rows}) == 3  # nil; block a; block a, short timestamp
