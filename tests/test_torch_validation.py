"""The port's commit verification (types/validation.py: verify_commit,
verify_commit_light, verify_commit_light_trusting, the staged windows)
against the JAX package's on the same signed commits: the same outcome,
which is both passing or the same exception class with the same message
(wrong signature (#i), not enough voting power got/needed, wrong set size,
height or block ID, double vote).

The port runs on its "cpu" backend (the kernels' plain versions) through
its scheduler. The reference runs with its scheduler enabled, on its "tpu"
backend (XLA on the CPU) at the 8-lane bucket, and on its "cpu" backend at
150 validators. No fallback: without a card the "gpu" backend raises, and
a launch that fails propagates out of verify_commit and out of an inline
drain instead of being verified on the host.
"""

from __future__ import annotations

import dataclasses
import hashlib

import pytest
import torch

from cometbft_tpu import sched as jsched
from cometbft_tpu.crypto import batch as jbatch
from cometbft_tpu.crypto import ed25519 as jed
from cometbft_tpu.crypto import sr25519 as jsr
from cometbft_tpu.ops import challenge as JC
from cometbft_tpu.ops import dispatch as JD
from cometbft_tpu.ops import residency as JR
from cometbft_tpu.types import basic as jbasic
from cometbft_tpu.types import commit as jcommit
from cometbft_tpu.types import validation as jval
from cometbft_tpu.types import validator as jvalidator
from cometbft_tpu.utils import cmttime as jtime
from cometbft_tpu_torch import sched as tsched
from cometbft_tpu_torch.crypto import batch as tbatch
from cometbft_tpu_torch.crypto import ed25519 as ted
from cometbft_tpu_torch.crypto import sr25519 as tsr
from cometbft_tpu_torch.ops import challenge as TC
from cometbft_tpu_torch.ops import ed25519_kernel as TK
from cometbft_tpu_torch.ops import residency as TR
from cometbft_tpu_torch.types import basic as tbasic
from cometbft_tpu_torch.types import commit as tcommit
from cometbft_tpu_torch.types import validation as tval
from cometbft_tpu_torch.types import validator as tvalidator
from cometbft_tpu_torch.utils import cmttime as ttime

CHAIN = "validation-chain"
HEIGHT = 4321


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The plain versions' small tensors run faster on one intra-op thread,
    and the parallel test workers then do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fresh():
    for m in (TC, TR, JC, JR):
        m.reset()
    JD.reset_supervision()
    tsched.reset()
    jsched.reset()
    tsched.configure(enabled=True)
    tbatch.set_backend("cpu")
    yield
    tsched.reset()
    jsched.reset()
    tbatch.set_backend("gpu")
    jbatch.set_backend("auto")
    for m in (TC, TR):
        m.reset()


@dataclasses.dataclass
class Pair:
    """One signed commit and its validator set, in both packages."""

    tvals: tvalidator.ValidatorSet
    jvals: jvalidator.ValidatorSet
    tc: tcommit.Commit
    jc: jcommit.Commit
    tbid: tbasic.BlockID
    jbid: jbasic.BlockID

    def set_sig(self, i: int, sig: bytes) -> None:
        self.tc.signatures[i].signature = sig
        self.jc.signatures[i].signature = sig

    def absent(self, i: int) -> None:
        self.tc.signatures[i] = tcommit.CommitSig.absent()
        self.jc.signatures[i] = jcommit.CommitSig.absent()


_KEYS: dict = {}


def _key(kind: str, i: int):
    k = (kind, i)
    if k not in _KEYS:
        mod = ted if kind == "ed25519" else tsr
        _KEYS[k] = mod.gen_priv_key_from_secret(b"validation-%s-%d" % (kind.encode(), i))
    return _KEYS[k]


def _pair(n: int, scheme: str, height: int = HEIGHT, tag: bytes = b"b",
          nil: tuple = (), short_ts: tuple = ()) -> Pair:
    privs = [_key(scheme if scheme != "mixed" else ("ed25519", "sr25519")[i % 2], i)
             for i in range(n)]
    tvs, jvs, by_addr = [], [], {}
    for p in privs:
        pub = p.pub_key()
        jpub = (jed.PubKey if pub.type_() == "ed25519" else jsr.PubKey)(pub.bytes_())
        tvs.append(tvalidator.Validator.new(pub, 10))
        jvs.append(jvalidator.Validator.new(jpub, 10))
        by_addr[pub.address()] = p
    tvals, jvals = tvalidator.ValidatorSet(tvs), jvalidator.ValidatorSet(jvs)
    h, psh = hashlib.sha256(tag).digest(), hashlib.sha256(tag + b"/parts").digest()
    tbid = tbasic.BlockID(h, tbasic.PartSetHeader(2, psh))
    jbid = jbasic.BlockID(h, jbasic.PartSetHeader(2, psh))
    tsigs = []
    for i, v in enumerate(tvals.validators):
        nanos = 1000 + i if i in short_ts else (1 << 28) + 7 * i
        flag = tbasic.BlockIDFlag.NIL if i in nil else tbasic.BlockIDFlag.COMMIT
        tsigs.append(tcommit.CommitSig(flag, v.address, ttime.Timestamp(1_700_000_000, nanos)))
    tc = tcommit.Commit(height, 0, tbid, tsigs)
    for i, (cs, v) in enumerate(zip(tsigs, tvals.validators)):
        cs.signature = by_addr[v.address].sign(tc.vote_sign_bytes(CHAIN, i))
    jsigs = [jcommit.CommitSig(jbasic.BlockIDFlag(int(cs.block_id_flag)), cs.validator_address,
                               jtime.Timestamp(cs.timestamp.seconds, cs.timestamp.nanos),
                               cs.signature) for cs in tsigs]
    jc = jcommit.Commit(height, 0, jbid, jsigs)
    return Pair(tvals, jvals, tc, jc, tbid, jbid)


def _outcome(fn) -> tuple:
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the outcome is compared
        return type(e).__name__, str(e)
    return ("pass",)


def _reference_backend(n: int) -> None:
    # XLA on the CPU at the 8-lane bucket; the OpenSSL loop beyond it
    jbatch.set_backend("tpu" if n <= 8 else "cpu")


def _calls(fn: str, p: Pair, tvals=None, jvals=None, height=HEIGHT, bids=None):
    tvals = tvals or p.tvals
    jvals = jvals or p.jvals
    tbid, jbid = bids or (p.tbid, p.jbid)
    if fn == "commit":
        return (lambda: tval.verify_commit(CHAIN, tvals, tbid, height, p.tc),
                lambda: jval.verify_commit(CHAIN, jvals, jbid, height, p.jc))
    if fn == "light":
        return (lambda: tval.verify_commit_light(CHAIN, tvals, tbid, height, p.tc),
                lambda: jval.verify_commit_light(CHAIN, jvals, jbid, height, p.jc))
    return (lambda: tval.verify_commit_light_trusting(CHAIN, tvals, p.tc, tval.Fraction(1, 3)),
            lambda: jval.verify_commit_light_trusting(CHAIN, jvals, p.jc,
                                                      jval.Fraction(1, 3)))


def _same(fn: str, p: Pair, **kw) -> tuple:
    t, j = _calls(fn, p, **kw)
    got, want = _outcome(t), _outcome(j)
    assert got == want
    return got


@pytest.mark.parametrize("fn", ["commit", "light", "trusting"])
@pytest.mark.parametrize("scheme", ["ed25519", "sr25519", "mixed"])
@pytest.mark.parametrize("n", [4, 8, 150])
def test_verify_commit_outcomes_equal_reference(n, scheme, fn):
    """A valid commit (with an off-length timestamp, and from 8 validators on
    a NIL vote), then a bad signature at the last index (the light checks
    stop before it), then one at index 1."""
    p = _pair(n, scheme, nil=(n - 2,) if n >= 8 else (), short_ts=(2,))
    _reference_backend(n)
    assert _same(fn, p) == ("pass",)
    sig = p.tc.signatures[n - 1].signature
    p.set_sig(n - 1, sig[:40] + bytes([sig[40] ^ 1]) + sig[41:])
    last = _same(fn, p)
    assert last == ("pass",) if fn != "commit" else last[0] == "ErrInvalidCommitSignature"
    sig = p.tc.signatures[1].signature
    p.set_sig(1, sig[:3] + bytes([sig[3] ^ 4]) + sig[4:])
    got = _same(fn, p)
    assert got[0] == "ErrInvalidCommitSignature" and got[1].startswith("wrong signature (#1)")


@pytest.mark.parametrize("fn", ["commit", "light", "trusting"])
def test_not_enough_voting_power_equal_reference(fn):
    p = _pair(6, "ed25519")
    for i in (0, 2, 3, 5):
        p.absent(i)
    _reference_backend(6)
    got = _same(fn, p)
    assert got[0] == "ErrNotEnoughVotingPowerSigned" and "got 20, needed more than" in got[1]


@pytest.mark.parametrize("fn", ["commit", "light"])
@pytest.mark.parametrize("fault", ["set size", "height", "block ID"])
def test_structural_errors_equal_reference(fn, fault):
    p = _pair(4, "ed25519")
    _reference_backend(4)
    kw: dict = {}
    if fault == "set size":
        small = _pair(3, "ed25519")
        kw = {"tvals": small.tvals, "jvals": small.jvals}
    elif fault == "height":
        kw = {"height": HEIGHT + 1}
    else:
        other = _pair(1, "ed25519", tag=b"other")
        kw = {"bids": (other.tbid, other.jbid)}
    got = _same(fn, p, **kw)
    assert got[0] == "ValueError" and f"wrong {fault}" in got[1]


def test_double_vote_equal_reference():
    p = _pair(5, "sr25519")
    for c in (p.tc, p.jc):
        c.signatures[1].validator_address = c.signatures[0].validator_address
    _reference_backend(5)
    got = _same("trusting", p)
    assert got[0] == "ValueError" and got[1].startswith("double vote from")


def test_trusting_by_address_over_another_set_equal_reference():
    """The trusted set is a superset in another order: lookup by address."""
    p = _pair(6, "ed25519")
    more = _pair(8, "ed25519")  # the same first six keys and two more
    _reference_backend(8)
    t, j = (lambda: tval.verify_commit_light_trusting(CHAIN, more.tvals, p.tc,
                                                      tval.Fraction(1, 3)),
            lambda: jval.verify_commit_light_trusting(CHAIN, more.jvals, p.jc,
                                                      jval.Fraction(1, 3)))
    assert _outcome(t) == _outcome(j) == ("pass",)


def _window(k: int, n: int, bad: dict[int, int]) -> list[Pair]:
    pairs = []
    for h in range(k):
        p = _pair(n, "ed25519", height=HEIGHT + h, tag=b"w%d" % h)
        if h in bad:
            sig = p.tc.signatures[bad[h]].signature
            p.set_sig(bad[h], sig[:50] + bytes([sig[50] ^ 8]) + sig[51:])
        pairs.append(p)
    return pairs


@pytest.mark.parametrize("scheduled", [True, False])
def test_prefetch_window_masks_equal_reference(scheduled):
    """Four commits staged, one with a bad signature: prefetch_staged gives
    per-commit masks equal to the reference's, and resolve_staged raises at
    that commit, with the reference's message."""
    tsched.configure(enabled=scheduled)
    try:
        pairs = _window(4, 4, {2: 3})
        _reference_backend(4)
        tst = [tval.stage_verify_commit(CHAIN, p.tvals, p.tbid, HEIGHT + h, p.tc)
               for h, p in enumerate(pairs)]
        jst = [jval.stage_verify_commit(CHAIN, p.jvals, p.jbid, HEIGHT + h, p.jc)
               for h, p in enumerate(pairs)]
        tval.prefetch_staged(tst)
        jval.prefetch_staged(jst)
        assert [list(map(bool, s._mask)) for s in tst] == \
            [list(map(bool, s._mask)) for s in jst]
        assert [list(map(bool, s._mask)) for s in tst][2] == [True, True, True, False]
        t, j = _outcome(lambda: tval.resolve_staged(tst)), _outcome(
            lambda: jval.resolve_staged(jst))
        assert t == j and t[1].startswith("wrong signature (#3)")
        tst[0].finish()  # a passed commit finishes again without work
    finally:
        tsched.configure(enabled=True)


def test_staged_window_is_one_scheduler_batch_under_sync():
    pairs = _window(3, 8, {})
    tst = [tval.stage_verify_commit_light(CHAIN, p.tvals, p.tbid, HEIGHT + h, p.tc)
           for h, p in enumerate(pairs)]
    tval.resolve_staged(tst)
    h = tsched.get().health()
    assert h["batches"] == 1 and h["class_rows"]["sync"] == sum(len(s.sig_idxs) for s in tst)


def test_staged_mixed_commit_finishes_alone():
    p = _pair(6, "mixed")
    _reference_backend(6)
    st = tval.stage_verify_commit_light_trusting(CHAIN, p.tvals, p.tc, tval.Fraction(1, 3))
    jst = jval.stage_verify_commit_light_trusting(CHAIN, p.jvals, p.jc, jval.Fraction(1, 3))
    assert st._ed_rows is None
    assert _outcome(st.finish) == _outcome(jst.finish) == ("pass",)


def test_validator_set_announced_once_per_object():
    """The key tables' epoch pin: the first verify_commit of a set hashes
    it once, later ones skip the O(N) Merkle root (the object's stamp)."""
    p = _pair(8, "ed25519")
    calls = []
    orig = type(p.tvals).hash

    def counted(self):
        calls.append(1)
        return orig(self)

    type(p.tvals).hash = counted
    try:
        tval.verify_commit(CHAIN, p.tvals, p.tbid, HEIGHT, p.tc)
        tval.verify_commit(CHAIN, p.tvals, p.tbid, HEIGHT, p.tc)
    finally:
        type(p.tvals).hash = orig
    assert len(calls) == 1
    tbl = TR.table_for(TK.default_cache("cpu"))
    assert tbl.pinned() == {p.tvals.hash(): 8}
    assert tbl.stats()["pinned_rows"] == 8


def test_gpu_backend_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    tbatch.set_backend("gpu")
    p = _pair(4, "ed25519")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tval.verify_commit(CHAIN, p.tvals, p.tbid, HEIGHT, p.tc)


def test_failing_launch_propagates_from_verify_commit_and_drain(monkeypatch):
    """A verify launch that raises is not verified on the host: the error
    leaves verify_commit, leaves an inline drain, and fails the riders'
    futures. Since the single-card path runs under the "device" supervisor,
    the launch's error arrives as the __cause__ of its DeviceOpFailed (a
    RuntimeError), after the supervisor's retries."""
    from cometbft_tpu_torch.ops import dispatch

    def boom(*args):
        raise RuntimeError("verify kernel launch failed: cudaError_t 700")

    def launch_error(exc_info) -> str:
        assert isinstance(exc_info.value, dispatch.DeviceOpFailed)
        return str(exc_info.value.__cause__)

    dispatch.reset_supervision()
    monkeypatch.setattr(TK, "ED25519", TK.ED25519._replace(verify_raw=boom))
    p = _pair(4, "ed25519")
    try:
        with pytest.raises(RuntimeError) as e:
            tval.verify_commit(CHAIN, p.tvals, p.tbid, HEIGHT, p.tc)
        assert "cudaError_t 700" in launch_error(e)
        rows = [(v.pub_key, b"m", bytes(64)) for v in p.tvals.validators]
        futs = tsched.get().submit(rows[:2], deadline=1e12)
        with pytest.raises(RuntimeError) as e:
            tsched.get().verify_now(rows[2:])
        assert "cudaError_t 700" in launch_error(e)
        assert all(isinstance(f.exception(0), RuntimeError) for f in futs)
    finally:
        dispatch.reset_supervision()
