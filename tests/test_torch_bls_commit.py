"""All-BLS commit verification and mixed-scheme batches through the port's
entry points, on its "cpu" backend (the kernels' plain versions), against
the JAX package on its "cpu" backend (its exact host oracle):
verify_commit and verify_commit_light on a 4-validator bls12381 set (the
aggregate check, and for a tampered signature the per-lane pinpoint through
the scheduler) give the same outcome, which is both passing or the same
exception class with the same message naming the same index; a disabled
scheme raises ErrInvalidKey on both; a staged window decides an all-BLS
commit at finish() (the mixed three-scheme scheduler batch is in
test_torch_bls_sched.py). Exact everywhere.
"""

from __future__ import annotations

import hashlib

import pytest
import torch

from cometbft_tpu import sched as jsched
from cometbft_tpu.crypto import batch as jbatch
from cometbft_tpu.crypto import bls12381 as jbls
from cometbft_tpu.types import basic as jbasic
from cometbft_tpu.types import commit as jcommit
from cometbft_tpu.types import validation as jval
from cometbft_tpu.types import validator as jvalidator
from cometbft_tpu.utils import cmttime as jtime
from cometbft_tpu_torch import crypto as tcrypto
from cometbft_tpu_torch import sched as tsched
from cometbft_tpu_torch.crypto import batch as tbatch
from cometbft_tpu_torch.crypto import bls12381 as tbls
from cometbft_tpu_torch.ops import bls_kernel as TBK
from cometbft_tpu_torch.types import basic as tbasic
from cometbft_tpu_torch.types import commit as tcommit
from cometbft_tpu_torch.types import validation as tval
from cometbft_tpu_torch.types import validator as tvalidator
from cometbft_tpu_torch.utils import cmttime as ttime
from tests.test_torch_bls_kernel import plain_hashes_once

CHAIN = "bls-chain"
HEIGHT = 77


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with plain_hashes_once():
        yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fresh():
    tsched.reset()
    jsched.reset()
    tsched.configure(enabled=True)
    TBK.reset_valset_cache()
    tbatch.set_backend("cpu")
    jbatch.set_backend("cpu")
    yield
    tsched.reset()
    jsched.reset()
    tbls.set_enabled(True)
    jbls.set_enabled(True)
    tbatch.set_backend("gpu")
    jbatch.set_backend("auto")


_PRIVS = [tbls.gen_priv_key_from_secret(b"bls-commit-%d" % i) for i in range(4)]


def _pair():
    """A signed 4-validator all-BLS commit in both packages (distinct
    timestamps: four distinct sign-bytes)."""
    by_addr = {p.pub_key().address(): p for p in _PRIVS}
    tvals = tvalidator.ValidatorSet([tvalidator.Validator.new(p.pub_key(), 10) for p in _PRIVS])
    jvals = jvalidator.ValidatorSet([jvalidator.Validator.new(jbls.PubKey(p.pub_key().bytes_()),
                                                              10) for p in _PRIVS])
    h, psh = hashlib.sha256(b"blk").digest(), hashlib.sha256(b"parts").digest()
    tbid = tbasic.BlockID(h, tbasic.PartSetHeader(1, psh))
    jbid = jbasic.BlockID(h, jbasic.PartSetHeader(1, psh))
    tsigs = [tcommit.CommitSig(tbasic.BlockIDFlag.COMMIT, v.address,
                               ttime.Timestamp(1_700_000_000, 1000 * i + 7))
             for i, v in enumerate(tvals.validators)]
    tc = tcommit.Commit(HEIGHT, 0, tbid, tsigs)
    for i, (cs, v) in enumerate(zip(tsigs, tvals.validators)):
        cs.signature = by_addr[v.address].sign(tc.vote_sign_bytes(CHAIN, i))
    jc = jcommit.Commit(HEIGHT, 0, jbid, [
        jcommit.CommitSig(jbasic.BlockIDFlag(int(cs.block_id_flag)), cs.validator_address,
                          jtime.Timestamp(cs.timestamp.seconds, cs.timestamp.nanos),
                          cs.signature) for cs in tsigs])
    return tvals, jvals, tc, jc, tbid, jbid


_PAIR = _pair()


def _outcome(fn) -> tuple:
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the outcome is compared
        return type(e).__name__, str(e)
    return ("pass",)


def _same(fn: str, tc, jc) -> tuple:
    tvals, jvals, _, _, tbid, jbid = _PAIR
    t = getattr(tval, fn)
    j = getattr(jval, fn)
    got = _outcome(lambda: t(CHAIN, tvals, tbid, HEIGHT, tc))
    want = _outcome(lambda: j(CHAIN, jvals, jbid, HEIGHT, jc))
    assert got == want
    return got


def _tampered(i: int):
    _, _, tc, jc, _, _ = _PAIR
    tc2 = tcommit.Commit(tc.height, tc.round_, tc.block_id, [
        tcommit.CommitSig(cs.block_id_flag, cs.validator_address, cs.timestamp, cs.signature)
        for cs in tc.signatures])
    jc2 = jcommit.Commit(jc.height, jc.round_, jc.block_id, [
        jcommit.CommitSig(cs.block_id_flag, cs.validator_address, cs.timestamp, cs.signature)
        for cs in jc.signatures])
    # a valid signature of another message: it decodes and is in G2
    bad = _PRIVS[0].sign(b"not the vote")
    tc2.signatures[i].signature = jc2.signatures[i].signature = bad
    return tc2, jc2


def test_verify_commit_all_bls_equal_reference():
    """Valid: the aggregate accepts, through a staged window (prefetch
    leaves the all-BLS commit out of the batch; finish() runs the aggregate)
    and no per-lane batch runs. One bad signature at index 2: the aggregate
    fails and the per-lane pinpoint names #2, as the reference does."""
    tvals, jvals, tc, jc, tbid, jbid = _PAIR
    st = tval.stage_verify_commit(CHAIN, tvals, tbid, HEIGHT, tc)
    tval.resolve_staged([st])
    assert st._passed and tsched.get().health()["batches"] == 0
    jval.verify_commit(CHAIN, jvals, jbid, HEIGHT, jc)
    got = _same("verify_commit", *_tampered(2))
    assert got[0] == "ErrInvalidCommitSignature" and got[1].startswith("wrong signature (#2)")


def test_verify_commit_light_all_bls_equal_reference():
    """The light check stops at +2/3: a bad signature at the last index is
    never looked at."""
    assert _same("verify_commit_light", *_tampered(3)) == ("pass",)


def test_disabled_scheme_raises_on_both():
    """The same exception class (the messages name each package's switch)."""
    tvals, jvals, tc, jc, tbid, jbid = _PAIR
    tbls.set_enabled(False)
    jbls.set_enabled(False)
    got = _outcome(lambda: tval.verify_commit(CHAIN, tvals, tbid, HEIGHT, tc))
    want = _outcome(lambda: jval.verify_commit(CHAIN, jvals, jbid, HEIGHT, jc))
    assert got[0] == want[0] == "ErrInvalidKey"
    with pytest.raises(tcrypto.ErrInvalidKey):
        tbatch.create_mixed_batch_verifier().add(_PRIVS[0].pub_key(), b"m", bytes(96))
