"""The port's commit certificates (cert/certificate.py) and the light
verifier's certificate hop (light/verifier.verify_with_certificate) against
the JAX package's on the same 4-validator all-BLS chain: build_certificate
and encode/decode bytes, decode's refusals, matches_commit and
attests_commit on altered commits, verify_certificate's refusals and the
certificate hop's accept-or-fall-back verdicts.

The pairing-product check costs ~15 s a call through the port's plain
versions on the CPU, so one certificate is verified for real on each side;
the rest of the matrix stubs validation._bls_aggregate_agg_ok on both sides
(the verdict it would give), which holds everything around the pairing:
the rows, the keys, the tally, the structural checks.
"""

from __future__ import annotations

import dataclasses

import pytest

from cometbft_tpu.cert import certificate as jcert
from cometbft_tpu.crypto import bls12381 as jbls
from cometbft_tpu.light import verifier as jverifier
from cometbft_tpu.types import validation as jval
from cometbft_tpu.types.light import SignedHeader
from cometbft_tpu.types.validation import Fraction as JFraction
from cometbft_tpu_torch.cert import certificate as tcert
from cometbft_tpu_torch.crypto import bls12381 as tbls
from cometbft_tpu_torch.light import verifier as tverifier
from cometbft_tpu_torch.types import light as ttypes_light
from cometbft_tpu_torch.types import validation as tval
from tests.torch_consumers import (CHAIN, PERIOD_NS, Chain, fresh_backends, now, outcome,
                                   tamper_commit)


@pytest.fixture(autouse=True)
def _fresh():
    yield from fresh_backends()


@pytest.fixture(scope="module")
def chain():
    """Six heights of four BLS validators, two replaced at height 4."""
    return Chain(6, n_vals=4, churn_every=4, replace=2, tag=b"cert", kind="bls12381")


def _certs(chain, h: int, commit=None):
    """build_certificate of block h (or of `commit` on its set) in both
    packages."""
    jlb = chain.blocks[h]
    jcommit = commit or jlb.commit
    tcommit_ = ttypes_light.SignedHeader.from_proto(
        SignedHeader(jlb.header, jcommit).to_proto()).commit
    return (tcert.build_certificate(CHAIN, chain.port(h).validator_set, tcommit_),
            jcert.build_certificate(CHAIN, jlb.validator_set, jcommit), tcommit_, jcommit)


@pytest.fixture
def stub_pairing(monkeypatch):
    """Replace the pairing-product check on both sides by `verdict`
    (True, False, or None for "not an all-BLS set"); records the rows."""
    state = {"verdict": True, "calls": [],
             "orig": (tval._bls_aggregate_agg_ok, jval._bls_aggregate_agg_ok)}

    def make(side):
        def stub(pubs, msgs, agg_sig):
            from cometbft_tpu_torch.libs.prefixrows import as_bytes

            state["calls"].append((side, [p.bytes_() for p in pubs],
                                   [bytes(as_bytes(m)) if side == "t" else bytes(m)
                                    for m in msgs], bytes(agg_sig)))
            return state["verdict"]
        return stub
    monkeypatch.setattr(tval, "_bls_aggregate_agg_ok", make("t"))
    monkeypatch.setattr(jval, "_bls_aggregate_agg_ok", make("j"))
    return state


def test_build_encode_decode_equal_reference(chain):
    for h in (2, 5):
        tc, jc, _, _ = _certs(chain, h)
        data = jc.encode()
        assert tc.encode() == data and tc.summary() == jc.summary()
        back = tcert.CommitCertificate.decode(data)
        assert back.encode() == data and back.signer_indices() == jc.signer_indices()
        assert [t.unix_ns() for t in back.signer_timestamps()] == \
            [t.unix_ns() for t in jc.signer_timestamps()]
        assert back.to_commit().to_proto() == jc.to_commit().to_proto()
    # an absent signer is left out of the bitmap; below the threshold, none
    for absent in ((1,), (0, 3)):
        jcommit = chain.blocks[3].commit
        jc2 = dataclasses.replace(jcommit, signatures=[
            type(cs).absent() if i in absent else cs for i, cs in enumerate(jcommit.signatures)])
        tc, jc, _, _ = _certs(chain, 3, jc2)
        assert (tc and tc.encode()) == (jc and jc.encode())
        assert (jc is None) == (len(absent) == 2)


_MALFORMED = {
    "short signature": lambda c: dataclasses.replace(c, agg_sig=c.agg_sig[:95]),
    "no validators": lambda c: dataclasses.replace(c, n_vals=0),
    "bitmap length": lambda c: dataclasses.replace(c, n_vals=c.n_vals + 8),
    "height": lambda c: dataclasses.replace(c, height=0),
    "round": lambda c: dataclasses.replace(c, round_=-1),
    "deltas": lambda c: dataclasses.replace(c, ts_deltas=c.ts_deltas[:-1]),
    "chain id": lambda c: dataclasses.replace(c, chain_id="x" * 65),
}


@pytest.mark.parametrize("case", sorted(_MALFORMED))
def test_decode_refuses_what_the_reference_refuses(chain, case):
    _, jc, _, _ = _certs(chain, 2)
    data = _MALFORMED[case](jc).encode()
    got = outcome(tcert.CommitCertificate.decode, data)
    assert got == outcome(jcert.CommitCertificate.decode, data)
    assert got[0] == "ValueError"


_ALTER = {
    "same": lambda c: c,
    "dropped signer": lambda c: dataclasses.replace(c, signatures=[
        type(cs).absent() if i == 2 else cs for i, cs in enumerate(c.signatures)]),
    "timestamp": lambda c: dataclasses.replace(c, signatures=[
        dataclasses.replace(cs, timestamp=type(cs.timestamp)(cs.timestamp.seconds, 7))
        if i == 0 else cs for i, cs in enumerate(c.signatures)]),
    "mauled signature": lambda c: tamper_commit(c, 3),
    "round": lambda c: dataclasses.replace(c, round_=c.round_ + 1),
}


@pytest.mark.parametrize("case", sorted(_ALTER))
def test_matches_and_attests_equal_reference(chain, case):
    tc, jc, _, _ = _certs(chain, 2)
    jcommit = _ALTER[case](chain.blocks[2].commit)
    tcommit_ = ttypes_light.SignedHeader.from_proto(
        SignedHeader(chain.blocks[2].header, jcommit).to_proto()).commit
    got = (tcert.matches_commit(tc, tcommit_), tcert.attests_commit(tc, tcommit_))
    assert got == (jcert.matches_commit(jc, jcommit), jcert.attests_commit(jc, jcommit))
    assert got == ((True, True) if case == "same" else
                   (True, False) if case == "mauled signature" else (False, False))


_REFUSE = {
    "ok": lambda c, v: (c, v),
    "chain": lambda c, v: (dataclasses.replace(c, chain_id="other"), v),
    "set size": lambda c, v: (dataclasses.replace(c, n_vals=3), v),
    "set hash": lambda c, v: (dataclasses.replace(c, valset_hash=b"\x01" * 32), v),
    "nil block": lambda c, v: (dataclasses.replace(c, block_id=type(c.block_id)()), v),
    "signature size": lambda c, v: (dataclasses.replace(c, agg_sig=c.agg_sig + b"\x00"), v),
    "no signers": lambda c, v: (dataclasses.replace(c, signers=type(c.signers)(c.n_vals),
                                                    ts_deltas=[]), v),
    "power": lambda c, v: (dataclasses.replace(
        c, signers=type(c.signers).from_bools([True, True, False, False]),
        ts_deltas=c.ts_deltas[:2]), v),
    "pairing fails": lambda c, v: (c, v),
    "not all BLS": lambda c, v: (c, v),
}


@pytest.mark.parametrize("case", sorted(_REFUSE))
def test_verify_certificate_equals_reference(chain, case, stub_pairing):
    tc, jc, _, _ = _certs(chain, 2)
    stub_pairing["verdict"] = {"pairing fails": False, "not all BLS": None}.get(case, True)
    tc, tvals = _REFUSE[case](tc, chain.port(2).validator_set)
    jc, jvals = _REFUSE[case](jc, chain.blocks[2].validator_set)
    got = outcome(tcert.verify_certificate, tc, CHAIN, tvals)
    assert got == outcome(jcert.verify_certificate, jc, CHAIN, jvals)
    assert (got == ("ok", None)) == (case == "ok")
    # the pairing saw the same keys, sign bytes and aggregate on both sides
    calls = stub_pairing["calls"]
    assert [c[1:] for c in calls if c[0] == "t"] == [c[1:] for c in calls if c[0] == "j"]


@pytest.mark.parametrize("case", ["adjacent", "non-adjacent", "sub-trust", "mismatched",
                                  "pairing fails", "expired", "bls disabled"])
def test_certificate_hop_equals_reference(chain, case, stub_pairing, monkeypatch):
    """verify_with_certificate: True decides the hop, False sends it to
    the classic path; header errors and a disabled BLS scheme raise (the
    latter before any pairing: the real check runs, and the messages of
    the two packages differ there, so only the class is compared)."""
    trusted, target = (2, 3) if case == "adjacent" else (1, 5)
    trust = (2, 3) if case == "sub-trust" else (1, 3)  # half the old set signed
    if case == "bls disabled":
        monkeypatch.setattr(tval, "_bls_aggregate_agg_ok", stub_pairing["orig"][0])
        monkeypatch.setattr(jval, "_bls_aggregate_agg_ok", stub_pairing["orig"][1])
    tc, jc, _, _ = _certs(chain, target)
    jnow, tnow = now(chain)
    period = 10**9 if case == "expired" else PERIOD_NS
    if case == "mismatched":
        tc, jc = _certs(chain, target - 1)[:2]
    stub_pairing["verdict"] = case != "pairing fails"
    outs = []
    for mod, blocks, cert, n_, frac, bls in (
            (jverifier, chain.blocks, jc, jnow, JFraction(*trust), jbls),
            (tverifier, {h: chain.port(h) for h in chain.blocks}, tc, tnow,
             tval.Fraction(*trust), tbls)):
        a, b = blocks[trusted], blocks[target]
        bls.set_enabled(case != "bls disabled")
        try:
            outs.append(outcome(mod.verify_with_certificate, a.signed_header, a.validator_set,
                                b.signed_header, b.validator_set, period, n_,
                                10 * 10**9, frac, cert))
        finally:
            bls.set_enabled(True)
    assert outs[0] == outs[1] or (case == "bls disabled" and outs[0][0] == outs[1][0])
    want = {"adjacent": ("ok", True), "non-adjacent": ("ok", True)}.get(case)
    if want:
        assert outs[0] == want
    elif case in ("sub-trust", "mismatched", "pairing fails"):
        assert outs[0] == ("ok", False)
    else:
        assert outs[0][0] == {"expired": "ErrOldHeaderExpired",
                              "bls disabled": "ErrInvalidKey"}[case]


def test_one_real_certificate_verifies_on_both_sides(chain):
    """The pairing-product check itself: the certificate of height 5 on
    its set, through the port's plain B1-B5 and the reference's oracle."""
    tc, jc, _, _ = _certs(chain, 5)
    assert outcome(tcert.verify_certificate, tc, CHAIN, chain.port(5).validator_set) == \
        outcome(jcert.verify_certificate, jc, CHAIN, chain.blocks[5].validator_set) == \
        ("ok", None)
