"""The port's secp256k1 keys (crypto/secp256k1.py, pure-Python ECDSA with
RFC 6979 nonces) against the JAX package's on the same seeds: public keys
and RIPEMD160(SHA256) addresses bit for bit, signatures bit for bit with
the JAX package's pure-Python RFC 6979 signer (crypto/fallback.secp_sign,
low S; its keys sign through OpenSSL where `cryptography` is installed,
with random nonces, and each package verifies the other's), the refusal of
high-S signatures; pub_key_from_proto's secp256k1 field; and a commit with
a secp256k1 validator, which both packages verify serially: the port hands
no row of it to the scheduler.
"""

from __future__ import annotations

import pytest

from cometbft_tpu.crypto import fallback as jfallback
from cometbft_tpu.crypto import secp256k1 as jsecp
from cometbft_tpu.types import validation as jval
from cometbft_tpu.types import validator as jvalidator
from cometbft_tpu_torch.crypto import batch as tbatch
from cometbft_tpu_torch.crypto import secp256k1 as tsecp
from cometbft_tpu_torch.types import commit as tcommit
from cometbft_tpu_torch.types import validation as tval
from tests.torch_consumers import (CHAIN, block_id, fresh_backends, outcome, port_vals, priv,
                                   signed_commit, tamper_commit)


@pytest.fixture(autouse=True)
def _fresh():
    yield from fresh_backends()


@pytest.mark.parametrize("seed", [b"a", b"validator-7", b"\x00" * 40])
def test_keys_and_signatures_equal_reference(seed):
    jp, tp = jsecp.gen_priv_key_from_secret(seed), tsecp.gen_priv_key_from_secret(seed)
    assert tp.bytes_() == jp.bytes_()
    assert tp.pub_key().bytes_() == jp.pub_key().bytes_()
    assert tp.pub_key().address() == jp.pub_key().address()
    assert len(tp.pub_key().address()) == 20
    for msg in (b"", b"vote sign bytes " + seed):
        sig = tp.sign(msg)
        r, s = jfallback.secp_sign(int.from_bytes(jp.bytes_(), "big"), msg)
        assert sig == r.to_bytes(32, "big") + min(s, tsecp.N - s).to_bytes(32, "big")
        assert int.from_bytes(sig[32:], "big") <= tsecp.N // 2  # low S
        assert tp.pub_key().verify_signature(msg, sig)
        assert jp.pub_key().verify_signature(msg, sig)
        assert tp.pub_key().verify_signature(msg, jp.sign(msg))
        high = sig[:32] + (tsecp.N - int.from_bytes(sig[32:], "big")).to_bytes(32, "big")
        assert not tp.pub_key().verify_signature(msg, high)
        assert not jp.pub_key().verify_signature(msg, high)
        assert not tp.pub_key().verify_signature(msg + b"!", sig)
        assert not tp.pub_key().verify_signature(msg, sig[:63])


def test_invalid_keys_are_refused_like_the_reference():
    for data in (b"\x02" * 32, b"\x05" + b"\x01" * 32):
        got = outcome(lambda d: tsecp.PubKey(d).verify_signature(b"m", b"\x01" * 64), data)
        assert got == outcome(lambda d: jsecp.PubKey(d).verify_signature(b"m", b"\x01" * 64),
                              data)
    for d in (b"\x00" * 32, tsecp.N.to_bytes(32, "big"), b"\x01" * 31):
        assert outcome(tsecp.PrivKey, d)[0] == outcome(jsecp.PrivKey, d)[0] == "ErrInvalidKey"


def test_pub_key_proto_round_trip():
    from cometbft_tpu_torch.types import validator as tvalidator

    jpub = jsecp.gen_priv_key_from_secret(b"proto").pub_key()
    data = jvalidator.pub_key_to_proto(jpub)
    key = tvalidator.pub_key_from_proto(data)
    assert key.type_() == "secp256k1" and key.bytes_() == jpub.bytes_()
    assert tvalidator.pub_key_to_proto(key) == data


@pytest.mark.parametrize("proposer", ["ed25519", "secp256k1"])
def test_commit_with_a_secp256k1_validator_verifies_serially(proposer, monkeypatch):
    """Three ed25519 validators and one secp256k1: with an ed25519
    proposer the batch refuses the secp256k1 row (ErrInvalidKey at add) and
    the commit goes serial; with the secp256k1 proposer it goes serial at
    once. Either way verify_commit (every signature) hands no row to the
    scheduler, and the verdicts of it and of the light checks (which stop
    at their threshold, and batch when the rows they need are ed25519)
    equal the reference's."""
    privs = [priv("ed25519", b"secp-mix", i) for i in range(3)]
    privs.append(priv("secp256k1", b"secp-mix", 3))
    power = 40 if proposer == "secp256k1" else 5
    jvals = jvalidator.ValidatorSet(
        [jvalidator.Validator.new(p.pub_key(), power if p.pub_key().type_() == "secp256k1"
                                  else 10) for p in privs])
    by_addr = {p.pub_key().address(): p for p in privs}
    privs = [by_addr[v.address] for v in jvals.validators]
    tvals = port_vals(jvals)
    assert tvals.get_proposer().pub_key.type_() == proposer
    drains = []
    verify = tbatch.ScheduledBatchVerifier.verify
    monkeypatch.setattr(tbatch.ScheduledBatchVerifier, "verify",
                        lambda self: drains.append(self.count()) or verify(self))
    bid = block_id(b"secp-commit")
    jc = signed_commit(privs, 9, bid)
    secp_i = [p.pub_key().type_() for p in privs].index("secp256k1")
    from cometbft_tpu_torch.types import basic as tbasic

    tbid = tbasic.BlockID.from_proto(bid.to_proto())
    for c in (jc, tamper_commit(jc, secp_i), tamper_commit(jc, (secp_i + 1) % 4)):
        tc = tcommit.Commit.from_proto(c.to_proto())
        got = outcome(tval.verify_commit, CHAIN, tvals, tbid, 9, tc)
        assert got == outcome(jval.verify_commit, CHAIN, jvals, bid, 9, c)
        assert drains == []
        got = outcome(tval.verify_commit_light, CHAIN, tvals, tbid, 9, tc)
        assert got == outcome(jval.verify_commit_light, CHAIN, jvals, bid, 9, c)
        got = outcome(tval.verify_commit_light_trusting, CHAIN, tvals, tc, tval.Fraction(1, 3))
        assert got == outcome(jval.verify_commit_light_trusting, CHAIN, jvals, c,
                              jval.Fraction(1, 3))
        drains.clear()
    assert outcome(tval.verify_commit, CHAIN, tvals, tbid, 9,
                   tcommit.Commit.from_proto(jc.to_proto())) == ("ok", None)
