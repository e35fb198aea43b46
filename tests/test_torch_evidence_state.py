"""The port's evidence (types/evidence.py, evidence/verify.py) and chain
state (state/state.py) against the JAX package's on the same seeded
inputs: evidence bytes, hashes, ABCI views and the round trip from the JAX
package's bytes; verify_duplicate_vote and verify_light_client_attack (a
lunatic attack from a forked chain, against a stub block store) with the
same verdicts, exception classes and first lines; verify_evidence's age
and lookup checks; State.to_bytes / from_bytes, from_genesis and
make_block.

The port runs on its "cpu" backend (the kernels' plain versions) through
its scheduler, the reference on its "cpu" backend.
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import pytest

from cometbft_tpu import light as jlight
from cometbft_tpu.evidence import verify as jverify
from cometbft_tpu.state import state as jstate
from cometbft_tpu.types import evidence as jevidence
from cometbft_tpu.types import genesis as jgenesis
from cometbft_tpu.types.validator import Validator, ValidatorSet
from cometbft_tpu.utils import cmttime
from cometbft_tpu_torch import light as tlight
from cometbft_tpu_torch.evidence import verify as tverify
from cometbft_tpu_torch.state import state as tstate
from cometbft_tpu_torch.types import evidence as tevidence
from cometbft_tpu_torch.types import vote as tvote
from cometbft_tpu_torch.utils import cmttime as ttime
from tests.torch_consumers import (BASE_S, CHAIN, Chain, block_id, fresh_backends, outcome,
                                   port_vals, priv, tamper_commit, vote)

H = 25


@pytest.fixture(autouse=True)
def _fresh():
    yield from fresh_backends()


@pytest.fixture(scope="module")
def chains():
    """30 heights of 4 validators, and the same chain lying from 20 on."""
    honest = Chain(30, n_vals=4, tag=b"evidence")
    return honest, honest.forked(20)


def _dup(chains, i: int = 1, a: bytes = b"a", b: bytes = b"b"):
    """Validator i's two votes at height H for blocks a and b, as
    DuplicateVoteEvidence in both packages."""
    honest, _ = chains
    jvals, privs = honest.vals(H)
    va, vb = vote(privs, i, H, 0, block_id(a)), vote(privs, i, H, 0, block_id(b))
    t = honest.blocks[H].header.time
    jev = jevidence.DuplicateVoteEvidence.new(va, vb, t, jvals)
    tev = tevidence.DuplicateVoteEvidence.new(
        tvote.Vote.from_proto(va.to_proto()), tvote.Vote.from_proto(vb.to_proto()),
        ttime.Timestamp(t.seconds, t.nanos), port_vals(jvals))
    return tev, jev


def _attack(chains):
    honest, lying = chains
    jev = jlight.make_attack_evidence(lying.blocks[30], honest.blocks[30], honest.blocks[1])
    tev = tlight.make_attack_evidence(lying.port(30), honest.port(30), honest.port(1))
    return tev, jev


def _abci(ev):
    return [{k: (v.unix_ns() if hasattr(v, "unix_ns") else v) for k, v in d.items()}
            for d in ev.abci()]


def test_evidence_bytes_and_hashes_equal_reference(chains):
    for tev, jev in (_dup(chains), _attack(chains)):
        data = jev.to_proto()
        assert tev.to_proto() == data and tev.bytes_() == jev.bytes_()
        assert tev.hash() == jev.hash() and tev.height() == jev.height()
        assert tev.time().unix_ns() == jev.time().unix_ns() and tev.string() == jev.string()
        assert type(tev).from_proto(data).to_proto() == data
        assert _abci(tev) == _abci(jev)
        assert outcome(tev.validate_basic) == outcome(jev.validate_basic) == ("ok", None)
    tevs = [ev for ev, _ in (_dup(chains), _attack(chains))]
    jevs = [ev for _, ev in (_dup(chains), _attack(chains))]
    data = jevidence.evidence_list_to_proto(jevs)
    assert tevidence.evidence_list_to_proto(tevs) == data
    assert tevidence.evidence_list_to_proto(tevidence.evidence_list_from_proto(data)) == data
    # the votes out of order are refused alike
    tev, jev = _dup(chains)
    tev.vote_a, tev.vote_b = tev.vote_b, tev.vote_a
    jev.vote_a, jev.vote_b = jev.vote_b, jev.vote_a
    assert outcome(tev.validate_basic) == outcome(jev.validate_basic) != ("ok", None)


def test_attack_classification_equals_reference(chains):
    honest, lying = chains
    tev, jev = (type(ev).from_proto(ev.to_proto()) for ev in _attack(chains))  # copies to alter
    for h in (1, 30):
        assert tev.conflicting_header_is_invalid(honest.port(h).header) == \
            jev.conflicting_header_is_invalid(honest.blocks[h].header)
    # an equivocation at the same height and round: the validators that
    # signed both commits
    sh_t, sh_j = honest.port(30).signed_header, honest.blocks[30].signed_header
    tev.conflicting_block.signed_header.header = dataclasses.replace(
        tev.conflicting_block.header, app_hash=sh_t.header.app_hash)
    jev.conflicting_block.signed_header.header = dataclasses.replace(
        jev.conflicting_block.header, app_hash=sh_j.header.app_hash)
    got = tev.get_byzantine_validators(port_vals(honest.vals(30)[0]), sh_t)
    want = jev.get_byzantine_validators(honest.vals(30)[0], sh_j)
    assert [v.to_proto() for v in got] == [v.to_proto() for v in want] and len(want) == 4


_DUP_CASES = {
    "valid": lambda t, j: None,
    "vote B tampered": lambda t, j: [setattr(e.vote_b, "signature", e.vote_b.signature[:40]
                                             + bytes([e.vote_b.signature[40] ^ 1])
                                             + e.vote_b.signature[41:]) for e in (t, j)],
    "vote A tampered": lambda t, j: [setattr(e.vote_a, "signature", bytes(64)) for e in (t, j)],
    "height": lambda t, j: [setattr(e.vote_b, "height", H + 1) for e in (t, j)],
    "same block": lambda t, j: [setattr(e.vote_b, "block_id", e.vote_a.block_id)
                                for e in (t, j)],
    "address": lambda t, j: [setattr(e.vote_b, "validator_address", b"\x01" * 20)
                             for e in (t, j)],
    "index": lambda t, j: [setattr(e.vote_b, "validator_index", 3) for e in (t, j)],
    "power": lambda t, j: [setattr(e, "validator_power", 11) for e in (t, j)],
    "total power": lambda t, j: [setattr(e, "total_voting_power", 1) for e in (t, j)],
}


@pytest.mark.parametrize("case", sorted(_DUP_CASES))
def test_verify_duplicate_vote_equals_reference(chains, case):
    tev, jev = _dup(chains)
    _DUP_CASES[case](tev, jev)
    jvals = chains[0].vals(H)[0]
    got = outcome(tverify.verify_duplicate_vote, tev, CHAIN, port_vals(jvals))
    assert got == outcome(jverify.verify_duplicate_vote, jev, CHAIN, jvals)
    assert (got == ("ok", None)) == (case == "valid")
    if case == "vote B tampered":
        assert got == ("ErrInvalidEvidence", "invalid signature on vote B")


class _Store:
    """The block store verify_light_client_attack reads (duck-typed): block
    meta and commit of each height up to `head`."""

    def __init__(self, blocks: dict, head: int):
        self.blocks, self.head = blocks, head

    def load_block_meta(self, h):
        lb = self.blocks.get(h) if h <= self.head else None
        return SimpleNamespace(header=lb.header) if lb is not None else None

    def load_block_commit(self, h):
        lb = self.blocks.get(h) if h <= self.head else None
        return lb.commit if lb is not None else None

    def height(self):
        return self.head


def _states(chains):
    honest, _ = chains
    jvals = honest.vals(30)[0]
    js = jstate.State(chain_id=CHAIN, initial_height=1, last_block_height=30,
                      last_block_time=honest.blocks[30].header.time, validators=jvals,
                      next_validators=jvals, last_validators=jvals)
    return tstate.State.from_bytes(js.to_bytes()), js


_LCA_CASES = {
    "valid": lambda t, j: None,
    "tampered conflicting commit": lambda t, j: setattr(
        j.conflicting_block.signed_header, "commit", tamper_commit(j.conflicting_block.commit, 0)),
    "total power": lambda t, j: [setattr(e, "total_voting_power", 7) for e in (t, j)],
    "byzantine validators": lambda t, j: [e.byzantine_validators.pop() for e in (t, j)],
    "no header": lambda t, j: [setattr(e, "common_height", 31) for e in (t, j)],
    "inconsistent block": lambda t, j: [
        setattr(e.conflicting_block.header, "validators_hash", b"\x09" * 32) for e in (t, j)],
}


@pytest.mark.parametrize("case", sorted(_LCA_CASES))
def test_verify_light_client_attack_equals_reference(chains, case):
    honest, _ = chains
    tev, jev = _attack(chains)
    jev = type(jev).from_proto(jev.to_proto())  # copies to alter
    tev = type(tev).from_proto(tev.to_proto())
    _LCA_CASES[case](tev, jev)
    if case == "tampered conflicting commit":  # the same commit on the port's side
        tev = type(tev).from_proto(jev.to_proto())
    ts, js = _states(chains)
    tstore, jstore = _Store(honest.port_blocks(), 30), _Store(honest.blocks, 30)
    jvals1 = honest.vals(1)[0]
    got = outcome(tverify.verify_light_client_attack, tev, ts, port_vals(jvals1), tstore)
    assert got == outcome(jverify.verify_light_client_attack, jev, js, jvals1, jstore)
    assert (got == ("ok", None)) == (case == "valid")
    if case == "valid":  # the whole intake, under SYNC, through verify_evidence
        vals_at = {1: jvals1}
        got = outcome(tverify.verify_evidence, tev, ts,
                      lambda h: vals_at.get(h) and port_vals(vals_at[h]), tstore)
        assert got == outcome(jverify.verify_evidence, jev, js, vals_at.get, jstore)
        assert got == ("ok", None)
        assert outcome(tverify.verify_light_client_attack, tev, ts, port_vals(jvals1), None) \
            == outcome(jverify.verify_light_client_attack, jev, js, jvals1, None)


@pytest.mark.parametrize("case", ["too old", "no validator set", "time differs", "no header"])
def test_verify_evidence_checks_equal_reference(chains, case):
    honest, _ = chains
    tev, jev = _dup(chains)
    ts, js = _states(chains)
    jvals = honest.vals(H)[0]
    get_t, get_j = (lambda h: port_vals(jvals)), (lambda h: jvals)
    tstore, jstore = _Store(honest.port_blocks(), 30), _Store(honest.blocks, 30)
    if case == "too old":
        for s in (ts, js):
            s.last_block_height = 200_000
            s.last_block_time = type(s.last_block_time)(BASE_S + 10**6, 0)
    elif case == "no validator set":
        get_t = get_j = lambda h: None
    elif case == "time differs":
        tev.timestamp = ttime.Timestamp(BASE_S, 1)
        jev.timestamp = cmttime.Timestamp(BASE_S, 1)
    elif case == "no header":
        tstore.head = jstore.head = 10
    got = outcome(tverify.verify_evidence, tev, ts, get_t, tstore)
    assert got == outcome(jverify.verify_evidence, jev, js, get_j, jstore)
    assert got[0] == "ErrInvalidEvidence"


def test_state_bytes_equal_reference():
    """A genesis state carried across through State.to_bytes, with one
    secp256k1 validator beside the ed25519 ones; make_block on both."""
    privs = [priv("ed25519", b"state", i) for i in range(3)]
    jdoc = jgenesis.GenesisDoc(
        genesis_time=cmttime.Timestamp(BASE_S, 123), chain_id=CHAIN,
        validators=[jgenesis.GenesisValidator(p.pub_key().address(), p.pub_key(), 10 + i)
                    for i, p in enumerate(privs)])
    jdoc.validate_and_complete()
    js = jstate.State.from_genesis(jdoc)
    from cometbft_tpu_torch.types import genesis as tgenesis

    ts = tstate.State.from_genesis(tgenesis.GenesisDoc.from_json(jdoc.to_json()))
    assert ts.to_bytes() == js.to_bytes()
    secp = priv("secp256k1", b"state", 9).pub_key()
    js.validators = ValidatorSet(js.validators.validators + [Validator.new(secp, 5)])
    js.last_block_height, js.app_hash = 7, b"\x42" * 32
    data = js.to_bytes()
    ts = tstate.State.from_bytes(data)
    assert ts.to_bytes() == data
    assert ts.copy().to_bytes() == js.copy().to_bytes() and not ts.is_empty()
    assert any(v.pub_key.type_() == "secp256k1" for v in ts.validators.validators)
    jb = js.make_block(8, [b"tx"], None, [], js.validators.validators[0].address,
                       cmttime.Timestamp(BASE_S + 8, 0))
    tb = ts.make_block(8, [b"tx"], None, [], ts.validators.validators[0].address,
                       ttime.Timestamp(BASE_S + 8, 0))
    assert tb.hash() == jb.hash() and tb.to_proto() == jb.to_proto()
