"""The port's byzantine validator harness (consensus/byzantine.py) against
the JAX package's: the equivocation's conflicting vote and the flood's
forged vote give the same proto bytes for the same inputs (os.urandom
seeded on both sides), and an unknown behaviour fails alike. In a small
in-process port net on the CPU (tests/torch_net_harness.py), silence and
amnesia cost no liveness (equivocation and flood:
tests/test_torch_byzantine_net.py).
"""

from __future__ import annotations

import asyncio
import types

import numpy as np
import pytest

import torch_net_harness as H
from tests.torch_consumers import fresh_backends
from cometbft_tpu.consensus import byzantine as jbyz
from cometbft_tpu.crypto import ed25519 as jed
from cometbft_tpu.types.basic import BlockID as JBlockID
from cometbft_tpu.types.basic import PartSetHeader as JPSH
from cometbft_tpu.types.basic import SignedMsgType as JT
from cometbft_tpu.types.validator import Validator as JValidator
from cometbft_tpu.types.validator import ValidatorSet as JValidatorSet
from cometbft_tpu.types.vote import Vote as JVote
from cometbft_tpu.utils.cmttime import Timestamp as JTs
from cometbft_tpu_torch.consensus import byzantine as tbyz
from cometbft_tpu_torch.consensus.config import ConsensusConfig as TConfig
from cometbft_tpu_torch.crypto import ed25519 as ted
from cometbft_tpu_torch.types.basic import BlockID as TBlockID
from cometbft_tpu_torch.types.basic import PartSetHeader as TPSH
from cometbft_tpu_torch.types.basic import SignedMsgType as TT
from cometbft_tpu_torch.types.validator import Validator as TValidator
from cometbft_tpu_torch.types.validator import ValidatorSet as TValidatorSet
from cometbft_tpu_torch.types.vote import Vote as TVote
from cometbft_tpu_torch.utils.cmttime import Timestamp as TTs

CHAIN = "byz-chain"
SIDES = {
    "j": dict(byz=jbyz, ed=jed, Vote=JVote, BlockID=JBlockID, PSH=JPSH, T=JT, Ts=JTs,
              Validator=JValidator, ValidatorSet=JValidatorSet),
    "t": dict(byz=tbyz, ed=ted, Vote=TVote, BlockID=TBlockID, PSH=TPSH, T=TT, Ts=TTs,
              Validator=TValidator, ValidatorSet=TValidatorSet),
}


def _stub_cs(side: dict, secret: bytes, n_vals: int = 4):
    """The parts of a ConsensusState the harness touches."""
    privs = [side["ed"].gen_priv_key_from_secret(secret + b"%d" % i) for i in range(n_vals)]
    vals = side["ValidatorSet"]([side["Validator"].new(p.pub_key(), 10) for p in privs])
    sent = []

    async def sign_add_vote(type_, hash_, psh):
        return None

    rs = types.SimpleNamespace(height=7, round_=2, validators=vals,
                               start_time=side["Ts"](1_700_000_123, 456_000_000))
    cs = types.SimpleNamespace(
        _gossip=sent.append, _sign_add_vote=sign_add_vote, rs=rs,
        priv_validator=types.SimpleNamespace(priv_key=privs[1]))
    return cs, sent


def _vote(side: dict, priv, type_name: str, block_hash: bytes, index: int):
    T = side["T"]
    v = side["Vote"](
        type_=getattr(T, type_name), height=7, round_=2,
        block_id=side["BlockID"](hash=block_hash,
                                 part_set_header=side["PSH"](total=3, hash=block_hash[::-1])),
        timestamp=side["Ts"](1_700_000_100, 5_000_000),
        validator_address=priv.pub_key().address(), validator_index=index)
    v.signature = priv.sign(v.sign_bytes(CHAIN))
    return v


@pytest.mark.parametrize("type_name", ["PREVOTE", "PRECOMMIT"])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_conflicting_vote_is_the_reference_s(type_name, seed):
    rng = np.random.default_rng(seed)
    block_hash = rng.integers(0, 256, 32, dtype=np.uint8).tobytes()
    out = {}
    for s, side in SIDES.items():
        cs, _ = _stub_cs(side, b"byz-%d-" % seed)
        h = side["byz"].ByzantineHarness(cs, "equivocation")
        vote = _vote(side, cs.priv_validator.priv_key, type_name, block_hash, 1)
        evil = h._conflicting_vote(vote, CHAIN)
        assert evil.block_id.hash != vote.block_id.hash and evil.height == vote.height
        assert cs.priv_validator.priv_key.pub_key().verify_signature(
            evil.sign_bytes(CHAIN), evil.signature)
        out[s] = evil.to_proto()
    assert out["t"] == out["j"]


@pytest.mark.parametrize("seed", [5, 6])
def test_forged_vote_is_the_reference_s(seed, monkeypatch):
    out = {}
    for s, side in SIDES.items():
        rng = np.random.default_rng(seed)
        monkeypatch.setattr(side["byz"].os, "urandom",
                            lambda n, rng=rng: rng.integers(0, 256, n, dtype=np.uint8).tobytes())
        cs, sent = _stub_cs(side, b"flood-")
        h = side["byz"].ByzantineHarness(cs, "flood")
        forged = [h._forged_vote(cs.rs) for _ in range(3)]
        assert all(v.validator_index == h._own_index(cs.rs) for v in forged)
        out[s] = [v.to_proto() for v in forged]
    assert out["t"] == out["j"]


def test_unknown_behaviour_fails_as_the_reference_s():
    got = {}
    for s, side in SIDES.items():
        cs, _ = _stub_cs(side, b"unknown-")
        with pytest.raises(ValueError) as e:
            side["byz"].make_byzantine(cs, "equivocate")
        # make_byzantine has swapped the signer before the harness refused
        assert isinstance(cs.priv_validator, side["byz"].UnsafeSigner)
        got[s] = str(e.value)
    assert got["t"] == got["j"]
    assert tbyz.BEHAVIORS == jbyz.BEHAVIORS


@pytest.fixture(autouse=True)
def _fresh():
    """The CPU backends on one torch thread (the plain batches run faster)."""
    yield from fresh_backends()


# ----------------------------------------------------------- CPU nets


def _config():
    """Timeouts of seconds: a plain batch costs ~1 s on the CPU."""
    return TConfig(timeout_propose=8.0, timeout_propose_delta=1.0, timeout_prevote=4.0,
                   timeout_prevote_delta=1.0, timeout_precommit=4.0,
                   timeout_precommit_delta=1.0, timeout_commit=0.05,
                   skip_timeout_commit=True, batch_vote_verification=True)


def test_silence_and_amnesia_cost_no_liveness_in_a_cpu_net():
    """val2 forgets its locks after every precommit and val3 never votes:
    the three voting validators hold +2/3 and the chain keeps committing."""
    heights = 3

    async def run():
        net = await H.make_net(4, config=_config(), chain_id=CHAIN, device="cpu", seed=22)
        harness = [tbyz.make_byzantine(net.nodes[2].cs, "amnesia"),
                   tbyz.make_byzantine(net.nodes[3].cs, "silence")]
        await net.start()
        try:
            await net.wait_for_height(heights, timeout=150.0)
        finally:
            for h in harness:
                await h.stop()
            await net.stop()
        return net

    net = asyncio.run(run())
    silent = net.privs[3].pub_key().address()
    for h in range(2, heights + 1):
        assert len({n.block_store.load_block(h).hash() for n in net.nodes}) == 1
        sigs = net.nodes[0].block_store.load_block(h).last_commit.signatures
        assert all(s.validator_address != silent for s in sigs if s.signature)


def test_own_echoed_equivocation_is_logged_not_a_consensus_failure():
    """A peer echoing an equivocating validator's second vote back to it
    (or its WAL replaying one) raises ErrVoteConflictingVotes from our own
    address in _try_add_vote. The reference lets it escape _handle_msg, a
    consensus failure that stops the liar, and stops its reformed restart at
    the WAL replay; the port logs it as CometBFT's handleMsg does (ROADMAP
    Queue 3 entry 39)."""
    from cometbft_tpu.consensus import messages as jM
    from cometbft_tpu.consensus.state import ConsensusState as JCS
    from cometbft_tpu.types.vote_set import ErrVoteConflictingVotes as JErr
    from cometbft_tpu_torch.consensus import messages as tM
    from cometbft_tpu_torch.consensus.state import ConsensusState as TCS
    from cometbft_tpu_torch.types.vote_set import ErrVoteConflictingVotes as TErr

    def stub(err_cls, log):
        async def try_add_vote(vote, peer_id):
            raise err_cls(vote, vote)

        return types.SimpleNamespace(
            _try_add_vote=try_add_vote,
            logger=types.SimpleNamespace(error=lambda msg, **k: log.append((msg, k))))

    t_side = SIDES["t"]
    cs, _ = _stub_cs(t_side, b"echo-")
    vote = _vote(t_side, cs.priv_validator.priv_key, "PREVOTE", b"\x05" * 32, 1)
    logged: list = []
    asyncio.run(TCS._handle_msg(stub(TErr, logged), tM.VoteMessage(vote=vote, peer_id="p1")))
    assert logged and logged[0][0] == "failed to process message"
    assert logged[0][1]["type"] == "Vote" and logged[0][1]["peer"] == "p1"

    j_side = SIDES["j"]
    jcs, _ = _stub_cs(j_side, b"echo-")
    jvote = _vote(j_side, jcs.priv_validator.priv_key, "PREVOTE", b"\x05" * 32, 1)
    with pytest.raises(JErr):
        asyncio.run(JCS._handle_msg(stub(JErr, []), jM.VoteMessage(vote=jvote, peer_id="p1")))
