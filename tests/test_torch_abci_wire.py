"""The port's ABCI protobuf codec (abci/proto_codec.py) against the JAX
package's: every Request and Response type, built alike in both packages'
types from one numpy seed (and from hypothesis-drawn fields), encodes to the
same bytes, and each package decodes the other's bytes to its own objects.
Bit-equal throughout.
"""

from __future__ import annotations

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from cometbft_tpu.abci import proto_codec as jpc
from cometbft_tpu.abci import types as jabci
from cometbft_tpu.types import params as jparams
from cometbft_tpu.utils import cmttime as jtime
from cometbft_tpu.utils import protobuf as jpb
from cometbft_tpu_torch.abci import proto_codec as tpc
from cometbft_tpu_torch.abci import types as tabci
from cometbft_tpu_torch.types import params as tparams
from cometbft_tpu_torch.utils import cmttime as ttime

JAX_SIDE = (jabci, jparams, jtime)
PORT_SIDE = (tabci, tparams, ttime)
SEED = 19


def _consensus_params(P, rng):
    return P.ConsensusParams(
        block=P.BlockParams(max_bytes=int(rng.integers(1, 1 << 22)), max_gas=-1),
        evidence=P.EvidenceParams(
            max_age_num_blocks=int(rng.integers(1, 10_000)),
            # a negative duration exercises the same-sign rule (:94-100)
            max_age_duration_ns=-int(rng.integers(1, 1 << 50)),
            max_bytes=int(rng.integers(1, 1 << 20))),
        validator=P.ValidatorParams(pub_key_types=["ed25519", "secp256k1"]),
        version=P.VersionParams(app=int(rng.integers(0, 100))),
        abci=P.ABCIParams(vote_extensions_enable_height=int(rng.integers(0, 100))),
    )


def _messages(side, seed: int = SEED) -> tuple[dict, dict]:
    """(requests, responses) by method, every field drawn from one seed."""
    A, P, T = side
    rng = np.random.default_rng(seed)

    def b(n):
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()

    def i(hi=1 << 40):
        return int(rng.integers(0, hi))

    def ts():
        return T.Timestamp(1_700_000_000 + i(1 << 20), i(10**9))

    def mis():
        return A.Misbehavior(type_="DUPLICATE_VOTE", validator_address=b(20),
                             validator_power=i(), height=i(), time=ts(),
                             total_voting_power=i())

    def commit_info():
        return A.CommitInfo(i(5), [A.VoteInfo(b(20), i(), 1 + i(3)) for _ in range(3)])

    def event(n):
        return A.Event(f"ev{i(9)}", [A.EventAttribute(f"k{j}", f"v{i()}", bool(j % 2))
                                     for j in range(n)])

    params = _consensus_params(P, rng)
    vals = [A.ValidatorUpdate("ed25519", b(32), i()), A.ValidatorUpdate("secp256k1", b(33), i())]
    reqs = {
        "echo": A.RequestEcho(message=f"echo-{i()}"),
        "flush": A.RequestFlush(),
        "info": A.RequestInfo(version="0.38", block_version=i(), p2p_version=i(),
                              abci_version="2.0.0"),
        "init_chain": A.RequestInitChain(time=ts(), chain_id="wire-chain",
                                         consensus_params=params, validators=vals,
                                         app_state_bytes=b(40), initial_height=1 + i()),
        "query": A.RequestQuery(data=b(12), path="/store", height=i(), prove=True),
        "check_tx": A.RequestCheckTx(tx=b(50), type_=A.CheckTxType.RECHECK),
        "commit": A.RequestCommit(),
        "list_snapshots": A.RequestListSnapshots(),
        "offer_snapshot": A.RequestOfferSnapshot(
            snapshot=A.Snapshot(i(), i(5), i(99), b(32), b(8)), app_hash=b(32)),
        "load_snapshot_chunk": A.RequestLoadSnapshotChunk(i(), i(5), i(99)),
        "apply_snapshot_chunk": A.RequestApplySnapshotChunk(i(99), b(64), "peer"),
        "prepare_proposal": A.RequestPrepareProposal(
            max_tx_bytes=i(), txs=[b(9), b""],
            local_last_commit=A.ExtendedCommitInfo(
                i(5), [A.ExtendedVoteInfo(b(20), i(), 2, b(7), b(64))]),
            misbehavior=[mis()], height=i(), time=ts(), next_validators_hash=b(32),
            proposer_address=b(20)),
        "process_proposal": A.RequestProcessProposal(
            txs=[b(9)], proposed_last_commit=commit_info(), misbehavior=[mis()], hash=b(32),
            height=i(), time=ts(), next_validators_hash=b(32), proposer_address=b(20)),
        "extend_vote": A.RequestExtendVote(
            hash=b(32), height=i(), round_=i(9), txs=[b(5)], proposed_last_commit=commit_info(),
            misbehavior=[mis()], next_validators_hash=b(32), proposer_address=b(20), time=ts()),
        "verify_vote_extension": A.RequestVerifyVoteExtension(
            hash=b(32), validator_address=b(20), height=i(), vote_extension=b(11)),
        "finalize_block": A.RequestFinalizeBlock(
            txs=[b(30), b"", b(3)], decided_last_commit=commit_info(), misbehavior=[mis()],
            hash=b(32), height=i(), time=ts(), next_validators_hash=b(32),
            proposer_address=b(20)),
    }
    resps = {
        "exception": "boom",
        "echo": A.ResponseEcho(message=f"echo-{i()}"),
        "flush": A.ResponseFlush(),
        "info": A.ResponseInfo(data="kv", version="1", app_version=i(), last_block_height=i(),
                               last_block_app_hash=b(32)),
        "init_chain": A.ResponseInitChain(consensus_params=_consensus_params(P, rng),
                                          validators=vals, app_hash=b(32)),
        "query": A.ResponseQuery(code=i(9), log="l", info="n", index=i(), key=b(4),
                                 value=b(20), proof_ops=[("iavl", b(4), b(16))], height=i(),
                                 codespace="app"),
        "check_tx": A.ResponseCheckTx(code=i(9), data=b(6), log="l", info="n", gas_wanted=i(),
                                      gas_used=i(), events=[event(2)], codespace="app"),
        "commit": A.ResponseCommit(retain_height=i()),
        "list_snapshots": A.ResponseListSnapshots(
            snapshots=[A.Snapshot(i(), i(5), i(99), b(32), b(4)) for _ in range(2)]),
        "offer_snapshot": A.ResponseOfferSnapshot(result=A.OfferSnapshotResult.ACCEPT),
        "load_snapshot_chunk": A.ResponseLoadSnapshotChunk(chunk=b(70)),
        "apply_snapshot_chunk": A.ResponseApplySnapshotChunk(
            result=A.ApplySnapshotChunkResult.RETRY, refetch_chunks=[i(9), i(9)],
            reject_senders=["p1", "p2"]),
        "prepare_proposal": A.ResponsePrepareProposal(txs=[b(8), b(2)]),
        "process_proposal": A.ResponseProcessProposal(status=A.ProposalStatus.ACCEPT),
        "extend_vote": A.ResponseExtendVote(vote_extension=b(13)),
        "verify_vote_extension": A.ResponseVerifyVoteExtension(status=A.VerifyStatus.REJECT),
        "finalize_block": A.ResponseFinalizeBlock(
            events=[event(3)],
            tx_results=[A.ExecTxResult(code=i(9), data=b(4), log="l", info="n", gas_wanted=i(),
                                       gas_used=i(), events=[event(1)], codespace="c")],
            validator_updates=vals, consensus_param_updates=_consensus_params(P, rng),
            app_hash=b(32)),
    }
    return reqs, resps


_JREQ, _JRESP = _messages(JAX_SIDE)
_TREQ, _TRESP = _messages(PORT_SIDE)


def _body(frame: bytes) -> bytes:
    body, _ = jpb.unmarshal_delimited(frame)
    return body


def test_every_method_is_covered():
    assert set(_JREQ) == set(jpc.REQUEST_FIELDS) == set(tpc.REQUEST_FIELDS)
    assert set(_JRESP) == set(jpc.RESPONSE_FIELDS) == set(tpc.RESPONSE_FIELDS)


def _same_decode(kind: str, method: str, frame: bytes) -> None:
    """Both packages decode `frame` to the same message (dataclass reprs do
    not name the package) and encode it back to the same bytes."""
    mj, dj = getattr(jpc, f"decode_{kind}_bytes")(_body(frame))
    mt, dt = getattr(tpc, f"decode_{kind}_bytes")(_body(frame))
    assert (mt, repr(dt)) == (mj, repr(dj)) and mt == method
    if method != "exception":
        assert (getattr(tpc, f"encode_{kind}")(mt, dt)
                == getattr(jpc, f"encode_{kind}")(mj, dj))


@pytest.mark.parametrize("method", sorted(_JREQ))
def test_request_bytes_and_cross_decode(method):
    want = jpc.encode_request(method, _JREQ[method])
    got = tpc.encode_request(method, _TREQ[method])
    assert got == want
    _same_decode("request", method, got)


@pytest.mark.parametrize("method", sorted(_JRESP))
def test_response_bytes_and_cross_decode(method):
    if method == "exception":
        want, got = jpc.encode_exception(_JRESP[method]), tpc.encode_exception(_TRESP[method])
    else:
        want = jpc.encode_response(method, _JRESP[method])
        got = tpc.encode_response(method, _TRESP[method])
    assert got == want
    _same_decode("response", method, got)


@pytest.mark.parametrize("ns", [0, 1, -1, 999_999_999, -999_999_999, -1_500_000_000,
                                -172800 * 10**9 - 500, 172800 * 10**9 + 500])
def test_duration_is_same_sign_in_both(ns):
    assert tpc._duration(ns) == jpc._duration(ns)
    assert tpc._dec_duration(tpc._duration(ns)) == ns


_text = st.text(max_size=24)
_blob = st.binary(max_size=64)
_i64 = st.integers(min_value=-(1 << 63), max_value=(1 << 63) - 1)
_u = st.integers(min_value=0, max_value=(1 << 63) - 1)


@settings(max_examples=40, deadline=None)
@given(tx=_blob, txs=st.lists(_blob, max_size=4), height=_i64, log=_text, code=st.integers(
    min_value=0, max_value=(1 << 32) - 1), gas=_i64, key=_text, value=_text, secs=st.integers(
    min_value=-(1 << 40), max_value=1 << 40), nanos=st.integers(min_value=0, max_value=10**9 - 1))
def test_drawn_fields_encode_alike(tx, txs, height, log, code, gas, key, value, secs, nanos):
    def build(A, T):
        ev = [A.Event(key or "t", [A.EventAttribute(key, value, True)])]
        return [
            ("request", "check_tx", A.RequestCheckTx(tx=tx)),
            ("request", "query", A.RequestQuery(data=tx, path=log, height=height)),
            ("request", "finalize_block", A.RequestFinalizeBlock(
                txs=txs, height=height, time=T.Timestamp(secs, nanos), hash=tx)),
            ("response", "check_tx", A.ResponseCheckTx(code=code, log=log, gas_wanted=gas,
                                                       events=ev)),
            ("response", "finalize_block", A.ResponseFinalizeBlock(
                events=ev, tx_results=[A.ExecTxResult(code=code, data=tx, gas_used=gas)],
                app_hash=tx)),
        ]

    for (kind, method, j), (_, _, t) in zip(build(jabci, jtime), build(tabci, ttime)):
        enc_j = getattr(jpc, f"encode_{kind}")(method, j)
        assert getattr(tpc, f"encode_{kind}")(method, t) == enc_j
        _same_decode(kind, method, enc_j)
