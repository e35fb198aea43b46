"""The port's ABCI layer against the JAX package's: the codec's frames
(abci/codec.py), the kvstore app (abci/kvstore.py: CheckTx, ProcessProposal,
FinalizeBlock results and app hash, Commit, Query, Info, validator updates,
misbehavior), the in-process client (abci/client.py LocalClient) and
AppConns (proxy/app_conns.py). Exact: the same bytes, the same responses.
"""

from __future__ import annotations

import asyncio
import base64
import threading

import pytest

from cometbft_tpu.abci import codec as jcodec
from cometbft_tpu.abci import kvstore as jkv
from cometbft_tpu.abci import types as jabci
from cometbft_tpu.crypto import ed25519 as jed
from cometbft_tpu.proxy import AppConns as JAppConns
from cometbft_tpu.proxy import local_client_creator as jlocal
from cometbft_tpu.utils import cmttime as jtime
from cometbft_tpu_torch.abci import codec as tcodec
from cometbft_tpu_torch.abci import kvstore as tkv
from cometbft_tpu_torch.abci import types as tabci
from cometbft_tpu_torch.proxy import AppConns as TAppConns
from cometbft_tpu_torch.proxy import local_client_creator as tlocal
from cometbft_tpu_torch.utils import cmttime as ttime

SIDES = [(jabci, jcodec, jkv, jtime), (tabci, tcodec, tkv, ttime)]
VAL_PUB = jed.gen_priv_key_from_secret(b"abci-val").pub_key().bytes_()


def _requests(abci, cmttime):
    ts = cmttime.Timestamp(1_700_000_123, 456_000_000)
    return [
        ("echo", abci.RequestEcho(message="hi")),
        ("info", abci.RequestInfo(version="0.38")),
        ("check_tx", abci.RequestCheckTx(tx=b"k=v", type_=abci.CheckTxType.RECHECK)),
        ("prepare_proposal", abci.RequestPrepareProposal(
            max_tx_bytes=1024, txs=[b"a=1", b"\xff"], height=3, time=ts,
            local_last_commit=abci.ExtendedCommitInfo(round_=1, votes=[abci.ExtendedVoteInfo(
                validator_address=b"\x01" * 20, validator_power=10, block_id_flag=2,
                vote_extension=b"ext", extension_signature=b"\x02" * 64)]),
            misbehavior=[abci.Misbehavior(type_=1, validator_address=b"\x03" * 20,
                                          validator_power=10, height=2, time=ts,
                                          total_voting_power=40)],
            next_validators_hash=b"\x04" * 32, proposer_address=b"\x05" * 20)),
        ("finalize_block", abci.RequestFinalizeBlock(
            txs=[b"x=y"], hash=b"\x06" * 32, height=4, time=ts,
            decided_last_commit=abci.CommitInfo(round_=0, votes=[abci.VoteInfo(
                validator_address=b"\x07" * 20, validator_power=5, block_id_flag=3)]))),
        ("extend_vote", abci.RequestExtendVote(hash=b"\x08" * 32, height=4, round_=2)),
        ("commit", abci.RequestCommit()),
    ]


def _responses(abci):
    return [
        ("check_tx", abci.ResponseCheckTx(code=1, log="bad", gas_wanted=3)),
        ("finalize_block", abci.ResponseFinalizeBlock(
            tx_results=[abci.ExecTxResult(code=0, events=[abci.Event(
                type_="app", attributes=[abci.EventAttribute(key="key", value="x")])]),
                abci.ExecTxResult(code=1, log="invalid tx")],
            validator_updates=[abci.ValidatorUpdate(pub_key_type="ed25519",
                                                    pub_key_bytes=VAL_PUB, power=7)],
            app_hash=b"\x09" * 32)),
        ("process_proposal", abci.ResponseProcessProposal(status=abci.ProposalStatus.REJECT)),
        ("commit", abci.ResponseCommit(retain_height=9)),
    ]


def test_codec_frames_are_the_reference_s():
    frames = []
    for abci, codec, _, cmttime in SIDES:
        frames.append([codec.encode_request(m, r) for m, r in _requests(abci, cmttime)]
                      + [codec.encode_response(m, r) for m, r in _responses(abci)]
                      + [codec.encode_exception("boom")])
    assert frames[0] == frames[1]
    # the reference's frames decode in the port to what re-encodes to them
    import io

    for (m, _), frame in zip(_requests(tabci, ttime), frames[0]):
        name, req = tcodec.decode_request(io.BytesIO(frame))
        assert name == m and tcodec.encode_request(name, req) == frame
    n = len(_requests(tabci, ttime))
    for (m, _), frame in zip(_responses(tabci), frames[0][n:]):
        name, resp = tcodec.decode_response(io.BytesIO(frame))
        assert name == m and tcodec.encode_response(name, resp) == frame


def test_exec_tx_result_hash_bytes_are_the_reference_s():
    got = [[r.hash_bytes() for r in _responses(abci)[1][1].tx_results] for abci, *_ in SIDES]
    assert got[0] == got[1]


BLOCKS = [
    [b"a=1", b"b=2", b"a=3"],
    [b"val:" + base64.b64encode(VAL_PUB) + b"!12", b"val:nope", b"\xff\xfe", b"plain"],
    [],
    [b"c=" + b"x" * 300, b"k=v=w"],
]


def _kv_run(abci, codec, kv, cmttime):
    app = kv.KVStoreApplication()
    out = [codec.encode_response("init_chain", app.init_chain(abci.RequestInitChain(
        validators=[abci.ValidatorUpdate(pub_key_type="ed25519", pub_key_bytes=VAL_PUB,
                                         power=10)],
        app_state_bytes=b'{"seed": "1", "n": 2}')))]
    for h, txs in enumerate(BLOCKS, start=1):
        for tx in txs:
            out.append(codec.encode_response("check_tx", app.check_tx(
                abci.RequestCheckTx(tx=tx))))
        out.append(codec.encode_response("process_proposal", app.process_proposal(
            abci.RequestProcessProposal(txs=txs, height=h))))
        mis = [abci.Misbehavior(type_=1, validator_address=b"\x01" * 20, validator_power=10,
                                height=h, time=cmttime.Timestamp(h, 0),
                                total_voting_power=10)] if h == 3 else []
        resp = app.finalize_block(abci.RequestFinalizeBlock(
            txs=txs, height=h, time=cmttime.Timestamp(1_700_000_000 + h, 0), misbehavior=mis))
        out.append(codec.encode_response("finalize_block", resp))
        out.append(codec.encode_response("commit", app.commit(abci.RequestCommit())))
        out.append(app.app_hash)
    out.append(codec.encode_response("info", app.info(abci.RequestInfo())))
    for key in (b"a", b"c", b"seed", b"missing", b"__misbehavior_count__"):
        out.append(codec.encode_response("query", app.query(abci.RequestQuery(data=key))))
    out.append(codec.encode_response("query", app.query(abci.RequestQuery(
        data=b"a", path="/other"))))
    return out


def test_kvstore_finalize_results_and_app_hash_are_the_reference_s():
    got = [_kv_run(*side) for side in SIDES]
    assert got[0] == got[1]


def test_app_conns_serialise_the_app_as_the_reference_s():
    """Four logical connections over one local creator: one app lock (no
    two calls inside the app at once), sequential calls in order, and
    the same responses."""
    async def run(abci, kv, AppConns, local):
        app = kv.KVStoreApplication()
        inside, calls, overlap = [0], [], []
        lock = threading.Lock()

        def wrap(name):
            fn = getattr(app, name)

            def call(req):
                with lock:
                    inside[0] += 1
                    overlap.append(inside[0])
                calls.append(name)
                try:
                    return fn(req)
                finally:
                    with lock:
                        inside[0] -= 1
            return call

        for name in ("check_tx", "finalize_block", "commit", "query", "info"):
            setattr(app, name, wrap(name))
        conns = AppConns(local(app))
        await conns.start()
        try:
            seq = [await conns.mempool.check_tx(abci.RequestCheckTx(tx=b"a=1")),
                   await conns.consensus.finalize_block(abci.RequestFinalizeBlock(
                       txs=[b"a=1"], height=1)),
                   await conns.consensus.commit(abci.RequestCommit()),
                   await conns.query.query(abci.RequestQuery(data=b"a"))]
            order = list(calls)
            many = await asyncio.gather(*(
                conns.mempool.check_tx(abci.RequestCheckTx(tx=b"k%d=v" % i))
                for i in range(16)), conns.query.info(abci.RequestInfo()))
            echo = await conns.query.echo("x")
        finally:
            await conns.stop()
        return ([repr(r) for r in seq], order, [repr(r) for r in many], max(overlap),
                echo.message)

    got = [asyncio.run(run(abci, kv, a, c)) for (abci, _, kv, _), a, c in
           zip(SIDES, (JAppConns, TAppConns), (jlocal, tlocal))]
    assert got[0] == got[1]
    assert got[1][1] == ["check_tx", "finalize_block", "commit", "query"]
    assert got[1][3] == 1


@pytest.mark.parametrize("method", ["socket_client_creator", "grpc_client_creator"])
def test_remote_creators_are_not_in_the_port_yet(method):
    from cometbft_tpu import proxy as jproxy
    from cometbft_tpu_torch import proxy as tproxy

    assert hasattr(jproxy, method) and not hasattr(tproxy, method)
