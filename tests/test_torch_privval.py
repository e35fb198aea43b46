"""The port's FilePV (privval/file_pv.py) and Proposal (types/proposal.py)
against the JAX package's: the same signature bytes for votes, vote
extensions and proposals; the same refusals for a double sign (height,
round and step regressions, conflicting data at one HRS) and the same
re-signs (the same bytes, a timestamp-only difference, which keeps the
first timestamp); key and last-sign-state files that either package writes
and the other loads, ed25519 and BLS12-381. Exact.
"""

from __future__ import annotations

import hashlib
import json
import os

import pytest

from cometbft_tpu.crypto import bls12381 as jbls
from cometbft_tpu.crypto import ed25519 as jed
from cometbft_tpu.privval import file_pv as jpv
from cometbft_tpu.types import proposal as jprop
from cometbft_tpu.types import vote as jvote
from cometbft_tpu.types.basic import BlockID as JBlockID
from cometbft_tpu.types.basic import PartSetHeader as JPSH
from cometbft_tpu.types.basic import SignedMsgType as JT
from cometbft_tpu.utils import cmttime as jtime
from cometbft_tpu_torch.crypto import bls12381 as tbls
from cometbft_tpu_torch.crypto import ed25519 as ted
from cometbft_tpu_torch.privval import file_pv as tpv
from cometbft_tpu_torch.types import proposal as tprop
from cometbft_tpu_torch.types import vote as tvote
from cometbft_tpu_torch.types.basic import BlockID as TBlockID
from cometbft_tpu_torch.types.basic import PartSetHeader as TPSH
from cometbft_tpu_torch.types.basic import SignedMsgType as TT
from cometbft_tpu_torch.utils import cmttime as ttime

CHAIN = "privval-chain"
J = dict(pv=jpv, prop=jprop, vote=jvote, BlockID=JBlockID, PSH=JPSH, T=JT, time=jtime,
         ed=jed, bls=jbls)
P = dict(pv=tpv, prop=tprop, vote=tvote, BlockID=TBlockID, PSH=TPSH, T=TT, time=ttime,
         ed=ted, bls=tbls)


def _bid(m, tag: bytes):
    h = hashlib.sha256(tag).digest()
    return m["BlockID"](h, m["PSH"](1, hashlib.sha256(h).digest()))


def _vote(m, addr, type_, h, r, tag, ts_ns=0, ext=b""):
    bid = m["BlockID"]() if tag is None else _bid(m, tag)
    return m["vote"].Vote(type_=type_, height=h, round_=r, block_id=bid,
                          timestamp=m["time"].Timestamp(1_700_000_000 + h, ts_ns),
                          validator_address=addr, validator_index=2, extension=ext)


def _proposal(m, h, r, tag, ts_ns=0, pol=-1):
    return m["prop"].Proposal(height=h, round_=r, pol_round=pol, block_id=_bid(m, tag),
                              timestamp=m["time"].Timestamp(1_700_000_000 + h, ts_ns))


def _steps(m):
    """(kind, args) of one signer's life: signs, re-signs and refusals."""
    T = m["T"]
    return [
        ("vote", (T.PREVOTE, 5, 0, b"a", 0)),
        ("vote", (T.PREVOTE, 5, 0, b"a", 0)),            # same bytes: cached signature
        ("vote", (T.PREVOTE, 5, 0, b"a", 7_000_000)),    # timestamp only: first timestamp
        ("vote", (T.PREVOTE, 5, 0, b"b", 0)),            # conflicting data
        ("vote", (T.PREVOTE, 5, 0, None, 0)),            # nil at the same HRS
        ("ext", (T.PRECOMMIT, 5, 0, b"a", 0)),           # precommit with an extension
        ("vote", (T.PREVOTE, 5, 0, b"a", 0)),            # step regression
        ("proposal", (5, 1, b"c", 0)),
        ("proposal", (5, 1, b"c", 9_000)),               # timestamp only
        ("proposal", (5, 1, b"d", 0)),                   # conflicting proposal
        ("vote", (T.PRECOMMIT, 5, 0, b"a", 0)),          # round regression
        ("vote", (T.PRECOMMIT, 6, 2, None, 0)),
        ("vote", (T.PREVOTE, 4, 9, b"a", 0)),            # height regression
        ("proposal", (6, 2, b"e", 0)),                   # step regression (propose < precommit)
    ]


def _run(m, pv):
    addr = pv.get_pub_key().address()
    out = []
    for kind, args in _steps(m):
        try:
            if kind == "proposal":
                p = _proposal(m, *args)
                pv.sign_proposal(CHAIN, p)
                out.append(("ok", p.signature, p.timestamp.unix_ns(), p.sign_bytes(CHAIN),
                            p.to_proto()))
            else:
                v = _vote(m, addr, *args, ext=b"ext-%d" % args[1] if kind == "ext" else b"")
                pv.sign_vote(CHAIN, v, sign_extension=kind == "ext")
                out.append(("ok", v.signature, v.extension_signature, v.timestamp.unix_ns(),
                            v.sign_bytes(CHAIN)))
        except Exception as e:  # noqa: BLE001 - the outcome is what is compared
            out.append((type(e).__name__, str(e)))
    st = pv.last_sign_state
    out.append((st.height, st.round_, st.step, st.signature, st.sign_bytes))
    return out


@pytest.mark.parametrize("files", [False, True], ids=["memory", "files"])
def test_signatures_and_double_sign_refusals_are_the_reference_s(tmp_path, files):
    got = []
    for name, m in (("jax", J), ("port", P)):
        priv = m["ed"].gen_priv_key_from_secret(b"privval-key")
        kw = {}
        if files:
            kw = dict(key_file=str(tmp_path / f"{name}_key.json"),
                      state_file=str(tmp_path / f"{name}_state.json"))
        pv = m["pv"].FilePV(priv, **kw)
        if files:
            pv.save_key()
        got.append(_run(m, pv))
    assert got[0] == got[1]
    kinds = [o[0] for o in got[1][:-1]]
    assert kinds.count("ErrDoubleSign") == 7 and kinds.count("ok") == 7
    if files:
        for f in ("key", "state"):
            assert (tmp_path / f"jax_{f}.json").read_bytes() == \
                (tmp_path / f"port_{f}.json").read_bytes()


@pytest.mark.parametrize("writer,reader", [(J, P), (P, J)], ids=["jax-to-port", "port-to-jax"])
@pytest.mark.parametrize("scheme", ["ed25519", "bls12381"])
def test_files_written_by_one_package_load_in_the_other(tmp_path, writer, reader, scheme):
    key, state = str(tmp_path / "key.json"), str(tmp_path / "state.json")
    mod = "ed" if scheme == "ed25519" else "bls"
    w = writer["pv"].FilePV(writer[mod].gen_priv_key_from_secret(b"privval-files"), key, state)
    w.save_key()
    addr = w.get_pub_key().address()
    v = _vote(writer, addr, writer["T"].PREVOTE, 8, 1, b"x")
    w.sign_vote(CHAIN, v)
    r = reader["pv"].FilePV.load(key, state)
    assert r.get_pub_key().bytes_() == w.get_pub_key().bytes_()
    assert r.last_sign_state.sign_bytes == w.last_sign_state.sign_bytes
    # the reader re-signs the writer's vote from its state file, refuses a
    # conflicting one, and signs the next step as the writer would
    again = _vote(reader, addr, reader["T"].PREVOTE, 8, 1, b"x", ts_ns=5)
    r.sign_vote(CHAIN, again)
    assert again.signature == v.signature and again.timestamp.unix_ns() == v.timestamp.unix_ns()
    with pytest.raises(reader["pv"].ErrDoubleSign):
        r.sign_vote(CHAIN, _vote(reader, addr, reader["T"].PREVOTE, 8, 1, b"y"))
    nxt = [_vote(m, addr, m["T"].PRECOMMIT, 8, 1, b"x") for m in (writer, reader)]
    w.sign_vote(CHAIN, nxt[0])
    r.sign_vote(CHAIN, nxt[1])
    assert nxt[0].signature == nxt[1].signature
    doc = json.loads(open(key).read())
    assert doc["address"] == addr.hex().upper() and os.path.exists(state)


def test_proposal_sign_bytes_proto_and_validation_are_the_reference_s():
    got = []
    for m in (J, P):
        priv = m["ed"].gen_priv_key_from_secret(b"proposer")
        rows = []
        for h, r, pol, ns in ((1, 0, -1, 0), (7, 3, 2, 123_456_789), (2**40, 0, 0, 1)):
            p = _proposal(m, h, r, b"p%d" % h, ns, pol)
            p.signature = priv.sign(p.sign_bytes(CHAIN))
            back = m["prop"].Proposal.from_proto(p.to_proto())
            rows.append((p.sign_bytes(CHAIN), p.to_proto(), back.to_proto(),
                         p.verify(CHAIN, priv.pub_key()), str(p)))
        bad = _proposal(m, 1, 0, b"q", 0, pol=5)
        try:
            bad.validate_basic()
            rows.append("ok")
        except ValueError as e:
            rows.append(str(e))
        got.append(rows)
    assert got[0] == got[1]
