"""The port's remote signer (privval/remote.py) against the JAX package's,
both ways: the port's SignerClient with the JAX package's SignerServer, and
the JAX package's client with the port's server. Keys and messages come
from one numpy seed; every signature equals the one a local FilePV of the
same key in the other package makes, and a double sign raises ErrDoubleSign
in the client's package. Bit-equal.
"""

from __future__ import annotations

import threading

import numpy as np
import pytest

from cometbft_tpu.crypto import ed25519 as jed
from cometbft_tpu.privval import file_pv as jfpv
from cometbft_tpu.privval import remote as jremote
from cometbft_tpu.types import basic as jbasic
from cometbft_tpu.types.proposal import Proposal as JProposal
from cometbft_tpu.types.vote import Vote as JVote
from cometbft_tpu.utils import cmttime as jtime
from cometbft_tpu_torch.crypto import ed25519 as ted
from cometbft_tpu_torch.privval import file_pv as tfpv
from cometbft_tpu_torch.privval import remote as tremote
from cometbft_tpu_torch.types import basic as tbasic
from cometbft_tpu_torch.types.proposal import Proposal as TProposal
from cometbft_tpu_torch.types.vote import Vote as TVote
from cometbft_tpu_torch.utils import cmttime as ttime

SEED = 19
CHAIN = "remote-chain"
JAX = dict(ed=jed, fpv=jfpv, remote=jremote, basic=jbasic, Vote=JVote, Proposal=JProposal,
           time=jtime)
PORT = dict(ed=ted, fpv=tfpv, remote=tremote, basic=tbasic, Vote=TVote, Proposal=TProposal,
            time=ttime)
SIDES = {"jax": JAX, "port": PORT}
DIRECTIONS = [("port", "jax"), ("jax", "port")]  # (client, server)


def _secret() -> bytes:
    return np.random.default_rng(SEED).integers(0, 256, 32, dtype=np.uint8).tobytes()


def _block_id(S, rng):
    b = rng.integers(0, 256, 64, dtype=np.uint8).tobytes()
    return S["basic"].BlockID(hash=b[:32], part_set_header=S["basic"].PartSetHeader(
        total=1, hash=b[32:]))


def _vote(S, height, rng, addr, ext=b""):
    v = S["Vote"](type_=S["basic"].SignedMsgType.PRECOMMIT, height=height, round_=0,
                  block_id=_block_id(S, rng),
                  timestamp=S["time"].Timestamp(1_700_000_000 + height, 0),
                  validator_address=addr, validator_index=0)
    if ext:
        v.extension = ext
    return v


@pytest.fixture(params=DIRECTIONS, ids=lambda d: f"{d[0]}-client-{d[1]}-server")
def pair(request):
    client_side, server_side = (SIDES[k] for k in request.param)
    priv = server_side["ed"].gen_priv_key_from_secret(_secret())
    client = client_side["remote"].SignerClient(("127.0.0.1", 0), timeout=5.0,
                                                accept_timeout=5.0)
    server = server_side["remote"].SignerServer(server_side["fpv"].FilePV(priv), client.laddr)
    server.start()
    t = threading.Thread(target=client.accept)
    t.start()
    t.join(timeout=5.0)
    assert client._conn is not None, "the signer never dialed in"
    other = [s for k, s in SIDES.items() if s is not client_side][0]
    local = other["fpv"].FilePV(other["ed"].gen_priv_key_from_secret(_secret()))
    yield client_side, other, client, local
    client.close()
    server.stop()


def test_pub_key_and_ping(pair):
    _, _, client, local = pair
    client.ping()
    assert client.get_pub_key().bytes_() == local.get_pub_key().bytes_()


@pytest.mark.parametrize("ext", [b"", b"ext-payload"], ids=["plain", "extension"])
def test_sign_vote_equals_a_local_file_pv(pair, ext):
    S, other, client, local = pair
    rng = np.random.default_rng(SEED + 1)
    addr = local.get_pub_key().address()
    v = _vote(S, 5, rng, addr, ext)
    client.sign_vote(CHAIN, v, sign_extension=bool(ext))
    w = other["Vote"].from_proto(v.to_proto())
    w.signature = w.extension_signature = b""
    local.sign_vote(CHAIN, w, sign_extension=bool(ext))
    assert (v.signature, v.extension_signature) == (w.signature, w.extension_signature)
    assert v.to_proto() == w.to_proto()


def test_double_sign_raises_in_both(pair):
    S, _, client, _ = pair
    rng = np.random.default_rng(SEED + 2)
    addr = client.get_pub_key().address()
    client.sign_vote(CHAIN, _vote(S, 7, rng, addr))
    with pytest.raises(S["fpv"].ErrDoubleSign):
        client.sign_vote(CHAIN, _vote(S, 7, rng, addr))  # same HRS, another block


def test_sign_proposal_equals_a_local_file_pv(pair):
    S, other, client, local = pair
    rng = np.random.default_rng(SEED + 3)
    p = S["Proposal"](height=9, round_=0, pol_round=-1, block_id=_block_id(S, rng),
                      timestamp=S["time"].Timestamp(1_700_000_009, 0))
    client.sign_proposal(CHAIN, p)
    q = other["Proposal"].from_proto(p.to_proto())
    q.signature = b""
    local.sign_proposal(CHAIN, q)
    assert p.signature == q.signature and p.to_proto() == q.to_proto()


def test_frames_are_the_same_bytes():
    payload = np.random.default_rng(SEED).integers(0, 256, 77, dtype=np.uint8).tobytes()
    for tag in range(1, 9):
        body = jremote._err_body(CHAIN, payload, "err" * (tag % 2), sign_extension=tag > 4)
        assert tremote._err_body(CHAIN, payload, "err" * (tag % 2),
                                 sign_extension=tag > 4) == body
        assert tremote._frame(tag, body) == jremote._frame(tag, body)
        assert tremote._parse_body(body) == jremote._parse_body(body)
