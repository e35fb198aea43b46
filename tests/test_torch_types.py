"""The port's types/ (sign bytes, commits, validator sets) against the JAX
package's, on the same seeded inputs: canonical sign bytes bit for bit
(Vote.sign_bytes, Commit.vote_sign_bytes, every row of
vote_sign_bytes_all, factored and materialized), Merkle roots,
ValidatorSet.hash() and the proposer rotation, and the protobuf codec under
them. Pure host code: no device, no kernel.
"""

from __future__ import annotations

import hashlib

import numpy as np
import pytest

from cometbft_tpu.crypto import ed25519 as jed
from cometbft_tpu.crypto import merkle as jmerkle
from cometbft_tpu.crypto import sr25519 as jsr
from cometbft_tpu.types import basic as jbasic
from cometbft_tpu.types import commit as jcommit
from cometbft_tpu.types import validator as jvalidator
from cometbft_tpu.types import vote as jvote
from cometbft_tpu.utils import cmttime as jtime
from cometbft_tpu.utils import protobuf as jpb
from cometbft_tpu_torch import crypto as tcrypto
from cometbft_tpu_torch.crypto import ed25519 as ted
from cometbft_tpu_torch.crypto import merkle as tmerkle
from cometbft_tpu_torch.crypto import sr25519 as tsr
from cometbft_tpu_torch.libs.prefixrows import PrefixedMsg
from cometbft_tpu_torch.types import basic as tbasic
from cometbft_tpu_torch.types import commit as tcommit
from cometbft_tpu_torch.types import validator as tvalidator
from cometbft_tpu_torch.types import vote as tvote
from cometbft_tpu_torch.utils import cmttime as ttime
from cometbft_tpu_torch.utils import protobuf as tpb


def _block_ids(tag: bytes):
    h = hashlib.sha256(tag).digest()
    psh = hashlib.sha256(tag + b"parts").digest()
    return (tbasic.BlockID(h, tbasic.PartSetHeader(3, psh)),
            jbasic.BlockID(h, jbasic.PartSetHeader(3, psh)))


def _commits(n: int, seed: int, height: int = 7, round_: int = 0):
    """The same commit in both packages: n signatures, ~10% ABSENT, ~10%
    NIL, a few timestamps whose encoding is shorter (nanos < 2^28) or longer
    (seconds past 2^35) than the rest."""
    rng = np.random.default_rng(seed)
    tbid, jbid = _block_ids(b"block-%d" % seed)
    tsigs, jsigs = [], []
    for i in range(n):
        r = rng.random()
        flag = 1 if r < 0.1 else (3 if r < 0.2 else 2)  # ABSENT, NIL, COMMIT
        if flag == 1:
            tsigs.append(tcommit.CommitSig.absent())
            jsigs.append(jcommit.CommitSig.absent())
            continue
        secs, nanos = 1_700_000_000, (1 << 28) + int(rng.integers(0, 1 << 20))
        if rng.random() < 0.1:
            nanos = int(rng.integers(0, 1000))
        elif rng.random() < 0.05:
            secs = (1 << 35) + 1
        addr, sig = rng.bytes(20), rng.bytes(64)
        tsigs.append(tcommit.CommitSig(tbasic.BlockIDFlag(flag), addr,
                                       ttime.Timestamp(secs, nanos), sig))
        jsigs.append(jcommit.CommitSig(jbasic.BlockIDFlag(flag), addr,
                                       jtime.Timestamp(secs, nanos), sig))
    return (tcommit.Commit(height, round_, tbid, tsigs),
            jcommit.Commit(height, round_, jbid, jsigs))


@pytest.mark.parametrize("n,seed,chain", [(1, 1, "c"), (9, 2, "cosmoshub-4"),
                                          (40, 3, "test-chain-x" * 4), (150, 4, "cosmoshub-4")])
def test_commit_sign_bytes_equal_reference(n, seed, chain):
    tc, jc = _commits(n, seed, height=1_000_000 + seed, round_=seed % 3)
    trows, jrows = tc.vote_sign_bytes_all(chain), jc.vote_sign_bytes_all(chain)
    assert trows.prefix == jrows.prefix
    assert trows.exceptions == jrows.exceptions
    for i in range(n):
        want = jc.vote_sign_bytes(chain, i)
        assert tc.vote_sign_bytes(chain, i) == want
        assert trows[i] == want == jrows[i]
    # the factored form: the same rows, one prefix object for the shared ones
    live = [i for i in range(n) if tc.signatures[i].block_id_flag != tbasic.BlockIDFlag.ABSENT]
    got = trows.rows_for(live)
    assert [bytes(m) if isinstance(m, PrefixedMsg) else m for m in got] == \
        [jc.vote_sign_bytes(chain, i) for i in live]
    assert len({id(m.prefix) for m in got if isinstance(m, PrefixedMsg)}) <= 1
    assert tc.hash() == jc.hash()
    assert tc.to_proto() == jc.to_proto()
    assert tcommit.Commit.from_proto(tc.to_proto()).vote_sign_bytes(chain, n - 1) == \
        jc.vote_sign_bytes(chain, n - 1)


def test_commit_with_no_commit_flags_has_only_exception_rows():
    tc, jc = _commits(12, 5)
    for cs in tc.signatures:
        if cs.block_id_flag == tbasic.BlockIDFlag.COMMIT:
            cs.block_id_flag = tbasic.BlockIDFlag.NIL
    for cs in jc.signatures:
        if cs.block_id_flag == jbasic.BlockIDFlag.COMMIT:
            cs.block_id_flag = jbasic.BlockIDFlag.NIL
    trows = tc.vote_sign_bytes_all("x")
    assert all(s is None for s in trows.suffixes)
    assert [trows[i] for i in range(12)] == [jc.vote_sign_bytes("x", i) for i in range(12)]


@pytest.mark.parametrize("flag,nil", [(1, False), (2, False), (2, True), (1, True)])
def test_vote_sign_bytes_equal_reference(flag, nil):
    tbid, jbid = _block_ids(b"vote")
    if nil:
        tbid, jbid = tbasic.BlockID(), jbasic.BlockID()
    kw = dict(height=12345, round_=2, validator_address=b"\x07" * 20, validator_index=3,
              signature=b"\x01" * 64)
    tv = tvote.Vote(tbasic.SignedMsgType(flag), block_id=tbid,
                    timestamp=ttime.Timestamp(1_700_000_001, 999), **kw)
    jv = jvote.Vote(jbasic.SignedMsgType(flag), block_id=jbid,
                    timestamp=jtime.Timestamp(1_700_000_001, 999), **kw)
    for chain in ("", "cosmoshub-4"):
        assert tv.sign_bytes(chain) == jv.sign_bytes(chain)
    assert tv.to_proto() == jv.to_proto()
    assert tvote.Vote.from_proto(tv.to_proto()).sign_bytes("c") == jv.sign_bytes("c")


def test_commit_get_vote_sign_bytes_equal():
    tc, jc = _commits(20, 6)
    for i, cs in enumerate(tc.signatures):
        if cs.block_id_flag != tbasic.BlockIDFlag.ABSENT:
            assert tc.get_vote(i).sign_bytes("z") == jc.get_vote(i).sign_bytes("z")


@pytest.mark.parametrize("v", [0, 1, 127, 128, 300, 2**28, 2**35 + 1, 2**63 - 1, 2**64 - 1])
def test_protobuf_varints_equal_reference(v):
    assert tpb.encode_uvarint(v) == jpb.encode_uvarint(v)
    assert tpb.decode_uvarint(tpb.encode_uvarint(v)) == (v, len(jpb.encode_uvarint(v)))
    if v < 2**63:
        assert tpb.encode_varint_i64(-v) == jpb.encode_varint_i64(-v)
        assert tpb.timestamp_bytes(v, v % 10**9) == jpb.timestamp_bytes(v, v % 10**9)


@pytest.mark.parametrize("n", [0, 1, 2, 3, 5, 8, 13, 100])
def test_merkle_roots_equal_reference(n):
    items = [hashlib.sha256(b"leaf-%d" % i).digest()[: 1 + i % 32] for i in range(n)]
    assert tmerkle.hash_from_byte_slices(items) == jmerkle.hash_from_byte_slices(items)
    assert tmerkle.hash_from_byte_slices(items[:n // 2]) != \
        tmerkle.hash_from_byte_slices(items[:n // 2] + [b"x"])


def _sets(n: int, seed: int, scheme: str = "ed25519", powers=None):
    """The same validator set in both packages, keys from the seed."""
    tvals, jvals = [], []
    for i in range(n):
        secret = b"types-%d-%d" % (seed, i)
        kind = scheme if scheme != "mixed" else ("ed25519" if i % 2 == 0 else "sr25519")
        if kind == "ed25519":
            pub = ted.gen_priv_key_from_secret(secret).pub_key().bytes_()
            tpub, jpub = ted.PubKey(pub), jed.PubKey(pub)
        else:
            pub = tsr.gen_priv_key_from_secret(secret).pub_key().bytes_()
            tpub, jpub = tsr.PubKey(pub), jsr.PubKey(pub)
        power = powers[i] if powers else 10
        tvals.append(tvalidator.Validator.new(tpub, power))
        jvals.append(jvalidator.Validator.new(jpub, power))
    return tvalidator.ValidatorSet(tvals), jvalidator.ValidatorSet(jvals)


@pytest.mark.parametrize("n,scheme", [(1, "ed25519"), (4, "sr25519"), (7, "mixed"),
                                      (150, "ed25519")])
def test_validator_set_hash_equal_reference(n, scheme):
    tv, jv = _sets(n, n, scheme)
    assert tv.hash() == jv.hash()
    assert [v.address for v in tv.validators] == [v.address for v in jv.validators]
    assert [v.bytes_() for v in tv.validators] == [v.bytes_() for v in jv.validators]
    assert tv.to_proto() == jv.to_proto()
    back = tvalidator.ValidatorSet.from_proto(tv.to_proto())
    assert back.hash() == jv.hash() and back.total_voting_power() == jv.total_voting_power()


@pytest.mark.parametrize("powers", [[10, 10, 10, 10], [1, 2, 3, 4, 100],
                                    [7, 1, 1, 1, 1, 1, 1, 50, 3]])
def test_proposer_rotation_equal_reference(powers):
    tv, jv = _sets(len(powers), 99, "ed25519", powers)
    for _ in range(20):
        assert tv.get_proposer().address == jv.get_proposer().address
        assert [v.proposer_priority for v in tv.validators] == \
            [v.proposer_priority for v in jv.validators]
        tv.increment_proposer_priority(1)
        jv.increment_proposer_priority(1)
    tv.increment_proposer_priority(7)
    jv.increment_proposer_priority(7)
    assert [v.proposer_priority for v in tv.validators] == \
        [v.proposer_priority for v in jv.validators]


def test_update_with_change_set_equal_reference():
    tv, jv = _sets(6, 5, "ed25519", [5, 6, 7, 8, 9, 10])
    tnew, jnew = _sets(2, 77, "ed25519", [40, 3])
    tv.update_with_change_set([tnew.validators[0], tvalidator.Validator(
        tv.validators[1].address, tv.validators[1].pub_key, 0)])
    jv.update_with_change_set([jnew.validators[0], jvalidator.Validator(
        jv.validators[1].address, jv.validators[1].pub_key, 0)])
    assert tv.hash() == jv.hash()
    for _ in range(5):
        tv.increment_proposer_priority(1)
        jv.increment_proposer_priority(1)
        assert tv.get_proposer().address == jv.get_proposer().address


def test_get_by_address_and_total_power():
    tv, jv = _sets(9, 3, "mixed", list(range(1, 10)))
    assert tv.total_voting_power() == jv.total_voting_power() == 45
    for v in jv.validators:
        ti, tval = tv.get_by_address(v.address)
        ji, _ = jv.get_by_address(v.address)
        assert ti == ji and tval.pub_key.bytes_() == v.pub_key.bytes_()
    assert tv.get_by_address(b"\x00" * 20) == (-1, None)


@pytest.mark.parametrize("kind", ["ed25519", "sr25519"])
def test_pub_key_proto_round_trip(kind):
    mod = ted if kind == "ed25519" else tsr
    pub = mod.gen_priv_key_from_secret(b"proto").pub_key()
    data = tvalidator.pub_key_to_proto(pub)
    jmod = jed if kind == "ed25519" else jsr
    assert data == jvalidator.pub_key_to_proto(jmod.PubKey(pub.bytes_()))
    back = tvalidator.pub_key_from_proto(data)
    assert back == pub and back.type_() == kind


@pytest.mark.parametrize("field,size,kind", [(2, 33, "secp256k1"), (4, 48, "bls12381")])
def test_pub_key_from_proto_decodes_secp256k1_and_bls12381(field, size, kind):
    """secp256k1 (field 2) and bls12381 (field 4) decode to the port's keys
    of those types, as in the reference; a key of the wrong size raises
    ErrInvalidKey."""
    data = tpb.Writer().bytes(field, b"\x02" * size, always=True).output()
    key = tvalidator.pub_key_from_proto(data)
    assert key.type_() == kind and key.bytes_() == b"\x02" * size
    assert jvalidator.pub_key_from_proto(data).address() == key.address()
    with pytest.raises(tcrypto.ErrInvalidKey):
        tvalidator.pub_key_from_proto(tpb.Writer().bytes(field, b"\x02" * (size - 1),
                                                         always=True).output())


def test_get_by_address_follows_changes_to_the_set():
    """The port indexes addresses; lookups equal the reference's scan after a
    change set, after an in-place replacement and for addresses not in the
    set."""
    tv, jv = _sets(6, 11, "ed25519")
    tnew, jnew = _sets(1, 12, "ed25519", [7])
    addrs = [v.address for v in jv.validators] + [jnew.validators[0].address, b"\x01" * 20]
    check = lambda: [tv.get_by_address(a)[0] for a in addrs] == \
        [jv.get_by_address(a)[0] for a in addrs]  # noqa: E731
    assert check()
    tv.update_with_change_set([tnew.validators[0]])
    jv.update_with_change_set([jnew.validators[0]])
    assert check() and tv.has_address(addrs[6]) and not tv.has_address(addrs[7])
    tv.validators[0], tv.validators[1] = tv.validators[1], tv.validators[0]
    jv.validators[0], jv.validators[1] = jv.validators[1], jv.validators[0]
    assert check()
