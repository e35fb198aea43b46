"""The port's BitArray, Merkle proofs, ConsensusParams, PartSet, Header,
Block, SignedHeader and LightBlock against the JAX package's on the same
seeded inputs: equal bytes, hashes, proofs and verdicts, exception classes
and first lines of messages, and the round trip from the JAX package's
proto bytes into the port and back to equal bytes. Pure host code: no
device, no kernel.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from cometbft_tpu.crypto import merkle as jmerkle
from cometbft_tpu.libs import bits as jbits
from cometbft_tpu.types import block as jblock
from cometbft_tpu.types import evidence as jevidence
from cometbft_tpu.types import params as jparams
from cometbft_tpu.types import part_set as jpart
from cometbft_tpu.types.basic import PartSetHeader
from cometbft_tpu_torch.crypto import merkle as tmerkle
from cometbft_tpu_torch.libs import bits as tbits
from cometbft_tpu_torch.types import basic as tbasic
from cometbft_tpu_torch.types import block as tblock
from cometbft_tpu_torch.types import light as tlight
from cometbft_tpu_torch.types import params as tparams
from cometbft_tpu_torch.types import part_set as tpart
from tests.torch_consumers import CHAIN, Chain, block_id, outcome, priv, valset, vote


def _bools(n: int, seed: int) -> list[bool]:
    return [bool(b) for b in np.random.default_rng(seed).integers(0, 2, n)]


@pytest.mark.parametrize("n,seed", [(0, 1), (1, 2), (7, 3), (8, 4), (13, 5), (150, 6)])
def test_bit_array_equals_reference(n, seed):
    a, b = _bools(n, seed), _bools(n + 3, seed + 100)
    ja, jb = jbits.BitArray.from_bools(a), jbits.BitArray.from_bools(b)
    ta, tb = tbits.BitArray.from_bools(a), tbits.BitArray.from_bools(b)
    assert ta.to_bytes() == ja.to_bytes() and str(ta) == str(ja)
    for op in ("or_", "and_", "sub"):
        assert getattr(ta, op)(tb).to_bytes() == getattr(ja, op)(jb).to_bytes(), op
    assert ta.not_().to_bytes() == ja.not_().to_bytes()
    assert (ta.num_true(), ta.get_true_indices(), ta.is_full(), ta.is_empty()) == \
        (ja.num_true(), ja.get_true_indices(), ja.is_full(), ja.is_empty())
    # carried across: the reference's bytes into the port and back
    back = tbits.BitArray.from_bytes(n, ja.to_bytes())
    assert back == ta and back.to_bytes() == ja.to_bytes()
    tc, jc = ta.copy(), ja.copy()
    tc.or_update(tb)
    jc.or_update(jb)
    assert tc.to_bytes() == jc.to_bytes()


@pytest.mark.parametrize("n", [1, 2, 3, 7, 16, 33])
def test_merkle_proofs_equal_reference(n):
    rng = np.random.default_rng(n)
    items = [rng.bytes(int(rng.integers(0, 80))) for _ in range(n)]
    troot, tproofs = tmerkle.proofs_from_byte_slices(items)
    jroot, jproofs = jmerkle.proofs_from_byte_slices(items)
    assert troot == jroot == tmerkle.hash_from_byte_slices(items)
    for i, (tp, jp) in enumerate(zip(tproofs, jproofs)):
        assert (tp.total, tp.index, tp.leaf_hash, tp.aunts) == \
            (jp.total, jp.index, jp.leaf_hash, jp.aunts)
        assert tp.verify(troot, items[i])
        assert not tp.verify(troot, items[i] + b"x")
        bad = dataclasses.replace(tp, aunts=tp.aunts[:-1])
        assert bad.verify(troot, items[i]) == jmerkle.Proof(
            jp.total, jp.index, jp.leaf_hash, jp.aunts[:-1]).verify(jroot, items[i])
    for args in [(0, 0, b"l", []), (1, 1, b"l", []), (0, 1, b"l", [b"a"]), (2, 3, b"l", [])]:
        assert tmerkle._compute_hash_from_aunts(*args) == jmerkle._compute_hash_from_aunts(*args)


@pytest.mark.parametrize("change", ["default", "block", "evidence", "abci"])
def test_consensus_params_hash_equals_reference(change):
    tp, jp = tparams.default_consensus_params(), jparams.default_consensus_params()
    if change == "block":
        tp.block.max_bytes = jp.block.max_bytes = 1_048_576
        tp.block.max_gas = jp.block.max_gas = 7
    elif change == "evidence":
        tp.evidence.max_age_num_blocks = jp.evidence.max_age_num_blocks = 9
    elif change == "abci":
        tp.abci.vote_extensions_enable_height = jp.abci.vote_extensions_enable_height = 5
    assert tp.hash() == jp.hash()
    assert tp.abci.vote_extensions_enabled(5) == jp.abci.vote_extensions_enabled(5)
    tp.validator.pub_key_types = jp.validator.pub_key_types = ["ed25519", "bogus"]
    assert outcome(tp.validate_basic) == outcome(jp.validate_basic)


@pytest.mark.parametrize("size,part", [(0, 64), (1, 64), (1000, 64), (4096, 1024), (70_001, 65536)])
def test_part_set_equals_reference(size, part):
    data = np.random.default_rng(size).bytes(size)
    tps, jps = tpart.PartSet.from_data(data, part), jpart.PartSet.from_data(data, part)
    assert tps.header() == tbasic.PartSetHeader(jps.total, jps.hash)
    for i in range(jps.total):
        jb = jps.get_part(i).to_proto()
        assert tps.get_part(i).to_proto() == jb
        assert tpart.Part.from_proto(jb).to_proto() == jb
    # a receiver assembles the parts with proof checks, rejecting a bad one
    trecv = tpart.PartSet.from_header(tps.header())
    jrecv = jpart.PartSet.from_header(PartSetHeader(jps.total, jps.hash))
    for i in reversed(range(jps.total)):
        p = tpart.Part.from_proto(jps.get_part(i).to_proto())
        if jps.total > 1 and i == 0:
            forged = dataclasses.replace(p, bytes_=p.bytes_ + b"!")
            jforged = dataclasses.replace(jps.get_part(0), bytes_=p.bytes_ + b"!")
            assert outcome(trecv.add_part, forged) == outcome(jrecv.add_part, jforged)
        assert trecv.add_part(p) == jrecv.add_part(jps.get_part(i))
        assert trecv.add_part(p) is False
    assert trecv.is_complete() and trecv.get_reader() == data
    assert trecv.bit_array().to_bytes() == jrecv.bit_array().to_bytes()


@pytest.fixture(scope="module")
def chain():
    return Chain(6, n_vals=4, churn_every=3, replace=2, tag=b"bits-block")


def _block_pair(chain, h: int, with_evidence: bool):
    """Block h of the chain in both packages, with two transactions, its
    last commit and, when asked, a duplicate-vote evidence."""
    lb = chain.blocks[h]
    evs = []
    if with_evidence:
        jvals, privs = chain.vals(h)
        va = vote(privs, 1, h, 0, block_id(b"a"))
        vb = vote(privs, 1, h, 0, block_id(b"b"))
        evs = [jevidence.DuplicateVoteEvidence.new(va, vb, lb.header.time, jvals)]
    jb = jblock.Block(header=dataclasses.replace(lb.header, evidence_hash=b""),
                      data=jblock.Data(txs=[b"tx-1", b"tx-2" * 40]),
                      evidence=jblock.EvidenceData(evidence=evs),
                      last_commit=chain.blocks[h - 1].commit)
    jb.header.last_commit_hash = b""
    jb.header.data_hash = b""
    jb.fill_header()
    return tblock.Block.from_proto(jb.to_proto()), jb


@pytest.mark.parametrize("h,with_evidence", [(2, False), (5, True)])
def test_header_and_block_equal_reference(chain, h, with_evidence):
    tb, jb = _block_pair(chain, h, with_evidence)
    data = jb.to_proto()
    assert tb.to_proto() == data
    assert tb.hash() == jb.hash() and tb.header.hash() == jb.header.hash()
    assert tb.data.hash() == jb.data.hash() and tb.evidence.hash() == jb.evidence.hash()
    assert tblock.Header.from_proto(jb.header.to_proto()).to_proto() == jb.header.to_proto()
    assert outcome(tb.validate_basic) == outcome(jb.validate_basic)
    tps, jps = tb.make_part_set(256), jb.make_part_set(256)
    assert (tps.total, tps.hash) == (jps.total, jps.hash)
    tb.data = tblock.Data(txs=[b"other"])
    jb.data = jblock.Data(txs=[b"other"])
    assert outcome(tb.validate_basic) == outcome(jb.validate_basic) != ("ok", None)
    empty_t, empty_j = tblock.Header(), jblock.Header()
    assert empty_t.hash() is None and empty_j.hash() is None
    assert outcome(empty_t.validate_basic) == outcome(empty_j.validate_basic)


_BREAKS = {
    "valid": lambda sh, lb: None,
    "chain": lambda sh, lb: setattr(sh.header, "chain_id", "other-chain"),
    "height": lambda sh, lb: setattr(sh.commit, "height", sh.commit.height + 1),
    "signs another header": lambda sh, lb: setattr(sh.header, "app_hash", b"\x09" * 32),
    "short hash": lambda sh, lb: setattr(sh.header, "data_hash", b"\x01" * 31),
    "proposer": lambda sh, lb: setattr(sh.header, "proposer_address", b"\x01" * 19),
    "valset": lambda sh, lb: lb.validator_set.validators.pop(),
    "no commit signatures": lambda sh, lb: sh.commit.signatures.clear(),
}


@pytest.mark.parametrize("brk", sorted(_BREAKS))
def test_signed_header_and_light_block_validate_basic_equal_reference(chain, brk):
    jlb = chain.blocks[4]
    tlb = tlight.LightBlock.from_proto(jlb.to_proto())
    jlb = type(jlb).from_proto(jlb.to_proto())  # a copy to break
    for lb in (tlb, jlb):
        _BREAKS[brk](lb.signed_header, lb)
    for want in (CHAIN, "other-chain"):
        assert outcome(tlb.signed_header.validate_basic, want) == \
            outcome(jlb.signed_header.validate_basic, want)
        assert outcome(tlb.validate_basic, want) == outcome(jlb.validate_basic, want)


@pytest.mark.parametrize("h", [1, 3, 6])
def test_light_block_round_trip_from_reference_bytes(chain, h):
    jlb = chain.blocks[h]
    data = jlb.to_proto()
    tlb = tlight.LightBlock.from_proto(data)
    assert tlb.to_proto() == data and tlb.hash() == jlb.hash()
    sh = jlb.signed_header.to_proto()
    assert tlight.SignedHeader.from_proto(sh).to_proto() == sh
    assert tlb.validator_set.hash() == jlb.validator_set.hash()
    for cls in (tlight.SignedHeader, tlight.LightBlock):
        with pytest.raises(ValueError):
            cls.from_proto(b"")


def test_genesis_doc_and_params_through_json():
    from cometbft_tpu.types import genesis as jgenesis
    from cometbft_tpu.utils import cmttime as jtime
    from cometbft_tpu_torch.types import genesis as tgenesis

    jvals, _ = valset([priv("ed25519", b"genesis", i) for i in range(3)])
    jdoc = jgenesis.GenesisDoc(
        genesis_time=jtime.Timestamp(1_700_000_000, 5_000), chain_id=CHAIN,
        validators=[jgenesis.GenesisValidator(v.address, v.pub_key, v.voting_power, f"v{i}")
                    for i, v in enumerate(jvals.validators)])
    jdoc.consensus_params.abci.vote_extensions_enable_height = 3
    raw = jdoc.to_json()
    tdoc = tgenesis.GenesisDoc.from_json(raw)
    assert tdoc.to_json() == raw and tdoc.hash() == jdoc.hash()
    assert tdoc.validator_set().hash() == jvals.hash()
    assert tdoc.consensus_params.hash() == jdoc.consensus_params.hash()
