"""The port's BLS device path (ops/bls_kernel.py) on CPU tensors (the
kernels' plain versions) against the JAX package's exact host oracle
(cometbft_tpu/crypto/fallback.py): the batched single-verify mask on the
reference's edge lanes (a valid signature, a valid signature of another
message, structural garbage, the infinity encoding, padding to the bucket),
and the aggregate commit check on the reference's six cases (clean, a
forged signature, a sub-commit, a wrong signer bitmap, the infinity pubkey,
and PoP aggregation of identical sign-bytes; the cases are shared with
test_torch_bls_aggregate.py, which holds the other four and
aggregate_verify_agg). Exact everywhere. The JAX package runs these cases
on its XLA pipeline only under its `pairing` marker; its oracle is the
reference here.
"""

from __future__ import annotations

import contextlib

import pytest
import torch

from cometbft_tpu.crypto import bls12381 as jbls
from cometbft_tpu.crypto import fallback as jo
from cometbft_tpu_torch.crypto import bls12381 as tbls
from cometbft_tpu_torch.ops import bls_kernel as K
from cometbft_tpu_torch.ops import bls_launch as BL
from cometbft_tpu_torch.ops import ed25519_kernel as EK


@contextlib.contextmanager
def plain_hashes_once():
    """bls_launch.hash_to_g2 on CPU tensors with each message lane's output
    kept: a call whose lanes were all hashed before takes them from the
    memo, any other runs the plain version on all its lanes. The cases of a
    module share their messages, and one plain hash costs seconds on the
    CPU whatever its lanes; the plain hash is held against the oracle in
    test_torch_bls_pairing.py and test_torch_bls_host.py."""
    real = BL.hash_to_g2
    memo: dict[bytes, tuple] = {}

    def hash_to_g2(u):
        if u.device.type != "cpu":
            return real(u)
        keys = [u[..., j].numpy().tobytes() for j in range(u.shape[-1])]
        if not all(k in memo for k in keys):
            planes, ident = real(u)
            memo.update((k, (planes[:, j], ident[j])) for j, k in enumerate(keys))
        cols = [memo[k] for k in keys]
        return torch.stack([c[0] for c in cols], -1), torch.stack([c[1] for c in cols])

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(BL, "hash_to_g2", hash_to_g2)
        yield


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with plain_hashes_once():
        yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fresh_cache():
    K.reset_valset_cache()
    yield
    K.reset_valset_cache()


def test_verify_batch_edge_lanes_match_oracle():
    keys = [tbls.gen_priv_key_from_secret(b"rung-%d" % i) for i in range(5)]
    msgs = [b"msg-%d" % i for i in range(5)]
    pubs = [k.pub_key().bytes_() for k in keys]
    sigs = [k.sign(m) for k, m in zip(keys, msgs)]
    sigs[1] = keys[1].sign(b"wrong")  # valid signature, wrong message
    sigs[2] = b"\x00" * 96  # structural garbage
    sigs[3] = bytes([0xC0]) + bytes(95)  # the infinity point
    want = [jo.bls_verify(p, m, s, jbls.DST) for p, m, s in zip(pubs, msgs, sigs)]
    assert want == [True, False, False, False, True]
    thunk = K.verify_batch_async(pubs, msgs, sigs, device="cpu")
    mask = EK.resolve_batches([thunk])[0]
    assert mask.tolist() == want
    assert thunk.flips == 0  # the oracle recheck confirmed the rejected lane
    assert thunk.eligible.tolist() == [True, True, False, False, True]


_KEYS = [tbls.gen_priv_key_from_secret(b"agg-rung-%d" % i) for i in range(4)]
_PUBS = [k.pub_key().bytes_() for k in _KEYS]
_MSGS = [b"h5-vote-%d" % i for i in range(4)]
_SIGS = [k.sign(m) for k, m in zip(_KEYS, _MSGS)]


def _case(name):
    if name == "clean":
        return _PUBS, _MSGS, _SIGS
    if name == "forged":
        return _PUBS, _MSGS, [_SIGS[0], _KEYS[1].sign(b"forged")] + _SIGS[2:]
    if name == "sub-commit":
        return _PUBS[:3], _MSGS[:3], _SIGS[:3]
    if name == "wrong bitmap":
        return _PUBS, _MSGS, _SIGS[:3] + [_SIGS[0]]
    if name == "infinity pubkey":
        return [bytes([0xC0]) + bytes(47)] + _PUBS[1:], _MSGS, _SIGS
    return _PUBS, [b"same"] * 4, [k.sign(b"same") for k in _KEYS]  # PoP


def _oracle_agg(ps, ms, ss):
    try:
        agg = jo.bls_aggregate([bytes(s) for s in ss])
    except ValueError:
        return False, None
    return jo.bls_aggregate_verify(ps, ms, agg, jbls.DST), agg


@pytest.mark.parametrize("name", ["clean", "forged"])
def test_aggregate_verify_matches_oracle(name):
    """The reference's six cases, the first two here (the others in
    test_torch_bls_aggregate.py)."""
    ps, ms, ss = _case(name)
    want, _ = _oracle_agg(ps, ms, ss)
    assert want == (name == "clean")
    assert K.aggregate_verify(ps, ms, ss, device="cpu") == want


def test_aggregate_key_cache_is_per_set():
    """A set's keys are decoded and subgroup-checked once: a second check of
    the same set hits the cache, another set misses."""
    ps, ms, ss = _case("sub-commit")
    K._valset_keys(ps, K._structural_check(ps, ss, 3)[1], torch.device("cpu"))
    K._valset_keys(ps, K._structural_check(ps, ss, 3)[1], torch.device("cpu"))
    K._valset_keys(_PUBS, K._structural_check(_PUBS, _SIGS, 4)[1], torch.device("cpu"))
    assert K.VALSET_STATS == {"hits": 1, "misses": 2}


def test_stage_batch_skips_hash_planes_for_aggregate():
    """msgs=None staging zero-fills the u-planes and leaves the key and
    signature planes byte-identical to full staging."""
    b = EK.bucket_size(4)
    ok_full, block_full, flags_full = K.stage_batch_bls(_PUBS, _MSGS, _SIGS, b)
    ok_agg, block_agg, flags_agg = K.stage_batch_bls(_PUBS, None, _SIGS, b)
    assert ok_full.tolist() == ok_agg.tolist()
    assert (flags_full == flags_agg).all()
    assert (block_full[:3] == block_agg[:3]).all()
    assert not block_agg[3:].any() and block_full[3:].any()
    assert flags_full[2].tolist() == [0] * 4 + [1] * (b - 4)
