"""The rest of the reference's six aggregate cases (test_torch_bls_kernel.py
holds clean and forged, and the cases): the port's aggregate_verify on CPU
tensors against the JAX package's oracle on a sub-commit, a wrong signer
bitmap, the infinity pubkey and PoP aggregation of identical sign-bytes;
and the certificate entry aggregate_verify_agg on the host-aggregated
signature of the clean and the forged commit. Exact everywhere.
"""

from __future__ import annotations

import pytest
import torch

from cometbft_tpu_torch.ops import bls_kernel as K
from tests.test_torch_bls_kernel import _case, _oracle_agg, plain_hashes_once


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with plain_hashes_once():
        yield
    torch.set_num_threads(n)


# "wrong bitmap" first: its four messages hold the sub-commit's three and
# the certificate cases'
@pytest.mark.parametrize("name", ["wrong bitmap", "sub-commit", "infinity pubkey", "pop"])
def test_aggregate_verify_matches_oracle(name):
    ps, ms, ss = _case(name)
    want, _ = _oracle_agg(ps, ms, ss)
    assert want == (name in ("sub-commit", "pop"))
    assert K.aggregate_verify(ps, ms, ss, device="cpu") == want


@pytest.mark.parametrize("name", ["clean", "forged"])
def test_aggregate_verify_agg_matches_oracle(name):
    ps, ms, ss = _case(name)
    want, agg = _oracle_agg(ps, ms, ss)
    assert K.aggregate_signatures(ss) == agg
    assert K.aggregate_verify_agg(ps, ms, agg, device="cpu") == want
    # the aggregate's signature half is subgroup-checked; a wrong length
    # or an undecodable aggregate is False
    assert not K.aggregate_verify_agg(ps, ms, agg[:95], device="cpu")
