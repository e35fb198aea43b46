"""A mixed ed25519 + sr25519 + bls12381 batch through the port's scheduler
on its "cpu" backend (the kernels' plain versions), as the reference's
tests/test_ops_bls.py:_run_mixed_scheduler_case: one batch a scheme,
resolved together, the per-lane mask in input order, with a bad row of
each of two schemes. Exact.
"""

from __future__ import annotations

import pytest
import torch

from cometbft_tpu_torch import sched as tsched
from cometbft_tpu_torch.crypto import batch as tbatch
from cometbft_tpu_torch.crypto import bls12381 as tbls
from cometbft_tpu_torch.crypto import ed25519 as ted
from cometbft_tpu_torch.crypto import sr25519 as tsr


@pytest.fixture(autouse=True)
def _cpu_backend():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    tbatch.set_backend("cpu")
    yield
    tbatch.set_backend("gpu")
    torch.set_num_threads(n)


def test_scheduler_mixed_three_scheme_batch_mask_order():
    """The reference's mixed ed25519 + sr25519 + bls12381 rows in one
    scheduler drain: one batch a scheme, the mask in input order."""
    scheduler = tsched.VerifyScheduler(max_lanes=64)
    ed_k = ted.gen_priv_key_from_secret(b"mixed-ed")
    sr_k = tsr.gen_priv_key_from_secret(b"mixed-sr")
    bl_k = tbls.gen_priv_key_from_secret(b"mixed-bls")
    rows = [
        (ed_k.pub_key(), b"ed-m", ed_k.sign(b"ed-m")),
        (bl_k.pub_key(), b"bls-m", bl_k.sign(b"bls-m")),
        (sr_k.pub_key(), b"sr-m", sr_k.sign(b"sr-m")),
        (bl_k.pub_key(), b"bls-bad", bl_k.sign(b"bls-m")),  # wrong message
        (ed_k.pub_key(), b"ed-bad", ed_k.sign(b"ed-m")),  # wrong message
        (sr_k.pub_key(), b"sr-m2", sr_k.sign(b"sr-m2")),
    ]
    try:
        mask = scheduler.verify_now(rows)
    finally:
        scheduler.stop()
    assert mask.tolist() == [True, True, True, False, False, True]
    assert scheduler.health()["batches"] == 1
