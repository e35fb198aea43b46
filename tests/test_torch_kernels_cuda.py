"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Imports only the port (the card's machine has no JAX); without a
GPU every test here skips. Run on the card with

    pytest -m cuda tests/test_torch_kernels_cuda.py

All arithmetic is integer: equality is exact.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from cometbft_tpu_torch.crypto import ed25519 as ted
from cometbft_tpu_torch.crypto import ed25519_math as oracle
from cometbft_tpu_torch.ops import ed25519_kernel as TK
from cometbft_tpu_torch.ops import verify_kernel as VK


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _batch(n: int):
    privs = [ted.gen_priv_key_from_secret(b"card-%d" % i) for i in range(n)]
    pubs = [p.pub_key().bytes_() for p in privs]
    msgs = [b"msg-%d" % i for i in range(n)]
    sigs = [p.sign(m) for p, m in zip(privs, msgs)]
    sigs[0] = sigs[1]  # wrong signature
    pubs[2] = (oracle.P + 1).to_bytes(32, "little")  # non-canonical identity
    sigs[2] = pubs[2] + bytes(32)  # ... which validly signs anything
    sigs[3] = (2).to_bytes(32, "little") + sigs[3][32:]  # R not on the curve
    return pubs, msgs, sigs


@pytest.mark.cuda
@pytest.mark.parametrize("n", [5, 130])
def test_kernels_match_plain_and_oracle(cuda, n):
    pubs, msgs, sigs = _batch(n)
    b = TK.bucket_size(n)
    _, safe, r, s, k = TK.stage_batch(pubs, msgs, sigs, b)
    enc = np.frombuffer(b"".join(safe), dtype=np.uint8).reshape(n, 32)
    _, coords = TK.decompress_points(enc, cuda)
    t = TK.staged_from_numpy(*TK.pad_coords_batch_minor(coords, b), r, s, k,
                             device=cuda)
    mask, allok = VK.verify_ok(*t)
    pmask, pall = VK.verify_math_ok(*t)
    assert torch.equal(mask, pmask) and bool(allok) == bool(pall) is False
    for got, want in zip(VK.decompress(t[4]), VK.decompress_math(t[4])):
        assert torch.equal(got, want)
    final, flips = TK.verify_mask(pubs, msgs, sigs, cache=TK.PubKeyCache(cuda))
    assert flips == 0
    assert final.tolist() == [oracle.verify_zip215(p, m, s)
                              for p, m, s in zip(pubs, msgs, sigs)]


@pytest.mark.cuda
def test_wrapper_rejects_bad_inputs(cuda):
    words = torch.zeros((8, 16), dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        VK.decompress(words.to(torch.int64))
    with pytest.raises(ValueError):
        VK.decompress(words[:, ::2])
    with pytest.raises(ValueError):
        VK.decompress(words[:7])


@pytest.mark.cuda
@pytest.mark.parametrize("n", [5, 130])
def test_valid_batch_sets_all_ok(cuda, n):
    privs = [ted.gen_priv_key_from_secret(b"ok-%d" % i) for i in range(n)]
    pubs = [p.pub_key().bytes_() for p in privs]
    msgs = [b"msg-%d" % i for i in range(n)]
    sigs = [p.sign(m) for p, m in zip(privs, msgs)]
    b = TK.bucket_size(n)
    _, safe, r, s, k = TK.stage_batch(pubs, msgs, sigs, b)
    enc = np.frombuffer(b"".join(safe), dtype=np.uint8).reshape(n, 32)
    _, coords = TK.decompress_points(enc, cuda)
    t = TK.staged_from_numpy(*TK.pad_coords_batch_minor(coords, b), r, s, k,
                             device=cuda)
    mask, allok = VK.verify_ok(*t)
    pmask, pall = VK.verify_math_ok(*t)
    assert torch.equal(mask, pmask) and bool(mask.all())
    assert bool(allok) == bool(pall) is True
    final, flips = TK.verify_mask(pubs, msgs, sigs, cache=TK.PubKeyCache(cuda))
    assert flips == 0 and bool(final.all())
