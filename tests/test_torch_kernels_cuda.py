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
from cometbft_tpu_torch.crypto import sr25519 as tsr
from cometbft_tpu_torch.crypto import sr25519_math as srm
from cometbft_tpu_torch.ops import ed25519_kernel as TK
from cometbft_tpu_torch.ops import sr25519_kernel as TS
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
    final, flips = TK.verify_rows(TK.ED25519, pubs, msgs, sigs, cache=TK.PubKeyCache(cuda))
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
    final, flips = TK.verify_rows(TK.ED25519, pubs, msgs, sigs, cache=TK.PubKeyCache(cuda))
    assert flips == 0 and bool(final.all())


def _sr_batch(n: int, tampered: bool):
    """n schnorrkel signatures; with `tampered` the first four are bad:
    another lane's signature, R >= p, R odd, the marker bit cleared."""
    privs = [tsr.gen_priv_key_from_secret(b"sr-card-%d" % i) for i in range(n)]
    pubs = [p.pub_key().bytes_() for p in privs]
    msgs = [b"msg-%d" % i for i in range(n)]
    sigs = [p.sign(m) for p, m in zip(privs, msgs)]
    if tampered:
        sigs[0] = sigs[1]
        sigs[1] = (oracle.P + 1).to_bytes(32, "little") + sigs[1][32:]
        sigs[2] = (3).to_bytes(32, "little") + sigs[2][32:]
        sigs[3] = sigs[3][:63] + bytes([sigs[3][63] & 0x7F])
    return pubs, msgs, sigs


def _sr_staged(pubs, msgs, sigs, device):
    n = len(sigs)
    b = TK.bucket_size(n)
    _, safe, r, s, k = TS.stage_rows_sr(pubs, msgs, sigs, b)
    enc = np.frombuffer(b"".join(safe), dtype=np.uint8).reshape(n, 32)
    _, coords = TS.decompress_points(enc, device)
    return TK.staged_from_numpy(*TK.pad_coords_batch_minor(coords, b), r, s, k,
                                device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("n,valid", [(5, False), (130, False), (5, True), (130, True)])
def test_sr25519_kernels_match_plain_and_oracle(cuda, n, valid):
    """K2 and the ristretto decoder against their plain versions on
    tampered and all-valid batches; 5 and 130 signatures pad to 8 and 256
    lanes (zero encodings with zero scalars, which must verify valid)."""
    pubs, msgs, sigs = _sr_batch(n, tampered=not valid)
    t = _sr_staged(pubs, msgs, sigs, cuda)
    mask, allok = VK.verify_sr_ok(*t)
    pmask, pall = VK.verify_math_sr_ok(*t)
    assert torch.equal(mask, pmask) and bool(allok) == bool(pall) is valid
    for got, want in zip(VK.decompress_sr(t[4]), VK.decompress_sr_math(t[4])):
        assert torch.equal(got, want)
    final, flips = TK.verify_rows(TS.SR25519, pubs, msgs, sigs,
                                  cache=TK.PubKeyCache(cuda, TS.SR25519))
    assert flips == 0
    assert final.tolist() == [srm.verify(p, m, s) for p, m, s in zip(pubs, msgs, sigs)]
