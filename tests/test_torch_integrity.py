"""The staging checksum and the reduced-fetch header of the port
(ops/integrity.py, the plain versions of the integrity kernel K6, and
ed25519_kernel.decode_header / decode_payload) against the JAX package's
_host_checksum, _device_checksum and _integrity_parts(_arrs), bit for bit,
with all four header verdicts; the payload's mask and all-ok as bools and
as the verify kernel's raw int32 verdicts (non-zero valid), which the
verify path hands to K6.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cometbft_tpu.ops import ed25519_kernel as JK
from cometbft_tpu_torch.ops import ed25519_kernel as TK
from cometbft_tpu_torch.ops import integrity as TI


def _arrays(seed: int, b: int = 64):
    """r/s/k-like (8, b) uint32 planes and a flat block with odd length."""
    rng = np.random.default_rng(seed)
    planes = [rng.integers(0, 2**32, size=(8, b), dtype=np.uint64).astype(np.uint32)
              for _ in range(3)]
    planes[0][:, :4] = 0xFFFFFFFF  # extreme words
    flat = rng.integers(0, 2**32, size=16 * b + 37, dtype=np.uint64).astype(np.uint32)
    fidx = rng.integers(0, b, size=8, dtype=np.int64).astype(np.int32)
    return planes, flat, fidx


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


@pytest.mark.parametrize("which", ["planes", "flat", "flat_fallback"])
def test_checksums_match_jax(which):
    planes, flat, fidx = _arrays(3)
    arrs = {"planes": planes, "flat": [flat], "flat_fallback": [flat, planes[2], fidx]}[which]
    host = TI.host_checksum(*arrs)
    assert host == JK._host_checksum(*arrs)
    assert host == int(np.asarray(JK._device_checksum(tuple(jnp.asarray(a) for a in arrs))))
    assert int(TI.checksum_plain(*(_t(a) for a in arrs))) == host
    assert TI.device_checksum(*(_t(a) for a in arrs)) == host


def _mask(b: int, bad: list[int]) -> np.ndarray:
    m = np.ones(b, dtype=bool)
    m[bad] = False
    return m


@pytest.mark.parametrize("bad", [[], [5, 63]], ids=["all_valid", "two_failed"])
@pytest.mark.parametrize("form", ["rsk", "arrs1", "arrs3"])
def test_parts_match_jax(form, bad):
    planes, flat, fidx = _arrays(11)
    mask = _mask(64, bad)
    allok = np.bool_(not bad)
    arrs = {"rsk": planes, "arrs1": [flat], "arrs3": [flat, planes[2], fidx]}[form]
    expected = TI.host_checksum(*arrs)
    if form == "rsk":
        jh, jp = JK._integrity_parts(jnp.asarray(mask), jnp.asarray(allok),
                                     *(jnp.asarray(a) for a in arrs), np.uint32(expected))
    else:
        jh, jp = JK._integrity_parts_arrs(jnp.asarray(mask), jnp.asarray(allok),
                                          np.uint32(expected), *(jnp.asarray(a) for a in arrs))
    th, tp = TI.integrity_parts(torch.from_numpy(mask), torch.tensor(bool(allok)), expected,
                                *(_t(a) for a in arrs))
    np.testing.assert_array_equal(th.numpy().view(np.uint32), np.asarray(jh))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    verdict = TK.decode_header(th.numpy().view(np.uint32), expected)
    assert verdict == JK.decode_header(np.asarray(jh), expected) == ("full" if bad else "happy")


@pytest.mark.parametrize("bad", [[], [5, 63]], ids=["all_valid", "two_failed"])
@pytest.mark.parametrize("form", ["rsk", "arrs1", "arrs3"])
def test_raw_verdicts_match_jax(form, bad):
    """The verify kernel's int32 mask (1 valid, 0 not; any non-zero is
    valid) and (1,) int32 all-ok give the JAX package's header and payload
    over its bool mask and all-ok."""
    planes, flat, fidx = _arrays(13)
    mask = _mask(64, bad)
    arrs = {"rsk": planes, "arrs1": [flat], "arrs3": [flat, planes[2], fidx]}[form]
    expected = TI.host_checksum(*arrs)
    if form == "rsk":
        jh, jp = JK._integrity_parts(jnp.asarray(mask), jnp.asarray(np.bool_(not bad)),
                                     *(jnp.asarray(a) for a in arrs), np.uint32(expected))
    else:
        jh, jp = JK._integrity_parts_arrs(jnp.asarray(mask), jnp.asarray(np.bool_(not bad)),
                                          np.uint32(expected), *(jnp.asarray(a) for a in arrs))
    raw = torch.from_numpy(mask.astype(np.int32))
    raw[::7] *= 5  # K6 reads any non-zero word as valid
    allok = torch.tensor([0 if bad else 1], dtype=torch.int32)
    th, tp = TI.integrity_parts(raw, allok, expected, *(_t(a) for a in arrs))
    np.testing.assert_array_equal(th.numpy().view(np.uint32), np.asarray(jh))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    assert TK.decode_header(th.numpy().view(np.uint32), expected) == ("full" if bad else "happy")


def test_header_verdicts_chk_mismatch_and_echo_corrupt():
    planes, _, _ = _arrays(5)
    expected = TI.host_checksum(*planes)
    mask = torch.ones(64, dtype=torch.bool)
    # the device saw other bytes than the host sent: one word flipped
    seen = [p.copy() for p in planes]
    seen[1][3, 7] ^= 1
    th, tp = TI.integrity_parts(mask, torch.tensor(True), expected, *(_t(a) for a in seen))
    header = th.numpy().view(np.uint32)
    assert TK.decode_header(header, expected) == JK.decode_header(header, expected) \
        == "chk_mismatch"
    assert not tp.numpy()[-1]  # the payload's checksum bit
    th, _ = TI.integrity_parts(mask, torch.tensor(True), expected, *(_t(a) for a in planes))
    header = th.numpy().view(np.uint32).copy()
    header[1] ^= 0x100  # mangled on the fetch
    assert TK.decode_header(header, expected) == JK.decode_header(header, expected) \
        == "echo_corrupt"


def test_decode_payload_raises_on_a_failed_check():
    b, n = 8, 6
    mask = _mask(b, [2])
    good = np.concatenate([mask, ~mask, [True]])
    ones = np.ones(n, dtype=bool)
    rows = ([b"\x01" + bytes(31)] * n, [b"m"] * n, [bytes(64)] * n)
    got, flips = TK.decode_payload(good, n, ones, ones, rows, lambda *a: False)
    assert got.tolist() == mask[:n].tolist() and flips == 0
    for bad_payload in (np.concatenate([mask, ~mask, [False]]),       # checksum failed
                        np.concatenate([mask, mask, [True]])):         # echo disagrees
        with pytest.raises(RuntimeError, match="integrity check failed"):
            TK.decode_payload(bad_payload, n, ones, ones, rows, lambda *a: False)
