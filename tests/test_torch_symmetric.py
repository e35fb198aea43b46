"""The port's symmetric-crypto helpers (crypto/armor, crypto/xchacha20poly1305,
crypto/xsalsa20symmetric) against the JAX package's, on seeded keys,
nonces and data: the same bytes, and the same error types where the
input is tampered. Neither side touches a device.
"""

from __future__ import annotations

import numpy as np
import pytest

from cometbft_tpu.crypto import armor as jarmor
from cometbft_tpu.crypto import xchacha20poly1305 as jxc
from cometbft_tpu.crypto import xsalsa20symmetric as jxs
from cometbft_tpu_torch.crypto import armor as tarmor
from cometbft_tpu_torch.crypto import xchacha20poly1305 as txc
from cometbft_tpu_torch.crypto import xsalsa20symmetric as txs

SIZES = (0, 1, 63, 64, 65, 200, 1000)


def _bytes(rng, n: int) -> bytes:
    return rng.integers(0, 256, n, dtype=np.uint8).tobytes()


def _raises_alike(fn_j, fn_t, *args):
    """Both raise the same type (by name) with the same text, or return
    the same value."""
    got = []
    for fn in (fn_j, fn_t):
        try:
            got.append(("ok", fn(*args)))
        except Exception as e:  # noqa: BLE001 - compared below
            got.append((type(e).__name__, str(e)))
    assert got[0] == got[1]
    return got[1]


# ------------------------------------------------------------------ armor


@pytest.mark.parametrize("size", SIZES)
def test_armor_encodes_as_the_reference_and_round_trips(size):
    rng = np.random.default_rng(100 + size)
    data = _bytes(rng, size)
    headers = {"kdf": "bcrypt", "salt": _bytes(rng, 16).hex().upper(), "type": "ed25519"}
    text = tarmor.encode_armor("TENDERMINT PRIVATE KEY", headers, data)
    assert text == jarmor.encode_armor("TENDERMINT PRIVATE KEY", headers, data)
    got = tarmor.decode_armor(text)
    assert got == jarmor.decode_armor(text) == ("TENDERMINT PRIVATE KEY", headers, data)


def test_armor_tampering_raises_as_the_reference():
    rng = np.random.default_rng(7)
    text = tarmor.encode_armor("MESSAGE", {"a": "b"}, _bytes(rng, 90))
    lines = text.splitlines()
    body = lines.index("") + 1
    flipped = lines[:]
    flipped[body] = ("B" if lines[body][0] != "B" else "C") + lines[body][1:]
    cases = ["\n".join(flipped),                          # checksum mismatch
             text.replace("-----END MESSAGE-----", ""),   # no END line
             text.replace("BEGIN", "BEGUN"),              # no BEGIN line
             text.replace(lines[body], lines[body][:-1] + "!")]  # bad base64
    for case in cases:
        kind, msg = _raises_alike(jarmor.decode_armor, tarmor.decode_armor, case)
        assert kind == "ArmorError", msg
    assert issubclass(tarmor.ArmorError, ValueError)


# ------------------------------------------------------- xchacha20poly1305


def test_hchacha20_matches_the_draft_s_vector():
    # draft-irtf-cfrg-xchacha-03 §2.2.1
    key = bytes(range(32))
    nonce = bytes.fromhex("000000090000004a0000000031415927")
    want = bytes.fromhex("82413b4227b27bfed30e42508a877d73a0f9e4d58a74a853c12ec41326d3ecdc")
    assert txc.hchacha20(key, nonce) == jxc.hchacha20(key, nonce) == want


@pytest.mark.parametrize("size", SIZES)
def test_xchacha20poly1305_seals_as_the_reference(size):
    rng = np.random.default_rng(200 + size)
    key, nonce, data, aad = _bytes(rng, 32), _bytes(rng, 24), _bytes(rng, size), _bytes(rng, 13)
    for ad in (b"", aad):
        ct = txc.seal(key, nonce, data, ad)
        assert ct == jxc.seal(key, nonce, data, ad)
        assert len(ct) == size + txc.TAG_SIZE
        assert txc.open_(key, nonce, ct, ad) == jxc.open_(key, nonce, ct, ad) == data


def test_xchacha20poly1305_rejects_as_the_reference():
    rng = np.random.default_rng(3)
    key, nonce, data = _bytes(rng, 32), _bytes(rng, 24), _bytes(rng, 100)
    ct = txc.seal(key, nonce, data, b"ad")
    bad = bytearray(ct)
    bad[5] ^= 1
    for args in ((key, nonce, bytes(bad), b"ad"),   # tampered ciphertext
                 (key, nonce, ct, b"other"),        # other associated data
                 (key, nonce, ct[:10], b"ad"),      # shorter than a tag
                 (key[:31], nonce, ct, b"ad"),      # bad key length
                 (key, nonce[:23], ct, b"ad")):     # bad nonce length
        kind, _ = _raises_alike(jxc.open_, txc.open_, *args)
        assert kind == "ValueError"


# ------------------------------------------------------- xsalsa20symmetric


def _seeded_urandom(seed: int):
    rng = np.random.default_rng(seed)
    return lambda n: rng.integers(0, 256, n, dtype=np.uint8).tobytes()


@pytest.mark.parametrize("size", SIZES)
def test_xsalsa20_secretbox_encrypts_as_the_reference(size, monkeypatch):
    rng = np.random.default_rng(300 + size)
    secret, data = _bytes(rng, 32), _bytes(rng, size)
    monkeypatch.setattr(jxs.os, "urandom", _seeded_urandom(size))
    want = jxs.encrypt_symmetric(data, secret)
    monkeypatch.setattr(txs.os, "urandom", _seeded_urandom(size))
    got = txs.encrypt_symmetric(data, secret)
    assert got == want and len(got) == txs.NONCE_LEN + txs.TAG_LEN + size
    if size:
        assert txs.decrypt_symmetric(got, secret) == jxs.decrypt_symmetric(got, secret) == data
    else:  # an empty message is "too short" in both (symmetric.go's check)
        _raises_alike(jxs.decrypt_symmetric, txs.decrypt_symmetric, got, secret)


def test_xsalsa20_secretbox_rejects_as_the_reference():
    rng = np.random.default_rng(4)
    secret, data = _bytes(rng, 32), _bytes(rng, 77)
    ct = txs.encrypt_symmetric(data, secret)
    for i in (0, txs.NONCE_LEN + 3, len(ct) - 1):  # nonce, tag and body
        bad = bytearray(ct)
        bad[i] ^= 0x40
        kind, msg = _raises_alike(jxs.decrypt_symmetric, txs.decrypt_symmetric, bytes(bad), secret)
        assert kind == "ValueError" and "decryption failed" in msg
    for args in ((ct[:40], secret), (ct, secret[:31]), (data, secret[:16])):
        kind, _ = _raises_alike(jxs.decrypt_symmetric, txs.decrypt_symmetric, *args)
        assert kind == "ValueError"
    kind, _ = _raises_alike(jxs.encrypt_symmetric, txs.encrypt_symmetric, data, secret[:8])
    assert kind == "ValueError"


def test_xsalsa20_hsalsa20_and_blocks_match_the_reference():
    rng = np.random.default_rng(5)
    for _ in range(4):
        key, n16, n8 = _bytes(rng, 32), _bytes(rng, 16), _bytes(rng, 8)
        assert txs.hsalsa20(key, n16) == jxs.hsalsa20(key, n16)
        for counter in (0, 1, 2**32 + 5):
            assert txs._salsa20_block(key, n8, counter) == jxs._salsa20_block(key, n8, counter)
