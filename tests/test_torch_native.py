"""The port's native host rungs (cometbft_tpu_torch/native: hashvec.c and
strobe.c, built with cc into build/) against the JAX package's native and
numpy rungs, hashlib, Python ints and the serial Merlin transcript, bit for
bit: Keccak-f[1600] over 0/1/7/8/9 states, SHA-512 over ragged lengths and
the block boundaries 111/112/239/240 and empty messages, the reduction mod
L, and the batch schnorrkel challenge. Also which rung CBFT_HASHVEC picks.
"""

from __future__ import annotations

import hashlib
import pathlib

import numpy as np
import pytest

from cometbft_tpu.crypto import sr25519_math as jsrm
from cometbft_tpu.ops import hashvec as JH
from cometbft_tpu_torch import native
from cometbft_tpu_torch.crypto import sr25519_math as srm
from cometbft_tpu_torch.ops import hashvec as TH

L = 2**252 + 27742317777372353535851937790883648493
ROWS = [0, 1, 7, 8, 9]


def _datas(lengths, seed: int) -> list[bytes]:
    rng = np.random.default_rng(seed)
    return [rng.bytes(n) for n in lengths]


def test_native_libraries_build_into_build_dir():
    assert TH.native_available() and srm.serial_rung() == "native"
    repo = pathlib.Path(native.__file__).resolve().parent.parent.parent
    built = sorted(p.name for p in (repo / "build").glob("lib*.so"))
    assert any(n.startswith("libhashvec-") for n in built)
    assert any(n.startswith("libstrobe-") for n in built)
    assert native.isa_cflags()[-1] == ("-O3",)
    assert native.build_error("hashvec") is None and native.build_error("strobe") is None


@pytest.mark.parametrize("n", ROWS)
def test_keccak_native_matches_jax_rungs_and_serial(monkeypatch, n):
    rng = np.random.default_rng(n)
    states = rng.integers(0, 2**63, size=(n, 25), dtype=np.uint64) * np.uint64(2) + np.uint64(1)
    monkeypatch.setenv("CBFT_HASHVEC", "native")
    got = states.copy()
    TH.keccak_f1600_many(got)
    jnat = states.copy()
    JH.keccak_f1600_many(jnat)  # the JAX package's native rung where it built
    monkeypatch.setenv("CBFT_HASHVEC", "numpy")
    jnp_rung = states.copy()
    JH.keccak_f1600_many(jnp_rung)
    tnp = states.copy()
    TH.keccak_f1600_many(tnp)
    for want in (jnat, jnp_rung, tnp):
        np.testing.assert_array_equal(got, want)
    for i in range(n):
        st = bytearray(states[i].tobytes())
        srm.keccak_f1600(st)
        assert bytes(st) == got[i].tobytes()


LENGTH_SETS = {
    "boundaries": [111, 112, 239, 240] * 3,
    "ragged": [0, 1, 5, 17, 111, 112, 127, 128, 239, 240, 255, 300, 1000],
    "uniform_186": [186] * 9,
    "empty": [0] * 9,
}


@pytest.mark.parametrize("n", ROWS)
@pytest.mark.parametrize("kind", sorted(LENGTH_SETS))
def test_sha512_native_matches_hashlib_and_jax(monkeypatch, kind, n):
    lengths = (LENGTH_SETS[kind] * 2)[:n] if n else []
    datas = _datas(lengths, n + len(kind))
    monkeypatch.setenv("CBFT_HASHVEC", "native")
    got = TH.sha512_many(datas)
    assert [bytes(r) for r in got] == [hashlib.sha512(d).digest() for d in datas]
    words = TH.sha512_mod_l_words(datas)
    monkeypatch.setenv("CBFT_HASHVEC", "numpy")
    np.testing.assert_array_equal(got, JH.sha512_many(datas))
    np.testing.assert_array_equal(words, JH.sha512_mod_l_words(datas))
    for i, d in enumerate(datas):
        k = int.from_bytes(hashlib.sha512(d).digest(), "little") % L
        assert words[i].tobytes() == k.to_bytes(32, "little")


@pytest.mark.parametrize("length", [111, 112, 239, 240])
def test_sha512_rows_native_at_block_boundaries(monkeypatch, length):
    rows = np.frombuffer(b"".join(_datas([length] * 12, length)), dtype=np.uint8).reshape(12, length)
    monkeypatch.setenv("CBFT_HASHVEC", "native")
    TH.reset_stats()
    got = TH.sha512_rows(rows)
    assert TH.stats() == {"sha512_native_rows": 12}
    monkeypatch.setenv("CBFT_HASHVEC", "numpy")
    np.testing.assert_array_equal(got, JH.sha512_rows(rows))
    np.testing.assert_array_equal(got, TH.sha512_rows(rows))


@pytest.mark.parametrize("n", ROWS + [64])
def test_reduce512_native_matches_jax_and_ints(monkeypatch, n):
    rng = np.random.default_rng(100 + n)
    d = rng.integers(0, 256, size=(n, 64), dtype=np.uint8)
    edges = [2**512 - 1, 0, L - 1, L, 3 * L - 1, 2**256 - 1]
    for i, v in enumerate(edges[:n]):
        d[i] = np.frombuffer(v.to_bytes(64, "little"), dtype=np.uint8)
    monkeypatch.setenv("CBFT_HASHVEC", "native")
    got = TH.reduce512_mod_l(d)
    for mode in ("numpy", "serial"):
        monkeypatch.setenv("CBFT_HASHVEC", mode)
        np.testing.assert_array_equal(got, TH.reduce512_mod_l(d))
    monkeypatch.setenv("CBFT_HASHVEC", "numpy")
    np.testing.assert_array_equal(got, JH.reduce512_mod_l(d))
    for i in range(n):
        want = int.from_bytes(d[i].tobytes(), "little") % L
        assert int.from_bytes(got[i].tobytes(), "little") == want


def _challenge_rows(n: int, mlens, seed: int):
    rng = np.random.default_rng(seed)
    pubs = [rng.bytes(32) for _ in range(n)]
    rs = [rng.bytes(32) for _ in range(n)]
    msgs = [rng.bytes(mlens[i % len(mlens)]) for i in range(n)]
    return pubs, rs, msgs


@pytest.mark.parametrize("n", ROWS + [600])
@pytest.mark.parametrize("mlens", [[122], [0, 17, 122, 300]], ids=["uniform", "ragged"])
def test_serial_batch_challenge_native(monkeypatch, n, mlens):
    """strobe.c's sr25519_batch_challenge (on threads for 600 rows) against
    the serial compute_challenge, the JAX package's serial rung and the
    port's batch transcript."""
    pubs, rs, msgs = _challenge_rows(n, mlens, n + len(mlens))
    monkeypatch.setenv("CBFT_HASHVEC", "serial")
    got = srm.batch_challenge_words(pubs, rs, msgs)
    monkeypatch.setenv("CBFT_HASHVEC", "native")
    np.testing.assert_array_equal(got, srm.batch_challenge_words(pubs, rs, msgs))
    jks = jsrm._serial_compute_challenges(pubs, rs, msgs)
    for i in range(n):
        k = int.from_bytes(got[i].tobytes(), "little")
        assert k == jks[i]
        if i < 12:
            assert k == srm.compute_challenge(pubs[i], rs[i], msgs[i])


def test_batch_challenge_on_empty_messages(monkeypatch):
    """Eight or more empty messages: the port's batch transcript answers,
    equal to the serial compute_challenge; the JAX package's batch rung
    raises there (ROADMAP Queue 3 item 2), its serial rung agrees."""
    pubs, rs, msgs = _challenge_rows(9, [0], 5)
    monkeypatch.setenv("CBFT_HASHVEC", "native")
    got = srm.batch_challenge_words(pubs, rs, msgs)
    want = [srm.compute_challenge(p, r, m) for p, r, m in zip(pubs, rs, msgs)]
    assert [int.from_bytes(g.tobytes(), "little") for g in got] == want
    assert jsrm._serial_compute_challenges(pubs, rs, msgs) == want
    with pytest.raises(ValueError):
        jsrm.batch_challenge_words(pubs, rs, msgs)


def test_rung_selection(monkeypatch):
    for mode, rung in (("auto", "native"), ("native", "native"), ("numpy", "numpy"),
                       ("serial", "serial"), ("bogus", "native")):
        monkeypatch.setenv("CBFT_HASHVEC", mode)
        assert TH.active_rung() == rung
    # without the library: auto rides numpy, a forced native raises
    monkeypatch.setattr(TH, "_native_lib", [None])
    monkeypatch.setenv("CBFT_HASHVEC", "auto")
    assert TH.active_rung() == "numpy" and not TH._batch_sha512_active()
    monkeypatch.setenv("CBFT_HASHVEC", "native")
    with pytest.raises(RuntimeError, match="did not load"):
        TH.sha512_many([b"x"] * 9)
