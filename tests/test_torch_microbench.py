"""The port's microbench (cometbft_tpu_torch.ops.microbench) against the JAX
package's: every registered probe body through the JAX module's own loop
kernel (Pallas in interpret mode), the stacked conv, the verify kernel's
bench knobs, the experimental variants, the repaired signed select, the
SHA-512 rungs of ops/hashvec, and the probes' host/device rules.

Inputs are seeded with numpy as the JAX probes seed them. All arithmetic is
integer, so every comparison is exact equality.
"""

from __future__ import annotations

import functools
import hashlib
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from cometbft_tpu.ops import curve as JC
from cometbft_tpu.ops import field as JF
from cometbft_tpu.ops import hashvec as JH
from cometbft_tpu.ops import microbench as JMB
from cometbft_tpu.ops import pallas_verify as JPV
from cometbft_tpu_torch.ops import _build
from cometbft_tpu_torch.ops import curve as TC
from cometbft_tpu_torch.ops import hashvec as TH
from cometbft_tpu_torch.ops import microbench as MB
from cometbft_tpu_torch.ops import verify_kernel as VK

CSRC = pathlib.Path(_build.CSRC_DIR)


def _eq(got, want) -> None:
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


# ------------------------------------------------ K3: every probe body


def _jwindow(s):
    p = JC.Point(s[0], s[1], s[2], s[3])
    table_a = (s[0][None] + JC._BASE_TABLE17[0],) * 4
    ds = s[0][0] & 15
    return tuple(JC.window_step(p, ds, ds, JC._BASE_TABLE17, table_a, out_t=False))


def _jdbl5(s):
    p = JC.Point(s[0], s[1], s[2], s[3])
    for _ in range(4):
        p = JC.double_no_t(p)
    return tuple(JC.double(p))


def _jselect(s):
    return (JC._select17_signed(JC._BASE_TABLE17, s[0][0]).x, s[0], s[1], s[2])


# The JAX module's probe lambdas (microbench.py main, probe_variants,
# probe_variants2, probe_select16), by the name each probe prints.
JAX_BODIES = {
    "mul": lambda s: (JF.mul(s[0], s[1]), s[0]),
    "sq": lambda s: (JF.sq(s[0]),),
    "add(3-round carry)": lambda s: (JF.add(s[0], s[1]), s[0]),
    "sub(3-round carry)": lambda s: (JF.sub(s[0], s[1]), s[0]),
    "raw add (no carry)": lambda s: ((s[0] + s[1]) & 0x1FFF, s[0]),
    "carry_round20": lambda s: (JF._carry_round20(s[0]),),
    "conv only (no reduce)": lambda s: (JF._conv(s[0], s[1])[:20], s[0]),
    "loop overhead (s+1)": lambda s: (s[0] + 1,),
    "reduce_v2 mul": lambda s: (JMB._mul_v2(s[0], s[1]), s[0]),
    "roll-conv mul": lambda s: (JMB._mul_roll(s[0], s[1]), s[0]),
    "conv_roll only": lambda s: (JMB._conv_roll(s[0], s[1])[:20], s[0]),
    "add 1-round": lambda s: (JMB._add_1round(s[0], s[1]), s[0]),
    "split-conv mul": lambda s: (JMB._mul_split(s[0], s[1]), s[0]),
    "conv_split only": lambda s: (JMB._conv_split(s[0], s[1])[0], s[0]),
    "current field.mul": lambda s: (JF.mul(s[0], s[1]), s[0]),
    "current field.sub": lambda s: (JF.sub(s[0], s[1]), s[0]),
    "double_no_t": lambda s: tuple(JC.double_no_t(JC.Point(*s)))[:4],
    "double": lambda s: tuple(JC.double(JC.Point(*s))),
    "madd_pre": lambda s: tuple(JC.madd_pre(
        JC.Point(*s), JC._select17_signed(JC._BASE_TABLE17, s[0][0]))),
    "select17 only": _jselect,
    "select17 int32 (current)": _jselect,
    "window_step(out_t=False)": _jwindow,
    "5 doublings only": _jdbl5,
}


def test_registry_covers_every_jax_probe_body():
    assert list(MB.BODIES) == list(JAX_BODIES)
    assert {b.body_id for b in MB.BODIES.values()} == set(range(MB.N_BODIES))
    groups = MB.FIELD_PROBES + MB.WINDOW_PROBES + MB.CURVE_PROBES
    assert set(groups) <= set(MB.BODIES)


def test_kernel_body_enum_matches_registry():
    """csrc/microbench.cu numbers its bodies as the registry does."""
    src = (CSRC / "microbench.cu").read_text()
    names = re.search(r"enum BodyId \{([^}]*)\}", src).group(1)
    names = [n.strip() for n in names.split(",") if n.strip()]
    assert names[-1] == "N_BODIES" and len(names) - 1 == MB.N_BODIES
    assert [getattr(MB, n) for n in names[:-1]] == list(range(MB.N_BODIES))


@pytest.fixture
def interpret(monkeypatch):
    """JAX's Pallas kernels in interpret mode, as its own CPU tests run them."""
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


@pytest.mark.parametrize("name", list(JAX_BODIES))
def test_loop_body_matches_jax_kernel(interpret, name):
    """K3's plain version against the JAX module's loop kernel, 3
    iterations at 128 lanes; 'conv only' wraps int32 by iteration 3."""
    body = MB.BODIES[name]
    state = MB.probe_state(body.n_state)
    want = JMB._loop_kernel_factory(JAX_BODIES[name], body.n_state, 3)(
        *(jnp.asarray(x) for x in state))
    got = MB.loop(name, torch.from_numpy(state), 3)  # CPU tensor: the plain version
    for g, w in zip(got, want):
        _eq(g, w)


def test_conv_only_wraps_int32():
    state = torch.from_numpy(MB.probe_state(2))
    x = MB.loop_plain("conv only (no reduce)", state, 3).to(torch.int64)
    assert int(x.abs().max()) > 2**30


# ------------------------------------------------------- K4: stacked conv


def test_stacked_matches_jax():
    rng = np.random.default_rng(0)
    a, b = (rng.integers(0, 8000, size=(4, 20, MB.LANES)).astype(np.int32) for _ in range(2))
    want = jax.lax.fori_loop(
        0, 5, lambda _, s: JMB._conv_stacked(s, jnp.asarray(b))[:, :20] & 0x1FFF,
        jnp.asarray(a))
    _eq(MB.stacked(torch.from_numpy(a), torch.from_numpy(b), 5), want)


def test_wrappers_check_inputs():
    s = torch.zeros((2, 20, 4), dtype=torch.int32)
    with pytest.raises(ValueError):
        MB.loop("mul", s[:1], 1)  # n_state of mul is 2
    with pytest.raises(TypeError):
        MB.loop("mul", s.to(torch.int64), 1)
    with pytest.raises(ValueError):
        MB.loop("mul", s, -1)
    with pytest.raises(ValueError):
        MB.stacked(s, s, 1)


# -------------------------------------------------------- variant functions


def _wide_pair(seed: int):
    """(20, 64) int32 pairs: carried-range limbs, and limbs anywhere in
    int32 (every product and sum wraps)."""
    rng = np.random.default_rng(seed)
    small = [rng.integers(-2000, 26000, size=(20, 64)).astype(np.int32) for _ in range(2)]
    wild = [rng.integers(-2**31, 2**31, size=(20, 64)).astype(np.int32) for _ in range(2)]
    return [small, wild]


@pytest.mark.parametrize("fn", ["_mul_v2", "_add_1round", "_conv_roll", "_mul_roll",
                                "_conv_split", "_mul_split"])
def test_binary_variants_match_jax(fn):
    for a, b in _wide_pair(1):
        got = getattr(MB, fn)(torch.from_numpy(a), torch.from_numpy(b))
        want = getattr(JMB, fn)(jnp.asarray(a), jnp.asarray(b))
        if isinstance(want, tuple):
            for g, w in zip(got, want):
                _eq(g, w)
        else:
            _eq(got, want)


def test_unary_variants_match_jax():
    rng = np.random.default_rng(2)
    for hi in (2**31 - 1, 2**24):
        x40 = rng.integers(-hi, hi, size=(40, 32)).astype(np.int32)
        lo, h = (rng.integers(-hi, hi, size=(20, 32)).astype(np.int32) for _ in range(2))
        _eq(MB._carry_round40(torch.from_numpy(x40)), JMB._carry_round40(jnp.asarray(x40)))
        _eq(MB._reduce_v2(torch.from_numpy(x40)), JMB._reduce_v2(jnp.asarray(x40)))
        _eq(MB._reduce_split(torch.from_numpy(lo), torch.from_numpy(h)),
            JMB._reduce_split(jnp.asarray(lo), jnp.asarray(h)))
    a, b = (rng.integers(-2**31, 2**31, size=(4, 20, 16)).astype(np.int32) for _ in range(2))
    _eq(MB._conv_stacked(torch.from_numpy(a), torch.from_numpy(b)),
        JMB._conv_stacked(jnp.asarray(a), jnp.asarray(b)))


# ----------------------------------------------------------- signed select

# Digits outside the ladder's [-16, 15]: the microbench feeds raw limbs.
_DIGITS = [17, -17, 33, 5000, -16, 15]


def test_select17_out_of_range_digits_match_jax():
    """The port once gathered entry |d| and failed for |d| > 16; JAX's
    where-tree takes entry |d| & 15 (16 where |d| == 16)."""
    d = np.array(_DIGITS, dtype=np.int32)
    got = TC._select17_signed(TC.base_table17(torch.device("cpu")), torch.from_numpy(d))
    want = JC._select17_signed(JC._BASE_TABLE17, jnp.asarray(d))
    for g, w in zip(got, want):
        _eq(g, w)
    assert got.x[0].tolist() == [5402, 2771, 5402, 1224, 1525, 3521]


def test_select17_every_digit_matches_jax():
    d = np.concatenate([np.arange(-70, 71), [8191, -8191, 2**31 - 1, -2**31 + 1, -2**31]]
                       ).astype(np.int32)
    rng = np.random.default_rng(3)
    tab = [rng.integers(0, 8192, size=(17, 20, d.size)).astype(np.int32) for _ in range(4)]
    got = TC._select17_signed(tuple(torch.from_numpy(t) for t in tab), torch.from_numpy(d))
    want = JC._select17_signed(tuple(jnp.asarray(t) for t in tab), jnp.asarray(d))
    for g, w in zip(got, want):
        _eq(g, w)


def test_select17_int16_matches_jax():
    d = np.concatenate([np.arange(-40, 41), [70000, -65536 - 16]]).astype(np.int32)
    base = JC._BASE_TABLE17
    jt16 = tuple(jnp.broadcast_to(c, (17, 20, d.size)).astype(jnp.int16) for c in base)
    tt16 = tuple(c.expand(17, 20, d.size).to(torch.int16)
                 for c in TC.base_table17(torch.device("cpu")))
    got = MB._select17_int16(tt16, torch.from_numpy(d))
    want = JMB._select17_int16(jt16, jnp.asarray(d))
    for g, w in zip(got, want):
        _eq(g, w)


# ------------------------------------------------------------ K1 bench knobs


def _bench_inputs(batch: int):
    """The JAX microbench's verify-probe inputs: random A limbs and words."""
    rng = np.random.default_rng(1)
    a = rng.integers(0, 8000, size=(4, 20, batch)).astype(np.int32)
    w = rng.integers(0, 2**32, size=(3, 8, batch), dtype=np.uint64).astype(np.uint32)
    return a, w


def test_bench_verify_inputs_are_the_jax_probes():
    """The port's verify-probe inputs hold the JAX probe's bits."""
    a, w = _bench_inputs(256)
    t = MB.bench_verify_inputs(256, torch.device("cpu"))
    assert [x.dtype for x in t] == [torch.int32] * 7
    for got, want in zip(t, [*a, *(x.view(np.int32) for x in w)]):
        assert got.is_contiguous()
        _eq(got, want)


def test_verify_bench_knobs_match_jax_kernel():
    """n_windows=2, stages="nodecomp" against the Pallas kernel in
    interpret mode at 128 lanes, on the verify probes' inputs."""
    a, w = _bench_inputs(128)
    jmask, jok = JPV._verify_pallas_bench(*(jnp.asarray(x) for x in (*a, *w)),
                                          interpret=True, n_windows=2, stages="nodecomp")
    t = MB.bench_verify_inputs(128, torch.device("cpu"))
    mask, ok = VK.verify_bench(*t, n_windows=2, stages="nodecomp")
    _eq(mask, jmask)
    assert bool(ok) == bool(jok)


def test_verify_math_bench_full_ladder_is_verify_math():
    """Signed lanes, lane 3 carrying lane 2's signature: the full ladder
    with decoding is verify_math_ok, mask and all-ok."""
    from cometbft_tpu_torch.crypto import ed25519 as ted
    from cometbft_tpu_torch.ops import ed25519_kernel as TK

    privs = [ted.gen_priv_key_from_secret(b"bench-%d" % i) for i in range(8)]
    pubs = [p.pub_key().bytes_() for p in privs]
    msgs = [b"msg-%d" % i for i in range(8)]
    sigs = [p.sign(m) for p, m in zip(privs, msgs)]
    sigs[3] = sigs[2]
    _, safe, r, s, k = TK.stage_batch(pubs, msgs, sigs, 8)
    _, coords = TK.decompress_points(np.frombuffer(b"".join(safe), np.uint8).reshape(8, 32),
                                     "cpu")
    t = TK.staged_from_numpy(*TK.pad_coords_batch_minor(coords, 8), r, s, k, device="cpu")
    mask, ok = VK.verify_math_ok(*t)
    for nw in (0, 51):
        bmask, bok = VK.verify_math_bench(*t, n_windows=nw, stages="full")
        assert torch.equal(bmask, mask) and bool(bok) == bool(ok)
    assert mask.tolist() == [True] * 3 + [False] + [True] * 4
    for nw, stages in ((26, "full"), (0, "nodecomp")):  # wrong masks, by design
        assert not VK.verify_math_bench(*t, n_windows=nw, stages=stages)[0].any()
    with pytest.raises(ValueError):
        VK.verify_bench(*t, n_windows=52)
    with pytest.raises(ValueError):
        VK.verify_bench(*t, stages="half")


# -------------------------------------------------------------- hashvec

_LENGTHS = [0, 111, 112, 239, 240]


def _datas(lengths, seed: int):
    rng = np.random.default_rng(seed)
    return [rng.bytes(n) for n in lengths]


@pytest.mark.parametrize("lengths", [
    _LENGTHS,                                    # ragged: every group serial
    [n for n in _LENGTHS for _ in range(9)],     # groups of 9: batch compression
    [111] * 16,                                  # one length, one block
    [240] * 8 + [5, 300, 239, 0] + [17] * 10,    # a mix of grouped and stragglers
])
@pytest.mark.parametrize("mode", ["numpy", "serial", "auto"])
def test_sha512_rungs_match_hashlib_and_jax(monkeypatch, lengths, mode):
    monkeypatch.setenv("CBFT_HASHVEC", mode)
    datas = _datas(lengths, len(lengths))
    got = TH.sha512_many(datas)
    assert [bytes(r) for r in got] == [hashlib.sha512(d).digest() for d in datas]
    monkeypatch.setenv("CBFT_HASHVEC", "numpy")
    _eq(got, JH.sha512_many(datas))
    _eq(TH.sha512_mod_l_words(datas), JH.sha512_mod_l_words(datas))


def test_sha512_rows_and_blocks_match_jax(monkeypatch):
    monkeypatch.setenv("CBFT_HASHVEC", "numpy")
    for ln in _LENGTHS:
        rows = np.frombuffer(b"".join(_datas([ln] * 12, ln)), dtype=np.uint8).reshape(12, ln)
        _eq(TH.sha512_rows(rows), JH.sha512_rows(rows))
        buf, nb = TH._sha512_pad(rows)
        jbuf, jnb = JH._sha512_pad(rows)
        _eq(buf, jbuf)
        assert nb == jnb
    assert TH._SHA_K.tolist() == JH._SHA_K.tolist()


def test_sha512_rung_selection():
    assert TH.native_available() is True  # native/hashvec.c builds with cc
    for mode, batch in (("numpy", True), ("serial", False), ("auto", True),
                        ("native", True), ("bogus", True)):
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("CBFT_HASHVEC", mode)
            assert TH._batch_sha512_active() is batch


def test_reduce512_mod_l_matches_jax_and_ints(monkeypatch):
    monkeypatch.setenv("CBFT_HASHVEC", "numpy")
    rng = np.random.default_rng(9)
    d = rng.integers(0, 256, size=(40, 64), dtype=np.uint8)
    d[0] = 0xFF
    d[1] = 0
    _eq(TH.reduce512_mod_l(d), JH.reduce512_mod_l(d))
    from cometbft_tpu_torch.crypto.ed25519_math import L

    for i in range(d.shape[0]):
        k = int.from_bytes(d[i].tobytes(), "little") % L
        assert TH.reduce512_mod_l(d[i:i + 1])[0].tobytes() == k.to_bytes(32, "little")


# ------------------------------------------------------------- the probes


def test_probe_staging_runs_on_the_host(capsys):
    out = MB.probe_staging(n=32, mlen=40)
    assert set(out) == {"sha512_serial", "sha512_vec", "sha512_mod_l", "sr_serial", "sr_batch"}
    assert "hashvec native core: True" in capsys.readouterr().out


def test_main_staging_only_runs_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = []
    monkeypatch.setattr(MB, "probe_staging", lambda: calls.append("staging"))
    MB.main(["staging"])
    assert calls == ["staging"]
    assert "device=none" in capsys.readouterr().out


@pytest.mark.parametrize("probe", [
    lambda: MB.probe_loop("mul", base_iters=2),
    lambda: MB.probe_stacked(iters=2),
    lambda: MB.probe_full_verify(batch=128),
    lambda: MB.probe_select16(torch_iters=1),
])
def test_device_probes_raise_without_a_card(monkeypatch, probe):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="need a CUDA device"):
        probe()


# ------------------------------------------------------------- the build


def test_library_hash_covers_included_headers(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    hdr = tmp_path / "inner.cuh"
    hdr.write_text("int x;\n")
    (tmp_path / "outer.cuh").write_text('#pragma once\n#include "inner.cuh"\n')
    src = tmp_path / "k.cu"
    src.write_text('#include <cstdint>\n#include "outer.cuh"\n')
    before = _build._target(src)
    assert before.parent == tmp_path / "build" and before.name.startswith("k-")
    assert _build._target(src) == before
    hdr.write_text("int y;\n")
    assert _build._target(src) != before
    assert [p.name for p in _build._sources(src)] == ["k.cu", "outer.cuh", "inner.cuh"]


def test_both_kernel_sources_share_the_curve_header():
    # the probes' value bodies run the verify kernels' 32-bit field and quad
    # (probe32.cuh), their limb bodies the radix-2^13 header; the verify
    # kernels and the decoders share the 32-bit field
    names = [p.name for p in _build._sources(CSRC / "microbench.cu")]
    assert names == ["microbench.cu", "probe32.cuh", "quad25519.cuh", "fe32.cuh",
                     "curve25519.cuh"]
    names = [p.name for p in _build._sources(CSRC / "verify25519.cu")]
    assert names == ["verify25519.cu", "quad25519.cuh", "fe32.cuh"]
    names = [p.name for p in _build._sources(CSRC / "decompress25519.cu")]
    assert names == ["decompress25519.cu", "decode25519.cuh", "fe32.cuh"]
