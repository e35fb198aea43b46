"""The pubkey decoders' per-key body on the host CPU, held against the JAX
package's decoders and the port's plain ones.

csrc/decode25519.cuh holds what a thread of csrc/decompress25519.cu runs
for one key: ZIP-215 decompression (ed25519) or ristretto255 DECODE
(sr25519) in the 8 x 32-bit field of csrc/fe32.cuh, and the canonical
radix-2^13 limbs it writes. Built here with the host C++ compiler
(__host__, __device__ and __forceinline__ defined away) into a ctypes
library.

The reference is cometbft_tpu/ops/ed25519_kernel._decompress_kernel and
sr25519_kernel._decompress_kernel, run by JAX on the CPU: ok equal on every
lane, the coordinates equal as field values on every lane (failed lanes
too: both run the same ring operations), the kernel's limbs canonical.
Skips only where no C++ compiler is found.
"""

from __future__ import annotations

import ctypes
import pathlib
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cometbft_tpu.ops import ed25519_kernel as JK
from cometbft_tpu.ops import sr25519_kernel as JS
from cometbft_tpu_torch.crypto import ed25519_math as oracle
from cometbft_tpu_torch.crypto import sr25519_math as srm
from cometbft_tpu_torch.ops import field as F
from cometbft_tpu_torch.ops import limbs as L
from cometbft_tpu_torch.ops import verify_kernel as VK

P = F.P
CSRC = pathlib.Path(VK.__file__).resolve().parent.parent / "csrc"

_WRAPPER = r"""
#include "decode25519.cuh"
using namespace f32;

extern "C" {
// The kernel's per-key body over a (8, B) batch.
void decode_batch(int scheme, const int* words, int* ok, int* ox, int* oy, int* oz, int* ot,
                  int B) {
  for (int b = 0; b < B; b++) {
    if (scheme)
      decode_key<SR25519>(words, ok, ox, oy, oz, ot, b, B);
    else
      decode_key<ED25519>(words, ok, ox, oy, oz, ot, b, B);
  }
}
void fe_to_limbs13(const uint32_t* w, int32_t* l, int n) {
  for (int k = 0; k < n; k++) {
    fe x;
    from_words256(x, w + 8 * k);
    to_limbs13(l + 20 * k, x);
  }
}
// to_limbs13's output as K1/K2 load A (from_limbs13), canonical words out.
void limbs13_round_trip(const uint32_t* w, uint32_t* o, int n) {
  for (int k = 0; k < n; k++) {
    fe x, y, c;
    int32_t l[20];
    from_words256(x, w + 8 * k);
    to_limbs13(l, x);
    from_limbs13(y, l);
    canonicalize(c, y);
    for (int i = 0; i < NW; i++) o[8 * k + i] = c.v[i];
  }
}
}
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++") or shutil.which("clang++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler (g++, c++ or clang++)")
    d = tmp_path_factory.mktemp("decode")
    src = d / "decode_host.cpp"
    src.write_text(_WRAPPER)
    so = d / "libdecode_host.so"
    subprocess.run([cxx, "-std=c++17", "-O2", "-shared", "-fPIC", "-D__host__=",
                    "-D__device__=", "-D__forceinline__=inline", f"-I{CSRC}", str(src), "-o",
                    str(so)], check=True, capture_output=True, text=True)
    h = ctypes.CDLL(str(so))
    vp = ctypes.c_void_p
    h.decode_batch.argtypes = [ctypes.c_int] + [vp] * 6 + [ctypes.c_int]
    h.fe_to_limbs13.argtypes = [vp, vp, ctypes.c_int]
    h.limbs13_round_trip.argtypes = [vp, vp, ctypes.c_int]
    return h


# ------------------------------------------------------------------ helpers


def _words(vals) -> np.ndarray:
    """ints < 2^256 -> (n, 8) uint32 little-endian words."""
    return np.array([[(v >> (32 * i)) & 0xFFFFFFFF for i in range(8)] for v in vals],
                    dtype=np.uint32)


def _ints(words: np.ndarray) -> list[int]:
    return [sum(int(w[i]) << (32 * i) for i in range(8)) for w in words.reshape(-1, 8)]


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


SPECIAL = [0, 1, 2, 19, P - 1, P, P + 1, 2 * P - 1, 2 * P, 2 * P + 1, 2**255 - 1, 2**255,
           2**256 - 38, 2**256 - 2, 2**256 - 1, 2**32 - 1, 2**128 - 1, 2**128, 2**224,
           2**256 - 2**128]


def _values(n: int, seed: int) -> list[int]:
    rng = np.random.default_rng(seed)
    return SPECIAL + [int.from_bytes(rng.bytes(32), "little") for _ in range(n)]


def _encodings(n: int, seed: int) -> list[int]:
    """The special encodings of tests/test_torch_fe32_host.py (y = 0, 1, 2,
    p - 1, p, p + 1, p + 2, 2^255 - 1, x = 0 with the sign bit, ...), the
    ZIP-215 and ristretto255 encodings of [k]B for k = 1..8, more edge
    encodings (non-squares, small order, odd and >= p ristretto s) and n
    random 256-bit strings."""
    rng = np.random.default_rng(seed)
    special = [0, 1, 2, P - 1, P, P + 1, P + 2, 2**255 - 1, 2**255 - 19 + 18,
               1 | 1 << 255, P | 1 << 255, (P + 1) | 1 << 255, 2**256 - 1,
               (P - 1) | 1 << 255, 3, 4, P - 2, P + 18, 2**255 - 20]
    good = [int.from_bytes(oracle.point_compress(oracle.scalar_mult(k, oracle.B_POINT)),
                           "little") for k in range(1, 9)]
    good += [int.from_bytes(srm.ristretto_encode(oracle.scalar_mult(k, oracle.B_POINT)),
                            "little") for k in range(1, 9)]
    return special + good + [int.from_bytes(rng.bytes(32), "little") for _ in range(n)]


def _host_decode(lib, scheme: int, words: np.ndarray):
    """(8, B) int32 words -> ok (B,) and (4, 20, B) int32 limbs."""
    b = words.shape[1]
    ok = np.full(b, -7, dtype=np.int32)
    out = np.full((4, 20, b), -7, dtype=np.int32)
    lib.decode_batch(scheme, _ptr(words), _ptr(ok), *(_ptr(out[i]) for i in range(4)), b)
    return ok, out


def _jax_decode(scheme: int, words: np.ndarray):
    fn = JS._decompress_kernel if scheme else JK._decompress_kernel
    ok, *coords = fn(jnp.asarray(words.view(np.uint32)))
    return np.asarray(ok), [np.asarray(c) for c in coords]


def _lane_values(limbs: np.ndarray) -> list[int]:
    """(20, B) limbs -> each lane's value mod p."""
    return [L.limbs_to_int(limbs[:, j]) % P for j in range(limbs.shape[1])]


def _assert_canonical(out: np.ndarray) -> None:
    assert out[:, :19].min() >= 0 and out[:, :19].max() <= 8191
    assert out[:, 19].min() >= 0 and out[:, 19].max() < 2**8


# ------------------------------------------------------------------- limbs


def test_to_limbs13_is_canonical(lib):
    vals = _values(200, 70)
    limbs = np.zeros((len(vals), 20), dtype=np.int32)
    lib.fe_to_limbs13(_ptr(_words(vals)), _ptr(limbs), len(vals))
    _assert_canonical(limbs)
    for v, row in zip(vals, limbs):
        assert row.tolist() == L.int_to_limbs(v % P).tolist()


@pytest.mark.parametrize("seed", [71, 72])
def test_to_limbs13_round_trips_through_the_verify_kernels_loader(lib, seed):
    """The decoders' limbs, as K1/K2 load A (fe32.cuh from_limbs13), give
    back the value mod p."""
    vals = _values(100, seed)
    out = np.zeros((len(vals), 8), dtype=np.uint32)
    lib.limbs13_round_trip(_ptr(_words(vals)), _ptr(out), len(vals))
    assert _ints(out) == [v % P for v in vals]


# ------------------------------------------------------------ the decoders


@pytest.mark.parametrize("scheme", [0, 1], ids=["ed25519", "sr25519"])
def test_decoder_body_against_jax_and_plain(lib, scheme):
    """The per-key body as the kernel instantiates it, against the JAX
    package's decoder and the port's plain one on special, valid and random
    encodings: ok bit for bit, every coordinate the same field value on
    every lane, the kernel's limbs canonical."""
    encs = _encodings(45, 80 + scheme)
    words = np.ascontiguousarray(_words(encs).T.view(np.int32))
    ok, out = _host_decode(lib, scheme, words)
    jok, jcoords = _jax_decode(scheme, words)
    plain = (VK.decompress_sr_math if scheme else VK.decompress_math)(torch.from_numpy(words))
    if scheme:
        want = [srm.ristretto_decode(e.to_bytes(32, "little")) is not None for e in encs]
    else:
        want = [oracle.point_decompress_zip215(e.to_bytes(32, "little")) is not None
                for e in encs]
    assert ok.tolist() == jok.astype(int).tolist() == plain[0].to(torch.int32).tolist()
    assert ok.astype(bool).tolist() == want
    assert 0 < sum(want) < len(want)
    _assert_canonical(out)
    for ci in range(4):
        got = _lane_values(out[ci])
        assert got == _lane_values(jcoords[ci]) == _lane_values(plain[1 + ci].numpy())
        assert out[ci].T.tolist() == [L.int_to_limbs(v).tolist() for v in got]
    # the kernel-vs-plain check chip_smoke.py runs on the card
    assert VK.decode_err((torch.from_numpy(ok) != 0, *map(torch.from_numpy, out)), plain) == 0


@pytest.mark.parametrize("scheme", [0, 1], ids=["ed25519", "sr25519"])
def test_decoded_keys_are_the_oracles_points(lib, scheme):
    """Valid keys ([k]B for random k) decode to the oracle's point: the
    same projective point, and T Z = X Y."""
    rng = np.random.default_rng(85 + scheme)
    points = [oracle.scalar_mult(int.from_bytes(rng.bytes(32), "little") % oracle.L,
                                 oracle.B_POINT) for _ in range(12)]
    encode = srm.ristretto_encode if scheme else oracle.point_compress
    encs = [encode(q) for q in points]
    decode = srm.ristretto_decode if scheme else oracle.point_decompress_zip215
    words = np.ascontiguousarray(
        _words([int.from_bytes(e, "little") for e in encs]).T.view(np.int32))
    ok, out = _host_decode(lib, scheme, words)
    assert ok.tolist() == [1] * len(encs)
    x, y, z, t = (_lane_values(out[ci]) for ci in range(4))
    for j, e in enumerate(encs):
        ox, oy, oz, _ = decode(e)
        assert x[j] * oz % P == ox * z[j] % P and y[j] * oz % P == oy * z[j] % P
        assert t[j] * z[j] % P == x[j] * y[j] % P


@pytest.mark.parametrize("which", ["pubkeys", "r"])
@pytest.mark.parametrize("scheme", [0, 1], ids=["ed25519", "sr25519"])
def test_decoder_body_on_chip_smoke_edge_lanes(lib, scheme, which):
    """chip_smoke.py's edge lanes (ed25519: ZIP-215 encodings, torsion
    components, y = p and y = p + 1, x = 0 with the sign bit; sr25519:
    non-canonical, odd and undecodable encodings, the carry-ripple lane):
    their pubkeys or their R encodings through the body against the JAX
    decoder."""
    import chip_smoke as CS

    path = CS._paths()["sr25519" if scheme else "ed25519"]
    pubs, msgs, sigs = path.make_commit(20, 13)
    path.edge_lanes(pubs, msgs, sigs)
    encs = pubs if which == "pubkeys" else [s[:32] for s in sigs]
    raw = np.frombuffer(b"".join(encs), dtype=np.uint8)
    words = np.ascontiguousarray(L.bytes_to_words(raw.reshape(-1, 32)).T.view(np.int32))
    ok, out = _host_decode(lib, scheme, words)
    jok, jcoords = _jax_decode(scheme, words)
    assert ok.tolist() == jok.astype(int).tolist()
    _assert_canonical(out)
    for ci in range(4):
        assert _lane_values(out[ci]) == _lane_values(jcoords[ci])


# --------------------------------------------------------- the comparison


@pytest.mark.parametrize("change", ["none", "loose", "ok", "coordinate"])
def test_decode_err_compares_ok_and_canonical_values(change):
    """verify_kernel.decode_err, the decoders' kernel-vs-plain check: 0 for
    the same points in other limbs (a coordinate plus p, carried), not 0
    where ok or a coordinate's value differs."""
    words = torch.from_numpy(np.ascontiguousarray(
        _words(_encodings(10, 97)).T.view(np.int32)))
    want = VK.decompress_math(words)
    got = [c.clone() for c in want]
    if change == "loose":  # X + p in carried limbs: the same value
        got[1] = got[1] + torch.from_numpy(L.int_to_limbs(P)).to(torch.int32)[:, None]
    elif change == "ok":
        got[0][3] = ~got[0][3]
    elif change == "coordinate":
        got[4][0, 5] += 1
    assert (VK.decode_err(got, want) == 0) == (change in ("none", "loose"))
