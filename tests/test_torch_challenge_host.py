"""The challenge kernel K5's per-lane body on the host CPU: the message
assembly, the SHA-512 and the reduction mod L of csrc/challenge25519.cuh,
built with the host C++ compiler (__device__ and __forceinline__ defined
away) into a shared library loaded with ctypes, and run lane by lane as the
kernel's threads run it.

Swept over message geometries on both sides of every SHA-512 block
boundary (one, two and three blocks), with the variable bytes across zero
to three 64-bit word boundaries, and held bit for bit against hashlib with
Python's % L, the port's plain derive, and the JAX package's derive_fn on
the CPU. Skips only where no C++ compiler is found.
"""

from __future__ import annotations

import ctypes
import hashlib
import pathlib
import shutil
import subprocess

import numpy as np
import pytest
import torch

from cometbft_tpu.ops import challenge as JC
from cometbft_tpu_torch.ops import challenge as TC

CSRC = pathlib.Path(TC.__file__).resolve().parent.parent / "csrc"
L = 2**252 + 27742317777372353535851937790883648493

_WRAPPER = r"""
#include "challenge25519.cuh"

extern "C" void derive_all(const uint32_t* flat, const uint32_t* aw, const uint8_t* ptab,
                           int B, int plen, int var, int tlen, uint32_t* kw) {
  const chal::Geometry g = chal::geometry(B, plen, var, tlen);
  for (int lane = 0; lane < B; ++lane) {
    uint32_t k[8];
    chal::derive_lane(flat, aw, ptab, g, lane, k);
    for (int i = 0; i < 8; ++i) kw[i * B + lane] = k[i];
  }
}

extern "C" void sha512_all(const uint8_t* buf, int n, int nb, uint8_t* out) {
  for (int r = 0; r < n; ++r) chal::sha512_row(buf + (size_t)r * nb * 128, nb, out + 64 * r);
}

extern "C" void reduce_all(const uint64_t* x, int n, uint32_t* out) {
  for (int r = 0; r < n; ++r) chal::reduce512_mod_l(x + 8 * r, out + 8 * r);
}
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++") or shutil.which("clang++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler (g++, c++ or clang++)")
    d = tmp_path_factory.mktemp("challenge_host")
    src, so = d / "wrap.cpp", d / "libchal.so"
    src.write_text(_WRAPPER)
    subprocess.run([cxx, "-std=c++17", "-O2", "-shared", "-fPIC", "-D__host__=",
                    "-D__device__=", "-D__forceinline__=inline", f"-I{CSRC}", str(src), "-o",
                    str(so)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.derive_all.argtypes = [vp, vp, vp, ci, ci, ci, ci, vp]
    lib.sha512_all.argtypes = [vp, ci, ci, vp]
    lib.reduce_all.argtypes = [vp, ci, vp]
    return lib


def _batch(bucket: int, plen: int, var: int, tlen: int, seed: int):
    """A random wire block, encoding plane and prefix table of one geometry:
    every fourth lane left to the host (descriptor bit 15 clear), the rest
    spread over a few table rows."""
    rng = np.random.default_rng(seed)
    block = rng.integers(0, 2**32, size=TC.block_words(bucket, var), dtype=np.uint64)
    block = block.astype(np.uint32)
    sb = block[16 * bucket:].view(np.uint8)
    pids = rng.integers(0, TC.TABLE_ROWS, size=bucket)
    desc = (pids | 0x8000).astype(np.uint16)
    desc[::4] &= 0x7FFF
    sb[:2 * bucket] = desc.view(np.uint8)
    aw = rng.integers(0, 2**32, size=(8, bucket), dtype=np.uint64).astype(np.uint32)
    ptab = rng.integers(0, 256, size=(TC.TABLE_ROWS, TC.PREFIX_CAP), dtype=np.uint8)
    return block, aw, ptab, desc


def _want(block, aw, ptab, desc, bucket, plen, var, tlen) -> np.ndarray:
    """(8, bucket) uint32 k words by hashlib and Python ints."""
    sb = block[16 * bucket:].view(np.uint8)
    rw = block[:8 * bucket].reshape(8, bucket)
    out = np.zeros((8, bucket), dtype=np.uint32)
    for i in range(bucket):
        if not desc[i] >> 15:
            continue
        row = ptab[desc[i] & 0x7FFF].tobytes()
        vb = sb[2 * bucket + i * var:2 * bucket + (i + 1) * var].tobytes()
        m = (rw[:, i].astype("<u4").tobytes() + aw[:, i].astype("<u4").tobytes()
             + row[:plen] + vb + row[plen:plen + tlen])
        k = int.from_bytes(hashlib.sha512(m).digest(), "little") % L
        out[:, i] = np.frombuffer(k.to_bytes(32, "little"), dtype="<u4")
    return out


def _host_derive(lib, block, aw, ptab, bucket, plen, var, tlen) -> np.ndarray:
    kw = np.zeros((8, bucket), dtype=np.uint32)
    lib.derive_all(block.ctypes.data, aw.ctypes.data, ptab.ctypes.data, bucket, plen, var, tlen,
                   kw.ctypes.data)
    return kw


# (plen, var, tlen): tot = 64 + plen + var + tlen across the block boundaries
# 111/112 (one/two blocks) and 239/240 (two/three blocks), a vote's 186
# bytes, no prefix, no variable bytes, and the largest message; then the
# variable window [64 + plen, 64 + plen + var) across zero, one, two and
# three 64-bit word boundaries (and across the first block's end), in one,
# two and three blocks, at source offsets that differ lane by lane (odd var)
GEOMETRIES = [(20, 13, 14), (20, 13, 15), (100, 24, 51), (100, 24, 52), (103, 13, 6),
              (0, 24, 0), (100, 0, 20), (150, 24, 10), (0, 0, 0),
              (0, 8, 5), (3, 5, 9), (5, 6, 10), (95, 13, 14), (7, 24, 30), (60, 13, 20),
              (103, 24, 50)]


@pytest.mark.parametrize("geom", GEOMETRIES, ids=lambda g: "plen%d-var%d-tlen%d" % g)
def test_derive_lane_matches_hashlib_and_plain(lib, geom):
    plen, var, tlen = geom
    bucket = 64
    block, aw, ptab, desc = _batch(bucket, plen, var, tlen, seed=sum(geom))
    got = _host_derive(lib, block, aw, ptab, bucket, plen, var, tlen)
    np.testing.assert_array_equal(got, _want(block, aw, ptab, desc, bucket, plen, var, tlen))
    plain = TC.derive_plain(torch.from_numpy(block.view(np.int32)),
                            torch.from_numpy(aw.view(np.int32)), torch.from_numpy(ptab),
                            bucket, var, plen, tlen)
    np.testing.assert_array_equal(got, plain.numpy().view(np.uint32))


@pytest.mark.parametrize("geom", [(103, 13, 6), (20, 13, 15), (7, 24, 30)],
                         ids=lambda g: "plen%d-var%d-tlen%d" % g)
def test_derive_lane_matches_jax_derive_fn(lib, geom):
    import jax.numpy as jnp

    plen, var, tlen = geom
    bucket = 32
    block, aw, ptab, _ = _batch(bucket, plen, var, tlen, seed=7 + plen)
    _, want = JC.derive_fn(bucket, var, plen, tlen, 0, False)(
        jnp.asarray(block), jnp.asarray(aw), jnp.asarray(ptab))
    np.testing.assert_array_equal(_host_derive(lib, block, aw, ptab, bucket, plen, var, tlen),
                                  np.asarray(want))


@pytest.mark.parametrize("length", [0, 1, 111, 112, 239, 240, 300])
def test_sha512_row_matches_hashlib(lib, length):
    rng = np.random.default_rng(length)
    rows = rng.integers(0, 256, size=(9, length), dtype=np.uint8)
    nb = (length + 17 + 127) // 128
    buf = np.zeros((9, nb * 128), dtype=np.uint8)
    buf[:, :length] = rows
    buf[:, length] = 0x80
    buf[:, -16:] = np.frombuffer((length * 8).to_bytes(16, "big"), dtype=np.uint8)
    out = np.zeros((9, 64), dtype=np.uint8)
    lib.sha512_all(buf.ctypes.data, 9, nb, out.ctypes.data)
    assert [r.tobytes() for r in out] == [hashlib.sha512(r.tobytes()).digest() for r in rows]


def test_reduce512_matches_python_ints(lib):
    rng = np.random.default_rng(3)
    d = rng.integers(0, 256, size=(64, 64), dtype=np.uint8)
    d[0] = 0xFF
    d[1] = 0
    lows = [L - 1, L, L + 1, 2 * L, 3 * L - 1, 2**253, 2**256 - 1]
    for i, v in enumerate(lows):
        d[2 + i] = np.frombuffer(v.to_bytes(64, "little"), dtype=np.uint8)
    out = np.zeros((64, 8), dtype=np.uint32)
    lib.reduce_all(np.ascontiguousarray(d).ctypes.data, 64, out.ctypes.data)
    for i in range(64):
        want = int.from_bytes(d[i].tobytes(), "little") % L
        assert int.from_bytes(out[i].tobytes(), "little") == want, i
