"""The BLS kernels' arithmetic on the host CPU: the per-lane bodies of
csrc/bls12381.cu (csrc/curve381.cuh lane_* over tower381.cuh and
fp381.cuh) built with the host C++ compiler (__host__, __device__ and
__forceinline__ defined away) into a shared library loaded with ctypes, the
constant table filled from the oracle (ops/bls_launch.constants_table).

Held by canonical value against the port's plain versions (B1-B5 of
ops/bls_launch.py) and the oracle (crypto/bls12381_math.py): decompression
with its sign rule, non-squares and points outside the subgroup,
hash-to-G2, segmented sums with an identity sum, the Miller loop (whose
projective scalings the kernel must reproduce exactly) and the final
exponentiation. Exact everywhere. Skips only where no C++ compiler is found.
"""

from __future__ import annotations

import ctypes
import pathlib
import random
import shutil
import subprocess

import numpy as np
import pytest
import torch

from cometbft_tpu_torch.crypto import bls12381 as bls
from cometbft_tpu_torch.crypto import bls12381_math as o
from cometbft_tpu_torch.ops import bls_launch as BL
from cometbft_tpu_torch.ops.bls12381 import fp, htc

CSRC = pathlib.Path(BL.__file__).resolve().parent.parent / "csrc"
P = o.BLS_P

_WRAPPER = r"""
#include <cstring>
#include "curve381.cuh"
using namespace bls;

extern "C" {
int set_constants(const uint32_t* k, int n) {
  if (n != NK) return 1;
  std::memcpy(c_k, k, sizeof(uint32_t) * NK);
  return 0;
}
void decompress(int g, const int32_t* x_raw, const int32_t* sign, int check_sub, int B,
                uint32_t* out, int32_t* ok) {
  for (int j = 0; j < B; ++j) {
    if (g == 1) lane_decompress<1>(x_raw, sign, check_sub, B, j, out, ok);
    else lane_decompress<2>(x_raw, sign, check_sub, B, j, out, ok);
  }
}
void hash_to_g2(const int32_t* u, int B, uint32_t* out, int32_t* is_id) {
  for (int j = 0; j < B; ++j) lane_hash_to_g2(u, B, j, out, is_id);
}
void point_sum(int g, const uint32_t* pts, long long N, const int32_t* order,
               const int32_t* starts, int G, int check_sub, uint32_t* out, int32_t* is_id,
               int32_t* sub_ok) {
  for (int k = 0; k < G; ++k) {
    if (g == 1) {
      proj<fp> acc;
      lane_partial_sum(acc, pts, N, order, starts[k], starts[k + 1], 1);
      lane_sum_out(acc, check_sub, G, k, out, is_id, sub_ok);
    } else {
      proj<fp2> acc;
      lane_partial_sum(acc, pts, N, order, starts[k], starts[k + 1], 1);
      lane_sum_out(acc, check_sub, G, k, out, is_id, sub_ok);
    }
  }
}
void miller(const uint32_t* p, const uint32_t* q, int L, uint32_t* f) {
  for (int j = 0; j < L; ++j) lane_miller(p, q, L, j, f);
}
void final_exp(const uint32_t* f, int L, const int32_t* lanes, const int32_t* starts, int C,
               const int32_t* ga, const int32_t* gb, const int32_t* force, uint32_t* e,
               int32_t* ok) {
  for (int c = 0; c < C; ++c) lane_final_exp(f, L, lanes, starts, C, c, ga, gb, force, e, ok);
}
}
"""


class Host:
    """The host build behind the wrappers' signatures (CPU int32 tensors in
    and out, kernel planes of 12 words a value)."""

    def __init__(self, lib):
        self.lib = lib

    @staticmethod
    def _p(t):
        return None if t is None else t.data_ptr()

    def decompress(self, g, x_raw, sign, check):
        b = x_raw.shape[-1]
        ok = torch.empty(b, dtype=torch.int32)
        out = torch.empty(2 * g * BL.NW, b, dtype=torch.int32)
        self.lib.decompress(g, x_raw.data_ptr(), sign.data_ptr(), int(check), b, out.data_ptr(),
                            ok.data_ptr())
        return ok, out

    def hash_to_g2(self, u):
        b = u.shape[-1]
        out = torch.empty(4 * BL.NW, b, dtype=torch.int32)
        ident = torch.empty(b, dtype=torch.int32)
        self.lib.hash_to_g2(u.data_ptr(), b, out.data_ptr(), ident.data_ptr())
        return out, ident

    def point_sum(self, g, planes, order, starts, check):
        ng = starts.shape[0] - 1
        out = torch.empty(2 * g * BL.NW, ng, dtype=torch.int32)
        ident = torch.empty(ng, dtype=torch.int32)
        sub = torch.empty(ng, dtype=torch.int32)
        self.lib.point_sum(g, planes.data_ptr(), planes.shape[-1], order.data_ptr(),
                           starts.data_ptr(), ng, int(check), out.data_ptr(), ident.data_ptr(),
                           sub.data_ptr())
        return out, ident, sub

    def miller(self, p, q):
        f = torch.empty(12 * BL.NW, p.shape[-1], dtype=torch.int32)
        self.lib.miller(p.data_ptr(), q.data_ptr(), p.shape[-1], f.data_ptr())
        return f

    def final_exp(self, f, lanes, starts, ga=None, gb=None, force=None):
        c = starts.shape[0] - 1
        ok = torch.empty(c, dtype=torch.int32)
        e = torch.empty(12 * BL.NW, c, dtype=torch.int32)
        self.lib.final_exp(f.data_ptr(), f.shape[-1], lanes.data_ptr(), starts.data_ptr(), c,
                           self._p(ga), self._p(gb), self._p(force), e.data_ptr(), ok.data_ptr())
        return ok, e


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The plain versions' small tensors run faster on one intra-op thread,
    and parallel test workers then do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++") or shutil.which("clang++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler (g++, c++ or clang++)")
    d = tmp_path_factory.mktemp("bls_host")
    src = d / "bls_host.cpp"
    src.write_text(_WRAPPER)
    so = d / "libbls_host.so"
    subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-D__host__=", "-D__device__=",
                    "-D__forceinline__=inline", f"-I{CSRC}", str(src), "-o", str(so)],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.set_constants.argtypes = [vp, ci]
    lib.decompress.argtypes = [ci, vp, vp, ci, ci, vp, vp]
    lib.hash_to_g2.argtypes = [vp, ci, vp, vp]
    lib.point_sum.argtypes = [ci, vp, ll, vp, vp, ci, ci, vp, vp, vp]
    lib.miller.argtypes = [vp, vp, ci, vp]
    lib.final_exp.argtypes = [vp, ci, vp, vp, ci, vp, vp, vp, vp, vp]
    table = BL.constants_table()
    assert lib.set_constants(table.ctypes.data, table.size) == 0
    return Host(lib)


def _g1_points(n, seed):
    rng = random.Random(seed)
    g1 = o._ec_from_affine(o.BLS_G1)
    return [o._ec_affine(o._FpOps, o._ec_mul(o._FpOps, rng.randrange(1, o.BLS_R), g1))
            for _ in range(n)]


def _g2_points(n, seed):
    rng = random.Random(seed)
    g2 = o._ec_from_affine(o.BLS_G2)
    return [o._ec_affine(o._Fp2Ops, o._ec_mul(o._Fp2Ops, rng.randrange(1, o.BLS_R), g2))
            for _ in range(n)]


def _non_subgroup_g2(seed):
    """A point of the twist outside the r-order subgroup: the SvdW image of
    a field element before cofactor clearing."""
    rng = random.Random(seed)
    return o._svdw_map_fp2((rng.randrange(P), rng.randrange(P)), o._bls_setup()["svdw"])


def _no_root_x(g, seed):
    """An x whose curve value has no square root."""
    rng = random.Random(seed)
    while True:
        if g == 1:
            x = rng.randrange(P)
            if pow((x ** 3 + 4) % P, (P - 1) // 2, P) == P - 1:
                return x
        else:
            x = (rng.randrange(P), rng.randrange(P))
            gx = o.f2_add(o.f2_mul(o.f2_sq(x), x), o._B2)
            if not o.f2_legendre_is_square(gx):
                return x


def _raw(vals):
    return torch.from_numpy(fp.ints_to_limbs(vals))


def test_constants_table_layout():
    t = BL.constants_table()
    assert t.size == BL.NK
    words = [int(w) for w in t]
    assert sum(w << (32 * i) for i, w in enumerate(words[0:12])) == P
    assert (words[48] * P) % (1 << 32) == (1 << 32) - 1  # -p^-1 mod 2^32
    assert words[638:645] == [381, 379, 379, 380, 255, 507, 64]


@pytest.mark.parametrize("g", [1, 2])
def test_decompress_edge_lanes_match_plain_and_oracle(host, g):
    """Both sign bits, a non-square x, a point off the subgroup (on the
    curve) and the generator, with and without the subgroup check: ok bits
    bit for bit, coordinates by canonical value on every lane."""
    if g == 1:
        good = _g1_points(3, 40)
        good.append((good[0][0], P - good[0][1]))  # the other sign bit
        off = (0, 2)  # order 3 on y^2 = x^3 + 4
        encs = [o.bls_g1_compress(a) for a in good + [off, o.BLS_G1]]
        xs = [int.from_bytes(bytes([e[0] & 0x1F]) + e[1:], "big") for e in encs]
        signs = [(e[0] >> 5) & 1 for e in encs]
        xs.append(_no_root_x(1, 41))
        signs.append(1)
        x_raw = _raw(xs)
        want_ok = [True, True, True, True, True, True, False]
        want_sub = [True, True, True, True, False, True, False]
    else:
        good = _g2_points(3, 42)
        good.append((good[0][0], o.f2_neg(good[0][1])))  # the other sign bit
        off = _non_subgroup_g2(43)
        encs = [o.bls_g2_compress(a) for a in good + [off, o.BLS_G2]]
        x1 = [int.from_bytes(bytes([e[0] & 0x1F]) + e[1:48], "big") for e in encs]
        x0 = [int.from_bytes(e[48:], "big") for e in encs]
        signs = [(e[0] >> 5) & 1 for e in encs]
        nx = _no_root_x(2, 44)
        x0.append(nx[0])
        x1.append(nx[1])
        signs.append(0)
        x_raw = torch.stack([_raw(x0), _raw(x1)])
        want_ok = [True, True, True, True, True, True, False]
        want_sub = [True, True, True, True, False, True, False]
    sign = torch.tensor(signs, dtype=torch.int32)
    assert len(set(signs[:4])) == 2  # both sign bits among the valid lanes
    for check, want in ((False, want_ok), (True, want_sub)):
        ok_k, xy_k = host.decompress(g, x_raw, sign, check)
        ok_p, xy_p = BL.decompress_plain(g, x_raw, sign, check)
        assert ok_k.tolist() == ok_p.tolist() == [int(w) for w in want]
        assert BL.values(xy_k) == BL.values(xy_p)
    got = BL.values(xy_k)
    for j, enc in enumerate(encs):
        dec = (o.bls_g1_decompress if g == 1 else o.bls_g2_decompress)(enc)
        if g == 1:
            assert (got[0][j], got[1][j]) == dec
        else:
            assert ((got[0][j], got[1][j]), (got[2][j], got[3][j])) == dec


def test_hash_to_g2_matches_plain_and_oracle(host):
    msgs = [b"", b"abc"]
    u = torch.from_numpy(np.stack(htc.hash_to_field_limbs(msgs, bls.DST)))
    xy_k, id_k = host.hash_to_g2(u)
    got = BL.values(xy_k)
    assert id_k.tolist() == [0, 0]
    for j, m in enumerate(msgs):
        assert ((got[0][j], got[1][j]), (got[2][j], got[3][j])) == o.bls_hash_to_g2(m, bls.DST)
    xy_p, id_p = BL.hash_to_g2_plain(u[:, :, :1])
    assert id_p.tolist() == [0]
    assert [v[:1] for v in got] == BL.values(xy_p)


@pytest.mark.parametrize("g", [1, 2])
def test_point_sum_groups_and_identity(host, g):
    """Three uneven groups and one whose points cancel to the identity, the
    lanes interleaved; with the subgroup check of each sum."""
    affs = _g1_points(5, 45) if g == 1 else _g2_points(5, 46)
    neg = [(a[0], (P - a[1]) if g == 1 else o.f2_neg(a[1])) for a in affs[:1]]
    lanes = affs + neg  # lane 5 = -lane 0
    groups = [[0, 5], [1, 3], [2], [4]]  # group 0 sums to the identity
    order = torch.tensor([j for grp in groups for j in grp], dtype=torch.int32)
    starts = torch.tensor(np.cumsum([0] + [len(grp) for grp in groups]), dtype=torch.int32)
    coords = ([[a[0] for a in lanes], [a[1] for a in lanes]] if g == 1 else
              [[a[0][0] for a in lanes], [a[0][1] for a in lanes], [a[1][0] for a in lanes],
               [a[1][1] for a in lanes]])
    planes = BL.planes_of_ints(coords)
    out_k, id_k, sub_k = host.point_sum(g, planes, order, starts, True)
    out_p, id_p, sub_p = BL.point_sum_plain(g, planes, order, starts, True)
    assert id_k.tolist() == id_p.tolist() == [1, 0, 0, 0]
    assert sub_k.tolist() == sub_p.tolist() == [1, 1, 1, 1]
    assert BL.values(out_k) == BL.values(out_p)
    F = o._FpOps if g == 1 else o._Fp2Ops
    want = []
    for grp in groups[1:]:
        acc = None
        for j in grp:
            acc = o._ec_add(F, acc, o._ec_from_affine(lanes[j]))
        want.append(o._ec_affine(F, acc))
    got = BL.values(out_k)
    for k, w in enumerate(want, start=1):
        if g == 1:
            assert (got[0][k], got[1][k]) == w
        else:
            assert ((got[0][k], got[1][k]), (got[2][k], got[3][k])) == w


def test_miller_and_final_exp_match_plain_and_oracle(host):
    """Two pairs: the Miller values equal the plain version's (the same
    projective scalings), the segmented product of both and the final
    exponentiation equal the oracle's pairing product, a check over e(P, Q)
    * e(-P, Q) is one, a gate and a force act."""
    a1 = _g1_points(1, 47)[0]
    a2 = _g2_points(1, 48)[0]
    p_coords = [[a1[0], a1[0]], [a1[1], P - a1[1]]]
    q_coords = [[a2[0][0]] * 2, [a2[0][1]] * 2, [a2[1][0]] * 2, [a2[1][1]] * 2]
    pk, qk = BL.planes_of_ints(p_coords), BL.planes_of_ints(q_coords)
    f_k = host.miller(pk, qk)
    f_p = BL.miller_plain(pk[:, :1].contiguous(), qk[:, :1].contiguous())
    assert [v[:1] for v in BL.values(f_k)] == BL.values(f_p)
    lanes = torch.tensor([0, 0, 1], dtype=torch.int32)
    starts = torch.tensor([0, 1, 3], dtype=torch.int32)
    gate = torch.tensor([1, 0], dtype=torch.int32)
    ok, e = host.final_exp(f_k, lanes, starts, ga=gate)
    assert ok.tolist() == [0, 0]  # e(P, Q) != 1; the second check is gated off
    ok, e = host.final_exp(f_k, lanes, starts, force=torch.tensor([1, 0], dtype=torch.int32))
    assert ok.tolist() == [1, 1]
    vals = BL.values(e)
    want = o.bls_pairing(a1, a2)
    flat = [c for d in want for cc in d for c in cc]
    assert [v[0] for v in vals] == flat
    assert [v[1] for v in vals] == [1] + [0] * 11
