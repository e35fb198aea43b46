"""The BLS kernels' arithmetic on the host CPU: the per-lane bodies of
csrc/bls12381.cu (csrc/curve381.cuh lane_* over tower381.cuh and
fp381.cuh) built with the host C++ compiler (__host__, __device__ and
__forceinline__ defined away) into a shared library loaded with ctypes, the
constant table filled from the oracle (ops/bls_launch.constants_table).

Held by canonical value against the port's plain versions (B1-B5 of
ops/bls_launch.py) and the oracle (crypto/bls12381_math.py): decompression
with its sign rule, non-squares and points outside the subgroup (G2's by
the psi test psi(P) == [x]P, against the plain version's [r]P == O, also on
points with a component of order 13 or 23; G1's by the sigma test
sigma(P) == [-x^2]P, on points with components of order 3, 11, 10177 and
859267 and [r]R, alone and plus a G1 point, also against the JAX package's
in_subgroup, with beta pinned: the other cube root rejects the
generator), hash-to-G2, segmented sums run as the kernels run them (phase 1
over many small blocks, phase 2, the tail) with an identity sum, repeated
points and cancellations within and across blocks and sums outside the
subgroup, the Miller loop (whose projective scalings the kernel must
reproduce exactly) and the final exponentiation. Exact everywhere. Skips
only where no C++ compiler is found.
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
#include <algorithm>
#include <cstring>
#include <vector>
#include "curve381.cuh"
using namespace bls;

// a block's tree over m partials, its nt threads level by level
template <class T>
static void block_tree(std::vector<proj<T>>& part, long long m, int nt) {
  for (int k = (int)std::min<long long>(m, nt); k > 1;) {
    int h = k;
    for (int t = 0; t < nt; ++t) h = sum_tree_level(part.data(), t, k);
    k = h;
  }
}

// B3 in the kernels' order, with S slices a group and blocks of nt
// threads: phase 1 (S > 1) block by block into the partials, then a block
// a group (phase 2 on the partials, or on the lanes where S = 1) and the
// tail
template <class T>
static void point_sum_blocks(const uint32_t* pts, long long N, const int32_t* order,
                             const int32_t* starts, int G, int check_sub, int S, int nt,
                             uint32_t* out, int32_t* is_id, int32_t* sub_ok) {
  const long long cols = (long long)G * S;
  std::vector<uint32_t> parts((size_t)3 * nwords<T> * cols);
  std::vector<proj<T>> part(nt);
  for (long long b = 0; S > 1 && b < cols; ++b) {
    long long lo, hi;
    sum_slice(lo, hi, starts[b / S], starts[b / S + 1], (int)(b % S), S);
    for (int t = 0; t < nt; ++t) sum_lanes(part[t], pts, N, order, lo, hi, t, nt);
    block_tree(part, hi - lo, nt);
    proj_st(parts.data(), cols, b, part[0]);
  }
  for (int g = 0; g < G; ++g) {
    for (int t = 0; t < nt; ++t) {
      if (S > 1) sum_parts(part[t], parts.data(), cols, (long long)g * S, S, t, nt);
      else sum_lanes(part[t], pts, N, order, starts[g], starts[g + 1], t, nt);
    }
    block_tree(part, S > 1 ? S : starts[g + 1] - starts[g], nt);
    sum_affine(part[0], G, g, out, is_id);
    sub_ok[g] = check_sub ? pt_in_subgroup(part[0]) : 1;
  }
}

// the G1 test sigma(P) == [-x^2]P on affine points (ident: the identity),
// from Jacobian coordinates with Z = 1 (aff_ok: mixed additions) and with
// Z = y + 1 (jac_ok), and [r]P == O by r's ladder (ladder_ok)
extern "C" void in_g1(const uint32_t* pts, const int32_t* ident, int n, int32_t* aff_ok,
                      int32_t* jac_ok, int32_t* ladder_ok) {
  for (int j = 0; j < n; ++j) {
    proj<fp> p, r;
    aff_ld(p.x, p.y, pts, n, j);
    f_one(p.z);
    if (ident[j]) pt_identity(p);
    jac1 a;
    jac_from_proj(a, p);
    aff_ok[j] = jac_in_g1(a);
    fp k, one;
    fp_one(one);
    fp_add(k, p.y, one);
    fp_mul(p.x, p.x, k);
    fp_mul(p.y, p.y, k);
    fp_mul(p.z, p.z, k);
    jac_ok[j] = pt_in_subgroup(p);
    pt_mul_const(r, p, E_R);
    ladder_ok[j] = f_is_zero(r.z);
  }
}

// G1 in Jacobian coordinates: P + Q by the mixed addition (Q affine) and by
// the general one (Q scaled by Z = y + 1), from P (ident: the identity),
// affine out
extern "C" void jac1_adds(const uint32_t* p, const int32_t* pid, const uint32_t* q, int n,
                          uint32_t* mixed, int32_t* mid, uint32_t* full, int32_t* fid) {
  solo g;
  for (int j = 0; j < n; ++j) {
    jac1 a, b, s;
    aff_ld(a.x, a.y, p, n, j);
    fp_one(a.z);
    if (pid[j]) jac_identity(a);
    fp qx, qy, zi, zi2, zi3, x, y;
    aff_ld(qx, qy, q, n, j);
    jac_add_aff(s, a, qx, qy, g);
    fp_inv(zi, s.z);
    fp_sq(zi2, zi);
    fp_mul(zi3, zi2, zi);
    fp_mul(x, s.x, zi2);
    fp_mul(y, s.y, zi3);
    mid[j] = fp_is_zero(s.z);
    aff_st(mixed, n, j, x, y);
    fp k, one;
    fp_one(one);
    fp_add(k, qy, one);
    fp_sq(zi2, k);
    fp_mul(b.x, qx, zi2);
    fp_mul(zi3, zi2, k);
    fp_mul(b.y, qy, zi3);
    b.z = k;
    jac_add(s, a, b, g);
    fp_inv(zi, s.z);
    fp_sq(zi2, zi);
    fp_mul(zi3, zi2, zi);
    fp_mul(x, s.x, zi2);
    fp_mul(y, s.y, zi3);
    fid[j] = fp_is_zero(s.z);
    aff_st(full, n, j, x, y);
  }
}

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
               const int32_t* starts, int G, int check_sub, int S, int nt, uint32_t* out,
               int32_t* is_id, int32_t* sub_ok) {
  if (g == 1) point_sum_blocks<fp>(pts, N, order, starts, G, check_sub, S, nt, out, is_id, sub_ok);
  else point_sum_blocks<fp2>(pts, N, order, starts, G, check_sub, S, nt, out, is_id, sub_ok);
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

    def point_sum(self, g, planes, order, starts, check, slices=1, threads=64):
        """B3 as the kernels run it, with `slices` phase-1 blocks a group
        (1: a block a group alone) of `threads` threads."""
        ng = starts.shape[0] - 1
        out = torch.empty(2 * g * BL.NW, ng, dtype=torch.int32)
        ident = torch.empty(ng, dtype=torch.int32)
        sub = torch.empty(ng, dtype=torch.int32)
        self.lib.point_sum(g, planes.data_ptr(), planes.shape[-1], order.data_ptr(),
                           starts.data_ptr(), ng, int(check), slices, threads, out.data_ptr(),
                           ident.data_ptr(), sub.data_ptr())
        return out, ident, sub

    def in_g1(self, planes, ident):
        n = planes.shape[-1]
        out = [torch.empty(n, dtype=torch.int32) for _ in range(3)]
        self.lib.in_g1(planes.data_ptr(), ident.data_ptr(), n, *(t.data_ptr() for t in out))
        return [t.tolist() for t in out]

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
    lib.point_sum.argtypes = [ci, vp, ll, vp, vp, ci, ci, ci, ci, vp, vp, vp]
    lib.in_g1.argtypes = [vp, vp, ci, vp, vp, vp]
    lib.jac1_adds.argtypes = [vp, vp, vp, ci, vp, vp, vp, vp]
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


def _small_order_g2(ell, seed):
    """A twist point of order ell (13 or 23: ell^2 divides h2, that part of
    E'(Fp2) is Z/ell x Z/ell): [r h2 / ell^2] of an SvdW image."""
    rng = random.Random(seed)
    h2 = o._bls_setup()["h2"]
    F = o._Fp2Ops
    while True:
        a = _non_subgroup_g2(rng.randrange(1 << 30))
        s = o._ec_affine(F, o._ec_mul(F, o.BLS_R * h2 // (ell * ell), o._ec_from_affine(a)))
        if s is not None:
            return s


def _g2_add(a, b):
    F = o._Fp2Ops
    return o._ec_affine(F, o._ec_add(F, o._ec_from_affine(a), o._ec_from_affine(b)))


def _in_g2(a):
    F = o._Fp2Ops
    return o._ec_affine(F, o._ec_mul(F, o.BLS_R, o._ec_from_affine(a))) is None


def test_decompress_g2_psi_test_on_small_order_components(host):
    """One lane a thread: G2 points plus a point of order 13 or 23, such
    points alone and their sum, an SvdW image and a G2 point, decompressed
    with and without the subgroup check; the psi test's verdicts equal the
    plain version's [r]P == O and the oracle's."""
    g = _g2_points(2, 51)
    s13, s23 = _small_order_g2(13, 52), _small_order_g2(23, 53)
    affs = [_g2_add(g[0], s13), _g2_add(g[1], s23), s13, s23, _g2_add(s13, s23),
            _non_subgroup_g2(54), g[0]]
    encs = [o.bls_g2_compress(a) for a in affs]
    x1 = [int.from_bytes(bytes([e[0] & 0x1F]) + e[1:48], "big") for e in encs]
    x0 = [int.from_bytes(e[48:], "big") for e in encs]
    sign = torch.tensor([(e[0] >> 5) & 1 for e in encs], dtype=torch.int32)
    x_raw = torch.stack([_raw(x0), _raw(x1)])
    want_sub = [int(_in_g2(a)) for a in affs]
    assert want_sub == [0, 0, 0, 0, 0, 0, 1]
    for check, want in ((False, [1] * len(affs)), (True, want_sub)):
        ok_k, xy_k = host.decompress(2, x_raw, sign, check)
        ok_p, xy_p = BL.decompress_plain(2, x_raw, sign, check)
        assert ok_k.tolist() == ok_p.tolist() == want
        assert BL.values(xy_k) == BL.values(xy_p)


def test_point_sum_g2_outside_g2(host):
    """One thread's sum and subgroup check (B3 G2's tail, the psi test) on
    groups whose sums lie in G2, outside it (an SvdW image plus a G2 point,
    a G2 point plus a point of order 13), of order 13, and one where the
    order-13 point and its negative cancel and the SvdW image stays,
    against the plain version's [r] ladder."""
    g = _g2_points(2, 55)
    s13 = _small_order_g2(13, 56)
    off = _non_subgroup_g2(57)
    lanes = g + [off, s13, (s13[0], o.f2_neg(s13[1]))]  # lane 4 = -lane 3
    groups = [[0, 1], [0, 2], [1, 3], [3], [2, 3, 4, 0]]
    order = torch.tensor([j for grp in groups for j in grp], dtype=torch.int32)
    starts = torch.tensor(np.cumsum([0] + [len(grp) for grp in groups]), dtype=torch.int32)
    planes = BL.planes_of_ints([[a[k][c] for a in lanes] for k in (0, 1) for c in (0, 1)])
    out_k, id_k, sub_k = host.point_sum(2, planes, order, starts, True)
    out_p, id_p, sub_p = BL.point_sum_plain(2, planes, order, starts, True)
    assert id_k.tolist() == id_p.tolist() == [0] * 5
    assert sub_k.tolist() == sub_p.tolist() == [1, 0, 0, 0, 0]
    assert BL.values(out_k) == BL.values(out_p)


# ------------------------------------------------ G1 membership by sigma

H1 = 0x396c8c005555e1568c00aaab0000aaab  # the G1 cofactor, 3 11^2 10177^2 859267^2 52437899^2
K_BETA = 715  # csrc/fp381.cuh


def _curve_g1(rng):
    """A random point of E(Fp): y^2 = x^3 + 4."""
    while True:
        x = rng.randrange(P)
        t = (x ** 3 + 4) % P
        y = pow(t, (P + 1) // 4, P)
        if y * y % P == t:
            return x, y


def _g1_mul(k, a):
    return o._ec_affine(o._FpOps, o._ec_mul(o._FpOps, k, o._ec_from_affine(a)))


def _g1_add(a, b):
    F = o._FpOps
    return o._ec_affine(F, o._ec_add(F, o._ec_from_affine(a), o._ec_from_affine(b)))


def _g1_torsion(ell, seed):
    """A point of order ell (ell^2 divides h1; that part of E(Fp) has exponent
    ell): [h1 r / ell^2]R of a seeded random point R, the first that is not
    the identity."""
    rng = random.Random(seed)
    while True:
        s = _g1_mul(H1 * o.BLS_R // (ell * ell), _curve_g1(rng))
        if s is not None:
            assert _g1_mul(ell, s) is None
            return s


@pytest.fixture(scope="module")
def g1_cases():
    """G1 points, then points outside G1: (0, 2) of order 3, points of order
    11, 10177 and 859267, [r]R of a random R (its order all in h1's part),
    each of those plus a G1 point; then the identity (None). With the
    oracle's verdicts [r]P == O."""
    assert H1 * o.BLS_R == P + 1 - (o.BLS_X + 1)  # #E(Fp) = p + 1 - t, t = x + 1
    g = [o.BLS_G1, _g1_mul(12345, o.BLS_G1), (o.BLS_G1[0], P - o.BLS_G1[1])]
    rr = _g1_mul(o.BLS_R, _curve_g1(random.Random(90)))
    tors = [(0, 2)] + [_g1_torsion(ell, 91 + i) for i, ell in enumerate((11, 10177, 859267))]
    tors.append(rr)
    affs = g + tors + [_g1_add(g[k % 3], t) for k, t in enumerate(tors)] + [None]
    want = [int(a is None or _g1_mul(o.BLS_R, a) is None) for a in affs]
    assert want == [1] * 3 + [0] * 10 + [1]
    return affs, want


def _g1_planes(affs):
    pts = [a if a is not None else (0, 0) for a in affs]
    planes = BL.planes_of_ints([[a[0] for a in pts], [a[1] for a in pts]])
    return planes, torch.tensor([a is None for a in affs], dtype=torch.int32)


def _g1_proj(affs):
    """Projective (x k, y k, k), k = y + 1 (Z != 1; the identity (0, k, 0)), as
    plain limbs."""
    ks = [(a[1] + 1) % P if a is not None else 2 for a in affs]
    xs = [a[0] * k % P if a is not None else 0 for a, k in zip(affs, ks)]
    ys = [a[1] * k % P if a is not None else k for a, k in zip(affs, ks)]
    zs = [k if a is not None else 0 for a, k in zip(affs, ks)]
    return fp.from_ints(xs), fp.from_ints(ys), fp.from_ints(zs)


def test_g1_subgroup_by_sigma_matches_ladder_plain_and_oracle(host, g1_cases):
    """sigma(P) == [-x^2]P (Bowe 2019) from Jacobian coordinates with Z = 1
    (the mixed additions B1 G1 runs) and Z != 1, against r's ladder in the
    same build, the plain version's [r]P == O on projective points with Z
    != 1 and the oracle."""
    from cometbft_tpu_torch.ops.bls12381 import points as pts

    affs, want = g1_cases
    aff_ok, jac_ok, ladder_ok = host.in_g1(*_g1_planes(affs))
    assert aff_ok == jac_ok == ladder_ok == want
    plain = pts.in_subgroup(pts.G1Field, pts.Point(*_g1_proj(affs)))
    assert plain.to(torch.int32).tolist() == want


def test_g1_subgroup_verdicts_match_jax_reference(host, g1_cases):
    """The JAX package's in_subgroup(G1Field, ...) ([r]P == O, one batched
    call on 8 of the points, projective with Z != 1) gives the same verdicts
    as the sigma test."""
    import jax
    import jax.numpy as jnp

    from cometbft_tpu.ops.bls12381 import points as jpts

    affs, want = g1_cases
    pick = [0, 2, 3, 4, 8, 10, 12, 13]  # G1 twice, orders 3 and 11, [r]R, mixed, the identity
    sub = [affs[k] for k in pick]
    p = jpts.Point(*(jnp.asarray(c.numpy()) for c in _g1_proj(sub)))
    got = jax.jit(lambda q: jpts.in_subgroup(jpts.G1Field, q))(p)
    assert [int(v) for v in np.asarray(got)] == [want[k] for k in pick]
    assert host.in_g1(*_g1_planes(sub))[1] == [want[k] for k in pick]


def test_g1_beta_is_pinned(host):
    """beta is the cube root of unity for which sigma acts as [-x^2] on G1:
    with the other root (sigma then acts as [x^2 - 1]) the test rejects the
    generator."""
    beta = BL.g1_beta()
    other = P - 1 - beta
    assert pow(other, 3, P) == 1 and other != beta
    gx, gy = o.BLS_G1
    assert (beta * gx % P, gy) == (lambda a: (a[0], P - a[1]))(_g1_mul(o.BLS_X ** 2, o.BLS_G1))
    assert (other * gx % P, gy) == _g1_mul(o.BLS_X ** 2 - 1, o.BLS_G1)
    table = BL.constants_table()
    assert table[K_BETA:K_BETA + 12].tolist() == BL._words(beta * BL.R32 % P)
    planes, ident = _g1_planes([o.BLS_G1])
    wrong = table.copy()
    wrong[K_BETA:K_BETA + 12] = BL._words(other * BL.R32 % P)
    try:
        assert host.lib.set_constants(wrong.ctypes.data, wrong.size) == 0
        assert host.in_g1(planes, ident)[:2] == [[0], [0]]
    finally:
        assert host.lib.set_constants(table.ctypes.data, table.size) == 0
    assert host.in_g1(planes, ident)[:2] == [[1], [1]]


def test_g1_jacobian_additions_cases(host):
    """The G1 ladder's additions, mixed (Q affine) and general (Q with Z !=
    1): P + Q, P + P (doubles), P + (-P) (the identity), O + Q, on G1 points
    and on a point of order 3, against the oracle."""
    a, b = _g1_mul(5, o.BLS_G1), _g1_mul(7, o.BLS_G1)
    t = (0, 2)
    ps = [a, a, a, None, t, t]
    qs = [b, a, (a[0], P - a[1]), b, t, (0, P - 2)]
    pp, pid = _g1_planes(ps)
    qp, _ = _g1_planes(qs)
    n = len(ps)
    mixed, full = torch.empty(2 * BL.NW, n, dtype=torch.int32), torch.empty(2 * BL.NW, n,
                                                                           dtype=torch.int32)
    mid, fid = torch.empty(n, dtype=torch.int32), torch.empty(n, dtype=torch.int32)
    host.lib.jac1_adds(pp.data_ptr(), pid.data_ptr(), qp.data_ptr(), n, mixed.data_ptr(),
                       mid.data_ptr(), full.data_ptr(), fid.data_ptr())
    want = [_g1_add(p_, q_) for p_, q_ in zip(ps, qs)]
    assert want[2] is None and want[5] is None and want[4] == _g1_mul(2, t)
    for out, ident in ((mixed, mid), (full, fid)):
        v = BL.values(out)
        assert [None if ident[j] else (v[0][j], v[1][j]) for j in range(n)] == want


def test_decompress_g1_sigma_on_torsion_lanes(host, g1_cases):
    """B1 G1 one lane a thread, with and without the subgroup check, on the
    points above (the identity left out: its encoding is a host reject),
    against decompress_plain(1, ..., True)'s [r]P == O and the oracle."""
    affs, want = g1_cases
    affs, want = affs[:-1], want[:-1]
    encs = [o.bls_g1_compress(a) for a in affs]
    xs = [int.from_bytes(bytes([e[0] & 0x1F]) + e[1:], "big") for e in encs]
    sign = torch.tensor([(e[0] >> 5) & 1 for e in encs], dtype=torch.int32)
    x_raw = _raw(xs)
    for check, w in ((False, [1] * len(affs)), (True, want)):
        ok_k, xy_k = host.decompress(1, x_raw, sign, check)
        ok_p, xy_p = BL.decompress_plain(1, x_raw, sign, check)
        assert ok_k.tolist() == ok_p.tolist() == w
        assert BL.values(xy_k) == BL.values(xy_p)
    got = BL.values(xy_k)
    assert [(got[0][j], got[1][j]) for j in range(len(affs))] == affs


# ------------------------------------------------ B3 split over blocks

def _stepped(g, n, seed):
    """n affine points of G1 or G2, stepped from [seed] of the generator."""
    F = o._FpOps if g == 1 else o._Fp2Ops
    gen = o._ec_from_affine(o.BLS_G1 if g == 1 else o.BLS_G2)
    pt = o._ec_mul(F, seed, gen)
    out = []
    for i in range(n):
        if i:
            pt = o._ec_add(F, pt, gen)
        out.append(o._ec_affine(F, pt))
    return out


def _neg(g, a):
    return (a[0], P - a[1]) if g == 1 else (a[0], o.f2_neg(a[1]))


@pytest.mark.parametrize("g", [1, 2])
def test_point_sum_split_over_blocks(host, g):
    """B3 in the kernels' order with a forced small chunk (4 threads a
    block, 16 slices: a group of 1,000 spans 16 phase-1 blocks), and as one
    block a group (4 and 64 threads), against point_sum_plain and the
    oracle. Group 0 holds 1,000 lanes with P + P on one thread (a mixed
    addition doubles), on two threads of a block (the tree doubles) and in
    two blocks (phase 2 doubles), P and -P on one thread and in two blocks,
    and a slice whose partial is the identity; then groups of 1 and a group
    whose sum lies outside the subgroup (G1: plus a point of order 3; G2: an
    SvdW image), with the check."""
    S, NT, L = 16, 4, 1000
    base = _stepped(g, L, 7 + g)
    lanes = list(base)

    def lane(a):
        lanes.append(a)
        return len(lanes) - 1

    grp = list(range(L))  # group 0: lane i at position i, then the cases below
    lo3, hi3 = (L * 3) // S, (L * 4) // S  # slice 3: sums to the identity
    k = (hi3 - lo3 - 3) // 2
    qs = base[400:400 + k]
    r = base[500]
    two_r_neg = _neg(g, _stepped_sum(g, [r, r]))
    grp[lo3:hi3] = ([lane(q) for q in qs] + [lane(_neg(g, q)) for q in qs]
                    + [lane(r), lane(r), lane(two_r_neg)])
    assert (hi3 - lo3) == 2 * k + 3
    grp[0] = grp[4] = 10          # P + P on thread 0 of slice 0
    grp[1], grp[2] = 11, 11       # P + P on threads 1 and 2 of slice 0
    grp[5], grp[9] = 12, lane(_neg(g, base[12]))  # P and -P on thread 1
    grp[100], grp[900] = 13, 13   # P + P in slices 1 and 14
    grp[150], grp[850] = 14, lane(_neg(g, base[14]))  # P and -P in slices 2 and 13
    off = (0, 2) if g == 1 else o._svdw_map_fp2((3, 4), o._bls_setup()["svdw"])
    groups = [grp, [20], [21], [22, lane(off)]]
    order = torch.tensor([j for gr in groups for j in gr], dtype=torch.int32)
    starts = torch.tensor(np.cumsum([0] + [len(gr) for gr in groups]), dtype=torch.int32)
    coords = ([[a[0] for a in lanes], [a[1] for a in lanes]] if g == 1 else
              [[a[k][c] for a in lanes] for k in (0, 1) for c in (0, 1)])
    planes = BL.planes_of_ints(coords)
    want_p = BL.point_sum_plain(g, planes, order, starts, True)
    assert want_p[1].tolist() == [0, 0, 0, 0]
    assert want_p[2].tolist() == [1, 1, 1, 0]
    want = [_stepped_sum(g, [lanes[j] for j in gr]) for gr in groups]
    got_v = BL.values(want_p[0])
    for gi, w in enumerate(want):
        if g == 1:
            assert (got_v[0][gi], got_v[1][gi]) == w
        else:
            assert ((got_v[0][gi], got_v[1][gi]), (got_v[2][gi], got_v[3][gi])) == w
    for slices, threads in ((S, NT), (1, NT), (1, 64)):
        out, ident, sub = host.point_sum(g, planes, order, starts, True, slices, threads)
        assert ident.tolist() == want_p[1].tolist()
        assert sub.tolist() == want_p[2].tolist()
        assert BL.values(out) == got_v


def _stepped_sum(g, affs):
    F = o._FpOps if g == 1 else o._Fp2Ops
    acc = None
    for a in affs:
        acc = o._ec_add(F, acc, o._ec_from_affine(a))
    return o._ec_affine(F, acc)
