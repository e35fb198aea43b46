"""The formulas of the BLS kernels B1 G2, B2, B4 and B5 on the host CPU, their
thread groups included: csrc/curve381.cuh's group bodies over
csrc/group381.cuh, built with the host C++ compiler (__host__, __device__
and __forceinline__ defined away) into a shared library loaded with ctypes,
each trio (B1 G2, B2) or sextet (B4, B5) three or six host threads that
exchange through slots and a barrier where the card's warp uses shared
memory and __syncwarp (as tests/test_torch_fe32_host.py runs the verify
kernels' quads).

Held, by canonical value, against the oracle (crypto/bls12381_math.py), the
one-lane formulas they replace and the plain versions (ops/bls_launch.py):
- the cofactor clearing (Budroni-Pintore's psi formula for RFC 9380's
  h_eff = 3(x^2 - 1) h2, then [c], c = (3(x^2 - 1))^-1 mod r, by its base-x
  split over psi, in Jacobian coordinates) computes the oracle's [h2] =
  [#E'(Fp2) / r], not [h_eff], on twist points outside G2 and the
  identity, with the addition's doubling and inverse cases;
- the G2 subgroup test psi(P) == [x]P (Scott 2021), on a trio and alone,
  gives [r]P == O's verdict and the oracle's on G2 points, the identity,
  SvdW outputs before cofactor clearing and points with a component of
  order 13, 23 or 169, in projective coordinates with Z != 1;
- B1 G2 on a trio and alone equals decompress_plain(2, ..., True) on the
  edge lanes of chip_smoke.check_bls;
- the cyclotomic square (one thread, and split over a sextet) equals
  f12_mul(a, a) on easy-part outputs and on a zero Miller value, and the
  sextet's Fp12 product the plain one; the Miller step's Fp12 square
  (sextet and alone) equals f12_mul(a, a), its product by the sparse line
  f12_mul(f, l) with l's coefficients times xi^-1 by f2_mul, and xi^-1 by
  additions f2_mul(., K_XI_INV);
- the binary inverse and Legendre symbol and the root by the norm agree
  with the exponentiations they replace, on squares, non-squares and 0;
- a check's product on T sextets (a stride each, then a tree) equals the
  serial product for 1, 2, 151 and 256 values;
- B2 on trios, B4 on sextets, half-warps and alone (1, 2 and 151 pairs, and
  the loop's first steps, f = l on the first) and B5 on sextets equal
  hash_to_g2_plain, miller_plain and final_exp_plain lane for lane. Exact
  everywhere. Skips only where no C++ compiler is found.
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
from cometbft_tpu_torch.ops import bls_kernel as BK
from cometbft_tpu_torch.ops import bls_launch as BL
from cometbft_tpu_torch.ops.bls12381 import fp, htc, pairing, tower

CSRC = pathlib.Path(BL.__file__).resolve().parent.parent / "csrc"
P = o.BLS_P
H2 = o._bls_setup()["h2"]

_WRAPPER = r"""
#include <cstring>
#include <functional>
#include <pthread.h>
#include <thread>
#include <vector>
#include "curve381.cuh"
using namespace bls;

// A group of N host threads: slots in a shared buffer, a barrier where the
// card's group calls __syncwarp over its lanes.
template <int NN>
struct host_lanes {
  static constexpr int N = NN;
  int t;
  pthread_barrier_t* bar;
  uint32_t* buf;
  int slot;
  int parity;
  uint32_t* at(int j) { return buf + (parity * N + j) * slot; }
  void sync() { pthread_barrier_wait(bar); }
};
using host_trio = host_lanes<3>;
using host_sextet = host_lanes<6>;

struct host_group {
  pthread_barrier_t* bar;
  void sync() { pthread_barrier_wait(bar); }
};

// f(group r, its thread object, the check's group) on N T host threads
template <int N, class F>
static void run_groups(int T, int slot, const F& f) {
  std::vector<pthread_barrier_t> bars(T);
  pthread_barrier_t gbar;
  for (int r = 0; r < T; ++r) pthread_barrier_init(&bars[r], nullptr, N);
  pthread_barrier_init(&gbar, nullptr, N * T);
  std::vector<uint32_t> buf((size_t)T * 2 * N * slot, 0xdeadbeefu);
  std::vector<std::thread> th;
  for (int r = 0; r < T; ++r)
    for (int t = 0; t < N; ++t)
      th.emplace_back([&, r, t] {
        host_lanes<N> g{t, &bars[r], buf.data() + (size_t)r * 2 * N * slot, slot, 0};
        host_group grp{&gbar};
        f(r, g, grp);
      });
  for (auto& x : th) x.join();
  for (int r = 0; r < T; ++r) pthread_barrier_destroy(&bars[r]);
  pthread_barrier_destroy(&gbar);
}

static void ld_jac(jac& q, const uint32_t* pts, const int32_t* ident, long long n, long long j) {
  proj<fp2> p;
  aff_ld(p.x, p.y, pts, n, j);
  f2_one(p.z);
  if (ident[j]) pt_identity(p);
  jac_from_proj(q, p);
}

static void st_jac(uint32_t* out, int32_t* id, long long n, long long j, const jac& h) {
  fp2 x, y;
  id[j] = jac_to_affine(x, y, h);
  aff_st(out, n, j, x, y);
}

// the Miller loop's first `steps` bits after |x|'s top one (f = l on the
// first), conjugated as the whole loop ends, on a sextet (out) and alone
// (solo)
template <class G>
static void miller_head_body(const uint32_t* p, const uint32_t* q, int L, long long j, int steps,
                             uint32_t* out, G& g) {
  fp px, py;
  fp2 qx, qy;
  aff_ld(px, py, p, L, j);
  aff_ld(qx, qy, q, L, j);
  proj<fp2> t;
  pt_from_affine(t, qx, qy);
  fp12 f;
  f12_one(f);
  for (int k = 0; k < steps; ++k) {
    const int i = exp_nbits(E_X) - 2 - k;
    miller_dbl(f, t, px, py, k == 0, g);
    if (exp_bit(E_X, i)) miller_add(f, t, px, py, qx, qy, g);
  }
  f12_conj(f, f);
  if (g.t == 0) f12_st(out, L, j, f);
}

extern "C" {
int set_constants(const uint32_t* k, int n) {
  if (n != NK) return 1;
  std::memcpy(c_k, k, sizeof(uint32_t) * NK);
  return 0;
}

// [h2] of affine twist points (ident: the identity): Budroni-Pintore and
// the GLS ladder of c on a trio (out, id) and one thread's RCB ladder
// pt_mul_const(h2) (ref, rid)
void cofactor(const uint32_t* pts, const int32_t* ident, int n, uint32_t* out, int32_t* id,
              uint32_t* ref, int32_t* rid) {
  for (int j = 0; j < n; ++j) {
    run_groups<3>(1, nwords<fp>, [&](int, host_trio& g, host_group&) {
      jac q, h;
      ld_jac(q, pts, ident, n, j);
      jac_clear_cofactor(h, q, g);
      if (g.t == 0) st_jac(out, id, n, j, h);
    });
    proj<fp2> p, r;
    aff_ld(p.x, p.y, pts, n, j);
    f2_one(p.z);
    if (ident[j]) pt_identity(p);
    pt_mul_const(r, p, E_H2);
    fp2 x, y;
    rid[j] = pt_to_affine(x, y, r);
    aff_st(ref, n, j, x, y);
  }
}

// P + Q and 2P on a trio, Jacobian in and affine out
void jac_ops(const uint32_t* p, const int32_t* pid, const uint32_t* q, const int32_t* qid, int n,
             uint32_t* sum, int32_t* sid, uint32_t* dbl, int32_t* did) {
  for (int j = 0; j < n; ++j)
    run_groups<3>(1, nwords<fp>, [&](int, host_trio& g, host_group&) {
      jac a, b, s, d;
      ld_jac(a, p, pid, n, j);
      ld_jac(b, q, qid, n, j);
      jac_add(s, a, b, g);
      jac_dbl(d, a, g);
      if (g.t == 0) {
        st_jac(sum, sid, n, j, s);
        st_jac(dbl, did, n, j, d);
      }
    });
}

// the easy part of the final exponentiation of f (144, n), then its square
// by g12_cyclo_sq on a sextet (sq), by f12_cyclo_sq (one thread, sq1) and by
// f12_mul (ref); and the easy part times itself by g12_mul on a sextet (prod)
void cyclo(const uint32_t* f, int n, uint32_t* easy, uint32_t* sq, uint32_t* sq1, uint32_t* ref,
           uint32_t* prod) {
  for (int j = 0; j < n; ++j) {
    fp12 a, t, e;
    f12_ld(a, f, n, j);
    f12_conj(t, a);
    f12_inv(e, a);
    f12_mul(e, t, e);
    f12_frob(t, e, 2);
    f12_mul(e, t, e);
    f12_st(easy, n, j, e);
    f12_mul(t, e, e);
    f12_st(ref, n, j, t);
    f12_cyclo_sq(t, e);
    f12_st(sq1, n, j, t);
    run_groups<6>(1, nwords<fp6>, [&](int, host_sextet& g, host_group&) {
      fp12 s, m;
      g12_cyclo_sq(s, e, g);
      g12_mul(m, e, a, g);
      if (g.t == 0) {
        f12_st(sq, n, j, s);
        f12_st(prod, n, j, m);
      }
    });
  }
}

// Fp2 values x (24, n): the Legendre test (sq) and f2_sqrt_fast (root, ok)
// beside the exponentiations they replace: norm^((p-1)/2) (sq_exp) and
// f2_sqrt (root_old, ok_old); and Fp: fp_inv and fp_legendre of x.a beside
// x.a^(p-2) and x.a^((p-1)/2)
void roots(const uint32_t* x, int n, int32_t* sq, int32_t* sq_exp, uint32_t* root, int32_t* ok,
           uint32_t* root_old, int32_t* ok_old, uint32_t* inv, uint32_t* inv_exp, int32_t* leg,
           int32_t* leg_exp) {
  for (int j = 0; j < n; ++j) {
    fp2 a, r;
    f2_ld(a, x, n, j);
    sq[j] = f2_is_square(a);
    fp nrm, e;
    f2_norm(nrm, a);
    fp_pow(e, nrm, E_LEG);
    sq_exp[j] = !fp_eq_k(e, K_MINUS1);
    ok[j] = f2_sqrt_fast(r, a);
    f2_st(root, n, j, r);
    ok_old[j] = f2_sqrt(r, a);
    f2_st(root_old, n, j, r);
    fp_inv(e, a.a);
    fp_st(inv, n, j, e);
    fp_pow(e, a.a, E_PM2);
    fp_st(inv_exp, n, j, e);
    leg[j] = fp_legendre(a.a);
    fp_pow(e, a.a, E_LEG);
    leg_exp[j] = fp_is_zero(e) ? 0 : fp_eq_k(e, K_MINUS1) ? -1 : 1;
  }
}

// each check's product on T sextets (out) and serially (ref), (144, C)
void product(const uint32_t* f, int L, const int32_t* lanes, const int32_t* starts, int C, int T,
             uint32_t* out, uint32_t* ref) {
  std::vector<uint32_t> part((size_t)T * 12 * NW);
  for (int c = 0; c < C; ++c) {
    run_groups<6>(T, nwords<fp6>, [&](int r, host_sextet& g, host_group& grp) {
      fp12 acc;
      group_product(acc, f, L, lanes, starts[c], starts[c + 1], r, T, g, grp, part.data());
      if (r == 0 && g.t == 0) f12_st(out, C, c, acc);
    });
    fp12 acc, v;
    f12_one(acc);
    for (int k = starts[c]; k < starts[c + 1]; ++k) {
      f12_ld(v, f, L, lanes[k]);
      f12_mul(acc, acc, v);
    }
    f12_st(ref, C, c, acc);
  }
}

// B2 a trio a message
void hash_to_g2(const int32_t* u, int B, uint32_t* out, int32_t* is_id) {
  for (int j = 0; j < B; ++j)
    run_groups<3>(1, 2 * nwords<fp2>, [&](int, host_trio& g, host_group&) {
      group_hash_to_g2(u, B, j, out, is_id, g);
    });
}

// projective twist points from affine ones (ident: the identity), scaled by
// k = y + 1 so that Z != 1
static void ld_scaled(proj<fp2>& p, const uint32_t* pts, const int32_t* ident, long long n,
                      long long j) {
  aff_ld(p.x, p.y, pts, n, j);
  f2_one(p.z);
  if (ident[j]) pt_identity(p);
  fp2 k, one;
  f2_one(one);
  f2_add(k, p.y, one);
  f2_mul(p.x, p.x, k);
  f2_mul(p.y, p.y, k);
  f2_mul(p.z, p.z, k);
}

// the G2 test psi(P) == [x]P on a trio (trio_ok) and alone (solo_ok), and
// [r]P == O by r's ladder (ladder_ok)
void in_g2(const uint32_t* pts, const int32_t* ident, int n, int32_t* trio_ok, int32_t* solo_ok,
           int32_t* ladder_ok) {
  for (int j = 0; j < n; ++j) {
    proj<fp2> p, r;
    ld_scaled(p, pts, ident, n, j);
    run_groups<3>(1, nwords<fp>, [&](int, host_trio& g, host_group&) {
      const bool k = pt_in_subgroup(p, g);
      if (g.t == 0) trio_ok[j] = k;
    });
    solo_ok[j] = pt_in_subgroup(p);
    pt_mul_const(r, p, E_R);
    ladder_ok[j] = f_is_zero(r.z);
  }
}

// B1 G2 on a trio a lane (out, ok) and one lane a thread (out1, ok1)
void decompress_trio(const int32_t* x_raw, const int32_t* sign, int check, int B, uint32_t* out,
                     int32_t* ok, uint32_t* out1, int32_t* ok1) {
  for (int j = 0; j < B; ++j) {
    run_groups<3>(1, nwords<fp>, [&](int, host_trio& g, host_group&) {
      group_decompress<2>(x_raw, sign, check, B, j, out, ok, g);
    });
    lane_decompress<2>(x_raw, sign, check, B, j, out1, ok1);
  }
}

// B1 G1 on a trio a lane (out, ok) and one lane a thread (out1, ok1)
void decompress_g1_trio(const int32_t* x_raw, const int32_t* sign, int check, int B,
                        uint32_t* out, int32_t* ok, uint32_t* out1, int32_t* ok1) {
  for (int j = 0; j < B; ++j) {
    run_groups<3>(1, nwords<fp>, [&](int, host_trio& g, host_group&) {
      group_decompress<1>(x_raw, sign, check, B, j, out, ok, g);
    });
    lane_decompress<1>(x_raw, sign, check, B, j, out1, ok1);
  }
}

// G1 in Jacobian coordinates on a trio: P + Q (Q affine) and 2P, from P
// (pid: the identity), affine out
void jac1_trio_ops(const uint32_t* p, const int32_t* pid, const uint32_t* q, int n,
                   uint32_t* sum, int32_t* sid, uint32_t* dbl, int32_t* did) {
  for (int j = 0; j < n; ++j)
    run_groups<3>(1, nwords<fp>, [&](int, host_trio& g, host_group&) {
      jac1 a, s, d;
      aff_ld(a.x, a.y, p, n, j);
      fp_one(a.z);
      if (pid[j]) jac_identity(a);
      fp qx, qy;
      aff_ld(qx, qy, q, n, j);
      jac1_add_aff_trio(s, a, qx, qy, g);
      jac1_dbl_trio(d, a, g);
      if (g.t == 0) {
        fp zi, zi2, zi3, x, y;
        for (int k = 0; k < 2; ++k) {
          const jac1& r = k ? d : s;
          fp_inv(zi, r.z);
          fp_sq(zi2, zi);
          fp_mul(zi3, zi2, zi);
          fp_mul(x, r.x, zi2);
          fp_mul(y, r.y, zi3);
          (k ? did : sid)[j] = fp_is_zero(r.z);
          aff_st(k ? dbl : sum, n, j, x, y);
        }
      }
    });
}

// B4 on a sextet a pair (out), a half-warp a pair (out16) and one pair a
// thread (solo)
void miller(const uint32_t* p, const uint32_t* q, int L, uint32_t* out, uint32_t* out16,
            uint32_t* solo) {
  for (int j = 0; j < L; ++j) {
    run_groups<6>(1, batch<host_sextet, MILLER_JOBS>::SLOT,
                  [&](int, host_sextet& g, host_group&) { group_miller(p, q, L, j, out, g); });
    run_groups<16>(1, batch<host_lanes<16>, MILLER_JOBS>::SLOT,
                   [&](int, host_lanes<16>& g, host_group&) { group_miller(p, q, L, j, out16, g); });
    lane_miller(p, q, L, j, solo);
  }
}

void miller_head(const uint32_t* p, const uint32_t* q, int L, int steps, uint32_t* out,
                 uint32_t* out16, uint32_t* solo) {
  for (int j = 0; j < L; ++j) {
    run_groups<6>(1, batch<host_sextet, MILLER_JOBS>::SLOT,
                  [&](int, host_sextet& g, host_group&) {
                    miller_head_body(p, q, L, j, steps, out, g);
                  });
    run_groups<16>(1, batch<host_lanes<16>, MILLER_JOBS>::SLOT,
                   [&](int, host_lanes<16>& g, host_group&) {
                     miller_head_body(p, q, L, j, steps, out16, g);
                   });
    bls::solo g;
    miller_head_body(p, q, L, j, steps, solo, g);
  }
}

// Fp12 values a (144, n) and line coefficients c (c0, c_vw, c_v2w: 72, n):
// the Miller step's square on a sextet (sq6) and alone (sq1) beside
// f12_mul(a, a) (sq_ref); its sparse line product (ln6, ln1) beside
// f12_mul(a, l), l's last two coefficients times K_XI_INV by f2_mul
// (ln_ref); and f2_mul_xi_inv(c_vw) (xi) beside f2_mul(c_vw, K_XI_INV)
// (xi_ref)
void sq_line(const uint32_t* a_in, const uint32_t* c, int n, uint32_t* sq6, uint32_t* sq1,
             uint32_t* sq_ref, uint32_t* ln6, uint32_t* ln1, uint32_t* ln_ref, uint32_t* xi,
             uint32_t* xi_ref) {
  for (int j = 0; j < n; ++j) {
    fp12 a, r, l;
    fp2 c0, cvw, cv2w, k, b1, b2;
    f12_ld(a, a_in, n, j);
    f2_ld(c0, c, n, j);
    f2_ld(cvw, c + 2 * NW * n, n, j);
    f2_ld(cv2w, c + 4 * NW * n, n, j);
    f12_mul(r, a, a);
    f12_st(sq_ref, n, j, r);
    f2_k(k, K_XI_INV);
    f12_one(l);
    l.d0.c0 = c0;
    f2_mul(l.d1.c1, cvw, k);
    f2_mul(l.d1.c2, cv2w, k);
    f12_mul(r, a, l);
    f12_st(ln_ref, n, j, r);
    f2_st(xi_ref, n, j, l.d1.c1);
    f2_mul_xi_inv(b1, cvw);
    f2_mul_xi_inv(b2, cv2w);
    f2_st(xi, n, j, b1);
    bls::solo g1;
    g12_sq(r, a, g1);
    f12_st(sq1, n, j, r);
    g12_mul_line(r, a, c0, b1, b2, g1);
    f12_st(ln1, n, j, r);
    run_groups<6>(1, batch<host_sextet, MILLER_JOBS>::SLOT,
                  [&](int, host_sextet& g, host_group&) {
                    fp12 s, m;
                    g12_sq(s, a, g);
                    g12_mul_line(m, a, c0, b1, b2, g);
                    if (g.t == 0) {
                      f12_st(sq6, n, j, s);
                      f12_st(ln6, n, j, m);
                    }
                  });
  }
}

// B5 on T sextets a check; returns the all-ok word
int final_exp(const uint32_t* f, int L, const int32_t* lanes, const int32_t* starts, int C, int T,
              const int32_t* ga, const int32_t* gb, const int32_t* force, uint32_t* e,
              int32_t* ok) {
  int allok = 1;
  std::vector<uint32_t> part((size_t)T * 12 * NW);
  for (int c = 0; c < C; ++c)
    run_groups<6>(T, nwords<fp6>, [&](int r, host_sextet& g, host_group& grp) {
      if (group_final_exp(f, L, lanes, starts, C, c, r, T, g, grp, part.data(), ga, gb, force,
                          e, ok) == 0)
        allok = 0;
    });
  return allok;
}
}
"""


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The plain versions' small tensors run faster on one intra-op thread,
    and parallel test workers then do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++") or shutil.which("clang++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler (g++, c++ or clang++)")
    d = tmp_path_factory.mktemp("bls_formulas")
    src = d / "bls_formulas.cpp"
    src.write_text(_WRAPPER)
    so = d / "libbls_formulas.so"
    subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-pthread", "-D__host__=",
                    "-D__device__=", "-D__forceinline__=inline", f"-I{CSRC}", str(src), "-o",
                    str(so)], check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.set_constants.argtypes = [vp, ci]
    lib.cofactor.argtypes = [vp, vp, ci, vp, vp, vp, vp]
    lib.jac_ops.argtypes = [vp, vp, vp, vp, ci, vp, vp, vp, vp]
    lib.cyclo.argtypes = [vp, ci, vp, vp, vp, vp, vp]
    lib.roots.argtypes = [vp, ci] + [vp] * 10
    lib.product.argtypes = [vp, ci, vp, vp, ci, ci, vp, vp]
    lib.hash_to_g2.argtypes = [vp, ci, vp, vp]
    lib.final_exp.argtypes = [vp, ci, vp, vp, ci, ci, vp, vp, vp, vp, vp]
    lib.final_exp.restype = ci
    lib.in_g2.argtypes = [vp, vp, ci, vp, vp, vp]
    lib.decompress_trio.argtypes = [vp, vp, ci, ci, vp, vp, vp, vp]
    lib.decompress_g1_trio.argtypes = [vp, vp, ci, ci, vp, vp, vp, vp]
    lib.jac1_trio_ops.argtypes = [vp, vp, vp, ci, vp, vp, vp, vp]
    lib.miller.argtypes = [vp, vp, ci, vp, vp, vp]
    lib.miller_head.argtypes = [vp, vp, ci, ci, vp, vp, vp]
    lib.sq_line.argtypes = [vp, vp, ci] + [vp] * 8
    table = BL.constants_table()
    assert lib.set_constants(table.ctypes.data, table.size) == 0
    return lib


def _i32(vals):
    return torch.tensor(vals, dtype=torch.int32)


def _empty(rows, n):
    return torch.empty(rows * BL.NW, n, dtype=torch.int32)


def _g2_planes(affs):
    """Affine twist points (None: the identity) -> planes and identity flags."""
    pts = [a if a is not None else ((0, 0), (0, 0)) for a in affs]
    planes = BL.planes_of_ints([[a[k][c] for a in pts] for k in (0, 1) for c in (0, 1)])
    return planes, _i32([a is None for a in affs])


def _g2_affs(planes, ident):
    v = BL.values(planes)
    return [None if ident[j] else ((v[0][j], v[1][j]), (v[2][j], v[3][j]))
            for j in range(planes.shape[-1])]


def _off_subgroup(n, seed):
    """Twist points outside G2: SvdW images of random field elements, before
    any cofactor clearing."""
    rng = random.Random(seed)
    svdw = o._bls_setup()["svdw"]
    return [o._svdw_map_fp2((rng.randrange(P), rng.randrange(P)), svdw) for _ in range(n)]


def _mul(k, a):
    return o._ec_affine(o._Fp2Ops, o._ec_mul(o._Fp2Ops, k, o._ec_from_affine(a)))


def test_gls_digits_and_cofactor_identity():
    """The table's digits split c = (3(x^2 - 1))^-1 mod r in base x (psi
    acts as [x] on G2), and RFC 9380's h_eff is 3(x^2 - 1) times the
    oracle's h2, so [c] after [h_eff] is [h2]."""
    c = BL.cofactor_c()
    x = o.BLS_X
    digits = BL.gls_digits(c)
    assert sum(d * x ** i for i, d in enumerate(digits)) == c
    assert all(0 <= d < -x for d in digits) and digits[-1] == 1
    t = BL.constants_table()
    assert [int(t[657 + 2 * i]) | int(t[658 + 2 * i]) << 32 for i in range(5)] == digits
    h_eff = 0xbc69f08f2ee75b3584c6a0ea91b352888e2a8e9145ad7689986ff031508ffe1329c2f178731db956d82bf015d1212b02ec0ec69d7477c1ae954cbc06689f6a359894c0adebbf6b4e8020005aaa95551
    assert h_eff == 3 * (x * x - 1) * H2
    assert c * 3 * (x * x - 1) % o.BLS_R == 1


def test_cofactor_ladder_is_h2_not_h_eff(lib):
    """Points outside G2, a G2 point and the identity: the trio's
    Budroni-Pintore and GLS ladder of c equal pt_mul_const(h2) and the
    oracle's [h2]; [h_eff] would differ."""
    affs = _off_subgroup(5, 70) + [o.BLS_G2, None]
    planes, ident = _g2_planes(affs)
    n = len(affs)
    out, ref = _empty(4, n), _empty(4, n)
    oid, rid = torch.empty(n, dtype=torch.int32), torch.empty(n, dtype=torch.int32)
    lib.cofactor(planes.data_ptr(), ident.data_ptr(), n, out.data_ptr(), oid.data_ptr(),
                 ref.data_ptr(), rid.data_ptr())
    assert oid.tolist() == rid.tolist() == [0] * (n - 1) + [1]
    assert BL.values(out) == BL.values(ref)
    got = _g2_affs(out, oid)
    for a, g in zip(affs[:-1], got[:-1]):
        assert g == _mul(H2, a)
        assert _mul(o.BLS_R, g) is None  # in G2
    h_eff = 3 * (o.BLS_X ** 2 - 1) * H2
    assert got[0] != _mul(h_eff, affs[0])
    assert got[n - 2] == _mul(H2 % o.BLS_R, o.BLS_G2)


def test_jacobian_addition_cases(lib):
    """P + Q, P + P (doubles), P + (-P) (the identity), P + O, O + Q, and
    2P of a point and of the identity, on a trio, against the oracle."""
    a, b = _off_subgroup(2, 71)
    neg = (a[0], o.f2_neg(a[1]))
    ps = [a, a, a, a, None]
    qs = [b, a, neg, None, b]
    pp, pid = _g2_planes(ps)
    qp, qid = _g2_planes(qs)
    n = len(ps)
    s, d = _empty(4, n), _empty(4, n)
    sid, did = torch.empty(n, dtype=torch.int32), torch.empty(n, dtype=torch.int32)
    lib.jac_ops(pp.data_ptr(), pid.data_ptr(), qp.data_ptr(), qid.data_ptr(), n, s.data_ptr(),
                sid.data_ptr(), d.data_ptr(), did.data_ptr())
    F = o._Fp2Ops
    for j, (p, q) in enumerate(zip(ps, qs)):
        want = o._ec_affine(F, o._ec_add(F, o._ec_from_affine(p), o._ec_from_affine(q)))
        assert _g2_affs(s, sid)[j] == want
        assert _g2_affs(d, did)[j] == o._ec_affine(F, o._ec_dbl(F, o._ec_from_affine(p)))


def _rand_f12(n, seed):
    rng = random.Random(seed)
    return [[rng.randrange(P) for _ in range(n)] for _ in range(12)]


def test_cyclotomic_square_matches_product(lib):
    """Easy-part outputs of random values, of one and of a zero Miller value:
    the sextet's and one thread's cyclotomic squares equal f12_mul(a, a),
    and the sextet's Fp12 product (the easy-part output times the input)
    equals the plain version's."""
    vals = _rand_f12(4, 72)
    for k in range(12):
        vals[k] += [1 if k == 0 else 0, 0]  # one, then zero
    f = BL.planes_of_ints(vals)
    n = f.shape[-1]
    easy, sq, sq1, ref, prod = (_empty(12, n) for _ in range(5))
    lib.cyclo(f.data_ptr(), n, easy.data_ptr(), sq.data_ptr(), sq1.data_ptr(), ref.data_ptr(),
              prod.data_ptr())
    assert BL.values(sq) == BL.values(sq1) == BL.values(ref)
    e = BL.values(easy)
    assert [v[n - 1] for v in e] == [0] * 12  # zero stays zero
    assert [v[n - 2] for v in e] == [1] + [0] * 11
    assert len({tuple(v[j] for v in e) for j in range(n - 2)}) == n - 2
    want = BL._to_words(tower.f12_mul(BL._from_words(easy).reshape(2, 3, 2, fp.NLIMBS, n),
                                      BL._from_words(f).reshape(2, 3, 2, fp.NLIMBS, n)))
    assert BL.values(prod) == BL.values(want)


def test_legendre_inverse_and_root_by_the_norm(lib):
    """Squares, non-squares (in Fp2 and their real parts in Fp), 0, one and
    a purely real non-square: the binary Legendre symbol and inverse and
    the root by the norm agree with the exponentiations they replace."""
    rng = random.Random(73)
    xs = []
    for _ in range(4):
        r = (rng.randrange(P), rng.randrange(P))
        xs.append(o.f2_sq(r))
    while len(xs) < 8:
        x = (rng.randrange(P), rng.randrange(P))
        if not o.f2_legendre_is_square(x):
            xs.append(x)
    nr = next(a for a in range(2, 50) if pow(a, (P - 1) // 2, P) == P - 1)
    xs += [(0, 0), (1, 0), (nr, 0), (0, nr), (P - 1, 0)]
    n = len(xs)
    planes = BL.planes_of_ints([[x[0] for x in xs], [x[1] for x in xs]])
    i32 = [torch.empty(n, dtype=torch.int32) for _ in range(6)]
    w = [_empty(2, n), _empty(2, n), _empty(1, n), _empty(1, n)]
    sq, sq_exp, ok, ok_old, leg, leg_exp = i32
    root, root_old, inv, inv_exp = w
    lib.roots(planes.data_ptr(), n, sq.data_ptr(), sq_exp.data_ptr(), root.data_ptr(),
              ok.data_ptr(), root_old.data_ptr(), ok_old.data_ptr(), inv.data_ptr(),
              inv_exp.data_ptr(), leg.data_ptr(), leg_exp.data_ptr())
    want_sq = [int(o.f2_legendre_is_square(x)) for x in xs]
    assert sq.tolist() == sq_exp.tolist() == want_sq
    assert ok.tolist() == ok_old.tolist() == want_sq
    r_new, r_old = BL.values(root), BL.values(root_old)
    for j, x in enumerate(xs):
        a, b = (r_new[0][j], r_new[1][j]), (r_old[0][j], r_old[1][j])
        if want_sq[j]:
            assert o.f2_sq(a) == x and a in (b, o.f2_neg(b))
        else:
            assert a == b  # the old candidate, bit for bit
    assert BL.values(inv) == BL.values(inv_exp)
    assert BL.values(inv)[0] == [pow(x[0], P - 2, P) for x in xs]
    assert leg.tolist() == leg_exp.tolist()
    assert leg.tolist() == [0 if x[0] == 0 else 1 if pow(x[0], (P - 1) // 2, P) == 1 else -1
                            for x in xs]


@pytest.mark.parametrize("T", [1, 2, 3, 5])
def test_tree_product_matches_serial(lib, T):
    """Checks of 1, 2, 151 and 256 values (and an empty one) over a shuffled
    lane order: T sextets' strides and tree equal the serial product."""
    sizes = [1, 2, 151, 256, 0]
    L = 300
    rng = np.random.default_rng(74 + T)
    f = BL.planes_of_ints(_rand_f12(L, 75))
    lanes = _i32(np.concatenate([rng.choice(L, s, replace=False) for s in sizes]))
    starts = _i32(np.cumsum([0] + sizes))
    C = len(sizes)
    out, ref = _empty(12, C), _empty(12, C)
    lib.product(f.data_ptr(), L, lanes.data_ptr(), starts.data_ptr(), C, T, out.data_ptr(),
                ref.data_ptr())
    assert BL.values(out) == BL.values(ref)
    assert [v[C - 1] for v in BL.values(out)] == [1] + [0] * 11


def test_hash_to_g2_trios_match_plain_and_oracle(lib):
    msgs = [b""] + [b"bls-formulas-%d" % i for i in range(7)]
    u = torch.from_numpy(np.stack(htc.hash_to_field_limbs(msgs, bls.DST)))
    n = len(msgs)
    out, ident = _empty(4, n), torch.empty(n, dtype=torch.int32)
    lib.hash_to_g2(u.data_ptr(), n, out.data_ptr(), ident.data_ptr())
    want, want_id = BL.hash_to_g2_plain(u)
    assert ident.tolist() == want_id.tolist() == [0] * n
    assert BL.values(out) == BL.values(want)
    assert _g2_affs(out, ident)[0] == o.bls_hash_to_g2(b"", bls.DST)


def test_final_exp_trios_match_plain(lib):
    """Checks of 1, 2, 3 and 5 values over 11 lanes, on one sextet a check
    and on two, with a gate and a force; a check over e(P, Q) e(-P, Q) is
    one."""
    L = 11
    vals = _rand_f12(L - 2, 76)
    p = o._ec_affine(o._FpOps, o._ec_mul(o._FpOps, 5, o._ec_from_affine(o.BLS_G1)))
    f_pq = o.bls_miller_loop(p, o.BLS_G2)
    f_npq = o.bls_miller_loop((p[0], P - p[1]), o.BLS_G2)
    for k, c in enumerate(c for d in (f_pq, f_npq) for cc in d for c2 in cc for c in c2):
        vals[k % 12].append(c)
    f = BL.planes_of_ints(vals)
    sizes = [1, 2, 3, 5]
    lanes = _i32([0, L - 2, L - 1, 1, 2, 3, 4, 5, 6, 7, 8])
    starts = _i32(np.cumsum([0] + sizes))
    C = len(sizes)
    gate = _i32([1, 1, 0, 1])
    force = _i32([0, 0, 0, 1])
    want_ok, want_e, want_all = BL.final_exp_plain(f, lanes, starts, gate, None, force)
    assert want_ok.tolist() == [0, 1, 0, 1]
    for T in (1, 2):
        e, ok = _empty(12, C), torch.empty(C, dtype=torch.int32)
        allok = lib.final_exp(f.data_ptr(), L, lanes.data_ptr(), starts.data_ptr(), C, T,
                              gate.data_ptr(), None, force.data_ptr(), e.data_ptr(), ok.data_ptr())
        assert ok.tolist() == want_ok.tolist()
        assert allok == int(want_all) == 0
        assert BL.values(e) == BL.values(want_e)


def _small_order(ell, seed):
    """A twist point of order ell, for ell = 13 or 23: ell^2 divides h2 and
    that part of E'(Fp2) is Z/ell x Z/ell, so [r h2 / ell^2] of an SvdW
    image has order ell or 1; the first that is not the identity."""
    rng = random.Random(seed)
    svdw = o._bls_setup()["svdw"]
    while True:
        a = o._svdw_map_fp2((rng.randrange(P), rng.randrange(P)), svdw)
        s = _mul(o.BLS_R * H2 // (ell * ell), a)
        if s is not None:
            return s


def _add(a, b):
    F = o._Fp2Ops
    return o._ec_affine(F, o._ec_add(F, o._ec_from_affine(a), o._ec_from_affine(b)))


def test_g2_subgroup_by_psi_matches_ladder_and_oracle(lib):
    """psi(P) == [x]P (Scott 2021) on a trio and alone, from projective
    coordinates with Z != 1, against r's ladder and the oracle: G2 points,
    -G2, the identity, SvdW outputs before cofactor clearing, points of
    order 13, 23 and 299 (13^2 and 23^2 divide h2), G2 points plus such a
    point, and an SvdW output's [r] (its order all in h2's part)."""
    assert H2 % 169 == 0 and H2 % 529 == 0
    g2 = [o.BLS_G2, _mul(12345, o.BLS_G2), (o.BLS_G2[0], o.f2_neg(o.BLS_G2[1]))]
    off = _off_subgroup(4, 80)
    s13, s23 = _small_order(13, 81), _small_order(23, 82)
    assert _mul(13, s13) is None and _mul(23, s23) is None
    s299 = _add(s13, s23)
    mixed = [_add(g2[1], s13), _add(g2[0], s23), _add(g2[1], s299), _mul(o.BLS_R, off[0])]
    affs = g2 + off + [s13, s23, s299] + mixed + [None]
    want = [int(a is None or _mul(o.BLS_R, a) is None) for a in affs]
    assert want == [1] * 3 + [0] * 11 + [1]
    planes, ident = _g2_planes(affs)
    n = len(affs)
    out = [torch.empty(n, dtype=torch.int32) for _ in range(3)]
    lib.in_g2(planes.data_ptr(), ident.data_ptr(), n, *(t.data_ptr() for t in out))
    trio, solo, ladder = (t.tolist() for t in out)
    assert trio == solo == ladder == want


def _edge_g2_lanes():
    """chip_smoke.check_bls's B1 G2 lanes: an x >= p (a host reject, staged
    as the generator), an SvdW point outside G2, G2 points with both sign
    bits, an x with no root; staged as bls_kernel stages them."""
    g2 = [_mul(k, o.BLS_G2) for k in (3, 4, 5)]
    g2.append((g2[0][0], o.f2_neg(g2[0][1])))
    x_bad = P.to_bytes(48, "big")
    encs = [bytes([x_bad[0] | 0x80]) + x_bad[1:] + bytes(48),
            o.bls_g2_compress(o._svdw_map_fp2((3, 4), o._bls_setup()["svdw"]))]
    encs += [o.bls_g2_compress(a) for a in g2]
    rng = random.Random(84)
    while True:  # below 2^376: the top byte carries the flags
        x = (rng.getrandbits(376), rng.getrandbits(376))
        if not o.f2_legendre_is_square(o.f2_add(o.f2_mul(o.f2_sq(x), x), o._B2)):
            encs.append(bytes([0x80]) + x[1].to_bytes(48, "big")[1:] + x[0].to_bytes(48, "big"))
            break
    pre, _, rows = BK._structural_check([BK._G1_GEN_ENC] * len(encs), encs, len(encs))
    assert not pre[0] and pre[1:].all()
    x, sign = BK._x_planes(rows)
    assert len(set(sign.tolist())) == 2
    return torch.from_numpy(np.ascontiguousarray(x)), torch.from_numpy(sign)


def test_decompress_g2_trio_and_lane_match_plain(lib):
    x, sign = _edge_g2_lanes()
    n = x.shape[-1]
    for check in (True, False):
        out, out1 = _empty(4, n), _empty(4, n)
        ok, ok1 = torch.empty(n, dtype=torch.int32), torch.empty(n, dtype=torch.int32)
        lib.decompress_trio(x.data_ptr(), sign.data_ptr(), int(check), n, out.data_ptr(),
                            ok.data_ptr(), out1.data_ptr(), ok1.data_ptr())
        want_ok, want = BL.decompress_plain(2, x, sign, check)
        assert ok.tolist() == ok1.tolist() == want_ok.tolist()
        assert want_ok.tolist() == [1, 0 if check else 1, 1, 1, 1, 1, 0]
        assert BL.values(out) == BL.values(out1) == BL.values(want)


def test_miller_square_line_and_xi_inverse(lib):
    """The Miller step's Fp12 square and sparse line product, on a sextet
    and alone, and xi^-1 by additions, against f12_mul and f2_mul."""
    n = 4
    a = BL.planes_of_ints(_rand_f12(n, 85))
    rng = random.Random(86)
    c = BL.planes_of_ints([[rng.randrange(P) for _ in range(n)] for _ in range(6)])
    outs = [_empty(12, n) for _ in range(6)] + [_empty(2, n), _empty(2, n)]
    lib.sq_line(a.data_ptr(), c.data_ptr(), n, *(t.data_ptr() for t in outs))
    sq6, sq1, sq_ref, ln6, ln1, ln_ref, xi, xi_ref = (BL.values(t) for t in outs)
    assert sq6 == sq1 == sq_ref
    assert ln6 == ln1 == ln_ref
    assert xi == xi_ref
    cv = BL.values(c)
    xi_inv = o._XI_INV
    assert [(xi[0][j], xi[1][j]) for j in range(n)] == [
        o.f2_mul((cv[2][j], cv[3][j]), xi_inv) for j in range(n)]
    want = BL._to_words(tower.f12_mul(BL._from_words(a).reshape(2, 3, 2, fp.NLIMBS, n),
                                      BL._from_words(a).reshape(2, 3, 2, fp.NLIMBS, n)))
    assert sq_ref == BL.values(want)


def _pairs(n, seed):
    """n (P, Q) pairs: G1 and G2 points stepped from seeded multiples."""
    F1, F2 = o._FpOps, o._Fp2Ops
    g1, g2 = o._ec_from_affine(o.BLS_G1), o._ec_from_affine(o.BLS_G2)
    a, b = o._ec_mul(F1, seed, g1), o._ec_mul(F2, seed + 1, g2)
    ps, qs = [], []
    for _ in range(n):
        ps.append(o._ec_affine(F1, a))
        qs.append(o._ec_affine(F2, b))
        a, b = o._ec_add(F1, a, g1), o._ec_add(F2, b, g2)
    pk = BL.planes_of_ints([[x[0] for x in ps], [x[1] for x in ps]])
    qk = BL.planes_of_ints([[x[k][c] for x in qs] for k in (0, 1) for c in (0, 1)])
    return pk, qk


@pytest.fixture(scope="module")
def pairs151():
    """151 pair lanes (the 150 commit's aggregate check has 151) over 16
    distinct pairs, lane k holding pair k mod 16, and the plain Miller
    values of the 16 (the plain version takes ~0.2 s a lane on the CPU)."""
    pk, qk = _pairs(16, 87)
    want = BL.values(BL.miller_plain(pk, qk))
    idx = torch.arange(151) % 16
    return (pk[:, idx].contiguous(), qk[:, idx].contiguous(),
            [[v[k] for k in idx.tolist()] for v in want])


@pytest.mark.parametrize("L", [1, 2, 151])
def test_miller_sextet_and_lane_match_plain(lib, pairs151, L):
    """B4 on a sextet a pair, a half-warp a pair and one pair a thread, on
    1, 2 and 151 pairs, equal miller_plain lane for lane (its projective
    scalings, exactly)."""
    pk, qk, want = pairs151
    p, q = pk[:, :L].contiguous(), qk[:, :L].contiguous()
    out, out16, solo = _empty(12, L), _empty(12, L), _empty(12, L)
    lib.miller(p.data_ptr(), q.data_ptr(), L, out.data_ptr(), out16.data_ptr(), solo.data_ptr())
    assert BL.values(out) == BL.values(out16) == BL.values(solo) == [v[:L] for v in want]


@pytest.mark.parametrize("steps", [1, 2, 3])
def test_miller_first_steps_match_plain_loop(lib, monkeypatch, steps):
    """The loop's first steps from f = 1 (the first sets f = l, with no
    square and no product; |x|'s second bit adds Q at once), on a sextet,
    a half-warp and alone, against the plain loop cut to the same bits."""
    pk, qk = _pairs(2, 88)
    out, out16, solo = _empty(12, 2), _empty(12, 2), _empty(12, 2)
    lib.miller_head(pk.data_ptr(), qk.data_ptr(), 2, steps, out.data_ptr(), out16.data_ptr(),
                    solo.data_ptr())
    monkeypatch.setattr(pairing, "X_BITS", pairing.X_BITS[:1 + steps])
    want = BL.values(BL.miller_plain(pk, qk))
    assert BL.values(out) == BL.values(out16) == BL.values(solo) == want


def _g1_mul(k, a):
    return o._ec_affine(o._FpOps, o._ec_mul(o._FpOps, k, o._ec_from_affine(a)))


def _g1_torsion_lanes():
    """Compressed G1 encodings: (0, 2) of order 3, points of order 11 and
    10177 ([h1 r / l^2]R of random points R), [r]R, each plus a G1 point,
    then two G1 points (the last lanes)."""
    h1 = 0x396c8c005555e1568c00aaab0000aaab
    rng = random.Random(95)

    def curve_point():
        while True:
            x = rng.randrange(P)
            t = (x ** 3 + 4) % P
            y = pow(t, (P + 1) // 4, P)
            if y * y % P == t:
                return x, y

    tors = [(0, 2)]
    for ell in (11, 10177):
        t = None
        while t is None:
            t = _g1_mul(h1 * o.BLS_R // (ell * ell), curve_point())
        tors.append(t)
    tors.append(_g1_mul(o.BLS_R, curve_point()))
    g = [_g1_mul(5, o.BLS_G1), o.BLS_G1]
    F = o._FpOps
    affs = tors + [o._ec_affine(F, o._ec_add(F, o._ec_from_affine(t),
                                             o._ec_from_affine(g[0]))) for t in tors] + g
    encs = [o.bls_g1_compress(a) for a in affs]
    x = torch.from_numpy(fp.ints_to_limbs(
        [int.from_bytes(bytes([e[0] & 0x1F]) + e[1:], "big") for e in encs]))
    sign = torch.tensor([(e[0] >> 5) & 1 for e in encs], dtype=torch.int32)
    return affs, x, sign


def test_decompress_g1_trio_and_lane_match_plain(lib):
    """B1 G1 on a trio a lane (the sigma test's Jacobian steps in rounds of
    three Fp products) and one lane a thread, with and without the check,
    on points with components of order 3, 11 and 10177, [r]R, those plus a
    G1 point and G1 points, against decompress_plain(1, ...) ([r]P == O)."""
    affs, x, sign = _g1_torsion_lanes()
    n = len(affs)
    for check in (True, False):
        out, out1 = _empty(2, n), _empty(2, n)
        ok, ok1 = torch.empty(n, dtype=torch.int32), torch.empty(n, dtype=torch.int32)
        lib.decompress_g1_trio(x.data_ptr(), sign.data_ptr(), int(check), n, out.data_ptr(),
                               ok.data_ptr(), out1.data_ptr(), ok1.data_ptr())
        want_ok, want = BL.decompress_plain(1, x, sign, check)
        assert ok.tolist() == ok1.tolist() == want_ok.tolist()
        assert want_ok.tolist() == ([0] * (n - 2) + [1, 1] if check else [1] * n)
        assert BL.values(out) == BL.values(out1) == BL.values(want)


def test_g1_jacobian_steps_on_a_trio(lib):
    """The trio's G1 doubling and mixed addition: P + Q, P + P (doubles), P +
    (-P) (the identity), O + Q, and 2P of a point, of the identity and of a
    point of order 3, against the oracle."""
    a, b = _g1_mul(5, o.BLS_G1), _g1_mul(7, o.BLS_G1)
    t = (0, 2)
    ps = [a, a, a, None, t, t]
    qs = [b, a, (a[0], P - a[1]), b, t, (0, P - 2)]
    pts = [p if p is not None else (0, 0) for p in ps]
    pp = BL.planes_of_ints([[v[0] for v in pts], [v[1] for v in pts]])
    qp = BL.planes_of_ints([[v[0] for v in qs], [v[1] for v in qs]])
    pid = _i32([p is None for p in ps])
    n = len(ps)
    s, d = _empty(2, n), _empty(2, n)
    sid, did = torch.empty(n, dtype=torch.int32), torch.empty(n, dtype=torch.int32)
    lib.jac1_trio_ops(pp.data_ptr(), pid.data_ptr(), qp.data_ptr(), n, s.data_ptr(),
                      sid.data_ptr(), d.data_ptr(), did.data_ptr())
    F = o._FpOps
    for out, ident, want in (
            (s, sid, [o._ec_affine(F, o._ec_add(F, o._ec_from_affine(p), o._ec_from_affine(q)))
                      for p, q in zip(ps, qs)]),
            (d, did, [o._ec_affine(F, o._ec_dbl(F, o._ec_from_affine(p))) for p in ps])):
        v = BL.values(out)
        assert [None if ident[j] else (v[0][j], v[1][j]) for j in range(n)] == want
