"""The verify kernels' arithmetic on the host CPU: the field, point,
decoding and conversion functions of csrc/fe32.cuh (8 x 32-bit limbs), and
the kernels' whole per-signature body (csrc/quad25519.cuh verify_quad) with
its quad of four threads run as four host threads that exchange values
through a barrier where the card shuffles. Built with the host C++ compiler
(__host__, __device__ and __forceinline__ defined away) into a shared
library loaded with ctypes.

Held against Python-int arithmetic mod p, against the port's plain
field.py / curve.py / unpack.py (radix-2^13 limbs), and, for whole
signatures, against the plain verify functions and the oracles. Skips only
where no C++ compiler is found.
"""

from __future__ import annotations

import ctypes
import pathlib
import shutil
import subprocess

import numpy as np
import pytest
import torch

from cometbft_tpu_torch.crypto import ed25519_math as oracle
from cometbft_tpu_torch.crypto import sr25519_math as srm
from cometbft_tpu_torch.ops import curve as C
from cometbft_tpu_torch.ops import ed25519_kernel as TK
from cometbft_tpu_torch.ops import field as F
from cometbft_tpu_torch.ops import limbs as L
from cometbft_tpu_torch.ops import microbench as MB
from cometbft_tpu_torch.ops import sr25519_kernel as TS
from cometbft_tpu_torch.ops import unpack as U
from cometbft_tpu_torch.ops import verify_kernel as VK

P = F.P
CSRC = pathlib.Path(VK.__file__).resolve().parent.parent / "csrc"

_WRAPPER = r"""
#include <pthread.h>
#include <thread>
#include "quad25519.cuh"
using namespace f32;

// A quad of four host threads: from() publishes this thread's value, waits
// for the other three, and reads thread j's.
struct exchange {
  pthread_barrier_t bar;
  fe slot[4];
  int islot[4];
};
struct host_quad {
  int q;
  exchange* ex;
  void from(fe& o, const fe& a, int j) const {
    ex->slot[q] = a;
    pthread_barrier_wait(&ex->bar);
    fe v = ex->slot[j];
    pthread_barrier_wait(&ex->bar);
    o = v;
  }
  int from_int(int v, int j) const {
    ex->islot[q] = v;
    pthread_barrier_wait(&ex->bar);
    int r = ex->islot[j];
    pthread_barrier_wait(&ex->bar);
    return r;
  }
  void sync() const { pthread_barrier_wait(&ex->bar); }
};

static void ld(fe& o, const uint32_t* w) { from_words256(o, w); }
static void st(uint32_t* w, const fe& a) { to_words(w, a); }
static void ldp(pt& o, const uint32_t* w) { ld(o.x, w); ld(o.y, w + 8); ld(o.z, w + 16); ld(o.t, w + 24); }
static void stp(uint32_t* w, const pt& p) { st(w, p.x); st(w + 8, p.y); st(w + 16, p.z); st(w + 24, p.t); }

// Runs f(Q) on a quad of four host threads.
template <class F>
static void on_quad(F f) {
  exchange ex;
  pthread_barrier_init(&ex.bar, nullptr, 4);
  std::thread th[4];
  for (int q = 0; q < 4; q++) th[q] = std::thread([&, q] { f(host_quad{q, &ex}); });
  for (auto& t : th) t.join();
  pthread_barrier_destroy(&ex.bar);
}

extern "C" {
// op: 0 mul, 1 sq, 2 add, 3 sub, 4 neg, 5 canonicalize, 6 pow22523
void fe_op(int op, const uint32_t* a, const uint32_t* b, uint32_t* o, int n) {
  for (int k = 0; k < n; k++) {
    fe x, y, r;
    ld(x, a + 8 * k);
    ld(y, b + 8 * k);
    switch (op) {
      case 0: mul(r, x, y); break;
      case 1: sq(r, x); break;
      case 2: add(r, x, y); break;
      case 3: sub(r, x, y); break;
      case 4: neg(r, x); break;
      case 5: canonicalize(r, x); break;
      default: pow22523(r, x); break;
    }
    st(o + 8 * k, r);
  }
}
void fe_pred(const uint32_t* a, int* is_z, int* par, int n) {
  for (int k = 0; k < n; k++) {
    fe x;
    ld(x, a + 8 * k);
    is_z[k] = is_zero(x) ? 1 : 0;
    par[k] = parity(x);
  }
}
void fe_consts(uint32_t* o) {
  fe c;
  const_d(c); st(o, c);
  const_d2(c); st(o + 8, c);
  const_sqrt_m1(c); st(o + 16, c);
}
void fe_from_limbs(const int32_t* l, uint32_t* o, int n) {
  for (int k = 0; k < n; k++) {
    fe r;
    from_limbs13(r, l + 20 * k);
    st(o + 8 * k, r);
  }
}
// which: 0 ZIP-215 decompression, 1 ristretto255 decode
void pt_decode(int which, const uint32_t* w, uint32_t* o, int* ok, int n) {
  for (int k = 0; k < n; k++) {
    fe y;
    int sign;
    from_words255(y, sign, w + 8 * k);
    pt p;
    ok[k] = (which ? ristretto_decode(p, y, sign) : decompress(p, y, sign)) ? 1 : 0;
    stp(o + 32 * k, p);
  }
}
// The quad's point operations on n points: op 0 qdbl, 1 qadd with q's
// cached components (q.z = 1 makes it the mixed add of an affine entry)
void pt_op(int op, const uint32_t* a, const uint32_t* b, uint32_t* o, int n) {
  for (int k = 0; k < n; k++) {
    pt p, q;
    ldp(p, a + 32 * k);
    ldp(q, b + 32 * k);
    cached qc;
    to_cached(qc, q);
    const fe pc[4] = {p.x, p.y, p.z, p.t};
    const fe qq[4] = {qc.ymx, qc.ypx, qc.z2, qc.t2d};
    fe out[4];
    on_quad([&](const host_quad& Q) {
      fe c = pc[Q.q];
      if (op == 0) {
        qdbl(c, Q);
      } else {
        qadd(c, Q, qq[Q.q]);
      }
      out[Q.q] = c;
    });
    for (int i = 0; i < 4; i++) st(o + 32 * k + 8 * i, out[i]);
  }
}
void digits(const int* words, int8_t* out, int B) {
  for (int b = 0; b < B; b++) store_digits(out + b, B, words, b, B);
}
// verify_quad over a batch, one quad of host threads per signature: inputs
// as the kernel takes them
int verify_batch(int scheme, int bench, const int* ax, const int* ay, const int* az,
                 const int* at, const int* rw, const int* sw, const int* kw,
                 const int* base_table, int B, int n_windows, int nodecomp, int* mask) {
  uint32_t tb[BASE_WORDS];
  load_base_table(tb, base_table, 0, 1);
  int all = 1;
  for (int b = 0; b < B; b++) {
    uint32_t table[table_words(1)];
    int8_t dig[2 * NDIG];
    bool ok[4];
    on_quad([&](const host_quad& Q) {
      const quad_table tab{table, 4};
      if (bench)
        ok[Q.q] = verify_quad<ED25519, true>(Q, ax, ay, az, at, rw, sw, kw, tb, tab, dig,
                                             dig + NDIG, 1, b, B, n_windows, nodecomp);
      else if (scheme == 1)
        ok[Q.q] = verify_quad<SR25519, false>(Q, ax, ay, az, at, rw, sw, kw, tb, tab, dig,
                                              dig + NDIG, 1, b, B, 0, 0);
      else
        ok[Q.q] = verify_quad<ED25519, false>(Q, ax, ay, az, at, rw, sw, kw, tb, tab, dig,
                                              dig + NDIG, 1, b, B, 0, 0);
    });
    if (ok[0] != ok[1] || ok[0] != ok[2] || ok[0] != ok[3]) return -1;
    mask[b] = ok[0] ? 1 : 0;
    all &= mask[b];
  }
  return all;
}
}
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++") or shutil.which("clang++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler (g++, c++ or clang++)")
    d = tmp_path_factory.mktemp("fe32")
    src = d / "fe32_host.cpp"
    src.write_text(_WRAPPER)
    so = d / "libfe32_host.so"
    subprocess.run([cxx, "-std=c++17", "-O2", "-shared", "-fPIC", "-pthread", "-D__host__=",
                    "-D__device__=", "-D__forceinline__=inline", f"-I{CSRC}", str(src), "-o",
                    str(so)], check=True, capture_output=True, text=True)
    h = ctypes.CDLL(str(so))
    vp = ctypes.c_void_p
    h.fe_op.argtypes = [ctypes.c_int, vp, vp, vp, ctypes.c_int]
    h.fe_pred.argtypes = [vp, vp, vp, ctypes.c_int]
    h.fe_consts.argtypes = [vp]
    h.fe_from_limbs.argtypes = [vp, vp, ctypes.c_int]
    h.pt_decode.argtypes = [ctypes.c_int, vp, vp, vp, ctypes.c_int]
    h.pt_op.argtypes = [ctypes.c_int, vp, vp, vp, ctypes.c_int]
    h.verify_batch.argtypes = [ctypes.c_int] * 2 + [vp] * 8 + [ctypes.c_int] * 3 + [vp]
    h.verify_batch.restype = ctypes.c_int
    h.digits.argtypes = [vp, vp, ctypes.c_int]
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


def _fe_op(lib, op: int, a: list[int], b: list[int] | None = None) -> list[int]:
    aw = _words(a)
    bw = _words(b if b is not None else a)
    out = np.zeros_like(aw)
    lib.fe_op(op, _ptr(aw), _ptr(bw), _ptr(out), len(a))
    return _ints(out)


SPECIAL = [0, 1, 2, 19, P - 1, P, P + 1, 2 * P - 1, 2 * P, 2 * P + 1, 2**255 - 1, 2**255,
           2**256 - 38, 2**256 - 2, 2**256 - 1, 2**32 - 1, 2**224]


def _values(n: int, seed: int) -> list[int]:
    rng = np.random.default_rng(seed)
    rand = [int.from_bytes(rng.bytes(32), "little") for _ in range(n)]
    return SPECIAL + rand


def _limbs_to_ints(t: torch.Tensor) -> list[int]:
    """(20, B) plain limbs -> each lane's value mod p."""
    a = t.numpy()
    return [L.limbs_to_int(a[:, j]) % P for j in range(a.shape[1])]


def _fe_limbs(vals: list[int]) -> torch.Tensor:
    """values mod p -> (20, B) canonical plain limbs."""
    return torch.from_numpy(np.stack([L.int_to_limbs(v % P) for v in vals], axis=1))


# ------------------------------------------------------------------- field


def test_constants_match_the_port(lib):
    out = np.zeros(24, dtype=np.uint32)
    lib.fe_consts(_ptr(out))
    assert _ints(out) == [F.D_INT, 2 * F.D_INT % P, F.SQRT_M1_INT]


@pytest.mark.parametrize("op,name", [(0, "mul"), (2, "add"), (3, "sub")])
def test_binary_ops_against_python_ints(lib, op, name):
    vals = _values(40, op)
    a = [x for x in vals for _ in vals]
    b = [y for _ in vals for y in vals]
    got = _fe_op(lib, op, a, b)
    want = {0: lambda x, y: x * y, 2: lambda x, y: x + y, 3: lambda x, y: x - y}[op]
    for x, y, g in zip(a, b, got):
        assert g < 2**256 and g % P == want(x, y) % P, (name, x, y)


@pytest.mark.parametrize("op,name", [(1, "sq"), (4, "neg"), (5, "canonicalize"),
                                     (6, "pow22523")])
def test_unary_ops_against_python_ints(lib, op, name):
    vals = _values(200, 10 + op)
    got = _fe_op(lib, op, vals)
    for x, g in zip(vals, got):
        if op == 1:
            assert g % P == x * x % P
        elif op == 4:
            assert g % P == -x % P
        elif op == 5:
            assert g == x % P  # canonical: exactly the representative
        else:
            assert g % P == pow(x, 2**252 - 3, P)
        assert g < 2**256


def test_chained_products_stay_loose_and_right(lib):
    """Outputs feed inputs: 300 squarings and products of earlier outputs."""
    rng = np.random.default_rng(3)
    x = [int.from_bytes(rng.bytes(32), "little") for _ in range(16)] + [2**256 - 1, 2 * P]
    want = [v % P for v in x]
    for step in range(300):
        if step % 3 == 0:
            x = _fe_op(lib, 0, x, x[::-1])
            want = [a * b % P for a, b in zip(want, want[::-1])]
        elif step % 3 == 1:
            x = _fe_op(lib, 3, x, _fe_op(lib, 2, x, x[1:] + x[:1]))
            want = [(a - (a + b)) % P for a, b in zip(want, want[1:] + want[:1])]
        else:
            x = _fe_op(lib, 1, x)
            want = [a * a % P for a in want]
        assert [v % P for v in x] == want


def test_is_zero_and_parity_on_every_representative_of_zero(lib):
    vals = _values(200, 21) + [0, P, 2 * P, 3 * P - 2**256 + 2**256]
    vals = [v for v in vals if v < 2**256]
    w = _words(vals)
    z = np.zeros(len(vals), dtype=np.int32)
    par = np.zeros(len(vals), dtype=np.int32)
    lib.fe_pred(_ptr(w), _ptr(z), _ptr(par), len(vals))
    assert z.tolist() == [int(v % P == 0) for v in vals]
    assert par.tolist() == [(v % P) & 1 for v in vals]
    # the plain version agrees on the same values
    t = _fe_limbs(vals)
    assert F.is_zero(t).to(torch.int32).tolist() == z.tolist()
    assert F.parity(t).tolist() == par.tolist()


def test_canonicalize_agrees_with_the_plain_version(lib):
    vals = _values(100, 5)
    got = _fe_op(lib, 5, vals)
    plain = F.canonicalize(_fe_limbs(vals))
    assert got == [L.limbs_to_int(plain[:, j].numpy()) for j in range(len(vals))]


# ------------------------------------------------------------- conversion

# what sub() leaves for Y - Z of an identity point: the limbs of the
# reference's canonicalize fault (ROADMAP Queue 3 item 1), value 0 mod p
_QUEUE3_LIMBS = [7603] + [8191] * 12 + [-1, 8192] + [8191] * 4 + [7935]


def _limb_cases() -> np.ndarray:
    rng = np.random.default_rng(13)
    cases = [
        _QUEUE3_LIMBS,
        [-1] * 20,
        [8192] * 20,
        [-1, 8192] * 10,
        [8191] * 20,
        [0] * 20,
        [8191] * 19 + [255],
        list(L.int_to_limbs(P)),
        [0] * 19 + [-1],
        [0] * 19 + [2**31 - 1],
        [-(2**31)] + [0] * 19,
        [2**31 - 1] * 20,
        [-(2**31)] * 20,
    ]
    cases += rng.integers(-1, 8193, size=(60, 20)).tolist()
    cases += rng.integers(0, 8000, size=(40, 20)).tolist()
    cases += rng.integers(-(2**20), 2**20, size=(40, 20)).tolist()
    cases += rng.integers(-(2**31), 2**31, size=(40, 20)).tolist()
    return np.array(cases, dtype=np.int32)


def test_limbs13_conversion_against_python_ints_and_the_plain_field(lib):
    limbs = _limb_cases()
    out = np.zeros((len(limbs), 8), dtype=np.uint32)
    lib.fe_from_limbs(_ptr(np.ascontiguousarray(limbs)), _ptr(out), len(limbs))
    got = _ints(out)
    for row, g in zip(limbs, got):
        value = sum(int(v) << (13 * i) for i, v in enumerate(row))
        assert g < 2**256 and g % P == value % P, row.tolist()
    # the carried rows (decoder and key-cache limbs) against the plain field
    carried = np.array([r for r in limbs if np.abs(r).max() <= 8192]).T
    plain = F.canonicalize(torch.from_numpy(np.ascontiguousarray(carried)))
    canon = [g % P for r, g in zip(limbs, got) if np.abs(r).max() <= 8192]
    assert _limbs_to_ints(plain) == canon
    assert got[0] % P == 0  # the Queue 3 item 1 limbs are zero


def test_digit_recoding_against_the_plain_unpack(lib):
    rng = np.random.default_rng(17)
    vals = [0, 2**256 - 1, 2**255, 2**255 - 1, F.P, oracle.L - 1, 16, 15, 31 * 32**50] + [
        int.from_bytes(rng.bytes(32), "little") for _ in range(60)]
    words = np.ascontiguousarray(_words(vals).T.view(np.int32))
    out = np.zeros((51, len(vals)), dtype=np.int8)
    lib.digits(_ptr(words), _ptr(out), len(vals))
    want = U.words_to_digits5_signed(torch.from_numpy(words)).numpy()
    np.testing.assert_array_equal(out.astype(np.int32), want)


# ------------------------------------------------------------------ points


def _encodings(n: int, seed: int) -> list[int]:
    rng = np.random.default_rng(seed)
    special = [0, 1, 2, P - 1, P, P + 1, P + 2, 2**255 - 1, 2**255 - 19 + 18,
               1 | 1 << 255, P | 1 << 255, (P + 1) | 1 << 255, 2**256 - 1]
    good = [int.from_bytes(oracle.point_compress(oracle.scalar_mult(k, oracle.B_POINT)),
                           "little") for k in range(1, 9)]
    good += [int.from_bytes(srm.ristretto_encode(oracle.scalar_mult(k, oracle.B_POINT)),
                            "little") for k in range(1, 9)]
    return special + good + [int.from_bytes(rng.bytes(32), "little") for _ in range(n)]


def _decode(lib, which: int, encs: list[int]):
    w = _words(encs)
    out = np.zeros((len(encs), 32), dtype=np.uint32)
    ok = np.zeros(len(encs), dtype=np.int32)
    lib.pt_decode(which, _ptr(w), _ptr(out), _ptr(ok), len(encs))
    coords = np.array(_ints(out), dtype=object).reshape(len(encs), 4)
    return ok.astype(bool), coords


@pytest.mark.parametrize("which", [0, 1], ids=["zip215", "ristretto"])
def test_decoding_against_the_plain_curve_and_the_oracle(lib, which):
    encs = _encodings(60, 30 + which)
    ok, coords = _decode(lib, which, encs)
    words = torch.from_numpy(_words(encs).T.copy().view(np.int32))
    if which == 0:
        pok, pp = VK.decompress_math(words)[0], VK.decompress_math(words)[1:]
        want = [oracle.point_decompress_zip215(e.to_bytes(32, "little")) is not None
                for e in encs]
    else:
        pok, *pp = VK.decompress_sr_math(words)
        want = [srm.ristretto_decode(e.to_bytes(32, "little")) is not None for e in encs]
    assert ok.tolist() == pok.tolist() == want
    for ci in range(4):  # garbage lanes too: the same operations mod p
        assert [c % P for c in coords[:, ci]] == _limbs_to_ints(pp[ci])


def _rand_points(n: int, seed: int) -> np.ndarray:
    """n arbitrary (off-curve) points as (n, 32) words, and special ones."""
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(32), "little") for _ in range(4 * n)]
    vals[:8] = [0, 1, 1, 0, P, 2 * P, 2**256 - 1, 0]
    return _words(vals).reshape(n, 32)


@pytest.mark.parametrize("op", [0, 1, 2], ids=["qdbl", "qadd", "qadd_affine"])
def test_quad_point_ops_against_the_plain_curve(lib, op):
    """The quad's doubling and addition, its four threads run as host
    threads, on arbitrary (off-curve) points against curve.double, add
    and madd_pre: every coordinate equal mod p."""
    n = 24
    a, b = _rand_points(n, 40 + op), _rand_points(n, 50 + op)
    if op == 2:  # an affine addend: Z = 1, its cached 2Z is the table's 2
        b[:, 16:24] = _words([1] * n)
    out = np.zeros_like(a)
    lib.pt_op(min(op, 1), _ptr(a), _ptr(b), _ptr(out), n)
    got = np.array(_ints(out), dtype=object).reshape(n, 4)

    def plain(words):
        vals = np.array(_ints(words), dtype=object).reshape(n, 4)
        return C.Point(*(_fe_limbs(list(vals[:, ci])) for ci in range(4)))

    p, q = plain(a), plain(b)
    if op == 0:
        want = C.double(p)
    elif op == 1:
        want = C.add(p, q)
    else:
        q_pre = C.Point(q.x, q.y, q.z, F.mul(q.t, F.const("D2", q.t.device).expand_as(q.t)))
        want = C.madd_pre(p, q_pre)
    for ci in range(4):
        assert [c % P for c in got[:, ci]] == _limbs_to_ints(want[ci])


# ------------------------------------------------------------ whole lanes


def _host_verify(lib, scheme: int, t, bench: tuple[int, int] | None = None):
    arrs = [np.ascontiguousarray(x.numpy()) for x in t]
    table = np.ascontiguousarray(VK.base_table_words())
    b = arrs[0].shape[1]
    mask = np.zeros(b, dtype=np.int32)
    nw, nodec = bench or (0, 0)
    allok = lib.verify_batch(scheme, int(bench is not None), *(_ptr(x) for x in arrs),
                             _ptr(table), b, nw, nodec, _ptr(mask))
    assert allok in (0, 1), "the quad's four threads disagree"
    return mask.astype(bool), bool(allok)


def _edge_commit(n: int, seed: bytes):
    from cometbft_tpu_torch.crypto import ed25519 as ted

    privs = [ted.gen_priv_key_from_secret(seed + b"%d" % i) for i in range(n)]
    pubs = [p.pub_key().bytes_() for p in privs]
    msgs = [b"msg-%d" % i for i in range(n)]
    sigs = [p.sign(m) for p, m in zip(privs, msgs)]
    sigs[0] = sigs[1]
    pubs[2] = (P + 1).to_bytes(32, "little")
    sigs[2] = pubs[2] + bytes(32)
    sigs[3] = (2).to_bytes(32, "little") + sigs[3][32:]
    sigs[4] = sigs[4][:40] + bytes([sigs[4][40] ^ 1]) + sigs[4][41:]
    return pubs, msgs, sigs


def test_whole_lanes_ed25519_against_plain_and_oracle(lib):
    pubs, msgs, sigs = _edge_commit(12, b"host-")
    b = TK.bucket_size(len(sigs))
    _, safe, r, s, k = TK.stage_batch(pubs, msgs, sigs, b)
    enc = np.frombuffer(b"".join(safe), dtype=np.uint8).reshape(len(sigs), 32)
    ok_a, coords = TK.decompress_points(enc, torch.device("cpu"))
    t = TK.staged_from_numpy(*TK.pad_coords_batch_minor(coords, b), r, s, k,
                             device=torch.device("cpu"))
    mask, allok = _host_verify(lib, 0, t)
    pmask, pall = VK.verify_math_ok(*t)
    assert mask.tolist() == pmask.tolist() and allok == bool(pall)
    got = (mask[: len(sigs)] & np.asarray(ok_a)).tolist()
    assert got == [oracle.verify_zip215(p, m, s) for p, m, s in zip(pubs, msgs, sigs)]


def test_whole_lanes_sr25519_against_plain_and_oracle(lib):
    import chip_smoke as CS

    from cometbft_tpu_torch.crypto import sr25519 as tsr

    privs = [tsr.gen_priv_key_from_secret(b"host-sr-%d" % i) for i in range(7)]
    pubs = [p.pub_key().bytes_() for p in privs]
    msgs = [b"m-%d" % i for i in range(7)]
    sigs = [p.sign(m) for p, m in zip(privs, msgs)]
    sigs[0] = sigs[1]
    sigs[2] = (3).to_bytes(32, "little") + sigs[2][32:]
    pub, msg, sig = (bytes.fromhex(h) for h in CS.RIPPLE_LANE)
    pubs.append(pub)
    msgs.append(msg)
    sigs.append(sig)
    n = len(sigs)
    b = TK.bucket_size(n)
    _, safe, r, s, k = TS.stage_rows_sr(pubs, msgs, sigs, b)
    enc = np.frombuffer(b"".join(safe), dtype=np.uint8).reshape(n, 32)
    ok_a, coords = TS.decompress_points(enc, torch.device("cpu"))
    t = TK.staged_from_numpy(*TK.pad_coords_batch_minor(coords, b), r, s, k,
                             device=torch.device("cpu"))
    mask, allok = _host_verify(lib, 1, t)
    pmask, pall = VK.verify_math_sr_ok(*t)
    assert mask.tolist() == pmask.tolist() and allok == bool(pall)
    got = (mask[:n] & np.asarray(ok_a)).tolist()
    assert got == [srm.verify(p, m, s) for p, m, s in zip(pubs, msgs, sigs)]
    assert got[-1] is True  # the lane whose check lands on a multiple of p


@pytest.mark.parametrize("knobs", [(0, "full"), (3, "full"), (1, "nodecomp")])
def test_whole_lanes_bench_knobs_on_the_probe_inputs(lib, knobs):
    """The bench body on the microbench's random, off-curve inputs: every
    operation must equal the plain version's mod p for the masks to agree."""
    t = MB.bench_verify_inputs(6, torch.device("cpu"))
    nodecomp = VK._bench_nodecomp(*knobs)
    mask, allok = _host_verify(lib, 0, t, bench=(knobs[0], int(nodecomp)))
    pmask, pall = VK.verify_math_bench(*t, n_windows=knobs[0], stages=knobs[1])
    assert mask.tolist() == pmask.tolist() and allok == bool(pall)


def _staged_cpu(scheme_stage, decode, pubs, msgs, sigs):
    n = len(sigs)
    b = TK.bucket_size(n)
    _, safe, r, s, k = scheme_stage(pubs, msgs, sigs, b)
    enc = np.frombuffer(b"".join(safe), dtype=np.uint8).reshape(n, 32)
    _, coords = decode(enc, torch.device("cpu"))
    return TK.staged_from_numpy(*TK.pad_coords_batch_minor(coords, b), r, s, k,
                                device=torch.device("cpu"))


@pytest.mark.parametrize("knobs", [None, (26, "full"), (0, "nodecomp"), (51, "full")])
def test_whole_lanes_on_the_card_checks_edge_lanes(lib, knobs):
    """chip_smoke.py's ed25519 edge lanes (torsion components, y = p and
    y = p + 1 as R and A, x = 0 with the sign bit) through the kernel's lane
    body: the production verdicts and the bench knobs."""
    import chip_smoke as CS

    pubs, msgs, sigs = CS.make_commit(20, 11)
    want = CS.edge_lanes(pubs, msgs, sigs)
    t = _staged_cpu(TK.stage_batch, TK.decompress_points, pubs, msgs, sigs)
    if knobs is None:
        mask, allok = _host_verify(lib, 0, t)
        pmask, pall = VK.verify_math_ok(*t)
    else:
        nodecomp = VK._bench_nodecomp(*knobs)
        mask, allok = _host_verify(lib, 0, t, bench=(knobs[0], int(nodecomp)))
        pmask, pall = VK.verify_math_bench(*t, n_windows=knobs[0], stages=knobs[1])
    assert mask.tolist() == pmask.tolist() and allok == bool(pall)
    if knobs in (None, (51, "full")):
        assert mask[8:16].tolist() == want[8:16]


def test_whole_lanes_sr25519_edge_lanes(lib):
    import chip_smoke as CS

    pubs, msgs, sigs = CS.make_commit_sr(12, 12)
    want = CS.edge_lanes_sr(pubs, msgs, sigs)
    t = _staged_cpu(TS.stage_rows_sr, TS.decompress_points, pubs, msgs, sigs)
    mask, allok = _host_verify(lib, 1, t)
    pmask, pall = VK.verify_math_sr_ok(*t)
    assert mask.tolist() == pmask.tolist() and allok == bool(pall)
    assert mask[len(want) - 1] and want[-1]
