"""The microbench's value probes on the host CPU: what a thread (or a quad
of threads) of K3's value bodies runs for one lane, held against the port's
plain probe bodies and the JAX package's probe kernel.

csrc/probe32.cuh holds the lanes of csrc/microbench.cu loop_kernel's value
bodies: the field operations of csrc/fe32.cuh on one thread (mul, sq, add,
sub), and quad25519.cuh's quad doubling on four threads (double,
double_no_t, 5 doublings only), state in as radix-2^13 limbs, canonical
limbs out. Built here with the host C++ compiler (__host__, __device__ and
__forceinline__ defined away) into a ctypes library; a quad is four host
threads that exchange values through a barrier where the card shuffles.

The two sides run different representations, so they are compared by
canonical value, exactly: the kernel's limbs must be the canonical limbs of
the plain version's value mod p, lane by lane and coordinate by coordinate.
The JAX probe kernel runs as tests/test_torch_microbench.py runs it (Pallas
in interpret mode). A value body is defined on the states whose plain run
does not wrap int32 (microbench.VALUE_LIMB_MAX); at the edge of that domain
all three sides take the same raw state. On limbs at int32's extremes the
plain int32 versions wrap, so there they take the state's value mod p as
canonical limbs (microbench.state_mod_p), which they carry without
wrapping, while the host lanes take the raw state. Skips only where no C++
compiler is found.
"""

from __future__ import annotations

import ctypes
import functools
import pathlib
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from cometbft_tpu.ops import curve as JC
from cometbft_tpu.ops import field as JF
from cometbft_tpu.ops import microbench as JMB
from cometbft_tpu_torch.ops import _build
from cometbft_tpu_torch.ops import field as F
from cometbft_tpu_torch.ops import limbs as L
from cometbft_tpu_torch.ops import microbench as MB

P = F.P
CSRC = pathlib.Path(_build.CSRC_DIR)

_WRAPPER = r"""
#include <pthread.h>
#include <thread>
#include "probe32.cuh"
using namespace f32;

// A quad of four host threads: from() publishes this thread's value, waits
// for the other three, and reads thread j's.
struct exchange {
  pthread_barrier_t bar;
  fe slot[4];
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
};

extern "C" {
// value_lane<op> for every lane of a (n_state, 20, B) state
void value_batch(int op, const int* in, int* out, int iters, int B) {
  for (int b = 0; b < B; b++) {
    switch (op) {
      case OP_MUL: value_lane<OP_MUL>(in, out, iters, b, B); break;
      case OP_SQ: value_lane<OP_SQ>(in, out, iters, b, B); break;
      case OP_ADD: value_lane<OP_ADD>(in, out, iters, b, B); break;
      default: value_lane<OP_SUB>(in, out, iters, b, B); break;
    }
  }
}
// quad_lane for every lane of a (4, 20, B) state, one quad of host threads
// walking the lanes; body 0 double, 1 double_no_t, 2 five doublings. Lanes
// at or past `live` run, but do not store, as the kernel's quads past the
// batch's end.
void quad_batch(int body, const int* in, int* out, int iters, int B, int live) {
  exchange ex;
  pthread_barrier_init(&ex.bar, nullptr, 4);
  std::thread th[4];
  for (int q = 0; q < 4; q++)
    th[q] = std::thread([&, q] {
      const host_quad Q{q, &ex};
      for (int b = 0; b < B; b++) {
        if (body == 0) quad_lane<1, false>(Q, in, out, iters, b, B, b < live);
        else if (body == 1) quad_lane<1, true>(Q, in, out, iters, b, B, b < live);
        else quad_lane<5, false>(Q, in, out, iters, b, B, b < live);
      }
    });
  for (auto& t : th) t.join();
  pthread_barrier_destroy(&ex.bar);
}
}
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++") or shutil.which("clang++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler (g++, c++ or clang++)")
    d = tmp_path_factory.mktemp("probe32")
    src = d / "probe32_host.cpp"
    src.write_text(_WRAPPER)
    so = d / "libprobe32_host.so"
    subprocess.run([cxx, "-std=c++17", "-O2", "-shared", "-fPIC", "-pthread", "-D__host__=",
                    "-D__device__=", "-D__forceinline__=inline", f"-I{CSRC}", str(src), "-o",
                    str(so)], check=True, capture_output=True, text=True)
    h = ctypes.CDLL(str(so))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    h.value_batch.argtypes = [ci, vp, vp, ci, ci]
    h.quad_batch.argtypes = [ci, vp, vp, ci, ci, ci]
    return h


# The value bodies, by the names the probes print, and how the host runs
# each: ("value", fe32 op) or ("quad", body of quad_batch).
_OPS = {MB.MUL: ("value", 0), MB.SQ: ("value", 1), MB.ADD: ("value", 2),
        MB.SUB: ("value", 3), MB.DOUBLE: ("quad", 0), MB.DOUBLE_NO_T: ("quad", 1),
        MB.DBL5: ("quad", 2)}
VALUE_NAMES = [n for n, b in MB.BODIES.items() if b.body_id in MB.VALUE_BODIES]

# The JAX module's probe lambdas for these names (as in test_torch_microbench).
JAX_BODIES = {
    "mul": lambda s: (JF.mul(s[0], s[1]), s[0]),
    "sq": lambda s: (JF.sq(s[0]),),
    "add(3-round carry)": lambda s: (JF.add(s[0], s[1]), s[0]),
    "sub(3-round carry)": lambda s: (JF.sub(s[0], s[1]), s[0]),
    "add 1-round": lambda s: (JMB._add_1round(s[0], s[1]), s[0]),
    "current field.mul": lambda s: (JF.mul(s[0], s[1]), s[0]),
    "current field.sub": lambda s: (JF.sub(s[0], s[1]), s[0]),
    "double_no_t": lambda s: tuple(JC.double_no_t(JC.Point(*s)))[:4],
    "double": lambda s: tuple(JC.double(JC.Point(*s))),
    "5 doublings only": lambda s: tuple(JC.double(functools.reduce(
        lambda p, _: JC.double_no_t(p), range(4), JC.Point(*s)))),
}


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def host_loop(lib, name: str, state: np.ndarray, iters: int, live: int | None = None
              ) -> np.ndarray:
    """K3's value body `name` on the host: (n_state, 20, B) int32 in, the
    kernel's limbs out (lanes at or past `live` left at -7)."""
    kind, op = _OPS[MB.BODIES[name].body_id]
    state = np.ascontiguousarray(state, dtype=np.int32)
    out = np.full_like(state, -7)
    b = state.shape[2]
    if kind == "value":
        lib.value_batch(op, _ptr(state), _ptr(out), iters, b)
    else:
        lib.quad_batch(op, _ptr(state), _ptr(out), iters, b, b if live is None else live)
    return out


def _values(state: np.ndarray) -> list[list[int]]:
    """(n, 20, B) limbs -> each coordinate's lane values mod p."""
    return [[L.limbs_to_int(c[:, j]) % P for j in range(c.shape[1])] for c in state]


def _assert_canonical_of(got: np.ndarray, want: np.ndarray) -> None:
    """got holds exactly the canonical limbs of want's values."""
    vals = _values(np.asarray(want))
    canon = np.stack([np.stack([L.int_to_limbs(v) for v in c], axis=1) for c in vals])
    np.testing.assert_array_equal(got, canon)


@pytest.fixture
def interpret(monkeypatch):
    """JAX's Pallas kernels in interpret mode, as its own CPU tests run them."""
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


def _jax_loop(name: str, state: np.ndarray, iters: int) -> np.ndarray:
    n = MB.BODIES[name].n_state
    out = JMB._loop_kernel_factory(JAX_BODIES[name], n, iters)(
        *(jnp.asarray(x) for x in state))
    return np.stack([np.asarray(x) for x in out])


def _extreme_state(n: int, seed: int) -> np.ndarray:
    """(n, 20, 128) int32 limbs at int32's extremes: every limb INT_MAX or
    INT_MIN, the two alternating, one extreme limb among small ones, and
    random int32 limbs."""
    hi, lo = 2**31 - 1, -(2**31)
    rng = np.random.default_rng(seed)
    s = rng.integers(lo, hi + 1, size=(n, 20, 128), dtype=np.int64)
    s[:, :, 0] = hi
    s[:, :, 1] = lo
    s[:, ::2, 2] = hi
    s[:, 1::2, 2] = lo
    s[:, :, 3] = 5
    s[:, 19, 3] = hi
    s[:, :, 4] = -1
    s[:, 0, 4] = lo
    return s.astype(np.int32)


# ------------------------------------------------------------------ tests


def test_value_bodies_are_the_kernels():
    """The names held here are the registry's value bodies, and every
    value body id has a host runner."""
    assert set(VALUE_NAMES) == set(JAX_BODIES)
    assert {MB.BODIES[n].body_id for n in VALUE_NAMES} == set(_OPS) == set(MB.VALUE_BODIES)


@pytest.mark.parametrize("name", VALUE_NAMES)
def test_value_body_against_plain_and_jax(lib, interpret, name):
    """The probes' seeded state at 128 lanes, 1, 7 and 50 iterations: the
    host lanes' limbs are the canonical limbs of the plain body's values and
    of the JAX probe kernel's."""
    state = MB.probe_state(MB.BODIES[name].n_state, 128)
    for iters in (1, 7, 50):
        got = host_loop(lib, name, state, iters)
        plain = MB.loop_plain(name, torch.from_numpy(state), iters).numpy()
        _assert_canonical_of(got, plain)
        _assert_canonical_of(got, _jax_loop(name, state, iters))
        assert MB.loop_err(name, torch.from_numpy(got), torch.from_numpy(plain)) == 0


@pytest.mark.parametrize("name", VALUE_NAMES)
def test_value_body_at_int32_extremes(lib, interpret, name):
    """Limbs at int32's extremes, which from_limbs13 takes mod p: at 0
    iterations the host lanes store the input's value; at 1 and 7 they
    equal the plain body and the JAX probe kernel run on that value's
    canonical limbs."""
    state = _extreme_state(MB.BODIES[name].n_state, 90 + MB.BODIES[name].body_id)
    reduced = MB.state_mod_p(state)
    _assert_canonical_of(host_loop(lib, name, state, 0), state)
    np.testing.assert_array_equal(host_loop(lib, name, state, 0), reduced)
    for iters in (1, 7):
        got = host_loop(lib, name, state, iters)
        _assert_canonical_of(got, MB.loop_plain(name, torch.from_numpy(reduced), iters).numpy())
        _assert_canonical_of(got, _jax_loop(name, reduced, iters))


@pytest.mark.parametrize("name", VALUE_NAMES)
def test_value_body_at_the_domain_edge(lib, interpret, name):
    """Every limb within +-VALUE_LIMB_MAX, the worst lanes at the bound: the
    host lanes, the plain body and the JAX probe kernel take the same raw
    state and agree by canonical value at 0, 1 and 7 iterations."""
    state = MB.value_edge_state(name, 128, seed=MB.BODIES[name].body_id)
    for iters in (0, 1, 7):
        got = host_loop(lib, name, state, iters)
        _assert_canonical_of(got, MB.loop_plain(name, torch.from_numpy(state), iters).numpy())
        _assert_canonical_of(got, _jax_loop(name, state, iters))


@pytest.mark.parametrize("name", VALUE_NAMES)
def test_value_domain_is_where_plain_does_not_wrap(monkeypatch, name):
    """VALUE_LIMB_MAX is the largest bound at which the plain int32 run
    agrees with the same run in int64, where nothing wraps: at the bound
    the two give the same values mod p at 1, 7 and 50 iterations; one
    above it they do not."""
    body_id = MB.BODIES[name].body_id

    def agree() -> bool:
        state = MB.value_edge_state(name, 64)
        return all(np.array_equal(
            MB.state_mod_p(MB.loop_plain(name, torch.from_numpy(state), it).numpy()),
            MB.state_mod_p(MB.loop_plain(name, torch.from_numpy(state).long(), it).numpy()))
            for it in (1, 7, 50))

    assert agree()
    monkeypatch.setitem(MB.VALUE_LIMB_MAX, body_id, MB.VALUE_LIMB_MAX[body_id] + 1)
    assert not agree()


def test_state_mod_p_against_python_ints():
    state = _extreme_state(2, 7)
    got = MB.state_mod_p(state)
    for c in range(2):
        for j in range(state.shape[2]):
            value = sum(int(v) << (13 * i) for i, v in enumerate(state[c, :, j])) % P
            assert got[c, :, j].tolist() == L.int_to_limbs(value).tolist()


def test_double_no_t_writes_t_as_the_plain_version(lib):
    """double_no_t's T: the input's value at 0 iterations, zeros after
    (the plain body's T), where double forms it."""
    state = MB.probe_state(4, 128)
    np.testing.assert_array_equal(host_loop(lib, "double_no_t", state, 0)[3],
                                  MB.state_mod_p(state)[3])
    for iters in (1, 3):
        got = host_loop(lib, "double_no_t", state, iters)
        assert not got[3].any()
        dbl = host_loop(lib, "double", state, iters)
        np.testing.assert_array_equal(got[:3], dbl[:3])
        assert dbl[3].any()


def test_quads_past_the_batch_write_nothing(lib):
    """A quad whose lane lies past the batch's end runs (its warp must stay
    whole) but stores nothing."""
    state = MB.probe_state(4, 16)
    got = host_loop(lib, "5 doublings only", state, 2, live=11)
    assert (got[:, :, 11:] == -7).all()
    np.testing.assert_array_equal(got[:, :, :11],
                                  host_loop(lib, "5 doublings only", state, 2)[:, :, :11])


def test_loop_err_reads_value_bodies_by_canonical_value():
    """loop_err: a value body's kernel limbs must be the canonical limbs of
    the plain version's values; a limb body's, the plain limbs themselves."""
    state = torch.from_numpy(MB.probe_state(2, 8))
    plain = MB.loop_plain("mul", state, 3)
    canon = torch.stack([F.canonicalize(c) for c in plain.unbind(0)])
    assert not torch.equal(canon, plain)  # carried, not canonical
    assert MB.loop_err("mul", canon, plain) == 0
    assert MB.loop_err("mul", plain, plain) > 0
    off = canon.clone()
    off[0, 0, 5] += 1
    assert MB.loop_err("mul", off, plain) == 1
    assert MB.loop_err("reduce_v2 mul", plain, plain) == 0
    assert MB.loop_err("reduce_v2 mul", canon, plain) > 0


def test_probe_header_is_host_code():
    """probe32.cuh builds without the CUDA runtime: it includes only the
    verify kernels' headers."""
    names = [p.name for p in _build._sources(CSRC / "probe32.cuh")]
    assert names == ["probe32.cuh", "quad25519.cuh", "fe32.cuh"]
    for name in names:
        assert "cuda_runtime" not in (CSRC / name).read_text()
