"""Device microbenchmarks for the verify kernel's components, on the card.

The port of cometbft_tpu/ops/microbench.py. A dev tool, not part of the
node runtime: it isolates where the verify ladder's device time goes (field
multiplication, carry rounds, table selects, point operations, one ladder
window) so that kernel work is driven by measurement. Timings are slopes:
a probe runs its body I and 2I times inside one kernel launch and reports
(t(2I) - t(I)) / I, which cancels launch and transfer overhead. Kernel
times are CUDA events.

Kernels (csrc/microbench.cu), with their plain PyTorch versions here:
  K3 ``loop``: state = body(state), ``iters`` times, for a body of the
     BODIES registry (the counterpart of _loop_kernel_factory);
  K4 ``stacked``: s = conv(s, b)[:, :20] & 0x1FFF on stacked (4, 20, B)
     coordinates, ``iters`` times (the counterpart of probe_stacked's
     kernel).
A wrapper takes the plain version for CPU tensors and launches its kernel
for CUDA tensors; ``LAUNCHES`` counts the launches.

K3's value bodies (VALUE_BODIES: the field operations and the point
doublings) compute a function mod p, and the kernel runs them on the verify
kernels' own arithmetic (8 x 32-bit limbs, the doublings on a quad of four
threads) with canonical limbs out; the plain versions run the JAX module's
radix-2^13 field. ``loop_err`` compares the two by canonical value. A
value body is defined on the states whose plain run does not wrap int32:
every limb within +-VALUE_LIMB_MAX of the body. On wider limbs the plain
version (and the JAX probe) wraps int32, while the kernel reads the state's
value mod p, so the two then differ. Every other body times the radix-2^13
representation itself and equals its plain version bit for bit on any
int32 state.

Unlike the JAX module, ``probe_loop`` takes the name of a registered body,
not a Python callable: a CUDA kernel cannot trace a lambda, so each body is
a plain torch function here and a compiled body in the kernel, under one
registry entry named as the JAX probe prints it.

Device probes need a card and raise without one; ``staging`` is host work
and runs anywhere.

Usage:  python -m cometbft_tpu_torch.ops.microbench [probe ...]
  probes: staging verify bisect field variants variants2 stacked select16
          window curve all (default: all, which leaves out bisect and
          select16, as the JAX module does)
"""

from __future__ import annotations

import ctypes
import statistics
import sys
import time
from typing import Callable, NamedTuple

import numpy as np
import torch

from cometbft_tpu_torch.ops import curve as C
from cometbft_tpu_torch.ops import field as F
from cometbft_tpu_torch.ops import unpack as U

LANES = 128
LAUNCHES = {"microbench_loop": 0, "microbench_stacked": 0}
# K3's launches by probe name (their sum is LAUNCHES["microbench_loop"])
LOOP_LAUNCHES: dict[str, int] = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    LOOP_LAUNCHES.clear()


# --------------------------------------------------------------------------
# Experimental variants (plain torch on (20, B) int32; the JAX module's
# shapes and operations, so every wrap-around agrees).
# --------------------------------------------------------------------------

_NCONV = 2 * F.NLIMBS


def _carry_round40(x: torch.Tensor) -> torch.Tensor:
    """The 40-column carry round (column 39's carry enters column 20)."""
    c = x >> F.RADIX
    r = x & F.MASK
    shifted = torch.cat([
        torch.zeros_like(c[:1]),
        c[: F.NLIMBS - 1],
        c[F.NLIMBS - 1: F.NLIMBS] + c[_NCONV - 1:] * F.FOLD,
        c[F.NLIMBS: _NCONV - 1],
    ], dim=0)
    return r + shifted


def _reduce_v2(conv: torch.Tensor) -> torch.Tensor:
    """2x carry40 + fold + 3x carry20."""
    for _ in range(2):
        conv = _carry_round40(conv)
    folded = conv[: F.NLIMBS] + F.FOLD * conv[F.NLIMBS:]
    for _ in range(3):
        folded = F._carry_round20(folded)
    return folded


def _mul_v2(a, b):
    return _reduce_v2(F._conv(a, b))


def _add_1round(a, b):
    return F._carry_round20(a + b)


def _conv_roll(a, b):
    """40-column product by rolls of the zero-extended b."""
    bz = torch.cat([b, torch.zeros_like(b)], dim=0)
    acc = a[0:1] * bz
    for i in range(1, F.NLIMBS):
        acc = acc + a[i: i + 1] * torch.roll(bz, i, dims=0)
    return acc


def _mul_roll(a, b):
    return _reduce_v2(_conv_roll(a, b))


def _conv_split(a, b):
    """Cyclic 20-column product split into (lo, hi): lo holds the products
    with i + j < 20 at column i + j, hi those with i + j >= 20 at i + j - 20."""
    cyc = a[0:1] * b
    hi = torch.zeros_like(b)
    row = torch.arange(b.shape[0], device=b.device)[:, None]
    for i in range(1, F.NLIMBS):
        prod = a[i: i + 1] * torch.roll(b, i, dims=0)
        cyc = cyc + prod
        hi = hi + torch.where(row < i, prod, 0)
    return cyc - hi, hi


def _reduce_split(lo, hi):
    """Carry hi twice, fold by 2^260 = FOLD, carry four times."""
    for _ in range(2):
        hi = F._carry_round20(hi)
    x = lo + F.FOLD * hi
    for _ in range(4):
        x = F._carry_round20(x)
    return x


def _mul_split(a, b):
    return _reduce_split(*_conv_split(a, b))


def _conv_stacked(a, b):
    """The 40-column product on stacked coordinates (4, 20, B)."""
    bz = torch.cat([b, torch.zeros_like(b)], dim=1)
    acc = a[:, 0:1] * bz
    for i in range(1, F.NLIMBS):
        acc = acc + a[:, i: i + 1] * torch.roll(bz, i, dims=1)
    return acc


def _select17_int16(table16, digit):
    """The where-tree lookup over int16 tables, upcast after the select."""
    neg_mask = (digit < 0)[None, :]
    mag = digit.abs().to(torch.int16)
    coords = [c[:16] for c in table16]
    for level in (3, 2, 1, 0):
        bit = ((mag >> level) & 1)[None, None, :] == 1
        half = coords[0].shape[0] // 2
        coords = [torch.where(bit, c[half:], c[:half]) for c in coords]
    is16 = (mag == 16)[None, :]
    x, y, z, t = (torch.where(is16, tb[16], c[0]).to(torch.int32)
                  for tb, c in zip(table16, coords))
    x = torch.where(neg_mask, F.neg(x), x)
    t = torch.where(neg_mask, F.neg(t), t)
    return C.Point(x, y, z, t)


# --------------------------------------------------------------------------
# Probe bodies. Each maps a tuple of n_state (20, B) int32 tensors to the
# same, as the JAX probe's lambda does; the kernel compiles the same
# function as body `body_id` (csrc/microbench.cu enum BodyId, same order).
# --------------------------------------------------------------------------

(MUL, SQ, ADD, SUB, RAW_ADD, CARRY20, CONV, LOOP, MUL_V2, MUL_SPLIT,
 DOUBLE_NO_T, DOUBLE, MADD, SELECT17, WINDOW, DBL5) = range(16)
N_BODIES = 16
# The bodies K3 runs on the verify kernels' arithmetic (csrc/probe32.cuh),
# equal to their plain versions by canonical value.
VALUE_BODIES = frozenset({MUL, SQ, ADD, SUB, DOUBLE_NO_T, DOUBLE, DBL5})
# The value bodies' domain: the largest L such that no limb of the plain
# run wraps int32 on states with every limb in [-L, L], the worst lane being
# every limb at +-L (a + b for add, a + M_SUB - b for sub; the products
# found by search). The kernel takes any int32 limbs, mod p.
_PRODUCT_LIMB_MAX = 10_342
VALUE_LIMB_MAX = {MUL: _PRODUCT_LIMB_MAX, SQ: _PRODUCT_LIMB_MAX, ADD: (2**31 - 1) // 2,
                  SUB: (2**31 - 1 - max(F.CONST_LIMBS["M_SUB"])) // 2,
                  DOUBLE_NO_T: _PRODUCT_LIMB_MAX, DOUBLE: _PRODUCT_LIMB_MAX,
                  DBL5: _PRODUCT_LIMB_MAX}


def _table_b(s) -> tuple[torch.Tensor, ...]:
    return C.base_table17(s[0].device)


def _window(s):
    """window_step(out_t=False) over the per-lane table s0 + ([d]B).x (all
    four coordinates), digits s0 limb 0 & 15."""
    p = C.Point(*s)
    table_b = _table_b(s)
    table_a = (s[0][None] + table_b[0],) * 4
    ds = s[0][0] & 15
    return tuple(C.window_step(p, ds, ds, table_b, table_a, out_t=False))


def _dbl5(s):
    p = C.Point(*s)
    for _ in range(4):
        p = C.double_no_t(p)
    return tuple(C.double(p))


def _select_only(s):
    return (C._select17_signed(_table_b(s), s[0][0]).x, s[0], s[1], s[2])


class Body(NamedTuple):
    plain: Callable  # tuple of n_state (20, B) tensors -> the same
    n_state: int
    base_iters: int  # the JAX probe's I
    body_id: int  # the kernel's body


_mul = Body(lambda s: (F.mul(s[0], s[1]), s[0]), 2, 300_000, MUL)
_sub = Body(lambda s: (F.sub(s[0], s[1]), s[0]), 2, 1_000_000, SUB)
_sel = Body(_select_only, 4, 100_000, SELECT17)

# Registry: the JAX probe names, in the order its probes print them. Names
# with one body_id compute one function (see csrc/microbench.cu).
BODIES: dict[str, Body] = {
    # field
    "mul": _mul,
    "sq": Body(lambda s: (F.sq(s[0]),), 1, 300_000, SQ),
    "add(3-round carry)": Body(lambda s: (F.add(s[0], s[1]), s[0]), 2, 1_000_000, ADD),
    "sub(3-round carry)": _sub,
    "raw add (no carry)": Body(lambda s: ((s[0] + s[1]) & 0x1FFF, s[0]), 2, 2_000_000,
                               RAW_ADD),
    "carry_round20": Body(lambda s: (F._carry_round20(s[0]),), 1, 2_000_000, CARRY20),
    "conv only (no reduce)": Body(lambda s: (F._conv(s[0], s[1])[:20], s[0]), 2, 300_000,
                                  CONV),
    # variants
    "loop overhead (s+1)": Body(lambda s: (s[0] + 1,), 1, 2_000_000, LOOP),
    "reduce_v2 mul": Body(lambda s: (_mul_v2(s[0], s[1]), s[0]), 2, 300_000, MUL_V2),
    "roll-conv mul": Body(lambda s: (_mul_roll(s[0], s[1]), s[0]), 2, 300_000, MUL_V2),
    "conv_roll only": Body(lambda s: (_conv_roll(s[0], s[1])[:20], s[0]), 2, 300_000,
                           CONV),
    "add 1-round": Body(lambda s: (_add_1round(s[0], s[1]), s[0]), 2, 1_000_000, ADD),
    # variants2
    "split-conv mul": Body(lambda s: (_mul_split(s[0], s[1]), s[0]), 2, 300_000,
                           MUL_SPLIT),
    "conv_split only": Body(lambda s: (_conv_split(s[0], s[1])[0], s[0]), 2, 300_000,
                            CONV),
    "current field.mul": _mul,
    "current field.sub": _sub,
    # curve and window
    "double_no_t": Body(lambda s: tuple(C.double_no_t(C.Point(*s))), 4, 40_000,
                        DOUBLE_NO_T),
    "double": Body(lambda s: tuple(C.double(C.Point(*s))), 4, 40_000, DOUBLE),
    "madd_pre": Body(lambda s: tuple(C.madd_pre(
        C.Point(*s), C._select17_signed(_table_b(s), s[0][0]))), 4, 40_000, MADD),
    "select17 only": _sel,
    "select17 int32 (current)": _sel._replace(base_iters=200_000),
    "window_step(out_t=False)": Body(_window, 4, 20_000, WINDOW),
    "5 doublings only": Body(_dbl5, 4, 20_000, DBL5),
}


# --------------------------------------------------------------------------
# Kernels K3 and K4
# --------------------------------------------------------------------------

_loaded = None


def _lib():
    global _loaded
    if _loaded is None:
        from cometbft_tpu_torch.ops import _build

        lib = _build.library("microbench")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.microbench_loop.argtypes = [ci, vp, vp, vp, ci, ci, vp]
        lib.microbench_loop.restype = ci
        lib.microbench_stacked.argtypes = [vp, vp, vp, ci, ci, vp]
        lib.microbench_stacked.restype = ci
        lib.microbench_launch_shape.argtypes = [ci, ci, vp]
        lib.microbench_launch_shape.restype = ci
        _loaded = lib
    return _loaded


def _check(name: str, t: torch.Tensor, rows: int):
    if t.dtype != torch.int32:
        raise TypeError(f"{name} must be int32, got {t.dtype}")
    if t.dim() != 3 or tuple(t.shape[:2]) != (rows, F.NLIMBS) or t.shape[2] < 1:
        raise ValueError(f"{name} must have shape ({rows}, {F.NLIMBS}, B >= 1), "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")


def _check_iters(iters: int) -> None:
    if not 0 <= iters < 2**31:
        raise ValueError(f"iters must lie in [0, 2^31), got {iters}")


def _raise_on(err: int, entry: str) -> None:
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: cudaError_t {err}")


def loop_plain(name: str, state: torch.Tensor, iters: int) -> torch.Tensor:
    """The plain version of K3: body `name` run `iters` times on state
    (n_state, 20, B) int32."""
    f = BODIES[name].plain
    s = tuple(state.unbind(0))
    for _ in range(iters):
        s = f(s)
    return torch.stack(s)


def loop(name: str, state: torch.Tensor, iters: int) -> torch.Tensor:
    """K3: the registered body `name` run `iters` times on state
    (n_state, 20, B) int32 -> the new state, same shape. Any B >= 1. On the
    card a value body's output is canonical limbs of loop_plain's value
    mod p (see loop_err) on the body's domain, the states with every limb
    within +-VALUE_LIMB_MAX; on wider limbs loop_plain wraps int32 where the
    kernel reduces the state's value mod p."""
    body = BODIES[name]
    _check("state", state, body.n_state)
    _check_iters(iters)
    dev = state.device
    if dev.type == "cpu":
        return loop_plain(name, state, iters)
    table = _limb_table(dev)
    out = torch.empty_like(state)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().microbench_loop(body.body_id, state.data_ptr(), out.data_ptr(),
                                     table.data_ptr(), iters, state.shape[2], stream)
    _raise_on(err, "microbench_loop")
    LAUNCHES["microbench_loop"] += 1
    LOOP_LAUNCHES[name] = LOOP_LAUNCHES.get(name, 0) + 1
    return out


def loop_err(name: str, got: torch.Tensor, want: torch.Tensor) -> int:
    """The largest difference between K3's output `got` and the plain
    version's `want` for body `name`, 0 when they agree: a limb body's limbs
    bit for bit; a value body's limbs (canonical) against the canonical
    limbs of the plain version's (field.canonicalize), coordinate by
    coordinate, so double_no_t's T must be zeros as the plain one's is."""
    if BODIES[name].body_id in VALUE_BODIES:
        want = torch.stack([F.canonicalize(c) for c in want.unbind(0)])
    return int((got.to(torch.int64) - want.to(torch.int64)).abs().max())


def state_mod_p(state: np.ndarray) -> np.ndarray:
    """Each coordinate of a (n, 20, B) int32 state, its limbs any int32, as
    the canonical limbs of its value mod p: the state a value body's plain
    version takes without wrapping int32, for limbs it would wrap on."""
    weights = np.array([1 << (F.RADIX * i) for i in range(F.NLIMBS)], dtype=object)
    vals = (state.astype(object) * weights[None, :, None]).sum(axis=1) % F.P
    out = np.stack([(vals >> (F.RADIX * i)) & F.MASK for i in range(F.NLIMBS)], axis=1)
    return out.astype(np.int32)


def value_edge_state(name: str, lanes: int, seed: int = 0) -> np.ndarray:
    """A (n_state, 20, lanes) int32 state at the edge of value body
    `name`'s domain, L = VALUE_LIMB_MAX: lanes with every limb L, every limb
    -L, the limbs alternating in sign, the first coordinate at L and the
    rest at -L and the reverse, the coordinates alternating in sign; the
    other lanes random in [-L, L]. Needs lanes >= 6."""
    body = BODIES[name]
    lim = VALUE_LIMB_MAX[body.body_id]
    s = np.random.default_rng(seed).integers(-lim, lim + 1, size=(body.n_state, F.NLIMBS, lanes))
    s[:, :, 0] = lim
    s[:, :, 1] = -lim
    s[:, ::2, 2], s[:, 1::2, 2] = lim, -lim
    s[0, :, 3], s[1:, :, 3] = lim, -lim
    s[0, :, 4], s[1:, :, 4] = -lim, lim
    s[::2, :, 5], s[1::2, :, 5] = lim, -lim
    return s.astype(np.int32)


def launch_shape(name: str, lanes: int, dev: torch.device) -> dict[str, int]:
    """How K3 launches body `name` on `lanes` lanes on CUDA device `dev`:
    lanes per block, blocks, threads per block (four a lane for the quad
    bodies), resident blocks per SM (the CUDA occupancy calculator), SMs,
    the waves that makes, and the loaded kernel's local memory per thread
    (stack and spills) and registers. Launches nothing."""
    out = (ctypes.c_int * 7)()
    with torch.cuda.device(dev):
        err = _lib().microbench_launch_shape(BODIES[name].body_id, lanes, out)
    _raise_on(err, f"loop_kernel<{name}> launch shape")
    per_block, blocks, threads, per_sm, sms, local_bytes, registers = out
    if per_sm < 1:
        raise RuntimeError(f"loop_kernel<{name}>: no block of {threads} threads fits an SM")
    return {"lanes_per_block": per_block, "blocks": blocks, "threads_per_block": threads,
            "blocks_per_sm": per_sm, "sms": sms, "waves": -(-blocks // (per_sm * sms)),
            "local_bytes": local_bytes, "registers": registers}


_limb_tables: dict[torch.device, torch.Tensor] = {}


def _limb_table(dev: torch.device) -> torch.Tensor:
    """K3's [d]B table: curve.base_table17_limbs, (4, 17, 20) int32 limbs of
    (x, y, 1, t * 2d), on `dev`."""
    t = _limb_tables.get(dev)
    if t is None:
        t = _limb_tables[dev] = torch.from_numpy(C.base_table17_limbs()).to(dev).contiguous()
    return t


def stacked_plain(a: torch.Tensor, b: torch.Tensor, iters: int) -> torch.Tensor:
    """The plain version of K4: a = conv(a, b)[:, :20] & 0x1FFF, `iters`
    times, on (4, 20, B) int32."""
    for _ in range(iters):
        a = _conv_stacked(a, b)[:, : F.NLIMBS] & 0x1FFF
    return a


def stacked(a: torch.Tensor, b: torch.Tensor, iters: int) -> torch.Tensor:
    """K4: stacked_plain's function on (4, 20, B) int32 a and b. Any B >= 1."""
    _check("a", a, 4)
    _check("b", b, 4)
    _check_iters(iters)
    if a.shape != b.shape or a.device != b.device:
        raise ValueError("a and b differ in shape or device")
    if a.device.type == "cpu":
        return stacked_plain(a, b, iters)
    out = torch.empty_like(a)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = _lib().microbench_stacked(a.data_ptr(), b.data_ptr(), out.data_ptr(), iters,
                                        a.shape[2], stream)
    _raise_on(err, "microbench_stacked")
    LAUNCHES["microbench_stacked"] += 1
    return out


# --------------------------------------------------------------------------
# Probes
# --------------------------------------------------------------------------


def _cuda() -> torch.device:
    if not torch.cuda.is_available():
        raise RuntimeError("microbench: device probes need a CUDA device; only the "
                           "staging probe runs on the host")
    return torch.device("cuda")


def _time(fn, reps: int = 5) -> float:
    """Median of `reps` CUDA-event times of fn(), in seconds, after one
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        out.append(e0.elapsed_time(e1) * 1e-3)
    return statistics.median(out)


def probe_state(n_state: int, lanes: int = LANES) -> np.ndarray:
    """The probes' seeded state: n_state arrays of integers in [0, 8000),
    drawn as the JAX probe draws them -> (n_state, 20, lanes) int32."""
    rng = np.random.default_rng(0)
    return np.stack([rng.integers(0, 8000, size=(F.NLIMBS, lanes))
                     for _ in range(n_state)]).astype(np.int32)


def probe_loop(name: str, base_iters: int | None = None, lanes: int = LANES) -> float:
    """Per-iteration device time (us) of body `name` by the I vs 2I slope;
    I defaults to the JAX probe's."""
    dev = _cuda()
    i1 = base_iters or BODIES[name].base_iters
    state = torch.from_numpy(probe_state(BODIES[name].n_state, lanes)).to(dev)
    t1 = _time(lambda: loop(name, state, i1))
    t2 = _time(lambda: loop(name, state, 2 * i1))
    per = (t2 - t1) / i1 * 1e6
    print(f"  {name:<32} {per:9.3f} us/iter  (I={i1}, t1={t1*1e3:.1f}ms "
          f"t2={t2*1e3:.1f}ms)", flush=True)
    return per


def bench_verify_inputs(batch: int, dev: torch.device) -> list[torch.Tensor]:
    """The verify probes' seeded random inputs at `batch` lanes: A coords
    4 x (20, B) and r/s/k words 3 x (8, B) int32, on `dev`. Their verdicts
    are meaningless; the probes only time them."""
    rng = np.random.default_rng(1)
    a = rng.integers(0, 8000, size=(4, F.NLIMBS, batch)).astype(np.int32)
    w = rng.integers(0, 2**32, size=(3, 8, batch), dtype=np.uint64).astype(np.uint32)
    args = [torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in a]
    return args + [torch.from_numpy(np.ascontiguousarray(x).view(np.int32)).to(dev)
                   for x in w]


def _verify_reps_timer(batch: int, n_windows: int = 0, stages: str = "full") -> float:
    """Seconds per bench-kernel call at `batch` lanes, slope of 4 vs 12
    calls on bench_verify_inputs (timing only: validity is irrelevant)."""
    from cometbft_tpu_torch.ops import verify_kernel as VK

    dev = _cuda()
    args = bench_verify_inputs(batch, dev)

    def reps(n: int):
        acc = torch.zeros(batch, dtype=torch.int32, device=dev)
        for _ in range(n):
            m, _ok = VK.verify_bench(*args, n_windows=n_windows, stages=stages)
            acc += m.to(torch.int32)
        return acc

    t1 = _time(lambda: reps(4))
    t2 = _time(lambda: reps(12))
    return (t2 - t1) / 8


def probe_full_verify(batch: int = 10240) -> float:
    """The verify kernel's device time per batch (the bench entry with
    default knobs), by the slope of a rep loop. Returns seconds."""
    per = _verify_reps_timer(batch)
    print(f"  verify[{batch}]                   {per*1e3:9.2f} ms/batch  "
          f"({batch/per:,.0f} sigs/s)", flush=True)
    return per


def probe_bisect(batch: int = 10240) -> dict[str, float]:
    """In-context stage costs: truncate the ladder / skip R's decompression
    and difference the slopes. Costs are per launch of `batch` lanes and per
    signature (the kernel's block size follows the batch, so a block is no
    unit). Returns the three slopes in seconds."""
    full = _verify_reps_timer(batch)
    half = _verify_reps_timer(batch, n_windows=26)
    nodec = _verify_reps_timer(batch, stages="nodecomp")
    per_win = (full - half) / 25
    decomp = full - nodec
    rest = full - U.NDIGITS5 * per_win - decomp
    print(f"  full                  {full*1e3:8.3f} ms")
    print(f"  26-window ladder      {half*1e3:8.3f} ms")
    print(f"  no R-decompress       {nodec*1e3:8.3f} ms")
    print(f"  => per-window         {per_win*1e6:8.3f} us/launch  "
          f"{per_win*1e9/batch:8.3f} ns/signature")
    print(f"  => decompress         {decomp*1e6:8.3f} us/launch  "
          f"{decomp*1e9/batch:8.3f} ns/signature")
    print(f"  => rest (non-ladder)  {rest*1e6:8.3f} us/launch  "
          f"{rest*1e9/batch:8.3f} ns/signature", flush=True)
    return {"full": full, "half": half, "nodecomp": nodec}


def probe_variants() -> None:
    print("variants (per 128-lane block):")
    for name in ("loop overhead (s+1)", "reduce_v2 mul", "roll-conv mul", "conv_roll only",
                 "add 1-round"):
        probe_loop(name)


def probe_variants2() -> None:
    print("variants2 (per 128-lane block):")
    for name in ("split-conv mul", "conv_split only", "current field.mul",
                 "current field.sub"):
        probe_loop(name)


def probe_stacked(iters: int = 100_000, lanes: int = LANES) -> float:
    """K4's per-iteration time (us) by the I vs 2I slope."""
    print("stacked-coord conv (4x (20,128) jointly):")
    dev = _cuda()
    rng = np.random.default_rng(0)
    a, b = (torch.from_numpy(rng.integers(0, 8000, size=(4, F.NLIMBS, lanes))
                             .astype(np.int32)).to(dev) for _ in range(2))
    t1 = _time(lambda: stacked(a, b, iters))
    t2 = _time(lambda: stacked(a, b, 2 * iters))
    per = (t2 - t1) / iters * 1e6
    print(f"  4-stacked conv                   {per:9.3f} us/iter  (= {per/4:.3f} us per "
          f"conv)  t1={t1*1e3:.1f}ms t2={t2*1e3:.1f}ms", flush=True)
    return per


def probe_select16(torch_iters: int = 1_000) -> None:
    """The int32 select as a K3 body, then the int16 and int32 where-tree
    selects as plain torch loops on the card (XLA programs in the JAX
    module, no Pallas kernel). An eager torch loop launches each operation
    separately, so those two loops run torch_iters and 2 x torch_iters
    iterations, not the JAX module's 100,000 and 200,000."""
    print("select int16 experiment (per 128-lane block):")
    probe_loop("select17 int32 (current)")
    dev = _cuda()
    table = C.base_table17(dev)
    table16 = tuple(c.expand(C.TABLE17, F.NLIMBS, LANES).to(torch.int16) for c in table)
    rng = np.random.default_rng(0)
    arrs = [torch.from_numpy(rng.integers(-16, 16, size=(F.NLIMBS, LANES))
                             .astype(np.int32)).to(dev) for _ in range(4)]

    def loop16(iters: int):
        s = tuple(arrs)
        for _ in range(iters):
            s = (_select17_int16(table16, s[0][0]).x, s[0], s[1], s[2])
        return s

    def loop32(iters: int):
        s = tuple(arrs)
        for _ in range(iters):
            s = (C._select17_signed(table, s[0][0]).x, s[0], s[1], s[2])
        return s

    for name, fn in (("torch select int16", loop16), ("torch select int32", loop32)):
        t1 = _time(lambda: fn(torch_iters))
        t2 = _time(lambda: fn(2 * torch_iters))
        print(f"  {name:<32} {(t2-t1)/torch_iters*1e6:9.3f} us/iter", flush=True)


def probe_staging(n: int = 10240, mlen: int = 110) -> dict[str, float]:
    """Host staging: serial per-row hashers against the batch rungs
    (ops/hashvec, the batch Merlin transcript), us/row. Host work only: no
    device is involved. Returns the us/row figures."""
    import hashlib

    from cometbft_tpu_torch.crypto import sr25519_math as srm
    from cometbft_tpu_torch.ops import hashvec

    rng = np.random.default_rng(0)
    datas = [rng.bytes(mlen) for _ in range(n)]
    print(f"  hashvec native core: {hashvec.native_available()}")

    t0 = time.perf_counter()
    for d in datas:
        hashlib.sha512(d).digest()
    t_serial = time.perf_counter() - t0
    t0 = time.perf_counter()
    hashvec.sha512_many(datas)
    t_vec = time.perf_counter() - t0
    print(f"  sha512      serial {t_serial / n * 1e6:7.2f} us/row | "
          f"vectorized {t_vec / n * 1e6:7.2f} us/row "
          f"({t_serial / t_vec:.1f}x)")

    t0 = time.perf_counter()
    hashvec.sha512_mod_l_words(datas)
    t_pipe = time.perf_counter() - t0
    print(f"  sha512+modL pipeline          | "
          f"vectorized {t_pipe / n * 1e6:7.2f} us/row")

    m = max(1, n // 4)  # the serial transcript is slow; measure a quarter
    pubs = [rng.bytes(32) for _ in range(m)]
    rs = [rng.bytes(32) for _ in range(m)]
    msgs = [rng.bytes(mlen) for _ in range(m)]
    t0 = time.perf_counter()
    for p, r, msg in zip(pubs, rs, msgs):
        srm.compute_challenge(p, r, msg)
    t_sr_serial = time.perf_counter() - t0
    t0 = time.perf_counter()
    srm.batch_challenge_words(pubs, rs, msgs)
    t_sr_vec = time.perf_counter() - t0
    print(f"  sr challenge serial {t_sr_serial / m * 1e6:6.2f} us/row | "
          f"batch STROBE {t_sr_vec / m * 1e6:5.2f} us/row "
          f"({t_sr_serial / t_sr_vec:.1f}x)", flush=True)
    return {"sha512_serial": t_serial / n * 1e6, "sha512_vec": t_vec / n * 1e6,
            "sha512_mod_l": t_pipe / n * 1e6, "sr_serial": t_sr_serial / m * 1e6,
            "sr_batch": t_sr_vec / m * 1e6}


# The probe groups of main(), in the order they print; each name is a
# BODIES entry.
FIELD_PROBES = ("mul", "sq", "add(3-round carry)", "sub(3-round carry)",
                "raw add (no carry)", "carry_round20", "conv only (no reduce)")
WINDOW_PROBES = ("window_step(out_t=False)", "5 doublings only")
CURVE_PROBES = ("double_no_t", "double", "madd_pre", "select17 only")


def main(argv: list[str]) -> None:
    probes = set(argv) or {"all"}
    device = (torch.cuda.get_device_name() if torch.cuda.is_available()
              else "none (host probes only)")
    print(f"device={device}")

    if probes & {"all", "staging"}:
        print("host staging (serial vs vectorized hashers):")
        probe_staging()

    if probes & {"all", "verify"}:
        print("full verify:")
        probe_full_verify()

    if probes & {"bisect"}:
        print("stage bisection:")
        probe_bisect()

    if probes & {"all", "field"}:
        print("field ops (per 128-lane block):")
        for name in FIELD_PROBES:
            probe_loop(name)

    if probes & {"all", "variants"}:
        probe_variants()

    if probes & {"all", "variants2"}:
        probe_variants2()

    if probes & {"all", "stacked"}:
        probe_stacked()

    if probes & {"select16"}:
        probe_select16()

    if probes & {"all", "window"}:
        print("ladder window (per 128-lane block):")
        for name in WINDOW_PROBES:
            probe_loop(name)

    if probes & {"all", "curve"}:
        print("curve ops (per 128-lane block):")
        for name in CURVE_PROBES:
            probe_loop(name)


if __name__ == "__main__":
    main(sys.argv[1:])
