"""Ed25519 ZIP-215 and sr25519 verify and pubkey decoding: kernel wrappers
and their plain PyTorch versions.

Source note. The verify kernels (csrc/verify25519.cu over
csrc/quad25519.cuh and csrc/fe32.cuh) replace the Pallas TPU kernel
``cometbft_tpu/ops/pallas_verify.py::_verify_block_kernel`` (entries
``verify_pallas_ok``, scheme "ed25519" — K1 — and ``verify_pallas_sr_ok``,
scheme "sr25519" — K2); the decoders (csrc/decompress25519.cu over
csrc/decode25519.cuh and csrc/fe32.cuh) replace the XLA programs
``cometbft_tpu/ops/ed25519_kernel.py::_decompress_kernel`` and
``cometbft_tpu/ops/sr25519_kernel.py::_decompress_kernel``. All are bound by
32-bit integer multiply-adds — about 2,800 field multiplications per
signature against ~1 KB of memory traffic. The verify kernels run each
signature on four threads, one coordinate each, in 8 x 32-bit limbs with
nothing in local memory: the per-signature table of [d](-A), the [d]B
table (``base_table_words``, in the cached form (y - x, y + x, 2z, 2d t))
and the signed digits in shared memory, in a grid of one wave
(``launch_shape``). The decoders run in the same field, one key a
thread, in a grid of one wave; they write the JAX package's format, 20 x
13-bit limbs, which the key cache holds and the verify kernels take as A.
Their limbs are canonical and the plain version's carried, so the two agree
as field values (``decode_err``).

``verify_bench`` is the microbench's entry (ops/microbench.py): a separate
instantiation of the ed25519 kernel with the Pallas kernel's bisection knobs
(n_windows, stages), whose masks are wrong by design; the production
entries cannot reach it.

Each wrapper takes its plain version for tensors on the CPU (the tests) and
launches its kernel for tensors on a CUDA device; there is no other route.
``LAUNCHES`` counts kernel launches per entry, ``LANES`` the lanes they
covered.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from cometbft_tpu_torch.ops import curve
from cometbft_tpu_torch.ops import field as F
from cometbft_tpu_torch.ops import limbs as L
from cometbft_tpu_torch.ops import unpack as U

LAUNCHES = {"ed25519_verify": 0, "ed25519_decompress": 0,
            "sr25519_verify": 0, "sr25519_decompress": 0,
            "ed25519_verify_bench": 0}
LANES = dict.fromkeys(LAUNCHES, 0)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
        LANES[k] = 0


def _count(entry: str, lanes: int) -> None:
    LAUNCHES[entry] += 1
    LANES[entry] += lanes


# ------------------------------------------------------------ plain versions


def verify_math(ax, ay, az, at, r_words, s_words, k_words) -> torch.Tensor:
    """A coords (20, B) int32; r/s/k packed (8, B) int32 words -> (B,) bool.
    Lanes whose pubkey failed decompression give garbage; the caller masks
    them with the decompression ok flag."""
    ok_r, r = curve.decompress_zip215(U.words_to_y_limbs(r_words),
                                      U.words_sign(r_words))
    neg_a = curve.neg(curve.Point(ax, ay, az, at))
    sb_ka = curve.windowed_double_scalar_signed(
        U.words_to_digits5_signed(s_words), U.words_to_digits5_signed(k_words),
        neg_a)
    diff = curve.add(sb_ka, curve.neg(r))
    return curve.is_identity(curve.mul_by_cofactor(diff)) & ok_r


def verify_math_bench(ax, ay, az, at, r_words, s_words, k_words,
                      n_windows: int = 0, stages: str = "full"):
    """verify_math_ok with the microbench's bisection knobs, the plain
    version of the bench kernel (the Pallas kernel's _verify_pallas_bench
    knobs): n_windows > 0 runs windows n_windows - 1 .. 1 and then window
    0; stages="nodecomp" takes R = A with ok instead of decompressing R.
    Either gives wrong masks; n_windows 0 or 51 with "full" is
    verify_math_ok."""
    nodecomp = _bench_nodecomp(n_windows, stages)
    a = curve.Point(ax, ay, az, at)
    if nodecomp:
        ok_r, r = torch.ones(ax.shape[1:], dtype=torch.bool, device=ax.device), a
    else:
        ok_r, r = curve.decompress_zip215(U.words_to_y_limbs(r_words),
                                          U.words_sign(r_words))
    # curve.windowed_double_scalar_signed, cut to n_windows windows
    sd, kd = U.words_to_digits5_signed(s_words), U.words_to_digits5_signed(k_words)
    table_a = curve.build_point_table17(curve.neg(a))
    table_b = curve.base_table17(ax.device)
    acc = curve.identity_like(ax)
    for i in range((n_windows or U.NDIGITS5) - 1, 0, -1):
        acc = curve.window_step(acc, sd[i], kd[i], table_b, table_a, out_t=False)
    acc = curve.window_step(acc, sd[0], kd[0], table_b, table_a, out_t=True)
    diff = curve.add(acc, curve.neg(r))
    mask = curve.is_identity(curve.mul_by_cofactor(diff)) & ok_r
    return mask, mask.all()


def _bench_nodecomp(n_windows: int, stages: str) -> bool:
    """The bench knobs checked; True for stages="nodecomp"."""
    if not 0 <= n_windows <= U.NDIGITS5:
        raise ValueError(f"n_windows must lie in [0, {U.NDIGITS5}], got {n_windows}")
    if stages not in ("full", "nodecomp"):
        raise ValueError(f"stages must be 'full' or 'nodecomp', got {stages!r}")
    return stages == "nodecomp"


def verify_math_ok(ax, ay, az, at, r_words, s_words, k_words):
    """verify_math plus the batch-wide all-ok (padding lanes verify valid,
    so all() over the padded batch equals all() over the live lanes)."""
    mask = verify_math(ax, ay, az, at, r_words, s_words, k_words)
    return mask, mask.all()


def decompress_math(words: torch.Tensor):
    """(8, B) int32 packed encodings -> (ok (B,) bool, X, Y, Z, T (20, B))."""
    ok, p = curve.decompress_zip215(U.words_to_y_limbs(words),
                                    U.words_sign(words))
    return ok, p.x, p.y, p.z, p.t


def verify_math_sr(ax, ay, az, at, r_words, s_words, k_words) -> torch.Tensor:
    """sr25519: A coords (20, B) int32 (ristretto-decoded); r/s/k packed
    (8, B) int32 words -> (B,) bool. The ed25519 ladder with ristretto255
    decoding of R and the cofactor-4 check [4](sB - kA - R) == O, which is
    ristretto equality. Lanes with undecodable R reject; the caller masks
    undecodable A."""
    ok_r, r = curve.ristretto_decode_device(r_words)
    neg_a = curve.neg(curve.Point(ax, ay, az, at))
    sb_ka = curve.windowed_double_scalar_signed(
        U.words_to_digits5_signed(s_words), U.words_to_digits5_signed(k_words),
        neg_a)
    diff = curve.add(sb_ka, curve.neg(r))
    return curve.is_identity(curve.double(curve.double(diff))) & ok_r


def verify_math_sr_ok(ax, ay, az, at, r_words, s_words, k_words):
    """verify_math_sr plus the batch-wide all-ok (padding lanes are zero
    encodings with zero scalars — the identity — and verify valid)."""
    mask = verify_math_sr(ax, ay, az, at, r_words, s_words, k_words)
    return mask, mask.all()


def decompress_sr_math(words: torch.Tensor):
    """(8, B) int32 packed ristretto encodings -> (ok (B,) bool, X, Y, Z, T
    (20, B))."""
    ok, p = curve.ristretto_decode_device(words)
    return ok, p.x, p.y, p.z, p.t


# ------------------------------------------------------------------ kernels


_loaded: dict[str, ctypes.CDLL] = {}


def _lib(stem: str) -> ctypes.CDLL:
    """The built kernel library csrc/<stem>.cu ("verify25519" or
    "decompress25519"), with its C signatures declared."""
    lib = _loaded.get(stem)
    if lib is None:
        from cometbft_tpu_torch.ops import _build

        lib = _build.library(stem)
        vp = ctypes.c_void_p
        if stem == "verify25519":
            for entry in ("ed25519_verify", "sr25519_verify"):
                getattr(lib, entry).argtypes = [vp] * 10 + [ctypes.c_int, vp]
                getattr(lib, entry).restype = ctypes.c_int
            lib.ed25519_verify_bench.argtypes = [vp] * 10 + [ctypes.c_int] * 3 + [vp]
            lib.ed25519_verify_bench.restype = ctypes.c_int
            lib.verify_launch_shape.argtypes = [ctypes.c_int, ctypes.c_int,
                                                ctypes.POINTER(ctypes.c_int)]
            lib.verify_launch_shape.restype = ctypes.c_int
        else:
            for entry in ("ed25519_decompress", "sr25519_decompress"):
                getattr(lib, entry).argtypes = [vp] * 6 + [ctypes.c_int, vp]
                getattr(lib, entry).restype = ctypes.c_int
            lib.decompress_launch_shape.argtypes = [ctypes.c_int, ctypes.c_int,
                                                    ctypes.POINTER(ctypes.c_int)]
            lib.decompress_launch_shape.restype = ctypes.c_int
        _loaded[stem] = lib
    return lib


def _check(name: str, t: torch.Tensor, rows: int, b: int, dev: torch.device):
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, expected {dev}")
    if t.dtype != torch.int32:
        raise TypeError(f"{name} must be int32, got {t.dtype}")
    if tuple(t.shape) != (rows, b):
        raise ValueError(f"{name} must have shape ({rows}, {b}), got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if b < 1:
        raise ValueError(f"{name} holds an empty batch")


def _raise_on(err: int, entry: str) -> None:
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: cudaError_t {err}")


def base_table_words() -> np.ndarray:
    """The verify kernels' [d]B table, d = 0..16, from the port's constants
    (curve.base_table17_limbs: affine x, y and t * 2d) in the cached form
    of an addend: (4, 8, 17) int32 words (the uint32 bits) of (y - x,
    y + x, 2z = 2, 2d t) mod p, [coord][limb][entry]."""
    coords = curve.base_table17_limbs()
    out = np.zeros((4, 8, curve.TABLE17), dtype=np.uint32)
    for d in range(curve.TABLE17):
        x, y, _, t2d = (L.limbs_to_int(coords[ci, d]) % F.P for ci in range(4))
        for ci, v in enumerate(((y - x) % F.P, (y + x) % F.P, 2, t2d)):
            out[ci, :, d] = [(v >> (32 * i)) & 0xFFFFFFFF for i in range(8)]
    return out.view(np.int32)


_table_cache: dict[torch.device, torch.Tensor] = {}


def _base_table(dev: torch.device) -> torch.Tensor:
    t = _table_cache.get(dev)
    if t is None:
        t = torch.from_numpy(base_table_words()).to(dev).contiguous()
        _table_cache[dev] = t
    return t


_SHAPE_ENTRIES = ("ed25519_verify", "sr25519_verify", "ed25519_verify_bench")
_DECODERS = ("ed25519_decompress", "sr25519_decompress")


def launch_shape(entry: str, b: int, dev: torch.device) -> dict[str, int]:
    """How kernel `entry` launches a batch of b lanes on CUDA device `dev`:
    signatures (or keys, for a decoder) per block, blocks, threads per
    block (four a signature, one a key), resident blocks per SM (the CUDA
    occupancy calculator at that block size and shared memory), SMs, the
    waves that makes, and the loaded kernel's local memory per thread
    (stack and spills) and registers. Launches nothing."""
    out = (ctypes.c_int * 7)()
    with torch.cuda.device(dev):
        if entry in _DECODERS:
            err = _lib("decompress25519").decompress_launch_shape(
                _DECODERS.index(entry), b, out)
        else:
            err = _lib("verify25519").verify_launch_shape(_SHAPE_ENTRIES.index(entry), b, out)
    _raise_on(err, f"{entry} launch shape")
    lanes, blocks, threads, per_sm, sms, local_bytes, registers = out
    if per_sm < 1:
        raise RuntimeError(f"{entry}: no block of {threads} threads fits an SM")
    per_block = "keys_per_block" if entry in _DECODERS else "sigs_per_block"
    return {per_block: lanes, "blocks": blocks, "threads_per_block": threads,
            "blocks_per_sm": per_sm, "sms": sms, "waves": -(-blocks // (per_sm * sms)),
            "local_bytes": local_bytes, "registers": registers}


def _launch_verify(entry: str, plain, ax, ay, az, at, r_words, s_words, k_words,
                   knobs: tuple[int, ...] = ()):
    """The plain version for CPU tensors; for CUDA tensors, kernel `entry`
    of the library (its launch counted) -> (mask, all-ok). `knobs` are the
    bench entry's extra int arguments."""
    dev = ax.device
    if dev.type == "cpu":
        return plain(ax, ay, az, at, r_words, s_words, k_words)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    b = ax.shape[1] if ax.dim() == 2 else -1
    for name, t in (("ax", ax), ("ay", ay), ("az", az), ("at", at)):
        _check(name, t, F.NLIMBS, b, dev)
    for name, t in (("r_words", r_words), ("s_words", s_words), ("k_words", k_words)):
        _check(name, t, U.WORDS, b, dev)
    launch = getattr(_lib("verify25519"), entry)
    table = _base_table(dev)
    mask = torch.empty(b, dtype=torch.int32, device=dev)
    allok = torch.ones(1, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = launch(
            ax.data_ptr(), ay.data_ptr(), az.data_ptr(), at.data_ptr(),
            r_words.data_ptr(), s_words.data_ptr(), k_words.data_ptr(),
            table.data_ptr(), mask.data_ptr(), allok.data_ptr(), b, *knobs, stream)
    _raise_on(err, entry)
    _count(entry, b)
    return mask != 0, allok[0] != 0


def _launch_decompress(entry: str, plain, words: torch.Tensor):
    """The plain version for CPU tensors; for CUDA tensors, kernel `entry`
    of the library (its launch counted) -> (ok, X, Y, Z, T)."""
    dev = words.device
    if dev.type == "cpu":
        return plain(words)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    b = words.shape[1] if words.dim() == 2 else -1
    _check("words", words, U.WORDS, b, dev)
    launch = getattr(_lib("decompress25519"), entry)
    ok = torch.empty(b, dtype=torch.int32, device=dev)
    coords = [torch.empty((F.NLIMBS, b), dtype=torch.int32, device=dev)
              for _ in range(4)]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = launch(words.data_ptr(), ok.data_ptr(),
                     *(c.data_ptr() for c in coords), b, stream)
    _raise_on(err, entry)
    _count(entry, b)
    return (ok != 0, *coords)


def decode_err(got, want) -> int:
    """The largest difference between two decoders' outputs (ok, X, Y, Z,
    T): ok bit for bit, the coordinates by their canonical limbs
    (field.canonicalize) on every lane; 0 when they are the same points."""
    err = int((got[0].to(torch.int64) - want[0].to(torch.int64)).abs().max())
    for a, b in zip(got[1:], want[1:]):
        d = F.canonicalize(a).to(torch.int64) - F.canonicalize(b).to(torch.int64)
        err = max(err, int(d.abs().max()))
    return err


def verify_ok(ax, ay, az, at, r_words, s_words, k_words):
    """The counterpart of pallas_verify.verify_pallas_ok: A coords (20, B)
    int32 x4 and packed r/s/k words (8, B) int32 (the wire's uint32 bits)
    -> ((B,) bool mask, () bool all-ok). Any B >= 1."""
    return _launch_verify("ed25519_verify", verify_math_ok,
                          ax, ay, az, at, r_words, s_words, k_words)


def verify_bench(ax, ay, az, at, r_words, s_words, k_words, n_windows: int = 0,
                 stages: str = "full"):
    """The counterpart of pallas_verify._verify_pallas_bench for ed25519:
    verify_ok with the microbench's knobs (see verify_math_bench), a
    separate kernel instantiation counted under "ed25519_verify_bench".
    Non-default knobs give wrong masks; the production entries cannot
    express them."""
    nodecomp = _bench_nodecomp(n_windows, stages)
    return _launch_verify(
        "ed25519_verify_bench",
        lambda *t: verify_math_bench(*t, n_windows=n_windows, stages=stages),
        ax, ay, az, at, r_words, s_words, k_words, knobs=(n_windows, int(nodecomp)))


def decompress(words: torch.Tensor):
    """The counterpart of ed25519_kernel._decompress_kernel: (8, B) int32
    packed encodings -> (ok (B,) bool, X, Y, Z, T (20, B) int32)."""
    return _launch_decompress("ed25519_decompress", decompress_math, words)


def verify_sr_ok(ax, ay, az, at, r_words, s_words, k_words):
    """The counterpart of pallas_verify.verify_pallas_sr_ok (kernel K2):
    sr25519 on the same inputs as verify_ok, with ristretto-decoded A
    coords -> ((B,) bool mask, () bool all-ok). Any B >= 1."""
    return _launch_verify("sr25519_verify", verify_math_sr_ok,
                          ax, ay, az, at, r_words, s_words, k_words)


def decompress_sr(words: torch.Tensor):
    """The counterpart of sr25519_kernel._decompress_kernel: (8, B) int32
    packed ristretto encodings -> (ok (B,) bool, X, Y, Z, T (20, B)
    int32)."""
    return _launch_decompress("sr25519_decompress", decompress_sr_math, words)
