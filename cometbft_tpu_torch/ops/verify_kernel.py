"""Ed25519 ZIP-215 and sr25519 verify and pubkey decoding: kernel wrappers
and their plain PyTorch versions.

Source note. The kernels (csrc/ed25519_verify.cu) replace the Pallas TPU
kernel ``cometbft_tpu/ops/pallas_verify.py::_verify_block_kernel`` (entries
``verify_pallas_ok``, scheme "ed25519" — K1 — and ``verify_pallas_sr_ok``,
scheme "sr25519" — K2) and the XLA programs
``cometbft_tpu/ops/ed25519_kernel.py::_decompress_kernel`` and
``cometbft_tpu/ops/sr25519_kernel.py::_decompress_kernel``. They are bound
by 32-bit integer multiply-adds — about 2,800 field multiplications of 20x20
13-bit limbs per signature, against ~1 KB of memory traffic — so the design
runs one signature per thread with every field element in registers, the
shared [d]B table in shared memory and the per-lane -A table in local
memory, and does the digit recoding and R unpack in a per-thread prologue
(see the source's header for the rest).

Each wrapper takes its plain version for tensors on the CPU (the tests) and
launches its kernel for tensors on a CUDA device; there is no other route.
``LAUNCHES`` counts kernel launches per entry, ``LANES`` the lanes they
covered.
"""

from __future__ import annotations

import ctypes

import torch

from cometbft_tpu_torch.ops import curve
from cometbft_tpu_torch.ops import field as F
from cometbft_tpu_torch.ops import unpack as U

LAUNCHES = {"ed25519_verify": 0, "ed25519_decompress": 0,
            "sr25519_verify": 0, "sr25519_decompress": 0}
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


_loaded = None


def _lib():
    """The built kernel library, with its C signatures declared."""
    global _loaded
    if _loaded is None:
        from cometbft_tpu_torch.ops import _build

        lib = _build.library("ed25519_verify")
        vp = ctypes.c_void_p
        for scheme in ("ed25519", "sr25519"):
            verify = getattr(lib, f"{scheme}_verify")
            verify.argtypes = [vp] * 10 + [ctypes.c_int, vp]
            verify.restype = ctypes.c_int
            decompress = getattr(lib, f"{scheme}_decompress")
            decompress.argtypes = [vp] * 6 + [ctypes.c_int, vp]
            decompress.restype = ctypes.c_int
        _loaded = lib
    return _loaded


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


_table_cache: dict[torch.device, torch.Tensor] = {}


def _base_table(dev: torch.device) -> torch.Tensor:
    t = _table_cache.get(dev)
    if t is None:
        t = torch.from_numpy(curve.base_table17_limbs()).to(dev).contiguous()
        _table_cache[dev] = t
    return t


def _launch_verify(entry: str, plain, ax, ay, az, at, r_words, s_words, k_words):
    """The plain version for CPU tensors; for CUDA tensors, kernel `entry`
    of the library (its launch counted) -> (mask, all-ok)."""
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
    launch = getattr(_lib(), entry)
    table = _base_table(dev)
    mask = torch.empty(b, dtype=torch.int32, device=dev)
    allok = torch.ones(1, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = launch(
            ax.data_ptr(), ay.data_ptr(), az.data_ptr(), at.data_ptr(),
            r_words.data_ptr(), s_words.data_ptr(), k_words.data_ptr(),
            table.data_ptr(), mask.data_ptr(), allok.data_ptr(), b, stream)
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
    launch = getattr(_lib(), entry)
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


def verify_ok(ax, ay, az, at, r_words, s_words, k_words):
    """The counterpart of pallas_verify.verify_pallas_ok: A coords (20, B)
    int32 x4 and packed r/s/k words (8, B) int32 (the wire's uint32 bits)
    -> ((B,) bool mask, () bool all-ok). Any B >= 1."""
    return _launch_verify("ed25519_verify", verify_math_ok,
                          ax, ay, az, at, r_words, s_words, k_words)


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
