"""The BLS12-381 kernels B1-B5 (csrc/bls12381.cu): their ctypes wrappers and
their plain PyTorch versions.

  decompress   B1  x -> (ok, affine x, y): y = sqrt(x^3 + b) with the sign
                   rule, ok = the root exists, and with check_subgroup the
                   point is in the subgroup (the kernel tests G1 by
                   sigma(P) == [-x^2]P and G2 by psi(P) == [x]P, the plain
                   version by [r]P == O: the same verdict on every point
                   of either curve). Replaces the XLA programs
                   cometbft_tpu/ops/bls_kernel.py:180 _jit_decompress, :191
                   _jit_subgroup_g1 and :198 _jit_subgroup_g2.
  hash_to_g2   B2  the raw hash_to_field planes -> affine H(m) and its
                   identity flag: [h2](map(u0) + map(u1)), h2 the oracle's
                   twist cofactor. Replaces :205 _jit_hash_msgs.
  point_sum    B3  a segmented sum of affine points by group, to affine, with
                   identity flags and (check_subgroup) the subgroup check of
                   each sum; wide groups split over many blocks (phase 1),
                   then a block a group (phase 2). Replaces points.sum_tree
                   in _aggregate_device (:546-571) and the sum's
                   _jit_subgroup_g2.
  miller       B4  f_{|x|,Q}(P) conjugated, one pair a lane. Replaces :221
                   _jit_miller.
  final_exp    B5  the segmented product of Miller values, the final
                   exponentiation and == 1, gated and forced per check, and
                   the all-ok word. Replaces :229 _jit_pair_halves,
                   pairing.py:105 product_lanes, :140-188 final_exp_composed
                   and :239 _jit_eq_one.

Representations. Inputs that come from host staging (B1's x, B2's u) are
the reference's raw radix-2^11 planes, (35, B) int32 a value. Every other
array is "planes": (rows, lanes) int32, the rows of one field element's
words stacked per coordinate (x then y; an Fp2 c0 then c1; an Fp12 in the
order d0.c0, d0.c1, d0.c2, d1.c0, d1.c1, d1.c2), 12 x 32-bit Montgomery
words a value (R = 2^384), whichever route computed them. The plain
versions compute in the reference's 35 radix-2^11 limbs (R = 2^385,
ops/bls12381/fp.py) and convert at their boundary. `planes_of_ints` builds
planes from canonical field values and `values` reads them back, which is
how a kernel is held against its plain version.

Each wrapper takes its plain version for tensors on the CPU and launches its
kernel for tensors on a CUDA device; there is no other route. The plain
versions (`*_plain`) run on any device. ``LAUNCHES`` counts kernel launches
per entry. B1 with the subgroup check has two kernels, a trio of
threads a lane and one lane a thread, and B4 three, a half-warp or a
sextet of threads a pair and one pair a thread: the narrower calls take the
larger groups, past measured crossovers (``launch_shape`` says which a call
takes). B3 runs one block a group alone on narrow groups ("short") and
splits wide ones over many blocks first ("split"). Their wrappers'
``kernel`` argument forces one ("trio" or "lane"; "short" or "split";
"half", "sextet" or "lane"), for holding each against the plain version on
both sides of each crossover.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from cometbft_tpu_torch.crypto import bls12381_math as oracle
from cometbft_tpu_torch.ops import _build
from cometbft_tpu_torch.ops.bls12381 import fp, fp2, htc, pairing, tower
from cometbft_tpu_torch.ops.bls12381 import points as pts

ENTRIES = ("bls_decompress_g1", "bls_decompress_g2", "bls_hash_to_g2", "bls_point_sum_g1",
           "bls_point_sum_g2", "bls_miller", "bls_final_exp")
# an entry's launches, and those of each kernel of the entries with more than one
KERNEL_COUNTS = ("bls_decompress_g1_trio", "bls_decompress_g1_lane", "bls_decompress_g2_trio",
                 "bls_decompress_g2_lane", "bls_point_sum_g1_short",
                 "bls_point_sum_g1_split", "bls_point_sum_g2_short", "bls_point_sum_g2_split",
                 "bls_miller_half", "bls_miller_sextet", "bls_miller_lane")
LAUNCHES = dict.fromkeys(ENTRIES + KERNEL_COUNTS, 0)

P = oracle.BLS_P
NW = 12  # kernel words a value
R32 = 1 << 384  # the kernels' Montgomery radix
_R32_INV = pow(R32, -1, P)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ------------------------------------------------------------ representations


def _words(x: int) -> list[int]:
    return [(x >> (32 * i)) & 0xFFFFFFFF for i in range(NW)]


def planes_of_ints(vals: list[list[int]], device=None) -> torch.Tensor:
    """Canonical field values -> planes: vals[k] lists coordinate k's value
    in every lane (an Fp2 coordinate is two entries, c0 then c1)."""
    blocks = [torch.from_numpy(np.array([_words(x % P * R32 % P) for x in v],
                                        dtype=np.uint32).T.copy().view(np.int32))
              for v in vals]
    return torch.cat(blocks).to(device)


def values(planes: torch.Tensor) -> list[list[int]]:
    """Planes -> canonical field values, one list a coordinate (the inverse
    of planes_of_ints)."""
    t = planes.detach().cpu()
    out = []
    for k in range(t.shape[0] // NW):
        w = t[k * NW:(k + 1) * NW].numpy().astype(np.uint32).T.astype(object)
        out.append([sum(int(x) << (32 * i) for i, x in enumerate(row)) * _R32_INV % P
                    for row in w])
    return out


# words <-> plain limbs. A value a is a * 2^384 mod p in words and a * 2^385
# mod p in plain limbs: the 384 bits repack into 11-bit digits, and a
# Montgomery product by 2^386 (into plain) or 2^384 (out of it) moves the
# radix.
_DIGIT_BIT = torch.arange(fp.NLIMBS) * fp.RADIX
_WORD_LO, _WORD_SHIFT = _DIGIT_BIT // 32, (_DIGIT_BIT % 32)[:, None]
_INTO_PLAIN, _OUT_OF_PLAIN = pow(2, 386, P), pow(2, 384, P)


def _from_words(planes: torch.Tensor) -> torch.Tensor:
    """Planes (k * 12, B) -> plain limbs (k * 35, B)."""
    b = planes.shape[-1]
    u = planes.reshape(-1, NW, b).to(torch.int64) & 0xFFFFFFFF
    u = torch.cat([u, torch.zeros_like(u[:, :1])], 1)
    lo, sh = _WORD_LO.to(u.device), _WORD_SHIFT.to(u.device)
    d = ((u[:, lo] >> sh) | (u[:, lo + 1] << (32 - sh))) & fp.MASK
    d = d.to(torch.int32)
    return fp.mul(d, fp._const(_INTO_PLAIN, d)).reshape(-1, b)


def _to_words(limbs: torch.Tensor) -> torch.Tensor:
    """Plain limbs (k * 35, B) -> planes (k * 12, B)."""
    b = limbs.shape[-1]
    a = limbs.reshape(-1, fp.NLIMBS, b)
    d = fp._canon_raw(fp.mul(a, fp._const(_OUT_OF_PLAIN, a))).to(torch.int64)
    words = []
    for i in range(NW):
        w = torch.zeros_like(d[:, 0])
        for j in range(32 * i // fp.RADIX, min(fp.NLIMBS, 32 * (i + 1) // fp.RADIX + 1)):
            s = fp.RADIX * j - 32 * i
            w = w | (d[:, j] << s if s >= 0 else d[:, j] >> -s)
        words.append(w & 0xFFFFFFFF)
    w = torch.stack(words, 1)
    return torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32).reshape(-1, b)


# ------------------------------------------------------------ constant table

# fp381.cuh's K_* layout
_LAYOUT = ("P", "ONE", "R2", "HALF", "N0", "B1", "MINUS1", "B2", "NEG_G1", "XI_INV", "SVDW",
           "FROB1", "FROB2", "E_PM2", "E_SQRT", "E_SQRT2", "E_LEG", "E_R", "E_H2", "E_X",
           "NBITS", "R3", "GLS", "PSI", "BETA", "X2")
GLS_DIGITS = 5
NK = 657 + 2 * GLS_DIGITS + 48 + 12 + 5


def gls_digits(k: int) -> list[int]:
    """k = sum d_i x^i with 0 <= d_i < |x|, x the (negative) curve
    parameter: the digits of a scalar for psi, which acts as [x] on G2."""
    x = oracle.BLS_X
    out = []
    while k:
        d = k % -x
        out.append(d)
        k = (k - d) // x
    return out


def cofactor_c() -> int:
    """c = (3(x^2 - 1))^-1 mod r: RFC 9380's h_eff is 3(x^2 - 1) h2, so
    [c][h_eff]P = [h2]P, the oracle's cofactor clearing, for every twist
    point P ([h2]P has order r or 1)."""
    setup = oracle._bls_setup()
    x = oracle.BLS_X
    h_eff = 3 * (x * x - 1) * setup["h2"]
    c = pow(3 * (x * x - 1), -1, oracle.BLS_R)
    assert (c * h_eff - setup["h2"]) % (setup["h2"] * oracle.BLS_R) == 0
    return c


def psi_constants() -> tuple:
    """psi(x, y) = (conj(x) cx, conj(y) cy) on the twist, cx = xi^-((p-1)/3),
    cy = xi^-((p-1)/2): the Frobenius through the untwist. Checked: psi
    acts on G2 as [x]."""
    cx = oracle.f2_inv(oracle.f2_pow(oracle.BLS_XI, (P - 1) // 3))
    cy = oracle.f2_inv(oracle.f2_pow(oracle.BLS_XI, (P - 1) // 2))
    g = oracle.BLS_G2
    F = oracle._Fp2Ops
    psi_g = (oracle.f2_mul(oracle.f2_conj(g[0]), cx), oracle.f2_mul(oracle.f2_conj(g[1]), cy))
    assert psi_g == oracle._ec_affine(F, oracle._ec_mul(F, oracle.BLS_X, oracle._ec_from_affine(g)))
    return cx, cy


def g1_beta() -> int:
    """beta, the primitive cube root of unity in Fp for which sigma(x, y) =
    (beta x, y) acts on G1 as [-x^2] (the other root gives [x^2 - 1]; both
    are roots of l^2 + l + 1 mod r = x^4 - x^2 + 1). Checked on the
    generator."""
    s = pow(-3 % P, (P + 1) // 4, P)
    assert s * s % P == P - 3
    F, g = oracle._FpOps, oracle.BLS_G1
    x2g = oracle._ec_affine(F, oracle._ec_mul(F, oracle.BLS_X ** 2, oracle._ec_from_affine(g)))
    minus = (x2g[0], P - x2g[1])
    half = pow(2, -1, P)
    beta = next(b for b in ((s - 1) * half % P, (-s - 1) * half % P)
                if (b * g[0] % P, g[1]) == minus)
    assert pow(beta, 3, P) == 1 != beta
    return beta


def constants_table() -> np.ndarray:
    """The kernels' constant table (csrc/fp381.cuh K_*), every value from
    the oracle: field constants in Montgomery form, exponents and scalars as
    raw little-endian words, the exponents' bit lengths, R^3, the base-x
    digits of cofactor_c(), the psi constants, g1_beta() and x^2 with its
    bit length."""
    setup = oracle._bls_setup()

    def m(x):  # Montgomery words
        return _words(x % P * R32 % P)

    def m2(c):
        return m(c[0]) + m(c[1])

    exps = [P - 2, (P + 1) // 4, (P - 3) // 4, (P - 1) // 2, oracle.BLS_R, setup["h2"],
            -oracle.BLS_X]
    nwords = [12, 12, 12, 12, 8, 16, 2]
    t: list[int] = []
    t += _words(P)                                   # K_P = 0
    t += m(1)                                        # K_ONE = 12
    t += _words(R32 * R32 % P)                       # K_R2 = 24
    t += _words((P - 1) // 2)                        # K_HALF = 36
    t += [(-pow(P, -1, 1 << 32)) % (1 << 32)] + [0] * 11  # K_N0 = 48
    t += m(4)                                        # K_B1 = 60
    t += m(P - 1)                                    # K_MINUS1 = 72
    t += m2(oracle._B2)                              # K_B2 = 84
    t += m(oracle._NEG_G1[0]) + m(oracle._NEG_G1[1])  # K_NEG_G1 = 108
    t += m2(oracle._XI_INV)                          # K_XI_INV = 132
    for c in setup["svdw"]:                          # K_SVDW = 156
        t += m2(c)
    for n in (1, 2):                                 # K_FROB1 = 276, K_FROB2 = 420
        for g in tower.frob_gammas(n):
            t += m2(g)
    for e, nw in zip(exps, nwords):                  # K_E_PM2 = 564 ...
        assert e.bit_length() <= 32 * nw
        t += [(e >> (32 * i)) & 0xFFFFFFFF for i in range(nw)]
    t += [e.bit_length() for e in exps]              # K_NBITS = 638
    t += _words(R32 ** 3 % P)                        # K_R3 = 645
    digits = gls_digits(cofactor_c())
    assert len(digits) == GLS_DIGITS and max(digits) < 1 << 64 and digits[-1] == 1
    for d in digits:                                 # K_GLS = 657
        t += [d & 0xFFFFFFFF, d >> 32]
    for k in psi_constants():                        # K_PSI = 667
        t += m2(k)
    t += m(g1_beta())                                # K_BETA = 715
    x2 = oracle.BLS_X ** 2                           # K_X2 = 727
    t += [(x2 >> (32 * i)) & 0xFFFFFFFF for i in range(4)] + [x2.bit_length()]
    assert len(t) == NK
    return np.asarray(t, dtype=np.uint32)


# ------------------------------------------------------------ plain versions


def _split(planes: torch.Tensor, g: int):
    """Affine planes of group g -> (x, y) as plain Fp (g = 1) or Fp2 (g = 2)
    tensors."""
    planes = _from_words(planes)
    n = fp.NLIMBS * g
    x, y = planes[:n], planes[n:2 * n]
    if g == 2:
        x, y = x.unflatten(0, (2, fp.NLIMBS)), y.unflatten(0, (2, fp.NLIMBS))
    return x, y


def _join(*coords: torch.Tensor) -> torch.Tensor:
    """Plain coordinates -> planes."""
    return _to_words(torch.cat([c.reshape(-1, c.shape[-1]) for c in coords]))


def _field(g: int):
    return pts.G1Field if g == 1 else pts.G2Field


def decompress_plain(g: int, x_raw: torch.Tensor, sign: torch.Tensor, check_subgroup: bool):
    """B1's plain version: (ok (B,) int32, affine planes (2 g rows, B))."""
    if g == 1:
        ok, p = pts.g1_decompress(x_raw, sign)
    else:
        ok, p = pts.g2_decompress(x_raw[0], x_raw[1], sign)
    if check_subgroup:
        ok = ok & pts.in_subgroup(_field(g), p)
    return ok.to(torch.int32), _join(p.x, p.y)


def hash_to_g2_plain(u: torch.Tensor):
    """B2's plain version: u (4, 35, B) raw -> (affine planes (4 rows, B),
    is_identity (B,) int32)."""
    um = fp.to_mont(u).unflatten(0, (2, 2))
    x, y, ident = pts.to_affine(pts.G2Field, htc.map_to_g2(um[0], um[1]))
    return _join(x, y), ident.to(torch.int32)


def _groups(order: torch.Tensor, starts: torch.Tensor, n: int):
    """(G, K) lane indices of each group, padded with n (the identity lane
    appended by the caller)."""
    st = starts.cpu().tolist()
    idx = order.cpu().tolist()
    width = max([b - a for a, b in zip(st, st[1:])] + [1])
    out = np.full((len(st) - 1, width), n, dtype=np.int64)
    for gi, (a, b) in enumerate(zip(st, st[1:])):
        out[gi, :b - a] = idx[a:b]
    return torch.from_numpy(out).to(order.device)


def point_sum_plain(g: int, planes: torch.Tensor, order: torch.Tensor, starts: torch.Tensor,
                    check_subgroup: bool):
    """B3's plain version: the affine planes' lanes summed by group (a
    halving tree over each group's lanes, padded with the identity) ->
    (affine planes of the sums (2 g rows, G), is_identity (G,) int32,
    subgroup ok (G,) int32, 1 without check_subgroup)."""
    F = _field(g)
    x, y = _split(planes, g)
    p = pts.from_affine(F, x, y)
    ident = pts.identity_like(F, p.y[..., :1])
    n = planes.shape[-1]
    p = pts.Point(*(torch.cat([a, b], -1) for a, b in zip(p, ident)))
    sel = _groups(order, starts, n)  # (G, K)
    ngroups, k = sel.shape
    flat = sel.T.reshape(-1)  # lane k * G + gi
    p = pts.Point(*(a[..., flat] for a in p))
    while k > 1:
        half = (k + 1) // 2
        lo = pts.Point(*(a[..., :half * ngroups] for a in p))
        hi = pts.Point(*(a[..., half * ngroups:] for a in p))
        if k % 2:
            pad = pts.identity_like(F, p.y[..., :ngroups])
            hi = pts.Point(*(torch.cat([a, b], -1) for a, b in zip(hi, pad)))
        p = pts.add(F, lo, hi)
        k = half
    sx, sy, ident = pts.to_affine(F, p)
    sub = (pts.in_subgroup(F, p) if check_subgroup
           else torch.ones_like(ident)).to(torch.int32)
    return _join(sx, sy), ident.to(torch.int32), sub


def miller_plain(p_planes: torch.Tensor, q_planes: torch.Tensor) -> torch.Tensor:
    """B4's plain version: (2 rows, L) G1 and (4 rows, L) twist affine
    planes -> (12 rows, L) Miller values."""
    px, py = _split(p_planes, 1)
    qx, qy = _split(q_planes, 2)
    return _join(pairing.miller_loop(px, py, qx, qy))


def final_exp_plain(f_planes: torch.Tensor, lanes: torch.Tensor, starts: torch.Tensor,
                    gate_a=None, gate_b=None, force=None):
    """B5's plain version: check c multiplies the Miller values of
    lanes[starts[c]:starts[c+1]] (a halving tree, padded with one), takes the
    final exponentiation and compares with one, and-ed with the gates and
    forced true by `force`. -> (ok (C,) int32, values (12 rows, C), all-ok
    (1,) int32)."""
    L = f_planes.shape[-1]
    f = _from_words(f_planes).reshape(2, 3, 2, fp.NLIMBS, L)
    f = torch.cat([f, tower.f12_one_like(f[..., :1])], -1)
    sel = _groups(lanes, starts, L)
    ngroups, k = sel.shape
    f = f[..., sel.T.reshape(-1)]
    while k > 1:
        half = (k + 1) // 2
        lo, hi = f[..., :half * ngroups], f[..., half * ngroups:]
        if k % 2:
            hi = torch.cat([hi, tower.f12_one_like(f[..., :ngroups])], -1)
        f = tower.f12_mul(lo, hi)
        k = half
    e = pairing.final_exp(f)
    ok = tower.f12_eq_one(e)
    for gate in (gate_a, gate_b):
        if gate is not None:
            ok = ok & (gate != 0)
    if force is not None:
        ok = ok | (force != 0)
    return ok.to(torch.int32), _join(e), ok.all().reshape(1).to(torch.int32)


# ------------------------------------------------------------------ kernels

_lib_lock = threading.Lock()
_lib_cache: list = []
_ready: set = set()


def _lib(dev: torch.device) -> ctypes.CDLL:
    with _lib_lock:
        if not _lib_cache:
            lib = _build.library("bls12381")
            vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            lib.bls_set_constants.argtypes = [vp, ci]
            pi = ctypes.POINTER(ci)
            lib.bls_decompress.argtypes = [ci, vp, vp, ci, ci, vp, vp, vp, ci, pi]
            lib.bls_hash_to_g2.argtypes = [vp, ci, vp, vp, vp]
            lib.bls_point_sum.argtypes = [ci, vp, ll, vp, vp, ci, ci, vp, vp, vp, vp, ci, vp, pi]
            lib.bls_point_sum_slices.argtypes = [ll, ci, ci]
            lib.bls_miller.argtypes = [vp, vp, ci, vp, vp, ci, pi]
            lib.bls_final_exp.argtypes = [vp, ci, vp, vp, ci, vp, vp, vp, vp, vp, vp, vp]
            lib.bls_launch_shape.argtypes = [ci, ci, ci, ci, ctypes.POINTER(ci)]
            for fn in (lib.bls_set_constants, lib.bls_decompress, lib.bls_hash_to_g2,
                       lib.bls_point_sum, lib.bls_point_sum_slices, lib.bls_miller,
                       lib.bls_final_exp, lib.bls_launch_shape):
                fn.restype = ci
            _lib_cache.append(lib)
        lib = _lib_cache[0]
        key = dev.index if dev.index is not None else torch.cuda.current_device()
        if key not in _ready:
            table = constants_table()
            with _build.on_device(dev):
                err = lib.bls_set_constants(table.ctypes.data, table.size)
            if err:
                raise RuntimeError(f"bls_set_constants failed: cudaError_t {err}")
            _ready.add(key)
        return lib


def _check(name: str, t: torch.Tensor, dev: torch.device, shape: tuple | None = None) -> None:
    if t.device != dev or t.dtype != torch.int32 or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous int32 tensor on {dev}, got {t.dtype} "
                         f"on {t.device}")
    if shape is not None and tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")


def _launch(entry: str, dev: torch.device, call, kernels: dict[int, str] | None = None) -> None:
    """call(lib, stream) launches; with `kernels` (the count of each of the
    entry's kernels by the number the entry reports) it also takes a
    pointer to an int that the entry sets to the kernel it ran."""
    used = ctypes.c_int(0)
    with _build.on_device(dev):
        lib, stream = _lib(dev), _build.raw_stream(dev)
        err = call(lib, stream, ctypes.byref(used)) if kernels else call(lib, stream)
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: cudaError_t {err}")
    LAUNCHES[entry] += 1
    if kernels:
        LAUNCHES[kernels[used.value]] += 1


def _route(t: torch.Tensor) -> bool:
    """True: launch the kernel (a CUDA tensor); False: the plain version (a
    CPU tensor). Anything else raises."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}")
    return True


def _ptr(t):
    return None if t is None else t.data_ptr()


# the entries' kernel argument by name
_B1_KERNELS = {None: 0, "trio": 1, "lane": 2}
_B3_KERNELS = {None: 0, "short": 1, "split": 2}
_B4_KERNELS = {None: 0, "sextet": 1, "lane": 2, "half": 3}


def _kernel(kernel: str | None, names: dict) -> int:
    if kernel not in names:
        raise ValueError(f"kernel must be one of {list(names)}, got {kernel!r}")
    return names[kernel]


def decompress(g: int, x_raw: torch.Tensor, sign: torch.Tensor, check_subgroup: bool,
               kernel: str | None = None):
    """B1: g = 1, x_raw (35, B); g = 2, x_raw (2, 35, B) [c0, c1]; sign (B,)
    int32 -> (ok (B,) int32, affine planes (2 g rows, B)). kernel: None (the
    crossover's), "trio" (a trio of threads a lane) or "lane" (one lane a
    thread)."""
    mode = _kernel(kernel, _B1_KERNELS)
    if not _route(x_raw):
        return decompress_plain(g, x_raw, sign, check_subgroup)
    dev = x_raw.device
    b = x_raw.shape[-1]
    _check("x_raw", x_raw, dev, (fp.NLIMBS, b) if g == 1 else (2, fp.NLIMBS, b))
    _check("sign", sign, dev, (b,))
    ok = torch.empty(b, dtype=torch.int32, device=dev)
    out = torch.empty(2 * g * NW, b, dtype=torch.int32, device=dev)
    def call(lib, s, lane):
        return lib.bls_decompress(g, x_raw.data_ptr(), sign.data_ptr(), int(check_subgroup), b,
                                  out.data_ptr(), ok.data_ptr(), s, mode, lane)
    _launch(ENTRIES[g - 1], dev, call,
            {0: f"bls_decompress_g{g}_trio", 1: f"bls_decompress_g{g}_lane"})
    return ok, out


def hash_to_g2(u: torch.Tensor):
    """B2: u (4, 35, B) raw [u0.c0, u0.c1, u1.c0, u1.c1] -> (affine planes
    (4 rows, B), is_identity (B,) int32)."""
    if not _route(u):
        return hash_to_g2_plain(u)
    dev = u.device
    b = u.shape[-1]
    _check("u", u, dev, (4, fp.NLIMBS, b))
    out = torch.empty(4 * NW, b, dtype=torch.int32, device=dev)
    ident = torch.empty(b, dtype=torch.int32, device=dev)
    _launch("bls_hash_to_g2", dev, lambda lib, s: lib.bls_hash_to_g2(
        u.data_ptr(), b, out.data_ptr(), ident.data_ptr(), s))
    return out, ident


def point_sum(g: int, planes: torch.Tensor, order: torch.Tensor, starts: torch.Tensor,
              check_subgroup: bool, kernel: str | None = None):
    """B3: affine planes (2 g rows, N), order (M,) int32 lane indices with
    each group's lanes together, starts (G + 1,) int32 group bounds in order
    -> (affine planes of the G sums, is_identity (G,) int32, subgroup ok
    (G,) int32). kernel: None (the crossover's: wide groups split over
    blocks, then a block a group), "short" (a block a group alone) or
    "split" (both phases)."""
    mode = _kernel(kernel, _B3_KERNELS)
    if not _route(planes):
        return point_sum_plain(g, planes, order, starts, check_subgroup)
    dev = planes.device
    n = planes.shape[-1]
    ngroups = starts.shape[0] - 1
    _check("planes", planes, dev, (2 * g * NW, n))
    _check("order", order, dev)
    _check("starts", starts, dev)
    if ngroups < 1:
        raise ValueError("point_sum needs at least one group")
    out = torch.empty(2 * g * NW, ngroups, dtype=torch.int32, device=dev)
    ident = torch.empty(ngroups, dtype=torch.int32, device=dev)
    sub = torch.empty(ngroups, dtype=torch.int32, device=dev)
    with _build.on_device(dev):
        slices = _lib(dev).bls_point_sum_slices(order.shape[0], ngroups, mode)
    # phase 1's partials, projective (x, y, z), one column a slice
    parts = (torch.empty(3 * g * NW, ngroups * slices, dtype=torch.int32, device=dev)
             if slices > 1 else None)
    _launch(ENTRIES[2 + g], dev, lambda lib, s, split: lib.bls_point_sum(
        g, planes.data_ptr(), n, order.data_ptr(), starts.data_ptr(), ngroups,
        int(check_subgroup), out.data_ptr(), ident.data_ptr(), sub.data_ptr(), s, slices,
        _ptr(parts), split),
        {0: f"bls_point_sum_g{g}_short", 1: f"bls_point_sum_g{g}_split"})
    return out, ident, sub


def miller(p_planes: torch.Tensor, q_planes: torch.Tensor, kernel: str | None = None
           ) -> torch.Tensor:
    """B4: (2 rows, L) affine G1 and (4 rows, L) affine twist planes ->
    (12 rows, L) Miller values. kernel: None (the crossovers'), "half" (a
    half-warp a pair), "sextet" or "lane" (one pair a thread)."""
    mode = _kernel(kernel, _B4_KERNELS)
    if not _route(p_planes):
        return miller_plain(p_planes, q_planes)
    dev = p_planes.device
    n = p_planes.shape[-1]
    _check("p", p_planes, dev, (2 * NW, n))
    _check("q", q_planes, dev, (4 * NW, n))
    f = torch.empty(12 * NW, n, dtype=torch.int32, device=dev)
    _launch("bls_miller", dev, lambda lib, s, lane: lib.bls_miller(
        p_planes.data_ptr(), q_planes.data_ptr(), n, f.data_ptr(), s, mode, lane),
        {1: "bls_miller_sextet", 2: "bls_miller_lane", 3: "bls_miller_half"})
    return f


def final_exp(f_planes: torch.Tensor, lanes: torch.Tensor, starts: torch.Tensor,
              gate_a: torch.Tensor | None = None, gate_b: torch.Tensor | None = None,
              force: torch.Tensor | None = None):
    """B5: Miller values (12 rows, L), lanes (M,) and starts (C + 1,) int32,
    optional (C,) int32 gates and force -> (ok (C,) int32, values (12 rows,
    C), all-ok (1,) int32)."""
    if not _route(f_planes):
        return final_exp_plain(f_planes, lanes, starts, gate_a, gate_b, force)
    dev = f_planes.device
    n = f_planes.shape[-1]
    c = starts.shape[0] - 1
    _check("f", f_planes, dev, (12 * NW, n))
    _check("lanes", lanes, dev)
    _check("starts", starts, dev)
    for name, t in (("gate_a", gate_a), ("gate_b", gate_b), ("force", force)):
        if t is not None:
            _check(name, t, dev, (c,))
    if c < 1:
        raise ValueError("final_exp needs at least one check")
    ok = torch.empty(c, dtype=torch.int32, device=dev)
    e = torch.empty(12 * NW, c, dtype=torch.int32, device=dev)
    allok = torch.ones(1, dtype=torch.int32, device=dev)
    _launch("bls_final_exp", dev, lambda lib, s: lib.bls_final_exp(
        f_planes.data_ptr(), n, lanes.data_ptr(), starts.data_ptr(), c, _ptr(gate_a),
        _ptr(gate_b), _ptr(force), e.data_ptr(), ok.data_ptr(), allok.data_ptr(), s))
    return ok, e, allok


def launch_shape(entry: str, n: int, dev: torch.device, values: int | None = None,
                 check_subgroup: bool = True, kernel: str | None = None) -> dict[str, int]:
    """How `entry` launches over n lanes (groups for B3, with `values` points
    in all, checks for B5, with `values` Miller values in all; n by default;
    B1 with `check_subgroup`) on CUDA device `dev`, with `kernel` as B1, B3
    and B4 take it: threads per block, blocks, resident blocks per SM,
    SMs, waves, local memory per thread, registers, static shared memory,
    B5's sextets a check (0 where none), whether an entry with a group
    kernel (B1, B2, B4, B5) takes its one-lane kernel instead, the
    threads a lane (1, 3, 6 or 16); for B3 its slices a group (1: a block a
    group alone) and phase 1's blocks, registers and local memory a thread
    (0 without phase 1; the fields before are the block-a-group kernel's).
    Launches nothing."""
    e = ENTRIES.index(entry)
    v = int(check_subgroup) if e < 2 else n if values is None else values
    out = (ctypes.c_int * 14)()
    with _build.on_device(dev):
        k = _kernel(kernel, {0: _B1_KERNELS, 1: _B1_KERNELS, 3: _B3_KERNELS, 4: _B3_KERNELS,
                             5: _B4_KERNELS}.get(e, {None: 0}))
        err = _lib(dev).bls_launch_shape(e, n, v, k, out)
    if err != 0:
        raise RuntimeError(f"bls launch shape failed: cudaError_t {err}")
    (threads, blocks, per_sm, sms, local_bytes, registers, shared, trios, lane, group, slices,
     part_blocks, part_registers, part_local) = out
    return {"threads_per_block": threads, "blocks": blocks, "blocks_per_sm": per_sm,
            "sms": sms, "waves": -(-blocks // max(1, per_sm * sms)), "local_bytes": local_bytes,
            "registers": registers, "shared_bytes": shared, "trios_per_check": trios,
            "lane_kernel": lane, "group_threads": group, "slices": slices,
            "part_blocks": part_blocks, "part_registers": part_registers,
            "part_local_bytes": part_local}
