"""GF(2^255 - 19) arithmetic on (20, B) int32 tensors — the plain version.

Representation (kept exactly as in the JAX package, so the carried-limb
interval proof of tests/test_field_intervals.py covers this module and the
CUDA kernel alike): radix-2^13, 20 limbs (260 bits), little-endian, int32,
LIMB-AXIS FIRST — a batch of field elements is shape (20, B). Every
intermediate of the 20x20 schoolbook product fits signed int32.

Invariant ("carried"): per-limb signed intervals, the least fixpoint of
{mul, sq, add, sub, neg} over their own outputs. Values are redundant mod p;
canonicalize() gives the unique representative in [0, p).

Integer arithmetic is exact, so any summation order gives the same limbs:
the plain product below sums the 400 limb products with one index_add_
where the kernels of csrc/curve25519.cuh run the same columns as a chain
of multiply-adds, and both produce identical carried limbs.

int32 ``>>`` is arithmetic in torch, as in JAX; the carry rounds rely on it
to floor negative intermediates from sub.
"""

from __future__ import annotations

import torch

from cometbft_tpu_torch.ops import limbs as L

RADIX = L.RADIX
NLIMBS = L.NLIMBS
MASK = L.MASK

P = 2**255 - 19
# 2^260 mod p = 2^5 * 19: the fold multiplier for carry-out of limb 19.
FOLD = 19 << (NLIMBS * RADIX - 255)  # 608

D_INT = (-121665 * pow(121666, P - 2, P)) % P
SQRT_M1_INT = pow(2, (P - 1) // 4, P)


def _loose_limbs(x: int) -> list[int]:
    """Limbs whose top limb may exceed 13 bits (the subtraction bias M = 33p
    is 261 bits)."""
    out = []
    for _ in range(NLIMBS - 1):
        out.append(x & MASK)
        x >>= RADIX
    out.append(x)
    return out


# name -> 20 limb values; the kernel's __constant__ tables hold the same.
CONST_LIMBS = {
    "P": [int(v) for v in L.int_to_limbs(P)],
    "D": [int(v) for v in L.int_to_limbs(D_INT)],
    "D2": [int(v) for v in L.int_to_limbs(2 * D_INT % P)],
    "SQRT_M1": [int(v) for v in L.int_to_limbs(SQRT_M1_INT)],
    "ONE": [int(v) for v in L.int_to_limbs(1)],
    # Subtraction bias: smallest multiple of p above any carried value
    # (carried max ~ 2^260 + 2^251 < 33p), keeping a + M - b positive.
    "M_SUB": _loose_limbs(33 * P),
}

_const_cache: dict[tuple[str, torch.device], torch.Tensor] = {}


def const(name: str, device: torch.device) -> torch.Tensor:
    """(20, 1) int32 constant on `device`, broadcast over the batch axis."""
    key = (name, device)
    t = _const_cache.get(key)
    if t is None:
        t = torch.tensor(CONST_LIMBS[name], dtype=torch.int32,
                         device=device)[:, None]
        _const_cache[key] = t
    return t


# Carry-round counts, proved sufficient by tests/test_field_intervals.py.
ADD_ROUNDS = 1
SUB_ROUNDS = 1
HI_ROUNDS = 1
CONV20_ROUNDS = 2


def _carry_round20(x: torch.Tensor) -> torch.Tensor:
    """One parallel carry round on 20 limbs with top wrap (2^260 = FOLD)."""
    c = x >> RADIX
    r = x & MASK
    return r + torch.cat([c[NLIMBS - 1:] * FOLD, c[: NLIMBS - 1]], dim=0)


def weak_carry(x: torch.Tensor) -> torch.Tensor:
    for _ in range(3):
        x = _carry_round20(x)
    return x


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    x = a + b
    for _ in range(ADD_ROUNDS):
        x = _carry_round20(x)
    return x


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    x = a + const("M_SUB", a.device) - b
    for _ in range(SUB_ROUNDS):
        x = _carry_round20(x)
    return x


def neg(a: torch.Tensor) -> torch.Tensor:
    x = const("M_SUB", a.device) - a
    for _ in range(SUB_ROUNDS):
        x = _carry_round20(x)
    return x


_NCONV = 2 * NLIMBS  # 39 product columns + 1 carry headroom column
_conv_index_cache: dict[torch.device, torch.Tensor] = {}


def _conv_index(device: torch.device) -> torch.Tensor:
    """Column i + j of limb product (i, j), flattened row-major."""
    idx = _conv_index_cache.get(device)
    if idx is None:
        i = torch.arange(NLIMBS)
        idx = (i[:, None] + i[None, :]).reshape(-1).to(device)
        _conv_index_cache[device] = idx
    return idx


def _conv(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Schoolbook polynomial product: (20, B) x (20, B) -> (40, B) columns,
    column 39 zero."""
    prod = (a[:, None] * b[None, :]).reshape((NLIMBS * NLIMBS,) + a.shape[1:])
    out = torch.zeros((_NCONV,) + a.shape[1:], dtype=a.dtype, device=a.device)
    return out.index_add_(0, _conv_index(a.device), prod)


def _carry_round20_nowrap(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One carry round WITHOUT the 2^260 wrap: (rounded, top carry (1, B))."""
    c = x >> RADIX
    r = x & MASK
    shifted = torch.cat([torch.zeros_like(c[:1]), c[: NLIMBS - 1]], dim=0)
    return r + shifted, c[NLIMBS - 1:]


def _conv_reduce(conv: torch.Tensor) -> torch.Tensor:
    """(40, B) product columns -> carried (20, B): carry the high half
    without wrap, fold it (weight 2^260 = FOLD) and its top carry (weight
    FOLD^2 at column 0) into the low half, then two wrapping rounds."""
    lo, hi = conv[:NLIMBS], conv[NLIMBS:]
    top = None
    for _ in range(HI_ROUNDS):
        hi, t = _carry_round20_nowrap(hi)
        top = t if top is None else top + t
    folded = lo + FOLD * hi
    folded = torch.cat([folded[:1] + (FOLD * FOLD) * top, folded[1:]], dim=0)
    for _ in range(CONV20_ROUNDS):
        folded = _carry_round20(folded)
    return folded


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _conv_reduce(_conv(a, b))


def sq(a: torch.Tensor) -> torch.Tensor:
    return _conv_reduce(_conv(a, a))


def _sqn(x: torch.Tensor, n: int) -> torch.Tensor:
    for _ in range(n):
        x = sq(x)
    return x


def pow22523(z: torch.Tensor) -> torch.Tensor:
    """z^((p-5)/8) = z^(2^252 - 3): the ref10 addition chain (254 squarings
    + 11 multiplies)."""
    z2 = sq(z)
    z9 = mul(_sqn(z2, 2), z)
    z11 = mul(z9, z2)
    z_5_0 = mul(sq(z11), z9)
    z_10_0 = mul(_sqn(z_5_0, 5), z_5_0)
    z_20_0 = mul(_sqn(z_10_0, 10), z_10_0)
    z_40_0 = mul(_sqn(z_20_0, 20), z_20_0)
    z_50_0 = mul(_sqn(z_40_0, 10), z_10_0)
    z_100_0 = mul(_sqn(z_50_0, 50), z_50_0)
    z_200_0 = mul(_sqn(z_100_0, 100), z_100_0)
    z_250_0 = mul(_sqn(z_200_0, 50), z_50_0)
    return mul(_sqn(z_250_0, 2), z)


def canonicalize(x: torch.Tensor) -> torch.Tensor:
    """Unique representative mod p, limbs canonical, value in [0, p)."""
    x = weak_carry(x)
    top_shift = 255 - (NLIMBS - 1) * RADIX  # bit 255 within limb 19
    top_mask = (1 << top_shift) - 1
    for _ in range(3):  # fold bits >= 255 (2^255 = 19 mod p) + re-carry
        hi = x[NLIMBS - 1] >> top_shift
        x = torch.cat([
            (x[0] + 19 * hi)[None],
            x[1: NLIMBS - 1],
            (x[NLIMBS - 1] & top_mask)[None],
        ], dim=0)
        x = _carry_round20(x)
    # A parallel round moves a carry one limb, and a carried multiple of p
    # (what sub() gives for equal inputs) can need a borrow to cross a run
    # of full limbs end to end: one serial pass makes every limb canonical.
    # (The JAX package's canonicalize has no such pass, and returns
    # non-canonical limbs of 0 for some multiples of p.)
    limbs = list(x.unbind(0))
    for i in range(NLIMBS - 1):
        limbs[i + 1] = limbs[i + 1] + (limbs[i] >> RADIX)
        limbs[i] = limbs[i] & MASK
    x = torch.stack(limbs, dim=0)
    # value now < 2^255 + eps < 2p: one conditional subtract of p, with a
    # serial borrow chain across the limbs.
    pl = CONST_LIMBS["P"]
    borrow = torch.zeros_like(x[0])
    sub_l = []
    for i in range(NLIMBS):
        v = x[i] - pl[i] - borrow
        borrow = (v < 0).to(torch.int32)
        sub_l.append(v + (borrow << RADIX))
    ge_p = borrow == 0
    return torch.where(ge_p[None], torch.stack(sub_l, dim=0), x)


def is_zero(x: torch.Tensor) -> torch.Tensor:
    """(20, B) -> (B,) bool: x == 0 mod p."""
    return (canonicalize(x) == 0).all(dim=0)


def parity(x: torch.Tensor) -> torch.Tensor:
    """(20, B) -> (B,) int32: the LSB of the canonical representative (the
    sign bit of a compressed encoding). Limb 0 of a carried value is not
    it: canonicalize first."""
    return canonicalize(x)[0] & 1
