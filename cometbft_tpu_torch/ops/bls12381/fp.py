"""The BLS12-381 base field in plain PyTorch: the port's copy of
cometbft_tpu/ops/bls12381/fp.py, limb for limb.

Representation: radix-2^11, 35 int32 limbs (385 bits), little-endian, limb
axis second to last, lane axis last: an Fp batch is (..., 35, B). The prime
is not pseudo-Mersenne, so reduction is Montgomery with R = 2^385: every
stored element is in the Montgomery domain, and mul() is a schoolbook limb
convolution followed by a convolution-form REDC.

Invariant ("carried"): limbs in [0, ~2^12), the value redundant mod p. The
2^385 overflow of carries folds back through the constant R mod p; a
residual top carry of 1 can persist across rounds, so the bound is 2^12.
canon() gives the unique representative for comparisons; from_mont() leaves
the Montgomery domain.

int32 safety (radix 11 is the headroom choice):
  conv columns:     <= 35 * (2^12)^2            ~= 5.9e8
  REDC m*N columns: <= 35 * 2047^2              ~= 1.5e8
  worst REDC col:   conv + m*N + carries        <  7.5e8  <  2^31

Constants live on the device of the operand they meet (_const).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from cometbft_tpu_torch.crypto import bls12381_math as _oracle

P_INT = _oracle.BLS_P
RADIX = 11
NLIMBS = 35
MASK = (1 << RADIX) - 1
R_INT = 1 << (RADIX * NLIMBS)  # 2^385, the Montgomery radix
R_MOD_P = R_INT % P_INT
R2_MOD_P = R_INT * R_INT % P_INT
# subtraction bias: a multiple of p dominating any carried value (value <
# 2^387); its top limb overflows 11 bits by design
M_SUB_INT = P_INT * (-(-(1 << 388) // P_INT))
# bias of the fused a - b - c (dominates two carried operands)
M_SUB2_INT = P_INT * (-(-(1 << 389) // P_INT))
# the full-width Montgomery constant N' = -p^-1 mod 2^385
NPRIME_INT = (-pow(P_INT, -1, R_INT)) % R_INT
assert R_MOD_P & MASK, "_carry_fold's folded constant needs limb 0 of R mod p non-zero"
_P_DIGITS = [(P_INT >> (RADIX * i)) & MASK for i in range(NLIMBS)]
_HALF_DIGITS = [(((P_INT - 1) // 2) >> (RADIX * i)) & MASK for i in range(NLIMBS)]
# the product columns of larger operands are formed in pieces of this many
# int32 elements (the skewed (35, 71) product block of each lane)
_CONV_CHUNK = 1 << 26


def int_to_limbs(x: int) -> np.ndarray:
    out = np.zeros(NLIMBS, dtype=np.int64)
    for i in range(NLIMBS - 1):
        out[i] = x & MASK
        x >>= RADIX
    out[NLIMBS - 1] = x
    assert x < 2**17, "constant too large for the loose top limb"
    return out.astype(np.int32)


def ints_to_limbs(xs) -> np.ndarray:
    """list[int] -> (35, B) int32 canonical limbs."""
    out = np.zeros((NLIMBS, len(xs)), dtype=np.int32)
    for j, x in enumerate(xs):
        for i in range(NLIMBS):
            out[i, j] = x & MASK
            x >>= RADIX
    return out


def limbs_to_ints(a) -> list[int]:
    """(35, B) limbs (any carried representation) -> list[int] values."""
    a = np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a, dtype=object)
    out = []
    for j in range(a.shape[1]):
        v = 0
        for i in range(NLIMBS - 1, -1, -1):
            v = (v << RADIX) + int(a[i, j])
        out.append(v)
    return out


_consts: dict[tuple[int, torch.device], torch.Tensor] = {}


def _const(x: int, like: torch.Tensor) -> torch.Tensor:
    """The (35, 1) int32 limbs of the integer x on `like`'s device."""
    key = (x, like.device)
    t = _consts.get(key)
    if t is None:
        t = _consts[key] = torch.from_numpy(int_to_limbs(x)[:, None]).to(like.device)
    return t


def from_ints(xs, device=None) -> torch.Tensor:
    """Field values (ints) -> (35, B) Montgomery limbs on `device`."""
    return torch.from_numpy(ints_to_limbs([x % P_INT * R_MOD_P % P_INT for x in xs])).to(device)


def to_ints(a: torch.Tensor) -> list[int]:
    """(35, B) Montgomery limbs -> canonical field values."""
    rinv = pow(R_INT, -1, P_INT)
    return [v * rinv % P_INT for v in limbs_to_ints(a)]


def const_like(x: int, like: torch.Tensor) -> torch.Tensor:
    """The field constant x (an int) in the Montgomery domain, broadcast to
    `like`'s shape."""
    return _const(x % P_INT * R_MOD_P % P_INT, like).expand_as(like)


def one_like(a: torch.Tensor) -> torch.Tensor:
    return _const(R_MOD_P, a).expand_as(a)


# 0-dim operands: cheaper per op than Python ints
_RADIX_T = torch.tensor(RADIX, dtype=torch.int32)
_MASK_T = torch.tensor(MASK, dtype=torch.int32)


def _shift_up(c: torch.Tensor) -> torch.Tensor:
    """cat([0, c[:-1]]) on the limb axis."""
    return F.pad(c.narrow(-2, 0, c.shape[-2] - 1), (0, 0, 1, 0))


def _carry_fold(x: torch.Tensor, rounds: int = 2) -> torch.Tensor:
    """Carry rounds with the 2^385 overflow folded back via R mod p (the
    whole 35-limb constant: a top carry re-enters as c * (R mod p)). The
    shift of the carries is a roll, which brings the top carry to limb 0;
    the folded constant is R mod p less that 1."""
    fold = _const(R_MOD_P - 1, x)
    for _ in range(rounds):
        c = x >> _RADIX_T
        x = (x & _MASK_T) + c.roll(1, -2) + c.narrow(-2, NLIMBS - 1, 1) * fold
    return x


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _carry_fold(a + b, rounds=2)


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _carry_fold(a + _const(M_SUB_INT, a) - b, rounds=3)


def neg(a: torch.Tensor) -> torch.Tensor:
    return _carry_fold(_const(M_SUB_INT, a) - a, rounds=3)


def sub2(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a - b - c in one carry chain (tower-mul glue)."""
    return _carry_fold(a + _const(M_SUB2_INT, a) - b - c, rounds=3)


def _conv(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., 35, B) x (..., 35, B) -> (..., 70, B) schoolbook product
    columns. The (35, 35) limb products of a lane are laid out in rows of
    71 and read back as rows of 70, which shifts row i by i, so that one
    sum over the rows gives every column; large operands go in pieces of
    lanes."""
    a, b = torch.broadcast_tensors(a, b)
    lanes = a.shape[-1]
    if a.numel() * 2 * NLIMBS > _CONV_CHUNK and lanes > 1:
        k = max(1, lanes * _CONV_CHUNK // (a.numel() * 2 * NLIMBS))
        return torch.cat([_conv(x, y) for x, y in zip(a.split(k, -1), b.split(k, -1))], -1)
    lead = a.shape[:-2]
    prod = a.unsqueeze(-2) * b.unsqueeze(-3)  # (..., i, j, B)
    skew = F.pad(prod, (0, 0, 0, NLIMBS + 1))  # (..., 35, 71, B)
    skew = skew.reshape(*lead, NLIMBS * (2 * NLIMBS + 1), lanes)[..., :2 * NLIMBS * NLIMBS, :]
    return skew.reshape(*lead, NLIMBS, 2 * NLIMBS, lanes).sum(-3, dtype=torch.int32)


_toeplitz: dict[tuple[int, torch.device], torch.Tensor] = {}


def _conv_const(a: torch.Tensor, x: int) -> torch.Tensor:
    """_conv(a, limbs of the constant x) through the constant's (35, 70, 1)
    Toeplitz block: row i holds the constant's limbs shifted by i."""
    key = (x, a.device)
    t = _toeplitz.get(key)
    if t is None:
        c = int_to_limbs(x)
        blk = np.zeros((NLIMBS, 2 * NLIMBS, 1), dtype=np.int32)
        for i in range(NLIMBS):
            blk[i, i:i + NLIMBS, 0] = c
        t = _toeplitz[key] = torch.from_numpy(blk).to(a.device)
    return (a.unsqueeze(-2) * t).sum(-3, dtype=torch.int32)


def _carry_nodrop(x: torch.Tensor, rounds: int, top_zero: bool = False) -> torch.Tensor:
    """Partial carry rounds on a column array, the top column's carry
    dropped: on the 35-limb m of _redc it is a multiple of 2^385. On the
    full-width columns (top_zero) the value bound leaves the top column
    below 2^11 (all limbs are non-negative), so its carry is zero and the
    shift may be a roll."""
    for _ in range(rounds):
        c = x >> _RADIX_T
        x = (x & _MASK_T) + (c.roll(1, -2) if top_zero else _shift_up(c))
    return x


def _redc(t: torch.Tensor) -> torch.Tensor:
    """Montgomery reduction in convolution form: m = (t mod R) * N' mod R,
    result = (t + m*p) / R. After the carries the low half's value is a
    multiple of 2^385 below 2 * 2^385, so the carry into the high half is
    any(low != 0)."""
    # one spill column: redundant inputs can push the product a hair past
    # 70 limbs; its carry must not drop
    t = F.pad(t, (0, 0, 0, 1))
    t = _carry_nodrop(t, 3, top_zero=True)
    m = _conv_const(t[..., :NLIMBS, :], NPRIME_INT)[..., :NLIMBS, :]
    m = _carry_nodrop(m, 3)
    mp = _conv_const(m, P_INT)
    t = t + F.pad(mp, (0, 0, 0, 1))
    t = _carry_nodrop(t, 3, top_zero=True)
    carry = (t[..., :NLIMBS, :] != 0).any(-2, keepdim=True).to(torch.int32)
    res = t[..., NLIMBS:2 * NLIMBS, :] + F.pad(carry, (0, 0, 0, NLIMBS - 1))
    # the spill column (weight 2^385 relative to res) folds via R mod p
    res = res + t[..., 2 * NLIMBS:, :] * _const(R_MOD_P, t)
    return _carry_fold(res, rounds=2)


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _redc(_conv(a, b))


def sq(a: torch.Tensor) -> torch.Tensor:
    return _redc(_conv(a, a))


def mul_small(a: torch.Tensor, k: int) -> torch.Tensor:
    """a * k for tiny non-Montgomery integers (k <= ~2^6): limb scaling."""
    return _carry_fold(a * k, rounds=2)


def to_mont(raw: torch.Tensor) -> torch.Tensor:
    """Raw integer limbs -> Montgomery domain (mont-mul by R^2)."""
    return mul(raw, _const(R2_MOD_P, raw))


def from_mont(a: torch.Tensor) -> torch.Tensor:
    """Montgomery -> raw integer limbs in [0, p), canonical."""
    return _canon_raw(mul(a, _const(1, a)))


def _cond_sub_p(x: torch.Tensor) -> torch.Tensor:
    """One conditional subtract of p with a sequential borrow sweep; input
    limbs canonical digits, value < 2p."""
    borrow = torch.zeros_like(x[..., 0, :])
    out = []
    for i in range(NLIMBS):
        v = x[..., i, :] - _P_DIGITS[i] - borrow
        borrow = (v < 0).to(torch.int32)
        out.append(v + (borrow << RADIX))
    return torch.where((borrow == 0).unsqueeze(-2), torch.stack(out, -2), x)


def _strict_carry(x: torch.Tensor) -> torch.Tensor:
    """Full sequential carry: limbs -> canonical digits (the value must be
    < 2^385 already)."""
    carry = torch.zeros_like(x[..., 0, :])
    out = []
    for i in range(NLIMBS):
        v = x[..., i, :] + carry
        out.append(v & MASK)
        carry = v >> RADIX
    return torch.stack(out, -2)


def _canon_raw(x: torch.Tensor) -> torch.Tensor:
    """Carried limbs, value < 3p -> canonical [0, p)."""
    x = _strict_carry(_carry_fold(x, rounds=2))
    return _cond_sub_p(_cond_sub_p(x))


def canon(a: torch.Tensor) -> torch.Tensor:
    """The canonical Montgomery representative in [0, p): a mont-mul by ONE
    tightens the value below ~2p before the conditional subtracts."""
    return _canon_raw(mul(a, _const(R_MOD_P, a)))


def is_zero(a: torch.Tensor) -> torch.Tensor:
    return (canon(a) == 0).all(-2)


def eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return is_zero(sub(a, b))


def select(m: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per lane: a where m (..., B) is true, else b."""
    return torch.where(m.unsqueeze(-2), a, b)


def bits_desc(e: int) -> list[int]:
    return [int(c) for c in bin(e)[2:]]


def pow_const(a: torch.Tensor, e: int) -> torch.Tensor:
    """a^e for a fixed public exponent, square-and-multiply MSB first."""
    acc = one_like(a)
    for bit in bits_desc(e):
        acc = sq(acc)
        if bit:
            acc = mul(acc, a)
    return acc


def inv(a: torch.Tensor) -> torch.Tensor:
    """Fermat inverse (inv(0) = 0)."""
    return pow_const(a, P_INT - 2)


def sqrt(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(ok (..., B), root): p = 3 mod 4, so the candidate is a^((p+1)/4); ok
    says a was a square."""
    r = pow_const(a, (P_INT + 1) // 4)
    return eq(sq(r), a), r


def sgn0(a: torch.Tensor) -> torch.Tensor:
    """Parity of the canonical integer value (RFC 9380 sgn0 for m = 1)."""
    return from_mont(a)[..., 0, :] & 1


def gt_half(raw: torch.Tensor) -> torch.Tensor:
    """Canonical raw limbs -> bool (..., B) of value > (p - 1) / 2, by a
    borrow sweep of (p - 1) / 2 - value."""
    borrow = torch.zeros_like(raw[..., 0, :])
    for i in range(NLIMBS):
        borrow = (_HALF_DIGITS[i] - raw[..., i, :] - borrow < 0).to(torch.int32)
    return borrow != 0


# ---- host packing -------------------------------------------------------


def bytes_be_to_limbs(rows: np.ndarray) -> np.ndarray:
    """(B, 48) uint8 big-endian field elements -> (35, B) int32 raw limbs:
    unpack to 384 LE bits, pad to 385, regroup by 11."""
    le = np.ascontiguousarray(rows[:, ::-1])
    bits = np.unpackbits(le, axis=1, bitorder="little")  # (B, 384)
    bits = np.concatenate([bits, np.zeros((rows.shape[0], 1), dtype=np.uint8)], axis=1)
    weights = (1 << np.arange(RADIX, dtype=np.int32))
    limbs = (bits.reshape(rows.shape[0], NLIMBS, RADIX)
             * weights[None, None, :]).sum(axis=2, dtype=np.int32)
    return np.ascontiguousarray(limbs.T)


def limbs_to_bytes_be(limbs: np.ndarray) -> np.ndarray:
    """(35, B) canonical raw limbs -> (B, 48) uint8 big-endian."""
    limbs = np.asarray(limbs).T.astype(np.int64)  # (B, 35)
    shifts = np.arange(RADIX, dtype=np.int64)
    bits = ((limbs[:, :, None] >> shifts[None, None, :]) & 1).astype(np.uint8)
    bits = bits.reshape(limbs.shape[0], NLIMBS * RADIX)[:, :384]
    le = np.packbits(bits, axis=1, bitorder="little")
    return np.ascontiguousarray(le[:, ::-1])
