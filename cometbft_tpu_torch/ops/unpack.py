"""Unpacking of wire-format words into limbs and window digits — the plain
version of the verify kernel's prologue.

Point encodings and scalars arrive as (8, B) packed little-endian 32-bit
words. torch has no shift, add or compare for ``torch.uint32`` on the CPU,
so the words travel as int32 tensors holding the same bits; these
functions widen them to int64 masked to 32 bits, where every shift is
logical.
"""

from __future__ import annotations

import torch

from cometbft_tpu_torch.ops import limbs as L

WORDS = 8  # 32 bytes = 8 little-endian 32-bit words

# Scalars are < L < 2^253: digit 50 covers bits 250..254, of which 253/254
# are zero, so its raw value is <= 7 and even with a carry (+1) stays < 16 —
# the signed recoding never carries out of digit 50. Hence 51 digits.
NDIGITS5 = 51


def _u32(w: torch.Tensor) -> torch.Tensor:
    """int32 words with the wire bits -> int64 in [0, 2^32)."""
    return w.to(torch.int64) & 0xFFFFFFFF


def _bits(w64: torch.Tensor, bit: int, width: int) -> torch.Tensor:
    """(B,) int64: bits [bit, bit + width) of the 256-bit little-endian
    value in w64 (8, B), zero beyond bit 255."""
    wi, off = bit // 32, bit % 32
    if wi >= WORDS:
        return torch.zeros_like(w64[0])
    v = w64[wi] >> off
    if off > 32 - width and wi + 1 < WORDS:
        v = v | (w64[wi + 1] << (32 - off))
    return v & ((1 << width) - 1)


def words_to_y_limbs(w: torch.Tensor) -> torch.Tensor:
    """(8, B) int32 point encodings -> (20, B) int32 y limbs (low 255 bits,
    canonical 13-bit limbs; limb 19 holds bits 247..254). The sign bit (bit
    255) is excluded — see words_sign."""
    w64 = _u32(w)
    out = []
    for i in range(L.NLIMBS):
        width = 8 if i == L.NLIMBS - 1 else L.RADIX
        out.append(_bits(w64, L.RADIX * i, width))
    return torch.stack(out, dim=0).to(torch.int32)


def words_sign(w: torch.Tensor) -> torch.Tensor:
    """(8, B) int32 -> (B,) int32 sign bit (bit 255)."""
    return (_u32(w)[WORDS - 1] >> 31).to(torch.int32)


def words_to_digits5_signed(w: torch.Tensor) -> torch.Tensor:
    """(8, B) int32 scalar words -> (51, B) int32 signed 5-bit window digits
    in [-16, 15], little-endian: scalar = sum d_j * 32^j. A raw digit >= 16
    becomes d - 32 and carries 1 into the next digit; the carry ripples
    through the 51 digits in order."""
    w64 = _u32(w)
    carry = torch.zeros_like(w64[0])
    out = []
    for j in range(NDIGITS5):
        d = _bits(w64, 5 * j, 5) + carry
        carry = (d >= 16).to(torch.int64)
        out.append(d - 32 * carry)
    return torch.stack(out, dim=0).to(torch.int32)
