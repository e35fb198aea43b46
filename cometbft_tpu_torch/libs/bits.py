"""BitArray (reference: libs/bits/bit_array.go).

Vote-presence maps and block-part masks. The reference guards with a mutex;
here all mutation happens on the event loop, so no lock — but the API mirrors
the reference (Sub, Or, Not, PickRandom, GetTrueIndices) including its
proto form (Bits size + little-endian uint64 elems → we use bytes).

The port's copy of cometbft_tpu/libs/bits.py.
"""

from __future__ import annotations

import random
from typing import Iterator, Optional


class BitArray:
    __slots__ = ("bits", "_elems")

    def __init__(self, bits: int):
        if bits < 0:
            raise ValueError("negative bit count")
        self.bits = bits
        self._elems = bytearray((bits + 7) // 8)

    @classmethod
    def from_bools(cls, bools: list[bool]) -> "BitArray":
        ba = cls(len(bools))
        for i, b in enumerate(bools):
            if b:
                ba.set_index(i, True)
        return ba

    @classmethod
    def from_bytes(cls, bits: int, data: bytes) -> "BitArray":
        ba = cls(bits)
        n = len(ba._elems)
        ba._elems[: min(n, len(data))] = data[:n]
        ba._mask_tail()
        return ba

    def _mask_tail(self) -> None:
        if self.bits % 8 and self._elems:
            self._elems[-1] &= (1 << (self.bits % 8)) - 1

    def size(self) -> int:
        return self.bits

    def get_index(self, i: int) -> bool:
        if i < 0 or i >= self.bits:
            return False
        return bool(self._elems[i // 8] >> (i % 8) & 1)

    def set_index(self, i: int, v: bool) -> bool:
        if i < 0 or i >= self.bits:
            return False
        if v:
            self._elems[i // 8] |= 1 << (i % 8)
        else:
            self._elems[i // 8] &= ~(1 << (i % 8)) & 0xFF
        return True

    def copy(self) -> "BitArray":
        ba = BitArray(self.bits)
        ba._elems = bytearray(self._elems)
        return ba

    def or_(self, other: "BitArray") -> "BitArray":
        """Union; result size = max (reference bit_array.go Or)."""
        big, small = (self, other) if self.bits >= other.bits else (other, self)
        out = big.copy()
        for i, b in enumerate(small._elems):
            out._elems[i] |= b
        out._mask_tail()
        return out

    def and_(self, other: "BitArray") -> "BitArray":
        bits = min(self.bits, other.bits)
        out = BitArray(bits)
        for i in range(len(out._elems)):
            out._elems[i] = self._elems[i] & other._elems[i]
        out._mask_tail()
        return out

    def not_(self) -> "BitArray":
        out = BitArray(self.bits)
        for i, b in enumerate(self._elems):
            out._elems[i] = ~b & 0xFF
        out._mask_tail()
        return out

    def sub(self, other: "BitArray") -> "BitArray":
        """Bits set in self but not in other (reference Sub semantics)."""
        out = self.copy()
        n = min(len(self._elems), len(other._elems))
        for i in range(n):
            out._elems[i] &= ~other._elems[i] & 0xFF
        out._mask_tail()
        return out

    def is_empty(self) -> bool:
        return not any(self._elems)

    def is_full(self) -> bool:
        if self.bits == 0:
            return True
        full, rem = divmod(self.bits, 8)
        if any(b != 0xFF for b in self._elems[:full]):
            return False
        if rem:
            return self._elems[full] == (1 << rem) - 1
        return True

    def pick_random(self, rng: Optional[random.Random] = None) -> tuple[int, bool]:
        """Random true index (reference PickRandom)."""
        trues = self.get_true_indices()
        if not trues:
            return 0, False
        return (rng or random).choice(trues), True

    def get_true_indices(self) -> list[int]:
        return [i for i in range(self.bits) if self.get_index(i)]

    def num_true(self) -> int:
        return sum(bin(b).count("1") for b in self._elems)

    def to_bytes(self) -> bytes:
        return bytes(self._elems)

    def or_update(self, other: "BitArray") -> None:
        """In-place union restricted to self's size. Used by vote-summary
        reconciliation: has-vote knowledge is monotonic, and mutating in
        place keeps any aliases (catchup_commit may BE precommits) in
        agreement where a rebinding union would silently fork them."""
        n = min(len(self._elems), len(other._elems))
        for i in range(n):
            self._elems[i] |= other._elems[i]
        self._mask_tail()

    def update(self, other: "BitArray") -> None:
        """Copy other's bits into self (sizes should match)."""
        n = min(len(self._elems), len(other._elems))
        self._elems[:n] = other._elems[:n]
        self._mask_tail()

    def __iter__(self) -> Iterator[bool]:
        for i in range(self.bits):
            yield self.get_index(i)

    def __eq__(self, other: object) -> bool:
        return (isinstance(other, BitArray) and self.bits == other.bits
                and self._elems == other._elems)

    def __str__(self) -> str:
        return "".join("x" if b else "_" for b in self)

    def __repr__(self) -> str:
        return f"BitArray{{{self}}}"
