"""Canonical time handling.

The reference canonicalizes all signed timestamps to UTC with monotonic clock
reading stripped (reference: types/canonical.go:84-90, libs/time). We carry
timestamps as (seconds, nanos) pairs — protobuf Timestamp semantics — because
Python datetimes cannot represent nanoseconds.

The port's copy of cometbft_tpu/utils/cmttime.py's Timestamp (the clock
readings and formatting are not ported: nothing in the port uses them).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True, order=True)
class Timestamp:
    """Nanosecond-precision UTC instant. nanos in [0, 1e9)."""

    seconds: int = 0
    nanos: int = 0

    def __post_init__(self) -> None:
        if not 0 <= self.nanos < 1_000_000_000:
            # normalize (frozen dataclass: use object.__setattr__)
            total = self.seconds * 1_000_000_000 + self.nanos
            object.__setattr__(self, "seconds", total // 1_000_000_000)
            object.__setattr__(self, "nanos", total % 1_000_000_000)

    @classmethod
    def zero(cls) -> "Timestamp":
        return cls(0, 0)

    def is_zero(self) -> bool:
        return self.seconds == 0 and self.nanos == 0
