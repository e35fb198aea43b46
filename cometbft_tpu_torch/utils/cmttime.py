"""Canonical time handling.

The reference canonicalizes all signed timestamps to UTC with monotonic clock
reading stripped (reference: types/canonical.go:84-90, libs/time). We carry
timestamps as (seconds, nanos) pairs — protobuf Timestamp semantics — because
Python datetimes cannot represent nanoseconds.

The port's copy of cometbft_tpu/utils/cmttime.py: Timestamp, the clock
reading now() and RFC 3339 formatting (the millisecond vote clock
canonical_now_ms comes with the node).
"""

from __future__ import annotations

import time as _time
from dataclasses import dataclass
from datetime import datetime, timezone


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
    def now(cls) -> "Timestamp":
        ns = _time.time_ns()
        return cls(ns // 1_000_000_000, ns % 1_000_000_000)

    @classmethod
    def zero(cls) -> "Timestamp":
        return cls(0, 0)

    def is_zero(self) -> bool:
        return self.seconds == 0 and self.nanos == 0

    def unix_ns(self) -> int:
        return self.seconds * 1_000_000_000 + self.nanos

    def add_ns(self, ns: int) -> "Timestamp":
        return Timestamp(0, self.unix_ns() + ns)

    def rfc3339(self) -> str:
        """RFC3339Nano formatting (reference TimeFormat, types/canonical.go:13)."""
        dt = datetime.fromtimestamp(self.seconds, tz=timezone.utc)
        base = dt.strftime("%Y-%m-%dT%H:%M:%S")
        if self.nanos:
            frac = f"{self.nanos:09d}".rstrip("0")
            return f"{base}.{frac}Z"
        return base + "Z"

    def __str__(self) -> str:
        return self.rfc3339()


def now() -> Timestamp:
    return Timestamp.now()
