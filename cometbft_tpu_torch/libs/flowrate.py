"""Flow-rate measurement and limiting.

Reference: libs/flowrate (token-bucket rate monitor used by MConnection to
throttle per-peer send/recv to config.SendRate/RecvRate,
p2p/conn/connection.go:44-45). asyncio-native: `limit()` returns the delay
to sleep before transferring n more bytes.

The port's copy of cometbft_tpu/libs/flowrate.py.
"""

from __future__ import annotations

import time


class Monitor:
    """Sliding-average rate monitor with an optional hard limit."""

    def __init__(self, rate_limit: int = 0, window: float = 1.0):
        self.rate_limit = rate_limit  # bytes/sec; 0 = unlimited
        self.window = window
        self.bytes_total = 0
        self.updates_total = 0
        self.peak_rate = 0.0  # highest completed-window average seen
        self._t0 = time.monotonic()
        self._window_start = self._t0
        self._window_bytes = 0
        self._avg_rate = 0.0

    def update(self, n: int) -> float:
        """Record n transferred bytes; return seconds the caller should
        sleep to stay under rate_limit (0.0 when unlimited/under budget).
        Accounting (bytes_total / rate / peak_rate) is recorded whether or
        not a limit is set — rate_limit=0 means non-throttling, never
        non-measuring."""
        now = time.monotonic()
        self.bytes_total += n
        self.updates_total += 1
        self._window_bytes += n
        elapsed = now - self._window_start
        if elapsed >= self.window:
            self._avg_rate = self._window_bytes / elapsed
            if self._avg_rate > self.peak_rate:
                self.peak_rate = self._avg_rate
            self._window_start = now
            self._window_bytes = 0
        if self.rate_limit <= 0:
            return 0.0
        # delay so that window_bytes/elapsed <= rate_limit
        min_elapsed = self._window_bytes / self.rate_limit
        return max(0.0, min_elapsed - elapsed)

    def rate(self) -> float:
        """Most recent windowed average rate (bytes/sec)."""
        elapsed = time.monotonic() - self._window_start
        if elapsed > 0.1:
            return self._window_bytes / elapsed
        return self._avg_rate

    def lifetime_rate(self) -> float:
        """bytes_total over the monitor's whole lifetime (bytes/sec)."""
        elapsed = time.monotonic() - self._t0
        return self.bytes_total / elapsed if elapsed > 0 else 0.0

    def stats(self) -> dict:
        """Snapshot for status()/telemetry consumers."""
        return {
            "bytes_total": self.bytes_total,
            "updates_total": self.updates_total,
            "rate_bytes_per_s": round(self.rate(), 1),
            "lifetime_rate_bytes_per_s": round(self.lifetime_rate(), 1),
            "peak_rate_bytes_per_s": round(self.peak_rate, 1),
            "rate_limit": self.rate_limit,
        }
