"""Node-wide overload resilience plane (no reference analog).

Every fault plane so far injects *failures* (device, network, disk);
this plane handles *saturation* — sustained admission traffic past what
the node can absorb. Before it, each subsystem shed by its own ad-hoc
rule (`ErrMempoolIsFull`, `FleetSaturated`, `SchedulerSaturated`) with
no shared view of pressure: the RPC plane would happily queue work for
a mempool that was already drowning, and a recheck storm after a big
block could starve admission for seconds.

The registry here is that shared view: each plane registers one cheap
utilization signal (a callable returning 0.0..1.0+, fraction of that
plane's capacity) that already exists —

  rpc      in-flight requests vs the per-route-class budgets
  mempool  txs/bytes vs the pool caps
  sched    verify-scheduler queue depth vs its queue limit
  events   event-bus subscriber lag vs queue capacity

— and the registry grades each into one of three watermark levels with
hysteresis, so every plane sheds by the SAME policy:

  normal     admit everything
  elevated   trim optional work (eager mempool expiry, gossip throttle,
             smaller batches) but admit
  saturated  shed MEMPOOL/LIGHT-class work at the door, BEFORE it costs
             an ABCI round-trip or a device batch; broadcast_tx_sync
             downgrades to async

CONSENSUS/SYNC-class work is never shed at any level — under overload
the chain keeps committing (bounded p99 height latency, zero consensus
flush deadline misses) while the planes around it degrade. That
liveness guarantee is graded end-to-end by the saturation soak
(`bench.py --soak`, tests/test_overload_soak.py).

Hysteresis: a level is entered when utilization crosses its watermark
and only left when utilization drops BELOW `watermark - hysteresis` —
a signal oscillating exactly at a boundary holds its level instead of
flapping (and re-flapping the shed policy) every sample.

Every shed is counted per plane both here (the `health()` snapshot
served by the `health` RPC route) and on /metrics
(`cometbft_overload_sheds_total{plane=...}`).

The port's copy of cometbft_tpu/libs/overload.py.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

# watermark levels (ordered: comparisons like `level >= ELEVATED` are
# the intended idiom)
NORMAL = 0
ELEVATED = 1
SATURATED = 2
LEVEL_NAMES = ("normal", "elevated", "saturated")

# the planes the node wires by default (tests may register others; the
# registry accepts any name — this tuple is documentation + the metrics
# pre-touch list so every plane's series exist before its first shed)
PLANES = ("rpc", "mempool", "sched", "events")

# default watermarks as utilization fractions: elevated at 60% of a
# plane's capacity, saturated at 90% (shedding at 90% full is the
# point — at 100% the ad-hoc "is_full" errors fire anyway, AFTER the
# work was paid for)
DEFAULT_ELEVATED = 0.60
DEFAULT_SATURATED = 0.90
DEFAULT_HYSTERESIS = 0.10

# retry-after hints handed to shed clients per level, in ms — rough
# "when might a slot open" guidance, not a promise
RETRY_AFTER_MS = {NORMAL: 0, ELEVATED: 100, SATURATED: 1000}


class OverloadRegistry:
    """Per-node pressure registry: watermark state machine + shed
    accounting. Thread-safe — the verify scheduler's worker thread and
    the asyncio planes sample it concurrently."""

    def __init__(
        self,
        elevated: float = DEFAULT_ELEVATED,
        saturated: float = DEFAULT_SATURATED,
        hysteresis: float = DEFAULT_HYSTERESIS,
        clock: Callable[[], float] = time.monotonic,
    ):
        if not 0.0 < elevated < saturated:
            raise ValueError("need 0 < elevated < saturated watermarks")
        if hysteresis < 0 or hysteresis >= elevated:
            raise ValueError("hysteresis must be in [0, elevated)")
        self.elevated = elevated
        self.saturated = saturated
        self.hysteresis = hysteresis
        self._clock = clock
        self._lock = threading.Lock()
        self._sources: dict[str, Callable[[], float]] = {}
        self._levels: dict[str, int] = {}
        self._sheds: dict[str, int] = {}
        self._transitions: dict[str, int] = {}
        self._last_util: dict[str, float] = {}
        self._since: dict[str, float] = {}

    # --------------------------------------------------------- wiring

    def register(self, plane: str, source: Callable[[], float]) -> None:
        """Attach a plane's utilization signal (idempotent: re-register
        replaces the source, keeping level/shed history)."""
        with self._lock:
            self._sources[plane] = source
            self._levels.setdefault(plane, NORMAL)
            self._sheds.setdefault(plane, 0)
            self._transitions.setdefault(plane, 0)
            self._since.setdefault(plane, self._clock())

    def unregister(self, plane: str) -> None:
        with self._lock:
            self._sources.pop(plane, None)

    def planes(self) -> list[str]:
        with self._lock:
            return sorted(self._levels)

    # -------------------------------------------------------- reading

    def utilization(self, plane: str) -> float:
        """Sample a plane's signal. A broken signal reads as 0.0 — the
        overload plane must never take a node down on its own."""
        with self._lock:
            src = self._sources.get(plane)
        if src is None:
            return 0.0
        try:
            return max(0.0, float(src()))
        except Exception:  # noqa: BLE001
            return 0.0

    def level(self, plane: str) -> int:
        """Current watermark level for a plane, advancing the hysteresis
        state machine on the fresh sample."""
        util = self.utilization(plane)
        with self._lock:
            cur = self._levels.get(plane, NORMAL)
            new = self._step(cur, util)
            self._last_util[plane] = util
            if new != cur:
                self._levels[plane] = new
                self._transitions[plane] = self._transitions.get(plane, 0) + 1
                self._since[plane] = self._clock()
                self._publish_level(plane, new, transition=True)
            else:
                self._levels.setdefault(plane, cur)
        return self._levels.get(plane, NORMAL)

    def _step(self, cur: int, util: float) -> int:
        """One hysteresis step: rise eagerly at a watermark, fall only
        past `watermark - hysteresis` below it."""
        if util >= self.saturated:
            return SATURATED
        if util >= self.elevated:
            # at/above elevated but below saturated: an already-
            # saturated plane holds until util clears the sat band
            if cur == SATURATED and util >= self.saturated - self.hysteresis:
                return SATURATED
            return ELEVATED
        # below elevated: falling edges need the hysteresis margin
        if cur == SATURATED and util >= self.saturated - self.hysteresis:
            return SATURATED
        if cur >= ELEVATED and util >= self.elevated - self.hysteresis:
            return ELEVATED
        return NORMAL

    def overall(self) -> int:
        """The node-wide level: the worst plane's."""
        return max((self.level(p) for p in self.planes()), default=NORMAL)

    def retry_after_ms(self, plane: str) -> int:
        """The retry hint a shed response should carry for this plane."""
        return RETRY_AFTER_MS[self.level(plane)]

    # ------------------------------------------------------- shedding

    def shed(self, plane: str, n: int = 1) -> None:
        """Count n shed requests/txs on a plane (registry + /metrics)."""
        with self._lock:
            self._sheds[plane] = self._sheds.get(plane, 0) + n
        m = self._metrics()
        if m is not None:
            try:
                m.sheds.labels(plane).inc(n)
            except Exception:  # noqa: BLE001
                pass

    def sheds(self, plane: str) -> int:
        with self._lock:
            return self._sheds.get(plane, 0)

    def total_sheds(self) -> int:
        with self._lock:
            return sum(self._sheds.values())

    # -------------------------------------------------------- metrics

    @staticmethod
    def _metrics():
        try:
            from cometbft_tpu_torch.libs import metrics as m

            return m.overload_metrics()
        except Exception:  # noqa: BLE001 - metrics must never break shedding
            return None

    def _publish_level(self, plane: str, level: int,
                       transition: bool = False) -> None:
        m = self._metrics()
        if m is None:
            return
        try:
            m.level.labels(plane).set(level)
            if transition:
                m.transitions.labels(plane).inc()
        except Exception:  # noqa: BLE001
            pass

    # --------------------------------------------------------- health

    def health(self) -> dict:
        """The `overload` section of the health RPC route and the
        assertion surface for tests/bench."""
        planes = self.planes()
        per_plane = {}
        overall = NORMAL
        now = self._clock()
        for p in planes:
            lvl = self.level(p)  # advances the state machine too
            overall = max(overall, lvl)
            with self._lock:
                per_plane[p] = {
                    "level": LEVEL_NAMES[lvl],
                    "utilization": round(self._last_util.get(p, 0.0), 4),
                    "sheds": self._sheds.get(p, 0),
                    "transitions": self._transitions.get(p, 0),
                    "since_s": round(now - self._since.get(p, now), 3),
                }
        return {
            "level": LEVEL_NAMES[overall],
            "planes": per_plane,
            "watermarks": {
                "elevated": self.elevated,
                "saturated": self.saturated,
                "hysteresis": self.hysteresis,
            },
        }


_default: Optional[OverloadRegistry] = None
_default_lock = threading.Lock()


def default_registry() -> OverloadRegistry:
    """A process-default registry for components created outside a Node
    (tests, benches). Nodes own their own instance — two in-proc nodes
    must not read each other's mempool pressure."""
    global _default
    if _default is None:
        with _default_lock:
            if _default is None:
                _default = OverloadRegistry()
    return _default
