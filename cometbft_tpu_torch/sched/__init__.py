"""The node-wide verify scheduler: continuous batching of all signature
work on one card (sched/scheduler.py). The port's copy of
cometbft_tpu/sched/__init__.py.

Public surface: the process-wide VerifyScheduler (get()), the priority
classes and the ambient class (work_class), configure()/enabled()/reset()
for boot and tests, and health_snapshot(). The scheduler is on by default:
crypto.batch's verifiers are its clients until configure(enabled=False).
configure() also takes the node's tunables (config crypto.sched_*: the lane
cap, the class deadlines, the queue limit and the starvation limit); the
live scheduler takes them in place, and one built after a reset() starts
with them.
"""

from __future__ import annotations

import threading

from cometbft_tpu_torch.sched.scheduler import (  # noqa: F401 - public re-exports
    CLASSES,
    CONSENSUS,
    LIGHT,
    MEMPOOL,
    SYNC,
    RowColumns,
    SchedulerSaturated,
    VerifyScheduler,
    current_class,
    work_class,
)

_lock = threading.Lock()
_sched: VerifyScheduler | None = None
_enabled = True
# a get() after reset() rebuilds with the node's knobs, not the defaults
_kwargs: dict = {}
_KNOBS = ("max_lanes", "sync_deadline", "light_deadline", "mempool_deadline",
          "queue_limit", "starvation_limit")


def enabled() -> bool:
    """Does crypto.batch route through the scheduler? When off, each
    verifier runs its own batches (MixedBatchVerifier)."""
    return _enabled


def get() -> VerifyScheduler:
    global _sched
    if _sched is None:
        with _lock:
            if _sched is None:
                _sched = VerifyScheduler(**_kwargs)
    return _sched


def configure(enabled: bool | None = None, **kwargs) -> None:
    """Route crypto.batch's verifiers through the scheduler, or not, and
    set the tunables in _KNOBS (unknown ones raise ValueError). The live
    scheduler takes them in place, so queued work is not orphaned."""
    global _enabled
    bad = set(kwargs) - set(_KNOBS)
    if bad:
        raise ValueError(f"unknown scheduler knob(s) {sorted(bad)}")
    with _lock:
        if enabled is not None:
            _enabled = enabled
        _kwargs.update(kwargs)
        if _sched is not None:
            for k, v in kwargs.items():
                if k.endswith("_deadline"):
                    _sched.class_deadline[{"sync_deadline": SYNC, "light_deadline": LIGHT,
                                           "mempool_deadline": MEMPOOL}[k]] = v
                else:
                    setattr(_sched, k, v)


def reset() -> None:
    """Flush what is queued, stop the worker and forget the scheduler
    (tests). A failing flush still stops the worker, then raises. The
    knobs set by configure() stay."""
    global _sched
    with _lock:
        sched, _sched = _sched, None
    if sched is not None:
        try:
            sched.flush()
        finally:
            sched.stop()


def health_snapshot() -> dict:
    """The scheduler's health() with the routing switch."""
    snap = get().health()
    snap["enabled"] = _enabled
    return snap
