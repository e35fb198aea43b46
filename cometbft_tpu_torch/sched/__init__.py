"""The node-wide verify scheduler: continuous batching of all signature
work on one card (sched/scheduler.py). The port's copy of
cometbft_tpu/sched/__init__.py.

Public surface: the process-wide VerifyScheduler (get()), the priority
classes and the ambient class (work_class), configure()/enabled()/reset()
for boot and tests, and health_snapshot(). The scheduler is on by default:
crypto.batch's verifiers are its clients until configure(enabled=False).
Its lane cap, class deadlines, queue limit and starvation limit are
VerifyScheduler's constructor defaults; a caller that needs others builds
its own VerifyScheduler.
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


def enabled() -> bool:
    """Does crypto.batch route through the scheduler? When off, each
    verifier runs its own batches (MixedBatchVerifier)."""
    return _enabled


def get() -> VerifyScheduler:
    global _sched
    if _sched is None:
        with _lock:
            if _sched is None:
                _sched = VerifyScheduler()
    return _sched


def configure(enabled: bool) -> None:
    """Route crypto.batch's verifiers through the scheduler, or not."""
    global _enabled
    _enabled = enabled


def reset() -> None:
    """Flush what is queued, stop the worker and forget the scheduler
    (tests). A failing flush still stops the worker, then raises."""
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
