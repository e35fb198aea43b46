"""Service lifecycle (reference: libs/service/service.go:24-239).

Every long-lived object in the framework embeds BaseService: idempotent
start/stop, no restart after stop (reset() to allow), a quit event to wait
on. The reference uses atomics + a quit channel; here starts/stops happen on
the event loop so plain flags suffice, while `stopped_event` lets any task
await termination.

The port's copy of cometbft_tpu/libs/service.py.
"""

from __future__ import annotations

import asyncio
from typing import Optional

from cometbft_tpu_torch.libs import log as cmtlog


class ServiceError(Exception):
    pass


class AlreadyStartedError(ServiceError):
    pass


class AlreadyStoppedError(ServiceError):
    pass


class BaseService:
    """Subclasses override on_start / on_stop."""

    def __init__(self, name: str, logger: Optional[cmtlog.Logger] = None):
        self.name = name
        self.logger = logger or cmtlog.nop()
        self._started = False
        self._stopped = False
        self._stopped_event: Optional[asyncio.Event] = None

    # -- lifecycle --

    async def start(self) -> None:
        if self._stopped:
            raise AlreadyStoppedError(self.name)
        if self._started:
            raise AlreadyStartedError(self.name)
        self._started = True
        self._stopped_event = asyncio.Event()
        self.logger.info("service start", service=self.name)
        try:
            await self.on_start()
        except BaseException:
            # failed start leaves the service startable again (reference
            # resets started on OnStart error, service.go:171-178)
            self._started = False
            self._stopped_event = None
            raise

    async def stop(self) -> None:
        if self._stopped:
            return
        if not self._started:
            raise ServiceError(f"{self.name}: stop before start")
        self._stopped = True
        self.logger.info("service stop", service=self.name)
        await self.on_stop()
        if self._stopped_event is not None:
            self._stopped_event.set()

    def reset(self) -> None:
        """Allow a stopped service to start again (reference Reset)."""
        self._started = False
        self._stopped = False
        self._stopped_event = None

    @property
    def is_running(self) -> bool:
        return self._started and not self._stopped

    async def wait(self) -> None:
        """Block until the service stops."""
        if self._stopped_event is None:
            if self._stopped:
                return
            raise ServiceError(f"{self.name}: wait before start")
        await self._stopped_event.wait()

    # -- overridables --

    async def on_start(self) -> None:  # pragma: no cover - trivial
        pass

    async def on_stop(self) -> None:  # pragma: no cover - trivial
        pass

    def set_logger(self, logger: cmtlog.Logger) -> None:
        self.logger = logger


class TaskRunner:
    """Helper owning a set of background asyncio tasks tied to a service:
    spawn() tracks them, cancel_all() tears them down on stop. Replaces the
    reference's ad-hoc goroutine-per-routine pattern with structured
    cancellation."""

    def __init__(self, name: str = "tasks"):
        self.name = name
        self._tasks: set[asyncio.Task] = set()

    def spawn(self, coro, name: str | None = None) -> asyncio.Task:
        task = asyncio.get_running_loop().create_task(coro, name=name or self.name)
        self._tasks.add(task)
        task.add_done_callback(self._tasks.discard)
        return task

    async def cancel_all(self) -> None:
        """Cancel and reap every task. Cancels REPEATEDLY: on Python < 3.11
        asyncio.wait_for can swallow a pending cancellation when its inner
        future completes in the same scheduling window (bpo-42130), leaving
        a task alive after one cancel — a single `await t` would then hang
        the whole service stop. Re-cancelling until the task actually dies
        makes teardown immune to that lost-wakeup race; tasks that survive
        every attempt (a tight loop swallowing CancelledError) are abandoned
        with a warning rather than wedging shutdown."""
        current = asyncio.current_task()
        # a service routine may stop its own service (a peer's recv loop
        # tearing the peer down): never cancel-and-await the calling task —
        # it ends naturally after teardown, and cancelling it here would
        # abort the teardown itself mid-flight
        tasks = [t for t in self._tasks if t is not current]
        for t in tasks:
            t.cancel()
        pending = set(tasks)
        for _attempt in range(10):
            if not pending:
                break
            done, pending = await asyncio.wait(pending, timeout=1.0)
            for t in done:
                if not t.cancelled() and t.exception() is not None:
                    pass  # swallowed: stop paths must not re-raise task errors
            for t in pending:
                t.cancel()
        if pending:
            import logging

            logging.getLogger("cometbft").warning(
                "%s.cancel_all: %d task(s) survived repeated cancellation: %s",
                self.name, len(pending),
                [t.get_name() for t in pending])
        self._tasks.clear()

    def __len__(self) -> int:
        return len(self._tasks)
