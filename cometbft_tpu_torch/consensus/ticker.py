"""TimeoutTicker — schedules consensus step timeouts.

Reference: consensus/ticker.go:15-36. One pending timeout at a time; a newer
schedule replaces an older one (timeouts for earlier H/R/S are stale by
construction). Injectable for tests, like the reference's mock ticker.

The port's copy of cometbft_tpu/consensus/ticker.py.
"""

from __future__ import annotations

import asyncio
from dataclasses import dataclass

from cometbft_tpu_torch.consensus.round_state import RoundStepType


@dataclass(frozen=True)
class TimeoutInfo:
    duration: float
    height: int
    round_: int
    step: RoundStepType

    def __str__(self) -> str:
        return f"{self.duration:.3f}s@{self.height}/{self.round_}/{self.step.name}"


class TimeoutTicker:
    """schedule_timeout() arms (replacing any pending); fired timeouts are
    pushed to out_queue as TimeoutInfo."""

    def __init__(self, out_queue: asyncio.Queue):
        self.out_queue = out_queue
        self._task: asyncio.Task | None = None

    def schedule_timeout(self, ti: TimeoutInfo) -> None:
        if self._task is not None and not self._task.done():
            self._task.cancel()
        self._task = asyncio.get_running_loop().create_task(self._fire(ti))

    async def _fire(self, ti: TimeoutInfo) -> None:
        try:
            await asyncio.sleep(ti.duration)
            await self.out_queue.put(ti)
        except asyncio.CancelledError:
            pass

    def stop(self) -> None:
        if self._task is not None and not self._task.done():
            self._task.cancel()
            self._task = None
