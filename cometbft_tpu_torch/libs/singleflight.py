"""Single-flight dedup for async work: concurrent callers for one key
share the FIRST caller's result instead of repeating the computation.

The pattern first appeared in mempool CheckTx dedup (mempool/mempool.py —
left in place there: its flight result is interwoven with the tx cache
and sender bookkeeping); the light client's per-height bisections and the
fleet service's coalesced verifications reuse THIS helper so the
shield/cancellation edge cases live in one audited place:

  - waiters `asyncio.shield` the first flight's future, so a cancelled
    WAITER never cancels the shared flight;
  - a cancelled FIRST flight leaves its waiters with an unknown result —
    they re-run the thunk themselves rather than propagate a foreign
    cancellation;
  - a failing flight fans its exception to every waiter (consumed on the
    future so no never-retrieved warning), and the key is released in
    all cases.

Event-loop-confined (no locks): callers share one asyncio loop, which is
every current consumer's model.

The port's copy of cometbft_tpu/libs/singleflight.py.
"""

from __future__ import annotations

import asyncio
from typing import Awaitable, Callable, Hashable


class SingleFlight:
    """A keyed map of in-flight computations. `do(key, thunk)` returns
    (shared, result): shared=True when this call coalesced onto another
    caller's flight — the accounting hook coalescing layers need."""

    def __init__(self):
        self._inflight: dict[Hashable, asyncio.Future] = {}

    def __len__(self) -> int:
        return len(self._inflight)

    def __contains__(self, key: Hashable) -> bool:
        return key in self._inflight

    async def do(self, key: Hashable,
                 thunk: Callable[[], Awaitable]) -> tuple[bool, object]:
        first = self._inflight.get(key)
        if first is not None:
            try:
                return True, await asyncio.shield(first)
            except asyncio.CancelledError:
                if not first.cancelled():
                    raise  # WE were cancelled, not the first caller
                # first flight cancelled mid-run: its result is unknown;
                # run the thunk ourselves (possibly becoming the new
                # first flight for later arrivals)
                return await self.do(key, thunk)
        fut = asyncio.get_running_loop().create_future()
        self._inflight[key] = fut
        try:
            res = await thunk()
        except BaseException as e:
            if not fut.done():
                if isinstance(e, Exception):
                    fut.set_exception(e)
                    fut.exception()  # consumed: no never-retrieved warning
                else:  # CancelledError: waiters retry on their own
                    fut.cancel()
            raise
        else:
            fut.set_result(res)
            return False, res
        finally:
            self._inflight.pop(key, None)
