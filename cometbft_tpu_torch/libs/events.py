"""Synchronous in-process event switch (reference: libs/events/events.go).

The consensus state machine fires internal events (NewRoundStep, Vote, ...)
that the reactor consumes on the fast path, decoupled from the async pubsub
EventBus used for RPC subscribers (reference: consensus/state.go:129-131).
Callbacks run inline on the caller; they must be non-blocking.

The port's copy of cometbft_tpu/libs/events.py.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Any, Callable

Callback = Callable[[Any], None]


class EventSwitch:
    def __init__(self) -> None:
        # event -> listener_id -> callback
        self._listeners: dict[str, dict[str, Callback]] = defaultdict(dict)

    def add_listener(self, listener_id: str, event: str, cb: Callback) -> None:
        self._listeners[event][listener_id] = cb

    def remove_listener(self, listener_id: str, event: str | None = None) -> None:
        if event is not None:
            self._listeners.get(event, {}).pop(listener_id, None)
            return
        for cbs in self._listeners.values():
            cbs.pop(listener_id, None)

    def fire_event(self, event: str, data: Any = None) -> None:
        for cb in list(self._listeners.get(event, {}).values()):
            cb(data)

    # short alias used by the consensus hot path
    fire = fire_event
