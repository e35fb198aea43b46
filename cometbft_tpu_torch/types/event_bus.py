"""EventBus: typed event publishing over the query-addressable pubsub.

Reference: types/event_bus.go:33 + types/events.go. Every event carries a
composite-keyed attribute map; `tm.event` identifies the type, ABCI events
from FinalizeBlock are flattened in as `<type>.<attr>` keys, and txs also
get the reserved `tx.hash` / `tx.height` keys (types/event_bus.go:160-200).
Subscribers (RPC websocket clients, the indexer service) filter with pubsub
queries like "tm.event = 'Tx' AND tx.hash = '...'".

The port's copy of cometbft_tpu/types/event_bus.py.
"""

from __future__ import annotations

from dataclasses import dataclass

from cometbft_tpu_torch.crypto import tmhash
from cometbft_tpu_torch.libs import pubsub

# reserved event types (types/events.go)
EVENT_NEW_BLOCK = "NewBlock"
EVENT_NEW_BLOCK_HEADER = "NewBlockHeader"
EVENT_NEW_BLOCK_EVENTS = "NewBlockEvents"
EVENT_TX = "Tx"
EVENT_VALIDATOR_SET_UPDATES = "ValidatorSetUpdates"
EVENT_NEW_ROUND = "NewRound"
EVENT_NEW_ROUND_STEP = "NewRoundStep"
EVENT_COMPLETE_PROPOSAL = "CompleteProposal"
EVENT_VOTE = "Vote"
EVENT_LOCK = "Lock"
EVENT_UNLOCK = "Unlock"
EVENT_POLKA = "Polka"
EVENT_VALID_BLOCK = "ValidBlock"

EVENT_TYPE_KEY = "tm.event"
TX_HASH_KEY = "tx.hash"
TX_HEIGHT_KEY = "tx.height"


def query_for_event(event_type: str) -> str:
    return f"{EVENT_TYPE_KEY} = '{event_type}'"


QUERY_NEW_BLOCK = query_for_event(EVENT_NEW_BLOCK)
QUERY_TX = query_for_event(EVENT_TX)


# ------------------------------------------------------- event data types


@dataclass
class EventDataNewBlock:
    block: object
    block_id: object
    result_finalize_block: object


@dataclass
class EventDataTx:
    height: int
    tx: bytes
    index: int
    result: object  # ExecTxResult


@dataclass
class EventDataValidatorSetUpdates:
    validator_updates: list


@dataclass
class EventDataRoundState:
    height: int
    round_: int
    step: str


def _flatten_abci_events(events, out: dict[str, list[str]]) -> None:
    """types/event_bus.go:60-80: '<type>.<key>' -> [values] for indexed
    attributes."""
    for ev in events or []:
        if not ev.type_:
            continue
        for attr in ev.attributes:
            if not attr.key or not attr.index:
                continue
            out.setdefault(f"{ev.type_}.{attr.key}", []).append(attr.value)


class EventBus:
    """types/event_bus.go:33 — the async event plane (RPC + indexers)."""

    def __init__(self, capacity: int = 1024):
        self.server = pubsub.Server(capacity_per_subscription=capacity)

    # ------------------------------------------------------- subscriptions

    def subscribe(self, client_id: str, query: str,
                  capacity: int | None = None) -> pubsub.Subscription:
        return self.server.subscribe(client_id, query, capacity)

    def unsubscribe(self, client_id: str, query: str) -> None:
        self.server.unsubscribe(client_id, query)

    def unsubscribe_all(self, client_id: str) -> None:
        self.server.unsubscribe_all(client_id)

    # --------------------------------------------------------- publishing

    async def publish(self, event_type: str, data) -> None:
        self.server.publish(data, {EVENT_TYPE_KEY: [event_type]})

    async def publish_event_new_block(self, block, block_id, resp) -> None:
        events = {EVENT_TYPE_KEY: [EVENT_NEW_BLOCK]}
        _flatten_abci_events(getattr(resp, "events", None), events)
        self.server.publish(EventDataNewBlock(block, block_id, resp), events)

    async def publish_event_tx(self, height: int, tx: bytes, index: int,
                               result) -> None:
        """types/event_bus.go:160-200 PublishEventTx: reserved keys always
        indexed."""
        events = {
            EVENT_TYPE_KEY: [EVENT_TX],
            TX_HASH_KEY: [tmhash.sum_(tx).hex().upper()],
            TX_HEIGHT_KEY: [str(height)],
        }
        _flatten_abci_events(getattr(result, "events", None), events)
        self.server.publish(EventDataTx(height, tx, index, result), events)

    async def publish_event_validator_set_updates(self, updates) -> None:
        await self.publish(
            EVENT_VALIDATOR_SET_UPDATES, EventDataValidatorSetUpdates(updates))

    async def publish_round_event(self, event_type: str, height: int,
                                  round_: int, step: str) -> None:
        await self.publish(event_type, EventDataRoundState(height, round_, step))
