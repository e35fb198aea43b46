"""Query-addressable pubsub server — the EventBus substrate.

Reference: libs/pubsub/pubsub.go:90-342 (server) and libs/pubsub/query/
(peg-generated parser). Subscribers register a client id + a query string
like:

    tm.event = 'Tx' AND tx.height > 5 AND account.name CONTAINS 'fred'

and receive every published message whose event map matches. Events are
composite-keyed: {"tm.event": ["Tx"], "tx.hash": ["AB12.."], ...}.

The reference generates its parser with peg; a hand-rolled tokenizer +
recursive descent covers the same grammar (conditions joined by AND;
operators = != < <= > >= CONTAINS EXISTS; string/number operands).

The port's copy of cometbft_tpu/libs/pubsub.py.
"""

from __future__ import annotations

import asyncio
import re
from dataclasses import dataclass, field
from typing import Any, Optional

_TOKEN_RE = re.compile(
    r"""\s*(?:
        (?P<op><=|>=|!=|=|<|>)
      | (?P<kw>\bAND\b|\bCONTAINS\b|\bEXISTS\b)
      | (?P<str>'(?:[^'\\]|\\.)*')
      | (?P<num>-?\d+(?:\.\d+)?)
      | (?P<key>[A-Za-z_][A-Za-z0-9_.\-]*)
    )""",
    re.VERBOSE,
)


class QueryError(ValueError):
    pass


@dataclass(frozen=True)
class Condition:
    key: str
    op: str  # '=', '!=', '<', '<=', '>', '>=', 'CONTAINS', 'EXISTS'
    operand: Any = None  # str | float | None

    def matches(self, values: list[str]) -> bool:
        if self.op == "EXISTS":
            return bool(values)
        for v in values:
            if self._match_one(v):
                return True
        return False

    def _match_one(self, v: str) -> bool:
        op, operand = self.op, self.operand
        if op == "CONTAINS":
            return str(operand) in v
        if isinstance(operand, float):
            try:
                num = float(v)
            except ValueError:
                return False
            return {
                "=": num == operand, "!=": num != operand,
                "<": num < operand, "<=": num <= operand,
                ">": num > operand, ">=": num >= operand,
            }[op]
        if op == "=":
            return v == operand
        if op == "!=":
            return v != operand
        return False  # ordered ops need numeric operands


class Query:
    """libs/pubsub/query/query.go — immutable compiled query."""

    def __init__(self, s: str):
        self.str_ = s.strip()
        self.conditions = _parse(self.str_)

    def matches(self, events: dict[str, list[str]]) -> bool:
        return all(c.matches(events.get(c.key, [])) for c in self.conditions)

    def __str__(self) -> str:
        return self.str_

    def __eq__(self, other) -> bool:
        return isinstance(other, Query) and self.str_ == other.str_

    def __hash__(self) -> int:
        return hash(self.str_)


def _tokenize(s: str):
    pos = 0
    out = []
    while pos < len(s):
        m = _TOKEN_RE.match(s, pos)
        if m is None or m.end() == pos:
            if s[pos:].strip():
                raise QueryError(f"bad token at {s[pos:]!r}")
            break
        pos = m.end()
        kind = m.lastgroup
        out.append((kind, m.group(kind)))
    return out


def _parse(s: str) -> list[Condition]:
    if not s:
        raise QueryError("empty query")
    toks = _tokenize(s)
    conds: list[Condition] = []
    i = 0
    while i < len(toks):
        if toks[i][0] != "key":
            raise QueryError(f"expected key, got {toks[i][1]!r}")
        key = toks[i][1]
        i += 1
        if i >= len(toks):
            raise QueryError(f"dangling key {key!r}")
        kind, tok = toks[i]
        if kind == "kw" and tok == "EXISTS":
            conds.append(Condition(key, "EXISTS"))
            i += 1
        elif kind == "kw" and tok == "CONTAINS":
            i += 1
            if i >= len(toks) or toks[i][0] != "str":
                raise QueryError("CONTAINS requires a string operand")
            conds.append(Condition(key, "CONTAINS", _unquote(toks[i][1])))
            i += 1
        elif kind == "op":
            op = tok
            i += 1
            if i >= len(toks):
                raise QueryError(f"operator {op!r} missing operand")
            vkind, vtok = toks[i]
            if vkind == "str":
                conds.append(Condition(key, op, _unquote(vtok)))
            elif vkind == "num":
                conds.append(Condition(key, op, float(vtok)))
            else:
                raise QueryError(f"bad operand {vtok!r}")
            i += 1
        else:
            raise QueryError(f"expected operator after {key!r}, got {tok!r}")
        if i < len(toks):
            if toks[i] != ("kw", "AND"):
                raise QueryError(f"expected AND, got {toks[i][1]!r}")
            i += 1
            if i >= len(toks):
                raise QueryError("dangling AND")
    return conds


def _unquote(s: str) -> str:
    return s[1:-1].replace("\\'", "'").replace("\\\\", "\\")


# --------------------------------------------------------------- the server


@dataclass
class Message:
    data: Any
    events: dict[str, list[str]]


class Subscription:
    """pubsub.go Subscription: a bounded queue + cancellation signal.
    capacity=0 means unbounded — the SubscribeUnbuffered analog
    (pubsub.go:191) for consumers that must never be dropped (indexer)."""

    def __init__(self, query: Query, capacity: int):
        self.query = query
        self.out: asyncio.Queue = asyncio.Queue(maxsize=capacity)
        self.canceled: Optional[str] = None  # reason when terminated

    def cancel(self, reason: str) -> None:
        self.canceled = reason
        try:
            self.out.put_nowait(None)  # wake the consumer
        except asyncio.QueueFull:
            pass


class ErrAlreadySubscribed(Exception):
    pass


class ErrSubscriptionNotFound(Exception):
    pass


class Server:
    """pubsub.go:90 Server. publish() is synchronous fan-out on the caller's
    task (the reference serializes through a channel; a single asyncio loop
    gives the same ordering for free). A subscriber that falls behind its
    buffer is cancelled rather than back-pressuring consensus
    (out-of-capacity semantics)."""

    def __init__(self, capacity_per_subscription: int = 256):
        self.capacity = capacity_per_subscription
        # client_id -> query_str -> Subscription
        self._subs: dict[str, dict[str, Subscription]] = {}

    def subscribe(self, client_id: str, query: str | Query,
                  capacity: int | None = None) -> Subscription:
        """capacity=None -> server default; 0 -> unbounded (unbuffered-
        subscriber semantics: never cancelled for falling behind)."""
        q = query if isinstance(query, Query) else Query(query)
        by_q = self._subs.setdefault(client_id, {})
        if q.str_ in by_q:
            raise ErrAlreadySubscribed(f"{client_id!r} already subscribed to {q.str_!r}")
        sub = Subscription(q, self.capacity if capacity is None else capacity)
        by_q[q.str_] = sub
        return sub

    def unsubscribe(self, client_id: str, query: str | Query) -> None:
        qs = query.str_ if isinstance(query, Query) else Query(query).str_
        by_q = self._subs.get(client_id, {})
        sub = by_q.pop(qs, None)
        if sub is None:
            raise ErrSubscriptionNotFound(f"{client_id!r} not subscribed to {qs!r}")
        sub.cancel("unsubscribed")
        if not by_q:
            self._subs.pop(client_id, None)

    def unsubscribe_all(self, client_id: str) -> None:
        by_q = self._subs.pop(client_id, None)
        if not by_q:
            raise ErrSubscriptionNotFound(f"{client_id!r} has no subscriptions")
        for sub in by_q.values():
            sub.cancel("unsubscribed")

    def num_clients(self) -> int:
        return len(self._subs)

    def max_lag_fraction(self) -> float:
        """The events plane's overload signal (libs/overload.py): the
        worst subscriber's queue fill fraction. Unbounded subscribers
        (capacity 0, e.g. the indexer) can't lag by this definition —
        they never drop — so they read 0."""
        worst = 0.0
        for by_q in self._subs.values():
            for sub in by_q.values():
                cap = sub.out.maxsize
                if cap > 0:
                    worst = max(worst, sub.out.qsize() / cap)
        return worst

    def num_client_subscriptions(self, client_id: str) -> int:
        return len(self._subs.get(client_id, {}))

    def publish(self, data: Any, events: dict[str, list[str]] | None = None) -> None:
        events = events or {}
        msg = Message(data, events)
        for client_id, by_q in list(self._subs.items()):
            for qs, sub in list(by_q.items()):
                if sub.canceled is not None or not sub.query.matches(events):
                    continue
                try:
                    sub.out.put_nowait(msg)
                except asyncio.QueueFull:
                    sub.cancel("out of capacity")
                    by_q.pop(qs, None)
                    if not by_q:
                        self._subs.pop(client_id, None)
