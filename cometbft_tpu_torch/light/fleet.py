"""Light-client fleet service — the serving plane.

One bisection is cheap on the verify plane (every hop is a device-batched
commit check riding the VerifyScheduler), but until this module every
light client bisected ALONE: a million clients asking for the same head
meant a million identical bisections. Grounded in "Practical Light
Clients for Committee-Based Blockchains" (arXiv:2410.03347) and "A
Tendermint Light Client" (arXiv:2010.07031), this is the witness-side
service that amortizes skipping verification across a fleet:

  coalescing   concurrent verification requests for the same height
               collapse into ONE shared flight keyed by
               (chain_id, height, validator-set hash): the first request
               runs the bisection (under the scheduler's LIGHT class, so
               serving traffic never preempts consensus or the node's own
               sync), everyone else awaits its future and receives the
               bit-identical result. Unique in-flight verifications are
               bounded (fleet_max_inflight); past the bound new UNIQUE
               requests shed with FleetSaturated — coalesced duplicates
               are free and never shed.

  checkpoint   verified headers land in a bounded skip-list cache
  cache        (CheckpointCache): heights divisible by skip_base^k live
               on lane k, so nearest-checkpoint lookups walk O(log)
               lanes. The cache IS the fleet client's trusted store —
               light/client.py's `checkpoint_source` seam makes every
               bisection start (and fast-forward mid-flight) from the
               nearest cached checkpoint instead of the trust root, and
               hot height ranges answer entirely from memory. Entries are
               only served within their trusting period: an expired entry
               is a miss and is pruned, never a stale answer. Eviction
               drops the lowest non-anchor height first (the trust root
               and the newest checkpoints are the valuable ends).

  streaming    subscribe() registers a per-client bounded queue; the head
               watcher verifies each new height once (through the same
               coalescing path) and fans the verified header out to every
               subscriber. Backpressure is explicit: a subscriber whose
               queue hits the high water is DROPPED (the event-bus
               slow-consumer rule — a silent unbounded buffer would melt
               the node), and a per-client send budget bounds the total
               headers any one client may be streamed.

The fleet performs no consensus-critical work: it is an RPC-plane service
(rpc/core.py `light_verify`, rpc/server.py `light_subscribe`) whose
failure modes are request errors, never node liveness.

The port's copy of cometbft_tpu/light/fleet.py.
"""

from __future__ import annotations

import asyncio
import bisect
import time
from typing import Callable, Optional

from cometbft_tpu_torch.libs import log as cmtlog
from cometbft_tpu_torch.types.light import LightBlock
from cometbft_tpu_torch.utils import cmttime

from cometbft_tpu_torch.light import verifier
from cometbft_tpu_torch.light.client import Client, TrustOptions
from cometbft_tpu_torch.light.errors import LightClientError
from cometbft_tpu_torch.light.provider import Provider

# skip-list defaults (config light.fleet_* overrides)
DEFAULT_CAPACITY = 4096
DEFAULT_SKIP_BASE = 16
_MAX_LANES = 8  # skip_base^8 heights dwarf any real chain

# ---------------------------------------------------------------------------
# Per-chain shared checkpoint cache: the
# fleet's skip-list cache and the STATESYNC light client share verified
# checkpoints. A statesync bootstrap that runs before the fleet exists
# seeds the cache the fleet later serves from; a fleet that ran first
# spares statesync its cold bisections (node/node.py points the statesync
# client's checkpoint_source here and tees its verified blocks back in).
# First creation's parameters win — later callers get the same instance
# regardless of knobs (one cache per chain per process is the point).
# ---------------------------------------------------------------------------

import threading as _threading

_SHARED_CACHES: dict[str, "CheckpointCache"] = {}
_SHARED_LOCK = _threading.Lock()


def shared_cache(chain_id: str, *, capacity: int | None = None,
                 trust_period_ns: int | None = None,
                 skip_base: int | None = None) -> "CheckpointCache":
    """The process-level checkpoint cache for `chain_id` (created on
    first use with the caller's parameters)."""
    with _SHARED_LOCK:
        cache = _SHARED_CACHES.get(chain_id)
        if cache is None:
            kwargs = {}
            if capacity is not None:
                kwargs["capacity"] = capacity
            if trust_period_ns is not None:
                kwargs["trust_period_ns"] = trust_period_ns
            if skip_base is not None:
                kwargs["skip_base"] = skip_base
            cache = CheckpointCache(**kwargs)
            _SHARED_CACHES[chain_id] = cache
        return cache


def reset_shared_caches() -> None:
    """Test hook: drop every per-chain shared cache."""
    with _SHARED_LOCK:
        _SHARED_CACHES.clear()


class FleetSaturated(LightClientError):
    """Unique-verification admission rejected: the fleet already runs
    fleet_max_inflight distinct bisections. Callers shed load (the RPC
    route turns this into a -32005 error) instead of queuing unboundedly
    — the coalescing twin of sched.SchedulerSaturated."""


class SubscriptionClosed(Exception):
    """Raised into a subscription pump when the fleet closed it; .reason
    is one of "backpressure" | "budget" | "shutdown"."""

    def __init__(self, reason: str):
        super().__init__(f"light subscription closed: {reason}")
        self.reason = reason


def _metrics():
    try:
        from cometbft_tpu_torch.libs import metrics as m

        return m.light_fleet_metrics()
    except Exception:  # noqa: BLE001 - metrics must never break serving
        return None


# --------------------------------------------------------------- cache


class CheckpointCache:
    """Bounded skip list of verified headers, keyed by height.

    Lane k holds the cached heights divisible by skip_base**k (lane 0 =
    every entry), each lane sorted ascending — the deterministic analog
    of a probabilistic skip list (a height's level is a content property,
    so restarts and replicas agree on the layout). Lane 0 resolves
    lookups (one bisect — it already holds every entry sorted); the
    upper lanes are the DURABILITY tiers: capacity eviction removes the
    lowest-LEVEL entries first, so the express checkpoints at
    skip_base^k spacing outlive the dense lane-0 fill between them and a
    cold bisection always finds a long-range anchor near its target.
    Every read applies the trust-period rule: an expired entry is a MISS
    (and is pruned) — the cache can serve stale bytes never.

    Doubles as the fleet client's trusted store: the LightStore surface
    (save_light_block / light_block / light_block_before / first /
    latest / prune / size) is implemented so light/client.py runs against
    the shared cache unchanged.
    """

    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 trust_period_ns: int = 0,
                 skip_base: int = DEFAULT_SKIP_BASE,
                 clock: Callable[[], cmttime.Timestamp] = cmttime.now):
        if capacity < 2:
            raise ValueError("checkpoint cache capacity must be >= 2")
        if skip_base < 2:
            raise ValueError("skip_base must be >= 2")
        self.capacity = capacity
        self.trust_period_ns = trust_period_ns  # 0 = never expires
        self.skip_base = skip_base
        self._clock = clock
        self._blocks: dict[int, LightBlock] = {}
        self._lanes: list[list[int]] = [[] for _ in range(_MAX_LANES)]
        # exclusive per-level rows (level(h) == k exactly): the eviction
        # order's index, so picking a victim is O(levels), not a scan of
        # lane 0 per eviction
        self._level_rows: list[list[int]] = [[] for _ in range(_MAX_LANES)]
        # the anchor (trust root) is never evicted by capacity pressure
        self._anchor: Optional[int] = None
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.expired_pruned = 0

    # ------------------------------------------------------- skip lanes

    def _level(self, height: int) -> int:
        """Lanes 0..level hold `height`: the number of times skip_base
        divides it (capped). Height 0 never occurs (heights are >= 1)."""
        lvl = 0
        while (lvl + 1 < _MAX_LANES and height % (self.skip_base ** (lvl + 1)) == 0):
            lvl += 1
        return lvl

    def lane_heights(self, lane: int) -> list[int]:
        """Introspection for tests/health: the heights on one lane."""
        return list(self._lanes[lane])

    def _insert(self, height: int) -> None:
        lvl = self._level(height)
        for lane in range(lvl + 1):
            row = self._lanes[lane]
            i = bisect.bisect_left(row, height)
            if i >= len(row) or row[i] != height:
                row.insert(i, height)
        row = self._level_rows[lvl]
        i = bisect.bisect_left(row, height)
        if i >= len(row) or row[i] != height:
            row.insert(i, height)

    def _remove(self, height: int) -> None:
        for row in self._lanes:
            i = bisect.bisect_left(row, height)
            if i < len(row) and row[i] == height:
                row.pop(i)
        row = self._level_rows[self._level(height)]
        i = bisect.bisect_left(row, height)
        if i < len(row) and row[i] == height:
            row.pop(i)

    # ----------------------------------------------------------- expiry

    def _expired(self, lb: LightBlock, now: Optional[cmttime.Timestamp]) -> bool:
        if not self.trust_period_ns:
            return False
        now = now or self._clock()
        return verifier.header_expired(
            lb.signed_header, self.trust_period_ns, now)

    def _drop_expired(self, height: int) -> None:
        self._blocks.pop(height, None)
        self._remove(height)
        if self._anchor == height:
            self._anchor = None
        self.expired_pruned += 1
        m = _metrics()
        if m is not None:
            m.cache_events.labels("prune").inc()

    def prune_expired(self, now: Optional[cmttime.Timestamp] = None) -> int:
        """Evict every entry past its trusting period (the periodic
        sweep; reads prune lazily too). Returns the count pruned."""
        now = now or self._clock()
        gone = [h for h, lb in self._blocks.items() if self._expired(lb, now)]
        for h in gone:
            self._drop_expired(h)
        return len(gone)

    # ------------------------------------------------------------ reads

    def get(self, height: int, now: Optional[cmttime.Timestamp] = None
            ) -> Optional[LightBlock]:
        """The exact-height read (counted): a hit only within the trust
        period — an expired entry is pruned and reported as a miss."""
        lb = self._blocks.get(height)
        if lb is not None and self._expired(lb, now):
            self._drop_expired(height)
            lb = None
        m = _metrics()
        if lb is None:
            self.misses += 1
            if m is not None:
                m.cache_events.labels("miss").inc()
            return None
        self.hits += 1
        if m is not None:
            m.cache_events.labels("hit").inc()
        return lb

    def nearest_at_or_below(self, height: int,
                            now: Optional[cmttime.Timestamp] = None
                            ) -> Optional[LightBlock]:
        """The greatest cached, unexpired height <= `height` — the
        bisection starting point. Lane 0 holds every entry sorted, so
        one bisect resolves the candidate; the walk continues down past
        expired entries (pruning them as it goes)."""
        now = now or self._clock()
        while True:
            row0 = self._lanes[0]
            i = bisect.bisect_right(row0, height)
            if i == 0:
                return None
            h = row0[i - 1]
            lb = self._blocks.get(h)
            if lb is None:  # stale index entry: self-heal and continue
                self._remove(h)
                continue
            if self._expired(lb, now):
                self._drop_expired(h)
                continue
            return lb

    # ----------------------------------------------------------- writes

    def put(self, lb: LightBlock) -> None:
        if lb.height <= 0:
            raise ValueError("lightBlock.Height <= 0")
        fresh = lb.height not in self._blocks
        self._blocks[lb.height] = lb
        if fresh:
            self._insert(lb.height)
        if self._anchor is None or lb.height < self._anchor:
            self._anchor = lb.height
        self.prune(self.capacity)

    # ----------------------------------------- LightStore-compat surface
    # (light/client.py Client runs against this cache as its trusted
    # store; reads here are UNcounted — the client's own store traffic is
    # bookkeeping, not fleet cache pressure)

    def save_light_block(self, lb: LightBlock) -> None:
        self.put(lb)

    def light_block(self, height: int) -> Optional[LightBlock]:
        lb = self._blocks.get(height)
        if lb is not None and self._expired(lb, None):
            self._drop_expired(height)
            return None
        return lb

    def light_block_before(self, height: int) -> Optional[LightBlock]:
        return self.nearest_at_or_below(height - 1)

    def first_light_block(self) -> Optional[LightBlock]:
        row0 = self._lanes[0]
        return self._blocks.get(row0[0]) if row0 else None

    def latest_light_block(self) -> Optional[LightBlock]:
        row0 = self._lanes[0]
        return self._blocks.get(row0[-1]) if row0 else None

    def _pick_victim(self) -> Optional[int]:
        """Level-aware eviction order: the lowest non-anchor height on
        the LOWEST level tier goes first — lane-0-only fill is shed
        before the skip_base^k express checkpoints, which are the
        long-range anchors a cold bisection needs. O(levels) via the
        exclusive per-level index, not a lane-0 scan."""
        for row in self._level_rows:
            if not row:
                continue
            if row[0] != self._anchor:
                return row[0]
            if len(row) > 1:
                return row[1]
        return None

    def prune(self, size: int) -> None:
        """Evict until at most `size` entries remain — capacity eviction
        AND the client's pruning call (the fleet wires the client's
        pruning_size to the cache capacity so the two bounds agree).
        Victim order is level-aware (_pick_victim): dense lane-0 fill
        goes first, express checkpoints and the trust-root anchor last."""
        m = _metrics()
        while len(self._blocks) > max(size, 1) and len(self._lanes[0]) > 1:
            victim = self._pick_victim()
            if victim is None:
                return
            self._blocks.pop(victim, None)
            self._remove(victim)
            self.evictions += 1
            if m is not None:
                m.cache_events.labels("evict").inc()

    def size(self) -> int:
        return len(self._blocks)

    def stats(self) -> dict:
        row0 = self._lanes[0]
        return {
            "entries": len(self._blocks),
            "capacity": self.capacity,
            "skip_base": self.skip_base,
            "lane_sizes": [len(r) for r in self._lanes],
            "lowest": row0[0] if row0 else None,
            "highest": row0[-1] if row0 else None,
            "hits": self.hits,
            "misses": self.misses,
            "hit_rate": round(self.hits / (self.hits + self.misses), 4)
            if (self.hits + self.misses) else None,
            "evictions": self.evictions,
            "expired_pruned": self.expired_pruned,
        }


# ------------------------------------------------------------ streaming


class Subscription:
    """One streaming client: a bounded queue the head watcher offers
    verified headers into, drained by the transport pump. Closing reasons
    ride the queue as SubscriptionClosed sentinels so the pump can tell
    the client WHY before the socket goes quiet."""

    def __init__(self, client_id: str, queue_high_water: int,
                 send_budget: int, from_height: int = 0):
        self.client_id = client_id
        self.queue: asyncio.Queue = asyncio.Queue(maxsize=queue_high_water)
        self.send_budget = send_budget  # 0 = unlimited
        self.sent = 0
        self.from_height = from_height
        self.closed: Optional[str] = None

    def offer(self, lb: LightBlock) -> bool:
        """Non-blocking enqueue; False = the queue is at high water (the
        caller drops this subscriber — backpressure must cost the slow
        client, not the fleet)."""
        if self.closed is not None:
            return True  # already closing; nothing to do
        try:
            self.queue.put_nowait(lb)
            return True
        except asyncio.QueueFull:
            return False

    def close(self, reason: str) -> None:
        if self.closed is not None:
            return
        self.closed = reason
        try:
            self.queue.put_nowait(SubscriptionClosed(reason))
        except asyncio.QueueFull:
            # the pump will see .closed once it drains the backlog
            pass

    async def next(self):
        """The pump's read side: a LightBlock, or raises
        SubscriptionClosed when the fleet ended the stream. Queued
        headers are delivered before the close surfaces; a close whose
        sentinel could not ride a full queue is still seen here (the
        closed flag is checked once the backlog drains)."""
        if self.closed is not None and self.queue.empty():
            raise SubscriptionClosed(self.closed)
        item = await self.queue.get()
        if isinstance(item, SubscriptionClosed):
            raise item
        return item


# ---------------------------------------------------------------- fleet


class LightFleet:
    """The multi-tenant serving plane over ONE light client + ONE shared
    checkpoint cache. Thread model: asyncio, single loop (the RPC
    server's); the underlying signature work rides the VerifyScheduler's
    worker threads as usual."""

    def __init__(
        self,
        chain_id: str,
        primary: Provider,
        trust_options: TrustOptions,
        *,
        witnesses: Optional[list[Provider]] = None,
        cache: Optional[CheckpointCache] = None,
        cache_capacity: int = DEFAULT_CAPACITY,
        skip_base: int = DEFAULT_SKIP_BASE,
        trust_period_ns: Optional[int] = None,
        max_inflight: int = 1024,
        subscriber_queue: int = 64,
        send_budget: int = 0,
        max_subscribers: int = 10000,
        poll_interval: float = 0.25,
        logger: cmtlog.Logger | None = None,
    ):
        self.chain_id = chain_id
        self.logger = logger or cmtlog.nop()
        period = (trust_period_ns if trust_period_ns is not None
                  else trust_options.period_ns)
        self.cache = cache or CheckpointCache(
            capacity=cache_capacity, trust_period_ns=period,
            skip_base=skip_base)
        # a provider with no witnesses cannot cross-check; the primary
        # doubles as its own witness (a node serving its own chain) —
        # real witness deployments pass distinct providers
        self.client = Client(
            chain_id, trust_options, primary,
            list(witnesses) if witnesses else [primary],
            self.cache, pruning_size=self.cache.capacity,
        )
        # the client's bisections consult the SHARED cache for pivots
        # (uncounted nearest read: internal traffic is not fleet demand)
        self.client.checkpoint_source = self.cache.nearest_at_or_below
        # witness-pool management: the reference client REMOVES a witness
        # that errors during cross-referencing — correct for one
        # bisection, fatal for a long-lived service (one flaky fetch and
        # the fleet serves ErrNoWitnesses forever). The fleet re-arms the
        # client from this pool whenever attrition empties it; witnesses
        # dropped for DIVERGENCE stay dropped within a flight, so attack
        # detection semantics are unchanged.
        self._witness_pool = list(self.client.witnesses)
        self.max_inflight = max_inflight
        self.subscriber_queue = subscriber_queue
        self.send_budget = send_budget
        self.max_subscribers = max_subscribers
        self.poll_interval = poll_interval
        # (chain_id, height, valset_hash) -> shared first flight
        # (libs/singleflight.py — same helper as the client's per-height
        # dedup; this map's keys carry the pin dimension and feed the
        # max_inflight shed accounting)
        from cometbft_tpu_torch.libs.singleflight import SingleFlight

        self._flights = SingleFlight()
        self._subs: dict[str, Subscription] = {}
        self._watcher: Optional[asyncio.Task] = None
        self._stopped = False
        # event-driven head plane (node event bus -> notify_height): the
        # watcher wakes on the event instead of sleeping out a poll
        # interval; with no event source it polls (store-only setups)
        self._head_event: Optional[asyncio.Event] = None
        self._notified_height: Optional[int] = None
        self.head_notifications = 0
        # ---- accounting (health + bench surface)
        self.requests = 0
        self.cache_hits = 0
        self.coalesced = 0
        self.verified = 0
        # verifications the head watcher initiated (internal traffic —
        # kept out of the request counters but in the hops denominator:
        # their provider fetches are real bisection work)
        self.stream_verified = 0
        self.shed = 0
        self.errors = 0
        self.streamed = 0
        self.dropped_subscribers = 0
        # head-poll fetches (light_block(0) ticks) — subtracted from the
        # provider call counter so hops_per_verification measures
        # BISECTION fetches, not watcher idle polling
        self._watcher_polls = 0
        # bounded request-latency samples (p50/p99 in health; the
        # histogram metric is the scrape surface)
        self._lat: list[float] = []

    # ------------------------------------------------------------ verify

    def _dedup_key(self, height: int, valset_hash: bytes = b"") -> tuple:
        return (self.chain_id, height, valset_hash)

    async def initialize(self) -> None:
        """Bootstrap the underlying client's root of trust (idempotent)."""
        await self.client.initialize()

    async def verify_height(self, height: int,
                            valset_hash: bytes = b"") -> LightBlock:
        """The fleet's request path: cache -> coalesced flight -> fresh
        bisection. Every caller for the same (chain, height, valset-hash)
        receives the SAME LightBlock object — bit-identical fan-out.

        A non-empty `valset_hash` is a client PIN: the served header's
        validator-set hash must equal it or the request errors (a client
        that already knows the set at a height uses this to refuse a
        fleet serving a different fork). Pinned requests dedup on their
        own key so a mismatched pin can never poison the unpinned
        flight."""
        self.requests += 1
        m = _metrics()
        cached = self.cache.get(height)
        if cached is not None:
            self._pin_ok_or_error(cached, valset_hash)
            self.cache_hits += 1
            if m is not None:
                m.requests.labels("hit").inc()
            return cached
        key = self._dedup_key(height, valset_hash)
        if key not in self._flights and len(self._flights) >= self.max_inflight:
            self.shed += 1
            if m is not None:
                m.requests.labels("saturated").inc()
            raise FleetSaturated(
                f"{len(self._flights)} unique verifications in flight "
                f"(limit {self.max_inflight})")
        t0 = time.perf_counter()
        try:
            shared, lb = await self._flights.do(
                key, lambda: self._verify_uncached(height))
        except Exception:
            self.errors += 1
            if m is not None:
                m.requests.labels("error").inc()
                m.inflight.set(len(self._flights))
            raise
        if m is not None:
            m.inflight.set(len(self._flights))
        # pin first, so each request carries exactly ONE result label
        # (a verification that happened still counts in self.verified —
        # the hops denominator — but an errored request is labeled error,
        # never verified/coalesced too)
        pin_ok = not valset_hash or lb.validator_set.hash() == valset_hash
        if not shared:
            self.verified += 1
            if m is not None:
                if pin_ok:
                    m.requests.labels("verified").inc()
                m.request_seconds.observe(time.perf_counter() - t0)
            self._lat.append(time.perf_counter() - t0)
            if len(self._lat) > 8192:
                del self._lat[:4096]
        elif pin_ok:
            self.coalesced += 1
            if m is not None:
                m.requests.labels("coalesced").inc()
        if not pin_ok:
            self._pin_ok_or_error(lb, valset_hash)
        return lb

    def _pin_ok_or_error(self, lb: LightBlock, valset_hash: bytes) -> None:
        """A mismatched pin is a REQUEST error (counted as such) even
        when the underlying verification succeeded and is cached for
        other clients."""
        if valset_hash and lb.validator_set.hash() != valset_hash:
            self.errors += 1
            m = _metrics()
            if m is not None:
                m.requests.labels("error").inc()
            raise LightClientError(
                f"validator-set pin mismatch at height {lb.height}: "
                f"client pinned {valset_hash.hex()}, verified set is "
                f"{lb.validator_set.hash().hex()}")

    async def _verify_uncached(self, height: int) -> LightBlock:
        """One real bisection, under the scheduler's LIGHT class."""
        from cometbft_tpu_torch import sched

        m = _metrics()
        if m is not None:
            # the key is already registered in _flights when this thunk
            # runs, so the gauge reflects LIVE flights, not completions
            m.inflight.set(len(self._flights))
        if not self.client.witnesses:
            # witness attrition (flaky fetches) must not brick the fleet
            self.client.witnesses = list(self._witness_pool)
        with sched.work_class(sched.LIGHT):
            return await self.client.verify_light_block_at_height(height)

    async def _verify_for_stream(self, height: int) -> LightBlock:
        """The head watcher's internal path: same coalescing map as
        external requests (a client asking for the new head DOES share
        the watcher's flight) but none of the demand counters — internal
        traffic is not serving load, the same rule that keeps watcher
        polls out of hops_per_verification and checkpoint reads out of
        the cache hit rate."""
        lb = self.cache.light_block(height)  # uncounted internal read
        if lb is not None:
            return lb
        shared, lb = await self._flights.do(
            self._dedup_key(height), lambda: self._verify_uncached(height))
        if not shared:
            self.stream_verified += 1
        return lb

    # --------------------------------------------------------- streaming

    def subscribe(self, client_id: str, from_height: int = 0) -> Subscription:
        """Register a streaming client. Replaces any prior subscription
        under the same client id (one stream per WS connection)."""
        if self._stopped:
            raise LightClientError("fleet stopped")
        if (client_id not in self._subs
                and len(self._subs) >= self.max_subscribers):
            raise FleetSaturated(
                f"{len(self._subs)} subscribers (limit "
                f"{self.max_subscribers})")
        old = self._subs.pop(client_id, None)
        if old is not None:
            old.close("shutdown")
        sub = Subscription(client_id, self.subscriber_queue,
                           self.send_budget, from_height)
        self._subs[client_id] = sub
        m = _metrics()
        if m is not None:
            m.subscribers.set(len(self._subs))
        self._ensure_watcher()
        return sub

    def unsubscribe(self, client_id: str) -> None:
        sub = self._subs.pop(client_id, None)
        if sub is not None:
            sub.close("shutdown")
        m = _metrics()
        if m is not None:
            m.subscribers.set(len(self._subs))

    def _ensure_watcher(self) -> None:
        if self._head_event is None:
            self._head_event = asyncio.Event()
        if self._watcher is None or self._watcher.done():
            self._watcher = asyncio.get_running_loop().create_task(
                self._watch_head(), name="light-fleet-head")

    def notify_height(self, height: int) -> None:
        """Event-driven head publishing (the node's NewBlock hook): record
        the newly committed height and wake the watcher NOW instead of
        letting it sleep out the poll interval. The
        watcher still verifies through the coalescing path — the event
        carries the height, never an unverified header — and the poll
        path stays as fallback for store-only setups where no event bus
        feeds the fleet."""
        if self._notified_height is None or height > self._notified_height:
            self._notified_height = height
        self.head_notifications += 1
        if self._head_event is not None:
            self._head_event.set()

    # heights verified+fanned per watcher tick: bounds one tick's work
    # without ever SKIPPING a height — a backlog deeper than this simply
    # spills into the next tick (the stream lags, it never gaps)
    _WATCH_BUDGET = 16

    async def _watch_head(self) -> None:
        """Follow the head — event-driven when the node event bus feeds
        notify_height (each tick consumes the notified height, no store
        poll), polling the primary otherwise — and verify each newly
        committed height once (coalesced with any concurrent request for
        it), fanning the verified header out. The stream is GAP-FREE from
        subscription time onward: `last` only advances through heights
        actually fanned out, so a stall longer than one tick delays
        headers but never drops them (backpressure and send budgets are
        the only loss modes, as documented). Provider errors back off on
        the poll cadence — the stream stalls, it never dies."""
        last: Optional[int] = None  # None = anchor at the head on tick 1
        while not self._stopped and self._subs:
            try:
                notified = self._notified_height
                if last is not None and notified is not None \
                        and notified > last:
                    # event-driven tick: the bus already told us the head
                    head_h = notified
                else:
                    head = await self.client.primary.light_block(0)
                    self._watcher_polls += 1
                    head_h = head.height
                if last is None:
                    # subscribers want heights committed AFTER they
                    # subscribed; history is light_verify's job
                    last = head_h - 1
                budget = self._WATCH_BUDGET
                while last < head_h and budget:
                    lb = await self._verify_for_stream(last + 1)
                    self._fan_out(lb)
                    last += 1
                    budget -= 1
            except FleetSaturated:
                pass  # serving pressure: retry next tick
            except LightClientError as e:
                self.logger.info("fleet head watcher error", err=str(e))
            except Exception as e:  # noqa: BLE001 - watcher must survive
                self.logger.error("fleet head watcher failure", err=str(e))
            # event-or-timeout: a notify_height wakes the watcher NOW;
            # the timeout is the store-only poll fallback
            ev = self._head_event
            if ev is not None:
                try:
                    await asyncio.wait_for(ev.wait(),
                                           timeout=self.poll_interval)
                except asyncio.TimeoutError:
                    pass
                ev.clear()
            else:
                await asyncio.sleep(self.poll_interval)
        self._watcher = None

    def publish(self, lb: LightBlock) -> None:
        """Event-driven head path (the node's NewBlock hook): cache the
        ALREADY-VERIFIED header and fan it out without a poll cycle.
        Callers must only pass headers that passed verification."""
        self.cache.put(lb)
        self._fan_out(lb)

    def _fan_out(self, lb: LightBlock) -> None:
        m = _metrics()
        for cid in list(self._subs):
            sub = self._subs[cid]
            if sub.from_height and lb.height < sub.from_height:
                continue
            if not sub.offer(lb):
                # backpressure: drop the slow consumer
                self.dropped_subscribers += 1
                self._subs.pop(cid, None)
                sub.close("backpressure")
                if m is not None:
                    m.subscriber_drops.labels("backpressure").inc()
                continue
            sub.sent += 1
            self.streamed += 1
            if m is not None:
                m.streamed.inc()
            if sub.send_budget and sub.sent >= sub.send_budget:
                self._subs.pop(cid, None)
                sub.close("budget")
                if m is not None:
                    m.subscriber_drops.labels("budget").inc()
        if m is not None:
            m.subscribers.set(len(self._subs))

    async def stop(self) -> None:
        self._stopped = True
        for cid in list(self._subs):
            self.unsubscribe(cid)
        w = self._watcher
        if w is not None:
            w.cancel()
            try:
                await w
            except (asyncio.CancelledError, Exception):  # noqa: BLE001
                pass
            self._watcher = None

    # ----------------------------------------------------------- health

    def counters(self) -> dict:
        """The cheap per-request accounting snapshot (O(1) — no latency
        sorting): what the light_verify response embeds. Full health()
        (with quantiles) is for health polls and tests, not the serving
        hot path."""
        total = self.cache.hits + self.cache.misses
        return {
            "requests": self.requests,
            "cache_hits": self.cache_hits,
            "coalesced": self.coalesced,
            "verified": self.verified,
            "amortization": round(
                (self.requests - self.shed - self.errors)
                / self.verified, 2) if self.verified else None,
            "cache_hit_rate": round(self.cache.hits / total, 4)
            if total else None,
        }

    def latency_quantiles(self) -> Optional[dict]:
        buf = sorted(self._lat)
        if not buf:
            return None
        return {
            "n": len(buf),
            "p50_ms": round(buf[len(buf) // 2] * 1e3, 3),
            "p99_ms": round(
                buf[min(len(buf) - 1, int(len(buf) * 0.99))] * 1e3, 3),
        }

    def health(self) -> dict:
        """The `light_fleet` section of crypto_health-style snapshots and
        the assertion surface for tests/bench."""
        served = self.requests - self.shed - self.errors
        n_verifs = self.verified + self.stream_verified
        return {
            "chain_id": self.chain_id,
            "requests": self.requests,
            "cache_hits": self.cache_hits,
            "coalesced": self.coalesced,
            "verified": self.verified,
            "stream_verified": self.stream_verified,
            "shed": self.shed,
            "errors": self.errors,
            # successful requests served per client-driven verification
            "amortization": round(served / self.verified, 2)
            if self.verified else None,
            "inflight": len(self._flights),
            "max_inflight": self.max_inflight,
            "subscribers": len(self._subs),
            "streamed": self.streamed,
            "dropped_subscribers": self.dropped_subscribers,
            "head_notifications": self.head_notifications,
            "request_latency": self.latency_quantiles(),
            # per-verification bisection budget: provider fetches per
            # verification (client-driven AND watcher-driven — both do
            # real bisection work), with the watcher's idle head polls
            # subtracted (providers expose a `calls` counter —
            # NodeBackedProvider does; foreign providers report None)
            "hops_per_verification": round(
                max(0, getattr(self.client.primary, "calls", 0)
                    - self._watcher_polls) / n_verifs, 2)
            if n_verifs and hasattr(self.client.primary, "calls")
            else None,
            "cache": self.cache.stats(),
            # certificate short-circuit: hops decided by a commit
            # certificate (one pairing) vs classic per-vote fallbacks
            "cert": {
                "hits": self.client.cert_hits,
                "misses": self.client.cert_misses,
                "fallbacks": self.client.cert_fallbacks,
            },
        }
