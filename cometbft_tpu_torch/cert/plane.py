"""CertPlane: the service that keeps the certificate store full.

Production is event-driven: the plane subscribes to NewBlock on the
node's EventBus (the same bridge the light fleet's head watcher rides)
and certifies each height the moment its commit lands — no polling
while the bus is live, which a regression test asserts via the
`poll_ticks` counter. Nodes without a bus (inspect shims, tests) fall
back to a store poll. A bounded backfill worker walks [base, head] in
batches so a node that enables the plane late — or restarts with an
empty cert db — converges on full coverage of the retained range while
the chain keeps advancing.

Commit-source discipline: the store's serving convention is
`load_block_commit(h) or load_seen_commit(h)` (canonical first). The
plane certifies with the same preference, and when the CANONICAL commit
for h-1 appears (written when block h saves) it re-checks the stored
certificate against it — a seen-commit cert whose round or signer set
differs from canonical is rebuilt, so a served certificate always
attests the commit the node actually serves next to it.

Uncertifiable (sets, commits) — mixed/ed25519 validator sets, empty or
sub-threshold commits — are counted and skipped; every consumer keeps
the classic per-vote path. A BLS set with the backend disabled raises
inside build_certificate; the plane counts it as a production failure
and logs loudly rather than dying (the verify paths enforce the same
misconfiguration with a raise, so it cannot go unnoticed).

The port's copy of cometbft_tpu/cert/plane.py.
"""

from __future__ import annotations

import asyncio

from cometbft_tpu_torch.cert.certificate import build_certificate, matches_commit
from cometbft_tpu_torch.cert.store import CertStore
from cometbft_tpu_torch.libs import log as cmtlog
from cometbft_tpu_torch.libs.service import BaseService

DEFAULT_POLL_INTERVAL = 1.0
DEFAULT_BACKFILL_BATCH = 32


class CertPlane(BaseService):
    def __init__(
        self,
        store: CertStore,
        block_store,
        state_store,
        chain_id: str,
        event_bus=None,
        backfill: bool = True,
        backfill_batch: int = DEFAULT_BACKFILL_BATCH,
        poll_interval: float = DEFAULT_POLL_INTERVAL,
        metrics=None,
        logger: cmtlog.Logger | None = None,
    ):
        super().__init__("CertPlane", logger)
        self.store = store
        self.block_store = block_store
        self.state_store = state_store
        self.chain_id = chain_id
        self.event_bus = event_bus
        self.backfill_enabled = backfill
        self.backfill_batch = max(1, int(backfill_batch))
        self.poll_interval = poll_interval
        self.metrics = metrics
        self._tasks: list[asyncio.Task] = []
        self._sub = None
        # counters (health() surfaces all of them; consumers bump the
        # serve/verify/fallback side through the count_* helpers)
        self.produced = 0
        self.rebuilt = 0  # seen-commit certs realigned to canonical
        self.uncertifiable = 0
        self.produce_failures = 0
        self.backfilled = 0
        self.served = 0
        self.verified = 0
        self.verify_failures = 0
        self.fallbacks = 0
        self.bus_events = 0
        self.poll_ticks = 0  # MUST stay 0 while the bus is live

    # ------------------------------------------------------------ produce

    def _load_commit(self, height: int):
        return (self.block_store.load_block_commit(height)
                or self.block_store.load_seen_commit(height))

    def certify_height(self, height: int, *, backfill: bool = False) -> bool:
        """Certify one height from the stored commit + validator set.
        True when a certificate exists afterwards (fresh or prior);
        False when the height is uncertifiable or material is missing.
        Synchronous and idempotent — exposed for tests and backfill."""
        if height <= 0:
            return False
        if self.store.has(height):
            return True
        commit = self._load_commit(height)
        if commit is None:
            return False
        vals = self.state_store.load_validators(height)
        if vals is None:
            return False
        try:
            cert = build_certificate(self.chain_id, vals, commit)
        except Exception as e:  # noqa: BLE001 - keep the plane alive
            self.produce_failures += 1
            self.logger.error("certificate production failed",
                              height=height, err=str(e))
            return False
        if cert is None:
            self.uncertifiable += 1
            return False
        self.store.put(cert)
        self.produced += 1
        if backfill:
            self.backfilled += 1
        if self.metrics is not None:
            self.metrics.cert_produced.inc()
            if backfill:
                self.metrics.cert_backfilled.inc()
        return True

    def _realign_canonical(self, height: int) -> None:
        """Once the canonical commit for `height` exists, make the
        stored certificate attest IT (the commit every serving path
        returns), rebuilding a seen-commit cert that differs."""
        if height <= 0:
            return
        canon = self.block_store.load_block_commit(height)
        if canon is None:
            return
        cert = self.store.get(height)
        if cert is not None and matches_commit(cert, canon):
            return
        vals = self.state_store.load_validators(height)
        if vals is None:
            return
        try:
            fresh = build_certificate(self.chain_id, vals, canon)
        except Exception as e:  # noqa: BLE001
            self.produce_failures += 1
            self.logger.error("certificate realign failed",
                              height=height, err=str(e))
            return
        if fresh is None:
            if cert is None:
                self.uncertifiable += 1
            return
        self.store.put(fresh)
        if cert is None:
            self.produced += 1
            if self.metrics is not None:
                self.metrics.cert_produced.inc()
        else:
            self.rebuilt += 1

    def _on_new_height(self, height: int) -> None:
        self.certify_height(height)
        self._realign_canonical(height - 1)

    # ------------------------------------------------------------ consume

    def serve(self, height: int) -> bytes | None:
        """Encoded certificate bytes for a consumer (RPC, blocksync),
        counting the serve. None when absent/quarantined."""
        raw = self.store.get_raw(height)
        if raw is not None:
            self.served += 1
            if self.metrics is not None:
                self.metrics.cert_served.inc()
        return raw

    def count_verified(self) -> None:
        self.verified += 1
        if self.metrics is not None:
            self.metrics.cert_verified.inc()

    def count_fallback(self) -> None:
        """A consumer held a certificate but ran the classic per-vote
        path anyway (invalid/mismatched/corrupt cert). The fallback
        invariant makes this a counted degradation, never a verdict."""
        self.fallbacks += 1
        if self.metrics is not None:
            self.metrics.cert_fallbacks.inc()

    def count_verify_failure(self) -> None:
        self.verify_failures += 1

    # ------------------------------------------------------------ service

    async def on_start(self) -> None:
        loop = asyncio.get_running_loop()
        if self.event_bus is not None:
            from cometbft_tpu_torch.types import event_bus as eb

            try:
                self._sub = self.event_bus.subscribe(
                    "cert-plane", eb.QUERY_NEW_BLOCK)
            except Exception:  # noqa: BLE001 - no server/already subscribed
                self._sub = None
        if self._sub is not None:
            self._tasks.append(loop.create_task(
                self._event_loop(), name="cert-plane-events"))
        else:
            self._tasks.append(loop.create_task(
                self._poll_loop(), name="cert-plane-poll"))
        if self.backfill_enabled:
            self._tasks.append(loop.create_task(
                self._backfill_loop(), name="cert-plane-backfill"))

    async def on_stop(self) -> None:
        for t in self._tasks:
            t.cancel()
        for t in self._tasks:
            try:
                await t
            except (asyncio.CancelledError, Exception):  # noqa: BLE001
                pass
        self._tasks.clear()
        if self._sub is not None and self.event_bus is not None:
            try:
                self.event_bus.unsubscribe_all("cert-plane")
            except Exception:  # noqa: BLE001
                pass
            self._sub = None

    async def _event_loop(self) -> None:
        sub = self._sub
        while True:
            msg = await sub.out.get()
            if msg is None:  # cancellation wake-up
                if sub.canceled is not None:
                    return
                continue
            block = getattr(msg.data, "block", None)
            header = getattr(block, "header", None)
            height = getattr(header, "height", None)
            if not height:
                continue
            self.bus_events += 1
            try:
                self._on_new_height(int(height))
            except Exception as e:  # noqa: BLE001 - keep the pump alive
                self.logger.error("cert event handling failed",
                                  height=height, err=str(e))

    async def _poll_loop(self) -> None:
        """Store-poll fallback for nodes without an event bus. Never
        runs alongside the event loop — poll_ticks counts its
        iterations, and the bus-liveness regression test pins it at 0."""
        last = 0
        while True:
            self.poll_ticks += 1
            try:
                head = self.block_store.height()
                while last < head:
                    last += 1
                    self._on_new_height(last)
            except Exception as e:  # noqa: BLE001
                self.logger.error("cert poll failed", err=str(e))
            await asyncio.sleep(self.poll_interval)

    async def _backfill_loop(self) -> None:
        """Bounded historical certification: walk [base, head] in
        batches, yielding between heights so production stays ahead of
        backfill and the loop never starves the node."""
        while True:
            try:
                base = max(1, self.block_store.base())
                head = self.block_store.height()
                missing = self.store.missing_in(base, head,
                                                self.backfill_batch)
            except Exception as e:  # noqa: BLE001
                self.logger.error("cert backfill scan failed", err=str(e))
                missing = []
            progressed = 0
            for h in missing:
                try:
                    if self.certify_height(h, backfill=True):
                        progressed += 1
                except Exception as e:  # noqa: BLE001
                    self.logger.error("cert backfill failed",
                                      height=h, err=str(e))
                await asyncio.sleep(0)
            # an uncertifiable range (ed25519 history) yields no
            # progress; sleep the full interval instead of spinning
            await asyncio.sleep(
                0.05 if progressed and len(missing) >= self.backfill_batch
                else self.poll_interval)

    # ------------------------------------------------------ observability

    def health(self) -> dict:
        return {
            "certified_heights": self.store.count(),
            "produced": self.produced,
            "rebuilt": self.rebuilt,
            "backfilled": self.backfilled,
            "uncertifiable": self.uncertifiable,
            "produce_failures": self.produce_failures,
            "served": self.served,
            "verified": self.verified,
            "verify_failures": self.verify_failures,
            "fallbacks": self.fallbacks,
            "quarantined": self.store.quarantined,
            "bus_events": self.bus_events,
            "poll_ticks": self.poll_ticks,
        }
