"""CListMempool — the validated tx pool (reference: mempool/clist_mempool.go).

Semantics preserved: txs enter only after an app CheckTx OK
(clist_mempool.go:251,376); an LRU cache short-circuits duplicates (the
cache also remembers invalid txs, config keep-invalid-txs-in-cache aside);
reap returns txs under byte/gas budgets in FIFO order
(clist_mempool.go:527); update removes committed txs and re-checks the
remainder against the post-block app state (clist_mempool.go:586).

Async design: one asyncio.Lock serializes structural mutation; a Condition
wakes gossip/proposal waiters when txs arrive — the clist
"wait-for-next" blocking iteration, minus the hand-rolled linked list.

The port's copy of cometbft_tpu/mempool/mempool.py. Under tx_verify="ed25519"
a tx's signature row goes to the port's verify scheduler as MEMPOOL work and
rides the next consensus flush on the card (K5, K1, K6) or the deadline
worker's batch. The node gives it the mempool metrics and the overload
registry (libs/overload), either by attribute and attach_overload, as the
reference's node does, or by the constructor's metrics= and overload=.
"""

from __future__ import annotations

import asyncio
from collections import OrderedDict
from dataclasses import dataclass, field

from cometbft_tpu_torch.abci import types as abci
from cometbft_tpu_torch.abci.client import Client
from cometbft_tpu_torch.types.block import tx_hash


class ErrTxInCache(Exception):
    pass


class ErrMempoolIsFull(Exception):
    """Admission shed: the pool (or the plane behind it) cannot absorb
    the tx right now. `plane` names WHICH pressure shed it ("mempool" =
    pool caps / saturated watermark, "sched" = verify-scheduler
    backpressure) so the RPC surface can serve the unified -32005 wire
    shape; `retry_after_ms` is the overload registry's hint when one
    was attached."""

    def __init__(self, *args, plane: str = "mempool",
                 retry_after_ms: int = 0):
        super().__init__(*args)
        self.plane = plane
        self.retry_after_ms = retry_after_ms


class ErrTxTooLarge(Exception):
    pass


class ErrTxBadSignature(Exception):
    """Admission-time signature gate rejected the tx (mempool tx_verify):
    either structurally unparseable or the signature failed the batched
    verification — the tx never buys an ABCI round-trip."""


# tx wire layout under tx_verify="ed25519": pub(32) || sig(64) || payload
TX_SIG_PUB = 32
TX_SIG_OVERHEAD = 96


class TxCache:
    """LRU of tx hashes (reference: mempool/cache.go LRUTxCache)."""

    def __init__(self, size: int):
        self.size = size
        self._map: OrderedDict[bytes, None] = OrderedDict()

    def push(self, tx: bytes) -> bool:
        """False if already present (moves to front either way)."""
        h = tx_hash(tx)
        if h in self._map:
            self._map.move_to_end(h)
            return False
        self._map[h] = None
        if len(self._map) > self.size:
            self._map.popitem(last=False)
        return True

    def remove(self, tx: bytes) -> None:
        self._map.pop(tx_hash(tx), None)

    def has(self, tx: bytes) -> bool:
        return tx_hash(tx) in self._map

    def reset(self) -> None:
        self._map.clear()


@dataclass
class MempoolTx:
    tx: bytes
    height: int  # height at which the tx entered the pool
    gas_wanted: int
    sender: str = ""  # peer that first sent it (gossip loop suppression)
    seq: int = 0


@dataclass
class MempoolConfig:
    size: int = 5000  # max txs (config/config.go:838)
    max_txs_bytes: int = 1 << 30  # 1 GB
    cache_size: int = 10000
    max_tx_bytes: int = 1048576
    recheck: bool = True
    keep_invalid_txs_in_cache: bool = False
    # admission-time signature gate: "" = off (reference behavior);
    # "ed25519" = txs are `pub(32) || sig(64) || payload`, the signature
    # (over payload) verifies through the global verify scheduler's
    # mempool class BEFORE the ABCI round-trip — concurrent admissions
    # coalesce into one device batch or ride a consensus flush as filler
    tx_verify: str = ""
    # post-commit recheck storms are bounded into windows of this many
    # txs, yielding the event loop between windows so admission and
    # consensus are never starved by one monolithic sweep after a big
    # block (the overload plane's pressure ladder); 0 = the reference's
    # single-sweep behavior
    recheck_window: int = 512

    def validate_basic(self) -> None:
        if self.tx_verify not in ("", "ed25519"):
            raise ValueError(f"unknown mempool tx_verify {self.tx_verify!r}")
        if self.size < 0 or self.max_txs_bytes < 0 or self.cache_size < 0:
            raise ValueError("mempool sizes cannot be negative")
        if self.recheck_window < 0:
            raise ValueError("recheck_window cannot be negative")


class CListMempool:
    def __init__(
        self,
        config: MempoolConfig,
        app_conn: Client,
        height: int = 0,
        metrics=None,
        overload=None,
    ):
        self.config = config
        self.app_conn = app_conn
        self.height = height
        self.cache = TxCache(config.cache_size)
        self._txs: OrderedDict[bytes, MempoolTx] = OrderedDict()  # hash -> tx
        self._txs_bytes = 0
        self._seq = 0
        self._lock = asyncio.Lock()
        self._tx_available = asyncio.Event()
        self.notify_available = True
        self.metrics = metrics  # libs.metrics.MempoolMetrics | None (node wires it)
        # overload resilience plane (libs/overload.py; node wires it via
        # attach_overload): saturated watermark sheds CheckTx BEFORE the
        # ABCI round-trip, elevated triggers eager expiry + gossip
        # throttling. None = the pre-overload ad-hoc behavior.
        self.overload = None
        # pressure-ladder accounting (assertion surface for the soak)
        self.recheck_windows_last = 0
        self.recheck_windows_total = 0
        self.eager_expired = 0
        # in-flight CheckTx dedup: tx hash -> future of the FIRST
        # submission's result; concurrent duplicates await it instead of
        # paying a second ABCI round-trip (or racing the cache)
        self._inflight: dict[bytes, asyncio.Future] = {}
        if overload is not None:
            self.attach_overload(overload)

    def attach_overload(self, registry) -> None:
        """Wire the node's overload registry: registers this pool's
        utilization signal and enables the pressure ladder."""
        self.overload = registry
        registry.register("mempool", self._overload_utilization)

    def _overload_utilization(self) -> float:
        """Pool pressure as a fraction of capacity (txs or bytes,
        whichever is tighter)."""
        return max(
            len(self._txs) / max(1, self.config.size),
            self._txs_bytes / max(1, self.config.max_txs_bytes),
        )

    def _update_metrics(self) -> None:
        if self.metrics is not None:
            self.metrics.size.set(self.size())
            self.metrics.size_bytes.set(self.size_bytes())

    # ------------------------------------------------------------- sizes

    def size(self) -> int:
        return len(self._txs)

    def size_bytes(self) -> int:
        return self._txs_bytes

    def is_full(self, tx_len: int) -> bool:
        return (
            len(self._txs) >= self.config.size
            or self._txs_bytes + tx_len > self.config.max_txs_bytes
        )

    # ------------------------------------------------------------ checktx

    async def check_tx(self, tx: bytes, sender: str = "") -> abci.ResponseCheckTx:
        """Gate a tx into the pool (clist_mempool.go:251-300 CheckTx +
        resCbFirstTime). Raises for structural rejects; returns the app
        response (which may be a rejection) otherwise.

        A duplicate submitted while the first copy's CheckTx is still in
        flight resolves from the FIRST result — same response object, no
        second ABCI round-trip (the reference rejects such duplicates via
        the cache; resolving is strictly more useful to the submitter and
        costs nothing)."""
        if len(tx) > self.config.max_tx_bytes:
            raise ErrTxTooLarge(f"tx size {len(tx)} > max {self.config.max_tx_bytes}")
        if self.is_full(len(tx)):
            if self.overload is not None:
                self.overload.shed("mempool")
            raise ErrMempoolIsFull(
                f"{len(self._txs)} txs, {self._txs_bytes} bytes"
            )
        if self.overload is not None:
            # the pressure ladder's saturated rung: shed NEW work at the
            # door while the pool is at its high watermark — before the
            # tx buys a signature batch or an ABCI round-trip. Duplicates
            # of in-flight/pooled txs still resolve below (they cost
            # nothing and the submitter learns the first result).
            from cometbft_tpu_torch.libs import overload as _ovl

            if (self.overload.level("mempool") >= _ovl.SATURATED
                    and tx_hash(tx) not in self._inflight):
                self.overload.shed("mempool")
                raise ErrMempoolIsFull(
                    f"mempool saturated ({len(self._txs)}/"
                    f"{self.config.size} txs)",
                    retry_after_ms=self.overload.retry_after_ms("mempool"),
                )
        h = tx_hash(tx)
        first = self._inflight.get(h)
        if first is not None:
            try:
                res = await asyncio.shield(first)
            except asyncio.CancelledError:
                if not first.cancelled():
                    raise  # WE were cancelled, not the first submitter
                # the first submitter was cancelled mid-flight: its result
                # is unknown; fall through to the normal path (typically
                # ErrTxInCache — the pre-dedup behavior) instead of
                # propagating a foreign cancellation into this caller
                first = None
            else:
                async with self._lock:
                    if h in self._txs and sender and not self._txs[h].sender:
                        self._txs[h].sender = sender
                return res
        if not self.cache.push(tx):
            # Record the extra sender, as the reference does, then reject.
            async with self._lock:
                if h in self._txs and sender and not self._txs[h].sender:
                    self._txs[h].sender = sender
            raise ErrTxInCache()

        fut = asyncio.get_running_loop().create_future()
        self._inflight[h] = fut
        try:
            res = await self._check_tx_new(tx, sender)
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
            return res
        finally:
            self._inflight.pop(h, None)

    async def _check_tx_new(self, tx: bytes, sender: str) -> abci.ResponseCheckTx:
        """First-copy admission: optional batched signature gate, the app
        CheckTx round-trip, then pool insertion."""
        if self.config.tx_verify:
            await self._verify_tx_signature(tx)
        res = await self.app_conn.check_tx(abci.RequestCheckTx(tx=tx, type_=abci.CheckTxType.NEW))
        if res.is_ok():
            async with self._lock:
                if self.is_full(len(tx)):
                    self.cache.remove(tx)
                    raise ErrMempoolIsFull()
                self._seq += 1
                self._txs[tx_hash(tx)] = MempoolTx(
                    tx=tx, height=self.height, gas_wanted=res.gas_wanted, sender=sender,
                    seq=self._seq,
                )
                self._txs_bytes += len(tx)
                if self.notify_available:
                    self._tx_available.set()
        else:
            if not self.config.keep_invalid_txs_in_cache:
                self.cache.remove(tx)
        return res

    async def _verify_tx_signature(self, tx: bytes) -> None:
        """The batched mempool-admission path (tx_verify="ed25519"): the
        tx's signature row goes to the global verify scheduler as
        MEMPOOL-class work — it rides the next consensus/sync flush as
        filler or the deadline worker flushes it within
        sched_mempool_deadline. Scheduler backpressure (saturated queues
        while consensus is busy) surfaces as ErrMempoolIsFull: admission
        sheds load instead of queuing unboundedly."""
        from cometbft_tpu_torch import sched
        from cometbft_tpu_torch.crypto import ed25519 as _ed
        from cometbft_tpu_torch.libs import trace

        if len(tx) < TX_SIG_OVERHEAD + 1:
            self.cache.remove(tx)
            raise ErrTxBadSignature(
                f"tx of {len(tx)} bytes cannot carry pub+sig+payload")
        pub, sig = tx[:TX_SIG_PUB], tx[TX_SIG_PUB:TX_SIG_OVERHEAD]
        payload = tx[TX_SIG_OVERHEAD:]
        # admission timeline: submit -> (queue wait inside the scheduler,
        # attributed there) -> resolved future. A slow admit is a root
        # span, so it lands in the slow capture ring with its batch tree.
        # the `with` covers EVERY exit below: an exception escaping an
        # unfinished span would leak it on this task's contextvar,
        # silently reparenting every later span on the connection
        with trace.span("mempool.admit", cat="mempool",
                        tx_bytes=len(tx)) as admit_sp:
            try:
                futs = sched.get().submit(
                    [(_ed.PubKey(pub), payload, sig)], klass=sched.MEMPOOL)
            except sched.SchedulerSaturated as e:
                admit_sp.set(outcome="saturated")
                self.cache.remove(tx)
                retry = 0
                if self.overload is not None:
                    self.overload.shed("sched")
                    retry = self.overload.retry_after_ms("sched")
                raise ErrMempoolIsFull(
                    f"verify scheduler saturated: {e}",
                    plane="sched", retry_after_ms=retry) from e
            # bounded wait: the scheduler resolves within its deadline
            # plus, worst case, one device-watchdog window (hang ->
            # supervisor -> host oracle). A timeout here means something
            # is deeply wrong — shed the tx rather than wedging this RPC
            # coroutine forever.
            from cometbft_tpu_torch.ops import dispatch as _dispatch

            try:
                ok = await asyncio.wait_for(
                    asyncio.wrap_future(futs[0]),
                    timeout=_dispatch.watchdog_timeout() + 5.0)
            except asyncio.TimeoutError:
                admit_sp.set(outcome="timeout")
                self.cache.remove(tx)
                raise ErrMempoolIsFull("verify scheduler timed out") from None
            admit_sp.set(outcome="ok" if ok else "bad_signature")
        if not ok:
            if self.metrics is not None:
                self.metrics.failed_txs.inc()
            self.cache.remove(tx)
            raise ErrTxBadSignature("tx signature failed batched verification")

    async def wait_for_txs(self) -> None:
        """Block until the pool is non-empty (consensus txNotifier +
        gossip wakeup; clist WaitChan analog)."""
        await self._tx_available.wait()

    def has_txs(self) -> bool:
        return bool(self._txs)

    # -------------------------------------------------------------- reap

    def reap_max_bytes_max_gas(self, max_bytes: int, max_gas: int) -> list[bytes]:
        """FIFO reap under budgets (clist_mempool.go:527-560). Byte budget
        counts raw tx bytes; -1 = unlimited."""
        out: list[bytes] = []
        total_bytes = total_gas = 0
        for mtx in self._txs.values():
            if max_bytes >= 0 and total_bytes + len(mtx.tx) > max_bytes:
                break
            if max_gas >= 0 and total_gas + mtx.gas_wanted > max_gas:
                break
            total_bytes += len(mtx.tx)
            total_gas += mtx.gas_wanted
            out.append(mtx.tx)
        return out

    def reap_max_txs(self, n: int) -> list[bytes]:
        if n < 0:
            return [m.tx for m in self._txs.values()]
        return [m.tx for m in list(self._txs.values())[:n]]

    def iter_txs(self) -> list[MempoolTx]:
        """Snapshot for the gossip routine."""
        return list(self._txs.values())

    # ------------------------------------------------------------- update

    async def update(
        self,
        height: int,
        txs: list[bytes],
        tx_results: list[abci.ExecTxResult],
    ) -> None:
        """Post-commit maintenance (clist_mempool.go:586-650): drop
        committed txs (valid ones stay cached for dedup; invalid ones leave
        the cache so they can be resubmitted), then re-check survivors.
        Caller must hold the commit lock (consensus does, via lock())."""
        self.height = height
        for tx, res in zip(txs, tx_results):
            if res.is_ok():
                self.cache.push(tx)
            elif not self.config.keep_invalid_txs_in_cache:
                self.cache.remove(tx)
            mtx = self._txs.pop(tx_hash(tx), None)
            if mtx is not None:
                self._txs_bytes -= len(mtx.tx)
        if self.overload is not None:
            from cometbft_tpu_torch.libs import overload as _ovl

            if self.overload.level("mempool") >= _ovl.ELEVATED:
                self._eager_expire()
        if self.config.recheck and self._txs:
            if self.metrics is not None:
                self.metrics.recheck_times.inc()
            await self._recheck_txs()
        if not self._txs:
            self._tx_available.clear()
        self._update_metrics()

    def _eager_expire(self) -> None:
        """The pressure ladder's elevated rung: TTL-style expiry of the
        OLDEST queued txs (longest-waiting = most likely stale against
        post-block state, and the bulk of the next recheck storm) until
        the pool is back under the elevated watermark's hysteresis
        floor. Expired txs leave the cache so a submitter that still
        wants one can resubmit once pressure clears."""
        target = max(
            1, int(self.config.size
                   * (self.overload.elevated - self.overload.hysteresis)))
        expired = 0
        while len(self._txs) > target:
            h, mtx = next(iter(self._txs.items()))
            self._txs.pop(h, None)
            self._txs_bytes -= len(mtx.tx)
            self.cache.remove(mtx.tx)
            expired += 1
        if expired:
            self.eager_expired += expired
            self.overload.shed("mempool", expired)

    async def _recheck_txs(self) -> None:
        """Re-validate remaining txs against post-block state
        (clist_mempool.go recheckTxs) — in bounded windows of
        config.recheck_window txs, yielding the event loop between
        windows so a post-big-block recheck storm never starves
        admission or consensus (each window is roughly one scheduler
        batch budget of app round-trips)."""
        items = list(self._txs.items())
        window = self.config.recheck_window or len(items) or 1
        self.recheck_windows_last = 0
        for start in range(0, len(items), window):
            self.recheck_windows_last += 1
            self.recheck_windows_total += 1
            batch = [(h, mtx) for h, mtx in items[start:start + window]
                     if h in self._txs]  # expired/committed mid-storm
            # the window's re-checks fly CONCURRENTLY — the reference
            # fires every recheck request without awaiting responses
            # one-by-one (clist_mempool.go recheckTxs), and a sequential
            # sweep here costs one event-loop round-trip per tx: under
            # admission load that stretches finalize past the rest of
            # the net's next round, which is exactly the liveness hole
            # the overload plane exists to close
            results = await asyncio.gather(*(
                self.app_conn.check_tx(
                    abci.RequestCheckTx(tx=mtx.tx,
                                        type_=abci.CheckTxType.RECHECK))
                for _, mtx in batch))
            for (h, mtx), res in zip(batch, results):
                if not res.is_ok() and h in self._txs:
                    self._txs.pop(h, None)
                    self._txs_bytes -= len(mtx.tx)
                    if not self.config.keep_invalid_txs_in_cache:
                        self.cache.remove(mtx.tx)
            if start + window < len(items):
                # yield: queued admissions and consensus work interleave
                # between windows instead of waiting out the whole sweep
                await asyncio.sleep(0)

    async def flush(self) -> None:
        """Drop everything (RPC unsafe_flush_mempool)."""
        async with self._lock:
            self._txs.clear()
            self._txs_bytes = 0
            self.cache.reset()
            self._tx_available.clear()
