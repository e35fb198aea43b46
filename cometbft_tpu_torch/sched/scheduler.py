"""VerifyScheduler — node-wide continuous batching of signature work on one
card. The port's copy of cometbft_tpu/sched/scheduler.py.

A card fed by each caller alone runs many small batches: a consensus
flush here, a blocksync window there, single mempool admissions. This
queue coalesces them, the way an inference server batches requests:

  producers  consensus commit checks, blocksync and light-client windows,
             mempool admission: all hand in rows of (pub_key, msg, sig).
  classes    CONSENSUS > SYNC > LIGHT > MEMPOOL. verify_now()/verify_many()
             drain IMMEDIATELY on the calling thread and take queued work
             that fits the bucket along as riders. submit() queues rows
             with a deadline and returns one future a row: the next inline
             drain carries them, or the deadline worker flushes them.
  bucketing  a batch dispatches at the kernels' bucket ladder
             (ed25519_kernel.bucket_size): powers of two to 2048, then
             multiples of 2048. warmup() runs the ladder once.
  fairness   bounded queues; mempool admission is refused
             (SchedulerSaturated) while higher classes fill the buckets;
             a group waiting past `starvation_limit` rides the next batch
             whatever its class.
  dispatch   one batch groups its rows by scheme and launches each scheme's
             rows (ed25519 and sr25519 with ed25519_kernel.verify_batch_async:
             K5 -> K1/K2 -> K6; bls12381 with bls_kernel.verify_batch_async:
             B1 -> B2 -> B4 -> B5 -> K6; on the dispatch stream,
             ops/dispatch.py), then resolves every scheme's batch with one
             resolve_batches: one header fetch. Each producer group is a recheck group with its own
             budget. A failing batch fails its groups' futures and raises.
  mesh       on the "gpu" backend with an active fault-domain mesh
             (parallel/mesh.py: two or more domains installed or visible),
             each scheme's rows go to mesh.verify_async instead, with the
             batch's highest class as its placement class (consensus pins
             to one domain, the others spread); every mesh batch is joined,
             even after one raised. A flush may then coalesce max_lanes
             times the live domains. With one card and no mesh installed
             the mesh is inactive and nothing changes.
  rechecks   an inline drain rechecks only its own groups' rejected lanes
             on the host oracle before it returns; its riders' rechecks run
             on the deadline worker, which then resolves their futures. A
             consensus caller never waits for the ~4 ms a lane of a bad
             mempool signature costs the oracle (the reference rechecks
             every group of the batch on the draining thread: ROADMAP
             Queue 3).

Left out of the reference: the "sched.flush" chaos site and its
fragmented fallback, trace spans and Prometheus metrics, and the
host-oracle rung for schemes without a kernel (every scheme the port has
runs on a kernel; the "cpu" backend runs the same batches on the kernels'
plain versions).

Threads: the core is lock-guarded. Inline drains run on the caller's
thread; one daemon worker, started by the first submit(), serves
deadlines. Both dispatch through the dispatch lock, on the single-card
path's stream or, through the mesh, on its domains' streams.
"""

from __future__ import annotations

import bisect
import concurrent.futures
import contextvars
import functools
import logging
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass

import numpy as np

# priority classes, highest first
CONSENSUS = "consensus"
SYNC = "sync"
LIGHT = "light"
MEMPOOL = "mempool"
CLASSES = (CONSENSUS, SYNC, LIGHT, MEMPOOL)

# grace beyond a group's deadline before its flush counts as a miss
_MISS_SLACK = 0.005


class SchedulerSaturated(Exception):
    """Mempool-class admission refused: the queues already hold more work
    than the next buckets take. Callers shed load instead of queuing."""


# The ambient class of verifiers made through crypto/batch, whose factories
# take no class. Consensus is the default, so that unlabelled paths are
# never starved behind filler. A ContextVar: per task under asyncio, per
# thread otherwise.
_ambient: contextvars.ContextVar = contextvars.ContextVar("verify_work_class", default=None)


def current_class() -> str:
    return _ambient.get() or CONSENSUS


@contextmanager
def work_class(klass: str):
    """Set the ambient priority class for verifiers made in this extent."""
    if klass not in CLASSES:
        raise ValueError(f"unknown verify class {klass!r} (classes: {CLASSES})")
    token = _ambient.set(klass)
    try:
        yield
    finally:
        _ambient.reset(token)


class RowColumns:
    """A producer group's rows split by key type, as the batches take them:
    by_type maps a key type to (pub key bytes, msgs, sigs, the rows'
    positions in the group). A message stays factored (PrefixedMsg) or is
    bytes. Built once by the producer (crypto.batch's client adds to it row
    by row), so the scheduler does not walk the rows again."""

    __slots__ = ("by_type", "n")

    def __init__(self):
        self.by_type: dict[str, tuple[list, list, list, list]] = {}
        self.n = 0

    def __len__(self) -> int:
        return self.n

    def add(self, key_type: str, pub: bytes, msg, sig: bytes) -> None:
        cols = self.by_type.get(key_type)
        if cols is None:
            cols = self.by_type[key_type] = ([], [], [], [])
        cols[0].append(pub)
        cols[1].append(msg)
        cols[2].append(sig)
        cols[3].append(self.n)
        self.n += 1

    @classmethod
    def of(cls, rows) -> "RowColumns":
        """Rows of (crypto.PubKey, msg, sig) as columns (RowColumns as
        they are)."""
        if isinstance(rows, cls):
            return rows
        from cometbft_tpu_torch.libs.prefixrows import PrefixedMsg

        out = cls()
        for pub, msg, sig in rows:
            out.add(pub.type_(), pub.bytes_(), msg if isinstance(msg, PrefixedMsg) else bytes(msg),
                    bytes(sig))
        return out

    @classmethod
    def single(cls, key_type: str, pubs: list[bytes], msgs: list, sigs: list[bytes]
               ) -> "RowColumns":
        """Columns of rows of one key type, in order."""
        out = cls()
        out.by_type[key_type] = (pubs, msgs, sigs, range(len(sigs)))
        out.n = len(sigs)
        return out


@dataclass(eq=False)  # identity semantics: groups are queue entries
class _Group:
    """One producer group: rows verified together with one recheck budget.
    `unit` names the producer call it came in (a verify_many window is one
    unit of several groups): the fragmented-baseline accounting pads each
    unit to its own bucket, as a batch of its own would have been. A rider
    of an inline drain has its recheck deferred to the deadline worker:
    `pending` then holds what the recheck needs."""

    klass: str
    rows: RowColumns
    submitted_at: float
    unit: int = 0
    deadline: float | None = None  # monotonic; None = inline only
    futures: list[concurrent.futures.Future] | None = None
    mask: np.ndarray | None = None
    flips: int = 0  # lanes the host recheck flipped to valid
    rider: bool = False
    pending: list | None = None  # [(BatchThunk, a, b, positions)]

    def resolve(self, mask: np.ndarray) -> None:
        self.mask = mask
        if self.futures is not None:
            for fut, ok in zip(self.futures, mask):
                if not fut.done():
                    fut.set_result(bool(ok))

    def fail(self, exc: BaseException) -> None:
        if self.futures is not None:
            for fut in self.futures:
                if not fut.done():
                    fut.set_exception(exc)


def _schemes() -> dict:
    """Key type -> the function that stages and launches a batch of its rows
    (pubs, msgs, sigs, device=, recheck_groups=) and returns its thunk."""
    from cometbft_tpu_torch.ops import bls_kernel, ed25519_kernel, sr25519_kernel

    return {"ed25519": functools.partial(ed25519_kernel.verify_batch_async,
                                         ed25519_kernel.ED25519),
            "sr25519": functools.partial(ed25519_kernel.verify_batch_async,
                                         sr25519_kernel.SR25519),
            bls_kernel.SCHEME: bls_kernel.verify_batch_async}


class VerifyScheduler:
    """The node-wide verify queue; one a process (sched.get())."""

    def __init__(self, max_lanes: int = 16384, sync_deadline: float = 0.002,
                 light_deadline: float = 0.004, mempool_deadline: float = 0.010,
                 queue_limit: int = 16384, starvation_limit: float = 0.25,
                 clock=time.monotonic):
        self.max_lanes = max_lanes
        self.class_deadline = {CONSENSUS: 0.0, SYNC: sync_deadline, LIGHT: light_deadline,
                               MEMPOOL: mempool_deadline}
        self.queue_limit = queue_limit
        self.starvation_limit = starvation_limit
        self._clock = clock
        self._cond = threading.Condition()
        self._queues: dict[str, list[_Group]] = {k: [] for k in CLASSES}
        # rows queued per class, kept in step with _queues
        self._depth: dict[str, int] = {k: 0 for k in CLASSES}
        self._worker: threading.Thread | None = None
        self._stop = False
        self.batches = 0
        self.rows_total = 0
        self.lanes_total = 0
        # the lanes the same groups would have taken dispatched one producer
        # call at a time (each padded to its own bucket)
        self.frag_lanes_total = 0
        self.deadline_misses = 0
        self.deadline_miss_by_class = {k: 0 for k in CLASSES}
        self.rejected = 0
        self.worker_flushes = 0
        self.recheck_flips = 0
        self.deferred_rechecks = 0  # riders rechecked by the worker
        self._rechecks: list[_Group] = []
        self._shapes: set[int] = set()
        self._class_rows = {k: 0 for k in CLASSES}
        self._unit_seq = 0
        self._lat: dict[str, list[float]] = {k: [] for k in CLASSES}

    # ------------------------------------------------------------- bucket

    @staticmethod
    def bucket_lanes(n: int) -> int:
        """The lanes a batch of n rows dispatches at: the kernels' ladder."""
        from cometbft_tpu_torch.ops import ed25519_kernel

        return ed25519_kernel.bucket_size(max(n, 1))

    def bucket_ladder(self, cap: int | None = None) -> list[int]:
        """Every lane count a batch can dispatch at, up to cap lanes."""
        from cometbft_tpu_torch.ops import ed25519_kernel as EK

        cap = cap or self.max_lanes
        out: list[int] = []
        b = EK.MIN_BUCKET
        while b <= cap and b < EK._POW2_CAP:
            out.append(b)
            b *= 2
        m = EK._POW2_CAP
        while m <= cap:
            out.append(m)
            m += EK._POW2_CAP
        return out

    @staticmethod
    def _mesh(build: bool = False):
        """The active fault-domain mesh, or None. Only the dispatch path
        builds it (build=True); health and the lane budget peek."""
        from cometbft_tpu_torch.parallel import mesh as mesh_mod

        return mesh_mod.active() if build else mesh_mod.peek_active()

    def _effective_max_lanes(self) -> int:
        """The lanes one flush may coalesce: max_lanes a domain times the
        live domains of the mesh (max_lanes without a mesh)."""
        mesh = self._mesh()
        if mesh is None:
            return self.max_lanes
        from cometbft_tpu_torch.ops import ed25519_kernel as EK

        return min(self.max_lanes * max(1, mesh.live_size_hint()), 1 << EK.MAX_BUCKET_LOG2)

    def _next_unit(self) -> int:
        with self._cond:
            self._unit_seq += 1
            return self._unit_seq

    @staticmethod
    def stream():
        """The CUDA stream the batches launch on (None on the "cpu"
        backend): the dispatch stream of ops/dispatch.py."""
        from cometbft_tpu_torch.crypto import batch as crypto_batch
        from cometbft_tpu_torch.ops import dispatch

        return dispatch.stream(crypto_batch.backend_device())

    # ------------------------------------------------------------- submit

    def submit(self, rows, klass: str = MEMPOOL,
               deadline: float | None = None) -> list[concurrent.futures.Future]:
        """Queue rows for a later batch; one Future[bool] a row. An inline
        drain takes them along, or the deadline worker flushes them within
        the class deadline. Raises SchedulerSaturated for mempool-class work
        when the queues are full."""
        if klass not in CLASSES:
            raise ValueError(f"unknown verify class {klass!r}")
        rows = RowColumns.of(rows)
        if not len(rows):
            return []
        now = self._clock()
        if deadline is None:
            deadline = now + self.class_deadline[klass]
        grp = _Group(klass=klass, rows=rows, submitted_at=now, unit=self._next_unit(),
                     deadline=deadline,
                     futures=[concurrent.futures.Future() for _ in range(len(rows))])
        with self._cond:
            depth = self._depth[klass]
            if klass == MEMPOOL:
                higher = self._depth[CONSENSUS] + self._depth[SYNC] + self._depth[LIGHT]
                if depth + len(rows) > self.queue_limit or higher >= self.queue_limit:
                    self.rejected += 1
                    raise SchedulerSaturated(
                        f"mempool verify queue at {depth} rows (limit {self.queue_limit}, "
                        f"higher-class backlog {higher})")
            elif depth + len(rows) > 4 * self.queue_limit:
                # consensus and sync are never refused (liveness), but a
                # runaway producer must show
                logging.getLogger(__name__).error(
                    "verify scheduler queue overflow: %s class at %d rows", klass, depth)
            self._queues[klass].append(grp)
            self._depth[klass] += len(grp.rows)
            self._ensure_worker_locked()
            self._cond.notify_all()
        return grp.futures

    # ------------------------------------------------------- inline drain

    def verify_now(self, rows, klass: str = CONSENSUS) -> np.ndarray:
        """Verify rows now: one batch on the calling thread, with queued
        riders up to the bucket. The (N,) bool mask of the caller's rows."""
        return self.verify_many([rows], klass)[0]

    def verify_many(self, rowlists, klass: str = CONSENSUS) -> list[np.ndarray]:
        """verify_now for a window of groups (a blocksync window of
        commits, each with its own recheck budget): one batch, one mask a
        group."""
        return [g.mask for g in self.drain(rowlists, klass)]

    def drain(self, rowlists, klass: str = CONSENSUS) -> list[_Group]:
        """verify_many's groups, resolved: each has its mask and the lanes
        the host recheck flipped (flips). A rowlist is rows of (PubKey, msg,
        sig) or a RowColumns. The riders' rechecks are left to the deadline
        worker."""
        unit = self._next_unit()
        own = [_Group(klass=klass, rows=RowColumns.of(rows), submitted_at=self._clock(),
                      unit=unit) for rows in rowlists]
        n_own = sum(len(g.rows) for g in own)
        if n_own == 0:
            for g in own:
                g.resolve(np.zeros(0, dtype=bool))
            return own
        riders = self._take_riders(n_own)
        for g in riders:
            g.rider = True
        self._dispatch(own + riders)
        return own

    def flush(self) -> int:
        """Dispatch everything queued now and run the riders' rechecks that
        wait for the worker (tests, shutdown). Returns the rows
        dispatched."""
        with self._cond:
            groups = [g for k in CLASSES for g in self._queues[k]]
            for k in CLASSES:
                self._queues[k].clear()
                self._depth[k] = 0
        try:
            if groups:
                self._dispatch(groups)
        finally:
            self._run_rechecks()
        return sum(len(g.rows) for g in groups)

    def _take_riders(self, n_own: int) -> list[_Group]:
        """Pop queued groups that fit the bucket the inline batch dispatches
        at anyway. Groups overdue past starvation_limit first (oldest
        first), then strict class order."""
        with self._cond:
            queued = sum(self._depth.values())
            if queued == 0:
                return []
            target = self.bucket_lanes(min(n_own + queued, self._effective_max_lanes()))
            space = target - n_own
            out: list[_Group] = []
            now = self._clock()
            overdue = sorted((g for k in CLASSES for g in self._queues[k]
                              if now - g.submitted_at > self.starvation_limit),
                             key=lambda g: g.submitted_at)
            seen = set(map(id, overdue))
            candidates = overdue + [g for k in CLASSES for g in self._queues[k]
                                    if id(g) not in seen]
            for g in candidates:
                if len(g.rows) > space:
                    continue
                out.append(g)
                space -= len(g.rows)
            for g in out:
                self._queues[g.klass].remove(g)
                self._depth[g.klass] -= len(g.rows)
            return out

    # ----------------------------------------------------------- dispatch

    def _dispatch(self, groups: list[_Group]) -> None:
        """Form and run batches for the groups (chunks of at most
        _effective_max_lanes() rows, a group never split; a group larger
        than that runs alone) and resolve every mask and future. A failing
        chunk fails its own futures; the later chunks still run, then the
        first error is raised."""
        if not groups:
            return
        chunks: list[list[_Group]] = []
        chunk: list[_Group] = []
        chunk_rows = 0
        budget = self._effective_max_lanes()
        for g in groups:
            if chunk and chunk_rows + len(g.rows) > budget:
                chunks.append(chunk)
                chunk, chunk_rows = [], 0
            chunk.append(g)
            chunk_rows += len(g.rows)
        if chunk:
            chunks.append(chunk)
        first_exc: Exception | None = None
        for c in chunks:
            try:
                self._dispatch_core(c)
            except Exception as exc:  # noqa: BLE001 - re-raised below
                first_exc = first_exc or exc
        if first_exc is not None:
            raise first_exc

    def _dispatch_core(self, groups: list[_Group]) -> None:
        """One batch: run it, keep the stats, resolve each group."""
        n_rows = sum(len(g.rows) for g in groups)
        lanes = self.bucket_lanes(n_rows)
        try:
            masks = self._run_batch(groups)
        except Exception as exc:
            for g in groups:
                g.fail(exc)
            raise
        now = self._clock()
        with self._cond:
            self.batches += 1
            self.rows_total += n_rows
            self.lanes_total += lanes
            self._shapes.add(lanes)
            unit_rows: dict[int, int] = {}
            for g in groups:
                unit_rows[g.unit] = unit_rows.get(g.unit, 0) + len(g.rows)
                self._class_rows[g.klass] += len(g.rows)
                self.recheck_flips += g.flips
            for nr in unit_rows.values():
                self.frag_lanes_total += self.bucket_lanes(nr)
            for g in groups:
                buf = self._lat[g.klass]
                buf.append(now - g.submitted_at)
                if len(buf) > 4096:
                    del buf[:2048]
                if g.deadline is not None and now > g.deadline + _MISS_SLACK:
                    self.deadline_misses += 1
                    self.deadline_miss_by_class[g.klass] += 1
        deferred = []
        for g, mask in zip(groups, masks):
            if g.pending:
                g.mask = mask
                deferred.append(g)
            else:
                g.resolve(mask)
        if deferred:
            with self._cond:
                self._rechecks.extend(deferred)
                self._ensure_worker_locked()
                self._cond.notify_all()

    def _run_batch(self, groups: list[_Group]) -> list[np.ndarray]:
        """Concatenate the groups' columns by scheme, launch each scheme's
        rows as one batch (each group's rows one recheck group; a rider's
        not rechecked here), resolve them all with one fetch, and put the
        masks (and the recheck's flips) back into the groups. A rider with a
        rejected lane the oracle would recheck gets `pending`. With an
        active mesh on the "gpu" backend each scheme's rows go to the mesh
        instead (its batches joined one by one, every one even after one
        raised). Host time: "sched" (concatenating and slicing) in the parts
        of ed25519_kernel.timed_parts."""
        from cometbft_tpu_torch import crypto
        from cometbft_tpu_torch.crypto import batch as crypto_batch
        from cometbft_tpu_torch.ops import ed25519_kernel as EK

        mesh = self._mesh(build=True) if crypto_batch.get_backend() == "gpu" else None
        schemes = _schemes()
        # key type -> (pubs, msgs, sigs, spans [(group index, a, b)])
        per: dict[str, tuple[list, list, list, list]] = {}
        with EK.host_part("sched"):
            for gi, g in enumerate(groups):
                for kt, (pubs, msgs, sigs, _) in g.rows.by_type.items():
                    d = per.get(kt)
                    if d is None:
                        if kt not in schemes:
                            raise crypto.ErrInvalidKey(f"key type {kt!r} has no verify kernel")
                        d = per[kt] = ([], [], [], [])
                    a = len(d[2])
                    d[0].extend(pubs)
                    d[1].extend(msgs)
                    d[2].extend(sigs)
                    d[3].append((gi, a, a + len(sigs)))
        if mesh is None:
            device = crypto_batch.backend_device()
            thunks = [schemes[kt](pubs, msgs, sigs, device=device,
                                  recheck_groups=[(a, b) for gi, a, b in spans
                                                  if not groups[gi].rider])
                      for kt, (pubs, msgs, sigs, spans) in per.items()]
            resolved = EK.resolve_batches(thunks)
        else:
            # the batch's placement class: its highest member's
            klass = next(k for k in CLASSES if any(g.klass == k for g in groups))
            thunks = [mesh.verify_async(kt, pubs, msgs, sigs, klass=klass,
                                        recheck_groups=[(a, b) for gi, a, b in spans
                                                        if not groups[gi].rider])
                      for kt, (pubs, msgs, sigs, spans) in per.items()]
            resolved, err = [], None
            for t in thunks:
                try:
                    resolved.append(t())
                except Exception as exc:  # noqa: BLE001 - raised once all are joined
                    err = err or exc
            if err is not None:
                raise err
        with EK.host_part("sched"):
            out = [np.zeros(len(g.rows), dtype=bool) for g in groups]
            for (kt, (_, _, _, spans)), mask, thunk in zip(per.items(), resolved, thunks):
                eligible = thunk.eligible
                for gi, a, b in spans:
                    g = groups[gi]
                    pos = g.rows.by_type[kt][3]
                    if len(g.rows.by_type) == 1:
                        out[gi] = mask[a:b].copy()
                    else:
                        out[gi][pos] = mask[a:b]
                    if g.rider and (eligible[a:b] & ~mask[a:b]).any():
                        g.pending = (g.pending or []) + [(thunk, a, b, pos)]
                starts = [a for _, a, _ in spans]
                for lane in thunk.flipped:
                    groups[spans[bisect.bisect_right(starts, lane) - 1][0]].flips += 1
        return out

    def _run_rechecks(self) -> None:
        """Recheck the deferred riders' rejected lanes on the host oracle
        (each rider its own budget a scheme, as apply_recheck), then resolve
        their futures. A recheck that raises fails its rider's futures."""
        from cometbft_tpu_torch.ops import ed25519_kernel as EK

        while True:
            with self._cond:
                if not self._rechecks:
                    return
                g = self._rechecks.pop(0)
            try:
                mask, flips = g.mask, 0
                for thunk, a, b, pos in g.pending:
                    pubs, msgs, sigs = thunk.rows
                    sub, f = EK.recheck_failed_lanes(
                        mask[pos], thunk.eligible[a:b], pubs[a:b], msgs[a:b], sigs[a:b],
                        thunk.scheme.verify_one)
                    mask[pos] = sub
                    flips += f
            except Exception as exc:  # noqa: BLE001 - delivered through the futures
                g.fail(exc)
                continue
            g.pending = None
            g.flips += flips
            with self._cond:
                self.recheck_flips += flips
                self.deferred_rechecks += 1
            g.resolve(mask)

    # ------------------------------------------------------ deadline worker

    def _ensure_worker_locked(self) -> None:
        if self._worker is not None and self._worker.is_alive():
            return
        self._stop = False
        self._worker = threading.Thread(target=self._worker_loop, name="verify-sched",
                                        daemon=True)
        self._worker.start()

    def _worker_loop(self) -> None:
        """Run the riders' deferred rechecks, and flush the queues when the
        earliest deadline comes due and no inline drain took the groups
        first. A failing flush has failed its futures already; its error
        ends this worker (the next submit() starts another)."""
        while True:
            self._run_rechecks()
            with self._cond:
                if self._stop:
                    return
                if self._rechecks:
                    continue
                deadlines = [g.deadline for k in CLASSES for g in self._queues[k]
                             if g.deadline is not None]
                now = self._clock()
                if not deadlines:
                    self._cond.wait(timeout=0.25)
                    continue
                dl = min(deadlines)
                if dl > now:
                    self._cond.wait(timeout=min(dl - now, 0.25))
                    continue
                groups = [g for k in CLASSES for g in self._queues[k]]
                for k in CLASSES:
                    self._queues[k].clear()
                    self._depth[k] = 0
            if groups:
                self.worker_flushes += 1
                self._dispatch(groups)

    def stop(self) -> None:
        """End the worker; rechecks it left run here."""
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        if self._worker is not None:
            self._worker.join(timeout=2.0)
            self._worker = None
        self._run_rechecks()

    # -------------------------------------------------------------- warmup

    def warmup(self, max_lanes: int | None = None) -> list[int]:
        """Run one batch at every rung of the bucket ladder on the card, so
        that the first real flushes build no kernel and grow no table.
        Nothing on the "cpu" backend. Returns the lane counts run."""
        from cometbft_tpu_torch.crypto import batch as crypto_batch
        from cometbft_tpu_torch.ops import ed25519_kernel as EK

        device = crypto_batch.backend_device()
        if device.type != "cuda":
            return []
        ladder = self.bucket_ladder(max_lanes or 2048)
        for b in ladder:
            # identity rows: pub = the identity encoding, s = 0: valid
            pubs = [EK._ID_ENC32] * b
            sigs = [EK._ID_ENC32 + bytes(32)] * b
            EK.resolve_batches([EK.verify_batch_async(EK.ED25519, pubs, [b"sched-warmup"] * b,
                                                      sigs, device=device)])
        return ladder

    # ------------------------------------------------------------ snapshot

    def latency_quantiles(self) -> dict:
        """Per-class submit -> dispatch latency p50/p99 in ms (None for a
        class with no traffic)."""
        out = {}
        for k in CLASSES:
            buf = sorted(self._lat[k])
            if not buf:
                out[k] = None
                continue
            out[k] = {"n": len(buf), "p50_ms": round(buf[len(buf) // 2] * 1e3, 3),
                      "p99_ms": round(buf[min(len(buf) - 1, int(len(buf) * 0.99))] * 1e3, 3)}
        return out

    def health(self) -> dict:
        """The scheduler's counters (tests, chip_smoke)."""
        with self._cond:
            depth = dict(self._depth)
        fill = self.rows_total / self.lanes_total if self.lanes_total else None
        frag = self.rows_total / self.frag_lanes_total if self.frag_lanes_total else None
        return {
            "batches": self.batches,
            "rows_total": self.rows_total,
            "lanes_total": self.lanes_total,
            "frag_lanes_total": self.frag_lanes_total,
            "fill_ratio_mean": round(fill, 4) if fill is not None else None,
            "fragmented_fill_ratio_mean": round(frag, 4) if frag is not None else None,
            "dispatch_shapes": sorted(self._shapes),
            "bucket_ladder_len": len(self.bucket_ladder()),
            "queue_depth": depth,
            "class_rows": dict(self._class_rows),
            "deadline_misses": self.deadline_misses,
            "deadline_miss_by_class": dict(self.deadline_miss_by_class),
            "rejected": self.rejected,
            "worker_flushes": self.worker_flushes,
            "worker_alive": bool(self._worker and self._worker.is_alive()),
            "recheck_flips": self.recheck_flips,
            "deferred_rechecks": self.deferred_rechecks,
            "max_lanes": self.max_lanes,
            "effective_max_lanes": self._effective_max_lanes(),
            "mesh": self._mesh_view(),
            "deadlines": dict(self.class_deadline),
        }

    def _mesh_view(self) -> dict:
        """The topology the scheduler fills lanes against."""
        mesh = self._mesh()
        if mesh is None:
            return {"active": False}
        return {"active": True, "devices": len(mesh.chips), "live": mesh.live_size(),
                "placement": mesh.placement}
