"""Fault-domain verify mesh: the port of cometbft_tpu/parallel/mesh.py.

Two planes:

1. The SPMD plane (batch_mesh / shard_verify_kernel / sharded_verify_batch):
   one batch staged once, the verify kernel K1 launched once a domain on
   its contiguous lane slice, on that domain's stream, the masks joined.
   The quickest way to run one healthy batch over healthy domains, and as
   fragile: a fault in any domain fails the batch.

2. VerifyMesh, the fault-tolerant plane that the VerifyScheduler routes
   through. A fault domain is a device and an index: its own dispatch
   stream (ops/dispatch.stream(device, "devN")), its own key tables and
   prefix tables (put_key "devN", ops/residency.py and ops/challenge.py),
   its own DeviceSupervisor and CircuitBreaker (registry name "mesh.devN")
   and its own in-flight gate (dispatch.doublebuffer("devN")).
   VerifyMesh([cuda:0] * 4) is four domains on one card, [cpu] * 2 two on
   the CPU (the tests); the default is one domain a visible card. A batch
   is split into shards, one a domain at a time, each the single-card
   path's pipeline on its domain (ed25519 and sr25519: K5 -> K1/K2 -> K6;
   bls12381: B1 -> B2 -> B4 -> B5 -> K6, ops/bls_kernel.mesh_shard_verify)
   under the domain's supervisor:

     evict       a domain whose breaker opens leaves placement; the mesh
                 shards over the survivors
     redispatch  a shard in flight when its domain dies is dispatched again
                 over the survivors: no future is lost to a device fault
     re-probe    an open breaker whose cooldown has passed re-enters
                 placement as the half-open probe; success readmits the
                 domain, failure opens it again; transients retry in place
                 and never evict. A domain's key and prefix tables are
                 dropped at its eviction (its probe stages afresh) and at
                 its readmission (residency.invalidate_device)
     degrade     only a mesh with every domain dead runs the rows through
                 the single-card path (verify_batch_async on domain "" of
                 the first domain's device): the same kernels on the same
                 card. If that fails too, the flush raises.

   Placement is class-aware (the scheduler passes its batch's highest
   class): consensus batches pin to the least-loaded domain (one dispatch,
   the lowest latency), sync and mempool batches spread over the live
   domains, in shards of at most MAX_SHARD_ROWS rows, round robin.

   The chaos sites "ed25519.dispatch.devN" / "sr25519.dispatch.devN"
   (libs/chaos.py) fire inside each shard's dispatch beside the plain
   scheme site, so a CBFT_CHAOS schedule kills or flaps exactly one domain.

Departures from the reference (ROADMAP Queue 3): an all-dead mesh runs the
card's single-card path, which raises on failure, where the reference
degrades to its CPU rung; an ed25519 or sr25519 shard carries K5 and the K6
header with its staging checksum (the reference's shards run the bare
verify program, its known gap at mesh.py:449-457); and domains of one card
share one CUDA context, so a sticky CUDA error (an illegal address) fails
every domain of the card at once, and the mesh evicts them all.

Threads: shards run on the mesh's thread pool. Each stages and launches
under dispatch.DISPATCH_LOCK (the key caches and tables assume one
dispatching thread at a time) and fetches outside it, on its stream. The
pubkey cache's device entries are shared by the domains of a card; a
domain that reads one records its stream on it (ed25519_kernel
._stage_gather). The BLS aggregate path (validator-set key cache) runs on
domain "" only.

Domains from the environment: CBFT_MESH_DOMAINS=N makes the process's
mesh N fault domains on its first card (domains_env(env, N) writes it into
a child's environment), the counterpart of the reference's host_mesh_env,
whose JAX/XLA recipe has no meaning for torch. The mesh publishes the
reference's mesh metrics (libs/metrics.MeshMetrics: size, devices, each
domain's breaker state, shard lanes, evictions, readmissions, redispatches,
fallbacks). Left out of the reference: the mesh's trace spans and link
model (ROADMAP Queue 1 item 11).
"""

from __future__ import annotations

import concurrent.futures
import functools
import logging
import os
import threading

import numpy as np
import torch

from cometbft_tpu_torch.ops import dispatch
from cometbft_tpu_torch.ops import ed25519_kernel as EK

# placement policies
CLASS_AWARE = "class_aware"  # consensus pinned, sync/mempool spread
SPREAD = "spread"            # every batch spread over the live mesh
PINNED = "pinned"            # every batch on the least-loaded domain
PLACEMENTS = (CLASS_AWARE, SPREAD, PINNED)

# a spread shard below this many rows pads more than it parallelizes
MIN_SHARD_ROWS = EK.MIN_BUCKET

# pinning is for latency (one dispatch for a vote flush); a batch larger
# than this spreads even under a pin policy
PIN_MAX_ROWS = 2048

# spread shards stay at most one 2,048-lane bucket: a domain takes several
# shards round robin, never one giant batch
MAX_SHARD_ROWS = 2048


# the environment variable that asks for N fault domains on the first card
DOMAINS_ENV = "CBFT_MESH_DOMAINS"

# libs/metrics.MeshMetrics.mesh_breaker_state's codes
_BREAKER_CODE = {dispatch.CLOSED: 0, dispatch.HALF_OPEN: 1, dispatch.OPEN: 2}


def domains_env(base_env: dict, n_domains: int) -> dict:
    """A child process's environment whose mesh is n_domains fault domains
    on its first card (the reference's host_mesh_env, for torch)."""
    return dict(base_env, **{DOMAINS_ENV: str(n_domains)})


def _mesh_metrics():
    """The process's MeshMetrics, or None: metrics never break a verify."""
    try:
        from cometbft_tpu_torch.libs import metrics

        return metrics.mesh_metrics()
    except Exception:  # noqa: BLE001
        return None


def _visible_cards() -> list[torch.device]:
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


# ---------------------------------------------------------------------------
# the SPMD plane
# ---------------------------------------------------------------------------


def batch_mesh(devices: list | None = None) -> list[tuple[torch.device, str]]:
    """The SPMD plane's domains: (device, "devN") for each entry of
    `devices` by position (default: one a visible card)."""
    if devices is None:
        devices = _visible_cards()
    return [(torch.device(d), f"dev{i}") for i, d in enumerate(devices)]


def shard_verify_kernel(domains: list[tuple[torch.device, str]]):
    """K1 over `domains`: a function of the staged planes (A coordinates
    (20, B) int32 x4, then r/s/k words (8, B) int32, B a multiple of the
    domain count) that launches K1 once a domain on its contiguous lane
    slice, on the domain's stream after the caller's stream, and returns
    the joined (B,) int32 raw verdicts on the caller's device and stream
    (non-zero valid). On CPU tensors each slice runs K1's plain version."""
    n_dom = len(domains)

    def run(ax, ay, az, at, rw, sw, kw):
        from cometbft_tpu_torch.ops import verify_kernel as VK

        b = ax.shape[1]
        if b % n_dom:
            raise ValueError(f"{b} lanes do not divide over {n_dom} domains")
        w = b // n_dom
        home = ax.device
        src = torch.cuda.current_stream(home) if home.type == "cuda" else None
        masks = []
        for i, (dev, domain) in enumerate(domains):
            with dispatch.launching(dev, domain):
                s = dispatch.stream(dev, domain)
                if s is not None and src is not None:
                    s.wait_stream(src)
                # K1 reads (20, B) and (8, B) planes: the lane slice copied
                # contiguous on the domain's stream
                part = [t[:, i * w:(i + 1) * w].to(dev).contiguous()
                        for t in (ax, ay, az, at, rw, sw, kw)]
                masks.append(VK.verify_ok_raw(*part)[0])
        if src is not None:
            for (dev, domain), m in zip(domains, masks):
                s = dispatch.stream(dev, domain)
                if s is not None:
                    src.wait_stream(s)
                    m.record_stream(src)
        return torch.cat([m.to(home) for m in masks])

    return run


def _mesh_bucket(n: int, n_dev: int) -> int:
    b = EK.bucket_size(n)
    if b % n_dev:
        b = ((b + n_dev - 1) // n_dev) * n_dev
    return b


def sharded_verify_batch(pubs: list[bytes], msgs: list, sigs: list[bytes],
                         mesh: list[tuple[torch.device, str]] | None = None,
                         cache: EK.PubKeyCache | None = None) -> tuple[bool, list[bool]]:
    """The SPMD counterpart of ed25519_kernel.verify_batch: the classic
    path's host staging at _mesh_bucket(n, domains) lanes (structural
    checks, host challenges), the keys through the pubkey cache's full path
    on the first domain's device, K1 over the domains (shard_verify_kernel),
    one fetch. No integrity header and no host recheck, as in the
    reference; VerifyMesh is the plane with both."""
    n = len(sigs)
    if n == 0:
        return True, []
    domains = batch_mesh() if mesh is None else mesh
    if not domains:
        raise RuntimeError("sharded_verify_batch: no domain to run on")
    home = domains[0][0]
    cache = EK._cache_for(EK.ED25519, cache, home)
    b = _mesh_bucket(n, len(domains))
    pre_ok, safe_pubs, r, s, k = EK.stage_batch(pubs, msgs, sigs, b)
    with dispatch.launching(home):
        ok_a, a_dev, _ = cache.stage(safe_pubs, b)
        words = tuple(EK._words_to_device(w, home) for w in (r, s, k))
        raw = shard_verify_kernel(domains)(*a_dev, *words)
        mask = raw.cpu().numpy()[:n] != 0
    mask &= pre_ok & ok_a
    return bool(mask.all()), mask.tolist()


# ---------------------------------------------------------------------------
# VerifyMesh: fault domains
# ---------------------------------------------------------------------------


class _Chip:
    """One fault domain: a device and an index, with the supervisor and
    the load counters that placement reads."""

    __slots__ = ("index", "device", "name", "domain", "inflight_lanes", "lanes_total",
                 "shards_total")

    def __init__(self, index: int, device):
        self.index = index
        self.device = torch.device(device)
        self.name = f"mesh.dev{index}"
        self.domain = f"dev{index}"
        self.inflight_lanes = 0
        self.lanes_total = 0
        self.shards_total = 0

    @property
    def supervisor(self) -> dispatch.DeviceSupervisor:
        return dispatch.supervisor(self.name)


class MeshBatch:
    """One batch on the mesh (verify_async). Calling it joins the shards
    (redispatching those whose domain died) and returns the (N,) mask; then
    `eligible` holds the lanes the host recheck may flip, `flipped` the
    lanes it flipped and `flips` their number, and `rows`/`scheme` are a
    BatchThunk's: the scheduler reads either alike."""

    __slots__ = ("scheme", "rows", "mask", "eligible", "flipped", "flips", "_join")

    def __init__(self, scheme: EK.Scheme, rows: tuple, join):
        self.scheme, self.rows, self._join = scheme, rows, join
        self.mask = self.eligible = None
        self.flipped = np.zeros(0, dtype=np.intp)
        self.flips = 0

    def __call__(self) -> np.ndarray:
        if self.mask is None:
            self._join(self)
        return self.mask


class VerifyMesh:
    """The fault-tolerant plane over fault domains (see the module
    docstring): shards ed25519, sr25519 and bls12381 batches over the live
    domains, redispatches the shards of a domain that dies."""

    def __init__(self, devices: list | None = None, placement: str = CLASS_AWARE):
        if devices is None:
            devices = _visible_cards()
        if placement not in PLACEMENTS:
            raise ValueError(f"unknown mesh placement {placement!r} (choices: {PLACEMENTS})")
        self.chips = [_Chip(i, d) for i, d in enumerate(devices)]
        self.placement = placement
        self._lock = threading.Lock()
        self._pool: concurrent.futures.ThreadPoolExecutor | None = None
        # the last breaker-open state seen a domain: eviction and
        # readmission are counted on its changes
        self._was_open = [False] * len(self.chips)
        self.evictions = 0
        self.readmissions = 0
        self.redispatches = 0
        self.fallbacks = 0
        self.batches = 0
        self.rows_total = 0

    # ------------------------------------------------------------ plumbing

    def _executor(self) -> concurrent.futures.ThreadPoolExecutor:
        with self._lock:
            if self._pool is None:
                self._pool = concurrent.futures.ThreadPoolExecutor(
                    max_workers=max(2, len(self.chips)), thread_name_prefix="mesh-verify")
            return self._pool

    def close(self) -> None:
        """Stop the shard threads once their shards end."""
        with self._lock:
            pool, self._pool = self._pool, None
        if pool is not None:
            pool.shutdown(wait=False)

    @staticmethod
    def _scheme_ops(scheme: str) -> dict:
        """What a shard of `scheme` runs: "scheme" (the Scheme record: the
        host oracle of the recheck), "launch" (stage and launch a shard on
        a domain: the single-card path's verify_batch_async, or for BLS
        "shard_verify", which also fetches) and "fallback" (the single-card
        path of an all-dead mesh)."""
        if scheme in ("ed25519", "sr25519"):
            from cometbft_tpu_torch.ops import sr25519_kernel as SRK

            sch = EK.ED25519 if scheme == "ed25519" else SRK.SR25519
            launch = functools.partial(EK.verify_batch_async, sch)
            return {"scheme": sch, "launch": launch, "fallback": launch}
        if scheme == "bls12381":
            from cometbft_tpu_torch.ops import bls_kernel as BLSK

            return {"scheme": BLSK.BLS, "shard_verify": BLSK.mesh_shard_verify,
                    "fallback": BLSK.verify_batch_async}
        raise ValueError(f"mesh has no verify program for scheme {scheme!r}")

    # ------------------------------------------------------------ liveness

    def live_chips(self) -> list[_Chip]:
        """Domains whose breaker admits shards now (an open breaker past its
        cooldown included: a shard there is the half-open probe). Also
        where evictions and readmissions are counted. A domain's tables are
        dropped (residency.invalidate_device) when it is evicted, so that
        its half-open probe stages afresh, and when it is readmitted, as the
        reference drops them: a healed domain serves no table staged before
        its fault."""
        from cometbft_tpu_torch.ops import residency

        live: list[_Chip] = []
        mm = _mesh_metrics()
        with self._lock:
            for chip in self.chips:
                br = chip.supervisor.breaker
                is_open = br.state == dispatch.OPEN
                if is_open and not self._was_open[chip.index]:
                    self.evictions += 1
                    residency.invalidate_device(chip.index)
                    if mm is not None:
                        mm.mesh_evictions_total.inc()
                elif self._was_open[chip.index] and not is_open:
                    self.readmissions += 1
                    residency.invalidate_device(chip.index)
                    if mm is not None:
                        mm.mesh_readmissions_total.inc()
                self._was_open[chip.index] = is_open
                if br.peek():
                    live.append(chip)
                if mm is not None:
                    mm.mesh_breaker_state.labels(str(chip.index)).set(_BREAKER_CODE[br.state])
            if mm is not None:
                mm.verify_mesh_size.set(len(live))
                mm.mesh_devices.set(len(self.chips))
        return live

    def live_size(self) -> int:
        return len(self.live_chips())

    def live_size_hint(self) -> int:
        """The live count without the eviction accounting (the scheduler's
        lane budget)."""
        return sum(1 for c in self.chips if c.supervisor.breaker.peek())

    # ----------------------------------------------------------- placement

    def _plan(self, m: int, klass: str, chips: list[_Chip]) -> list[tuple[_Chip, int, int]]:
        """Split m rows into contiguous shards: consensus (and the "pinned"
        policy) on the least-loaded domain, everything else spread over
        the live domains, never a shard below MIN_SHARD_ROWS nor above
        MAX_SHARD_ROWS."""
        by_load = sorted(chips, key=lambda c: (c.inflight_lanes, c.lanes_total, c.index))
        pin = (self.placement == PINNED or (
            self.placement == CLASS_AWARE and klass == "consensus")) and m <= PIN_MAX_ROWS
        if pin or m < 2 * MIN_SHARD_ROWS or len(chips) == 1:
            return [(by_load[0], 0, m)]
        n_shards = max(1, min(len(chips), m // MIN_SHARD_ROWS))
        n_shards = max(n_shards, -(-m // MAX_SHARD_ROWS))
        targets = [by_load[i % len(by_load)] for i in range(n_shards)]
        out: list[tuple[_Chip, int, int]] = []
        base, rem = divmod(m, n_shards)
        lo = 0
        for i, chip in enumerate(targets):
            hi = lo + base + (1 if i < rem else 0)
            if hi > lo:
                out.append((chip, lo, hi))
            lo = hi
        return out

    # ------------------------------------------------------------ dispatch

    def _shard_op(self, ops: dict, scheme: str, chip: _Chip, pubs: list, msgs: list,
                  sigs: list) -> tuple[np.ndarray, np.ndarray]:
        """One domain's shard, run under its supervisor: fire the chaos
        sites, take a slot of the domain's gate, stage and launch on the
        domain's stream, let the slot go, fetch on the same stream (the
        header after this shard's K6). No host recheck: the batch's runs at
        the join. Returns (mask (n,), eligible (n,))."""
        from cometbft_tpu_torch.libs import chaos

        shard_verify = ops.get("shard_verify")
        if shard_verify is None:  # the BLS shard fires its scheme site itself
            chaos.fire(f"{scheme}.dispatch")
        chaos.fire(f"{scheme}.dispatch.dev{chip.index}")
        rel = dispatch.doublebuffer(chip.domain).acquire()
        try:
            if shard_verify is not None:
                mask, eligible = shard_verify(chip.device, pubs, msgs, sigs, chip.domain)
            else:
                thunk = ops["launch"](pubs, msgs, sigs, device=chip.device, recheck_groups=[],
                                      domain=chip.domain)
        finally:
            rel()
        if shard_verify is None:
            mask = EK.resolve_batches([thunk])[0]
            eligible = thunk.eligible
        with self._lock:
            chip.lanes_total += EK.bucket_size(len(sigs))
            chip.shards_total += 1
        mm = _mesh_metrics()
        if mm is not None:
            mm.mesh_shard_lanes.labels(str(chip.index)).inc(EK.bucket_size(len(sigs)))
        return mask, eligible

    def _submit_round(self, ops: dict, scheme: str, rows: tuple, idx: np.ndarray, klass: str,
                      chips: list[_Chip]) -> list:
        """Shard idx's rows over `chips` and submit every shard to the pool.
        Returns [(chip, sub_idx, future)]."""
        pubs, msgs, sigs = rows
        submitted = []
        for chip, lo, hi in self._plan(len(idx), klass, chips):
            sub_idx = idx[lo:hi]
            with self._lock:
                chip.inflight_lanes += EK.bucket_size(len(sub_idx))
            fut = self._executor().submit(
                chip.supervisor.run, functools.partial(
                    self._shard_op, ops, scheme, chip, [pubs[i] for i in sub_idx],
                    [msgs[i] for i in sub_idx], [sigs[i] for i in sub_idx]))
            submitted.append((chip, sub_idx, fut))
        return submitted

    @staticmethod
    def _remap_groups(groups, idx: np.ndarray):
        """Full-batch recheck-group bounds on the fallback's sub-batch (idx
        ascending): each producer keeps its own recheck budget there."""
        if not groups:
            return None
        out = []
        for a, b in groups:
            lo = int(np.searchsorted(idx, a))
            hi = int(np.searchsorted(idx, b))
            if hi > lo:
                out.append((lo, hi))
        return out or None

    def _fallback(self, ops: dict, scheme: str, rows: tuple, idx: np.ndarray,
                  batch: MeshBatch, mask: np.ndarray, eligible: np.ndarray,
                  recheck_groups) -> None:
        """Every domain dead: idx's rows run through the single-card path on
        the first domain's device (domain "": the same kernels, the same
        card), which rechecks them under the producers' remapped groups.
        Those lanes are then marked ineligible, so that the batch's recheck
        does not spend a budget on them twice; a lane outside every group
        (a scheduler rider's) stays eligible for its own recheck. A failure
        raises."""
        with self._lock:
            self.fallbacks += 1
        mm = _mesh_metrics()
        if mm is not None:
            mm.mesh_fallback_total.inc()
        logging.getLogger(__name__).error(
            "verify mesh has no live fault domain: %d %s rows on the single-card path",
            len(idx), scheme)
        pubs, msgs, sigs = rows
        sub_groups = self._remap_groups(recheck_groups, idx)
        thunk = ops["fallback"]([pubs[i] for i in idx], [msgs[i] for i in idx],
                                [sigs[i] for i in idx], device=self.chips[0].device,
                                recheck_groups=sub_groups)
        mask[idx] = EK.resolve_batches([thunk])[0]
        covered = np.ones(len(idx), dtype=bool)
        if sub_groups is not None:
            covered[:] = False
            for a, b in sub_groups:
                covered[a:b] = True
        eligible[idx] = thunk.eligible & ~covered
        batch.flipped = np.concatenate([batch.flipped, idx[thunk.flipped]])
        batch.flips += thunk.flips

    def verify_async(self, scheme: str, pubs: list[bytes], msgs: list, sigs: list[bytes],
                     klass: str = "sync",
                     recheck_groups: list[tuple[int, int]] | None = None) -> MeshBatch:
        """Shard and dispatch over the live domains without waiting; returns
        the MeshBatch whose call joins them. A shard whose domain dies is
        dispatched again over the survivors inside the join: the caller's
        futures always resolve."""
        n = len(sigs)
        if len(pubs) != n or len(msgs) != n:
            raise ValueError("pubs, msgs and sigs differ in length")
        ops = self._scheme_ops(scheme)
        rows = (list(pubs), list(msgs), list(sigs))
        idx = np.arange(n)
        if n == 0:
            batch = MeshBatch(ops["scheme"], rows, None)
            batch.mask, batch.eligible = np.zeros(0, dtype=bool), np.zeros(0, dtype=bool)
            return batch
        chips = self.live_chips()
        pending = self._submit_round(ops, scheme, rows, idx, klass, chips) if chips else []
        return MeshBatch(ops["scheme"], rows, functools.partial(
            self._join, ops, scheme, rows, idx, pending, klass, recheck_groups))

    def verify(self, scheme: str, pubs, msgs, sigs, klass: str = "sync",
               recheck_groups=None) -> np.ndarray:
        return self.verify_async(scheme, pubs, msgs, sigs, klass, recheck_groups)()

    def _join(self, ops: dict, scheme: str, rows: tuple, idx0: np.ndarray, pending: list,
              klass: str, recheck_groups, batch: MeshBatch) -> None:
        n = len(idx0)
        mask = np.zeros(n, dtype=bool)
        eligible = np.zeros(n, dtype=bool)
        if not pending:  # every domain was dead at submit time
            self._fallback(ops, scheme, rows, idx0, batch, mask, eligible, recheck_groups)
        rounds = 0
        # each failed round opens at least one notch of some breaker: the
        # bound is generous, not load-bearing
        max_rounds = 4 * len(self.chips) + 2
        while pending:
            failed: list[np.ndarray] = []
            for chip, sub_idx, fut in pending:
                try:
                    m, el = fut.result(timeout=dispatch.watchdog_timeout())
                    mask[sub_idx] = m
                    eligible[sub_idx] = el
                except (dispatch.DeviceUnavailable, dispatch.DeviceOpFailed):
                    failed.append(sub_idx)
                except Exception as exc:  # noqa: BLE001 - the watchdog; no future may be lost
                    # a wedged shard keeps its thread until it ends, and
                    # records again if it fails then
                    chip.supervisor.record_op_failure(exc)
                    failed.append(sub_idx)
                finally:
                    with self._lock:
                        chip.inflight_lanes -= EK.bucket_size(len(sub_idx))
            pending = []
            if not failed:
                break
            retry_idx = np.concatenate(failed)
            with self._lock:
                self.redispatches += len(failed)
            mm = _mesh_metrics()
            if mm is not None:
                mm.mesh_redispatch_total.labels("failed").inc(len(failed))
            rounds += 1
            chips = self.live_chips()
            if not chips or rounds > max_rounds:
                self._fallback(ops, scheme, rows, retry_idx, batch, mask, eligible,
                               recheck_groups)
                break
            pending = self._submit_round(ops, scheme, rows, retry_idx, klass, chips)
        with self._lock:
            self.batches += 1
            self.rows_total += n
        # the readmission of a domain whose half-open probe just succeeded
        # shows before the next flush
        self.live_chips()
        before = mask.copy()
        mask, flips = EK.apply_recheck(mask, eligible, rows, ops["scheme"].verify_one,
                                       recheck_groups)
        batch.flipped = np.concatenate([batch.flipped, np.flatnonzero(mask & ~before)])
        batch.flips += flips
        batch.eligible, batch.mask = eligible, mask

    # -------------------------------------------------------------- health

    def health(self) -> dict:
        """Live size, each domain's breaker state and load, and the
        eviction, readmission, redispatch and fallback counts."""
        chips = {}
        live = 0
        for chip in self.chips:
            sup = chip.supervisor
            alive = sup.breaker.peek()
            live += bool(alive)
            chips[str(chip.index)] = {
                "state": sup.breaker.state,
                "live": bool(alive),
                "inflight_lanes": chip.inflight_lanes,
                "lanes_total": chip.lanes_total,
                "shards_total": chip.shards_total,
                "failures": sup.failures,
                "successes": sup.successes,
            }
        with self._lock:
            return {
                "devices": len(self.chips),
                "live": live,
                "placement": self.placement,
                "evictions": self.evictions,
                "readmissions": self.readmissions,
                "redispatched_batches": self.redispatches,
                "fallbacks": self.fallbacks,
                "batches": self.batches,
                "rows_total": self.rows_total,
                "chips": chips,
            }


# ---------------------------------------------------------------------------
# the process's mesh and its knobs
# ---------------------------------------------------------------------------

_cfg = {
    "enabled": True,
    # below this many domains the mesh adds dispatch cost and no second
    # fault domain: the single-card path serves
    "min_devices": 2,
    "placement": CLASS_AWARE,
}

_mesh_lock = threading.Lock()
_mesh: VerifyMesh | None = None


def configure(enabled: bool | None = None, min_devices: int | None = None,
              placement: str | None = None) -> None:
    """Set the mesh knobs. The live mesh takes a placement change in place;
    another set of domains needs reset() or _set_for_testing()."""
    with _mesh_lock:
        if enabled is not None:
            _cfg["enabled"] = bool(enabled)
        if min_devices is not None:
            if min_devices < 1:
                raise ValueError("mesh_min_devices must be >= 1")
            _cfg["min_devices"] = int(min_devices)
        if placement is not None:
            if placement not in PLACEMENTS:
                raise ValueError(f"unknown mesh placement {placement!r} (choices: {PLACEMENTS})")
            _cfg["placement"] = placement
            if _mesh is not None:
                _mesh.placement = placement


def get() -> VerifyMesh:
    """The process's VerifyMesh, one domain a visible card unless one was
    installed or DOMAINS_ENV asks for N domains on the first card (built on
    first use)."""
    global _mesh
    if _mesh is None:
        with _mesh_lock:
            if _mesh is None:
                n = int(os.environ.get(DOMAINS_ENV, "0") or 0)
                cards = _visible_cards()
                devices = [cards[0]] * n if n > 0 and cards else None
                _mesh = VerifyMesh(devices, placement=_cfg["placement"])
    return _mesh


def _set_for_testing(mesh: VerifyMesh | None) -> None:
    """Install a mesh over chosen domains (tests, chip_smoke.py); the one it
    replaces is closed."""
    global _mesh
    with _mesh_lock:
        old, _mesh = _mesh, mesh
    if old is not None and old is not mesh:
        old.close()


def reset() -> None:
    """Forget the mesh (its domains' supervisors live in the ops/dispatch
    registry: reset_supervision clears them)."""
    _set_for_testing(None)


def active() -> VerifyMesh | None:
    """The mesh the scheduler routes through, or None (disabled, or fewer
    domains than min_devices: one card gives one domain, so a one-card
    machine runs the single-card path unless a mesh of domains was
    installed). Builds the mesh on first use. A mesh with every domain dead
    is still active: its fallback is the single-card path."""
    if not _cfg["enabled"]:
        return None
    m = get()
    if len(m.chips) < _cfg["min_devices"]:
        return None
    return m


def peek_active() -> VerifyMesh | None:
    """active() without building the mesh (health and lane-budget reads)."""
    m = _mesh
    if not _cfg["enabled"] or m is None or len(m.chips) < _cfg["min_devices"]:
        return None
    return m


def enabled() -> bool:
    return _cfg["enabled"]


def health_snapshot() -> dict:
    """The knobs, and the mesh's health once it is built (a snapshot does
    not build it)."""
    out = {"enabled": _cfg["enabled"], "min_devices": _cfg["min_devices"],
           "placement": _cfg["placement"], "built": _mesh is not None}
    m = _mesh
    if m is not None:
        out.update(m.health())
        out["active"] = active() is not None
    return out
