"""How the verify path reaches the card, and whether a fault domain may be
used: the port's counterpart of cometbft_tpu/ops/dispatch.py.

  dispatch streams one torch.cuda.Stream per (device, domain). Domain ""
                   is the single-card path's stream: every stage and launch
                   of a verify batch (ed25519_kernel.verify_batch_async,
                   bls_kernel.verify_batch_async) and every fetch of its
                   header (resolve_batches) runs on it, from whichever thread
                   dispatches. A mesh fault domain "devN" (parallel/mesh.py)
                   has a stream of its own, beside its own key tables
                   (ops/residency.py) and prefix tables (ops/challenge.py),
                   which are updated in place: one stream a domain is what
                   orders a delta upload after the kernels that still read a
                   row.
  dispatch lock    stage + launch run under it, for every domain (the
                   reference's KERNEL_DISPATCH_LOCK); the fetch does not.

Supervision, the reference's fault layer, decides whether a fault domain
is used; nothing here falls back to the CPU. The single-card path's
supervisor is "device" (ops/ed25519_kernel.py: its dispatch and fetch), a
mesh domain's "mesh.devN":

  classify         transient (chaos transients, CUDA out of memory, unknown
                   errors), timeout, or permanent (chaos permanents, an
                   illegal memory access, a launch failure, a device-side
                   assert, a failed nvcc build, the reference's lowering
                   markers)
  retry            a transient retries in place with capped exponential
                   backoff and jitter
  checks           an AssertionError is a failed check of the program, not
                   a fault of the card: run() re-raises it at once, neither
                   retried, counted nor wrapped (a departure: the
                   reference retries it as an unknown error)
  break            N consecutive failed operations (or one permanent) open
                   a CircuitBreaker: the domain takes no new shard
  re-probe         after `cooldown` the breaker half-opens and one operation
                   probes the domain; success closes it, failure re-opens it

  DoubleBuffer     the two-slot in-flight gate of a fault domain (the
                   reference's :445, without its pinned staging blocks): a
                   shard takes a slot before it stages and gives it back once
                   its kernels are launched. The chaos site
                   "dispatch.doublebuf" degrades a domain to one batch in
                   flight until its breaker closes again.

The reference's Pallas rung and its longer Pallas cooldown have no
counterpart (the port has no Pallas rung). health_snapshot is the
reference's crypto_health snapshot (:540) over the port's own state.
"""

from __future__ import annotations

import contextlib
import logging
import random
import threading
import time

import torch

# stage + launch of one verify batch (re-entrant: verify_rows nests the
# async entry)
DISPATCH_LOCK = threading.RLock()

_streams: dict[tuple[torch.device, str], torch.cuda.Stream] = {}
_reg_lock = threading.Lock()


def _key(dev: torch.device) -> torch.device:
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def stream(dev: torch.device, domain: str = "") -> torch.cuda.Stream | None:
    """The dispatch stream of fault domain `domain` on CUDA device `dev`
    (None on the CPU)."""
    if dev.type != "cuda":
        return None
    key = (_key(dev), domain)
    with _reg_lock:
        s = _streams.get(key)
        if s is None:
            s = _streams[key] = torch.cuda.Stream(device=key[0])
        return s


def on_stream(dev: torch.device, domain: str = ""):
    """A context in which the dispatch stream of (`dev`, `domain`) is the
    current stream (nothing on the CPU)."""
    s = stream(dev, domain)
    return contextlib.nullcontext() if s is None else torch.cuda.stream(s)


@contextlib.contextmanager
def launching(dev: torch.device, domain: str = ""):
    """Stage and launch under the dispatch lock, on the domain's stream."""
    with DISPATCH_LOCK, on_stream(dev, domain):
        yield


# ------------------------------------------------------------ failure classes

TRANSIENT = "transient"
PERMANENT = "permanent"
TIMEOUT = "timeout"

# breaker states
CLOSED = "closed"
HALF_OPEN = "half_open"
OPEN = "open"


class DeviceUnavailable(RuntimeError):
    """Breaker open: the domain is sidelined until the next re-probe."""


class DeviceOpFailed(RuntimeError):
    """A supervised device operation failed (after retries). The original
    exception rides __cause__; the supervisor has already recorded it."""


# a failed card, never a verdict on what it was asked to verify: both are
# RuntimeErrors, which the light client and the evidence checks re-raise
# unwrapped, and consensus and block sync stop on them
DEVICE_FAULTS = (DeviceUnavailable, DeviceOpFailed)


# permanent markers in error text: the reference's, then the CUDA
# runtime's and the kernel build's. Everything else is transient: the
# reference's transient markers (RESOURCE_EXHAUSTED, UNAVAILABLE, timed
# out, ...), CUDA's "out of memory", and unknown text.
_PERMANENT_MARKERS = (
    "Mosaic", "mosaic", "lowering", "Unsupported", "NOT_FOUND",
    "UNIMPLEMENTED", "INVALID_ARGUMENT",
    "illegal memory access", "unspecified launch failure", "device-side assert", "nvcc",
)


def classify_failure(exc: BaseException) -> str:
    """Map a device-op exception to a failure class. Unknown errors count
    as transient: the breaker bounds how long they are retried."""
    from cometbft_tpu_torch.libs import chaos

    if isinstance(exc, chaos.ChaosPermanentError):
        return PERMANENT
    if isinstance(exc, chaos.ChaosTransientError):
        return TRANSIENT
    if isinstance(exc, (chaos.ChaosTimeout, TimeoutError)):
        return TIMEOUT
    if isinstance(exc, torch.cuda.OutOfMemoryError):
        return TRANSIENT
    text = f"{type(exc).__name__}: {exc}"
    if any(m in text for m in _PERMANENT_MARKERS):
        return PERMANENT
    return TRANSIENT


class CircuitBreaker:
    """closed -> (N consecutive failures | 1 permanent) -> open ->
    (cooldown elapses) -> half_open -> one probe -> closed | open."""

    def __init__(self, name: str, failure_threshold: int = 3, cooldown: float = 30.0,
                 clock=time.monotonic):
        self.name = name
        self.failure_threshold = failure_threshold
        self.cooldown = cooldown
        self._clock = clock
        self._lock = threading.Lock()
        self._state = CLOSED
        self._consecutive = 0
        self._opened_at = 0.0
        self._probe_inflight = False

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    @property
    def consecutive_failures(self) -> int:
        with self._lock:
            return self._consecutive

    def allow(self) -> bool:
        """Claim permission for a device operation. An OPEN breaker whose
        cooldown has elapsed half-opens and admits the caller as the probe;
        while the probe is in flight every other caller is refused. Readers
        use peek(): allow() is a state transition."""
        with self._lock:
            if self._state == OPEN:
                if self._clock() - self._opened_at < self.cooldown:
                    return False
                self._state = HALF_OPEN
                self._probe_inflight = True
                return True
            if self._state == HALF_OPEN:
                if self._probe_inflight:
                    return False
                self._probe_inflight = True
            return True

    def peek(self) -> bool:
        """Would a device operation be admitted now? No transition, no probe
        claim."""
        with self._lock:
            if self._state == OPEN:
                return self._clock() - self._opened_at >= self.cooldown
            if self._state == HALF_OPEN:
                return not self._probe_inflight
            return True

    def record_success(self) -> None:
        with self._lock:
            self._consecutive = 0
            self._probe_inflight = False
            self._state = CLOSED

    def record_failure(self, fclass: str) -> None:
        """A failed operation (retries exhausted). A permanent failure and a
        failed half-open probe open at once; transients at the threshold."""
        with self._lock:
            self._consecutive += 1
            self._probe_inflight = False
            opens = (fclass == PERMANENT or self._state == HALF_OPEN
                     or self._consecutive >= self.failure_threshold)
            if opens and self._state != OPEN:
                self._state = OPEN
                self._opened_at = self._clock()
            elif self._state == OPEN:
                self._opened_at = self._clock()  # failed probe: restart the timer

    def health(self) -> dict:
        with self._lock:
            out = {"state": self._state, "consecutive_failures": self._consecutive,
                   "failure_threshold": self.failure_threshold,
                   "cooldown_seconds": self.cooldown}
            if self._state == OPEN:
                out["reprobe_in_seconds"] = round(
                    max(0.0, self.cooldown - (self._clock() - self._opened_at)), 3)
            return out


class DeviceSupervisor:
    """Retry with backoff, a breaker and counters around one class of
    device operation. `sleep` and `clock` are injectable so that tests run
    on a fake timeline."""

    def __init__(self, name: str, failure_threshold: int = 3, cooldown: float = 30.0,
                 retry_attempts: int = 2, retry_base: float = 0.05, retry_cap: float = 1.0,
                 sleep=time.sleep, clock=time.monotonic):
        self.name = name
        self.breaker = CircuitBreaker(name, failure_threshold=failure_threshold,
                                      cooldown=cooldown, clock=clock)
        self.retry_attempts = retry_attempts
        self.retry_base = retry_base
        self.retry_cap = retry_cap
        self._sleep = sleep
        self._lock = threading.Lock()
        self.retries = 0
        self.failures = 0
        self.successes = 0
        self.last_error: str | None = None

    def _count_failure(self, fclass: str, exc: BaseException) -> None:
        with self._lock:
            self.failures += 1
            self.last_error = f"{fclass}: {type(exc).__name__}: {exc}"

    def run(self, fn, *args, **kwargs):
        """Run fn under supervision. Raises DeviceUnavailable (breaker open,
        nothing attempted) or DeviceOpFailed (attempted and failed, already
        recorded); an AssertionError passes through unretried. Success
        closes the breaker."""
        if not self.breaker.allow():
            raise DeviceUnavailable(self.name)
        attempt = 0
        while True:
            try:
                out = fn(*args, **kwargs)
            except AssertionError:
                raise
            except Exception as exc:  # noqa: BLE001 - classified below
                fclass = classify_failure(exc)
                if fclass == TRANSIENT and attempt < self.retry_attempts:
                    with self._lock:
                        self.retries += 1
                    delay = min(self.retry_cap, self.retry_base * (2 ** attempt))
                    self._sleep(delay * (0.5 + random.random() / 2))
                    attempt += 1
                    continue
                self._count_failure(fclass, exc)
                self.breaker.record_failure(fclass)
                logging.getLogger(__name__).error(
                    "supervised device operation failed: %s, %s after %d attempt(s), "
                    "breaker %s: %s", self.name, fclass, attempt + 1, self.breaker.state, exc)
                raise DeviceOpFailed(f"{self.name}: {fclass} device failure after "
                                     f"{attempt + 1} attempt(s)") from exc
            with self._lock:
                self.successes += 1
            self.breaker.record_success()
            return out

    def record_op_failure(self, exc: BaseException) -> str:
        """Record a failure observed outside run() (a watchdog timeout).
        Returns the failure class."""
        fclass = classify_failure(exc)
        self._count_failure(fclass, exc)
        self.breaker.record_failure(fclass)
        return fclass

    def health(self) -> dict:
        with self._lock:
            out = {"retries": self.retries, "failures": self.failures,
                   "successes": self.successes, "last_error": self.last_error}
        out["breaker"] = self.breaker.health()
        return out


# ----------------------------------------------- supervisor registry + knobs

_config = {
    "failure_threshold": 3,
    "cooldown": 30.0,
    "retry_attempts": 2,
    "retry_base": 0.05,
    "retry_cap": 1.0,
    # covers a shard's first build of the kernels (nvcc, tens of seconds)
    # while bounding a wedged one
    "watchdog_timeout": 120.0,
}

_registry_lock = threading.Lock()
_supervisors: dict[str, DeviceSupervisor] = {}


def configure(**kwargs) -> None:
    """Set supervision knobs (unknown keys raise ValueError). Existing
    supervisors take the new values in place."""
    with _registry_lock:
        for k, v in kwargs.items():
            if k not in _config:
                raise ValueError(f"unknown supervision knob {k!r}")
            _config[k] = v
        for sup in _supervisors.values():
            sup.breaker.failure_threshold = _config["failure_threshold"]
            sup.breaker.cooldown = _config["cooldown"]
            sup.retry_attempts = _config["retry_attempts"]
            sup.retry_base = _config["retry_base"]
            sup.retry_cap = _config["retry_cap"]


def watchdog_timeout() -> float:
    return _config["watchdog_timeout"]


def supervisor(name: str) -> DeviceSupervisor:
    """The process's supervisor named `name` (a mesh domain's is
    "mesh.devN"), built with the current knobs on first use."""
    with _registry_lock:
        sup = _supervisors.get(name)
        if sup is None:
            sup = _supervisors[name] = DeviceSupervisor(
                name, failure_threshold=_config["failure_threshold"],
                cooldown=_config["cooldown"], retry_attempts=_config["retry_attempts"],
                retry_base=_config["retry_base"], retry_cap=_config["retry_cap"])
        return sup


def device_allowed() -> bool:
    """May a new batch target the device? A peek of the "device"
    supervisor's breaker: no transition, no probe claim."""
    return supervisor("device").breaker.peek()


def reset_supervision() -> None:
    """Forget every supervisor and gate (tests)."""
    with _registry_lock:
        _supervisors.clear()
    with _doublebuf_lock:
        _doublebufs.clear()


# ------------------------------------------------------ in-flight gate


def _release_once(fn):
    lock = threading.Lock()
    state = {"done": False}

    def release() -> None:
        with lock:
            if state["done"]:
                return
            state["done"] = True
        fn()

    return release


class DoubleBuffer:
    """Two slots in flight a fault domain: a shard acquires one before it
    stages and releases it once its kernels are launched, so a domain
    stages its next shard while the card runs the last and a third waits.

    Fault seam: the chaos site "dispatch.doublebuf" fires at acquire. A
    fault records against the domain's "doublebuf.<domain>" supervisor and
    degrades the gate to one batch in flight while that breaker admits
    nothing; its half-open probe restores two. acquire() never raises."""

    def __init__(self, domain: str, slots: int = 2) -> None:
        self.domain = domain
        self.slots = slots
        self._sem = threading.BoundedSemaphore(slots)
        self._serial = threading.Lock()
        self._lock = threading.Lock()
        self.acquires = 0
        self.waits = 0
        self.degraded = 0

    def acquire(self):
        """Block until a slot is free; returns a one-shot release callable
        (any thread may call it; later calls do nothing)."""
        from cometbft_tpu_torch.libs import chaos

        sup = supervisor(f"doublebuf.{self.domain}")
        degraded = False
        try:
            chaos.fire("dispatch.doublebuf")
            if sup.breaker.allow():
                sup.breaker.record_success()
            else:
                degraded = True
        except Exception as exc:  # noqa: BLE001 - an injected fault degrades the gate
            sup.record_op_failure(exc)
            degraded = True
        with self._lock:
            self.acquires += 1
            if degraded:
                self.degraded += 1
        if degraded:
            self._serial.acquire()
            return _release_once(self._serial.release)
        if not self._sem.acquire(blocking=False):
            with self._lock:
                self.waits += 1
            self._sem.acquire()
        return _release_once(self._sem.release)

    def stats(self) -> dict:
        with self._lock:
            return {"slots": self.slots, "acquires": self.acquires, "waits": self.waits,
                    "degraded": self.degraded}


_doublebuf_lock = threading.Lock()
_doublebufs: dict[str, DoubleBuffer] = {}


def doublebuffer(domain: str = "dev0") -> DoubleBuffer:
    """The in-flight gate of fault domain `domain`."""
    with _doublebuf_lock:
        db = _doublebufs.get(domain)
        if db is None:
            db = _doublebufs[domain] = DoubleBuffer(domain)
        return db


def doublebuffer_stats() -> dict:
    with _doublebuf_lock:
        return {d: db.stats() for d, db in _doublebufs.items()}


def _mesh_health() -> dict:
    """The mesh section of crypto_health; never raises."""
    try:
        from cometbft_tpu_torch.parallel import mesh as _mesh

        return _mesh.health_snapshot()
    except Exception:  # noqa: BLE001 - health renders whatever the mesh does
        return {"enabled": False, "built": False}


def health_snapshot() -> dict:
    """The RPC-visible crypto-health snapshot (the crypto_health route): the
    backend, every supervisor, the armed chaos schedule, the verify
    scheduler, the mesh, the batch attribution and the tunnel model, and
    the staging plane's counters. Reads only this process's state and never
    raises."""
    from cometbft_tpu_torch import sched
    from cometbft_tpu_torch.crypto import batch as crypto_batch
    from cometbft_tpu_torch.libs import chaos
    from cometbft_tpu_torch.libs import linkmodel as _linkmodel
    from cometbft_tpu_torch.libs import trace as _trace

    with _registry_lock:
        sups = dict(_supervisors)
    backend = crypto_batch.get_backend()
    snap: dict = {
        "configured_backend": backend,
        # the port has no CPU ladder: a batch targets the configured backend
        # or raises
        "active_backend": backend,
        "watchdog_timeout_seconds": _config["watchdog_timeout"],
        "supervisors": {name: sup.health() for name, sup in sups.items()},
    }
    for key, read in (("chaos", chaos.snapshot),
                      ("verify_sched", sched.health_snapshot),
                      ("mesh", _mesh_health),
                      ("attribution", _trace.attribution),
                      ("tunnel", lambda: _linkmodel.tunnel().snapshot())):
        try:
            snap[key] = read()
        except Exception as e:  # noqa: BLE001 - health must render
            snap[key] = {"error": f"{type(e).__name__}: {e}"}
    try:
        from cometbft_tpu_torch.ops import challenge as _challenge
        from cometbft_tpu_torch.ops import ed25519_kernel as _ek
        from cometbft_tpu_torch.ops import hashvec as _hv
        from cometbft_tpu_torch.ops import residency as _residency

        snap["staging"] = {
            "hashvec_native": _hv.native_available(),
            "hashvec_rows": _hv.stats(),
            "fetch": _ek.fetch_stats(),
            "wire": _residency.send_stats(),
            "doublebuf": doublebuffer_stats(),
            "challenge": {"enabled": _challenge.enabled(),
                          "counters": _challenge.stats()},
        }
    except Exception:  # noqa: BLE001 - health must render
        pass
    return snap
