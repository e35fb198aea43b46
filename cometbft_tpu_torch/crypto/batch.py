"""Batch-verifier dispatch: by key type and backend, the scheduler's client
and the mixed-scheme verifier. The port's counterpart of
cometbft_tpu/crypto/batch.py.

Backends: "gpu" (the default) runs the CUDA kernels and raises when no
card is present; "cpu" runs the plain PyTorch versions and is chosen only
explicitly. There is no "auto" and no circuit breaker: the backend is what
was set. It is process-global, like the JAX package's. configure() applies
a node's config.crypto section at boot.

With the verify scheduler enabled (sched.enabled(), the default),
create_batch_verifier and create_mixed_batch_verifier return a
ScheduledBatchVerifier: its verify() is an inline drain of the node-wide
scheduler (sched/scheduler.py). With sched.configure(enabled=False) they
return the per-key-type verifiers and MixedBatchVerifier, which run their
own batches.
"""

from __future__ import annotations

from typing import Callable

from cometbft_tpu_torch import crypto
from cometbft_tpu_torch.crypto import bls12381, ed25519, sr25519

BACKENDS = ("gpu", "cpu")
_BACKEND = "gpu"

# key type -> backend name -> factory
_REGISTRY: dict[str, dict[str, Callable[[], crypto.BatchVerifier]]] = {}


def register(key_type: str, backend: str,
             factory: Callable[[], crypto.BatchVerifier]) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"unknown crypto backend {backend!r}")
    _REGISTRY.setdefault(key_type, {})[backend] = factory


def set_backend(backend: str) -> None:
    global _BACKEND
    if backend not in BACKENDS:
        raise ValueError(f"unknown crypto backend {backend!r} (the port's backends: "
                         f"{', '.join(repr(b) for b in BACKENDS)})")
    _BACKEND = backend
    _publish_active(backend)


def _publish_active(backend: str) -> None:
    """The crypto backend gauge (libs/metrics.CryptoMetrics.backend_active):
    1 for the backend set, 0 for the other."""
    try:
        from cometbft_tpu_torch.libs import metrics

        g = metrics.crypto_metrics().backend_active
        for b in BACKENDS:
            g.labels(b).set(1.0 if b == backend else 0.0)
    except Exception:  # noqa: BLE001 - metrics must never break dispatch
        pass


# config.crypto knobs with no counterpart in the port, and their defaults:
# set away from the default, configure() raises rather than ignore them
_NO_COUNTERPART = {"max_batch_size": 16384}


def configure(crypto_cfg) -> None:
    """Apply config.crypto at node boot (the reference's
    crypto/batch.configure): the backend, the dispatch supervisors' knobs,
    the verify scheduler's knobs, the mesh, the key tables' indexed path,
    the device challenge, the BLS switch and any chaos schedule. The
    backend is "gpu" or "cpu"; any other value raises, as does a knob in
    _NO_COUNTERPART set away from its default."""
    for name, default in _NO_COUNTERPART.items():
        if getattr(crypto_cfg, name) != default:
            raise NotImplementedError(
                f"crypto.{name} = {getattr(crypto_cfg, name)!r} has no counterpart in the "
                f"port (leave it at {default!r}; the scheduler's lane cap is sched_max_lanes)")
    set_backend(crypto_cfg.backend)
    from cometbft_tpu_torch.ops import dispatch

    dispatch.configure(
        failure_threshold=crypto_cfg.breaker_failure_threshold,
        cooldown=crypto_cfg.breaker_cooldown,
        retry_attempts=crypto_cfg.retry_max_attempts,
        retry_base=crypto_cfg.retry_backoff_base,
        retry_cap=crypto_cfg.retry_backoff_cap,
        watchdog_timeout=crypto_cfg.watchdog_timeout,
    )
    from cometbft_tpu_torch import sched

    sched.configure(
        enabled=crypto_cfg.scheduler,
        max_lanes=crypto_cfg.sched_max_lanes,
        sync_deadline=crypto_cfg.sched_sync_deadline,
        light_deadline=crypto_cfg.sched_light_deadline,
        mempool_deadline=crypto_cfg.sched_mempool_deadline,
        queue_limit=crypto_cfg.sched_queue_limit,
        starvation_limit=crypto_cfg.sched_starvation_limit,
    )
    from cometbft_tpu_torch.parallel import mesh as verify_mesh

    verify_mesh.configure(
        enabled=crypto_cfg.mesh_enabled,
        min_devices=crypto_cfg.mesh_min_devices,
        placement=crypto_cfg.mesh_placement,
    )
    from cometbft_tpu_torch.ops import challenge, residency

    residency.configure(
        enabled=crypto_cfg.wire_indexed_sends,
        rows=crypto_cfg.wire_table_rows,
    )
    challenge.configure(enabled=crypto_cfg.wire_device_challenge)
    bls12381.set_enabled(crypto_cfg.bls_enabled)
    if crypto_cfg.chaos:
        from cometbft_tpu_torch.libs import chaos

        chaos.arm_spec(crypto_cfg.chaos)


def get_backend() -> str:
    return _BACKEND


def backend_device():
    """The device the configured backend runs on: cuda for "gpu" (raising
    without a card), the CPU for "cpu"."""
    from cometbft_tpu_torch import resolve_device

    return resolve_device("cuda" if _BACKEND == "gpu" else "cpu")


def check_bls_enabled(key_type: str) -> None:
    """A BLS key while the scheme is switched off (bls12381.set_enabled) is
    a configuration error and raises ErrInvalidKey: nothing falls back
    quietly."""
    if key_type == bls12381.KEY_TYPE and not bls12381.enabled():
        raise crypto.ErrInvalidKey(
            "bls12381 key reached the batch-verify seam but the scheme is disabled "
            "(bls12381.set_enabled(False)); enable it or remove BLS keys from the validator set")


def supports_batch_verifier(pub_key: crypto.PubKey | None) -> bool:
    """Does this key type have a batch verifier (CometBFT's
    crypto/batch.SupportsBatchVerifier)? Raises for a BLS key while the
    scheme is disabled."""
    if pub_key is None:
        return False
    check_bls_enabled(pub_key.type_())
    return pub_key.type_() in _REGISTRY


def create_batch_verifier(pub_key: crypto.PubKey) -> crypto.BatchVerifier:
    """A verifier for this key type: the scheduler's client while the
    scheduler is enabled, else the key type's verifier on the configured
    backend. Raises ErrInvalidKey for key types with no batch verifier;
    verify() raises RuntimeError on the "gpu" backend without a card."""
    from cometbft_tpu_torch import sched

    if pub_key.type_() not in _REGISTRY:
        raise crypto.ErrInvalidKey(f"key type {pub_key.type_()!r} has no batch verifier")
    if sched.enabled():
        return ScheduledBatchVerifier()
    return _new_verifier(pub_key.type_())


def _new_verifier(key_type: str) -> crypto.BatchVerifier:
    backends = _REGISTRY.get(key_type)
    if not backends:
        raise crypto.ErrInvalidKey(f"key type {key_type!r} has no batch verifier")
    return backends[_BACKEND]()


class MixedBatchVerifier(crypto.BatchVerifier):
    """A batch of mixed key types (BASELINE config 5: an ed25519 + sr25519
    mega-commit): add() routes each row to a per-type sub-verifier on the
    configured backend; verify() runs each sub-batch once — one kernel
    launch per scheme — and stitches the per-lane masks back into input
    order. The sub-batches are launched before any is fetched and resolve
    with one resolve_batches: one header fetch for all of them.
    recheck_flips sums the sub-verifiers'."""

    def __init__(self):
        self._subs: dict[str, crypto.BatchVerifier] = {}
        self._route: list[tuple[str, int]] = []  # (key type, index in sub)

    def add(self, pub_key: crypto.PubKey, msg, sig: bytes) -> None:
        kt = pub_key.type_()
        check_bls_enabled(kt)
        sub = self._subs.get(kt)
        if sub is None:
            sub = self._subs[kt] = _new_verifier(kt)
        sub.add(pub_key, msg, sig)
        self._route.append((kt, sub.count() - 1))

    def verify(self) -> tuple[bool, list[bool]]:
        from cometbft_tpu_torch.ops import ed25519_kernel

        thunks = {kt: sub.verify_async() for kt, sub in self._subs.items()}
        resolved = ed25519_kernel.resolve_batches(list(thunks.values()))
        masks = dict(zip(thunks, resolved))
        for kt, thunk in thunks.items():
            self._subs[kt].recheck_flips += thunk.flips
        out = [bool(masks[kt][i]) for kt, i in self._route]
        return all(out), out

    @property
    def recheck_flips(self) -> int:
        return sum(sub.recheck_flips for sub in self._subs.values())

    def count(self) -> int:
        return len(self._route)


class ScheduledBatchVerifier(crypto.BatchVerifier):
    """The scheduler's client behind crypto.BatchVerifier: add() checks the
    key type and signature length and keeps the row in the columns the
    batches take (sched.RowColumns: key bytes, messages, signatures by key
    type; factored rows stay factored); verify() hands them to the
    node-wide VerifyScheduler as one group under the ambient priority class
    (sched.work_class) and drains it inline, with queued riders. Key types
    may mix: the scheduler runs one batch per scheme and resolves them with
    one fetch. recheck_flips counts
    the lanes of this verifier's rows that the host recheck flipped. Like
    the per-key-type verifiers, it raises at creation on the "gpu" backend
    without a card."""

    # signature sizes by key type (BLS G2 signatures are 96 bytes)
    SIGNATURE_SIZES = {ed25519.KEY_TYPE: 64, sr25519.KEY_TYPE: 64, bls12381.KEY_TYPE: 96}

    def __init__(self, klass: str | None = None):
        from cometbft_tpu_torch import sched

        backend_device()
        self._klass = klass or sched.current_class()
        self._rows = sched.RowColumns()
        self.recheck_flips = 0

    def add(self, pub_key: crypto.PubKey, msg, sig: bytes) -> None:
        from cometbft_tpu_torch.libs.prefixrows import PrefixedMsg

        kt = pub_key.type_()
        check_bls_enabled(kt)
        if kt not in _REGISTRY:
            raise crypto.ErrInvalidKey(f"key type {kt!r} has no batch verifier")
        if len(sig) != self.SIGNATURE_SIZES[kt]:
            raise crypto.ErrInvalidSignature("bad signature length")
        self._rows.add(kt, pub_key.bytes_(), msg if isinstance(msg, PrefixedMsg) else bytes(msg),
                       bytes(sig))

    def verify(self) -> tuple[bool, list[bool]]:
        if not len(self._rows):
            return True, []
        from cometbft_tpu_torch import sched

        group = sched.get().drain([self._rows], self._klass)[0]
        self.recheck_flips += group.flips
        out = group.mask.tolist()
        return all(out), out

    def count(self) -> int:
        return len(self._rows)


def create_mixed_batch_verifier() -> crypto.BatchVerifier:
    """A verifier for a batch of mixed key types: the scheduler's client
    while the scheduler is enabled, else a MixedBatchVerifier on the
    configured backend."""
    from cometbft_tpu_torch import sched

    if sched.enabled():
        return ScheduledBatchVerifier()
    return MixedBatchVerifier()


def path_stats() -> dict:
    """Which paths the device batches took, from the process-wide counters:
    the device-challenge planner (``challenge``: plans, lanes_device,
    lanes_host_fallback and the classic path's reasons), the pubkey sends
    by path (``sends``: indexed, delta, full), the host hash rung
    (``hash_rung``) and the header-only and full fetches (``fetch``)."""
    from cometbft_tpu_torch.ops import challenge, ed25519_kernel, hashvec, residency

    return {"challenge": challenge.stats(), "sends": residency.send_stats(),
            "hash_rung": hashvec.active_rung(), "fetch": ed25519_kernel.fetch_stats()}


def reset_path_stats() -> None:
    """Zero the counters path_stats() reads."""
    from cometbft_tpu_torch.ops import challenge, ed25519_kernel, residency

    challenge.reset_stats()
    residency.reset_send_stats()
    ed25519_kernel.reset_fetch_stats()


def _factory(verifier: str, device: str) -> Callable[[], crypto.BatchVerifier]:
    def make() -> crypto.BatchVerifier:
        from cometbft_tpu_torch.ops import batch_verifier

        return getattr(batch_verifier, verifier)(device=device)
    return make


for _kt, _verifier in ((ed25519.KEY_TYPE, "CUDABatchVerifier"),
                       (sr25519.KEY_TYPE, "SrCUDABatchVerifier"),
                       (bls12381.KEY_TYPE, "BlsCUDABatchVerifier")):
    register(_kt, "gpu", _factory(_verifier, "cuda"))
    register(_kt, "cpu", _factory(_verifier, "cpu"))
