"""Batch-verifier dispatch: by key type and backend, and the mixed-scheme
verifier.

Backends: "gpu" (the default) runs the CUDA kernels and raises when no
card is present; "cpu" runs the plain PyTorch versions and is chosen only
explicitly. The backend is process-global, like the JAX package's.
"""

from __future__ import annotations

from typing import Callable

from cometbft_tpu_torch import crypto
from cometbft_tpu_torch.crypto import ed25519, sr25519

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
        raise ValueError(f"unknown crypto backend {backend!r}")
    _BACKEND = backend


def get_backend() -> str:
    return _BACKEND


def create_batch_verifier(pub_key: crypto.PubKey) -> crypto.BatchVerifier:
    """A verifier for this key type on the configured backend. Raises
    ErrInvalidKey for key types with no batch verifier, and RuntimeError
    for the "gpu" backend when no card is present."""
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
    order. recheck_flips sums the sub-verifiers'."""

    def __init__(self):
        self._subs: dict[str, crypto.BatchVerifier] = {}
        self._route: list[tuple[str, int]] = []  # (key type, index in sub)

    def add(self, pub_key: crypto.PubKey, msg, sig: bytes) -> None:
        kt = pub_key.type_()
        sub = self._subs.get(kt)
        if sub is None:
            sub = self._subs[kt] = _new_verifier(kt)
        sub.add(pub_key, msg, sig)
        self._route.append((kt, sub.count() - 1))

    def verify(self) -> tuple[bool, list[bool]]:
        masks = {kt: sub.verify()[1] for kt, sub in self._subs.items()}
        out = [masks[kt][i] for kt, i in self._route]
        return all(out), out

    @property
    def recheck_flips(self) -> int:
        return sum(sub.recheck_flips for sub in self._subs.values())

    def count(self) -> int:
        return len(self._route)


def create_mixed_batch_verifier() -> MixedBatchVerifier:
    """A verifier for a batch of mixed key types on the configured backend.
    The JAX package returns its scheduler's client here; the port has no
    scheduler yet, so this is always a MixedBatchVerifier."""
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
                       (sr25519.KEY_TYPE, "SrCUDABatchVerifier")):
    register(_kt, "gpu", _factory(_verifier, "cuda"))
    register(_kt, "cpu", _factory(_verifier, "cpu"))
