"""Batch-verifier dispatch: by key type and backend.

Backends: "gpu" (the default) runs the CUDA kernels and raises when no
card is present; "cpu" runs the plain PyTorch versions and is chosen only
explicitly. The backend is process-global, like the JAX package's.
"""

from __future__ import annotations

from typing import Callable

from cometbft_tpu_torch import crypto
from cometbft_tpu_torch.crypto import ed25519

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
    backends = _REGISTRY.get(pub_key.type_())
    if not backends:
        raise crypto.ErrInvalidKey(
            f"key type {pub_key.type_()!r} has no batch verifier")
    return backends[_BACKEND]()


def _ed25519_factory(device: str) -> Callable[[], crypto.BatchVerifier]:
    def make() -> crypto.BatchVerifier:
        from cometbft_tpu_torch.ops.batch_verifier import CUDABatchVerifier

        return CUDABatchVerifier(device=device)
    return make


register(ed25519.KEY_TYPE, "gpu", _ed25519_factory("cuda"))
register(ed25519.KEY_TYPE, "cpu", _ed25519_factory("cpu"))
