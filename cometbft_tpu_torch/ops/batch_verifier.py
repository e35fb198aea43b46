"""crypto.BatchVerifiers backed by the port's verify kernels — the
counterparts of cometbft_tpu's TPUBatchVerifier, SrTPUBatchVerifier and
BlsTPUBatchVerifier.
Messages pass through as they are given: a factored row
(libs/prefixrows.PrefixedMsg, e.g. from SharedPrefixRows.rows_for) stays
factored down to the device challenges."""

from __future__ import annotations

from cometbft_tpu_torch import crypto, resolve_device
from cometbft_tpu_torch.libs.prefixrows import PrefixedMsg
from cometbft_tpu_torch.ops import bls_kernel, ed25519_kernel, sr25519_kernel

SIGNATURE_SIZE = 64


class CUDABatchVerifier(crypto.BatchVerifier):
    """add() stages host-side; verify() runs the batch on `device` (cuda by
    default; "cpu" runs the plain PyTorch versions). recheck_flips counts
    the lanes the host oracle flipped to valid over this verifier's life —
    any flip means the device gave a wrong verdict."""

    scheme = ed25519_kernel.ED25519

    def __init__(self, device=None, cache: ed25519_kernel.PubKeyCache | None = None):
        self.device = resolve_device(device)
        self._cache = cache
        self._pubs: list[bytes] = []
        self._msgs: list = []
        self._sigs: list[bytes] = []
        self.recheck_flips = 0

    def add(self, pub_key: crypto.PubKey, msg, sig: bytes) -> None:
        if pub_key.type_() != self.scheme.name:
            raise crypto.ErrInvalidKey(
                f"the cuda {self.scheme.name} batch verifier got a {pub_key.type_()} key")
        if len(sig) != SIGNATURE_SIZE:
            raise crypto.ErrInvalidSignature("bad signature length")
        self._pubs.append(pub_key.bytes_())
        self._msgs.append(msg if isinstance(msg, PrefixedMsg) else bytes(msg))
        self._sigs.append(bytes(sig))

    def verify_async(self) -> ed25519_kernel.BatchThunk:
        """Stage and launch the batch; the thunk resolves with
        ed25519_kernel.resolve_batches (its flips are not added to
        recheck_flips: the caller that resolves it counts them)."""
        return ed25519_kernel.verify_batch_async(
            self.scheme, self._pubs, self._msgs, self._sigs, cache=self._cache,
            device=self.device)

    def verify(self) -> tuple[bool, list[bool]]:
        thunk = self.verify_async()
        mask = ed25519_kernel.resolve_batches([thunk])[0]
        self.recheck_flips += thunk.flips
        return bool(mask.all()), mask.tolist()

    def count(self) -> int:
        return len(self._sigs)


class SrCUDABatchVerifier(CUDABatchVerifier):
    """sr25519 on the device: the same ladder with ristretto255 decoding
    and the cofactor-4 coset check (ops/sr25519_kernel.py; reference seam
    crypto/sr25519/batch.go). A cache, when given, must be an sr25519 one."""

    scheme = sr25519_kernel.SR25519


class BlsCUDABatchVerifier(CUDABatchVerifier):
    """BLS12-381 batched single-verify on the device (ops/bls_kernel.py: the
    kernels B1-B5 and K6); 96-byte signatures. A commit whose signers are all
    BLS is checked by the aggregate path (types/validation.py), not behind
    this per-lane seam. It keeps no key cache."""

    def add(self, pub_key: crypto.PubKey, msg, sig: bytes) -> None:
        if pub_key.type_() != bls_kernel.SCHEME:
            raise crypto.ErrInvalidKey(
                f"the cuda {bls_kernel.SCHEME} batch verifier got a {pub_key.type_()} key")
        if len(sig) != bls_kernel.SIGNATURE_SIZE:
            raise crypto.ErrInvalidSignature("bad signature length")
        self._pubs.append(pub_key.bytes_())
        self._msgs.append(msg if isinstance(msg, PrefixedMsg) else bytes(msg))
        self._sigs.append(bytes(sig))

    def verify_async(self) -> ed25519_kernel.BatchThunk:
        return bls_kernel.verify_batch_async(self._pubs, self._msgs, self._sigs,
                                             device=self.device)
