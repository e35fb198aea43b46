"""crypto.BatchVerifier backed by the port's verify kernel — the
counterpart of cometbft_tpu's TPUBatchVerifier."""

from __future__ import annotations

from cometbft_tpu_torch import crypto, resolve_device
from cometbft_tpu_torch.ops import ed25519_kernel

SIGNATURE_SIZE = 64


class CUDABatchVerifier(crypto.BatchVerifier):
    """add() stages host-side; verify() runs the batch on `device` (cuda by
    default; "cpu" runs the plain PyTorch versions). recheck_flips counts
    the lanes the host oracle flipped to valid over this verifier's life —
    any flip means the device gave a wrong verdict."""

    def __init__(self, device=None, cache: ed25519_kernel.PubKeyCache | None = None):
        self.device = resolve_device(device)
        self._cache = cache
        self._pubs: list[bytes] = []
        self._msgs: list[bytes] = []
        self._sigs: list[bytes] = []
        self.recheck_flips = 0

    def add(self, pub_key: crypto.PubKey, msg: bytes, sig: bytes) -> None:
        if pub_key.type_() != "ed25519":
            raise crypto.ErrInvalidKey("the cuda batch verifier requires ed25519 keys")
        if len(sig) != SIGNATURE_SIZE:
            raise crypto.ErrInvalidSignature("bad signature length")
        self._pubs.append(pub_key.bytes_())
        self._msgs.append(bytes(msg))
        self._sigs.append(bytes(sig))

    def verify(self) -> tuple[bool, list[bool]]:
        mask, flips = ed25519_kernel.verify_mask(
            self._pubs, self._msgs, self._sigs, cache=self._cache,
            device=self.device)
        self.recheck_flips += flips
        return bool(mask.all()), mask.tolist()

    def count(self) -> int:
        return len(self._sigs)
