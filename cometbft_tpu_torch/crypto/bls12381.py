"""BLS12-381 keys (min-pubkey-size variant: 48-byte G1 pubkeys, 96-byte G2
signatures), the third validator scheme. The port's copy of
cometbft_tpu/crypto/bls12381.py.

Signing and single verification run on the exact host oracle
(crypto/bls12381_math.py). Batch verification goes through crypto.batch to
the device path (ops/bls_kernel.py): batched single-verify for mempool rows
and mixed commits, and the one-pairing-product aggregate check for a commit
whose signers are all BLS (types/validation.py). Aggregation is the
proof-of-possession flavour: identical sign-bytes across signers aggregate
their pubkeys.

Enablement: with set_enabled(False) a BLS key that reaches the batch seam or
an all-BLS validator set raises ErrInvalidKey naming the switch; nothing
falls back quietly.
"""

from __future__ import annotations

import hashlib
import secrets

from cometbft_tpu_torch import crypto
from cometbft_tpu_torch.crypto import bls12381_math as _bls

KEY_TYPE = "bls12381"
PUB_KEY_SIZE = 48
PRIV_KEY_SIZE = 32
SIGNATURE_SIZE = 96

# Domain separation tag: the pipeline is draft-structured
# (expand_message_xmd/SHA-256 -> hash_to_field -> map -> clear_cofactor)
# with the generic SvdW map of RFC 9380 §6.6.1.
DST = b"BLS_SIG_BLS12381G2_XMD:SHA-256_SVDW_RO_CBFT_"

_enabled = True


def set_enabled(on: bool) -> None:
    """Switch the scheme on or off (a node's crypto.bls_enabled)."""
    global _enabled
    _enabled = bool(on)


def enabled() -> bool:
    return _enabled


class PubKey(crypto.PubKey):
    __slots__ = ("_bytes", "_valid")

    def __init__(self, data: bytes):
        if len(data) != PUB_KEY_SIZE:
            raise crypto.ErrInvalidKey(f"bls12381 pubkey must be {PUB_KEY_SIZE} bytes")
        self._bytes = bytes(data)
        self._valid: bool | None = None  # KeyValidate result, lazy

    def address(self) -> bytes:
        return hashlib.sha256(self._bytes).digest()[:crypto.ADDRESS_SIZE]

    def bytes_(self) -> bytes:
        return self._bytes

    def type_(self) -> str:
        return KEY_TYPE

    def key_validate(self) -> bool:
        """KeyValidate: decodes, subgroup-checks and rejects the infinity
        pubkey. Cached: validator sets re-verify every height."""
        if self._valid is None:
            self._valid = _bls.bls_pubkey_validate(self._bytes)
        return self._valid

    def verify_signature(self, msg: bytes, sig: bytes) -> bool:
        if len(sig) != SIGNATURE_SIZE:
            return False
        if type(msg) is not bytes:
            msg = bytes(msg)
        if not self.key_validate():
            return False
        return _bls.bls_verify(self._bytes, msg, sig, DST)

    def __repr__(self) -> str:
        return f"PubKeyBLS12381{{{self._bytes.hex().upper()}}}"


class PrivKey(crypto.PrivKey):
    __slots__ = ("_bytes", "_sk", "_pub")

    def __init__(self, data: bytes):
        if len(data) != PRIV_KEY_SIZE:
            raise crypto.ErrInvalidKey("bls12381 privkey must be 32 bytes")
        self._bytes = bytes(data)
        self._sk = int.from_bytes(self._bytes, "big") % _bls.BLS_R
        if self._sk == 0:
            raise crypto.ErrInvalidKey("bls12381 privkey is zero mod r")
        self._pub = PubKey(_bls.bls_pub_from_priv(self._sk))

    def bytes_(self) -> bytes:
        return self._bytes

    def sign(self, msg: bytes) -> bytes:
        if type(msg) is not bytes:
            msg = bytes(msg)
        return _bls.bls_sign(self._sk, msg, DST)

    def pub_key(self) -> PubKey:
        return self._pub

    def type_(self) -> str:
        return KEY_TYPE


def gen_priv_key() -> PrivKey:
    while True:
        data = secrets.token_bytes(PRIV_KEY_SIZE)
        if int.from_bytes(data, "big") % _bls.BLS_R:
            return PrivKey(data)


def gen_priv_key_from_secret(secret: bytes) -> PrivKey:
    """Deterministic key from a secret (testing only)."""
    return PrivKey(hashlib.sha256(secret).digest())


def aggregate_signatures(sigs: list[bytes]) -> bytes:
    """One 96-byte aggregate of per-vote signatures; an undecodable or
    infinity input raises ValueError."""
    return _bls.bls_aggregate(sigs)


def aggregate_verify(pubs: list[bytes], msgs: list[bytes], sig: bytes) -> bool:
    """The one-pairing-product check on the host oracle (PoP flavour:
    repeated messages aggregate their pubkeys). See
    bls12381_math.bls_aggregate_verify for what it rejects."""
    return _bls.bls_aggregate_verify([bytes(p) for p in pubs], [bytes(m) for m in msgs],
                                     bytes(sig), DST)
