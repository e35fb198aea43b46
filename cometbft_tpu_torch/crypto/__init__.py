"""Crypto plugin boundary of the port: PubKey / PrivKey / BatchVerifier.

The rest of a node programs against these seams; ``crypto.batch`` picks a
batch verifier by key type and backend ("gpu" or "cpu"). BatchVerifier.add()
is cheap host staging; verify() is the sync point and returns both the
overall bool and a per-signature validity mask (the device kernel's lane
output).
"""

from __future__ import annotations

from abc import ABC, abstractmethod

# Address: 20-byte truncated SHA-256 of the pubkey bytes.
ADDRESS_SIZE = 20

# Wire cap on signature bytes in votes and commits, as in the JAX package:
# the largest signature of any scheme it registers (BLS12-381's 96 bytes).
MAX_SIGNATURE_SIZE = 96


class PubKey(ABC):
    @abstractmethod
    def address(self) -> bytes: ...

    @abstractmethod
    def bytes_(self) -> bytes: ...

    @abstractmethod
    def verify_signature(self, msg: bytes, sig: bytes) -> bool: ...

    @abstractmethod
    def type_(self) -> str: ...

    def __eq__(self, other: object) -> bool:
        return (isinstance(other, PubKey) and self.type_() == other.type_()
                and self.bytes_() == other.bytes_())

    def __hash__(self) -> int:
        return hash((self.type_(), self.bytes_()))


class PrivKey(ABC):
    @abstractmethod
    def bytes_(self) -> bytes: ...

    @abstractmethod
    def sign(self, msg: bytes) -> bytes: ...

    @abstractmethod
    def pub_key(self) -> PubKey: ...

    @abstractmethod
    def type_(self) -> str: ...


class BatchVerifier(ABC):
    """Accumulate (pubkey, msg, sig) triples; verify once.

    add() validates shapes and stages host-side; verify() runs the batch
    and returns (all_valid, per_sig_mask).
    """

    @abstractmethod
    def add(self, pub_key: PubKey, msg: bytes, sig: bytes) -> None: ...

    @abstractmethod
    def verify(self) -> tuple[bool, list[bool]]: ...

    @abstractmethod
    def count(self) -> int: ...


class ErrInvalidKey(Exception):
    pass


class ErrInvalidSignature(Exception):
    pass
