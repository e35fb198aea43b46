"""Shared-prefix byte rows: the host half of the device-challenge path.

The canonical sign-bytes of the votes in one commit differ only in the
timestamp field (and the NIL votes' block_id omission): ~105 of ~122
bytes a row are one prefix shared by the (height, round, chain). These
types carry the factored form end to end:

  SharedPrefixRows   a commit's rows: one prefix, per-row suffixes, and a
                     small map of rows that cannot share (NIL heads, an
                     off-length timestamp encoding). Indexing materializes
                     real bytes; rows_for() yields the factored rows.
  PrefixedMsg        one row in factored form. It flows through the verify
                     path (crypto/batch, ops/batch_verifier, verify_rows)
                     without materializing: ops/challenge.plan_batch keys
                     the device prefix table on it, and
                     ops/hashvec.assemble_prefixed_rows reassembles whole
                     runs on the batch axis with one broadcast of the
                     prefix. as_bytes(m) gives the exact row for the host
                     oracles.

The port's copy of cometbft_tpu/libs/prefixrows.py.
"""

from __future__ import annotations

from collections.abc import Sequence


class PrefixedMsg:
    """One message in (shared prefix, per-row suffix) factored form.
    len() is O(1); bytes() materializes the exact row. Staging groups
    consecutive rows whose `prefix` is the SAME OBJECT into one
    batch-axis broadcast, so row makers must reuse one prefix object per
    run (SharedPrefixRows does)."""

    __slots__ = ("prefix", "suffix")

    def __init__(self, prefix: bytes, suffix: bytes):
        self.prefix = prefix
        self.suffix = suffix

    def __len__(self) -> int:
        return len(self.prefix) + len(self.suffix)

    def __bytes__(self) -> bytes:
        return self.prefix + self.suffix

    def tobytes(self) -> bytes:
        return self.prefix + self.suffix

    def __eq__(self, other) -> bool:
        if isinstance(other, PrefixedMsg):
            return (self.prefix == other.prefix
                    and self.suffix == other.suffix) or \
                bytes(self) == bytes(other)
        if isinstance(other, (bytes, bytearray)):
            return bytes(self) == bytes(other)
        return NotImplemented

    def __hash__(self) -> int:
        return hash(bytes(self))

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"PrefixedMsg({len(self.prefix)}B prefix + "
                f"{len(self.suffix)}B suffix)")


def as_bytes(msg) -> bytes:
    """Materialize a message that may be a PrefixedMsg (host-oracle and
    serial-verifier boundaries)."""
    return bytes(msg) if isinstance(msg, PrefixedMsg) else msg


class SharedPrefixRows(Sequence):
    """An immutable sequence of byte rows where row[i] is either
    `prefix + suffixes[i]` or an explicit exception row. Indexing and
    iteration yield real bytes (drop-in for the old list); rows_for()
    yields the factored PrefixedMsg form for the staging pipeline."""

    __slots__ = ("prefix", "suffixes", "exceptions")

    def __init__(self, prefix: bytes, suffixes: list,
                 exceptions: dict[int, bytes] | None = None):
        self.prefix = prefix
        self.suffixes = suffixes
        self.exceptions = exceptions or {}

    def __len__(self) -> int:
        return len(self.suffixes)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(len(self)))]
        if i < 0:
            i += len(self)
        exc = self.exceptions.get(i)
        if exc is not None:
            return exc
        return self.prefix + self.suffixes[i]

    def rows_for(self, idxs) -> list:
        """The factored rows for the selected indices: PrefixedMsg for
        shared rows (all referencing THE one prefix object, so staging
        batches them as a single run), exact bytes for exceptions."""
        out = []
        for i in idxs:
            exc = self.exceptions.get(i)
            out.append(exc if exc is not None
                       else PrefixedMsg(self.prefix, self.suffixes[i]))
        return out
