"""Validator and ValidatorSet with proposer-priority rotation.

Reference: types/validator.go, types/validator_set.go. The rotation
algorithm (a-priori deterministic weighted round-robin with priority
centering and rescaling) is consensus-critical: every node must compute the
identical proposer for (height, round), so the arithmetic here mirrors the
reference exactly — including int64 clipping semantics
(validator_set.go:114-250) — implemented over Python ints with explicit
clamps.

The port's copy of cometbft_tpu/types/validator.py. pub_key_from_proto
decodes the key types the port has (ed25519, sr25519); secp256k1 and
bls12381 keys raise crypto.ErrInvalidKey until their slices land.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace

from cometbft_tpu_torch import crypto
from cometbft_tpu_torch.crypto import merkle
from cometbft_tpu_torch.utils import protobuf as pb

INT64_MAX = (1 << 63) - 1
INT64_MIN = -(1 << 63)
# reference: types/validator_set.go:25
MAX_TOTAL_VOTING_POWER = INT64_MAX // 8
# reference: types/validator_set.go:30
PRIORITY_WINDOW_SIZE_FACTOR = 2


def _clip(v: int) -> int:
    return max(INT64_MIN, min(INT64_MAX, v))


@dataclass
class Validator:
    """types/validator.go:13-20."""

    address: bytes
    pub_key: crypto.PubKey
    voting_power: int
    proposer_priority: int = 0

    @classmethod
    def new(cls, pub_key: crypto.PubKey, voting_power: int) -> "Validator":
        return cls(
            address=pub_key.address(),
            pub_key=pub_key,
            voting_power=voting_power,
            proposer_priority=0,
        )

    def copy(self) -> "Validator":
        return replace(self)

    def validate_basic(self) -> None:
        if self.pub_key is None:
            raise ValueError("validator does not have a public key")
        if self.voting_power < 0:
            raise ValueError("validator has negative voting power")
        if len(self.address) != crypto.ADDRESS_SIZE:
            raise ValueError("validator address is the wrong size")

    def compare_proposer_priority(self, other: "Validator") -> int:
        """Higher priority wins; tie-break by lower address
        (validator_set.go CompareProposerPriority)."""
        if self.proposer_priority > other.proposer_priority:
            return -1
        if self.proposer_priority < other.proposer_priority:
            return 1
        if self.address < other.address:
            return -1
        if self.address > other.address:
            return 1
        raise ValueError("cannot compare identical validators")

    def bytes_(self) -> bytes:
        """SimpleValidator proto: pub_key=1 (crypto.PublicKey oneof),
        voting_power=2 — the valset-hash leaf (types/validator.go:117-133)."""
        pk = pub_key_to_proto(self.pub_key)
        w = pb.Writer()
        w.message(1, pk)
        w.varint_i64(2, self.voting_power)
        return w.output()

    def to_proto(self) -> bytes:
        """tendermint.types.Validator: address=1, pub_key=2, voting_power=3,
        proposer_priority=4 (types/validator.go ToProto)."""
        w = pb.Writer()
        w.bytes(1, self.address)
        w.message(2, pub_key_to_proto(self.pub_key), always=True)
        w.varint_i64(3, self.voting_power)
        w.varint_i64(4, self.proposer_priority)
        return w.output()

    @classmethod
    def from_proto(cls, data: bytes) -> "Validator":
        r = pb.Reader(data)
        address = b""
        pub_key = None
        power = 0
        priority = 0
        while not r.at_end():
            f, w = r.read_tag()
            if f == 1:
                address = r.read_bytes()
            elif f == 2:
                pub_key = pub_key_from_proto(r.read_bytes())
            elif f == 3:
                power = r.read_varint_i64()
            elif f == 4:
                priority = r.read_varint_i64()
            else:
                r.skip(w)
        if pub_key is None:
            raise ValueError("Validator proto missing pub_key")
        return cls(
            address=address or pub_key.address(),
            pub_key=pub_key,
            voting_power=power,
            proposer_priority=priority,
        )


def pub_key_to_proto(pub_key: crypto.PubKey) -> bytes:
    """crypto.PublicKey oneof: ed25519=1 bytes, secp256k1=2 bytes
    (proto/tendermint/crypto/keys.proto)."""
    field_num = {"ed25519": 1, "secp256k1": 2, "sr25519": 3,
                 "bls12381": 4}.get(pub_key.type_())
    if field_num is None:
        raise ValueError(f"unsupported pubkey type {pub_key.type_()}")
    return pb.Writer().bytes(field_num, pub_key.bytes_(), always=True).output()


def pub_key_from_proto(data: bytes) -> crypto.PubKey:
    """crypto.PublicKey oneof -> the port's key: ed25519 (field 1), sr25519
    (field 3) or bls12381 (field 4). secp256k1 (2) raises ErrInvalidKey: the
    port has no such keys."""
    from cometbft_tpu_torch.crypto import bls12381, ed25519, sr25519

    r = pb.Reader(data)
    while not r.at_end():
        f, w = r.read_tag()
        if f == 1:
            return ed25519.PubKey(r.read_bytes())
        if f == 3:
            return sr25519.PubKey(r.read_bytes())
        if f == 4:
            return bls12381.PubKey(r.read_bytes())
        if f == 2:
            raise crypto.ErrInvalidKey("secp256k1 keys are not supported by the port")
        r.skip(w)
    raise ValueError("empty/unsupported PublicKey proto")


class ValidatorSet:
    """types/validator_set.go:55-66. Validators sorted by address; proposer
    tracked explicitly and rotated by priority."""

    def __init__(self, validators: list[Validator]):
        self.validators: list[Validator] = sorted(
            (v.copy() for v in validators), key=lambda v: v.address
        )
        self.proposer: Validator | None = None
        self._total_voting_power: int | None = None
        if self.validators:
            self._update_total_voting_power()
            self.increment_proposer_priority(1)

    # ---------------------------------------------------------------- basics

    def is_nil_or_empty(self) -> bool:
        return not self.validators

    def __len__(self) -> int:
        return len(self.validators)

    def copy(self) -> "ValidatorSet":
        new = ValidatorSet.__new__(ValidatorSet)
        new.validators = [v.copy() for v in self.validators]
        new.proposer = self.proposer.copy() if self.proposer else None
        new._total_voting_power = self._total_voting_power
        return new

    def _update_total_voting_power(self) -> None:
        total = 0
        for v in self.validators:
            total += v.voting_power
            if total > MAX_TOTAL_VOTING_POWER:
                raise ValueError(
                    f"total voting power cannot exceed {MAX_TOTAL_VOTING_POWER}"
                )
        self._total_voting_power = total

    def total_voting_power(self) -> int:
        if self._total_voting_power is None:
            self._update_total_voting_power()
        return self._total_voting_power

    def _address_index(self) -> dict[bytes, int]:
        """address -> index of its first validator, built on first use and
        again when the validators list is another object or another length
        (the reference scans the list: O(N) a lookup, which a trusting check
        of a 10,240-validator commit pays per signature)."""
        key = (id(self.validators), len(self.validators))
        cached = getattr(self, "_by_address", None)
        if cached is None or cached[0] != key:
            idx: dict[bytes, int] = {}
            for i, v in enumerate(self.validators):
                idx.setdefault(v.address, i)
            cached = self._by_address = (key, idx)
        return cached[1]

    def _index_of(self, address: bytes) -> int:
        i = self._address_index().get(address, -1)
        if i >= 0 and self.validators[i].address != address:  # replaced in place
            self._by_address = None
            i = self._address_index().get(address, -1)
        return i

    def has_address(self, address: bytes) -> bool:
        return self._index_of(address) >= 0

    def get_by_address(self, address: bytes) -> tuple[int, Validator | None]:
        i = self._index_of(address)
        return (i, self.validators[i].copy()) if i >= 0 else (-1, None)

    def get_by_index(self, index: int) -> tuple[bytes, Validator | None]:
        if index < 0 or index >= len(self.validators):
            return b"", None
        v = self.validators[index]
        return v.address, v.copy()

    # ------------------------------------------------------------- proposer

    def get_proposer(self) -> Validator | None:
        if not self.validators:
            return None
        if self.proposer is None:
            self.proposer = self._find_proposer()
        return self.proposer.copy()

    def _find_proposer(self) -> Validator:
        best = None
        for v in self.validators:
            if best is None or v.compare_proposer_priority(best) < 0:
                best = v
        return best

    def increment_proposer_priority(self, times: int) -> None:
        """validator_set.go:114-136."""
        if self.is_nil_or_empty():
            raise ValueError("empty validator set")
        if times <= 0:
            raise ValueError("cannot call IncrementProposerPriority with non-positive times")
        diff_max = PRIORITY_WINDOW_SIZE_FACTOR * self.total_voting_power()
        self.rescale_priorities(diff_max)
        self._shift_by_avg_proposer_priority()
        proposer = None
        for _ in range(times):
            proposer = self._increment_proposer_priority()
        self.proposer = proposer

    def rescale_priorities(self, diff_max: int) -> None:
        """validator_set.go:141-162: divide by ceil(diff/diffMax) when the
        priority span exceeds diffMax. Go integer division truncates toward
        zero — mirror that, not Python floor."""
        if diff_max <= 0:
            return
        diff = self._max_min_priority_diff()
        ratio = (diff + diff_max - 1) // diff_max
        if diff > diff_max:
            for v in self.validators:
                q = abs(v.proposer_priority) // ratio
                v.proposer_priority = q if v.proposer_priority >= 0 else -q

    def _max_min_priority_diff(self) -> int:
        prios = [v.proposer_priority for v in self.validators]
        return abs(max(prios) - min(prios))

    def _increment_proposer_priority(self) -> Validator:
        for v in self.validators:
            v.proposer_priority = _clip(v.proposer_priority + v.voting_power)
        mostest = self._find_proposer()
        mostest.proposer_priority = _clip(
            mostest.proposer_priority - self.total_voting_power()
        )
        return mostest

    def _shift_by_avg_proposer_priority(self) -> None:
        n = len(self.validators)
        # Go big.Int Div: Euclidean-style? No — big.Int.Div with positive
        # divisor floors toward -inf for negative dividends, same as Python.
        avg = sum(v.proposer_priority for v in self.validators) // n
        for v in self.validators:
            v.proposer_priority = _clip(v.proposer_priority - avg)

    # ---------------------------------------------------------------- hash

    def hash(self) -> bytes:
        """Merkle root of SimpleValidator leaves (validator_set.go:347-353)."""
        return merkle.hash_from_byte_slices([v.bytes_() for v in self.validators])

    # -------------------------------------------------------------- updates

    def update_with_change_set(self, changes: list[Validator]) -> None:
        """Apply ABCI ValidatorUpdates (validator_set.go:502-576 semantics):
        power 0 = removal; new addresses added; existing updated. Priorities
        of new validators start at -1.125 * total power (so they don't
        immediately propose); then recenter/rescale."""
        if not changes:
            return
        seen: set[bytes] = set()
        for c in changes:
            if c.address in seen:
                raise ValueError(f"duplicate entry {c.address.hex()} in changes")
            seen.add(c.address)
            if c.voting_power < 0:
                raise ValueError("voting power can't be negative")

        removals = {c.address for c in changes if c.voting_power == 0}
        updates = [c for c in changes if c.voting_power > 0]

        for addr in removals:
            if not self.has_address(addr):
                raise ValueError(f"failed to find validator {addr.hex()} to remove")

        by_addr = {v.address: v for v in self.validators}
        # Total voting power after updates but BEFORE removals — the base
        # for both the cap check and new-validator priorities
        # (validator_set.go:490,618-624 tvpAfterUpdatesBeforeRemovals;
        # excluding removals here would permanently diverge proposer
        # rotation from the reference for mixed add+remove change sets).
        upd_by_addr = {u.address: u for u in updates}
        new_total = 0
        for v in self.validators:
            upd = upd_by_addr.get(v.address)
            new_total += upd.voting_power if upd else v.voting_power
        for u in updates:
            if u.address not in by_addr:
                new_total += u.voting_power
        if new_total > MAX_TOTAL_VOTING_POWER:
            raise ValueError("total voting power would exceed maximum")

        for u in updates:
            existing = by_addr.get(u.address)
            if existing is not None:
                existing.voting_power = u.voting_power
                existing.pub_key = u.pub_key
            else:
                nv = u.copy()
                # validator_set.go:316: new validators get -(total + total/8)
                nv.proposer_priority = -(new_total + (new_total >> 3))
                self.validators.append(nv)
        self.validators = [v for v in self.validators if v.address not in removals]
        self.validators.sort(key=lambda v: v.address)
        self._by_address = None
        self._total_voting_power = None
        self._update_total_voting_power()
        if self.validators:
            self.rescale_priorities(PRIORITY_WINDOW_SIZE_FACTOR * self.total_voting_power())
            self._shift_by_avg_proposer_priority()
            self.proposer = self._find_proposer()

    def validate_basic(self) -> None:
        if self.is_nil_or_empty():
            raise ValueError("validator set is nil or empty")
        for v in self.validators:
            v.validate_basic()
        if self.proposer is not None:
            self.proposer.validate_basic()
            if not self.has_address(self.proposer.address):
                raise ValueError("proposer not in validator set")

    def __iter__(self):
        return iter(self.validators)

    # ---------------------------------------------------------------- wire

    def to_proto(self) -> bytes:
        """tendermint.types.ValidatorSet: validators=1, proposer=2,
        total_voting_power=3 (types/validator_set.go ToProto)."""
        w = pb.Writer()
        for v in self.validators:
            w.message(1, v.to_proto(), always=True)
        if self.proposer is not None:
            w.message(2, self.proposer.to_proto(), always=True)
        w.varint_i64(3, self.total_voting_power())
        return w.output()

    @classmethod
    def from_proto(cls, data: bytes) -> "ValidatorSet":
        r = pb.Reader(data)
        vals: list[Validator] = []
        proposer: Validator | None = None
        while not r.at_end():
            f, w = r.read_tag()
            if f == 1:
                vals.append(Validator.from_proto(r.read_bytes()))
            elif f == 2:
                proposer = Validator.from_proto(r.read_bytes())
            else:
                r.skip(w)
        vs = cls.__new__(cls)
        vs.validators = sorted(vals, key=lambda v: v.address)
        vs.proposer = proposer
        vs._total_voting_power = None
        if vs.validators:
            vs._update_total_voting_power()
        return vs
