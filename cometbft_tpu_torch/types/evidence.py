"""Byzantine evidence types (reference: types/evidence.go).

DuplicateVoteEvidence — equivocation: two signed votes for the same
height/round/type but different blocks. LightClientAttackEvidence — a
conflicting light block trace. Verification lives in evidence/verify.py
(pool-side); here are the types, hashing, and ABCI conversion.

The port's copy of cometbft_tpu/types/evidence.py.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from cometbft_tpu_torch.crypto import tmhash
from cometbft_tpu_torch.types.validator import Validator, ValidatorSet
from cometbft_tpu_torch.types.vote import Vote
from cometbft_tpu_torch.utils import cmttime
from cometbft_tpu_torch.utils import protobuf as pb


class Evidence:
    """types/evidence.go Evidence interface."""

    def abci(self) -> list[dict]:
        raise NotImplementedError

    def bytes_(self) -> bytes:
        raise NotImplementedError

    def hash(self) -> bytes:
        return tmhash.sum_(self.bytes_())

    def height(self) -> int:
        raise NotImplementedError

    def time(self) -> cmttime.Timestamp:
        raise NotImplementedError

    def validate_basic(self) -> None:
        raise NotImplementedError

    def string(self) -> str:
        raise NotImplementedError


@dataclass
class DuplicateVoteEvidence(Evidence):
    """types/evidence.go:53-71."""

    vote_a: Vote
    vote_b: Vote
    total_voting_power: int = 0
    validator_power: int = 0
    timestamp: cmttime.Timestamp = field(default_factory=cmttime.Timestamp.zero)

    @classmethod
    def new(
        cls,
        vote1: Vote,
        vote2: Vote,
        block_time: cmttime.Timestamp,
        val_set: ValidatorSet,
    ) -> "DuplicateVoteEvidence":
        """types/evidence.go NewDuplicateVoteEvidence: orders votes by
        BlockID key, fills powers from the valset."""
        if vote1 is None or vote2 is None or val_set is None:
            raise ValueError("missing vote or validator set")
        _, val = val_set.get_by_address(vote1.validator_address)
        if val is None:
            raise ValueError("validator is not in validator set")
        if vote1.block_id.key() < vote2.block_id.key():
            vote_a, vote_b = vote1, vote2
        else:
            vote_a, vote_b = vote2, vote1
        return cls(
            vote_a=vote_a,
            vote_b=vote_b,
            total_voting_power=val_set.total_voting_power(),
            validator_power=val.voting_power,
            timestamp=block_time,
        )

    def abci(self) -> list[dict]:
        return [
            {
                "type": "DUPLICATE_VOTE",
                "validator_address": self.vote_a.validator_address,
                "validator_power": self.validator_power,
                "height": self.vote_a.height,
                "time": self.timestamp,
                "total_voting_power": self.total_voting_power,
            }
        ]

    def bytes_(self) -> bytes:
        return self.to_proto()

    def height(self) -> int:
        return self.vote_a.height

    def time(self) -> cmttime.Timestamp:
        return self.timestamp

    def validate_basic(self) -> None:
        if self.vote_a is None or self.vote_b is None:
            raise ValueError("empty duplicate vote evidence")
        self.vote_a.validate_basic()
        self.vote_b.validate_basic()
        if self.vote_a.block_id.key() >= self.vote_b.block_id.key():
            raise ValueError("duplicate votes in invalid order")

    def string(self) -> str:
        return f"DuplicateVoteEvidence{{VoteA: {self.vote_a}, VoteB: {self.vote_b}}}"

    def to_proto(self) -> bytes:
        w = pb.Writer()
        w.message(1, self.vote_a.to_proto(), always=True)
        w.message(2, self.vote_b.to_proto(), always=True)
        w.varint_i64(3, self.total_voting_power)
        w.varint_i64(4, self.validator_power)
        w.message(
            5, pb.timestamp_bytes(self.timestamp.seconds, self.timestamp.nanos), always=True
        )
        return w.output()

    @classmethod
    def from_proto(cls, data: bytes) -> "DuplicateVoteEvidence":
        r = pb.Reader(data)
        ev = cls(vote_a=None, vote_b=None)  # type: ignore[arg-type]
        while not r.at_end():
            f, w = r.read_tag()
            if f == 1:
                ev.vote_a = Vote.from_proto(r.read_bytes())
            elif f == 2:
                ev.vote_b = Vote.from_proto(r.read_bytes())
            elif f == 3:
                ev.total_voting_power = r.read_varint_i64()
            elif f == 4:
                ev.validator_power = r.read_varint_i64()
            elif f == 5:
                secs, nanos = r.read_timestamp()
                ev.timestamp = cmttime.Timestamp(secs, nanos)
            else:
                r.skip(w)
        return ev


@dataclass
class LightClientAttackEvidence(Evidence):
    """types/evidence.go:203-260. Carries the conflicting light block and the
    common height; byzantine validators filled in by the evidence pool."""

    conflicting_block: "object"  # light.LightBlock (avoid circular import)
    common_height: int
    byzantine_validators: list[Validator] = field(default_factory=list)
    total_voting_power: int = 0
    timestamp: cmttime.Timestamp = field(default_factory=cmttime.Timestamp.zero)

    def abci(self) -> list[dict]:
        return [
            {
                "type": "LIGHT_CLIENT_ATTACK",
                "validator_address": v.address,
                "validator_power": v.voting_power,
                "height": self.height(),
                "time": self.timestamp,
                "total_voting_power": self.total_voting_power,
            }
            for v in self.byzantine_validators
        ]

    def bytes_(self) -> bytes:
        return self.to_proto()

    def to_proto(self) -> bytes:
        """tendermint.types.LightClientAttackEvidence: conflicting_block=1,
        common_height=2, byzantine_validators=3, total_voting_power=4,
        timestamp=5."""
        w = pb.Writer()
        w.message(1, self.conflicting_block.to_proto(), always=True)
        w.varint_i64(2, self.common_height)
        for v in self.byzantine_validators:
            w.message(3, v.to_proto(), always=True)
        w.varint_i64(4, self.total_voting_power)
        w.message(
            5, pb.timestamp_bytes(self.timestamp.seconds, self.timestamp.nanos), always=True
        )
        return w.output()

    @classmethod
    def from_proto(cls, data: bytes) -> "LightClientAttackEvidence":
        from cometbft_tpu_torch.types.light import LightBlock

        r = pb.Reader(data)
        ev = cls(conflicting_block=None, common_height=0)
        while not r.at_end():
            f, w = r.read_tag()
            if f == 1:
                ev.conflicting_block = LightBlock.from_proto(r.read_bytes())
            elif f == 2:
                ev.common_height = r.read_varint_i64()
            elif f == 3:
                ev.byzantine_validators.append(Validator.from_proto(r.read_bytes()))
            elif f == 4:
                ev.total_voting_power = r.read_varint_i64()
            elif f == 5:
                secs, nanos = r.read_timestamp()
                ev.timestamp = cmttime.Timestamp(secs, nanos)
            else:
                r.skip(w)
        return ev

    def hash(self) -> bytes:
        """types/evidence.go:322-329: header hash + common height — stable
        across byzantine-validator permutations (dedup key)."""
        w = pb.Writer()
        w.bytes(1, self.conflicting_block.hash() or b"")
        w.varint_i64(2, self.common_height)
        return tmhash.sum_(w.output())

    def conflicting_header_is_invalid(self, trusted_header) -> bool:
        """types/evidence.go:303-312: lunatic iff any state-derived header
        field differs from the trusted header at the same height."""
        ch = self.conflicting_block.header
        return (
            trusted_header.validators_hash != ch.validators_hash
            or trusted_header.next_validators_hash != ch.next_validators_hash
            or trusted_header.consensus_hash != ch.consensus_hash
            or trusted_header.app_hash != ch.app_hash
            or trusted_header.last_results_hash != ch.last_results_hash
        )

    def get_byzantine_validators(self, common_vals: ValidatorSet,
                                 trusted) -> list[Validator]:
        """types/evidence.go:250-300: classify the attack and extract the
        culprits. Lunatic -> signers of the conflicting commit who are in
        the common valset; equivocation (same round) -> validators who
        signed both commits; amnesia (different rounds) -> unknown."""
        from cometbft_tpu_torch.types.basic import BlockIDFlag

        out: list[Validator] = []
        conflicting = self.conflicting_block
        if self.conflicting_header_is_invalid(trusted.header):
            for cs in conflicting.commit.signatures:
                if cs.block_id_flag != BlockIDFlag.COMMIT:
                    continue
                _, val = common_vals.get_by_address(cs.validator_address)
                if val is None:
                    continue
                out.append(val)
        elif trusted.commit.round_ == conflicting.commit.round_:
            for i, sig_a in enumerate(conflicting.commit.signatures):
                if sig_a.block_id_flag != BlockIDFlag.COMMIT:
                    continue
                if i >= len(trusted.commit.signatures):
                    continue
                sig_b = trusted.commit.signatures[i]
                if sig_b.block_id_flag != BlockIDFlag.COMMIT:
                    continue
                _, val = conflicting.validator_set.get_by_address(sig_a.validator_address)
                if val is not None:
                    out.append(val)
        out.sort(key=lambda v: (-v.voting_power, v.address))
        return out

    def height(self) -> int:
        return self.common_height

    def time(self) -> cmttime.Timestamp:
        return self.timestamp

    def validate_basic(self) -> None:
        if self.conflicting_block is None:
            raise ValueError("conflicting block is nil")
        if self.common_height <= 0:
            raise ValueError("negative or zero common height")

    def string(self) -> str:
        return f"LightClientAttackEvidence{{CommonHeight: {self.common_height}}}"


def evidence_list_to_proto(evs: list[Evidence]) -> bytes:
    """tendermint.types.EvidenceList: repeated oneof-wrapped evidence."""
    w = pb.Writer()
    for ev in evs:
        inner = pb.Writer()
        if isinstance(ev, DuplicateVoteEvidence):
            inner.message(1, ev.to_proto(), always=True)
        elif isinstance(ev, LightClientAttackEvidence):
            inner.message(2, ev.to_proto(), always=True)
        else:
            raise ValueError(f"unsupported evidence type for wire: {type(ev)}")
        w.message(1, inner.output(), always=True)
    return w.output()


def evidence_list_from_proto(data: bytes) -> list[Evidence]:
    out: list[Evidence] = []
    r = pb.Reader(data)
    while not r.at_end():
        f, w = r.read_tag()
        if f == 1:
            er = r.read_message()
            while not er.at_end():
                ef, ew = er.read_tag()
                if ef == 1:
                    out.append(DuplicateVoteEvidence.from_proto(er.read_bytes()))
                elif ef == 2:
                    out.append(LightClientAttackEvidence.from_proto(er.read_bytes()))
                else:
                    er.skip(ew)
        else:
            r.skip(w)
    return out
