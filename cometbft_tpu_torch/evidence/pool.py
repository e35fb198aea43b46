"""EvidencePool (reference: evidence/pool.go).

Verified-but-uncommitted Byzantine proofs, persisted under two keyspaces
(pending / committed-marker) exactly like the reference's prefix scheme
(pool.go:45-50). The pool:

  add_evidence     — dedupe + verify + persist + offer to gossip
  pending_evidence — proposer's pull, size-capped (pool.go:100-130)
  check_evidence   — validates evidence in a peer's proposed block
  update           — post-commit: mark committed, prune expired

The reference guards the pool with mutexes; here every call happens on the
consensus asyncio task (or blocksync's), so plain dicts suffice — same
single-writer discipline as the rest of the engine.

The port's copy of cometbft_tpu/evidence/pool.py.
"""

from __future__ import annotations

from typing import Callable, Iterable

from cometbft_tpu_torch.evidence.verify import ErrInvalidEvidence, verify_evidence
from cometbft_tpu_torch.libs import log as cmtlog
from cometbft_tpu_torch.state.state import State
from cometbft_tpu_torch.state.store import StateStore
from cometbft_tpu_torch.store.db import KVStore, MemDB
from cometbft_tpu_torch.types.evidence import (
    DuplicateVoteEvidence,
    Evidence,
    evidence_list_from_proto,
    evidence_list_to_proto,
)

_PENDING = b"\x00"
_COMMITTED = b"\x01"


def _key(prefix: bytes, ev: Evidence) -> bytes:
    return prefix + ev.height().to_bytes(8, "big") + ev.hash()


class EvidencePool:
    def __init__(
        self,
        db: KVStore | None,
        state_store: StateStore,
        logger: cmtlog.Logger | None = None,
        block_store=None,
    ):
        self.db = db if db is not None else MemDB()
        self.state_store = state_store
        # historical signed headers for light-client-attack verification
        # (pool.go:66 blockStore); None -> LC evidence is rejected
        self.block_store = block_store
        self.logger = logger or cmtlog.nop()
        self._pending: dict[bytes, Evidence] = {}
        self._committed: set[bytes] = set()
        self._consensus_buffer: list[tuple] = []
        self._state: State | None = state_store.load()
        # broadcast hook: the evidence reactor subscribes (reactor.go:32)
        self.on_evidence_added: Callable[[Evidence], None] | None = None
        self.metrics = None  # libs.metrics.EvidenceMetrics | None (node wires it)
        self._load()

    # -------------------------------------------------------------- intake

    def add_evidence(self, ev: Evidence, from_consensus: bool = False) -> bool:
        """pool.go:136-192 AddEvidence: idempotent; verifies before
        accepting. Returns True if newly added. from_consensus marks
        evidence our own engine produced (pool.go:196
        AddEvidenceFromConsensus): its height has no committed header yet,
        so the block-time cross-check is skipped."""
        try:
            ev.validate_basic()  # before hash(): malformed wire evidence
        except ValueError as e:
            raise ErrInvalidEvidence(f"evidence failed basic validation: {e}") from e
        h = ev.hash()
        if h in self._committed or h in self._pending:
            return False
        state = self._state or self.state_store.load()
        if state is None:
            raise ErrInvalidEvidence("evidence pool has no state")
        verify_evidence(ev, state, self._validators_at, self.block_store,
                        from_consensus=from_consensus)
        self._pending[h] = ev
        # oneof-wrapped so the type survives reload (DuplicateVote vs LC attack)
        self.db.set(_key(_PENDING, ev), evidence_list_to_proto([ev]))
        self.logger.info("verified new evidence of byzantine behavior", evidence=ev.string())
        if self.on_evidence_added is not None:
            self.on_evidence_added(ev)
        return True

    def check_evidence(self, evs: Iterable[Evidence]) -> None:
        """pool.go:194-235 CheckEvidence: every piece in a proposed block
        must be valid and not already committed; duplicates within the
        list are rejected."""
        seen: set[bytes] = set()
        for ev in evs:
            try:
                ev.validate_basic()
            except ValueError as e:
                raise ErrInvalidEvidence(f"evidence failed basic validation: {e}") from e
            h = ev.hash()
            if h in seen:
                raise ErrInvalidEvidence(f"duplicate evidence {h.hex()} in block")
            seen.add(h)
            if h in self._committed:
                raise ErrInvalidEvidence(f"evidence {h.hex()} was already committed")
            if h not in self._pending:
                state = self._state or self.state_store.load()
                verify_evidence(ev, state, self._validators_at, self.block_store)

    # ------------------------------------------------------------- outflow

    def pending_evidence(self, max_bytes: int) -> tuple[list[Evidence], int]:
        """pool.go:100-130 PendingEvidence: oldest-first under a byte cap."""
        out: list[Evidence] = []
        size = 0
        for ev in sorted(self._pending.values(), key=lambda e: (e.height(), e.hash())):
            ev_size = len(ev.bytes_()) + 16  # proto wrapper overhead
            if max_bytes >= 0 and size + ev_size > max_bytes:
                break
            out.append(ev)
            size += ev_size
        return out, size

    def report_conflicting_votes(self, vote_a, vote_b) -> None:
        """pool.go:196 ReportConflictingVotes: buffer an equivocation seen
        by consensus. Evidence is materialized in update() once the header
        at that height is committed, so its timestamp can be the BLOCK time
        (the time cross-check other pools apply would reject anything
        else)."""
        self._consensus_buffer.append((vote_a, vote_b))

    def _process_consensus_buffer(self, state: State) -> None:
        """pool.go:459-520 processConsensusBuffer."""
        from cometbft_tpu_torch.types.evidence import DuplicateVoteEvidence

        buf, self._consensus_buffer = self._consensus_buffer, []
        for vote_a, vote_b in buf:
            try:
                if vote_a.height == state.last_block_height:
                    ev = DuplicateVoteEvidence.new(
                        vote_a, vote_b, state.last_block_time, state.last_validators
                    )
                elif vote_a.height < state.last_block_height:
                    val_set = self.state_store.load_validators(vote_a.height)
                    meta = (
                        self.block_store.load_block_meta(vote_a.height)
                        if self.block_store is not None else None
                    )
                    if val_set is None or meta is None:
                        self.logger.error(
                            "failed to load valset/header for conflicting votes",
                            height=vote_a.height,
                        )
                        continue
                    ev = DuplicateVoteEvidence.new(
                        vote_a, vote_b, meta.header.time, val_set
                    )
                else:
                    # votes above the committed height: retry next update
                    self._consensus_buffer.append((vote_a, vote_b))
                    continue
                self.add_evidence(ev, from_consensus=True)
            except Exception as e:  # noqa: BLE001 - never wedge the commit path
                self.logger.error("failed to convert conflicting votes", err=str(e))

    def update(self, state: State, committed: list[Evidence]) -> None:
        """pool.go:80-98: called after every ApplyBlock with the evidence
        the block carried. Marks committed + prunes expired pending,
        then materializes buffered consensus equivocations."""
        self._state = state
        for ev in committed:
            h = ev.hash()
            self._committed.add(h)
            self.db.set(_key(_COMMITTED, ev), b"\x01")
            if h in self._pending:
                del self._pending[h]
                self.db.delete(_key(_PENDING, ev))
        self._prune_expired(state)
        self._process_consensus_buffer(state)
        if self.metrics is not None:
            if committed:
                self.metrics.evidence_committed.inc(len(committed))
            self.metrics.evidence_pending.set(len(self._pending))

    # ------------------------------------------------------------ internals

    def _prune_expired(self, state: State) -> None:
        params = state.consensus_params.evidence
        height = state.last_block_height
        now_ns = state.last_block_time.unix_ns()
        for h, ev in list(self._pending.items()):
            if (
                height - ev.height() > params.max_age_num_blocks
                and now_ns - ev.time().unix_ns() > params.max_age_duration_ns
            ):
                del self._pending[h]
                self.db.delete(_key(_PENDING, ev))

    def _validators_at(self, height: int):
        return self.state_store.load_validators(height)

    def _load(self) -> None:
        """Recover pending/committed sets from the DB on boot."""
        for k, v in self.db.iterate(_PENDING, _PENDING + b"\xff" * 40):
            if not k.startswith(_PENDING):
                continue
            try:
                evs = evidence_list_from_proto(v)
            except Exception:  # noqa: BLE001 - pre-wrapper rows (bare proto)
                evs = [DuplicateVoteEvidence.from_proto(v)]
            for ev in evs:
                self._pending[ev.hash()] = ev
        for k, _ in self.db.iterate(_COMMITTED, _COMMITTED + b"\xff" * 40):
            if k.startswith(_COMMITTED):
                self._committed.add(k[-32:])

    def size(self) -> int:
        return len(self._pending)
