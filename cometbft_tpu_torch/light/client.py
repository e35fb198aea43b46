"""The light client: trusted-state bootstrap, sequential + skipping
(bisection) verification, fork detection, attack evidence.

Reference: light/client.go (Client, verifySequential:613, verifySkipping:706,
backwards:933) and light/detector.go (detectDivergence:28,
examineConflictingHeaderAgainstTrace:290, newLightClientAttackEvidence:408).

Every hop of a bisection lands in verify_commit_light /
verify_commit_light_trusting (types/validation.py), which put a commit's
whole signature set into one device batch: a 500-validator hop of BASELINE
config 4 is one drain of the scheduler on the card (K5, K1, K6), so a
100k-height bisection costs a handful of batches rather than ~10^5 host
verifies. The client logic itself is asyncio (providers are
network-bound), single-task — no locks. The scheduler drains inline, so a
hop blocks the event loop for one flush, as in the reference; the ambient
priority class is a contextvar, read in the coroutine that stages the hop.

The port's copy of cometbft_tpu/light/client.py.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Callable, Optional

from cometbft_tpu_torch.types.evidence import LightClientAttackEvidence
from cometbft_tpu_torch.types.light import LightBlock
from cometbft_tpu_torch.types.validation import Fraction
from cometbft_tpu_torch.utils import cmttime

from cometbft_tpu_torch.light import verifier
from cometbft_tpu_torch.light.errors import (
    ErrFailedHeaderCrossReferencing,
    ErrInvalidHeader,
    ErrLightBlockNotFound,
    ErrLightClientAttack,
    ErrNewValSetCantBeTrusted,
    ErrNoWitnesses,
    ErrVerificationFailed,
    LightClientError,
)
from cometbft_tpu_torch.light.provider import Provider
from cometbft_tpu_torch.light.store import LightStore

SEQUENTIAL = "sequential"
SKIPPING = "skipping"

# client.go:36-44 defaults
DEFAULT_PRUNING_SIZE = 1000
DEFAULT_MAX_CLOCK_DRIFT_NS = 10 * 1_000_000_000
# pivot = trusted + (new-trusted) * 1/2 (client.go:52-56)
_PIVOT_NUM, _PIVOT_DEN = 1, 2


@dataclass
class TrustOptions:
    """light/trust_options.go: subjective-initialization root of trust."""

    period_ns: int
    height: int
    hash_: bytes

    def validate_basic(self) -> None:
        if self.period_ns <= 0:
            raise ValueError("negative or zero trusting period")
        if self.height <= 0:
            raise ValueError("negative or zero trusted height")
        if len(self.hash_) != 32:
            raise ValueError("expected 32-byte trusted header hash")


class Client:
    """light/client.go:147."""

    def __init__(
        self,
        chain_id: str,
        trust_options: TrustOptions,
        primary: Provider,
        witnesses: list[Provider],
        trusted_store: LightStore,
        *,
        verification_mode: str = SKIPPING,
        trust_level: Fraction = verifier.DEFAULT_TRUST_LEVEL,
        max_clock_drift_ns: int = DEFAULT_MAX_CLOCK_DRIFT_NS,
        pruning_size: int = DEFAULT_PRUNING_SIZE,
        logger: logging.Logger | None = None,
    ):
        trust_options.validate_basic()
        verifier.validate_trust_level(trust_level)
        self.chain_id = chain_id
        self.trust_options = trust_options
        self.trusting_period_ns = trust_options.period_ns
        self.primary = primary
        self.witnesses = list(witnesses)
        self.store = trusted_store
        self.verification_mode = verification_mode
        self.trust_level = trust_level
        self.max_clock_drift_ns = max_clock_drift_ns
        self.pruning_size = pruning_size
        self.logger = logger or logging.getLogger(__name__)
        self.latest_trusted: Optional[LightBlock] = trusted_store.latest_light_block()
        # in-flight dedup (libs/singleflight.py — the mempool CheckTx
        # pattern, extracted): concurrent verify_light_block_at_height/
        # update calls for the same height share ONE bisection — the
        # first caller runs it, the rest await its future (height 0 keys
        # the update() latest-head flight)
        from cometbft_tpu_torch.libs.singleflight import SingleFlight

        self._flights = SingleFlight()
        # optional shared-checkpoint source (the reference's serving fleet,
        # light/fleet.py, not ported yet, points this at its skip-list
        # cache): height -> trusted LightBlock at
        # the greatest cached height <= the requested one, or None. The
        # default consults this client's own store, so even a plain
        # client's bisection fast-forwards through heights it has already
        # verified instead of re-verifying hops above them.
        self.checkpoint_source: Callable[[int], Optional[LightBlock]] = (
            lambda h: self.store.light_block_before(h + 1))
        # certificate short-circuit (cert/): a primary that can serve
        # commit certificates lets a hop decide on a >2/3 bitmap tally
        # plus ONE pairing instead of per-vote commit verification —
        # accept-only, so any unusable certificate (absent, mismatched,
        # forged) falls through to the classic path bit-identically
        self.cert_source = getattr(primary, "commit_certificate", None)
        self.cert_hits = 0       # hops decided by a certificate
        self.cert_misses = 0     # no certificate at the hop height
        self.cert_fallbacks = 0  # held a certificate, ran classic anyway

    # ----------------------------------------------------------- bootstrap

    async def initialize(self, now: cmttime.Timestamp | None = None) -> None:
        """client.go:303-402: restore from the store or fetch the trust-
        options header from the primary, cross-check it with every witness,
        and persist it as the root of trust."""
        now = now or cmttime.now()
        if self.latest_trusted is not None:
            # checkTrustedHeaderUsingOptions (client.go:303)
            if self.latest_trusted.height < self.trust_options.height:
                opt_block = await self._light_block_from_primary(self.trust_options.height)
                if opt_block.hash() != self.trust_options.hash_:
                    raise LightClientError(
                        "trusted option header hash does not match the primary's"
                    )
            return
        lb = await self._light_block_from_primary(self.trust_options.height)
        if lb.hash() != self.trust_options.hash_:
            raise LightClientError(
                f"expected header's hash {self.trust_options.hash_.hex()}, "
                f"but got {lb.hash().hex()}"
            )
        lb.validate_basic(self.chain_id)
        # +2/3 of its own valset signed it (client.go:388-395)
        from cometbft_tpu_torch.types.validation import verify_commit_light

        verify_commit_light(
            self.chain_id, lb.validator_set, lb.commit.block_id, lb.height, lb.commit
        )
        await self._compare_first_header_with_witnesses(lb)
        self._update_trusted(lb)

    async def _compare_first_header_with_witnesses(self, lb: LightBlock) -> None:
        """client.go:1131: during subjective init every witness must agree
        — a divergent witness at the root of trust is simply dropped."""
        bad: list[int] = []
        for i, w in enumerate(self.witnesses):
            try:
                other = await w.light_block(lb.height)
            except LightClientError:
                continue
            if other.hash() != lb.hash():
                self.logger.error(
                    "witness %s disagrees with primary at the root of trust; removing",
                    w.id_())
                bad.append(i)
        self._remove_witnesses(bad)

    # -------------------------------------------------------------- verify

    async def verify_light_block_at_height(
        self, height: int, now: cmttime.Timestamp | None = None
    ) -> LightBlock:
        """client.go:474-523 — plus in-flight dedup: concurrent calls for
        the same height share the FIRST caller's bisection instead of each
        running their own (the store check alone cannot catch this — the
        store only fills once a flight completes)."""
        if height <= 0:
            raise ValueError("negative or zero height")
        now = now or cmttime.now()
        existing = self.store.light_block(height)
        if existing is not None:
            return existing
        _, lb = await self._flights.do(
            height, lambda: self._verify_at_height(height, now))
        return lb

    async def _verify_at_height(self, height: int, now) -> LightBlock:
        lb = await self._light_block_from_primary(height)
        await self._verify_light_block(lb, now)
        return lb

    async def update(self, now: cmttime.Timestamp | None = None) -> Optional[LightBlock]:
        """client.go:436-470: fetch + verify the primary's latest header if
        newer than the last trusted one. Concurrent update() calls share
        one flight (dedup key 0)."""
        now = now or cmttime.now()
        if self.latest_trusted is None:
            raise LightClientError("no headers exist yet")
        _, lb = await self._flights.do(0, lambda: self._update_flight(now))
        return lb

    async def _update_flight(self, now) -> Optional[LightBlock]:
        last = self.latest_trusted
        latest = await self._light_block_from_primary(0)
        if last is not None and latest.height > last.height:
            await self._verify_light_block(latest, now)
            return latest
        return None

    async def _verify_light_block(self, new_lb: LightBlock, now: cmttime.Timestamp) -> None:
        """client.go:558-611: pick forward (sequential/skipping) or
        backwards verification relative to the trusted state."""
        if self.store.light_block(new_lb.height) is not None:
            return
        closest = self.store.light_block_before(new_lb.height)
        if closest is not None:
            if self.verification_mode == SEQUENTIAL:
                await self._verify_sequential(closest, new_lb, now)
            else:
                await self._verify_skipping_against_primary(closest, new_lb, now)
            return
        first = self.store.first_light_block()
        if first is None:
            raise LightClientError("no trusted state to verify against; initialize first")
        await self._backwards(first, new_lb, now)

    async def _try_certificate(
        self, trusted: LightBlock, target: LightBlock, now: cmttime.Timestamp
    ) -> bool:
        """Try to decide the hop trusted→target with a commit certificate.

        True means the hop is verified (one pairing); False means run the
        classic per-vote path. Certificates are accept-only: any miss,
        mismatch, forged signature, or sub-trust-level tally returns False
        and costs nothing but the attempt. Header-shape/expiry errors raise
        exactly as the classic verifiers would, so callers' except clauses
        behave identically either way."""
        if self.cert_source is None:
            return False
        cert = await self.cert_source(target.height)
        if cert is None:
            self.cert_misses += 1
            return False
        ok = verifier.verify_with_certificate(
            trusted.signed_header, trusted.validator_set,
            target.signed_header, target.validator_set,
            self.trusting_period_ns, now, self.max_clock_drift_ns,
            self.trust_level, cert,
        )
        if ok:
            self.cert_hits += 1
        else:
            self.cert_fallbacks += 1
        return ok

    async def _verify_sequential(
        self, trusted: LightBlock, new_lb: LightBlock, now: cmttime.Timestamp
    ) -> None:
        """client.go:613-697 — height-by-height VerifyAdjacent. The devices
        see one commit batch per height, streamed."""
        verified = trusted
        trace = [trusted]
        for height in range(trusted.height + 1, new_lb.height + 1):
            interim = (
                new_lb if height == new_lb.height
                else await self._light_block_from_primary(height)
            )
            try:
                if not await self._try_certificate(verified, interim, now):
                    verifier.verify_adjacent(
                        verified.signed_header, interim.signed_header,
                        interim.validator_set, self.trusting_period_ns, now,
                        self.max_clock_drift_ns,
                    )
            except LightClientError as e:
                raise ErrVerificationFailed(verified.height, interim.height, e) from e
            verified = interim
            trace.append(verified)
        await self._detect_divergence(trace, now)
        for lb in trace[1:]:
            self._update_trusted(lb)

    async def _verify_skipping(
        self,
        source: Provider,
        trusted: LightBlock,
        new_lb: LightBlock,
        now: cmttime.Timestamp,
    ) -> list[LightBlock]:
        """client.go:706-775 — bisection. Returns the verification trace
        (every block the client had to fully verify, in height order).

        Shared-cache fast-forward: before fetching a pivot from the
        provider, `checkpoint_source` is consulted for an already-trusted
        block in (verified, pivot] — a hit advances `verified` directly
        (no fetch, no signature work for the hops below it). The
        reference's fleet service points this at its skip-list checkpoint
        cache, so a cold
        client's bisection restarts from the nearest cached checkpoint
        instead of walking all the way up from its own trust root."""
        block_cache = [new_lb]
        depth = 0
        verified = trusted
        trace = [trusted]
        while True:
            target = block_cache[depth]
            try:
                # certificate first: a usable certificate decides the hop
                # with one pairing; anything else (miss, mismatch, forged,
                # sub-trust-level) runs the unchanged classic path — the
                # canonical verdicts and errors below come from it
                if not await self._try_certificate(verified, target, now):
                    verifier.verify(
                        verified.signed_header, verified.validator_set,
                        target.signed_header, target.validator_set,
                        self.trusting_period_ns, now, self.max_clock_drift_ns,
                        self.trust_level,
                    )
            except ErrNewValSetCantBeTrusted:
                # jump too far: bisect [verified, target]
                if depth == len(block_cache) - 1:
                    pivot = (
                        verified.height
                        + (target.height - verified.height) * _PIVOT_NUM // _PIVOT_DEN
                    )
                    cached = self._trusted_checkpoint(pivot, verified, now)
                    if cached is not None:
                        verified = cached
                        trace.append(verified)
                        continue
                    interim = await source.light_block(pivot)
                    block_cache.append(interim)
                depth += 1
                continue
            except LightClientError as e:
                raise ErrVerificationFailed(verified.height, target.height, e) from e
            if depth == 0:
                trace.append(new_lb)
                return trace
            verified = target
            block_cache = block_cache[:depth]
            depth = 0
            trace.append(verified)

    async def _verify_skipping_against_primary(
        self, trusted: LightBlock, new_lb: LightBlock, now: cmttime.Timestamp
    ) -> None:
        """client.go:777-832: verifySkipping + witness cross-check."""
        trace = await self._verify_skipping(self.primary, trusted, new_lb, now)
        await self._detect_divergence(trace, now)
        for lb in trace[1:]:
            self._update_trusted(lb)

    async def _backwards(
        self, trusted: LightBlock, new_lb: LightBlock, now: cmttime.Timestamp
    ) -> None:
        """client.go:933-988: hash-chain walk below the first trusted
        header. No signature checks — pure header-link hashes (the trusted
        header transitively commits to every ancestor)."""
        if verifier.header_expired(trusted.signed_header, self.trusting_period_ns, now):
            raise ErrInvalidHeader("trusted header expired; can't verify backwards")
        verified = trusted.header
        height = trusted.height - 1
        while height >= new_lb.height:
            interim = (
                new_lb if height == new_lb.height
                else await self._light_block_from_primary(height)
            )
            verifier.verify_backwards(interim.header, verified)
            verified = interim.header
            self._update_trusted(interim)
            height -= 1

    # ------------------------------------------------------------ detector

    async def _detect_divergence(self, trace: list[LightBlock], now) -> None:
        """detector.go:28-107: ask every witness for the target header; any
        conflict is examined for attack evidence. At least one witness must
        agree (or be removed) for the header to stand."""
        if not trace or len(trace) < 2:
            raise LightClientError("nil or single block primary trace")
        if not self.witnesses:
            raise ErrNoWitnesses("no witnesses connected; unable to cross-check")
        last = trace[-1]
        header_matched = False
        to_remove: list[int] = []
        for i, witness in enumerate(self.witnesses):
            try:
                w_block = await self._get_target_block_or_latest(last.height, witness)
            except LightClientError:
                to_remove.append(i)
                continue
            if w_block is None:
                continue  # witness is still catching up — benign
            if w_block.hash() == last.hash():
                header_matched = True
                continue
            attack = await self._handle_conflicting_headers(trace, w_block, i, now)
            if attack:
                raise ErrLightClientAttack(
                    "conflicting headers confirmed: primary or witness is lying"
                )
            to_remove.append(i)
        self._remove_witnesses(to_remove)
        if not header_matched:
            raise ErrFailedHeaderCrossReferencing(
                "all witnesses failed to cross-reference the header"
            )

    async def _get_target_block_or_latest(
        self, height: int, witness: Provider
    ) -> Optional[LightBlock]:
        """detector.go:379-405: None when the witness is behind (benign)."""
        latest = await witness.light_block(0)
        if latest.height == height:
            return latest
        if latest.height > height:
            return await witness.light_block(height)
        return None

    async def _handle_conflicting_headers(
        self, primary_trace: list[LightBlock], challenging: LightBlock,
        witness_index: int, now,
    ) -> bool:
        """detector.go:217-287. Returns True when a real attack was
        confirmed (evidence generated + reported both ways)."""
        witness = self.witnesses[witness_index]
        try:
            witness_trace, primary_block = await self._examine_against_trace(
                primary_trace, challenging, witness, now
            )
        except LightClientError as e:
            self.logger.info("error validating witness %s's divergent header: %s",
                             witness.id_(), e)
            return False
        # witness held as source of truth -> evidence against the primary
        common, trusted_blk = witness_trace[0], witness_trace[-1]
        ev_primary = make_attack_evidence(primary_block, trusted_blk, common)
        self.logger.error(
            "ATTEMPTED ATTACK DETECTED; sending evidence %s against primary %s",
            ev_primary.string(), self.primary.id_())
        await witness.report_evidence(ev_primary)
        # reverse: primary held as source of truth -> evidence against witness
        try:
            p_trace, witness_block = await self._examine_against_trace(
                witness_trace, primary_block, self.primary, now
            )
            common, trusted_blk = p_trace[0], p_trace[-1]
            ev_witness = make_attack_evidence(witness_block, trusted_blk, common)
            await self.primary.report_evidence(ev_witness)
        except LightClientError as e:
            self.logger.info("error validating primary's divergent header: %s", e)
        return True

    async def _examine_against_trace(
        self, trace: list[LightBlock], target: LightBlock, source: Provider, now,
    ) -> tuple[list[LightBlock], LightBlock]:
        """detector.go:290-377: walk the trace, re-verifying each height
        against `source`, until the hashes diverge — that bifurcation point
        yields (source's trace, the divergent block from the trace owner)."""
        if target.height < trace[0].height:
            raise LightClientError(
                f"target block height below trusted height "
                f"({target.height} < {trace[0].height})"
            )
        prev: Optional[LightBlock] = None
        source_trace: list[LightBlock] = []
        for idx, trace_block in enumerate(trace):
            if trace_block.height > target.height:
                # forward lunatic: the block right after target diverges
                if trace_block.time.unix_ns() > target.time.unix_ns():
                    raise LightClientError(
                        "sanity: trace block time above target block time"
                    )
                if prev is not None and prev.height != target.height:
                    source_trace = await self._verify_skipping(source, prev, target, now)
                return source_trace, trace_block
            source_block = (
                target if trace_block.height == target.height
                else await source.light_block(trace_block.height)
            )
            if idx == 0:
                if source_block.hash() != trace_block.hash():
                    raise LightClientError(
                        "trusted block differs from the source's first block"
                    )
                prev = source_block
                continue
            source_trace = await self._verify_skipping(source, prev, source_block, now)
            if source_block.hash() != trace_block.hash():
                return source_trace, trace_block  # bifurcation point
            prev = source_block
        raise LightClientError("no divergence found in trace (contract violation)")

    # ----------------------------------------------------------- plumbing

    def _trusted_checkpoint(
        self, pivot: int, verified: LightBlock, now: cmttime.Timestamp
    ) -> Optional[LightBlock]:
        """An already-trusted block in (verified.height, pivot] from the
        shared checkpoint source, still within its trusting period —
        or None. Never raises: a broken cache degrades to a plain fetch."""
        try:
            cached = self.checkpoint_source(pivot)
        except Exception:  # noqa: BLE001 - cache trouble must not fail verify
            return None
        if (cached is None or cached.height <= verified.height
                or cached.height > pivot):
            return None
        if verifier.header_expired(
                cached.signed_header, self.trusting_period_ns, now):
            return None
        return cached

    async def _light_block_from_primary(self, height: int) -> LightBlock:
        """client.go:990-1017 (without the primary-replacement dance: a
        failing primary surfaces as the provider's error)."""
        lb = await self.primary.light_block(height)
        lb.validate_basic(self.chain_id)
        if height != 0 and lb.height != height:
            raise ErrLightBlockNotFound(
                f"primary returned height {lb.height}, want {height}"
            )
        return lb

    def _update_trusted(self, lb: LightBlock) -> None:
        """client.go:910-931."""
        self.store.save_light_block(lb)
        if self.latest_trusted is None or lb.height > self.latest_trusted.height:
            self.latest_trusted = lb
        self.store.prune(self.pruning_size)

    def _remove_witnesses(self, indexes: list[int]) -> None:
        """client.go:1019-1043."""
        for i in sorted(indexes, reverse=True):
            self.witnesses.pop(i)

    # ------------------------------------------------------------- queries

    def trusted_light_block(self, height: int) -> Optional[LightBlock]:
        return self.store.light_block(height)

    def last_trusted_height(self) -> int:
        lb = self.store.latest_light_block()
        return lb.height if lb else -1

    def first_trusted_height(self) -> int:
        lb = self.store.first_light_block()
        return lb.height if lb else -1


def make_attack_evidence(
    conflicted: LightBlock, trusted: LightBlock, common: LightBlock
) -> LightClientAttackEvidence:
    """detector.go:408-425 newLightClientAttackEvidence: classify the attack
    (lunatic vs equivocation/amnesia) and fill every field a full node needs
    to verify it."""
    ev = LightClientAttackEvidence(conflicting_block=conflicted, common_height=0)
    if ev.conflicting_header_is_invalid(trusted.header):
        ev.common_height = common.height
        ev.timestamp = common.time
        ev.total_voting_power = common.validator_set.total_voting_power()
    else:
        ev.common_height = trusted.height
        ev.timestamp = trusted.time
        ev.total_voting_power = trusted.validator_set.total_voting_power()
    ev.byzantine_validators = ev.get_byzantine_validators(
        common.validator_set, trusted.signed_header
    )
    return ev
