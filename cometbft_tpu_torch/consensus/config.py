"""Consensus timing/behavior knobs (reference: config/config.go:1090-1230).

Defaults mirror the reference (propose 3s + 500ms/round, prevote/precommit
1s + 500ms/round, commit 1s); tests shrink them to drive rounds in
milliseconds — the injectable analog of the reference's mock TimeoutTicker.

The port's copy of cometbft_tpu/consensus/config.py.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class ConsensusConfig:
    timeout_propose: float = 3.0
    timeout_propose_delta: float = 0.5
    timeout_prevote: float = 1.0
    timeout_prevote_delta: float = 0.5
    timeout_precommit: float = 1.0
    timeout_precommit_delta: float = 0.5
    timeout_commit: float = 1.0
    skip_timeout_commit: bool = False
    create_empty_blocks: bool = True
    create_empty_blocks_interval: float = 0.0
    peer_gossip_sleep_duration: float = 0.1
    peer_query_maj23_sleep_duration: float = 2.0
    double_sign_check_height: int = 0
    # batch-first vote verification: stage gossip votes into device batches
    # (VoteSet.add_pending/flush) instead of serial per-vote verification
    batch_vote_verification: bool = False
    # flush a staged batch once it reaches this many votes (flushes also
    # happen at speculative quorum boundaries and on timeouts)
    vote_batch_flush_size: int = 128
    # compact vote-set reconciliation (consensus/reactor.py RECON channel):
    # periodically send peers one VoteSummary frame (both vote bitmaps for
    # the current height/round) so per-vote HasVote announcements lost to
    # drops/full queues/churn are repaired in bulk and peers stop sending
    # votes we already have. Negotiated per peer (a peer that never
    # advertises the channel just gets classic full gossip) and checksum-
    # guarded (a corrupt summary is ignored and counted, never applied).
    gossip_vote_summaries: bool = True
    # summary send cadence per peer; summaries are skipped while the vote
    # view is unchanged, so a short interval costs little on a quiet net
    vote_summary_interval: float = 0.5
    # TEST/E2E ONLY: run this validator adversarially (consensus/byzantine.py
    # behaviors: equivocation | amnesia | silence | flood). The node swaps
    # its privval for an unguarded signer — never set this in production.
    byzantine: str = ""

    def propose_timeout(self, round_: int) -> float:
        return self.timeout_propose + self.timeout_propose_delta * round_

    def prevote_timeout(self, round_: int) -> float:
        return self.timeout_prevote + self.timeout_prevote_delta * round_

    def precommit_timeout(self, round_: int) -> float:
        return self.timeout_precommit + self.timeout_precommit_delta * round_


def test_consensus_config() -> ConsensusConfig:
    """Millisecond-scale timeouts for in-process multi-validator tests
    (reference: config.TestConsensusConfig)."""
    return ConsensusConfig(
        timeout_propose=0.12,
        timeout_propose_delta=0.05,
        timeout_prevote=0.06,
        timeout_prevote_delta=0.03,
        timeout_precommit=0.06,
        timeout_precommit_delta=0.03,
        timeout_commit=0.03,
        skip_timeout_commit=True,
        peer_gossip_sleep_duration=0.005,
        peer_query_maj23_sleep_duration=0.25,
        vote_summary_interval=0.02,
    )
