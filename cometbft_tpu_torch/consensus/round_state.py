"""RoundState — the consensus-internal state snapshot.

Reference: consensus/types/round_state.go. Everything the gossip reactor
reads (via events / shared snapshot) and the step functions mutate.

The port's copy of cometbft_tpu/consensus/round_state.py.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field

from cometbft_tpu_torch.types.block import Block
from cometbft_tpu_torch.types.part_set import PartSet
from cometbft_tpu_torch.types.proposal import Proposal
from cometbft_tpu_torch.types.validator import ValidatorSet
from cometbft_tpu_torch.utils import cmttime


class RoundStepType(enum.IntEnum):
    """consensus/types/round_state.go:12-40."""

    NEW_HEIGHT = 1
    NEW_ROUND = 2
    PROPOSE = 3
    PREVOTE = 4
    PREVOTE_WAIT = 5
    PRECOMMIT = 6
    PRECOMMIT_WAIT = 7
    COMMIT = 8


@dataclass
class RoundState:
    height: int = 0
    round_: int = 0
    step: RoundStepType = RoundStepType.NEW_HEIGHT
    start_time: cmttime.Timestamp = field(default_factory=cmttime.Timestamp.zero)
    commit_time: cmttime.Timestamp = field(default_factory=cmttime.Timestamp.zero)
    validators: ValidatorSet | None = None
    proposal: Proposal | None = None
    proposal_block: Block | None = None
    proposal_block_parts: PartSet | None = None
    locked_round: int = -1
    locked_block: Block | None = None
    locked_block_parts: PartSet | None = None
    valid_round: int = -1
    valid_block: Block | None = None
    valid_block_parts: PartSet | None = None
    votes: "object" = None  # HeightVoteSet
    commit_round: int = -1
    last_commit: "object" = None  # VoteSet of precommits for height-1
    last_validators: ValidatorSet | None = None
    triggered_timeout_precommit: bool = False

    def height_round_step(self) -> str:
        return f"{self.height}/{self.round_}/{self.step.name}"
