"""Domain types of the port: sign bytes, votes and vote extensions,
commits and extended commits, validator sets, the commit verification that
feeds the batch verifier (validation.py), VoteSet's batch-first tally
(vote_set.py), blocks, part sets, evidence, light blocks, consensus params
and the genesis document. The port's copies of the matching modules of
cometbft_tpu/types/, with proposals and the event bus (event_bus.py).
"""

from cometbft_tpu_torch.types.basic import (  # noqa: F401
    MAX_VOTES_COUNT,
    BlockID,
    BlockIDFlag,
    PartSetHeader,
    SignedMsgType,
)
from cometbft_tpu_torch.types.commit import (  # noqa: F401
    Commit,
    CommitSig,
    ExtendedCommit,
    ExtendedCommitSig,
)
from cometbft_tpu_torch.types.validator import Validator, ValidatorSet  # noqa: F401
from cometbft_tpu_torch.types.vote import Vote  # noqa: F401
from cometbft_tpu_torch.types.proposal import Proposal  # noqa: F401
from cometbft_tpu_torch.types.validation import (  # noqa: F401
    verify_commit,
    verify_commit_light,
    verify_commit_light_trusting,
)
from cometbft_tpu_torch.types.vote_set import VoteSet  # noqa: F401
from cometbft_tpu_torch.types.block import Block, Data, EvidenceData, Header  # noqa: F401
from cometbft_tpu_torch.types.part_set import Part, PartSet  # noqa: F401
