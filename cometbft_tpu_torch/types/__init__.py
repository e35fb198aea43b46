"""Domain types of the port: sign bytes, commits, validator sets, and the
commit verification that feeds the batch verifier (validation.py). The
port's copies of the matching modules of cometbft_tpu/types/.
"""

from cometbft_tpu_torch.types.basic import (  # noqa: F401
    MAX_VOTES_COUNT,
    BlockID,
    BlockIDFlag,
    PartSetHeader,
    SignedMsgType,
)
from cometbft_tpu_torch.types.commit import Commit, CommitSig  # noqa: F401
from cometbft_tpu_torch.types.validator import Validator, ValidatorSet  # noqa: F401
from cometbft_tpu_torch.types.vote import Vote  # noqa: F401
from cometbft_tpu_torch.types.validation import (  # noqa: F401
    verify_commit,
    verify_commit_light,
    verify_commit_light_trusting,
)
