"""Chain state and block execution (reference: state/). The port's copies
of cometbft_tpu/state/{state,store,execution}.py: State, the committed-chain
snapshot; StateStore; and BlockExecutor, which builds, validates (the
LastCommit through verify_commit, on the card) and applies blocks. The
pruner, rollback and indexers come with the node.
"""

from cometbft_tpu_torch.state.state import State  # noqa: F401
from cometbft_tpu_torch.state.store import StateStore  # noqa: F401
from cometbft_tpu_torch.state.execution import BlockExecutor  # noqa: F401
