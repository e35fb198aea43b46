"""Chain state and block execution (reference: state/). The port's copies
of cometbft_tpu/state/{state,store,execution}.py: State, the committed-chain
snapshot; StateStore; and BlockExecutor, which builds, validates (the
LastCommit through verify_commit, on the card) and applies blocks; the kv
indexers (txindex.py) and the pruner (pruner.py). Rollback and the SQL
indexer come in a later slice.
"""

from cometbft_tpu_torch.state.state import State  # noqa: F401
from cometbft_tpu_torch.state.store import StateStore  # noqa: F401
from cometbft_tpu_torch.state.execution import BlockExecutor  # noqa: F401
