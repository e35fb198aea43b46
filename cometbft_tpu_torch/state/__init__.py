"""Chain state (reference: state/). The port's copy of
cometbft_tpu/state/state.py: State, the committed-chain snapshot that
evidence verification reads. The state store, block execution, pruner,
rollback and indexers of the reference come with the node.
"""

from cometbft_tpu_torch.state.state import State  # noqa: F401
