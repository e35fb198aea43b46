"""Block sync (reference: blocksync/): a node that is behind requests
blocks from its peers, verifies each window's commits through the staged
batch path as SYNC-class work, applies them and hands over to consensus.
"""

from cometbft_tpu_torch.blocksync.pool import BlockPool  # noqa: F401
from cometbft_tpu_torch.blocksync.reactor import BlocksyncReactor  # noqa: F401
