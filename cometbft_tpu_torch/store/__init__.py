"""Persistence (reference: store/). The port's copies of the in-memory
part of cometbft_tpu/store/db.py and of store/blockstore.py; the SQLite and
CRC-guarded stores come with the node.
"""

from cometbft_tpu_torch.store.db import KVStore, MemDB  # noqa: F401
from cometbft_tpu_torch.store.blockstore import BlockStore  # noqa: F401
