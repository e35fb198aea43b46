"""Key-value stores (reference: store/). The port's copy of the in-memory
part of cometbft_tpu/store/db.py, under the light client's store; the
SQLite and CRC-guarded stores and the block store come with the node.
"""

from cometbft_tpu_torch.store.db import KVStore, MemDB  # noqa: F401
