"""Persistence (reference: store/). The port's copies of
cometbft_tpu/store/db.py (MemDB, SQLiteDB, CRCStore, open_db) and of
store/blockstore.py.
"""

from cometbft_tpu_torch.store.db import (  # noqa: F401
    CRCStore,
    ErrCorruptValue,
    KVStore,
    MemDB,
    SQLiteDB,
    open_db,
)
from cometbft_tpu_torch.store.blockstore import BlockStore  # noqa: F401
