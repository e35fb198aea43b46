"""Mempool (reference: mempool/). The port's copy of
cometbft_tpu/mempool/mempool.py: the CheckTx-gated pool with its dedup
cache, reaping for proposals, post-commit update and recheck, and the
ed25519 admission whose signature rows ride the scheduler as MEMPOOL work.
The gossip reactor is mempool/reactor.py.
"""

from cometbft_tpu_torch.mempool.mempool import CListMempool, TxCache  # noqa: F401
