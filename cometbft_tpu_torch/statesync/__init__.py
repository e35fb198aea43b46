"""State sync (reference: statesync/).

snapshots — peer-offered snapshot pool with ranking + rejection memory
chunks    — ordered chunk queue with retry/refetch semantics
syncer    — the offer/fetch/apply loop against the ABCI app, anchored to
            light-client-verified state
provider  — StateProvider: trusted AppHash/Commit/State via the light client
reactor   — p2p plumbing: snapshot/chunk channels, serving + requesting

The port's copy of cometbft_tpu/statesync/__init__.py.
"""

from cometbft_tpu_torch.statesync.chunks import ChunkQueue
from cometbft_tpu_torch.statesync.provider import LightClientStateProvider, StateProvider
from cometbft_tpu_torch.statesync.reactor import StatesyncReactor
from cometbft_tpu_torch.statesync.snapshots import Snapshot, SnapshotPool
from cometbft_tpu_torch.statesync.syncer import (
    ErrAbort,
    ErrNoSnapshots,
    ErrRejectSnapshot,
    ErrRetrySnapshot,
    Syncer,
)

__all__ = [
    "ChunkQueue", "LightClientStateProvider", "StateProvider",
    "StatesyncReactor", "Snapshot", "SnapshotPool", "Syncer",
    "ErrAbort", "ErrNoSnapshots", "ErrRejectSnapshot", "ErrRetrySnapshot",
]
