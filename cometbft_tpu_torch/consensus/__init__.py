"""Consensus core, the Tendermint state machine (reference: consensus/).
The port's copy of the in-process part of cometbft_tpu/consensus/: one
asyncio task a node serialises every transition, and peer votes reach the
card through VoteSet's batched flush. The reactor, its wire codec and the
peer state (consensus/reactor.py) carry it between nodes; the WAL
(consensus/wal.py) and the handshake replay (consensus/replay.py) carry it
across a restart.
"""

from cometbft_tpu_torch.consensus.config import ConsensusConfig  # noqa: F401
from cometbft_tpu_torch.consensus.round_state import RoundState, RoundStepType  # noqa: F401
from cometbft_tpu_torch.consensus.state import ConsensusState  # noqa: F401
