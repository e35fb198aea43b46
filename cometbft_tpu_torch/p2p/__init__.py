"""The p2p layer (reference: p2p/): node keys and NodeInfo, the secret
connection and MConnection, the Transport that upgrades a TCP stream into
an authenticated peer, and the Switch that routes each channel's messages
to its reactor. The port's copy of cometbft_tpu/p2p/ without the PEX and
the fuzzing transport, which come in later slices.
"""

from cometbft_tpu_torch.p2p.base_reactor import Envelope, Reactor  # noqa: F401
from cometbft_tpu_torch.p2p.key import NodeKey  # noqa: F401
from cometbft_tpu_torch.p2p.node_info import NodeInfo  # noqa: F401
from cometbft_tpu_torch.p2p.peer import Peer  # noqa: F401
from cometbft_tpu_torch.p2p.switch import Switch  # noqa: F401
from cometbft_tpu_torch.p2p.transport import Transport  # noqa: F401
