"""The node's RPC surfaces (reference: rpc/). The port's copy of
cometbft_tpu/rpc/.
"""

from cometbft_tpu_torch.rpc.server import RPCServer

__all__ = ["RPCServer"]
