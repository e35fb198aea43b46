"""Proxy: the four logical ABCI connections over one client creator
(reference: proxy/). The port's copy of cometbft_tpu/proxy/.
"""

from cometbft_tpu_torch.proxy.app_conns import (  # noqa: F401
    AppConns,
    ClientCreator,
    grpc_client_creator,
    local_client_creator,
    socket_client_creator,
)
