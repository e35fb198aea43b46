"""Proxy: the four logical ABCI connections over one client creator
(reference: proxy/). The port's copy of cometbft_tpu/proxy/app_conns.py
with the local creator; the socket and gRPC creators come in a later
slice.
"""

from cometbft_tpu_torch.proxy.app_conns import (  # noqa: F401
    AppConns,
    ClientCreator,
    local_client_creator,
)
