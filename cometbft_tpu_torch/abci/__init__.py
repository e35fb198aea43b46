"""ABCI 2.0, the application boundary (reference: abci/). The port's copy
of cometbft_tpu/abci/: the request and response types with the Application
base classes (types.py), the JSON codec of their payloads (codec.py), the
in-process client (client.py) and the example kvstore app (kvstore.py).
The socket and gRPC transports come in a later slice.
"""

from cometbft_tpu_torch.abci.types import (  # noqa: F401
    CODE_TYPE_OK,
    Application,
    BaseApplication,
)
