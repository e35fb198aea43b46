"""ABCI 2.0, the application boundary (reference: abci/). The port's copy
of cometbft_tpu/abci/: the request and response types with the Application
base classes (types.py), the JSON codec of their payloads (codec.py), the
in-process and socket clients (client.py), the example kvstore app
(kvstore.py), the reference's protobuf wire (proto_codec.py), the socket
server (server.py), the gRPC transport (grpc.py) and abci-cli (cli.py,
grammar.py).
"""

from cometbft_tpu_torch.abci.types import (  # noqa: F401
    CODE_TYPE_OK,
    Application,
    BaseApplication,
)
