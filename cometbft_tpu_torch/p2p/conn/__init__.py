from cometbft_tpu_torch.p2p.conn.connection import (  # noqa: F401
    ChannelDescriptor,
    MConnConfig,
    MConnection,
)
from cometbft_tpu_torch.p2p.conn.secret_connection import SecretConnection  # noqa: F401
