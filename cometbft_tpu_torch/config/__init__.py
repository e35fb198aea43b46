from cometbft_tpu_torch.config.config import (
    BaseConfig,
    BlockSyncConfig,
    Config,
    InstrumentationConfig,
    LightConfig,
    P2PConfig,
    RPCConfig,
    StateSyncConfig,
    StorageConfig,
    TxIndexConfig,
    default_config,
    test_config,
)

__all__ = [
    "BaseConfig",
    "BlockSyncConfig",
    "Config",
    "InstrumentationConfig",
    "LightConfig",
    "P2PConfig",
    "RPCConfig",
    "StateSyncConfig",
    "StorageConfig",
    "TxIndexConfig",
    "default_config",
    "test_config",
]
