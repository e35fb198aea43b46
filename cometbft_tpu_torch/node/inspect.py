"""Inspect mode (reference: inspect/inspect.go).

Serves the data-backed subset of the RPC over a STOPPED node's stores:
status, block/blockchain/commit/validators, tx + block search. No
consensus, no p2p, no app — a crashed or halted node's disk can be
examined (and a light client can even use it as a primary) without
running the node.

The port's copy of cometbft_tpu/node/inspect.py, served through the port's
rpc/server. It opens the stores and nothing else: no card, no kernel.
"""

from __future__ import annotations

import asyncio
import os
import signal

from cometbft_tpu_torch.config import Config
from cometbft_tpu_torch.libs import log as cmtlog
from cometbft_tpu_torch.p2p.key import NodeKey
from cometbft_tpu_torch.p2p.node_info import NodeInfo
from cometbft_tpu_torch.rpc.server import RPCServer
from cometbft_tpu_torch.state.store import StateStore
from cometbft_tpu_torch.state.txindex import BlockIndexer, NullTxIndexer, TxIndexer
from cometbft_tpu_torch.store import BlockStore
from cometbft_tpu_torch.store.db import open_db
from cometbft_tpu_torch.types.event_bus import EventBus
from cometbft_tpu_torch.version import CMTSemVer as VERSION


class InspectNode:
    """The read-only stand-in for Node that the RPC Environment needs
    (inspect/rpc/rpc.go Routes — the data-backed subset)."""

    def __init__(self, config: Config, logger: cmtlog.Logger):
        self.config = config
        self.logger = logger
        backend = config.base.db_backend
        # honor the node's CRC-guard knob: the data was WRITTEN through
        # the wrapper, so reading it raw would misparse every record
        self.block_store = BlockStore(open_db(
            backend, config.db_path("blockstore"),
            checksum=config.storage.checksum))
        self.state_store = StateStore(open_db(
            backend, config.db_path("state"),
            checksum=config.storage.checksum))
        self.node_key = NodeKey.load_or_gen(config.node_key_path())
        with open(config.genesis_path()) as f:
            from cometbft_tpu_torch.types.genesis import GenesisDoc

            self.genesis_doc = GenesisDoc.from_json(f.read())
        self.node_info = NodeInfo(
            node_id=self.node_key.id(),
            network=self.genesis_doc.chain_id,
            version=VERSION,
            moniker=config.base.moniker + " (inspect)",
            rpc_address=config.rpc.laddr,
        )
        if config.tx_index.indexer == "kv":
            db = open_db(backend, config.db_path("tx_index"))
            self.tx_indexer = TxIndexer(db)
            self.block_indexer = BlockIndexer(db)
        else:
            self.tx_indexer = NullTxIndexer()
            self.block_indexer = None
        self.event_bus = EventBus()
        self.metrics_registry = None
        # RPC routes that need these return empty/error in inspect mode
        self.priv_validator = None
        self.mempool = _NoMempool()
        self.consensus_state = None
        self.consensus_reactor = _NoReactor()
        self.evidence_pool = _NoEvidence()
        self.switch = _NoSwitch()
        self.proxy_app = None

    @property
    def state(self):
        return self.state_store.load()


class _NoMempool:
    def size(self) -> int:
        return 0

    def size_bytes(self) -> int:
        return 0

    def reap_max_txs(self, n: int) -> list:
        return []


class _NoEvidence:
    def add_evidence(self, ev):
        raise RuntimeError("inspect mode: evidence intake disabled")

    def pending_evidence(self, max_bytes: int):
        return [], 0


class _NoReactor:
    wait_sync = False


class _NoSwitch:
    peers: dict = {}

    def n_peers(self) -> int:
        return 0


async def run_inspect(config: Config) -> None:
    """Serve until SIGINT/SIGTERM (inspect.go Run)."""
    # CBFT_LOG_FORMAT overlays base.log_format, same as Node.__init__ —
    # otherwise the main logger and default()-built library loggers
    # would disagree on format under the env override
    log_fmt = (os.environ.get("CBFT_LOG_FORMAT", "").strip().lower()
               or config.base.log_format)
    cmtlog.set_default_format(log_fmt)
    logger = cmtlog.Logger(level=cmtlog.parse_level(config.base.log_level),
                           fmt=log_fmt)
    node = InspectNode(config, logger)
    server = RPCServer(node, config.rpc, logger=logger.with_fields(module="rpc"))
    await server.start()
    logger.info("inspect RPC serving", addr=server.bound_addr,
                height=node.block_store.height())
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, stop.set)
    await stop.wait()
    await server.stop()
