"""Node assembly: the dependency-injection root.

Reference: node/node.go:263-524 NewNode + OnStart (node.go:527). Boot
order mirrors the reference call stack (SURVEY §3.1):

  init DBs -> load state (db or genesis) -> start proxy app conns ->
  event switch -> privval -> [handshake replay] -> mempool -> evidence ->
  block executor -> consensus -> reactors -> transport/switch -> dial
  persistent peers -> RPC

`init_files` is the `cometbft init` analog (cmd/cometbft/commands/init.go):
write genesis + node key + privval key under the home dir.

The port's copy of cometbft_tpu/node/node.py, with the RPC server, the gRPC
services (public and privileged), PEX with its address book, and a socket
or gRPC proxy_app wired as the reference wires them. Each plane the port
does not hold yet raises NotImplementedError naming the module it waits for
(check_planes): pprof, the certificate plane, state sync, the byzantine
mode, the fuzzing transport and the SQL indexer; the STATESYNC channels are
not offered.

Its device side: crypto/batch.configure(config.crypto) sets the backend,
"gpu" (the default) or "cpu"; on "gpu" the node fails at construction
without a card, and on_start builds and loads every CUDA kernel of the
verify path (ops/_build: verify25519, decompress25519, challenge25519,
integrity, and bls12381 while BLS is enabled) before the handshake and the
switch start, so no nvcc build lands inside a consensus round. A kernel
that fails to build or launch raises; nothing falls back to the CPU.
"""

from __future__ import annotations

import asyncio
import os

from cometbft_tpu_torch.abci.kvstore import KVStoreApplication
from cometbft_tpu_torch.blocksync import BlocksyncReactor
from cometbft_tpu_torch.config import Config
from cometbft_tpu_torch.consensus import ConsensusState
from cometbft_tpu_torch.consensus import timeline as cmttimeline
from cometbft_tpu_torch.consensus.reactor import ConsensusReactor
from cometbft_tpu_torch.consensus.wal import WAL
from cometbft_tpu_torch.crypto import batch as crypto_batch
from cometbft_tpu_torch.evidence import EvidencePool
from cometbft_tpu_torch.evidence.reactor import EvidenceReactor
from cometbft_tpu_torch.libs import log as cmtlog
from cometbft_tpu_torch.libs import trace as cmttrace
from cometbft_tpu_torch.libs.events import EventSwitch
from cometbft_tpu_torch.libs.service import BaseService
from cometbft_tpu_torch.mempool.mempool import CListMempool
from cometbft_tpu_torch.mempool.reactor import MempoolReactor
from cometbft_tpu_torch.p2p.conn.connection import MConnConfig
from cometbft_tpu_torch.p2p.key import NodeKey
from cometbft_tpu_torch.p2p.node_info import NodeInfo
from cometbft_tpu_torch.p2p.switch import Switch
from cometbft_tpu_torch.p2p.transport import Transport
from cometbft_tpu_torch.privval.file_pv import FilePV
from cometbft_tpu_torch.proxy import (
    AppConns,
    grpc_client_creator,
    local_client_creator,
    socket_client_creator,
)
from cometbft_tpu_torch.state import BlockExecutor, State, StateStore
from cometbft_tpu_torch.state.txindex import (
    BlockIndexer,
    IndexerService,
    NullTxIndexer,
    TxIndexer,
)
from cometbft_tpu_torch.store import BlockStore
from cometbft_tpu_torch.store.db import open_db
from cometbft_tpu_torch.types.event_bus import EventBus
from cometbft_tpu_torch.types.genesis import GenesisDoc, GenesisValidator
from cometbft_tpu_torch.utils import cmttime
from cometbft_tpu_torch.version import CMTSemVer as VERSION


def _strip_tcp(addr: str) -> str:
    return addr.removeprefix("tcp://")


# the kernels of the verify path, by csrc/ stem; bls12381 joins while BLS
# is enabled (crypto.bls_enabled)
KERNEL_SOURCES = ("verify25519", "decompress25519", "challenge25519", "integrity")


def check_planes(config: Config) -> None:
    """Raise NotImplementedError, naming the module it waits for, for every
    plane of `config` that the port does not hold yet. None is skipped or
    served another way."""
    waits = []
    if config.rpc.pprof_laddr:
        waits.append(("rpc.pprof_laddr", config.rpc.pprof_laddr, "node/pprof.py"))
    if config.cert.enabled:
        waits.append(("cert.enabled", True, "cert/plane.py"))
    if config.state_sync.enable:
        waits.append(("statesync.enable", True, "statesync/"))
    if config.consensus.byzantine:
        waits.append(("consensus.byzantine", config.consensus.byzantine,
                      "consensus/byzantine.py"))
    if config.p2p.test_fuzz:
        waits.append(("p2p.test_fuzz", True, "p2p/fuzz.py"))
    if config.tx_index.indexer == "sql":
        waits.append(("tx_index.indexer", "sql", "state/indexer_sql.py"))
    if waits:
        key, val, mod = waits[0]
        more = "".join(f"; {k} = {v!r} waits for {m}" for k, v, m in waits[1:])
        raise NotImplementedError(
            f"{key} = {val!r} waits for the port's {mod}, which is not ported yet{more}. "
            "Set [cert] enabled = false (and leave the other planes at their "
            "defaults) to run the port's node.")


def build_kernels(bls: bool) -> dict[str, float]:
    """Build (unless up to date) and load every kernel of the verify path;
    returns nvcc's seconds by source (0.0 for one already built). Raises
    when a build or a load fails."""
    from cometbft_tpu_torch.ops import _build

    out = {}
    for stem in KERNEL_SOURCES + (("bls12381",) if bls else ()):
        out[stem] = _build.build(stem)[2]
        _build.library(stem)
    return out


def init_files(home: str, chain_id: str = "", moniker: str = "node") -> Config:
    """`init` command (cmd/cometbft/commands/init.go): write config.toml,
    genesis.json (single validator = this node), node key, privval key."""
    cfg = Config(home=home)
    cfg.base.moniker = moniker
    os.makedirs(os.path.join(home, "config"), exist_ok=True)
    os.makedirs(os.path.join(home, "data"), exist_ok=True)
    cfg.save()

    pv = FilePV.load_or_generate(
        cfg.priv_validator_key_path(), cfg.priv_validator_state_path()
    )
    NodeKey.load_or_gen(cfg.node_key_path())

    gpath = cfg.genesis_path()
    if not os.path.exists(gpath):
        gdoc = GenesisDoc(
            genesis_time=cmttime.canonical_now_ms(),
            chain_id=chain_id or f"test-chain-{os.urandom(3).hex()}",
            validators=[
                GenesisValidator(
                    address=pv.get_pub_key().address(),
                    pub_key=pv.get_pub_key(),
                    power=10,
                    name=moniker,
                )
            ],
        )
        gdoc.validate_and_complete()
        with open(gpath, "w") as f:
            f.write(gdoc.to_json())
    return cfg


class Node(BaseService):
    """node/node.go:234 Node: owns every subsystem."""

    def __init__(self, config: Config, logger: cmtlog.Logger | None = None,
                 app=None, genesis_doc: GenesisDoc | None = None):
        # CBFT_LOG_FORMAT overlays base.log_format (the CBFT_TRACE
        # pattern: env wins at boot, config is the durable knob);
        # normalized so CBFT_LOG_FORMAT=JSON means json, and an unknown
        # value fails loudly in set_default_format below
        log_fmt = (os.environ.get("CBFT_LOG_FORMAT", "").strip().lower()
                   or config.base.log_format)
        if logger is None:
            logger = cmtlog.Logger(
                level=cmtlog.parse_level(config.base.log_level),
                fmt=log_fmt,
            )
        super().__init__("Node", logger)
        self.config = config
        config.validate_basic()
        check_planes(config)

        # process-wide default log format: deep library log sites
        # (kernels, scheduler, supervisors) follow the node's choice, and
        # JSON records carry trace/span ids for slow-batch correlation
        cmtlog.set_default_format(log_fmt)
        # flight recorder (libs/trace.py): ARM-only — a node booting with
        # tracing off never disarms a tracer a test/bench armed directly.
        # CBFT_TRACE overlays the config knob (the CBFT_CHAOS pattern).
        inst = config.instrumentation
        env_trace = os.environ.get("CBFT_TRACE")
        tracing = (env_trace.strip().lower() not in ("", "0", "false",
                                                     "off", "no")
                   if env_trace is not None else inst.tracing)
        if tracing:
            cmttrace.configure(
                enabled=True, capacity=inst.trace_buffer_spans,
                slow_ms=inst.trace_slow_ms,
                slow_captures=inst.trace_slow_captures)
        # consensus heightline (consensus/timeline.py): ARM-only, the
        # same overlay pattern — CBFT_TIMELINE wins over the config knob
        env_tl = os.environ.get("CBFT_TIMELINE")
        timeline_on = (env_tl.strip().lower() not in ("", "0", "false",
                                                      "off", "no")
                       if env_tl is not None else inst.timeline)
        if timeline_on:
            cmttimeline.configure(
                enabled=True, heights=inst.timeline_heights,
                slow_ms=inst.height_slow_ms,
                postmortems=inst.postmortem_captures)

        # crypto backend selection + device-fault supervision knobs
        # (BASELINE: --crypto.backend flag; ops/dispatch.py supervisor).
        # On "gpu" a node without a card fails here, not mid-round.
        crypto_batch.configure(config.crypto)
        if config.crypto.backend == "gpu":
            crypto_batch.backend_device()

        # network-fault schedule (p2p/netchaos.py; CBFT_NET_CHAOS overlays)
        if config.p2p.chaos:
            from cometbft_tpu_torch.p2p import netchaos

            netchaos.arm_spec(config.p2p.chaos)

        # disk-fault schedule (libs/diskchaos.py; CBFT_DISK_CHAOS overlays)
        if config.storage.chaos:
            from cometbft_tpu_torch.libs import diskchaos

            diskchaos.arm_spec(config.storage.chaos)

        # ---- genesis + identity (node.go:274-300)
        if genesis_doc is None:
            with open(config.genesis_path()) as f:
                genesis_doc = GenesisDoc.from_json(f.read())
        self.genesis_doc = genesis_doc
        self.node_key = NodeKey.load_or_gen(config.node_key_path())

        # ---- storage (node/setup.go:127 initDBs)
        backend = config.base.db_backend
        sync_mode = config.storage.synchronous
        # CRC-guard exactly the stores a rotted bit can turn into an
        # accepted-but-wrong block: block records and state records
        self.block_store = BlockStore(open_db(
            backend, config.db_path("blockstore"),
            synchronous=sync_mode, checksum=config.storage.checksum))
        self.state_store = StateStore(open_db(
            backend, config.db_path("state"),
            synchronous=sync_mode, checksum=config.storage.checksum))
        state = self.state_store.load()
        if state is None:
            state = State.from_genesis(genesis_doc)
            self.state_store.bootstrap(state)

        # ---- application (node.go:302 createAndStartProxyAppConns)
        if app is not None:
            creator = local_client_creator(app)
        elif config.base.proxy_app == "kvstore":
            app = KVStoreApplication()
            creator = local_client_creator(app)
        elif config.base.proxy_app.startswith("grpc://"):
            creator = grpc_client_creator(config.base.proxy_app)
        elif config.base.proxy_app.startswith(("tcp://", "unix://")):
            creator = socket_client_creator(config.base.proxy_app)
        else:
            raise ValueError(f"unknown proxy_app {config.base.proxy_app!r}")
        self.app = app
        self.proxy_app = AppConns(creator)

        # ---- privval (node.go:324)
        self.priv_validator = FilePV.load_or_generate(
            config.priv_validator_key_path(), config.priv_validator_state_path()
        )

        # ---- mempool + evidence (node.go:369-388)
        self.mempool = CListMempool(config.mempool, None)  # app conn wired on start
        self._evidence_db = open_db(backend, config.db_path("evidence"),
                                    synchronous=sync_mode)
        self.evidence_pool = EvidencePool(self._evidence_db, self.state_store,
                                          block_store=self.block_store)
        self.event_switch = EventSwitch()
        self.event_bus = EventBus()

        # ---- indexers (node.go:311-320 createAndStartIndexerService)
        if config.tx_index.indexer == "kv":
            self._indexer_db = open_db(backend, config.db_path("tx_index"),
                                       synchronous=sync_mode)
            self.tx_indexer = TxIndexer(self._indexer_db)
            self.block_indexer = BlockIndexer(self._indexer_db)
        else:
            self._indexer_db = None
            self.tx_indexer = NullTxIndexer()
            self.block_indexer = None
        self.indexer_service = IndexerService(
            self.tx_indexer, self.block_indexer, self.event_bus,
            logger=self.logger.with_fields(module="txindex"),
        ) if self._indexer_db is not None else None

        # ---- metrics (node.go:300 DefaultMetricsProvider; per-node registry
        # so in-process multi-node tests don't cross-count)
        from cometbft_tpu_torch.libs import metrics as cmtmetrics

        self.metrics_registry = cmtmetrics.Registry()
        # cometbft_build_info: constant-1 gauge whose labels carry the
        # build — fleet scrapes correlate behavior with version/backend
        # (the node_exporter build_info convention)
        from cometbft_tpu_torch import version as _version

        schemes = ["ed25519", "secp256k1", "sr25519"]
        if getattr(config.crypto, "bls_enabled", False):
            schemes.append("bls12381")
        self.metrics_registry.gauge(
            "build", "info", "Build/version information (value is always 1).",
            labels=("version", "abci", "block_protocol", "p2p_protocol",
                    "gpu_crypto_backend", "backend", "schemes"),
        ).labels(
            _version.CMTSemVer, _version.ABCIVersion,
            str(_version.BlockProtocol), str(_version.P2PProtocol),
            str(_version.GPUCryptoBackend), config.crypto.backend,
            ",".join(schemes),
        ).set(1)
        self.consensus_metrics = cmtmetrics.ConsensusMetrics(self.metrics_registry)
        self.mempool_metrics = cmtmetrics.MempoolMetrics(self.metrics_registry)
        self.p2p_metrics = cmtmetrics.P2PMetrics(
            self.metrics_registry, peer_cap=config.p2p.metrics_peer_cap)
        self.evidence_metrics = cmtmetrics.EvidenceMetrics(self.metrics_registry)
        self.mempool.metrics = self.mempool_metrics
        self.evidence_pool.metrics = self.evidence_metrics

        # ---- overload plane (libs/overload.py, no reference analog):
        # one per-node pressure registry every plane grades itself
        # against. Signals registered here read state that already
        # exists; the RPC server adds its own on start.
        from cometbft_tpu_torch.libs.overload import OverloadRegistry

        self.overload = OverloadRegistry()
        self.mempool.attach_overload(self.overload)
        from cometbft_tpu_torch import sched as _sched_mod

        self.overload.register(
            "sched",
            lambda: (sum(_sched_mod.get()._depth.values())
                     / max(1, _sched_mod.get().queue_limit)))
        self.overload.register(
            "events", self.event_bus.server.max_lag_fraction)

        # the commit-certificate plane (cert/) waits for its slice:
        # check_planes refused cert.enabled
        self.cert_plane = None

        # background pruning honoring app/companion retain heights
        # (node.go:263-524 createPruner; state/pruner.go)
        from cometbft_tpu_torch.state.pruner import Pruner

        self.pruner = Pruner(
            self.state_store, self.block_store,
            tx_indexer=self.tx_indexer, block_indexer=self.block_indexer,
            # a configured privileged gRPC listener means a data companion
            # may set retain heights — the pruner must then honor them
            companion_enabled=bool(config.grpc.privileged_laddr),
            logger=self.logger.with_fields(module="pruner"),
        )

        # ---- execution + consensus (node.go:391-425)
        self.block_exec = BlockExecutor(
            self.state_store, None, self.mempool, evidence_pool=self.evidence_pool,
            event_bus=self.event_bus, pruner=self.pruner,
        )
        wal = WAL(os.path.join(config.wal_path(), "wal"))
        self.consensus_state = ConsensusState(
            config=config.consensus,
            state=state,
            block_exec=self.block_exec,
            block_store=self.block_store,
            wal=wal,
            priv_validator=self.priv_validator,
            event_switch=self.event_switch,
            logger=self.logger.with_fields(module="consensus"),
            metrics=self.consensus_metrics,
        )
        # blocksync runs when enabled and we are not the sole validator
        # (node.go onlyValidatorIsUs — nothing to sync from ourselves)
        self.blocksync_active = config.block_sync.enable and not _only_validator_is_us(
            state, self.priv_validator.get_pub_key()
        )
        # heightline recorder identity + slow-height postmortem collector:
        # the recorder exists either way (disabled marks are near-free);
        # the collector only fires on a slow height
        tlr = self.consensus_state.timeline
        tlr.node = self.node_key.id()
        tlr.slow_ms = config.instrumentation.height_slow_ms
        tlr.collector = self._postmortem_context
        self._postmortem_wire_prev: dict = {}
        self.consensus_reactor = ConsensusReactor(
            self.consensus_state,
            wait_sync=self.blocksync_active,
            logger=self.logger.with_fields(module="cons-reactor"),
        )
        self.blocksync_reactor = BlocksyncReactor(
            self.block_exec,
            self.block_store,
            active=self.blocksync_active,
            consensus_reactor=self.consensus_reactor,
            logger=self.logger.with_fields(module="blocksync"),
        )
        # the statesync reactor (serving and syncing snapshots) waits for
        # its slice: the STATESYNC channels are not offered
        self.mempool_reactor = MempoolReactor(
            self.mempool, logger=self.logger.with_fields(module="mempool"))
        self.evidence_reactor = EvidenceReactor(
            self.evidence_pool, logger=self.logger.with_fields(module="evidence"))

        # ---- p2p (node.go:443-482)
        self.node_info = NodeInfo(
            node_id=self.node_key.id(),
            network=genesis_doc.chain_id,
            version=VERSION,
            moniker=config.base.moniker,
            rpc_address=config.rpc.laddr,
        )
        self.transport = Transport(
            self.node_key, self.node_info,
            logger=self.logger.with_fields(module="p2p"),
        )
        from cometbft_tpu_torch.p2p.switch import PeerScorer

        self.switch = Switch(
            self.transport,
            mconn_config=MConnConfig(
                send_rate=config.p2p.send_rate,
                recv_rate=config.p2p.recv_rate,
                max_packet_msg_payload_size=config.p2p.max_packet_msg_payload_size,
                flush_throttle=config.p2p.flush_throttle_timeout,
            ),
            logger=self.logger.with_fields(module="p2p"),
            scorer=PeerScorer(
                ban_threshold=config.p2p.ban_score_threshold,
                ban_base=config.p2p.ban_duration,
                ban_max=config.p2p.ban_max_duration,
                half_life=config.p2p.ban_score_half_life,
            ),
        )
        self.switch.metrics = self.p2p_metrics
        # consensus-detected offenses (forged vote signatures) feed the
        # same ban ledger as transport-level errors
        self.consensus_state.misbehavior_hook = self.switch.report_misbehavior
        self.switch.add_reactor("CONSENSUS", self.consensus_reactor)
        self.switch.add_reactor("BLOCKSYNC", self.blocksync_reactor)
        self.switch.add_reactor("MEMPOOL", self.mempool_reactor)
        self.switch.add_reactor("EVIDENCE", self.evidence_reactor)

        # ---- pex (node.go:498 createPEXReactorAndAddToSwitch)
        self.addr_book = None
        self.pex_reactor = None
        if config.p2p.pex:
            import random as _random

            from cometbft_tpu_torch.p2p.pex import AddrBook, NetAddress, PEXReactor

            self.addr_book = AddrBook(
                os.path.join(config.home, config.p2p.addr_book_file),
                our_id=self.node_key.id(),
            )
            self.addr_book.metrics = self.p2p_metrics
            if self.addr_book.load_error:
                self.logger.error(
                    "address book corrupt; quarantined and booting empty",
                    err=self.addr_book.load_error,
                    quarantined=self.addr_book.quarantined_path,
                )
            for seed in config.p2p.seed_list():
                self.addr_book.add_address(NetAddress.parse(seed))
            # persistent peers are operator intent: pinned in the book,
            # exempt from eviction and the per-group outbound cap
            for pp in config.p2p.persistent_peer_list():
                try:
                    ppa = NetAddress.parse(pp)
                except (ValueError, TypeError):
                    continue
                self.addr_book.add_address(ppa)
                self.addr_book.mark_protected(ppa.node_id)
            self.pex_reactor = PEXReactor(
                self.addr_book,
                max_outbound=config.p2p.max_num_outbound_peers,
                seed_mode=config.p2p.seed_mode,
                ensure_interval=config.p2p.pex_ensure_interval,
                max_group_outbound=config.p2p.max_outbound_per_group,
                rng=_random.Random(self.node_key.id()),
                logger=self.logger.with_fields(module="pex"),
            )
            self.switch.add_reactor("PEX", self.pex_reactor)
            # a switch ban also marks the address book so PEX neither
            # offers nor dials the peer until the ban decays
            self.switch.on_ban = self.addr_book.mark_bad

        # the byzantine mode waits for its slice (check_planes)
        self.rpc_server = None  # attached on start when rpc.laddr set
        self.grpc_server = None
        self.grpc_priv_server = None
        self.kernel_build_s: dict[str, float] = {}

    # ------------------------------------------------- slow-height bundles

    def _postmortem_context(self, height: int) -> dict:
        """Bounded node context captured into a slow-height postmortem
        bundle (consensus/timeline.py Recorder): the matching slow span
        capture from the flight recorder, the gossip-accounting snapshot,
        wire-counter deltas since the previous capture, and scheduler /
        verify-mesh health. Every section degrades to None independently
        — a broken subsystem must not cost the bundle."""
        ctx: dict = {}
        try:
            caps = cmttrace.slow_captures()
            # prefer the capture of THIS height's span tree; else newest
            pick = None
            for c in reversed(caps):
                if (c.get("root") == "consensus.height"
                        and c.get("attrs", {}).get("height") == height):
                    pick = c
                    break
            if pick is None and caps:
                pick = caps[-1]
            if pick is not None:
                ctx["span_capture"] = {
                    "root": pick.get("root"),
                    "dur_ms": pick.get("dur_ms"),
                    "attrs": pick.get("attrs"),
                    "spans": pick.get("spans", [])[:200],
                }
        except Exception:  # noqa: BLE001
            ctx["span_capture"] = None
        try:
            ctx["gossip"] = self.consensus_reactor.gossip_accounting()
        except Exception:  # noqa: BLE001
            ctx["gossip"] = None
        try:
            tele = self.switch.net_telemetry()
            totals = dict(tele.get("totals") or {})
            prev = self._postmortem_wire_prev
            ctx["wire_totals"] = totals
            ctx["wire_deltas"] = {
                k: round(v - prev.get(k, 0), 3) if isinstance(v, float)
                else v - prev.get(k, 0)
                for k, v in totals.items() if isinstance(v, (int, float))}
            self._postmortem_wire_prev = totals
            ctx["channels"] = tele.get("channels")
        except Exception:  # noqa: BLE001
            ctx["wire_totals"] = ctx["wire_deltas"] = None
        try:
            from cometbft_tpu_torch import sched

            ctx["scheduler"] = sched.health_snapshot()
        except Exception:  # noqa: BLE001
            ctx["scheduler"] = None
        try:
            from cometbft_tpu_torch.ops import dispatch

            ctx["crypto_backend"] = dispatch.health_snapshot()
        except Exception:  # noqa: BLE001
            ctx["crypto_backend"] = None
        return ctx

    # ------------------------------------------------------------ lifecycle

    async def on_start(self) -> None:
        """node.go:527 OnStart."""
        if self.indexer_service is not None:
            await self.indexer_service.start()
        await self.pruner.start()

        # every kernel of the verify path built and loaded before the
        # handshake replays a block or the switch carries a vote
        if self.config.crypto.backend == "gpu":
            self.kernel_build_s = await asyncio.get_running_loop().run_in_executor(
                None, build_kernels, self.config.crypto.bls_enabled)
            self.logger.info("kernels built", seconds=str(self.kernel_build_s))

        # bridge the consensus fast-path EventSwitch into the async EventBus
        # so RPC subscribers see round transitions (state.go:129-131 dual
        # event plane)
        from cometbft_tpu_torch.types import event_bus as eb

        def _rs_bridge(rs) -> None:
            self.event_bus.server.publish(
                eb.EventDataRoundState(rs.height, rs.round_, str(rs.step)),
                {eb.EVENT_TYPE_KEY: [eb.EVENT_NEW_ROUND_STEP]},
            )

        self.event_switch.add_listener("node-bus", "NewRoundStep", _rs_bridge)

        await self.proxy_app.start()
        # wire the live app conns (created only at proxy start)
        self.mempool.app_conn = self.proxy_app.mempool
        self.block_exec.app_conn = self.proxy_app.consensus

        # ABCI handshake: replay blocks the app missed (replay.go:241)
        from cometbft_tpu_torch.consensus.replay import Handshaker

        hs = Handshaker(
            self.state_store, self.block_store, self.genesis_doc,
            logger=self.logger.with_fields(module="handshake"),
        )
        state = await hs.handshake(self.proxy_app)
        self.consensus_state.sync_to_state(state)
        self.blocksync_reactor.set_state(self.consensus_state.state)

        # run the verify scheduler's bucket ladder once so the first real
        # consensus flush grows no table mid-round (no-op on "cpu")
        if self.config.crypto.sched_warmup:
            from cometbft_tpu_torch import sched as _sched

            cap = self.config.crypto.sched_warmup_max_lanes
            traced = await asyncio.get_running_loop().run_in_executor(
                None, lambda: _sched.get().warmup(cap))
            if traced:
                self.logger.info("verify scheduler warmup", shapes=str(traced))

        addr = await self.transport.listen(_strip_tcp(self.config.p2p.laddr))
        self.node_info.listen_addr = addr
        await self.switch.start()
        peers = self.config.p2p.persistent_peer_list()
        if peers:
            await self.switch.dial_peers_async(peers, persistent=True)

        if self.config.rpc.laddr:
            from cometbft_tpu_torch.rpc.server import RPCServer

            self.rpc_server = RPCServer(self, self.config.rpc)
            await self.rpc_server.start()

        # gRPC service surface (node.go:527 + rpc/grpc/server; grpc is
        # imported only when one is configured)
        if self.config.grpc.laddr:
            from cometbft_tpu_torch.rpc import grpc_services as gs

            self.grpc_server, self.grpc_bound = gs.serve(
                [gs.VersionService(), gs.BlockService(self.block_store),
                 gs.BlockResultsService(self.state_store, self.block_store)],
                self.config.grpc.laddr)
            self.logger.info("gRPC services listening", addr=self.grpc_bound)
        if self.config.grpc.privileged_laddr:
            from cometbft_tpu_torch.rpc import grpc_services as gs

            self.grpc_priv_server, self.grpc_priv_bound = gs.serve(
                [gs.PruningService(self.pruner)],
                self.config.grpc.privileged_laddr)
            self.logger.info("privileged gRPC listening",
                             addr=self.grpc_priv_bound)

    async def on_stop(self) -> None:
        if self.rpc_server is not None:
            await self.rpc_server.stop()
        for srv in (self.grpc_server, self.grpc_priv_server):
            if srv is not None:
                from cometbft_tpu_torch.rpc.grpc_services import wait_closed

                await wait_closed(srv, grace=0.5)
        await self.switch.stop()
        await self.proxy_app.stop()
        if self.pruner.is_running:
            await self.pruner.stop()
        if self.indexer_service is not None and self.indexer_service.is_running:
            await self.indexer_service.stop()
        for db in (self.block_store.db, self.state_store.db, self._evidence_db,
                   self._indexer_db):
            try:
                db.close()
            except Exception:  # noqa: BLE001
                pass


def _only_validator_is_us(state, pub_key) -> bool:
    """node.go onlyValidatorIsUs."""
    if state.validators is None or len(state.validators) != 1:
        return False
    return state.validators.validators[0].address == pub_key.address()
