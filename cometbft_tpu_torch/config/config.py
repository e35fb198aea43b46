"""Unified node configuration tree.

Reference: config/config.go:76-1445 — one Config struct with 12 sections,
per-section ValidateBasic, serialized to config.toml (config/toml.go) and
loaded with flag/env layering. Here: dataclass sections, tomllib loading,
a hand-rolled TOML writer (stdlib has no writer), and `crypto.backend`
as the framework's addition (SURVEY §5.6).

Layout under the node home (config.go:208-236):
  config/config.toml            this file
  config/genesis.json           genesis doc
  config/node_key.json          p2p identity
  config/priv_validator_key.json
  data/priv_validator_state.json
  data/blockstore.db, data/state.db, data/evidence.db
  data/cs.wal/                  consensus WAL

The port's copy of cometbft_tpu/config/config.py: every section, field,
default and TOML key is the reference's but `crypto.backend`, which takes
the port's backends, "gpu" (the default) or "cpu". The reference's "auto"
and "tpu" fail validate_basic; nothing maps them quietly. A file either
package saved loads in the other, and saves back to the same text but that
one line.
"""

from __future__ import annotations

import os

try:
    import tomllib  # 3.11+
except ImportError:  # 3.10: the API-identical backport
    import tomli as tomllib
from dataclasses import dataclass, field, fields

from cometbft_tpu_torch.consensus.config import ConsensusConfig
from cometbft_tpu_torch.mempool.mempool import MempoolConfig


@dataclass
class BaseConfig:
    """config.go:76-206."""

    moniker: str = "anonymous"
    proxy_app: str = "kvstore"  # "kvstore", "noop", or "tcp://host:port"
    abci: str = "local"  # "local" | "socket"
    db_backend: str = "sqlite"  # "sqlite" | "memdb"
    db_dir: str = "data"
    log_level: str = "info"
    log_format: str = "logfmt"  # "logfmt" | "json"
    genesis_file: str = "config/genesis.json"
    priv_validator_key_file: str = "config/priv_validator_key.json"
    priv_validator_state_file: str = "data/priv_validator_state.json"
    priv_validator_laddr: str = ""  # remote signer listen addr
    node_key_file: str = "config/node_key.json"
    filter_peers: bool = False

    def validate_basic(self) -> None:
        if self.abci not in ("local", "socket"):
            raise ValueError(f"unknown abci transport {self.abci!r}")
        if self.db_backend not in ("sqlite", "memdb"):
            raise ValueError(f"unknown db_backend {self.db_backend!r}")
        if self.log_format not in ("logfmt", "json"):
            raise ValueError(f"unknown log_format {self.log_format!r} "
                             "(expected \"logfmt\" or \"json\")")


@dataclass
class CryptoConfig:
    """The framework's addition (SURVEY §5.6, BASELINE.json): which
    backend verifies signature batches, and the knobs of the layers under
    it.

    `backend = "gpu"` runs every batch through the CUDA kernels on the card
    and raises when there is none or a kernel fails to build or launch;
    `backend = "cpu"` runs the plain PyTorch versions and is chosen only
    explicitly. There is no "auto" and no fall back to the CPU. The
    supervision knobs (retry_*, breaker_*, watchdog_timeout) set the
    device supervisors of ops/dispatch.py; the sched_* knobs the verify
    scheduler; mesh_* the fault-domain mesh; wire_* the key tables'
    indexed path and the device challenge (K5)."""

    backend: str = "gpu"  # "gpu" | "cpu"
    # coalesce at most this many signatures into one device batch
    max_batch_size: int = 16384
    # --- global verify scheduler (sched/scheduler.py) ---
    # route ALL batch verification through the node-wide scheduler
    # (continuous batching: consensus flushes drain immediately and
    # coalesce queued sync/mempool work as filler). Off = the pre-
    # scheduler fragmented dispatch (each producer its own batch).
    scheduler: bool = True
    # cap on rows coalesced into one scheduler batch (groups never split)
    sched_max_lanes: int = 16384
    # flush deadlines per class: consensus is always 0 (inline drain);
    # sync/light/mempool work waits at most this long for a ride before
    # the deadline worker flushes it (light = the serving plane's fleet
    # bisections, sched/scheduler.py LIGHT)
    sched_sync_deadline: float = 0.002
    sched_light_deadline: float = 0.004
    sched_mempool_deadline: float = 0.010
    # mempool-class admission rejected past this many queued rows (also
    # rejected while consensus/sync backlog alone exceeds it)
    sched_queue_limit: int = 16384
    # any queued group older than this rides the next batch regardless
    # of class priority (starvation guard)
    sched_starvation_limit: float = 0.25
    # run one batch at every rung of the bucket ladder at node boot (gpu
    # backend only), up to sched_warmup_max_lanes, so the first real
    # flushes grow no table mid-round; the kernels themselves are built
    # at boot either way
    sched_warmup: bool = False
    sched_warmup_max_lanes: int = 2048
    # --- multi-chip verify mesh (parallel/mesh.py) ---
    # shard scheduler batches across all visible cards, each card its
    # own fault domain (dedicated supervisor/breaker): a dead card
    # shrinks the mesh; a healed card is readmitted by the half-open
    # re-probe
    mesh_enabled: bool = True
    # below this many devices the mesh stays inactive and the classic
    # single-chip dispatch path serves (2 = mesh only when there is a
    # second fault domain to shrink onto)
    mesh_min_devices: int = 2
    # placement policy: "class_aware" pins consensus batches to the
    # least-loaded chip (latency) and spreads sync/mempool (throughput);
    # "spread"/"pinned" force one behavior for every class
    mesh_placement: str = "class_aware"
    # --- reduced-send wire protocol (ops/residency.py) ---
    # keep the active validator set's decompressed coordinates resident
    # on device keyed by set hash: steady-state flushes send 2-byte
    # validator indices instead of key/coordinate material, and set
    # churn ships only the evict/insert delta. Off = every batch rides
    # the full-key digest-cache path (the pre-reduced-send protocol)
    wire_indexed_sends: bool = True
    # per-scheme device validator-table capacity in rows (320 B/row of
    # device memory; one row is reserved for the padding identity).
    # Must fit a uint16 index: [64, 65536]
    wire_table_rows: int = 16384
    # derive the ed25519 challenge k = SHA-512(R||A||M) mod L ON DEVICE
    # (ops/challenge.py): the wire carries only R/s plus per-lane
    # (prefix-id, suffix) descriptors against a resident prefix table
    # (~66-82 B/sig vs 98), with per-lane and whole-batch host-k
    # fallbacks that never change a verdict. Off = every batch ships
    # host-computed k words (the pre-device-challenge protocol)
    wire_device_challenge: bool = True
    # --- BLS12-381 aggregate-signature scheme (crypto/bls12381.py) ---
    # the third verify-plane scheme: 48 B G1 pubkeys, 96 B G2 sigs,
    # aggregate commit verify (one pairing-product check per commit) and
    # batched single-verify through the scheduler. Off = a BLS key
    # reaching the batch seam raises a LOUD ErrInvalidKey naming this
    # knob (never a silent CPU fallback — the light-proxy https rule)
    bls_enabled: bool = True
    # --- device-fault supervision (ops/dispatch.py DeviceSupervisor) ---
    # transient failures: retries per dispatch, with backoff doubling from
    # retry_backoff_base up to retry_backoff_cap (plus jitter)
    retry_max_attempts: int = 2
    retry_backoff_base: float = 0.05
    retry_backoff_cap: float = 1.0
    # consecutive failed operations before the breaker opens (a permanent
    # device failure opens it immediately)
    breaker_failure_threshold: int = 3
    # seconds the breaker stays open before a half-open re-probe
    breaker_cooldown: float = 30.0
    # wall-clock cap on any single device dispatch wait or device->host
    # fetch; a hung device fails the batch instead of stalling a
    # consensus round. Generous by default: it must cover a cold first
    # kernel build, not just steady-state batches
    watchdog_timeout: float = 120.0
    # deterministic device-fault injection schedule (libs/chaos.py syntax,
    # e.g. "ed25519.dispatch=transient:3,mixed.resolve=permanent");
    # test/e2e only — the CBFT_CHAOS env var overlays this
    chaos: str = ""

    def validate_basic(self) -> None:
        if self.backend not in ("gpu", "cpu"):
            raise ValueError(
                f"unknown crypto backend {self.backend!r}: the port's backends are "
                "\"gpu\" (CUDA kernels on the card) and \"cpu\" (their plain PyTorch "
                "versions)")
        if self.retry_max_attempts < 0:
            raise ValueError("retry_max_attempts cannot be negative")
        if self.retry_backoff_base < 0 or self.retry_backoff_cap < 0:
            raise ValueError("retry backoff values cannot be negative")
        if self.breaker_failure_threshold < 1:
            raise ValueError("breaker_failure_threshold must be >= 1")
        if self.breaker_cooldown < 0:
            raise ValueError("breaker_cooldown cannot be negative")
        if self.watchdog_timeout <= 0:
            raise ValueError("watchdog_timeout must be positive")
        if self.sched_max_lanes < 8:
            raise ValueError("sched_max_lanes must be >= 8")
        if (self.sched_sync_deadline < 0 or self.sched_light_deadline < 0
                or self.sched_mempool_deadline < 0):
            raise ValueError("scheduler deadlines cannot be negative")
        if self.sched_queue_limit < 1:
            raise ValueError("sched_queue_limit must be >= 1")
        if self.sched_starvation_limit < 0:
            raise ValueError("sched_starvation_limit cannot be negative")
        if self.sched_warmup_max_lanes < 8:
            raise ValueError("sched_warmup_max_lanes must be >= 8")
        if self.mesh_min_devices < 1:
            raise ValueError("mesh_min_devices must be >= 1")
        if self.mesh_placement not in ("class_aware", "spread", "pinned"):
            raise ValueError(
                f"unknown mesh_placement {self.mesh_placement!r} "
                "(expected \"class_aware\", \"spread\", or \"pinned\")")
        if not 64 <= self.wire_table_rows <= 65536:
            raise ValueError(
                "wire_table_rows must be in [64, 65536] (uint16 indices; "
                "one row reserved for the padding identity)")
        if self.chaos:
            from cometbft_tpu_torch.libs import chaos as _chaos

            _chaos.parse_spec(self.chaos)  # raises ValueError on any part


@dataclass
class LightConfig:
    """The light-client serving plane (light/fleet.py — no reference
    analog): a witness-side verification service that coalesces many
    concurrent skipping-verification requests into shared verification
    futures, caches verified headers in a trust-period-bounded skip list,
    and streams verified headers to subscribed clients over the
    `light_subscribe` WS route. All knobs are fleet_* because the plain
    single-flight light client (light/client.py) needs none of them."""

    # serve the light_verify / light_subscribe routes (opt-in: the fleet
    # holds a verified-header cache and a head watcher task)
    fleet_enabled: bool = False
    # checkpoint skip-list cache capacity in headers (~2-5 KB/header for
    # small valsets; eviction drops the lowest non-anchor heights first)
    fleet_cache_capacity: int = 4096
    # skip-list fanout: heights divisible by fleet_skip_base^k live on
    # lane k, so nearest-checkpoint lookups walk O(log_base height) lanes
    fleet_skip_base: int = 16
    # seconds a cached checkpoint is served before it must be re-verified
    # (the light-client trusting period applied to the CACHE: an expired
    # entry is a miss, never a stale answer)
    fleet_trust_period: float = 168 * 3600.0
    # comma-separated witness RPC endpoints for divergence cross-checks;
    # empty = the fleet's own primary doubles as witness (a node serving
    # its own chain)
    fleet_witnesses: str = ""
    # concurrent UNIQUE verification requests before new ones are shed
    # with FleetSaturated (coalesced duplicates never count)
    fleet_max_inflight: int = 1024
    # streaming-subscriber bounds: per-client queued-header high water
    # (a subscriber this far behind is dropped — backpressure), total
    # headers a client may be sent before its subscription closes
    # (0 = unlimited), and the subscriber cap
    fleet_subscriber_queue: int = 64
    fleet_send_budget: int = 0
    fleet_max_subscribers: int = 10000
    # head-watcher poll cadence when no event bus feeds the fleet
    fleet_poll_interval: float = 0.25

    def validate_basic(self) -> None:
        if self.fleet_cache_capacity < 2:
            raise ValueError("fleet_cache_capacity must be >= 2 "
                             "(trust root + at least one checkpoint)")
        if self.fleet_skip_base < 2:
            raise ValueError("fleet_skip_base must be >= 2")
        if self.fleet_trust_period <= 0:
            raise ValueError("fleet_trust_period must be positive")
        if self.fleet_max_inflight < 1:
            raise ValueError("fleet_max_inflight must be >= 1")
        if self.fleet_subscriber_queue < 1:
            raise ValueError("fleet_subscriber_queue must be >= 1")
        if self.fleet_send_budget < 0:
            raise ValueError("fleet_send_budget cannot be negative")
        if self.fleet_max_subscribers < 1:
            raise ValueError("fleet_max_subscribers must be >= 1")
        if self.fleet_poll_interval <= 0:
            raise ValueError("fleet_poll_interval must be positive")


@dataclass
class RPCConfig:
    """config.go:392-576."""

    laddr: str = "tcp://127.0.0.1:26657"
    cors_allowed_origins: list[str] = field(default_factory=list)
    max_open_connections: int = 900
    max_subscription_clients: int = 100
    max_subscriptions_per_client: int = 5
    timeout_broadcast_tx_commit: float = 10.0
    max_body_bytes: int = 1_000_000
    max_header_bytes: int = 1 << 20
    pprof_laddr: str = ""
    # expose the operator control routes (dial_seeds/dial_peers/
    # unsafe_flush_mempool/unsafe_disconnect_peers; config.go Unsafe)
    unsafe: bool = False
    # overload guard (libs/overload.py, no reference analog): bounded
    # per-route-class in-flight budgets — excess requests wait out the
    # queue deadline then shed with -32005 + a retry-after hint. 0
    # disables a class's budget. Control routes are always exempt.
    overload_read_inflight: int = 256
    overload_write_inflight: int = 64
    overload_queue_timeout: float = 0.05
    # a client that stops draining its socket gets this long before the
    # server abandons the response and closes the connection
    slow_client_timeout: float = 10.0

    def validate_basic(self) -> None:
        if self.max_open_connections < 0:
            raise ValueError("max_open_connections cannot be negative")
        if self.timeout_broadcast_tx_commit <= 0:
            raise ValueError("timeout_broadcast_tx_commit must be positive")
        if self.overload_read_inflight < 0 or self.overload_write_inflight < 0:
            raise ValueError("overload in-flight budgets cannot be negative")
        if self.overload_queue_timeout < 0:
            raise ValueError("overload_queue_timeout cannot be negative")
        if self.slow_client_timeout <= 0:
            raise ValueError("slow_client_timeout must be positive")


@dataclass
class P2PConfig:
    """config.go:592-810."""

    laddr: str = "tcp://0.0.0.0:26656"
    external_address: str = ""
    seeds: str = ""  # comma-separated id@host:port
    persistent_peers: str = ""
    max_num_inbound_peers: int = 40
    max_num_outbound_peers: int = 10
    flush_throttle_timeout: float = 0.1
    max_packet_msg_payload_size: int = 1024
    send_rate: int = 5_120_000
    recv_rate: int = 5_120_000
    pex: bool = True
    seed_mode: bool = False
    addr_book_file: str = "config/addrbook.json"
    addr_book_strict: bool = True
    handshake_timeout: float = 20.0
    dial_timeout: float = 3.0
    # fault injection for soak testing (config.go:739-740 TestFuzz +
    # FuzzConnConfig; knobs flattened instead of a subtable). Mode "drop"
    # mirrors the reference FuzzModeDrop (drops + conn kills + delays);
    # "delay" is latency-only (FuzzModeDelay)
    test_fuzz: bool = False
    test_fuzz_mode: str = "drop"  # "drop" | "delay"
    test_fuzz_prob_drop_rw: float = 0.01
    test_fuzz_prob_drop_conn: float = 0.003
    test_fuzz_prob_sleep: float = 0.01
    test_fuzz_max_delay: float = 0.05
    # deterministic-ish network-fault schedule armed at boot
    # (p2p/netchaos.py syntax: latency/jitter/drop/dup/reorder/bandwidth/
    # partition); test/e2e only — CBFT_NET_CHAOS overlays this
    chaos: str = ""
    # wire-plane metrics cardinality cap (libs/metrics.P2PMetrics): how
    # many distinct peers get their own label on the per-peer Prometheus
    # series before later peers fold into peer="other" — bounds the
    # exposition on a large-fleet node
    metrics_peer_cap: int = 32
    # misbehavior scoring / ban ledger (p2p/switch.py PeerScorer):
    # misbehavior score that triggers a ban, the first-offense ban window,
    # its cap as repeat offenses double it, and the score decay half-life
    ban_score_threshold: float = 3.0
    ban_duration: float = 60.0
    ban_max_duration: float = 3600.0
    ban_score_half_life: float = 120.0
    # discovery-plane diversity (p2p/pex/reactor.py): outbound slots one
    # /16 netblock may hold (0 = auto: half the outbound budget, min 2)
    # and how often ensure-peers wakes to fill the outbound set
    max_outbound_per_group: int = 0
    pex_ensure_interval: float = 30.0

    def validate_basic(self) -> None:
        if self.max_num_inbound_peers < 0 or self.max_num_outbound_peers < 0:
            raise ValueError("peer limits cannot be negative")
        if self.send_rate < 0 or self.recv_rate < 0:
            raise ValueError("rates cannot be negative")
        if self.test_fuzz_mode not in ("drop", "delay"):
            raise ValueError(f"unknown test_fuzz_mode {self.test_fuzz_mode!r}")
        for name in ("test_fuzz_prob_drop_rw", "test_fuzz_prob_drop_conn",
                     "test_fuzz_prob_sleep"):
            v = getattr(self, name)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{name} must be a probability, got {v}")
        if self.test_fuzz_max_delay < 0:
            raise ValueError("test_fuzz_max_delay cannot be negative")
        if self.metrics_peer_cap < 0:
            raise ValueError("metrics_peer_cap cannot be negative")
        if self.ban_score_threshold <= 0:
            raise ValueError("ban_score_threshold must be positive")
        if self.ban_duration < 0 or self.ban_max_duration < 0:
            raise ValueError("ban durations cannot be negative")
        if self.ban_score_half_life <= 0:
            raise ValueError("ban_score_half_life must be positive")
        if self.max_outbound_per_group < 0:
            raise ValueError("max_outbound_per_group cannot be negative")
        if self.pex_ensure_interval <= 0:
            raise ValueError("pex_ensure_interval must be positive")
        if self.chaos:
            from cometbft_tpu_torch.p2p import netchaos as _netchaos

            _netchaos.parse_spec(self.chaos)  # raises ValueError on any part

    def persistent_peer_list(self) -> list[str]:
        return [p.strip() for p in self.persistent_peers.split(",") if p.strip()]

    def seed_list(self) -> list[str]:
        return [p.strip() for p in self.seeds.split(",") if p.strip()]


@dataclass
class BlockSyncConfig:
    """config.go:1064-1086."""

    enable: bool = True
    version: str = "v0"

    def validate_basic(self) -> None:
        if self.version != "v0":
            raise ValueError(f"unknown blocksync version {self.version!r}")


@dataclass
class StateSyncConfig:
    """config.go:966-1062."""

    enable: bool = False
    rpc_servers: list[str] = field(default_factory=list)
    trust_height: int = 0
    trust_hash: str = ""
    trust_period: float = 168 * 3600.0  # 1 week
    discovery_time: float = 15.0
    chunk_request_timeout: float = 10.0

    def validate_basic(self) -> None:
        if not self.enable:
            return
        if len(self.rpc_servers) < 2:
            raise ValueError("statesync requires >=2 rpc_servers")
        if self.trust_height <= 0:
            raise ValueError("statesync requires trust_height > 0")
        if not self.trust_hash:
            raise ValueError("statesync requires trust_hash")


@dataclass
class StorageConfig:
    """config.go:1240-1265, plus the storage-fault resilience plane
    (libs/diskchaos, store/db hardening).

    Durability semantics: `synchronous` is the sqlite pragma applied to
    EVERY connection of the block/state/evidence/index DBs — NORMAL
    (default) fsyncs the sqlite WAL at checkpoints (power loss can drop
    the tail of recently-committed transactions, never corrupt; the
    consensus WAL EndHeight fsync is what guards committed heights),
    FULL fsyncs every commit. The privval sign-state is ALWAYS
    FULL-grade (fsynced temp file + durable rename) regardless of this
    knob — it is the one write whose loss enables a double-sign."""

    discard_abci_responses: bool = False
    # sqlite synchronous pragma for the node's kv stores: NORMAL | FULL
    synchronous: str = "NORMAL"
    # CRC32-guard every block-store and state-store record value: a
    # rotted bit surfaces as a typed ErrCorruptValue naming the repair
    # path instead of a mis-parsed block. The guard changes the on-disk
    # value format — a store written WITHOUT it must be read with
    # checksum=false (or re-synced onto a fresh home); there is no
    # mixed-format mode, by design: "maybe legacy" reads would give a
    # rotted tag byte a way to smuggle a raw mis-parse past the guard
    checksum: bool = True
    # deterministic disk-fault schedule (libs/diskchaos.py syntax, e.g.
    # "wal.fsync=fsync_lie:1,db.read=bitrot"); test/e2e only — the
    # CBFT_DISK_CHAOS env var overlays this
    chaos: str = ""

    def validate_basic(self) -> None:
        if self.synchronous not in ("NORMAL", "FULL"):
            raise ValueError(
                f"unknown storage.synchronous {self.synchronous!r} "
                "(expected \"NORMAL\" or \"FULL\")")
        if self.chaos:
            from cometbft_tpu_torch.libs import diskchaos as _diskchaos

            _diskchaos.parse_spec(self.chaos)  # raises ValueError on any part


@dataclass
class CertConfig:
    """Commit-certificate plane (cert/ — no reference analog): succinct
    finality certificates produced once at commit finalize, verified
    with ONE pairing-product check, served over RPC and a negotiated
    blocksync channel. Only all-BLS validator sets certify; on any
    other set the plane stays idle and every consumer keeps the classic
    per-vote path."""

    enabled: bool = True
    # certify historical heights [store base, head] in the background
    backfill: bool = True
    # heights per backfill planning batch (bounds the per-pass work)
    backfill_batch: int = 32
    # store-poll cadence (seconds) for nodes WITHOUT an event bus, and
    # the backfill worker's idle sleep
    poll_interval: float = 1.0
    # serve certificates to peers on the negotiated 0x25 channel
    serve: bool = True

    def validate_basic(self) -> None:
        if self.backfill_batch < 1:
            raise ValueError("cert.backfill_batch must be >= 1")
        if self.poll_interval <= 0:
            raise ValueError("cert.poll_interval must be positive")


@dataclass
class GRPCConfig:
    """config.go:520-543 GRPCConfig: the gRPC service surface. Empty
    addresses disable the listeners. The pruning (data-companion) service
    is only ever served on the privileged listener."""

    laddr: str = ""
    privileged_laddr: str = ""


@dataclass
class TxIndexConfig:
    """config.go:1279-1302."""

    # "kv": query-language search via RPC; "sql": write-only relational
    # sink (the psql-sink analog — SQL consumers query the DB directly,
    # tx_search/block_search disabled, as with the reference's psql sink);
    # "null": no indexing
    indexer: str = "kv"

    def validate_basic(self) -> None:
        if self.indexer not in ("kv", "null", "sql"):
            raise ValueError(f"unknown indexer {self.indexer!r}")


@dataclass
class InstrumentationConfig:
    """config.go:1333-1378, plus the verify-plane flight recorder
    (libs/trace.py): span tracing with per-batch wall-time attribution,
    Chrome-trace export over the `trace_dump` RPC route, and a slow-batch
    capture ring. Near-zero cost when `tracing` is off (tier-1 asserts
    <3% on a 1k-row verify). The CBFT_TRACE env var ("1"/"0") overlays
    `tracing` at node boot, the same pattern as CBFT_CHAOS."""

    prometheus: bool = False
    prometheus_listen_addr: str = ":26660"
    namespace: str = "cometbft"
    # --- flight recorder (libs/trace.py) ---
    tracing: bool = False
    # bounded span ring: oldest finished spans overwritten past this
    trace_buffer_spans: int = 65536
    # a root span (sched.verify drain, sync.window, consensus.height,
    # mempool.admit) slower than this keeps its FULL span tree in the
    # slow capture ring for post-mortem; < 0 disables capture
    trace_slow_ms: float = 250.0
    # how many slow captures are retained (FIFO)
    trace_slow_captures: int = 32
    # --- consensus heightline (consensus/timeline.py) ---
    # per-height critical-path event ring + clock-skew model; the
    # CBFT_TIMELINE env var overlays `timeline` at node boot
    timeline: bool = False
    # bounded ring: how many recent heights keep their event records
    timeline_heights: int = 64
    # a height whose wall time exceeds this auto-captures a postmortem
    # bundle (timeline + span captures + gossip/wire/scheduler context),
    # served by the `postmortems` RPC route; <= 0 disables capture
    height_slow_ms: float = 0.0
    # how many postmortem bundles are retained (FIFO)
    postmortem_captures: int = 8

    def validate_basic(self) -> None:
        if self.trace_buffer_spans < 1:
            raise ValueError("trace_buffer_spans must be >= 1")
        if self.trace_slow_captures < 1:
            raise ValueError("trace_slow_captures must be >= 1")
        if self.timeline_heights < 1:
            raise ValueError("timeline_heights must be >= 1")
        if self.postmortem_captures < 1:
            raise ValueError("postmortem_captures must be >= 1")


@dataclass
class WALConfig:
    """Consensus WAL file knobs (reference: part of ConsensusConfig,
    config.go:1096 WalPath + libs/autofile group limits)."""

    wal_dir: str = "data/cs.wal"
    segment_size_bytes: int = 8 << 20  # rotate segments at 8 MB
    max_segments: int = 32


@dataclass
class Config:
    """The root tree (config.go:76)."""

    base: BaseConfig = field(default_factory=BaseConfig)
    crypto: CryptoConfig = field(default_factory=CryptoConfig)
    light: LightConfig = field(default_factory=LightConfig)
    rpc: RPCConfig = field(default_factory=RPCConfig)
    grpc: GRPCConfig = field(default_factory=GRPCConfig)
    p2p: P2PConfig = field(default_factory=P2PConfig)
    mempool: MempoolConfig = field(default_factory=MempoolConfig)
    consensus: ConsensusConfig = field(default_factory=ConsensusConfig)
    wal: WALConfig = field(default_factory=WALConfig)
    block_sync: BlockSyncConfig = field(default_factory=BlockSyncConfig)
    state_sync: StateSyncConfig = field(default_factory=StateSyncConfig)
    storage: StorageConfig = field(default_factory=StorageConfig)
    tx_index: TxIndexConfig = field(default_factory=TxIndexConfig)
    cert: CertConfig = field(default_factory=CertConfig)
    instrumentation: InstrumentationConfig = field(default_factory=InstrumentationConfig)
    home: str = "."  # set at load time, not serialized

    def validate_basic(self) -> None:
        """config.go:318 ValidateBasic: every section that defines one."""
        for section in (self.base, self.crypto, self.light, self.rpc,
                        self.p2p, self.mempool, self.block_sync,
                        self.state_sync, self.storage, self.tx_index,
                        self.cert, self.instrumentation):
            section.validate_basic()

    # ------------------------------------------------------------ paths

    def _abs(self, rel: str) -> str:
        return rel if os.path.isabs(rel) else os.path.join(self.home, rel)

    def genesis_path(self) -> str:
        return self._abs(self.base.genesis_file)

    def node_key_path(self) -> str:
        return self._abs(self.base.node_key_file)

    def priv_validator_key_path(self) -> str:
        return self._abs(self.base.priv_validator_key_file)

    def priv_validator_state_path(self) -> str:
        return self._abs(self.base.priv_validator_state_file)

    def db_path(self, name: str) -> str:
        return self._abs(os.path.join(self.base.db_dir, f"{name}.db"))

    def wal_path(self) -> str:
        return self._abs(self.wal.wal_dir)

    # ------------------------------------------------------------- TOML

    _SECTIONS = (
        ("base", ""),  # base fields live at top level, like the reference
        ("crypto", "crypto"),
        ("light", "light"),
        ("rpc", "rpc"),
        ("grpc", "grpc"),
        ("p2p", "p2p"),
        ("mempool", "mempool"),
        ("consensus", "consensus"),
        ("wal", "wal"),
        ("block_sync", "blocksync"),
        ("state_sync", "statesync"),
        ("storage", "storage"),
        ("tx_index", "tx_index"),
        ("cert", "cert"),
        ("instrumentation", "instrumentation"),
    )

    def to_toml(self) -> str:
        out = ["# cometbft_tpu node configuration\n"]
        for attr, section in self._SECTIONS:
            obj = getattr(self, attr)
            if section:
                out.append(f"\n[{section}]\n")
            for f in fields(obj):
                out.append(f"{f.name} = {_toml_value(getattr(obj, f.name))}\n")
        return "".join(out)

    def save(self, path: str | None = None) -> str:
        path = path or os.path.join(self.home, "config", "config.toml")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            f.write(self.to_toml())
        # durable rename (libs/diskio): the e2e runner rewrites configs
        # between respawns — a half-landed config after a crash-storm
        # kill would boot the node with default knobs
        from cometbft_tpu_torch.libs import diskio

        diskio.durable_replace(tmp, path)
        return path

    @classmethod
    def load(cls, home: str) -> "Config":
        """Load config/config.toml under home; missing keys keep defaults
        (the reference's viper layering, minus env/flags which the CLI
        applies on top)."""
        cfg = cls(home=home)
        path = os.path.join(home, "config", "config.toml")
        if not os.path.exists(path):
            return cfg
        with open(path, "rb") as f:
            doc = tomllib.load(f)
        for attr, section in cls._SECTIONS:
            obj = getattr(cfg, attr)
            src = doc if not section else doc.get(section, {})
            for fld in fields(obj):
                if fld.name in src:
                    setattr(obj, fld.name, src[fld.name])
        return cfg


def _toml_value(v) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, (int, float)):
        return repr(v)
    if isinstance(v, str):
        return '"' + v.replace("\\", "\\\\").replace('"', '\\"') + '"'
    if isinstance(v, list):
        return "[" + ", ".join(_toml_value(x) for x in v) + "]"
    raise TypeError(f"cannot TOML-encode {type(v)}")


def default_config(home: str = ".") -> Config:
    return Config(home=home)


def test_config(home: str = ".") -> Config:
    """Millisecond-scale timeouts (reference config.TestConfig)."""
    from cometbft_tpu_torch.consensus.config import test_consensus_config

    cfg = Config(home=home, consensus=test_consensus_config())
    cfg.base.db_backend = "memdb"
    cfg.crypto.backend = "cpu"
    cfg.p2p.send_rate = 50_000_000
    cfg.p2p.recv_rate = 50_000_000
    return cfg
