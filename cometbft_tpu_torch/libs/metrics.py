"""Prometheus-style metrics, dependency-free.

Reference: each subsystem's metrics.go (consensus/metrics.go:20-133,
mempool/metrics.go, p2p/metrics.go, state/metrics.go) built on go-kit +
prometheus. Same shape here: typed per-subsystem structs over Counter /
Gauge / Histogram primitives, one process-wide Registry rendering the
Prometheus text exposition format, served by the RPC server's /metrics
route (config.instrumentation.prometheus).

The port's copy of cometbft_tpu/libs/metrics.py: the same series, names,
help texts and exposition, so either package's scrape reads alike. The
crypto backend gauge carries the port's backends, "gpu" and "cpu".
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Optional, Sequence


def escape_label_value(v: str) -> str:
    """Prometheus text-exposition label-value escaping: backslash, double
    quote, and newline must be escaped or a scraper misparses the series
    (a chaos spec or error string in a label value can contain all
    three)."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def escape_help(s: str) -> str:
    """# HELP line escaping: backslash and newline only (quotes are legal
    there)."""
    return str(s).replace("\\", "\\\\").replace("\n", "\\n")


def _fmt_labels(pairs) -> str:
    return ",".join(f'{n}="{escape_label_value(v)}"' for n, v in pairs)


class _Metric:
    def __init__(self, name: str, help_: str, labels: Sequence[str] = ()):
        self.name = name
        self.help = help_
        self.label_names = tuple(labels)
        self._values: dict[tuple, float] = {}
        self._lock = threading.Lock()

    def labels(self, *label_values: str) -> "_Bound":
        if len(label_values) != len(self.label_names):
            raise ValueError(
                f"{self.name}: want {len(self.label_names)} labels, got {len(label_values)}")
        return _Bound(self, tuple(str(v) for v in label_values))

    def value(self, *label_values: str) -> float:
        """Current value for the label combination (0.0 if never set) —
        the assertion-friendly read side for tests and health snapshots."""
        key = tuple(str(v) for v in label_values)
        with self._lock:
            return self._values.get(key, 0.0)

    def _set(self, key: tuple, v: float) -> None:
        with self._lock:
            self._values[key] = v

    def _add(self, key: tuple, v: float) -> None:
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + v

    def _fmt_key(self, key: tuple) -> str:
        if not key:
            return self.name
        return f"{self.name}{{{_fmt_labels(zip(self.label_names, key))}}}"

    def render(self) -> list[str]:
        out = [f"# HELP {self.name} {escape_help(self.help)}",
               f"# TYPE {self.name} {self.TYPE}"]
        with self._lock:
            vals = dict(self._values) or ({(): 0.0} if not self.label_names else {})
        for key, v in sorted(vals.items()):
            out.append(f"{self._fmt_key(key)} {v:g}")
        return out


class _Bound:
    def __init__(self, metric: "_Metric", key: tuple):
        self._m = metric
        self._key = key

    def set(self, v: float) -> None:
        self._m._set(self._key, v)

    def inc(self, v: float = 1.0) -> None:
        self._m._add(self._key, v)

    def observe(self, v: float) -> None:
        self._m.observe_key(self._key, v)  # type: ignore[attr-defined]


class Counter(_Metric):
    TYPE = "counter"

    def inc(self, v: float = 1.0) -> None:
        self._add((), v)


class Gauge(_Metric):
    TYPE = "gauge"

    def set(self, v: float) -> None:
        self._set((), v)

    def inc(self, v: float = 1.0) -> None:
        self._add((), v)

    def dec(self, v: float = 1.0) -> None:
        self._add((), -v)


class Histogram(_Metric):
    """Prometheus histogram with fixed buckets."""

    TYPE = "histogram"
    DEFAULT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0,
                       2.5, 5.0, 10.0)

    def __init__(self, name: str, help_: str, labels: Sequence[str] = (),
                 buckets: Sequence[float] | None = None):
        super().__init__(name, help_, labels)
        self.buckets = tuple(buckets if buckets is not None else self.DEFAULT_BUCKETS)
        self._counts: dict[tuple, list[int]] = {}
        self._sums: dict[tuple, float] = {}
        self._totals: dict[tuple, int] = {}

    def observe(self, v: float) -> None:
        self.observe_key((), v)

    def observe_key(self, key: tuple, v: float) -> None:
        with self._lock:
            counts = self._counts.setdefault(key, [0] * len(self.buckets))
            for i, b in enumerate(self.buckets):
                if v <= b:
                    counts[i] += 1
            self._sums[key] = self._sums.get(key, 0.0) + v
            self._totals[key] = self._totals.get(key, 0) + 1

    def sum_value(self, *label_values: str) -> float:
        key = tuple(str(v) for v in label_values)
        with self._lock:
            return self._sums.get(key, 0.0)

    def count_value(self, *label_values: str) -> int:
        key = tuple(str(v) for v in label_values)
        with self._lock:
            return self._totals.get(key, 0)

    def render(self) -> list[str]:
        """Exposition-format series per label set, in the order scrapers
        require: cumulative _bucket lines ascending by `le`, then the
        mandatory `le="+Inf"` bucket, then _sum, then _count — with label
        values escaped. `le` renders LAST within the braces (the
        convention promtool canonicalizes to)."""
        out = [f"# HELP {self.name} {escape_help(self.help)}",
               f"# TYPE {self.name} histogram"]
        with self._lock:
            keys = list(self._totals) or ([()] if not self.label_names else [])
            for key in sorted(keys):
                counts = self._counts.get(key, [0] * len(self.buckets))
                base_pairs = list(zip(self.label_names, key))
                # per-bucket counts are recorded cumulatively by
                # observe_key; render them as-is, ascending
                for b, cum in zip(self.buckets, counts):
                    inner = _fmt_labels(base_pairs + [("le", f"{b:g}")])
                    out.append(f"{self.name}_bucket{{{inner}}} {cum}")
                inner = _fmt_labels(base_pairs + [("le", "+Inf")])
                out.append(
                    f"{self.name}_bucket{{{inner}}} {self._totals.get(key, 0)}")
                # the suffix goes on the metric NAME, before the braces
                # (the seed rendered `name{labels}_sum`, which scrapers
                # reject for any labeled histogram)
                braces = f"{{{_fmt_labels(base_pairs)}}}" if key else ""
                out.append(
                    f"{self.name}_sum{braces} {self._sums.get(key, 0.0):g}")
                out.append(
                    f"{self.name}_count{braces} {self._totals.get(key, 0)}")
        return out


class Registry:
    def __init__(self, namespace: str = "cometbft"):
        self.namespace = namespace
        self._metrics: list[_Metric] = []
        self._lock = threading.Lock()

    def counter(self, subsystem: str, name: str, help_: str,
                labels: Sequence[str] = ()) -> Counter:
        return self._register(Counter(self._nm(subsystem, name), help_, labels))

    def gauge(self, subsystem: str, name: str, help_: str,
              labels: Sequence[str] = ()) -> Gauge:
        return self._register(Gauge(self._nm(subsystem, name), help_, labels))

    def histogram(self, subsystem: str, name: str, help_: str,
                  labels: Sequence[str] = (),
                  buckets: Sequence[float] | None = None) -> Histogram:
        return self._register(
            Histogram(self._nm(subsystem, name), help_, labels, buckets))

    def _nm(self, subsystem: str, name: str) -> str:
        return f"{self.namespace}_{subsystem}_{name}"

    def _register(self, m):
        with self._lock:
            self._metrics.append(m)
        return m

    def render(self) -> str:
        lines: list[str] = []
        with self._lock:
            metrics = list(self._metrics)
        for m in metrics:
            lines.extend(m.render())
        return "\n".join(lines) + "\n"


# ------------------------------------------------- per-subsystem structs


class ConsensusMetrics:
    """consensus/metrics.go:20-133."""

    def __init__(self, reg: Registry):
        self.height = reg.gauge("consensus", "height", "Height of the chain")
        self.rounds = reg.gauge("consensus", "rounds", "Round of the current height")
        self.round_duration = reg.histogram(
            "consensus", "round_duration_seconds", "Time per consensus round")
        self.validators = reg.gauge("consensus", "validators", "Number of validators")
        self.validators_power = reg.gauge(
            "consensus", "validators_power", "Total voting power")
        self.missing_validators = reg.gauge(
            "consensus", "missing_validators", "Validators missing from the last commit")
        self.byzantine_validators = reg.gauge(
            "consensus", "byzantine_validators", "Validators with evidence against them")
        self.block_interval = reg.histogram(
            "consensus", "block_interval_seconds", "Time between blocks",
            buckets=(0.1, 0.25, 0.5, 1, 2, 5, 10, 30))
        self.num_txs = reg.gauge("consensus", "num_txs", "Txs in the latest block")
        self.block_size = reg.gauge("consensus", "block_size_bytes", "Latest block size")
        self.total_txs = reg.counter("consensus", "total_txs", "Total committed txs")
        self.vote_extension_received = reg.counter(
            "consensus", "vote_extensions_received", "Peer vote extensions seen",
            labels=("status",))
        self.batch_flushes = reg.counter(
            "consensus", "vote_batch_flushes", "Device vote-batch flushes")
        self.batch_lanes = reg.counter(
            "consensus", "vote_batch_lanes", "Signatures through batched flushes")
        # gossip accounting (fleet dimension): votes sent vs. votes the
        # peer actually needed — vote amplification as a measured number.
        # Receiver-side classification: needed = the vote advanced our
        # view; already_had = our vote set already held it (a wasted
        # send by the peer); stale = for a height we have committed past.
        # Cardinality is bounded by construction (3 statuses, no peer
        # labels — the per-peer split lives in net_telemetry's gossip
        # rollup, bounded by live peers).
        self.gossip_votes_sent = reg.counter(
            "consensus", "gossip_votes_sent",
            "Votes this node's gossip routines sent to peers")
        self.gossip_votes_received = reg.counter(
            "consensus", "gossip_votes_received",
            "Votes received from peers, by whether this node needed them",
            labels=("status",))
        self.gossip_summaries = reg.counter(
            "consensus", "gossip_vote_summaries",
            "Compact vote-summary reconciliation events (sent / applied / "
            "degraded_* = summary ignored, full gossip continues / "
            "peer_unsupported = peer never negotiated the channel)",
            labels=("event",))


class MempoolMetrics:
    """mempool/metrics.go."""

    def __init__(self, reg: Registry):
        self.size = reg.gauge("mempool", "size", "Number of uncommitted txs")
        self.size_bytes = reg.gauge("mempool", "size_bytes", "Mempool byte size")
        self.failed_txs = reg.counter("mempool", "failed_txs", "CheckTx rejections")
        self.recheck_times = reg.counter("mempool", "recheck_times", "Recheck passes")


class P2PMetrics:
    """p2p/metrics.go + the wire-plane accounting dimension.

    Cardinality policy: per-channel series label by `chID` (a handful of
    values, fixed by the reactor set). Per-peer series label by a CAPPED
    peer set — the first `peer_cap` distinct peers get their own label
    (short node id); every later peer folds into an `other` bucket, so a
    10k-peer fleet cannot explode the exposition. The cap is first-come
    (stable across a scrape's lifetime); `peer_label()` is the one
    chokepoint enforcing it."""

    def __init__(self, reg: Registry, peer_cap: int = 32):
        self.peers = reg.gauge("p2p", "peers", "Connected peers")
        self.message_send_bytes = reg.counter(
            "p2p", "message_send_bytes_total", "Bytes sent", labels=("chID",))
        self.message_receive_bytes = reg.counter(
            "p2p", "message_receive_bytes_total", "Bytes received", labels=("chID",))
        # wire-plane accounting (MConnection per-peer/per-channel counters;
        # peer labels capped — see class docstring)
        self.peer_send_bytes = reg.counter(
            "p2p", "peer_send_bytes_total",
            "Wire bytes sent per peer per channel (peer labels capped; "
            "overflow peers fold into peer=\"other\")",
            labels=("peer", "chID"))
        self.peer_receive_bytes = reg.counter(
            "p2p", "peer_receive_bytes_total",
            "Wire bytes received per peer per channel (capped peer set)",
            labels=("peer", "chID"))
        self.peer_send_msgs = reg.counter(
            "p2p", "peer_send_messages_total",
            "Messages sent per peer per channel (capped peer set)",
            labels=("peer", "chID"))
        self.peer_receive_msgs = reg.counter(
            "p2p", "peer_receive_messages_total",
            "Messages received per peer per channel (capped peer set)",
            labels=("peer", "chID"))
        self.peer_ping_rtt = reg.gauge(
            "p2p", "peer_ping_rtt_seconds",
            "Last ping->pong round trip per peer (capped peer set)",
            labels=("peer",))
        # misbehavior-scoring plane (p2p/switch.py PeerScorer): byzantine
        # peers must lose their connection slot, not just their messages
        self.peer_misbehavior = reg.counter(
            "p2p", "peer_misbehavior",
            "Misbehavior reports scored against peers", labels=("reason",))
        self.peer_bans = reg.counter(
            "p2p", "peer_bans",
            "Peers banned after repeated misbehavior")
        # discovery plane (p2p/pex/addrbook.py hashed-bucket book)
        self.addrbook_size = reg.gauge(
            "p2p", "addrbook_size",
            "Address-book entries by set (hashed-bucket geometry)",
            labels=("set",))
        self.addrbook_overwrite_rejected = reg.counter(
            "p2p", "addrbook_overwrite_rejected_total",
            "Gossip records rejected because they would overwrite the "
            "host:port of a successfully-tried (OLD) address")
        self.addrbook_quarantined = reg.counter(
            "p2p", "addrbook_quarantined_total",
            "Corrupt address-book files quarantined to .corrupt at load")
        self.peer_cap = peer_cap
        # label-slot ledger (bounded under churn storms — ISSUE 12):
        #   _peer_labels  ids currently OWNING a label (<= peer_cap live
        #                 owners; a returning released peer may briefly
        #                 push past while its old label is re-armed)
        #   _released     past owners, newest last (<= peer_cap): a peer
        #                 whose ban expired re-claims its OWN label
        #                 instead of minting a new exposition series
        #   _minted       distinct labels ever created — the HARD
        #                 exposition bound (2x peer_cap): counter series
        #                 persist after release, so reclaimed slots must
        #                 not mint fresh label values forever
        # Overflow ids are NOT cached (a churn storm past the cap must
        # not grow this map without bound).
        self._peer_labels: dict[str, str] = {}
        self._released: dict[str, str] = {}
        self._minted = 0
        self._peer_lock = threading.Lock()

    OTHER_PEER_LABEL = "other"

    @property
    def mint_cap(self) -> int:
        """Distinct per-peer label values ever allowed on the exposition
        (live + released-but-persisting series)."""
        return 2 * self.peer_cap

    def peer_label(self, node_id: str) -> str:
        """Bounded-cardinality peer label: up to peer_cap LIVE peers own
        their short-id label; a released peer (disconnect, ban) frees its
        slot and — returning later — gets its old label back; past the
        mint cap, new peers fold into "other" even when slots are free
        (the exposition is already at its bound)."""
        if not node_id:
            return self.OTHER_PEER_LABEL
        with self._peer_lock:
            label = self._peer_labels.get(node_id)
            if label is not None:
                return label
            label = self._released.pop(node_id, None)
            if label is not None:  # ban expired / redial: same series
                self._peer_labels[node_id] = label
                return label
            if (len(self._peer_labels) < self.peer_cap
                    and self._minted < self.mint_cap):
                label = node_id[:10]
                self._peer_labels[node_id] = label
                self._minted += 1
                return label
            return self.OTHER_PEER_LABEL

    def release_peer(self, node_id: str) -> None:
        """Free a disconnected/banned peer's label slot. Its label is
        remembered (bounded FIFO) so the SAME peer returning re-claims
        it; the oldest released memory is dropped past peer_cap — such a
        peer returning after a long churn storm reads as new."""
        with self._peer_lock:
            label = self._peer_labels.pop(node_id, None)
            if label is None:
                return
            self._released.pop(node_id, None)
            self._released[node_id] = label
            while len(self._released) > self.peer_cap:
                del self._released[next(iter(self._released))]

    def peer_label_stats(self) -> dict:
        """Ledger introspection for tests/health: all bounded."""
        with self._peer_lock:
            return {"owners": len(self._peer_labels),
                    "released": len(self._released),
                    "minted": self._minted,
                    "mint_cap": self.mint_cap}

    def record_conn_traffic(self, peer_label: str, per_chan: dict,
                            send: bool) -> None:
        """Apply a batch of per-channel (bytes, msgs) deltas from one
        MConnection flush. `peer_label` must already be capped (the
        Switch hands each Peer its label at construction)."""
        peer = peer_label or self.OTHER_PEER_LABEL
        byte_m = self.peer_send_bytes if send else self.peer_receive_bytes
        msg_m = self.peer_send_msgs if send else self.peer_receive_msgs
        chan_m = self.message_send_bytes if send else self.message_receive_bytes
        for cid, (nbytes, nmsgs) in per_chan.items():
            ch = f"{cid:#x}" if isinstance(cid, int) else str(cid)
            if nbytes:
                byte_m.labels(peer, ch).inc(nbytes)
                chan_m.labels(ch).inc(nbytes)
            if nmsgs:
                msg_m.labels(peer, ch).inc(nmsgs)


class EvidenceMetrics:
    """Evidence-pool observability (no dedicated reference struct; the
    reference folds this into consensus metrics — split out here so the
    byzantine-resilience tests can assert detection end-to-end)."""

    def __init__(self, reg: Registry):
        self.evidence_committed = reg.counter(
            "evidence", "committed",
            "Byzantine-behavior proofs committed into blocks")
        self.evidence_pending = reg.gauge(
            "evidence", "pending", "Verified evidence awaiting commitment")


class StateMetrics:
    """state/metrics.go."""

    def __init__(self, reg: Registry):
        self.block_processing_time = reg.histogram(
            "state", "block_processing_time", "ApplyBlock seconds",
            buckets=(0.01, 0.05, 0.1, 0.25, 0.5, 1, 2.5, 5))


class CryptoMetrics:
    """Device dimension (no reference analog): device batch activity."""

    def __init__(self, reg: Registry):
        self.device_batches = reg.counter(
            "crypto", "device_batches", "Kernel dispatches", labels=("kind",))
        self.device_lanes = reg.counter(
            "crypto", "device_lanes", "Signature lanes dispatched", labels=("kind",))
        self.device_seconds = reg.counter(
            "crypto", "device_seconds", "Estimated device-busy seconds")
        # transfer-integrity plane: a tunnel-attached device must EARN the
        # in-process-memory trust the reference assumes (validation.go:235)
        self.transfer_checksum_mismatch = reg.counter(
            "crypto", "transfer_checksum_mismatch",
            "Host->device staging checksum failures detected on device")
        self.mask_echo_mismatch = reg.counter(
            "crypto", "mask_echo_mismatch",
            "Device->host mask fetches whose redundant echo disagreed")
        self.mask_oracle_disagreement = reg.counter(
            "crypto", "mask_oracle_disagreement",
            "Device-rejected lanes the host oracle re-accepted")
        # backend-health plane (device-fault resilience layer,
        # ops/dispatch.py): which backend (crypto/batch: "gpu" or
        # "cpu") is serving verifies, and how the supervisors are doing
        self.backend_active = reg.gauge(
            "crypto", "backend_active",
            "1 for the backend currently serving verify batches",
            labels=("backend",))
        self.breaker_state = reg.gauge(
            "crypto", "breaker_state",
            "Device circuit breaker: 0 closed, 1 half-open, 2 open",
            labels=("name",))
        self.device_retries = reg.counter(
            "crypto", "device_retries",
            "Transient device-op retries (backoff path)", labels=("name",))
        self.device_failures = reg.counter(
            "crypto", "device_failures",
            "Supervised device operations that failed after retries",
            labels=("name", "class"))
        self.breaker_transitions = reg.counter(
            "crypto", "breaker_transitions",
            "Circuit breaker state transitions", labels=("name", "to"))
        self.fallback_verifies = reg.counter(
            "crypto", "fallback_verifies",
            "Signature lanes verified on the CPU ladder after a device "
            "failure", labels=("scheme",))
        # staging plane (ops/hashvec + reduced-fetch protocol): how often
        # the happy path keeps the mask off the tunnel, and how the
        # decompressed-pubkey cache is doing
        self.verify_fetches = reg.counter(
            "crypto", "verify_fetches",
            "Device->host verify result fetches by path (happy = 8-byte "
            "header only; full = header + per-lane payload)",
            labels=("path",))
        self.verify_fetch_bytes = reg.counter(
            "crypto", "verify_fetch_bytes",
            "Bytes transferred by verify result fetches, by path",
            labels=("path",))
        self.pubkey_cache_events = reg.counter(
            "crypto", "pubkey_cache_events",
            "Decompressed-pubkey cache hits/misses/evictions per level "
            "(host bytes->coords FIFO; device-resident digest slots)",
            labels=("level", "event"))
        # send-side wire accounting (reduced-send protocol,
        # ops/residency.py), the twin of verify_fetch_bytes{path}:
        # indexed = 2-byte validator indices + staged r/s/k words
        # (steady state); delta = validator-set churn row uploads;
        # full = full-key fallback (coordinate tables + 4-byte indices)
        self.verify_sends = reg.counter(
            "crypto", "verify_sends",
            "Host->device verify staging transfers by send path",
            labels=("path",))
        self.verify_send_bytes = reg.counter(
            "crypto", "verify_send_bytes",
            "Bytes transferred by host->device verify staging, by send "
            "path", labels=("path",))


class MeshMetrics:
    """Multi-chip verify-mesh observability (parallel/mesh.py — no
    reference analog): live mesh size, per-chip breaker state, shard
    redispatch/eviction/readmission churn, and the all-chips-dead
    fallback count. Process-global like CryptoMetrics — the device mesh
    is one per process."""

    def __init__(self, reg: Registry):
        self.verify_mesh_size = reg.gauge(
            "crypto", "verify_mesh_size",
            "Live verify-mesh size: chips whose breaker currently admits "
            "shards (0 = all fault domains dead, ladder fallback engaged)")
        self.mesh_devices = reg.gauge(
            "crypto", "mesh_devices",
            "Total chips the verify mesh was built over")
        self.mesh_breaker_state = reg.gauge(
            "crypto", "mesh_breaker_state",
            "Per-chip fault-domain breaker: 0 closed, 1 half-open, 2 open",
            labels=("device",))
        self.mesh_redispatch_total = reg.counter(
            "crypto", "mesh_redispatch_total",
            "In-flight shards re-dispatched onto surviving chips after "
            "their fault domain failed, by failure class",
            labels=("reason",))
        self.mesh_evictions_total = reg.counter(
            "crypto", "mesh_evictions_total",
            "Chips evicted from the live mesh (breaker opened)")
        self.mesh_readmissions_total = reg.counter(
            "crypto", "mesh_readmissions_total",
            "Chips readmitted to the live mesh (half-open probe healed)")
        self.mesh_fallback_total = reg.counter(
            "crypto", "mesh_fallback_total",
            "Batches that fell off an all-chips-dead mesh onto the "
            "single-card path")
        self.mesh_shard_lanes = reg.counter(
            "crypto", "mesh_shard_lanes",
            "Padded verify lanes dispatched per chip (the scheduler's "
            "per-chip lane-fill evidence)", labels=("device",))


class SchedMetrics:
    """Verify-scheduler observability (sched/scheduler.py — no reference
    analog): how full the continuously-batched device batches run, how
    deep each priority class queues, and whether deadline flushing keeps
    up. Process-global like CryptoMetrics — one scheduler per process."""

    def __init__(self, reg: Registry):
        self.batch_lanes = reg.histogram(
            "verify_sched", "batch_lanes",
            "Padded lane count of each dispatched verify batch",
            buckets=(8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096,
                     8192, 16384))
        self.fill_ratio = reg.histogram(
            "verify_sched", "fill_ratio",
            "Rows / padded lanes per dispatched verify batch",
            buckets=(0.1, 0.25, 0.5, 0.625, 0.75, 0.875, 0.95, 1.0))
        self.queue_depth = reg.gauge(
            "verify_sched", "queue_depth",
            "Signature rows queued per priority class", labels=("class",))
        self.flush_deadline_misses = reg.counter(
            "verify_sched", "flush_deadline_misses",
            "Groups flushed past their deadline (plus slack)")
        self.flush_latency = reg.histogram(
            "verify_sched", "flush_latency_seconds",
            "Submit-to-dispatch latency per priority class",
            labels=("class",),
            buckets=(0.0005, 0.001, 0.002, 0.005, 0.01, 0.025, 0.05, 0.1,
                     0.25, 1.0))


class LightFleetMetrics:
    """Light-client serving-plane observability (light/fleet.py — no
    reference analog): how requests resolve (cache hit / coalesced onto
    an in-flight verification / freshly verified / shed / error), the
    checkpoint-cache churn, and the streaming-subscriber lifecycle.
    Process-global like SchedMetrics — the fleet rides the process's
    verify plane."""

    def __init__(self, reg: Registry):
        self.requests = reg.counter(
            "light_fleet", "requests_total",
            "Fleet verification requests by result (hit = checkpoint "
            "cache; coalesced = shared an in-flight bisection; verified "
            "= ran a fresh bisection; saturated = shed at admission)",
            labels=("result",))
        self.cache_events = reg.counter(
            "light_fleet", "cache_events",
            "Checkpoint skip-list cache events (hit/miss/evict/prune; "
            "prune = trusting-period expiry)", labels=("event",))
        self.request_seconds = reg.histogram(
            "light_fleet", "request_seconds",
            "Wall seconds per UNIQUE fleet verification (cache hits and "
            "coalesced waits excluded)",
            buckets=(0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                     1.0, 2.5, 10.0))
        self.inflight = reg.gauge(
            "light_fleet", "inflight",
            "Unique verifications currently in flight")
        self.subscribers = reg.gauge(
            "light_fleet", "subscribers", "Live streaming subscribers")
        self.streamed = reg.counter(
            "light_fleet", "streamed_headers_total",
            "Verified headers streamed to subscribers")
        self.subscriber_drops = reg.counter(
            "light_fleet", "subscriber_drops_total",
            "Subscriptions the fleet closed, by reason (backpressure = "
            "queue high water; budget = per-client send budget spent)",
            labels=("reason",))


class CertMetrics:
    """Commit-certificate plane observability (cert/plane.py — no
    reference analog): the produce/serve/verify/fallback lifecycle of
    succinct finality certificates. Per-node (the plane rides each
    node's stores), registered on the node's registry so the e2e runner
    reads backfill progress off /metrics."""

    def __init__(self, reg: Registry):
        self.cert_produced = reg.counter(
            "cert", "produced_total",
            "Commit certificates produced (event-driven at finalize plus "
            "backfill)")
        self.cert_backfilled = reg.counter(
            "cert", "backfilled_total",
            "Certificates produced by the historical backfill worker "
            "(subset of produced_total)")
        self.cert_served = reg.counter(
            "cert", "served_total",
            "Certificates served to consumers (RPC + blocksync)")
        self.cert_verified = reg.counter(
            "cert", "verified_total",
            "Certificates that decided a commit via the one-pairing "
            "check (light + blocksync consumers)")
        self.cert_fallbacks = reg.counter(
            "cert", "fallbacks_total",
            "Held-certificate verifications that degraded to the classic "
            "per-vote path (invalid/mismatched/corrupt certificate — "
            "counted, never a wrong verdict)")


class OverloadMetrics:
    """Overload resilience plane observability (libs/overload.py — no
    reference analog): per-plane watermark levels and shed accounting.
    Process-global like SchedMetrics — the registry instances are
    per-node but the series are shared, labeled by plane (in-proc test
    nets aggregate, exactly like the scheduler's queue-depth series)."""

    def __init__(self, reg: Registry):
        self.level = reg.gauge(
            "overload", "level",
            "Watermark level per plane (0=normal 1=elevated 2=saturated)",
            labels=("plane",))
        self.sheds = reg.counter(
            "overload", "sheds_total",
            "Requests/txs shed by the coordinated overload policy, per "
            "plane (rpc = in-flight budget, mempool = admission gate, "
            "sched = verify-queue backpressure, events = subscriber "
            "lag)", labels=("plane",))
        self.transitions = reg.counter(
            "overload", "level_transitions_total",
            "Watermark level transitions per plane (a flapping signal "
            "here means the hysteresis band is too narrow)",
            labels=("plane",))


_global: Optional[Registry] = None


def global_registry() -> Registry:
    global _global
    if _global is None:
        _global = Registry()
    return _global


class NetChaosMetrics:
    """Injected network-fault observability (p2p/netchaos.py). Process-
    global like CryptoMetrics: the netchaos registry is one per process."""

    def __init__(self, reg: Registry):
        self.partition_heal_seconds = reg.gauge(
            "p2p", "partition_heal_seconds",
            "Seconds from partition heal to first traffic across a "
            "formerly-cut link")
        self.net_faults = reg.counter(
            "p2p", "net_chaos_faults",
            "Injected network faults by kind", labels=("kind",))


class StorageMetrics:
    """Storage-plane observability (libs/diskchaos, consensus/wal,
    store/db — no reference analog): WAL fsync latency, torn-tail
    truncations and wal-repair runs, db write latency, CRC-guard
    corruption detections, and a per-(site,kind) counter for every
    injected disk fault. Process-global like CryptoMetrics — the disk
    chaos registry and the latency rollups are one per process. The
    `storage_health` RPC section is rendered from health()."""

    # rolling percentile windows: Prometheus histograms lose p50/p99
    # resolution to bucket edges; operators reading storage_health get
    # exact percentiles over the recent window instead
    WINDOW = 4096

    def __init__(self, reg: Registry):
        self.wal_fsync_seconds = reg.histogram(
            "storage", "wal_fsync_seconds", "Consensus WAL fsync latency",
            buckets=(0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                     0.1, 0.25, 1.0))
        self.wal_truncations = reg.counter(
            "storage", "wal_truncations",
            "Torn WAL tails repaired by truncation during replay")
        self.wal_repairs = reg.counter(
            "storage", "wal_repairs",
            "wal-repair runs that quarantined a mid-group corrupt chunk")
        self.db_write_seconds = reg.histogram(
            "storage", "db_write_seconds",
            "SQLite write-transaction latency (set/delete/batch)",
            buckets=(0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                     0.1, 0.25, 1.0))
        self.disk_faults = reg.counter(
            "storage", "disk_faults",
            "Injected disk faults by seam and kind (libs/diskchaos)",
            labels=("site", "kind"))
        self.corruption_detected = reg.counter(
            "storage", "corruption_detected",
            "CRC-guarded records that failed their checksum on read")
        self._lock = threading.Lock()
        self._wal_lat: deque[float] = deque(maxlen=self.WINDOW)
        self._db_lat: deque[float] = deque(maxlen=self.WINDOW)

    def observe_wal_fsync(self, seconds: float) -> None:
        self.wal_fsync_seconds.observe(seconds)
        with self._lock:
            self._wal_lat.append(seconds)

    def observe_db_write(self, seconds: float) -> None:
        self.db_write_seconds.observe(seconds)
        with self._lock:
            self._db_lat.append(seconds)

    @staticmethod
    def _pct(sorted_vals: list[float], q: float) -> float | None:
        if not sorted_vals:
            return None
        return sorted_vals[min(len(sorted_vals) - 1,
                               int(len(sorted_vals) * q))]

    def health(self) -> dict:
        """The storage_health RPC's metric section: exact p50/p99 over
        the recent latency windows plus the counter rollups."""
        with self._lock:
            wal = sorted(self._wal_lat)
            db = sorted(self._db_lat)
        # snapshot under the counter's own lock: a fault firing on
        # another thread may be inserting a new (site,kind) series
        with self.disk_faults._lock:
            fault_items = sorted(self.disk_faults._values.items())
        ms = 1000.0
        return {
            "wal": {
                "fsyncs": self.wal_fsync_seconds.count_value(),
                "fsync_p50_ms": (self._pct(wal, 0.50) or 0.0) * ms if wal else None,
                "fsync_p99_ms": (self._pct(wal, 0.99) or 0.0) * ms if wal else None,
                "truncations": self.wal_truncations.value(),
                "repairs": self.wal_repairs.value(),
            },
            "db": {
                "writes": self.db_write_seconds.count_value(),
                "write_p50_ms": (self._pct(db, 0.50) or 0.0) * ms if db else None,
                "write_p99_ms": (self._pct(db, 0.99) or 0.0) * ms if db else None,
            },
            "corruption_detected": self.corruption_detected.value(),
            "disk_faults": {
                "{}:{}".format(*key): v for key, v in fault_items
            },
        }


_crypto: Optional[CryptoMetrics] = None
_crypto_lock = threading.Lock()


def crypto_metrics() -> CryptoMetrics:
    """Process-global CryptoMetrics on the global registry. The device is a
    process-global resource, so its health plane is too (unlike the
    per-node Consensus/Mempool/P2P structs). Double-checked init: racing
    first calls must not register duplicate series."""
    global _crypto
    if _crypto is None:
        with _crypto_lock:
            if _crypto is None:
                _crypto = CryptoMetrics(global_registry())
    return _crypto


_sched: Optional[SchedMetrics] = None


def sched_metrics() -> SchedMetrics:
    """Process-global SchedMetrics on the global registry (same
    double-checked init discipline as crypto_metrics)."""
    global _sched
    if _sched is None:
        with _crypto_lock:
            if _sched is None:
                _sched = SchedMetrics(global_registry())
    return _sched


_mesh: Optional[MeshMetrics] = None


def mesh_metrics() -> MeshMetrics:
    """Process-global MeshMetrics on the global registry (same
    double-checked init discipline as crypto_metrics)."""
    global _mesh
    if _mesh is None:
        with _crypto_lock:
            if _mesh is None:
                _mesh = MeshMetrics(global_registry())
    return _mesh


_light_fleet: Optional[LightFleetMetrics] = None


def light_fleet_metrics() -> LightFleetMetrics:
    """Process-global LightFleetMetrics on the global registry (same
    double-checked init discipline as crypto_metrics)."""
    global _light_fleet
    if _light_fleet is None:
        with _crypto_lock:
            if _light_fleet is None:
                _light_fleet = LightFleetMetrics(global_registry())
    return _light_fleet


_netchaos: Optional[NetChaosMetrics] = None


def netchaos_metrics() -> NetChaosMetrics:
    """Process-global NetChaosMetrics on the global registry (same
    double-checked init discipline as crypto_metrics)."""
    global _netchaos
    if _netchaos is None:
        with _crypto_lock:
            if _netchaos is None:
                _netchaos = NetChaosMetrics(global_registry())
    return _netchaos


_storage: Optional[StorageMetrics] = None


def storage_metrics() -> StorageMetrics:
    """Process-global StorageMetrics on the global registry (same
    double-checked init discipline as crypto_metrics)."""
    global _storage
    if _storage is None:
        with _crypto_lock:
            if _storage is None:
                _storage = StorageMetrics(global_registry())
    return _storage


_overload: Optional[OverloadMetrics] = None


def overload_metrics() -> OverloadMetrics:
    """Process-global OverloadMetrics on the global registry (same
    double-checked init discipline as crypto_metrics)."""
    global _overload
    if _overload is None:
        with _crypto_lock:
            if _overload is None:
                _overload = OverloadMetrics(global_registry())
    return _overload
