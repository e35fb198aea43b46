"""Testnet manifest: the declarative net description the generator emits
and the runner consumes (reference: test/e2e/pkg/manifest.go, TOML shape
mirroring networks/*.toml).

The port's copy of cometbft_tpu/e2e/manifest.py. Its validation reads the
port's libs/fail.SITES and libs/chaos.MESH_CHAOS_DEVICES; the TOML it
writes is the reference's, byte for byte.
"""

from __future__ import annotations

try:
    import tomllib  # 3.11+
except ImportError:  # 3.10: the API-identical backport
    import tomli as tomllib
from dataclasses import dataclass, field


@dataclass
class NodeManifest:
    """One node's options (manifest.go Node)."""

    database: str = "sqlite"        # sqlite | memdb
    abci_protocol: str = "builtin"  # builtin | tcp | unix | grpc
    privval_protocol: str = "file"  # file (remote-signer nets use tests')
    persist_interval: int = 1
    retain_blocks: int = 0
    # p2p stream fuzzing (p2p/fuzz.py FuzzConnConfig via config test_fuzz):
    # "" disabled, else "drop" | "delay"
    fuzz: str = ""
    # process faults: kill | pause | restart (perturb.go:44-100);
    # device faults: device-kill (restart with the accelerator permanently
    # dead via a CBFT_CHAOS schedule — the node must keep committing on
    # the CPU ladder), device-flap (restart with a transient-fault
    # schedule — the supervisor must retry/re-probe back onto the device);
    # mesh faults: chip-kill[:N] (restart on a forced host-device mesh —
    # runner.MESH_DEVICE_COUNT chips, grown to cover N — with chip N's
    # fault domain permanently dead: the node must finalize on the
    # SHRUNKEN mesh, not the CPU fallback), chip-flap[:N] (chip N
    # transiently failing — breaker hysteresis must absorb it without
    # shrinking the mesh); N defaults to 1;
    # network/byzantine faults: partition (runtime 2-2 split through the
    # unsafe_net_chaos route — no progress while split, heal resumes),
    # byzantine (restart equivocating — honest nodes must commit
    # DuplicateVoteEvidence), flood (restart invalid-signature flooding —
    # honest nodes must ban the peer);
    # serving faults: light-fleet (restart with the light-client fleet
    # service enabled, drive a simulated client swarm against
    # light_verify, partition the fleet node away mid-soak, and assert
    # post-heal p99 recovery via the light_fleet metrics);
    # storage faults: crash-storm[:site] (>= 3 kill-at-crash-site /
    # respawn cycles via CBFT_CRASH_SITE — site from libs/fail.SITES,
    # default rotates through the commit-path sites; the chain must
    # commit through the storm and the node rejoin fork-free),
    # disk-fault[:kind] (arm a bounded libs/diskchaos schedule at
    # runtime via unsafe_disk_chaos — kind from the non-crash subset
    # below, default bitrot; every injected fault must be counted in
    # storage_health and the node must degrade or halt typed, never
    # serve a block that differs from the fault-free run);
    # certificate faults (cert/plane.py): cert-backfill (kill the node,
    # wipe its commit-certificate store, respawn mid-fleet while the
    # chain keeps advancing — the backfill worker must re-certify the
    # retained range from stored commits, observable via the
    # cometbft_cert_* /metrics counters and the commit_certificate RPC
    # route; requires an all-BLS net, i.e. manifest key_type bls12381);
    # overload faults (libs/overload.py): mempool-storm (respawn with a
    # SMALL mempool and drive fire-and-forget admission waves at the
    # node's RPC — the chain must keep advancing, the exempt health
    # route must answer mid-storm, and the mempool plane's sheds must
    # land on /metrics), rpc-flood (respawn with a 1-slot write budget
    # and flood concurrent broadcast_tx_commit calls — excess requests
    # must shed with the unified -32005 envelope, plane "rpc", while
    # the exempt control plane keeps serving)
    perturb: list[str] = field(default_factory=list)
    # fleet topologies: which region this node lives in (regional/hub
    # topologies wire peering and netchaos link profiles from this;
    # meaningless under topology "full")
    region: int = 0

    PERTURBATIONS = ("kill", "pause", "restart", "disconnect",
                     "device-kill", "device-flap",
                     "chip-kill", "chip-flap",
                     "partition", "byzantine", "flood", "light-fleet",
                     "crash-storm", "disk-fault", "cert-backfill",
                     "mempool-storm", "rpc-flood")
    # perturbations that take a ":<device-index>" argument
    INDEXED_PERTURBATIONS = ("chip-kill", "chip-flap")
    # disk-fault kinds an OS process can survive to keep serving (the
    # crash kinds torn_write/fsync_lie belong to the in-proc matrix,
    # tests/test_storage_crash_matrix.py, which models the power cut)
    DISK_FAULT_KINDS = ("bitrot", "enospc", "eio", "fsync_error", "slow")

    @staticmethod
    def split_perturb(p: str) -> tuple[str, str]:
        """-> (base, arg); arg is "" when the perturbation is unindexed."""
        base, _, arg = p.partition(":")
        return base, arg

    def validate(self) -> None:
        if self.region < 0:
            raise ValueError("node region cannot be negative")
        if self.database not in ("sqlite", "memdb"):
            raise ValueError(f"unknown database {self.database!r}")
        if self.abci_protocol not in ("builtin", "tcp", "unix", "grpc"):
            raise ValueError(f"unknown abci protocol {self.abci_protocol!r}")
        if self.fuzz not in ("", "drop", "delay"):
            raise ValueError(f"unknown fuzz mode {self.fuzz!r}")
        for p in self.perturb:
            base, arg = self.split_perturb(p)
            if base not in self.PERTURBATIONS:
                raise ValueError(f"unknown perturbation {p!r}")
            if not arg:
                continue
            if base == "crash-storm":
                from cometbft_tpu_torch.libs.fail import SITES

                if arg not in SITES:
                    raise ValueError(
                        f"unknown crash site in {p!r} (sites: {SITES})")
            elif base == "disk-fault":
                if arg not in self.DISK_FAULT_KINDS:
                    raise ValueError(
                        f"unknown disk-fault kind in {p!r} "
                        f"(kinds: {self.DISK_FAULT_KINDS})")
            elif base in self.INDEXED_PERTURBATIONS:
                from cometbft_tpu_torch.libs.chaos import MESH_CHAOS_DEVICES

                try:
                    idx = int(arg)
                except ValueError:
                    raise ValueError(
                        f"bad device index in {p!r}") from None
                if not 0 <= idx < MESH_CHAOS_DEVICES:
                    raise ValueError(
                        f"device index out of range in {p!r} "
                        f"(0..{MESH_CHAOS_DEVICES - 1})")
            else:
                raise ValueError(
                    f"perturbation {base!r} takes no index ({p!r})")


@dataclass
class Manifest:
    """A whole testnet (manifest.go Manifest, the options this framework
    exercises — grown to fleet scale: 50-100 node hub/regional
    topologies, netchaos link profiles, and NET-level perturbations)."""

    name: str = "testnet"
    initial_height: int = 1
    initial_state: dict[str, str] = field(default_factory=dict)
    vote_extensions_enable_height: int = 0
    target_height_delta: int = 4  # heights every node must advance
    # peer-wiring shape (runner.setup): "full" = every node peers with
    # every other (the classic 4-val net); "hub" = the first `hubs` nodes
    # form a hub mesh, spokes peer only with hubs; "regional" = full mesh
    # within a region, region gateways (first node of each region) mesh
    # across regions — the shape production gossip pathologies need;
    # "organic" = NO persistent wiring at all: node 0 is the lone seed,
    # every other node boots with an empty address book knowing only the
    # seed and must GROW its peer set through PEX discovery
    topology: str = "full"
    regions: int = 1    # regional topology: how many regions
    hubs: int = 2       # hub topology: how many hub nodes
    # named netchaos link profile for CROSS-REGION links ("" = clean
    # wire): "wan" = high-latency, "lossy-wan" = high-latency + loss.
    # Intra-region links stay clean — the intra-fast/cross-slow shape.
    link_profile: str = ""
    # NET-level perturbations (runner, after per-node perturbations):
    #   churn-storm[:pct]         rolling restarts of pct% of the fleet
    #                             (default 30), quorum preserved per wave
    #   regional-partition[:r]    cut region r (default 0) off, assert the
    #                             minority stalls while the majority
    #                             commits, heal, assert catch-up + the
    #                             heal metric
    #   byzantine-minority[:k]    restart k nodes (default n//3, capped to
    #                             keep a +2/3 honest quorum) equivocating;
    #                             honest nodes must commit evidence
    #   minority-partition[:k]    cut the LAST k nodes off (default n//4,
    #                             capped to keep a +2/3 majority quorum) —
    #                             the topology-agnostic sibling of
    #                             regional-partition (under the hub
    #                             topology the last nodes are spokes, so
    #                             the hub mesh stays intact); the majority
    #                             must commit, the cut side stall, the
    #                             heal catch it up + land on the metric
    net_perturb: list[str] = field(default_factory=list)
    # compact vote-set reconciliation (consensus.gossip_vote_summaries)
    # for every node: False = the full-gossip baseline, the control arm
    # of the amplification measurement
    vote_summaries: bool = True
    # instrumentation.height_slow_ms for every node: a height whose wall
    # time exceeds this captures a postmortem bundle (consensus/
    # timeline.py) served by the `postmortems` route; <= 0 disables
    height_slow_ms: float = 0.0
    # validator key scheme for the whole net: "ed25519" (default) or
    # "bls12381" (all-BLS — what the commit-certificate plane needs to
    # produce certs; cert-backfill perturbations require it)
    key_type: str = "ed25519"
    nodes: dict[str, NodeManifest] = field(default_factory=dict)

    TOPOLOGIES = ("full", "hub", "regional", "organic")
    KEY_TYPES = ("ed25519", "bls12381")
    NET_PERTURBATIONS = ("churn-storm", "regional-partition",
                         "byzantine-minority", "minority-partition")
    LINK_PROFILES = ("", "wan", "lossy-wan")

    def validate(self) -> None:
        if not self.nodes:
            raise ValueError("manifest has no nodes")
        if self.initial_height < 1:
            raise ValueError("initial_height must be >= 1")
        if self.topology not in self.TOPOLOGIES:
            raise ValueError(f"unknown topology {self.topology!r} "
                             f"(expected one of {self.TOPOLOGIES})")
        if self.regions < 1:
            raise ValueError("regions must be >= 1")
        if self.topology == "hub" and not 1 <= self.hubs <= len(self.nodes):
            raise ValueError(
                f"hub topology needs 1 <= hubs <= nodes, got {self.hubs}")
        if self.link_profile not in self.LINK_PROFILES:
            raise ValueError(f"unknown link_profile {self.link_profile!r} "
                             f"(expected one of {self.LINK_PROFILES})")
        if self.key_type not in self.KEY_TYPES:
            raise ValueError(f"unknown key_type {self.key_type!r} "
                             f"(expected one of {self.KEY_TYPES})")
        if self.key_type != "bls12381" and any(
                NodeManifest.split_perturb(p)[0] == "cert-backfill"
                for n in self.nodes.values() for p in n.perturb):
            raise ValueError(
                "cert-backfill perturbation requires key_type = bls12381 "
                "(certificates only exist on all-BLS validator sets)")
        if self.link_profile and self.topology != "regional":
            raise ValueError("link_profile requires the regional topology")
        for p in self.net_perturb:
            base, _, arg = p.partition(":")
            if base not in self.NET_PERTURBATIONS:
                raise ValueError(f"unknown net perturbation {p!r}")
            if arg:
                try:
                    v = int(arg)
                except ValueError:
                    raise ValueError(
                        f"bad net perturbation arg in {p!r}") from None
                if v < 0:
                    raise ValueError(f"negative arg in {p!r}")
                if base == "churn-storm" and not 1 <= v <= 100:
                    raise ValueError(
                        f"churn-storm percent out of range in {p!r}")
                if (base == "minority-partition"
                        and (v < 1 or 3 * v >= len(self.nodes))):
                    raise ValueError(
                        f"minority-partition must cut a quorum-"
                        f"preserving minority (1 <= k, 3*k < nodes) "
                        f"in {p!r}")
            if (base == "regional-partition"
                    and (self.topology != "regional" or self.regions < 2)):
                raise ValueError(
                    "regional-partition needs topology=regional with "
                    ">= 2 regions")
        for n in self.nodes.values():
            n.validate()
            if self.topology == "regional" and not 0 <= n.region < self.regions:
                raise ValueError(
                    f"node region {n.region} out of range "
                    f"(0..{self.regions - 1})")

    def region_names(self) -> dict[str, int]:
        """node name -> region index (sorted-name order, as the runner
        sees them)."""
        return {name: self.nodes[name].region for name in sorted(self.nodes)}

    # ---------------------------------------------------------- TOML

    def to_toml(self) -> str:
        def q(s: str) -> str:
            return '"' + s.replace("\\", "\\\\").replace('"', '\\"') + '"'

        out = [
            f"name = {q(self.name)}",
            f"initial_height = {self.initial_height}",
            f"vote_extensions_enable_height = {self.vote_extensions_enable_height}",
            f"target_height_delta = {self.target_height_delta}",
            f"topology = {q(self.topology)}",
            f"regions = {self.regions}",
            f"hubs = {self.hubs}",
            f"link_profile = {q(self.link_profile)}",
            "net_perturb = ["
            + ", ".join(q(p) for p in self.net_perturb) + "]",
            f"vote_summaries = {'true' if self.vote_summaries else 'false'}",
            f"height_slow_ms = {float(self.height_slow_ms)}",
            f"key_type = {q(self.key_type)}",
        ]
        if self.initial_state:
            out.append("")
            out.append("[initial_state]")
            for k in sorted(self.initial_state):
                out.append(f"{q(k)} = {q(self.initial_state[k])}")
        for name in sorted(self.nodes):
            n = self.nodes[name]
            out.append("")
            out.append(f"[node.{name}]")
            out.append(f"database = {q(n.database)}")
            out.append(f"abci_protocol = {q(n.abci_protocol)}")
            out.append(f"privval_protocol = {q(n.privval_protocol)}")
            out.append(f"persist_interval = {n.persist_interval}")
            out.append(f"retain_blocks = {n.retain_blocks}")
            out.append(f"fuzz = {q(n.fuzz)}")
            out.append(f"region = {n.region}")
            out.append(
                "perturb = [" + ", ".join(q(p) for p in n.perturb) + "]")
        return "\n".join(out) + "\n"

    @classmethod
    def from_toml(cls, text: str) -> "Manifest":
        doc = tomllib.loads(text)
        m = cls(
            name=doc.get("name", "testnet"),
            initial_height=int(doc.get("initial_height", 1)),
            initial_state={str(k): str(v)
                           for k, v in doc.get("initial_state", {}).items()},
            vote_extensions_enable_height=int(
                doc.get("vote_extensions_enable_height", 0)),
            target_height_delta=int(doc.get("target_height_delta", 4)),
            topology=str(doc.get("topology", "full")),
            regions=int(doc.get("regions", 1)),
            hubs=int(doc.get("hubs", 2)),
            link_profile=str(doc.get("link_profile", "")),
            net_perturb=list(doc.get("net_perturb", [])),
            vote_summaries=bool(doc.get("vote_summaries", True)),
            height_slow_ms=float(doc.get("height_slow_ms", 0.0)),
            key_type=str(doc.get("key_type", "ed25519")),
        )
        for name, nd in doc.get("node", {}).items():
            m.nodes[name] = NodeManifest(
                database=nd.get("database", "sqlite"),
                abci_protocol=nd.get("abci_protocol", "builtin"),
                privval_protocol=nd.get("privval_protocol", "file"),
                persist_interval=int(nd.get("persist_interval", 1)),
                retain_blocks=int(nd.get("retain_blocks", 0)),
                fuzz=str(nd.get("fuzz", "")),
                perturb=list(nd.get("perturb", [])),
                region=int(nd.get("region", 0)),
            )
        m.validate()
        return m
