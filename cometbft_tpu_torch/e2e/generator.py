"""Random manifest generation over the config-matrix space.

Reference: test/e2e/generator/generate.go:20-66 — uniform/weighted/
probabilistic choices over topology, databases, ABCI transports, initial
state, and a perturbation schedule, seeded for reproducibility.

The port's copy of cometbft_tpu/e2e/generator.py: for the same seed,
generate_manifests and generate_fleet_manifest give the reference's
manifests.
"""

from __future__ import annotations

import random

from cometbft_tpu_torch.e2e.manifest import Manifest, NodeManifest

TOPOLOGIES = ("single", "quad")  # node counts 1 / 4 (generate.go "topology")
DATABASES = ("sqlite", "memdb")
ABCI_PROTOCOLS = ("builtin", "tcp", "unix", "grpc")
INITIAL_HEIGHTS = (1, 1000)
INITIAL_STATES: tuple[dict, ...] = (
    {},
    {"initial01": "a", "initial02": "b", "initial03": "c"},
)
VOTE_EXT_HEIGHT_OFFSETS = (0, 2)  # 0 = disabled
# perturbation -> probability a node gets it (generate.go nodePerturbations;
# "disconnect" needs a network layer OS processes don't have — the in-proc
# perturbation matrix, tests/test_e2e_perturb.py, covers it). device-kill /
# device-flap restart a node with a CBFT_CHAOS schedule armed (runner.py):
# the accelerator dies or flaps and the verify ladder must keep committing.
# partition splits the net 2-2 at runtime (unsafe_net_chaos route);
# byzantine/flood restart the node adversarially (consensus/byzantine.py)
# and assert detection via evidence_committed / peer_bans metrics.
# light-fleet restarts a node with the serving plane enabled, drives a
# client swarm at light_verify, partitions the fleet node mid-soak, and
# asserts post-heal p99 via the light_fleet metrics.
# crash-storm cycles >= 3 kill-at-crash-site/respawns on one node
# (CBFT_CRASH_SITE); disk-fault arms a bounded diskchaos schedule at
# runtime (unsafe_disk_chaos) and asserts the faults were counted and
# the node degraded or halted typed — never served a differing block.
# mempool-storm respawns the node with a small mempool and drives
# admission waves at its RPC (the chain must keep advancing, sheds must
# land on /metrics); rpc-flood respawns with a 1-slot write budget and
# floods concurrent commit-wait writes (excess must shed -32005 while
# the exempt control plane keeps serving). cert-backfill kills a node,
# wipes its commit-certificate store, and respawns it mid-fleet — the
# backfill worker must re-certify the retained range (needs an all-BLS
# net: drawing it flips the manifest to key_type bls12381).
PERTURBATIONS = {"kill": 0.1, "pause": 0.1, "restart": 0.1,
                 "device-kill": 0.05, "device-flap": 0.05,
                 "chip-kill:1": 0.05, "chip-flap:1": 0.05,
                 "partition": 0.05, "byzantine": 0.05, "flood": 0.05,
                 "light-fleet": 0.05,
                 "crash-storm": 0.05, "crash-storm:abci.apply": 0.03,
                 "disk-fault:bitrot": 0.04, "disk-fault:enospc": 0.03,
                 "disk-fault:slow": 0.03,
                 "mempool-storm": 0.05, "rpc-flood": 0.04,
                 "cert-backfill": 0.05}
# perturbations that kill + respawn the OS process (a memdb node would
# lose its stores while its out-of-process app keeps state); compared by
# BASE name (chip-kill:N respawns too)
RESPAWN_PERTURBATIONS = {"kill", "restart", "device-kill", "device-flap",
                         "chip-kill", "chip-flap", "byzantine", "flood",
                         "light-fleet", "crash-storm", "disk-fault",
                         "mempool-storm", "rpc-flood", "cert-backfill"}


def generate_manifest(rng: random.Random, index: int) -> Manifest:
    topology = rng.choice(TOPOLOGIES)
    n = {"single": 1, "quad": 4}[topology]
    initial_height = rng.choice(INITIAL_HEIGHTS)
    m = Manifest(
        name=f"gen-{index:03d}-{topology}",
        initial_height=initial_height,
        initial_state=dict(rng.choice(INITIAL_STATES)),
        vote_extensions_enable_height=(
            initial_height + rng.choice(VOTE_EXT_HEIGHT_OFFSETS)
            if rng.random() < 0.5 else 0),
    )
    # a slice of the matrix runs the reconciliation-off control arm
    if rng.random() < 0.15:
        m.vote_summaries = False
    # occasionally wire the quad as a small regional net (2 regions, wan
    # cross-links): the matrix keeps the fleet plumbing honest at a size
    # CI can afford — the 50-100 node shapes are deliberate
    # (generate_fleet_manifest), not rolled
    if n == 4 and rng.random() < 0.15:
        m.topology = "regional"
        m.regions = 2
        m.link_profile = rng.choice(("wan", "lossy-wan"))
    for i in range(n):
        node = NodeManifest(
            database=rng.choice(DATABASES),
            abci_protocol=rng.choice(ABCI_PROTOCOLS),
            persist_interval=rng.choice((0, 1, 5)),
            retain_blocks=rng.choice((0, 20)),
            region=(i % 2 if m.topology == "regional" else 0),
        )
        if n >= 4:  # perturbing a 1-node net just halts it
            for p, prob in PERTURBATIONS.items():
                if rng.random() < prob:
                    node.perturb.append(p)
            # occasional always-on stream fuzzing rides alongside
            # (reference generator testFuzz); latency-only so a fuzzed
            # node never costs the quorum its liveness margin
            if rng.random() < 0.05:
                node.fuzz = "delay"
        m.nodes[f"node{i}"] = node
    # at most one perturbed node per net: +2/3 of 4 must stay live while a
    # perturbation is in flight
    perturbed = [name for name, nd in m.nodes.items() if nd.perturb]
    for name in perturbed[1:]:
        m.nodes[name].perturb = []
    # a kill/restart wipes a memdb node's stores while its out-of-process
    # app keeps state -> the ABCI handshake correctly refuses an app ahead
    # of the store. Such nodes need persistent storage (the reference
    # matrix only has persistent engines, generate.go nodeDatabases);
    # pause never loses the process, so memdb+pause stays in the matrix.
    if perturbed:
        nd = m.nodes[perturbed[0]]
        if nd.database == "memdb" and {
                p.partition(":")[0] for p in nd.perturb
        } & RESPAWN_PERTURBATIONS:
            nd.database = "sqlite"
        # certificates only exist on all-BLS validator sets, so drawing
        # cert-backfill flips the whole net's key scheme
        if any(p.partition(":")[0] == "cert-backfill" for p in nd.perturb):
            m.key_type = "bls12381"
    m.validate()
    return m


def generate_manifests(seed: int, count: int) -> list[Manifest]:
    rng = random.Random(seed)
    return [generate_manifest(rng, i) for i in range(count)]


# ------------------------------------------------------------- fleets
# Deterministic fleet-scale manifests (50-100 node nets are booted on
# purpose by tests/bench, not rolled from the random matrix — a 100-node
# net is a deliberate resource commitment, runner._resource_guard gates
# it). Hub/spoke and regional topologies with the intra-region-fast /
# cross-region-slow link shape (runner.LINK_PROFILES).

FLEET_TOPOLOGIES = ("full", "hub", "regional", "organic")


def generate_fleet_manifest(
    n_nodes: int,
    topology: str = "regional",
    regions: int = 4,
    hubs: int = 4,
    link_profile: str = "",
    net_perturb: tuple[str, ...] = (),
    target_height_delta: int = 4,
    name: str = "",
    vote_summaries: bool = True,
    height_slow_ms: float = 0.0,
) -> Manifest:
    """One fleet testnet: `n_nodes` sqlite+builtin validators wired by
    `topology`, regions assigned round-robin, with the given net-level
    perturbation schedule. memdb is excluded (churn storms respawn
    processes) and out-of-process ABCI apps are excluded (they would
    double the fleet's process count for no gossip-plane coverage)."""
    if topology not in FLEET_TOPOLOGIES:
        raise ValueError(f"unknown fleet topology {topology!r}")
    if link_profile and topology != "regional":
        # loudly, not silently: a clean-wire run misread as WAN-resilient
        # is exactly the misconfiguration Manifest.validate exists for
        raise ValueError(
            f"link_profile {link_profile!r} requires the regional "
            f"topology (got {topology!r})")
    regions = regions if topology == "regional" else 1
    m = Manifest(
        name=name or f"fleet-{n_nodes:03d}-{topology}",
        topology=topology,
        regions=regions,
        hubs=min(hubs, n_nodes),
        link_profile=link_profile,
        net_perturb=list(net_perturb),
        target_height_delta=target_height_delta,
        vote_summaries=vote_summaries,
        height_slow_ms=height_slow_ms,
    )
    for i in range(n_nodes):
        m.nodes[f"node{i:03d}"] = NodeManifest(
            database="sqlite", abci_protocol="builtin",
            region=i % regions,
        )
    m.validate()
    return m
