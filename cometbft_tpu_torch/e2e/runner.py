"""Config-matrix runner: set up, start, perturb, and verify one manifest's
testnet of real OS processes over real TCP.

Reference: test/e2e/runner (main.go Setup/Start/Perturb/Test/Cleanup;
perturb.go:44-100). Differences are environmental: nodes are processes on
one host (no docker network, so "disconnect" lives in the in-proc
perturbation matrix instead), and out-of-process ABCI apps are one
`abci-cli kvstore` server per node on the manifest's transport.

The port's copy of cometbft_tpu/e2e/runner.py. Where it departs:

  backend      setup writes `backend` (default "gpu": every node verifies
               on the card) into each home, where the reference pins
               "cpu"; a child runs where its home says. _env sets neither
               JAX_PLATFORMS nor CBFT_NO_PALLAS. A "gpu" home also turns
               consensus.batch_vote_verification on, so that peer votes
               reach the card (the reference's default is the serial
               host path).
  kernels      run_manifest builds every CUDA source once in the parent
               (node.build_kernels: one nvcc a source, all together)
               before it spawns a node on "gpu", so no child runs nvcc.
  guard        _resource_guard also holds the card's free memory
               (torch.cuda.mem_get_info) against NODE_CARD_MB a node.
  logs         each node's output goes to <home>/node.log (appended over
               respawns), where the reference discards it.
  device-kill  there is no CPU rung: the killed node must halt typed (exit
               non-zero, or stop its consensus or block sync) with the
               DeviceOpFailed / DeviceUnavailable in its log, its
               crypto_health "device" supervisor failed with a breaker
               that is not closed, while the others commit; it is then
               respawned without the schedule and catches up.
  device-flap  absorbed in place on the node's own backend: the flap arms
               retry_max_attempts = DEVICE_FLAP_RETRIES (four transient
               dispatch firings need four retries) and keeps the breaker's
               default threshold (a timed-out fetch is issued again while
               the breaker admits it); failures and retries are counted,
               and the breaker ends closed.
  chip-*       the child's fault domains are N domains of its one card
               (parallel/mesh.domains_env, VerifyMesh([cuda:0] * N)); the
               checks read the port's mesh metrics.
  hooks        setup and run_manifest take `backend`, `node_config(name,
               cfg)` (a caller's edit of each home before it is saved),
               `after_perturb(net, record)` (run once a node's
               perturbation has recovered and been checked) and
               `before_stop(net)` (run on the live net after the checks
               and the net report);
               run_manifest returns what it measured: each perturbation's
               start and recovery heights and seconds, and the common
               height.
"""

from __future__ import annotations

import concurrent.futures
import glob
import json
import os
import signal
import subprocess
import sys
import time
import urllib.parse
import urllib.request
from dataclasses import dataclass, field

from cometbft_tpu_torch.e2e.manifest import Manifest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


class RunError(Exception):
    pass


# ---------------------------------------------------------------- fleet
# Named netchaos link-profile bodies (p2p/netchaos.py profile syntax) for
# the regional topology's cross-region links: intra-region links stay
# clean, cross-region links pay WAN latency (and, for lossy-wan, loss).
LINK_PROFILES = {
    "wan": "latency:0.03;jitter:0.01",
    "lossy-wan": "latency:0.05;jitter:0.02;drop:0.005",
}

# resource-guard knobs (env-overridable; the error message names them):
# estimated per-node cost of one OS-process node on this host
NODE_RSS_MB = int(os.environ.get("CBFT_E2E_NODE_RSS_MB", "400"))
NODE_FDS = int(os.environ.get("CBFT_E2E_NODE_FDS", "96"))
# device memory one "gpu" node holds on the card: its CUDA context, the
# kernels' modules and the key tables; chip_smoke.py's e2e4 measured 710 MB
# a node on [NVIDIA H100 80GB HBM3, 700.00 W] (PERF.md), rounded up here
NODE_CARD_MB = 768


def _ephemeral_port_range() -> tuple[int, int]:
    try:
        with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
            lo, hi = (int(x) for x in f.read().split())
            return lo, hi
    except (OSError, ValueError):
        return 32768, 60999  # the Linux default


def _resource_guard(n_nodes: int, base_port: int | None = None,
                    card_nodes: int = 0) -> None:
    """Refuse to launch a fleet the host cannot hold — BEFORE node 0
    spawns, with an error naming the knob, instead of wedging mid-boot at
    node 70. Estimates are deliberately conservative; operators with
    bigger boxes override via env (CBFT_E2E_NODE_RSS_MB /
    CBFT_E2E_NODE_FDS) or disable with CBFT_E2E_RESOURCE_GUARD=0.
    `card_nodes` nodes on the "gpu" backend must also fit the card's free
    memory at NODE_CARD_MB each."""
    if os.environ.get("CBFT_E2E_RESOURCE_GUARD", "1") == "0":
        return
    # Listen ports colliding with the kernel's EPHEMERAL range is the
    # classic wedge-at-node-48: another node's outbound conn grabs the
    # port a later node was about to bind (found the hard way at 50
    # nodes — ~750 outbound conns vs. 150 pending listens is a birthday
    # problem). The net spans [base, base+2000+n] (p2p/rpc/abci
    # strides). Small nets keep their historical ports: a handful of
    # listens against a handful of conns is a negligible exposure.
    if base_port is not None and n_nodes >= 16:
        eph_lo, eph_hi = _ephemeral_port_range()
        span_hi = base_port + 2000 + n_nodes
        if base_port <= eph_hi and span_hi >= eph_lo:
            raise RunError(
                f"refusing to launch {n_nodes} nodes on base_port "
                f"{base_port}: the net's port span [{base_port}, {span_hi}]"
                f" overlaps the kernel ephemeral range [{eph_lo}, {eph_hi}]"
                f" — a peer's outbound conn can steal a listen port "
                f"mid-boot; pick base_port so the span ends below "
                f"{eph_lo} (or set CBFT_E2E_RESOURCE_GUARD=0)")
    # file descriptors: every node holds sockets to its peers + stores
    try:
        import resource

        soft, _ = resource.getrlimit(resource.RLIMIT_NOFILE)
    except Exception:  # noqa: BLE001 - exotic platform: skip the fd check
        soft = 0
    need_fds = n_nodes * NODE_FDS
    if soft and need_fds > soft:
        raise RunError(
            f"refusing to launch {n_nodes} nodes: estimated {need_fds} fds "
            f"(~{NODE_FDS}/node, knob CBFT_E2E_NODE_FDS) exceeds the "
            f"RLIMIT_NOFILE soft limit {soft}; raise `ulimit -n` or set "
            f"CBFT_E2E_RESOURCE_GUARD=0 to override")
    # the card: each "gpu" node holds its own CUDA context and tables
    if card_nodes:
        import torch

        if not torch.cuda.is_available():
            raise RunError(f"refusing to launch {card_nodes} nodes on the \"gpu\" "
                           f"backend: no CUDA device")
        free, _ = torch.cuda.mem_get_info()
        need = card_nodes * NODE_CARD_MB
        if need > free // 2**20:
            raise RunError(
                f"refusing to launch {card_nodes} nodes on the card: estimated "
                f"{need} MB (~{NODE_CARD_MB} MB/node) "
                f"exceeds its {free // 2**20} MB free; shrink the net or set "
                f"CBFT_E2E_RESOURCE_GUARD=0 to override")
    # memory: each node is a full python+torch process
    avail_mb = 0
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    avail_mb = int(line.split()[1]) // 1024
                    break
    except OSError:
        return  # no /proc: skip the memory check
    need_mb = n_nodes * NODE_RSS_MB
    if avail_mb and need_mb > avail_mb:
        raise RunError(
            f"refusing to launch {n_nodes} nodes: estimated {need_mb} MB "
            f"(~{NODE_RSS_MB} MB/node, knob CBFT_E2E_NODE_RSS_MB) exceeds "
            f"the {avail_mb} MB available; shrink the fleet or set "
            f"CBFT_E2E_RESOURCE_GUARD=0 to override")


def _topology_peers(manifest: Manifest, names: list[str], i: int) -> list[int]:
    """Which peers node i dials persistently, by topology. "full" is the
    classic everyone-dials-everyone; "hub" meshes the first `hubs` nodes
    and hangs every spoke off ALL hubs; "regional" meshes each region
    internally and meshes the region GATEWAYS (first node per region)
    across regions — cross-region traffic concentrates on the gateway
    links the netchaos profiles degrade. "organic" wires NOTHING: every
    node except the lone seed (node 0) boots with an empty address book
    and grows its peer set through PEX discovery alone."""
    n = len(names)
    others = [j for j in range(n) if j != i]
    if manifest.topology == "organic":
        return []
    if manifest.topology == "hub":
        hubs = list(range(min(manifest.hubs, n)))
        if i in hubs:
            return [j for j in hubs if j != i]
        return hubs
    if manifest.topology == "regional":
        regs = [manifest.nodes[nm].region for nm in names]
        # TWO gateways per region (the first two nodes), meshed across
        # regions: killing one gateway — a churn storm will — must not
        # partition the fleet
        gateways: dict[int, list[int]] = {}
        for j, r in enumerate(regs):
            gateways.setdefault(r, [])
            if len(gateways[r]) < 2:
                gateways[r].append(j)
        peers = [j for j in others if regs[j] == regs[i]]
        if i in gateways.get(regs[i], []):
            peers += [g for r, gs in sorted(gateways.items())
                      if r != regs[i] for g in gs]
        return peers
    return others


def _netchaos_spec(manifest: Manifest, names: list[str],
                   node_ids: list[str]) -> str:
    """The per-node p2p.chaos schedule for a regional fleet: the named
    link profile, every node's region, and one cross-region link mapping
    per region pair. Empty when the manifest asks for a clean wire."""
    if manifest.topology != "regional" or not manifest.link_profile:
        return ""
    prof = manifest.link_profile
    parts = [f"profile.{prof}={LINK_PROFILES[prof]}"]
    parts += [f"region={node_ids[i]}:r{manifest.nodes[nm].region}"
              for i, nm in enumerate(names)]
    regions = sorted({manifest.nodes[nm].region for nm in names})
    parts += [f"link.r{a}-r{b}={prof}"
              for ai, a in enumerate(regions) for b in regions[ai + 1:]]
    return ",".join(parts)


@dataclass
class _Net:
    manifest: Manifest
    dir: str
    base_port: int
    homes: list[str] = field(default_factory=list)
    node_procs: list = field(default_factory=list)
    app_procs: list = field(default_factory=list)

    def rpc_port(self, i: int) -> int:
        return self.base_port + 1000 + i


def _env() -> dict:
    return dict(os.environ, PYTHONUNBUFFERED="1")


def setup(manifest: Manifest, out_dir: str, base_port: int, backend: str = "gpu",
          node_config=None) -> _Net:
    """testnet homes + per-node config per the manifest (runner/setup.go).
    Every node verifies on `backend`; node_config(name, cfg), when given,
    edits each node's Config before it is saved."""
    from cometbft_tpu_torch.config import Config
    from cometbft_tpu_torch.node import init_files
    from cometbft_tpu_torch.p2p.key import NodeKey
    from cometbft_tpu_torch.privval.file_pv import FilePV
    from cometbft_tpu_torch.types.genesis import GenesisDoc, GenesisValidator
    from cometbft_tpu_torch.utils import cmttime

    net = _Net(manifest=manifest, dir=out_dir, base_port=base_port)
    names = sorted(manifest.nodes)
    net.homes = [os.path.join(out_dir, name) for name in names]
    pvs, node_keys = [], []
    for home in net.homes:
        cfg = Config(home=home)
        os.makedirs(os.path.join(home, "config"), exist_ok=True)
        os.makedirs(os.path.join(home, "data"), exist_ok=True)
        pvs.append(FilePV.load_or_generate(
            cfg.priv_validator_key_path(), cfg.priv_validator_state_path(),
            key_type=manifest.key_type))
        node_keys.append(NodeKey.load_or_gen(cfg.node_key_path()))

    gdoc = GenesisDoc(
        genesis_time=cmttime.canonical_now_ms(),
        chain_id=manifest.name,
        initial_height=manifest.initial_height,
        validators=[
            GenesisValidator(address=pv.get_pub_key().address(),
                             pub_key=pv.get_pub_key(), power=1, name=nm)
            for nm, pv in zip(names, pvs)
        ],
        app_state=json.dumps(manifest.initial_state).encode(),
    )
    if manifest.vote_extensions_enable_height:
        gdoc.consensus_params.abci.vote_extensions_enable_height = (
            manifest.vote_extensions_enable_height)
    if manifest.key_type != "ed25519":
        gdoc.consensus_params.validator.pub_key_types = [manifest.key_type]
    gdoc.validate_and_complete()

    peer_addrs = [f"{node_keys[i].id()}@127.0.0.1:{base_port + i}"
                  for i in range(len(names))]
    node_ids = [nk.id() for nk in node_keys]
    chaos_spec = _netchaos_spec(manifest, names, node_ids)
    for i, (name, home) in enumerate(zip(names, net.homes)):
        nm = manifest.nodes[name]
        cfg = Config(home=home)
        cfg.base.moniker = name
        cfg.base.db_backend = nm.database
        cfg.p2p.laddr = f"tcp://127.0.0.1:{base_port + i}"
        cfg.rpc.laddr = f"tcp://127.0.0.1:{net.rpc_port(i)}"
        cfg.p2p.persistent_peers = ",".join(
            peer_addrs[j] for j in _topology_peers(manifest, names, i))
        if manifest.topology == "organic" and i > 0:
            # bootstrap = the seed's address and nothing else; the rest
            # of the peer set must be LEARNED over PEX
            cfg.p2p.seeds = peer_addrs[0]
        if manifest.topology == "organic":
            # boot-time convergence rides ensure-peers; the 30 s
            # production cadence would dominate the bootstrap clock
            cfg.p2p.pex_ensure_interval = 2.0
        # a fleet hub/gateway takes far more inbound conns than the
        # 40-peer default allows
        cfg.p2p.max_num_inbound_peers = max(40, len(names) + 8)
        if chaos_spec:
            # every node arms the same region/profile map: partition and
            # profile enforcement is write-side, so each process must
            # throttle its OWN outbound links
            cfg.p2p.chaos = chaos_spec
        cfg.crypto.backend = backend
        if backend == "gpu":
            # peer votes staged and verified in batched flushes on the
            # card; the reference's default is the serial path, one host
            # verify a vote
            cfg.consensus.batch_vote_verification = True
        cfg.consensus.timeout_commit = 0.1
        # heightline on every node: the run report's consensus anatomy
        # section needs the per-height rings, and the recorder's armed
        # cost is a few dict writes per height
        cfg.instrumentation.timeline = True
        cfg.instrumentation.height_slow_ms = manifest.height_slow_ms
        # reconciliation arm: the manifest picks the protocol (the
        # full-gossip control arm measures amplification WITHOUT it); a
        # fleet repairs vote views on a tighter cadence than the 0.5 s
        # single-digit-net default
        cfg.consensus.gossip_vote_summaries = manifest.vote_summaries
        if manifest.vote_summaries:
            cfg.consensus.vote_summary_interval = 0.1
        # perturbations drive the runtime control routes (partition arm/
        # heal); test-scale ban windows so a flood perturbation's bans
        # decay before the final catch-up deadline
        cfg.rpc.unsafe = True
        cfg.p2p.ban_duration = 5.0
        cfg.p2p.ban_max_duration = 30.0
        if nm.fuzz:
            cfg.p2p.test_fuzz = True
            cfg.p2p.test_fuzz_mode = nm.fuzz
        if nm.abci_protocol == "builtin":
            cfg.base.proxy_app = "kvstore"
        elif nm.abci_protocol == "tcp":
            cfg.base.proxy_app = f"tcp://127.0.0.1:{base_port + 2000 + i}"
        elif nm.abci_protocol == "unix":
            cfg.base.proxy_app = f"unix://{home}/app.sock"
        elif nm.abci_protocol == "grpc":
            cfg.base.proxy_app = f"grpc://127.0.0.1:{base_port + 2000 + i}"
        if node_config is not None:
            node_config(name, cfg)
        cfg.save()
        with open(cfg.genesis_path(), "w") as f:
            f.write(gdoc.to_json())
    return net


# device-fault perturbation schedules (libs/chaos.py syntax), the
# reference's: the perturbed node restarts on its own backend with the
# schedule armed from config, so its supervisor and breaker run for real
# (ops/dispatch.py, the single-card path's "device" supervisor). The port
# has no CPU rung: a killed card halts the node typed; a flapping one is
# absorbed in place. pallas.trace is accepted and never fires (the port has
# no Pallas trace).
DEVICE_KILL_CHAOS = ("ed25519.dispatch=permanent,sr25519.dispatch=permanent,"
                     "pallas.trace=permanent")
DEVICE_FLAP_CHAOS = ("ed25519.dispatch=transient:4,ed25519.fetch=timeout:1,"
                     "sr25519.dispatch=transient:2")
# the flap's in-place retries: the schedule fires four transients in a row
# at ed25519.dispatch, which the default two retries cannot cover
DEVICE_FLAP_RETRIES = 4
# what a halted node's log names
DEVICE_FAULT_NAMES = ("DeviceOpFailed", "DeviceUnavailable")

# mesh perturbations (chip-kill[:N] / chip-flap[:N]): the node restarts
# with N fault domains on its card (parallel/mesh.domains_env) so the
# verify mesh activates, and ONLY domain N is scheduled to fail — the run
# must finalize on the SHRUNKEN mesh (kill) or the full mesh after breaker
# hysteresis absorbs the flap, never on the all-dead fallback. Asserted via
# the mesh metrics.
MESH_DEVICE_COUNT = 4
DEFAULT_CHIP_INDEX = 1


def _chip_kill_chaos(dev: int) -> str:
    return (f"ed25519.dispatch.dev{dev}=permanent,"
            f"sr25519.dispatch.dev{dev}=permanent")


def _chip_flap_chaos(dev: int) -> str:
    return (f"ed25519.dispatch.dev{dev}=transient:6,"
            f"sr25519.dispatch.dev{dev}=transient:2")


def _boot_staggered(net: _Net, wave: int = 12, pause: float = 1.0) -> None:
    """Spawn every node in waves: 50 simultaneous torch imports would
    stall every node's dial window (thundering herd)."""
    for w in range(0, len(net.homes), wave):
        net.node_procs += [_spawn_node(h) for h in net.homes[w:w + wave]]
        if w + wave < len(net.homes):
            time.sleep(pause)


# how a node process starts: `python <NODE_ARGV> --home H start`. A harness
# may put its own entry in front of the package's (the same argv after it)
NODE_ARGV = ["-m", "cometbft_tpu_torch"]


def _node_log(home: str) -> str:
    return os.path.join(home, "node.log")


def _spawn_node(home: str, mesh_devices: int = 0,
                extra_env: dict | None = None):
    env = _env()
    if extra_env:
        env.update(extra_env)
    if mesh_devices:
        # N fault domains on the child's card (the reference's
        # host_mesh_env, for torch)
        from cometbft_tpu_torch.parallel.mesh import domains_env

        env = domains_env(env, mesh_devices)
    with open(_node_log(home), "ab") as log:
        return subprocess.Popen(
            [sys.executable, *NODE_ARGV, "--home", home, "start"],
            cwd=REPO, env=env, stdout=log,
            stderr=subprocess.STDOUT, start_new_session=True)


def _arm_device_chaos(home: str, spec: str, kill: bool = True) -> None:
    """Arm `spec` on the node's on-disk config, on its own backend
    (survives the respawn; CBFT_CHAOS env would work too but the config
    knob keeps the whole schedule visible in the node's home). A killed
    device should sideline fast (breaker threshold 1); a flap keeps the
    default threshold and takes DEVICE_FLAP_RETRIES in-place retries. An
    empty spec disarms and restores the defaults."""
    from cometbft_tpu_torch.config import Config

    cfg = Config.load(home)
    default = Config().crypto
    cfg.crypto.chaos = spec
    cfg.crypto.breaker_failure_threshold = (
        1 if spec and kill else default.breaker_failure_threshold)
    cfg.crypto.retry_max_attempts = (
        DEVICE_FLAP_RETRIES if spec and not kill else default.retry_max_attempts)
    cfg.save()


def _log_size(home: str) -> int:
    try:
        return os.path.getsize(_node_log(home))
    except OSError:
        return 0


def _log_names_device_fault(home: str, since: int) -> bool:
    """Does the node's log past byte `since` name a device fault?"""
    try:
        with open(_node_log(home), "rb") as f:
            f.seek(since)
            text = f.read().decode("utf-8", "replace")
    except OSError:
        return False
    return any(name in text for name in DEVICE_FAULT_NAMES)


def _arm_chip_chaos(home: str, spec: str, kill: bool) -> None:
    """Mesh perturbation config: device backend + mesh enabled + the
    per-chip schedule. A killed chip should evict fast (threshold 1); a
    flapping chip must be ABSORBED by hysteresis, so the flap keeps the
    default threshold and in-place transient retries."""
    from cometbft_tpu_torch.config import Config

    cfg = Config.load(home)
    cfg.crypto.chaos = spec
    cfg.crypto.mesh_enabled = True
    cfg.crypto.mesh_min_devices = 2
    if kill:
        cfg.crypto.breaker_failure_threshold = 1
    cfg.save()


def _arm_light_fleet(home: str) -> None:
    """Enable the light-client fleet service (light/fleet.py) on the
    node's on-disk config — the serving plane boots with the node."""
    from cometbft_tpu_torch.config import Config

    cfg = Config.load(home)
    cfg.light.fleet_enabled = True
    cfg.save()


def _fleet_swarm(net: _Net, i: int, requests: int, seed: int = 0) -> list[float]:
    """A simulated light-client swarm against node i's light_verify
    route: `requests` calls over a deterministic spread of committed
    heights. Returns sorted per-request latencies; raises RunError on a
    failed verification (a cache-served header the fleet could not
    produce is a serving-plane bug, not a flake)."""
    lats: list[float] = []
    top = max(1, _height(net, i) - 1)
    for j in range(requests):
        hq = 1 + (seed + j * 7) % top
        t0 = time.time()
        doc = _rpc(net, i, f"light_verify?height={hq}", timeout=15.0)
        if "result" not in doc:
            raise RunError(f"light_verify failed at height {hq}: {doc}")
        lats.append(time.time() - t0)
    lats.sort()
    return lats


def _arm_byzantine(home: str, behavior: str) -> None:
    """Point the node's on-disk config at an adversarial consensus mode
    (consensus/byzantine.py); empty behavior disarms."""
    from cometbft_tpu_torch.config import Config

    cfg = Config.load(home)
    cfg.consensus.byzantine = behavior
    cfg.save()


def _metrics_text(net: _Net, i: int, timeout=3.0) -> str:
    url = f"http://127.0.0.1:{net.rpc_port(i)}/metrics"
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.read().decode()
    except Exception:  # noqa: BLE001 - node not up / metrics not ready
        return ""


def _metric_value(text: str, name: str) -> float:
    """Sum every series of a metric in a Prometheus exposition."""
    total, seen = 0.0, False
    for line in text.splitlines():
        if line.startswith(name) and (len(line) == len(name)
                                      or line[len(name)] in " {"):
            try:
                total += float(line.rsplit(" ", 1)[1])
                seen = True
            except (ValueError, IndexError):
                continue
    return total if seen else 0.0


def _node_ids(net: _Net) -> list[str]:
    from cometbft_tpu_torch.config import Config
    from cometbft_tpu_torch.p2p.key import NodeKey

    return [NodeKey.load_or_gen(Config(home=h).node_key_path()).id()
            for h in net.homes]


def _spawn_app(addr: str):
    return subprocess.Popen(
        [sys.executable, "-m", "cometbft_tpu_torch.abci.cli",
         "--address", addr, "kvstore"],
        cwd=REPO, env=_env(), stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL, start_new_session=True)


def _rpc(net: _Net, i: int, route: str, timeout=2.0):
    url = f"http://127.0.0.1:{net.rpc_port(i)}/{route}"
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.load(r)


def _height(net: _Net, i: int) -> int:
    try:
        return int(_rpc(net, i, "status")["result"]["sync_info"]
                   ["latest_block_height"])
    except Exception:  # noqa: BLE001 - node not up yet
        return -1


def _wait(cond, timeout: float, what: str) -> None:
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return
        time.sleep(0.3)
    raise RunError(f"timed out waiting for {what}")


def _kill(proc) -> None:
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except (ProcessLookupError, PermissionError):
        pass
    try:
        proc.wait(timeout=5)
    except subprocess.TimeoutExpired:
        pass


def _fleet_rollup(report: dict, net: _Net, names: list[str]) -> dict:
    """Aggregate per-node net_report forensics into ONE fleet view: wire
    totals, gossip accounting (votes sent vs. needed — the amplification
    headline), heal latency, and per-node heights. Every field degrades
    to None/partial when a node died — the rollup reports, it never
    raises."""
    heights, send_bytes, recv_bytes = {}, 0, 0
    g_tot: dict[str, int] = {}
    heal = []
    reporting = 0
    book_sizes: dict[str, int] = {}
    for i, name in enumerate(names):
        doc = report["nodes"].get(name) or {}
        if "error" in doc:
            continue
        reporting += 1
        heights[name] = _height(net, i)
        totals = doc.get("totals") or {}
        send_bytes += totals.get("send_bytes", 0)
        recv_bytes += totals.get("recv_bytes", 0)
        gossip = doc.get("gossip") or {}
        for k, v in (gossip.get("totals") or {}).items():
            g_tot[k] = g_tot.get(k, 0) + v
        disc = doc.get("discovery") or {}
        if disc:
            book_sizes[name] = disc.get("size", 0)
        hs = (doc.get("net_chaos") or {}).get("last_heal_seconds")
        if hs:
            heal.append(hs)
    hs_vals = [h for h in heights.values() if h > 0]
    span = ((max(hs_vals) - net.manifest.initial_height)
            if hs_vals else 0)
    needed = g_tot.get("votes_recv_needed", 0)
    return {
        "n_nodes": len(names),
        "nodes_reporting": reporting,
        "topology": net.manifest.topology,
        "heights": heights,
        "wire_send_bytes_total": send_bytes,
        "wire_recv_bytes_total": recv_bytes,
        "wire_bytes_per_height_per_node": (
            round(send_bytes / span / max(1, reporting), 1)
            if span > 0 and reporting else None),
        "gossip_totals": g_tot,
        "gossip_votes_per_vote_needed": (
            round(g_tot.get("votes_recv", 0) / needed, 3)
            if needed else None),
        "partition_heal_seconds_max": max(heal) if heal else None,
        # discovery plane: how big each node's PEX book grew — under the
        # organic topology this IS the convergence evidence (every entry
        # was learned over the wire, none were wired by the runner)
        "addrbook_sizes": book_sizes or None,
    }


def _heightline_section(net: _Net, names: list[str]) -> dict:
    """The run report's consensus-anatomy section: each live node's
    `consensus_timeline` ring plus the skew-aligned fleet aggregate
    (consensus/timeline.aggregate) and postmortem summaries.  Per-node
    pull failures are recorded, never raised — like the wire section,
    this is an artifact."""
    from cometbft_tpu_torch.consensus import timeline

    docs, per_node = [], {}
    for i, name in enumerate(names):
        try:
            doc = _rpc(net, i, "consensus_timeline",
                       timeout=5.0).get("result", {})
        except Exception as e:  # noqa: BLE001
            per_node[name] = {"error": str(e)}
            continue
        doc["name"] = name
        docs.append(doc)
        entry = {"node_id": doc.get("node_id", ""),
                 "heights": len(doc.get("heights", [])),
                 "enabled": doc.get("enabled", False)}
        try:
            pm = _rpc(net, i, "postmortems", timeout=5.0).get("result", {})
            entry["postmortems"] = pm.get("captures", [])
        except Exception as e:  # noqa: BLE001
            entry["postmortems_error"] = str(e)
        per_node[name] = entry
    section = {"nodes": per_node}
    try:
        agg = timeline.aggregate(docs)
        # regional manifests read straggler REGIONS, not just node ids
        regions = net.manifest.region_names()
        id_to_name = {d.get("node_id", ""): d["name"] for d in docs}
        top = agg["summary"].get("top_straggler")
        if top is not None and id_to_name.get(top) in regions:
            agg["summary"]["top_straggler_name"] = id_to_name[top]
            agg["summary"]["top_straggler_region"] = regions[id_to_name[top]]
        section["aggregate"] = agg
    except Exception as e:  # noqa: BLE001
        section["aggregate"] = {"error": str(e)}
    return section


def _write_net_report(net: _Net, names: list[str], log=print) -> str | None:
    """Snapshot net_telemetry from every live node into
    <out_dir>/net_report.json (the run report's wire-plane section),
    plus the `fleet` rollup aggregating them into one record and the
    `heightline` consensus-anatomy section. Telemetry failures are
    recorded per node, never raised — the report is an artifact, not an
    assertion, and it must land on FAILED runs too (a perturbation
    assert mid-run reaches here via run_manifest's finally), so every
    section degrades independently instead of losing the whole file."""
    report = {"manifest": net.manifest.name, "nodes": {}}
    for i, name in enumerate(names):
        try:
            report["nodes"][name] = _rpc(net, i, "net_telemetry",
                                         timeout=5.0).get("result", {})
        except Exception as e:  # noqa: BLE001
            report["nodes"][name] = {"error": str(e)}
    try:
        report["fleet"] = _fleet_rollup(report, net, names)
    except Exception as e:  # noqa: BLE001 - the rollup must never cost
        report["fleet"] = {"error": str(e)}  # the per-node forensics
    try:
        report["heightline"] = _heightline_section(net, names)
    except Exception as e:  # noqa: BLE001 - ditto
        report["heightline"] = {"error": str(e)}
    path = os.path.join(net.dir, "net_report.json")
    try:
        with open(path, "w") as f:
            # default=str: one unserializable telemetry value must not
            # cost the failed-run forensics record
            json.dump(report, f, indent=1, default=str)
    except OSError as e:
        log(f"[{net.manifest.name}] net report not written: {e}")
        return None
    ok = sum(1 for v in report["nodes"].values() if "error" not in v)
    log(f"[{net.manifest.name}] wrote {path} "
        f"({ok}/{len(names)} nodes reporting)")
    return path


# ------------------------------------------------- fleet perturbations
# NET-level perturbations (manifest.net_perturb): each one drives the
# WHOLE fleet and asserts through the gossip/heal metrics, where the
# per-node perturbations above drive one node at a time.


def _min_height(net: _Net, idxs) -> int:
    return min(_height(net, j) for j in idxs)


def _max_height(net: _Net, idxs) -> int:
    return max(_height(net, j) for j in idxs)


def _perturb_churn_storm(net: _Net, names: list[str], pct: int, log) -> None:
    """Rolling restarts of pct% of the fleet in quorum-preserving waves:
    at most ~10% of nodes are down at once, and the chain must ADVANCE
    while the storm blows (a churn storm is weather, not an outage)."""
    n = len(names)
    n_churn = max(1, n * pct // 100)
    wave = max(1, min(n // 10, max(1, (n - 1) // 3)))
    victims = list(range(n))[:n_churn]  # deterministic: lowest indices
    log(f"[{net.manifest.name}] churn storm: restarting {n_churn}/{n} "
        f"nodes in waves of {wave}")
    h0 = _max_height(net, range(n))
    for w in range(0, n_churn, wave):
        batch = victims[w:w + wave]
        for j in batch:
            _kill(net.node_procs[j])
        for j in batch:
            net.node_procs[j] = _spawn_node(net.homes[j])
        # the respawned wave must REJOIN before the next wave blows, or
        # waves overlap into an outage
        target = _max_height(net, [j for j in range(n) if j not in batch])
        _wait(lambda: _min_height(net, batch) >= target - 1,
              120 + 4 * len(batch),
              f"churn wave {w // wave} rejoining height {target - 1}")
    # the chain must have kept committing through the storm window (a
    # churn storm is weather, not an outage); a short tail covers a
    # proposer round that died mid-wave
    _wait(lambda: _max_height(net, range(n)) > h0, 60 + 2 * n,
          f"the chain advancing past {h0} through the churn storm")
    h1 = _max_height(net, range(n))
    _wait(lambda: _min_height(net, range(n)) >= h1, 150 + 2 * n,
          "the whole fleet catching up after the churn storm")
    log(f"[{net.manifest.name}] churn storm done: {h0} -> {h1}, all caught up")


def _nudge_dials(net: _Net, names: list[str]) -> None:
    """Ask every node to re-dial its topology peers NOW (the dial_peers
    control route; already-connected peers are no-ops). Best-effort —
    a node that ignores the nudge just rides its own backoff."""
    ids = _node_ids(net)
    for i in range(len(names)):
        if net.manifest.topology == "organic":
            # no persistent wiring to re-dial; point everyone back at the
            # seed so a restarted node re-enters discovery immediately
            peer_idx = [0] if i != 0 else []
        else:
            peer_idx = _topology_peers(net.manifest, names, i)
        peers = ",".join(
            f"{ids[j]}@127.0.0.1:{net.base_port + j}"
            for j in peer_idx)
        if not peers:
            continue
        try:
            _rpc(net, i,
                 f"dial_peers?peers={urllib.parse.quote(peers)}",
                 timeout=10.0)
        except Exception:  # noqa: BLE001
            pass


def _perturb_regional_partition(net: _Net, names: list[str], region: int,
                                log) -> None:
    """Cut one region off through the runtime netchaos route. A minority
    region must STALL while the rest commits (they lost nothing but that
    region's votes); a heal must reconnect it, catch it up, and land on
    the partition-heal metric."""
    m = net.manifest
    n = len(names)
    ids = _node_ids(net)
    cut = [i for i, nm in enumerate(names) if m.nodes[nm].region == region]
    rest = [i for i in range(n) if i not in cut]
    if not cut or not rest:
        raise RunError(f"regional-partition: region {region} is empty or "
                       f"the whole net")
    spec = ("partition=" + ".".join(ids[i] for i in cut) + "|"
            + ".".join(ids[i] for i in rest))
    log(f"[{m.name}] partitioning region r{region} "
        f"({len(cut)} nodes) from the other {len(rest)}")
    arg = urllib.parse.quote(f'"{spec}"')
    for j in range(n):
        _rpc(net, j, f"unsafe_net_chaos?spec={arg}", timeout=10.0)
    time.sleep(2.0)  # in-flight commits land
    cut_h = _max_height(net, cut)
    rest_h = _max_height(net, rest)
    majority_has_quorum = len(rest) * 3 > n * 2
    if majority_has_quorum:
        _wait(lambda: _min_height(net, rest) >= rest_h + 2, 120 + 2 * n,
              "the majority side committing through the partition")
    else:
        time.sleep(6.0)
        if _max_height(net, rest) > rest_h + 1:
            raise RunError("progress on a quorum-less majority side")
    if _max_height(net, cut) > cut_h + 1:
        raise RunError(
            f"cut region r{region} advanced {cut_h} -> "
            f"{_max_height(net, cut)} during its partition")
    for j in range(n):
        _rpc(net, j, "unsafe_net_chaos?heal=true", timeout=10.0)
    # redial nudge: persistent-peer reconnect backoff deepens to 30 s
    # steps during a long partition, which can leave the few
    # cross-region links down for minutes AFTER the heal — the operator
    # move (and this runner's) is to nudge the dials through the
    # control route instead of waiting out the backoff
    _nudge_dials(net, names)
    target = _max_height(net, rest) + 2
    _wait(lambda: _min_height(net, range(n)) >= target, 300 + 6 * n,
          f"region r{region} catching up to {target} after the heal")
    if not any(_metric_value(_metrics_text(net, j),
                             "cometbft_p2p_partition_heal_seconds") > 0
               for j in range(n)):
        raise RunError("regional partition heal not recorded on /metrics")
    log(f"[{m.name}] region r{region} healed and caught up")


def _perturb_minority_partition(net: _Net, names: list[str], k: int,
                                log) -> None:
    """Cut the LAST k nodes off through the runtime netchaos route — the
    topology-agnostic sibling of regional-partition (a hub fleet has no
    regions, and under the hub topology the last nodes are spokes, so
    the hub mesh stays intact). The cut minority must STALL while the
    majority commits; a heal must reconnect it, catch it up, and land
    on the partition-heal metric."""
    m = net.manifest
    n = len(names)
    k = max(1, min(k, (n - 1) // 3))  # the majority keeps a +2/3 quorum
    ids = _node_ids(net)
    cut = list(range(n - k, n))
    rest = list(range(n - k))
    spec = ("partition=" + ".".join(ids[i] for i in cut) + "|"
            + ".".join(ids[i] for i in rest))
    log(f"[{m.name}] minority partition: cutting "
        f"{', '.join(names[i] for i in cut)} from the other {len(rest)}")
    arg = urllib.parse.quote(f'"{spec}"')
    for j in range(n):
        _rpc(net, j, f"unsafe_net_chaos?spec={arg}", timeout=10.0)
    time.sleep(2.0)  # in-flight commits land
    cut_h = _max_height(net, cut)
    rest_h = _max_height(net, rest)
    _wait(lambda: _min_height(net, rest) >= rest_h + 2, 120 + 2 * n,
          "the majority side committing through the minority partition")
    if _max_height(net, cut) > cut_h + 1:
        raise RunError(
            f"cut minority advanced {cut_h} -> {_max_height(net, cut)} "
            f"during its partition")
    for j in range(n):
        _rpc(net, j, "unsafe_net_chaos?heal=true", timeout=10.0)
    # same redial nudge as the regional heal: reconnect backoff deepens
    # during a long partition, the control route shortcuts it
    _nudge_dials(net, names)
    target = _max_height(net, rest) + 2
    _wait(lambda: _min_height(net, range(n)) >= target, 300 + 6 * n,
          f"the cut minority catching up to {target} after the heal")
    if not any(_metric_value(_metrics_text(net, j),
                             "cometbft_p2p_partition_heal_seconds") > 0
               for j in range(n)):
        raise RunError("minority partition heal not recorded on /metrics")
    log(f"[{m.name}] minority healed and caught up")


def _perturb_byzantine_minority(net: _Net, names: list[str], k: int,
                                log) -> None:
    """Restart k nodes equivocating (capped to keep a +2/3 honest
    quorum). The honest fleet must detect (DuplicateVoteEvidence
    committed) while staying live; the culprits are then reformed."""
    n = len(names)
    k = max(1, min(k, (n - 1) // 3))
    byz = list(range(k))
    honest = [j for j in range(n) if j >= k]
    log(f"[{net.manifest.name}] byzantine minority: {k}/{n} equivocating")
    for j in byz:
        _kill(net.node_procs[j])
        _arm_byzantine(net.homes[j], "equivocation")
        net.node_procs[j] = _spawn_node(net.homes[j])
    _wait(lambda: any(
        _metric_value(_metrics_text(net, j), "cometbft_evidence_committed")
        >= 1 for j in honest), 240 + 4 * n,
        "honest nodes committing DuplicateVoteEvidence")
    h0 = _max_height(net, honest)
    _wait(lambda: _max_height(net, honest) >= h0 + 2, 120 + 2 * n,
          "the honest fleet staying live under the byzantine minority")
    for j in byz:
        _kill(net.node_procs[j])
        _arm_byzantine(net.homes[j], "")
        net.node_procs[j] = _spawn_node(net.homes[j])
    target = _max_height(net, honest) + 1
    _wait(lambda: _min_height(net, range(n)) >= target, 200 + 4 * n,
          "reformed nodes rejoining the fleet")
    log(f"[{net.manifest.name}] byzantine minority detected and reformed")


def _run_net_perturbations(net: _Net, names: list[str], log) -> None:
    for p in net.manifest.net_perturb:
        base, _, arg = p.partition(":")
        if base == "churn-storm":
            _perturb_churn_storm(net, names, int(arg) if arg else 30, log)
        elif base == "regional-partition":
            _perturb_regional_partition(net, names,
                                        int(arg) if arg else 0, log)
        elif base == "byzantine-minority":
            _perturb_byzantine_minority(
                net, names, int(arg) if arg else len(names) // 3, log)
        elif base == "minority-partition":
            _perturb_minority_partition(
                net, names, int(arg) if arg else max(1, len(names) // 4),
                log)


def _report(net: _Net, names: list[str], manifest: Manifest, log) -> None:
    """Wire-plane report: snapshot every node's net_telemetry into the run
    dir BEFORE teardown — on FAILED runs especially, this is the forensics
    record of where the wire bytes went (nodes that died are recorded as
    per-node errors, never raised). A report bug must neither mask the
    run's real error nor skip the kills after it."""
    try:
        _write_net_report(net, names, log=log)
    except Exception as e:  # noqa: BLE001
        log(f"[{manifest.name}] net report failed: {e}")


def run_manifest(manifest: Manifest, out_dir: str, base_port: int = 29000,
                 log=print, backend: str = "gpu", node_config=None,
                 after_perturb=None, before_stop=None) -> dict:
    """Setup + start + perturb + verify + cleanup. Raises RunError on any
    violated expectation. Every node verifies on `backend`; node_config
    edits each home's Config (setup); after_perturb(net, record) runs once
    each node's perturbation has recovered and been checked;
    before_stop(net) runs on the live net after the checks and the net
    report. Returns {"perturbations": [each one's node, kind,
    start/recovery heights and seconds from the net's start, and the
    seconds to its detection where one is awaited], "height": the
    common height checked fork-free, "kernel_build_s": nvcc's seconds by
    source in this process (empty off the card)}."""
    from cometbft_tpu_torch.config import Config

    manifest.validate()
    net = setup(manifest, out_dir, base_port, backend=backend,
                node_config=node_config)
    names = sorted(manifest.nodes)
    n = len(names)
    cfgs = [Config.load(h) for h in net.homes]
    on_card = [c for c in cfgs if c.crypto.backend == "gpu"]
    _resource_guard(n, base_port, card_nodes=len(on_card))
    if on_card:
        # every source built once here, so that no node runs nvcc
        from cometbft_tpu_torch.node.node import build_kernels

        kernel_build_s = build_kernels(any(c.crypto.bls_enabled for c in on_card))
    else:
        kernel_build_s = {}
    out = {"perturbations": [], "height": 0, "kernel_build_s": kernel_build_s}
    reported = False
    t_net = time.time()
    # fleet deadlines scale with size: 50 processes importing torch and
    # dialing a topology do not boot in a 4-node net's 150 s
    boot_deadline = 150 + 4 * n
    try:
        # out-of-process apps first (the node dials them on boot)
        for i, name in enumerate(names):
            proto = manifest.nodes[name].abci_protocol
            if proto == "builtin":
                net.app_procs.append(None)
                continue
            from cometbft_tpu_torch.config import Config

            cfg = Config.load(net.homes[i])
            net.app_procs.append(_spawn_app(cfg.base.proxy_app))
        time.sleep(1.0)
        _boot_staggered(net)

        start_h = manifest.initial_height
        log(f"[{manifest.name}] waiting for height {start_h + 2} on {n} nodes")
        _wait(lambda: all(_height(net, i) >= start_h + 2 for i in range(n)),
              boot_deadline, f"all {n} nodes reaching height {start_h + 2}")

        # perturbations (perturb.go:44-100), one node at a time. A
        # single-node net has no survivors to observe: kill degrades to
        # restart, pause is a fixed-length stop (waiting on the perturbed
        # node's own height would deadlock).
        for i, name in enumerate(names):
            for p in manifest.nodes[name].perturb:
                p, p_arg = manifest.nodes[name].split_perturb(p)
                others = [j for j in range(n) if j != i]
                h0 = max((_height(net, j) for j in others), default=0)
                rec = {"node": name, "perturb": p, "start_height": h0,
                       "start_s": round(time.time() - t_net, 3)}
                out["perturbations"].append(rec)
                if p == "kill":
                    log(f"[{manifest.name}] kill {name}")
                    _kill(net.node_procs[i])
                    if others:
                        _wait(lambda: min(_height(net, j) for j in others)
                              >= h0 + 2, 120,
                              "survivors advancing past a kill")
                    net.node_procs[i] = _spawn_node(net.homes[i])
                elif p == "restart":
                    log(f"[{manifest.name}] restart {name}")
                    _kill(net.node_procs[i])
                    net.node_procs[i] = _spawn_node(net.homes[i])
                elif p == "device-flap":
                    # restart the node with a flapping device from boot:
                    # catching up to the live head below proves the flap
                    # was absorbed in place; crypto_health is asserted after
                    log(f"[{manifest.name}] {p} {name}")
                    _kill(net.node_procs[i])
                    _arm_device_chaos(net.homes[i], DEVICE_FLAP_CHAOS, kill=False)
                    net.node_procs[i] = _spawn_node(net.homes[i])
                elif p == "device-kill":
                    # restart the node with a dead device: with no CPU rung
                    # it must HALT TYPED — exit non-zero or stop its
                    # consensus / block sync — naming the fault in its log,
                    # and its supervisor must show it, while the others
                    # commit; then it is respawned healthy below
                    log(f"[{manifest.name}] {p} {name}")
                    _kill(net.node_procs[i])
                    _arm_device_chaos(net.homes[i], DEVICE_KILL_CHAOS)
                    since = _log_size(net.homes[i])
                    proc = net.node_procs[i] = _spawn_node(net.homes[i])
                    _wait(lambda: _log_names_device_fault(net.homes[i], since)
                          or (proc.poll() not in (None, 0)), 180,
                          f"{name} halting on its dead device")
                    if proc.poll() == 0:
                        raise RunError(f"device-kill on {name}: exit code 0")
                    if not _log_names_device_fault(net.homes[i], since):
                        raise RunError(
                            f"device-kill on {name}: exited {proc.poll()} without "
                            f"naming {' or '.join(DEVICE_FAULT_NAMES)} in its log")
                    if proc.poll() is None:
                        # still serving: its supervisor must show the fault
                        try:
                            h = _rpc(net, i, "crypto_health", timeout=5.0)["result"]
                        except Exception:  # noqa: BLE001 - RPC down: halted
                            h = None
                        if h is not None:
                            dev = h["supervisors"].get("device", {})
                            if (dev.get("failures", 0) < 1
                                    or dev.get("breaker", {}).get("state") == "closed"):
                                raise RunError(
                                    f"device-kill on {name}: the device supervisor "
                                    f"shows no open fault: {dev}")
                    rec["halted_s"] = round(time.time() - t_net, 3)
                    if others:
                        _wait(lambda: min(_height(net, j) for j in others)
                              >= h0 + 2, 120,
                              "survivors advancing past a dead device")
                    # respawn healthy: it catches up by block sync below
                    _kill(proc)
                    _arm_device_chaos(net.homes[i], "")
                    net.node_procs[i] = _spawn_node(net.homes[i])
                elif p in ("chip-kill", "chip-flap"):
                    # restart the node on a forced host-device mesh with
                    # ONE chip's fault domain scheduled to die (permanent)
                    # or flap (transient): catching up below proves liveness;
                    # the mesh metrics asserted after prove the run
                    # finalized on a shrunken/healed MESH, not on the CPU
                    # fallback ladder
                    dev = int(p_arg) if p_arg else DEFAULT_CHIP_INDEX
                    # the mesh must contain the targeted chip: a manifest
                    # may index up to chaos.MESH_CHAOS_DEVICES-1
                    n_mesh = max(MESH_DEVICE_COUNT, dev + 1)
                    chaos = (_chip_kill_chaos(dev) if p == "chip-kill"
                             else _chip_flap_chaos(dev))
                    log(f"[{manifest.name}] {p} {name} "
                        f"(device {dev} of {n_mesh})")
                    _kill(net.node_procs[i])
                    _arm_chip_chaos(net.homes[i], chaos,
                                    kill=(p == "chip-kill"))
                    net.node_procs[i] = _spawn_node(
                        net.homes[i], mesh_devices=n_mesh)
                elif p == "pause":
                    log(f"[{manifest.name}] pause {name}")
                    os.killpg(net.node_procs[i].pid, signal.SIGSTOP)
                    if others:
                        _wait(lambda: min(_height(net, j) for j in others)
                              >= h0 + 2, 120,
                              "survivors advancing past a pause")
                    else:
                        time.sleep(2.0)
                    os.killpg(net.node_procs[i].pid, signal.SIGCONT)
                elif p == "partition":
                    # 2-2 split through the runtime control route: no side
                    # has quorum, so NO progress until the heal — then the
                    # heal must be observable on /metrics
                    ids = _node_ids(net)
                    side = {i, (i + 1) % n}
                    spec = ("partition="
                            + ".".join(ids[j] for j in sorted(side)) + "|"
                            + ".".join(ids[j] for j in range(n)
                                       if j not in side))
                    log(f"[{manifest.name}] partition {sorted(side)} vs rest")
                    arg = urllib.parse.quote(f'"{spec}"')
                    for j in range(n):
                        _rpc(net, j, f"unsafe_net_chaos?spec={arg}")
                    time.sleep(2.0)  # in-flight commits land
                    hp = max(_height(net, j) for j in range(n))
                    time.sleep(6.0)
                    hq = max(_height(net, j) for j in range(n))
                    if hq > hp + 1:
                        raise RunError(
                            f"progress during a 2-2 partition: {hp} -> {hq}")
                    for j in range(n):
                        _rpc(net, j, "unsafe_net_chaos?heal=true")
                    _wait(lambda: min(_height(net, j) for j in range(n))
                          >= hq + 2, 150, "the net resuming after the heal")
                    if not any(_metric_value(
                            _metrics_text(net, j),
                            "cometbft_p2p_partition_heal_seconds") > 0
                            for j in range(n)):
                        raise RunError("partition_heal_seconds not recorded")
                elif p == "light-fleet":
                    # restart the node with the serving plane enabled,
                    # drive a client swarm at light_verify, partition the
                    # fleet node away MID-SOAK (already-committed heights
                    # must keep serving from the checkpoint cache), heal,
                    # and assert post-heal p99 + the light_fleet metrics
                    log(f"[{manifest.name}] light-fleet {name}")
                    _kill(net.node_procs[i])
                    _arm_light_fleet(net.homes[i])
                    net.node_procs[i] = _spawn_node(net.homes[i])
                    _wait(lambda: _height(net, i) >= h0, 150,
                          "the fleet node serving again")
                    _fleet_swarm(net, i, 40)  # soak phase 1: warm cache
                    ids = _node_ids(net)
                    spec = ("partition=" + ids[i] + "|"
                            + ".".join(ids[j] for j in range(n) if j != i))
                    log(f"[{manifest.name}] partitioning fleet node "
                        f"{name} mid-soak")
                    arg = urllib.parse.quote(f'"{spec}"')
                    for j in range(n):
                        _rpc(net, j, f"unsafe_net_chaos?spec={arg}")
                    time.sleep(2.0)
                    # the cut fleet node still answers for committed
                    # heights — the cache needs no quorum
                    _fleet_swarm(net, i, 15, seed=3)
                    for j in range(n):
                        _rpc(net, j, "unsafe_net_chaos?heal=true")
                    if others:
                        _wait(lambda: _height(net, i)
                              >= max(_height(net, j) for j in others) - 1,
                              150, "the fleet node rejoining after heal")
                    healed = _fleet_swarm(net, i, 60, seed=11)
                    p99 = healed[min(len(healed) - 1,
                                     int(len(healed) * 0.99))]
                    if p99 > 5.0:
                        raise RunError(
                            f"light-fleet on {name}: post-heal p99 "
                            f"{p99:.2f}s (> 5s budget)")
                    text = _metrics_text(net, i, timeout=5.0)
                    served = _metric_value(
                        text, "cometbft_light_fleet_requests_total")
                    if served < 100:
                        raise RunError(
                            f"light-fleet on {name}: only {served} fleet "
                            f"requests on /metrics (swarm ran 115)")
                    hits = _metric_value(
                        text,
                        'cometbft_light_fleet_cache_events{event="hit"}')
                    if hits < 1:
                        raise RunError(
                            f"light-fleet on {name}: checkpoint cache "
                            f"recorded no hits")
                elif p == "crash-storm":
                    # >= 3 kill-at-crash-site / respawn cycles on ONE
                    # node (CBFT_CRASH_SITE, libs/fail.py): each armed
                    # incarnation must die at its site with exit 99, each
                    # clean respawn must serve again; the shared tail
                    # asserts the storm cost the chain nothing
                    sites = ([p_arg] if p_arg else
                             ["wal.endheight", "abci.apply", "state.save"])
                    cycles = max(3, len(sites))
                    for c in range(cycles):
                        site = sites[c % len(sites)]
                        log(f"[{manifest.name}] crash-storm {name} "
                            f"cycle {c + 1}/{cycles} @ {site}")
                        _kill(net.node_procs[i])
                        proc = _spawn_node(
                            net.homes[i],
                            extra_env={"CBFT_CRASH_SITE": f"{site}:2"})
                        net.node_procs[i] = proc
                        t0 = time.time()
                        while proc.poll() is None and time.time() - t0 < 150:
                            time.sleep(0.5)
                        if proc.poll() != 99:
                            _kill(proc)
                            raise RunError(
                                f"crash-storm on {name}: site {site} never "
                                f"fired (exit {proc.poll()})")
                        net.node_procs[i] = _spawn_node(net.homes[i])
                        _wait(lambda: _height(net, i) >= 1, 150,
                              f"{name} serving after crash cycle {c + 1}")
                elif p == "disk-fault":
                    # arm a BOUNDED diskchaos schedule at runtime
                    # (unsafe_disk_chaos): the node must degrade or halt
                    # typed — never serve a block that differs from the
                    # fault-free chain — and every injected fault must be
                    # counted on the storage metrics plane
                    kind = p_arg or "bitrot"
                    spec = {"bitrot": "db.read=bitrot:2",
                            "enospc": "wal.write=enospc:2",
                            "eio": "db.write=eio:2",
                            "fsync_error": "wal.fsync=fsync_error:1",
                            "slow": "wal.fsync=slow:8"}[kind]
                    log(f"[{manifest.name}] disk-fault {name} ({spec})")
                    arg = urllib.parse.quote(f'"{spec}"')
                    _rpc(net, i, f"unsafe_disk_chaos?spec={arg}")
                    hq = manifest.initial_height + 1
                    ref_hash = None
                    if others:
                        ref = _rpc(net, others[0], f"block?height={hq}")
                        ref_hash = ref.get("result", {}).get(
                            "block_id", {}).get("hash")
                    deadline = time.time() + 60
                    fired = 0.0
                    while time.time() < deadline:
                        # poke the read seam: the answer is the typed
                        # error or the IDENTICAL block, never a wrong one
                        try:
                            doc = _rpc(net, i, f"block?height={hq}")
                        except Exception:  # noqa: BLE001 - typed halt
                            doc = {}
                        if "result" in doc and ref_hash is not None:
                            got = doc["result"]["block_id"]["hash"]
                            if got != ref_hash:
                                raise RunError(
                                    f"disk-fault on {name}: served block "
                                    f"{hq} hash {got} differs from fault-"
                                    f"free {ref_hash}")
                        fired = _metric_value(
                            _metrics_text(net, i),
                            "cometbft_storage_disk_faults")
                        if fired >= 1:
                            break
                        time.sleep(1.0)
                    if fired < 1:
                        raise RunError(
                            f"disk-fault on {name}: no injected fault "
                            f"counted on /metrics within 60s")
                    # clear the schedule and respawn: a node that halted
                    # with the typed error must rejoin; a live one just
                    # restarts (the shared tail asserts fork-free)
                    _rpc(net, i, "unsafe_disk_chaos?clear=true")
                    _kill(net.node_procs[i])
                    net.node_procs[i] = _spawn_node(net.homes[i])
                elif p == "cert-backfill":
                    # kill the node, wipe its commit-certificate store,
                    # respawn it mid-fleet while the chain keeps
                    # advancing: the backfill worker must re-certify the
                    # retained range from stored commits, observable on
                    # /metrics and over the commit_certificate route
                    log(f"[{manifest.name}] cert-backfill {name}")
                    _wait(lambda: _metric_value(
                        _metrics_text(net, i),
                        "cometbft_cert_produced_total") >= 1, 150,
                        f"{name} producing certificates before the wipe")
                    _kill(net.node_procs[i])
                    from cometbft_tpu_torch.config import Config

                    cfg = Config.load(net.homes[i])
                    cert_files = glob.glob(cfg.db_path("certs") + "*")
                    if not cert_files:
                        raise RunError(
                            f"cert-backfill on {name}: no certificate "
                            f"store files under {cfg.db_path('certs')}*")
                    for path in cert_files:
                        os.remove(path)
                    net.node_procs[i] = _spawn_node(net.homes[i])
                    _wait(lambda: _metric_value(
                        _metrics_text(net, i),
                        "cometbft_cert_backfilled_total") >= 1, 180,
                        f"{name} backfilling certificates after the wipe")
                    # churn: the fleet must have kept committing while the
                    # node re-certified (backfill under a moving head)
                    if others:
                        _wait(lambda: min(_height(net, j) for j in others)
                              >= h0 + 2, 120,
                              "survivors advancing through the backfill")
                    # a height committed BEFORE the wipe must answer on
                    # the RPC route again — re-certified, not replayed
                    def _recertified(_i=i, _h=max(h0, start_h + 2)):
                        try:
                            doc = _rpc(
                                net, _i, f"commit_certificate?height={_h}")
                        except Exception:  # noqa: BLE001 - retried
                            return False
                        return "certificate" in doc.get("result", {})

                    _wait(_recertified, 120,
                          f"{name} serving a re-certified early height")
                elif p == "mempool-storm":
                    # respawn with a SMALL pool so saturation is reachable
                    # without drowning the host, then drive fire-and-forget
                    # admission waves at the node's RPC: the chain must
                    # ADVANCE through the storm (only admission-plane work
                    # may be shed), the exempt control plane must answer
                    # mid-storm, and the sheds must land on /metrics with
                    # the mempool plane label
                    log(f"[{manifest.name}] mempool-storm {name}")
                    from cometbft_tpu_torch.config import Config

                    cfg = Config.load(net.homes[i])
                    orig_pool = cfg.mempool.size
                    cfg.mempool.size = 128
                    cfg.save()
                    _kill(net.node_procs[i])
                    net.node_procs[i] = _spawn_node(net.homes[i])
                    _wait(lambda: _height(net, i) >= 1, 150,
                          f"{name} serving with a small pool")
                    h1 = _height(net, i)
                    for wave in range(4):
                        for t in range(200):
                            tx = urllib.parse.quote(
                                f'"storm-{name}-{wave:02d}-{t:03d}"')
                            _rpc(net, i, f"broadcast_tx_async?tx={tx}",
                                 timeout=10.0)
                        doc = _rpc(net, i, "health", timeout=10.0)
                        if "overload" not in doc.get("result", {}):
                            raise RunError(
                                f"mempool-storm on {name}: health lost its "
                                f"overload section mid-storm: {doc}")
                    _wait(lambda: _height(net, i) >= h1 + 2, 120,
                          "the chain advancing through the mempool storm")
                    shed = _metric_value(
                        _metrics_text(net, i, timeout=5.0),
                        'cometbft_overload_sheds_total{plane="mempool"}')
                    if shed < 1:
                        raise RunError(
                            f"mempool-storm on {name}: 800 txs into a "
                            f"128-tx pool shed nothing on /metrics")
                    cfg = Config.load(net.homes[i])
                    cfg.mempool.size = orig_pool
                    cfg.save()
                    _kill(net.node_procs[i])
                    net.node_procs[i] = _spawn_node(net.homes[i])
                elif p == "rpc-flood":
                    # respawn with a 1-slot WRITE budget, then flood
                    # concurrent broadcast_tx_commit calls — the route
                    # that holds its slot across a whole commit wait, so
                    # the budget genuinely exhausts (fast read handlers
                    # finish within one event-loop step and never pile
                    # up). Excess requests must shed with the unified
                    # -32005 envelope (plane "rpc" + retry hint) while
                    # the exempt control plane keeps answering — an
                    # operator must always be able to ask a saturated
                    # node how saturated it is
                    log(f"[{manifest.name}] rpc-flood {name}")
                    from cometbft_tpu_torch.config import Config

                    cfg = Config.load(net.homes[i])
                    orig_guard = (cfg.rpc.overload_write_inflight,
                                  cfg.rpc.overload_queue_timeout)
                    cfg.rpc.overload_write_inflight = 1
                    cfg.rpc.overload_queue_timeout = 0.01
                    cfg.save()
                    _kill(net.node_procs[i])
                    net.node_procs[i] = _spawn_node(net.homes[i])
                    _wait(lambda: _height(net, i) >= 1, 150,
                          f"{name} serving with a 1-slot write budget")

                    def _flood_write(_j, _i=i, _nm=name):
                        tx = urllib.parse.quote(f'"flood-{_nm}-{_j:03d}"')
                        try:
                            return _rpc(
                                net, _i, f"broadcast_tx_commit?tx={tx}",
                                timeout=30.0)
                        except Exception:  # noqa: BLE001 - counted below
                            return {}

                    health_ok = False
                    with concurrent.futures.ThreadPoolExecutor(
                            max_workers=24) as tp:
                        futs = [tp.submit(_flood_write, j)
                                for j in range(120)]
                        while not all(f.done() for f in futs):
                            try:
                                doc = _rpc(net, i, "health", timeout=10.0)
                                health_ok = health_ok or "result" in doc
                            except Exception:  # noqa: BLE001
                                pass
                            time.sleep(0.02)
                        docs = [f.result() for f in futs]
                    sheds = 0
                    for doc in docs:
                        err = doc.get("error") or {}
                        if err.get("code") != -32005:
                            continue
                        data = err.get("data") or {}
                        if (data.get("plane") != "rpc"
                                or "retry_after_ms" not in data):
                            raise RunError(
                                f"rpc-flood on {name}: malformed shed "
                                f"envelope {err}")
                        sheds += 1
                    if sheds < 1:
                        raise RunError(
                            f"rpc-flood on {name}: no -32005 sheds out of "
                            f"{len(docs)} concurrent commit-waits on a "
                            f"1-slot budget")
                    if not health_ok:
                        raise RunError(
                            f"rpc-flood on {name}: exempt health route "
                            f"failed during the flood")
                    if _metric_value(
                            _metrics_text(net, i, timeout=5.0),
                            'cometbft_overload_sheds_total{plane="rpc"}') < 1:
                        raise RunError(
                            f"rpc-flood on {name}: sheds not recorded on "
                            f"/metrics with the rpc plane label")
                    cfg = Config.load(net.homes[i])
                    (cfg.rpc.overload_write_inflight,
                     cfg.rpc.overload_queue_timeout) = orig_guard
                    cfg.save()
                    _kill(net.node_procs[i])
                    net.node_procs[i] = _spawn_node(net.homes[i])
                elif p in ("byzantine", "flood"):
                    # restart the node adversarially; the honest majority
                    # must DETECT it: equivocation -> DuplicateVoteEvidence
                    # committed (evidence_committed), invalid-signature
                    # flooding -> the peer is banned (peer_bans)
                    behavior = "equivocation" if p == "byzantine" else "flood"
                    log(f"[{manifest.name}] {p} {name} ({behavior})")
                    _kill(net.node_procs[i])
                    _arm_byzantine(net.homes[i], behavior)
                    net.node_procs[i] = _spawn_node(net.homes[i])
                    metric = ("cometbft_evidence_committed"
                              if p == "byzantine" else "cometbft_p2p_peer_bans")
                    _wait(lambda: any(
                        _metric_value(_metrics_text(net, j), metric) >= 1
                        for j in others), 180,
                        f"honest nodes recording {metric} >= 1")
                    rec["detected_s"] = round(time.time() - t_net, 3)
                    # reform the node so the final agreement checks run
                    # against an honest net
                    _kill(net.node_procs[i])
                    _arm_byzantine(net.homes[i], "")
                    net.node_procs[i] = _spawn_node(net.homes[i])
                # the perturbed node must rejoin the live head (generous
                # deadline: CI shares the host with whatever else runs,
                # and a device perturbation pays cold kernel compiles)
                target = max((_height(net, j) for j in others),
                             default=h0) + 1
                _wait(lambda: _height(net, i) >= target, 240,
                      f"{name} catching up to {target} after {p}")
                rec["recovered_height"] = _height(net, i)
                rec["recovered_s"] = round(time.time() - t_net, 3)
                if p == "device-flap":
                    # the flap must be OBSERVED and ABSORBED: supervised
                    # failures and in-place retries recorded, the breaker
                    # closed again, and every verdict from the node's own
                    # backend (there is no other rung)
                    h = _rpc(net, i, "crypto_health")["result"]
                    dev = h["supervisors"].get("device", {})
                    if dev.get("failures", 0) < 1 or dev.get("retries", 0) < 1:
                        raise RunError(
                            f"{p} on {name}: supervised failures "
                            f"{dev.get('failures')}, retries {dev.get('retries')} "
                            f"(crypto_health: {h})")
                    if dev.get("breaker", {}).get("state") != "closed":
                        raise RunError(
                            f"{p} on {name}: breaker not closed at the end "
                            f"(crypto_health: {h})")
                    if h.get("active_backend") != cfgs[i].crypto.backend:
                        raise RunError(
                            f"{p} on {name}: verdicts from {h.get('active_backend')!r}, "
                            f"not the home's {cfgs[i].crypto.backend!r}")
                    rec["device"] = {k: dev.get(k) for k in ("failures", "retries",
                                                             "successes")}
                if p in ("chip-kill", "chip-flap"):
                    # the run must have finalized ON THE MESH: shards were
                    # dispatched, and the all-chips-dead CPU fallback was
                    # never engaged
                    text = _metrics_text(net, i, timeout=5.0)
                    size = _metric_value(
                        text, "cometbft_crypto_verify_mesh_size")
                    fallbacks = _metric_value(
                        text, "cometbft_crypto_mesh_fallback_total")
                    shard_lanes = _metric_value(
                        text, "cometbft_crypto_mesh_shard_lanes")
                    if shard_lanes < 1:
                        raise RunError(
                            f"{p} on {name}: no mesh shards dispatched "
                            f"(mesh never engaged)")
                    if fallbacks > 0:
                        raise RunError(
                            f"{p} on {name}: finalized via the CPU "
                            f"fallback ({fallbacks} fallbacks), not the mesh")
                    if p == "chip-kill":
                        evictions = _metric_value(
                            text, "cometbft_crypto_mesh_evictions_total")
                        dead_state = _metric_value(
                            text, "cometbft_crypto_mesh_breaker_state"
                                  f'{{device="{dev}"}}')
                        if evictions < 1:
                            raise RunError(
                                f"chip-kill on {name}: the mesh never "
                                f"evicted the dead chip (size {size})")
                        if dead_state < 1:  # 0 closed: a device op succeeded
                            raise RunError(
                                f"chip-kill on {name}: chip {dev}'s breaker "
                                f"is closed — its fault domain never died")
                        if size < 1:
                            raise RunError(
                                f"chip-kill on {name}: whole mesh died "
                                f"(size {size})")
                    else:  # chip-flap: hysteresis absorbs, mesh stays full
                        if size < n_mesh:
                            raise RunError(
                                f"chip-flap on {name}: flap shrank the mesh "
                                f"(size {size} of {n_mesh}) instead of "
                                f"being absorbed")
                if after_perturb is not None:
                    after_perturb(net, rec)

        # net-level perturbations (fleet scale): after the per-node loop,
        # so a manifest can compose both planes
        _run_net_perturbations(net, names, log)

        target = max(manifest.initial_height + manifest.target_height_delta,
                     max(_height(net, i) for i in range(n)))
        log(f"[{manifest.name}] waiting for target height {target}")
        _wait(lambda: all(_height(net, i) >= target for i in range(n)),
              150 + 2 * n, f"all nodes reaching target height {target}")

        # no fork: every node agrees on the newest height they all have
        h = min(_height(net, i) for i in range(n)) - 1
        hashes = {
            _rpc(net, i, f"block?height={h}")["result"]["block_id"]["hash"]
            for i in range(n)
        }
        if len(hashes) != 1:
            raise RunError(f"fork at height {h}: {hashes}")
        out["height"] = h

        # genesis app_state visible through every node's app
        for key, want in manifest.initial_state.items():
            q = _rpc(net, 0,
                     f'abci_query?data={key.encode().hex()}&path="/store"')
            if "result" not in q:
                raise RunError(f"abci_query failed: {q}")
            got = q["result"]["response"].get("value")
            import base64 as _b64

            if got is None or _b64.b64decode(got).decode() != want:
                raise RunError(
                    f"initial_state key {key!r} not served by the app "
                    f"(got {got!r})")
        log(f"[{manifest.name}] OK (height {h}, {n} nodes in agreement)")
        # the live net's report, before a caller's hook may stop the nodes
        reported = True
        _report(net, names, manifest, log)
        if before_stop is not None:
            before_stop(net)
    finally:
        if not reported:
            _report(net, names, manifest, log)
        for p in net.node_procs:
            if p is not None:
                _kill(p)
        for p in net.app_procs:
            if p is not None:
                _kill(p)
    return out
