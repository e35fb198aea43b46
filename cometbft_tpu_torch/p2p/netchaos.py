"""Network-fault injection registry (the transport analog of libs/chaos.py).

chaos.py breaks the DEVICE at named call sites; netchaos breaks the WIRE.
One process-global registry (the network plane, like the device plane, is a
process-global resource) drives two fault families:

  link faults   latency / jitter / drop / duplication / reordering /
                bandwidth caps, applied by a ChaosConn wrapped around every
                peer connection between the MConnection and the
                SecretConnection — frames are already encrypted plaintext
                packets at that seam, so a duplicated or reordered write is
                a duplicated or reordered packet batch on the wire, exactly
                what a lossy network delivers;
  partitions    a partition map keyed by node id: a write across a group
                boundary errors the connection (the RST/timeout a real
                partitioned route eventually produces — silently eating
                bytes would violate the delivered-or-dead contract the
                gossip bookkeeping relies on), and new dials/accepts
                across the boundary are refused until the map is cleared.
                Directed single-link blocks (`block_link`) express
                asymmetric partitions.

Arming, via env (`CBFT_NET_CHAOS`), config (`p2p.chaos`), `arm_spec()`, or
the `unsafe_net_chaos` RPC control route:

  CBFT_NET_CHAOS="latency=0.05,drop=0.01,dup=0.02,reorder=0.05,bandwidth=65536"
  CBFT_NET_CHAOS="partition=<idA>.<idB>|<idC>.<idD>"

Link profiles (the fleet-topology dimension): instead of one global link
config, NAMED profiles apply per region pair — the regional testnets'
"intra-region fast, cross-region high-latency/lossy" shape:

  CBFT_NET_CHAOS="profile.wan=latency:0.04;jitter:0.02;drop:0.005,
                  region=<idA>:r0,region=<idB>:r1,link.r0-r1=wan"

  profile.<name>=k:v;k:v   define a profile (keys = the link-fault keys)
  region=<node_id>:<name>  assign a node to a region (repeatable)
  link.<rA>-<rB>=<name>    profile for traffic between two regions
                           (unordered; rA == rB for intra-region links)
  link.default=<name>      profile for any region pair not mapped above

A write resolves its profile from (local region, remote region); links
with no profile (or nodes with no region) fall back to the global link
config. Profiles compose with partitions unchanged.

`partition=` groups are separated by `|`, members by `.`; node ids are hex
so neither collides. Probabilistic faults use a seeded RNG per connection
(`seed=` in the spec), so a fault schedule replays deterministically like a
fuzz seed. Partition healing is observable: `clear_partition()` starts a
clock that stops at the first write crossing a formerly-blocked link, and
the elapsed seconds are kept for `last_heal_seconds()` and land on the
process-global `cometbft_p2p_partition_heal_seconds` gauge
(libs/metrics.NetChaosMetrics).

Partition enforcement is write-side: each node's own wrapper drops its own
outbound bytes. In-process nets share this registry so one `set_partition`
cuts every direction at once; OS-process nets must arm the map on every
node that should stop transmitting (the e2e runner arms all of them).

The port's copy of cometbft_tpu/p2p/netchaos.py. It is inert unless armed:
the Switch wraps every peer conn and the Transport asks `dial_blocked`, and
with nothing armed a write costs one flag test. Its fault counters are
kept in `snapshot()["stats"]` and on the net-fault metrics.
"""

from __future__ import annotations

import asyncio
import os
import random
import threading
import time

_ENV = "CBFT_NET_CHAOS"

# spec keys that arm link faults (all floats except bandwidth/seed)
_LINK_KEYS = ("latency", "jitter", "drop", "dup", "reorder", "bandwidth", "seed")


class NetChaosConfig:
    """Link-fault knobs; all zero means the wire is clean."""

    __slots__ = ("latency", "jitter", "drop", "dup", "reorder", "bandwidth",
                 "seed")

    def __init__(self, latency: float = 0.0, jitter: float = 0.0,
                 drop: float = 0.0, dup: float = 0.0, reorder: float = 0.0,
                 bandwidth: int = 0, seed: int = 0):
        self.latency = latency
        self.jitter = jitter
        self.drop = drop
        self.dup = dup
        self.reorder = reorder
        self.bandwidth = bandwidth
        self.seed = seed

    def any_active(self) -> bool:
        return bool(self.latency or self.jitter or self.drop or self.dup
                    or self.reorder or self.bandwidth)


_lock = threading.Lock()
_cfg: NetChaosConfig | None = None
_groups: dict[str, str] = {}          # node_id -> partition group label
_blocked_links: set[tuple[str, str]] = set()  # directed (src, dst) blocks
# link-profile plane (fleet topologies): named configs + region wiring
_profiles: dict[str, NetChaosConfig] = {}     # profile name -> config
_regions: dict[str, str] = {}                 # node_id -> region name
_region_links: dict[tuple[str, str], str] = {}  # sorted (rA, rB) -> profile
_default_link_profile: str | None = None
_env_loaded = False
# heal observability: set when a partition is cleared, consumed by the first
# write that crosses a formerly-blocked link
_heal_pending = False
_heal_t0 = 0.0
_heal_links: set[tuple[str, str]] = set()
_last_heal_seconds: float | None = None
_stats = {"blocked_writes": 0, "dropped": 0, "duplicated": 0,
          "reordered": 0, "delayed": 0, "blocked_dials": 0}
# fast path: True only while some fault is armed (checked lock-free per write)
_active = False


class ParsedSpec:
    """The parsed form of one CBFT_NET_CHAOS schedule. Attribute access
    only (the old 3-tuple unpack shape predates link profiles)."""

    __slots__ = ("cfg", "groups", "blocks", "profiles", "regions", "links",
                 "default_link")

    def __init__(self):
        self.cfg: NetChaosConfig | None = None
        self.groups: dict[str, str] = {}
        self.blocks: set[tuple[str, str]] = set()
        self.profiles: dict[str, NetChaosConfig] = {}
        self.regions: dict[str, str] = {}
        self.links: dict[tuple[str, str], str] = {}
        self.default_link: str | None = None


def _parse_link_kwargs(value: str, part: str, sep_pair: str = "=") -> dict:
    """Parse link-fault key/value pairs; `value` is `k{sep}v` joined by
    `,` (top level) or `;` (inside a profile definition)."""
    kwargs: dict[str, float | int] = {}
    items = value.split(";") if sep_pair == ":" else [value]
    for item in items:
        key, sep, val = item.partition(sep_pair)
        key, val = key.strip(), val.strip()
        if not sep or not val or key not in _LINK_KEYS:
            raise ValueError(f"bad net-chaos link fault {item!r} in {part!r} "
                             f"(keys: {_LINK_KEYS})")
        try:
            kwargs[key] = (int(val) if key in ("bandwidth", "seed")
                           else float(val))
        except ValueError:
            raise ValueError(
                f"bad net-chaos value {val!r} in {part!r}") from None
        if kwargs[key] < 0:
            raise ValueError(f"negative net-chaos value in {part!r}")
    return kwargs


def parse_spec(spec: str) -> ParsedSpec:
    """Parse a CBFT_NET_CHAOS schedule (link config, partition groups,
    directed blocks, link profiles, region map, region-pair links),
    raising ValueError on any malformed part — config validation uses
    this so a typo'd schedule fails at boot."""
    out = ParsedSpec()
    cfg_kwargs: dict[str, float | int] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        key, sep, value = part.partition("=")
        key, value = key.strip(), value.strip()
        if not sep or not value:
            raise ValueError(f"malformed net-chaos part {part!r}")
        if key == "partition":
            for gi, group in enumerate(value.split("|")):
                members = [m for m in group.split(".") if m]
                if not members:
                    raise ValueError(f"empty partition group in {part!r}")
                for m in members:
                    out.groups[m] = f"g{gi}"
        elif key == "block":
            src, sep2, dst = value.partition(">")
            if not sep2 or not src or not dst:
                raise ValueError(f"malformed directed block {part!r} "
                                 "(want block=src>dst)")
            out.blocks.add((src, dst))
        elif key.startswith("profile."):
            name = key[len("profile."):]
            if not name:
                raise ValueError(f"empty profile name in {part!r}")
            out.profiles[name] = NetChaosConfig(
                **_parse_link_kwargs(value, part, sep_pair=":"))
        elif key == "region":
            node_id, sep2, region = value.partition(":")
            if not sep2 or not node_id or not region:
                raise ValueError(f"malformed region assignment {part!r} "
                                 "(want region=<node_id>:<region>)")
            out.regions[node_id] = region
        elif key.startswith("link."):
            pair = key[len("link."):]
            if pair == "default":
                out.default_link = value
            else:
                ra, sep2, rb = pair.partition("-")
                if not sep2 or not ra or not rb:
                    raise ValueError(f"malformed link key {part!r} "
                                     "(want link.<rA>-<rB>=<profile>)")
                out.links[tuple(sorted((ra, rb)))] = value
        elif key in _LINK_KEYS:
            cfg_kwargs.update(_parse_link_kwargs(part, part))
        else:
            raise ValueError(
                f"unknown net-chaos key {key!r} (keys: "
                f"{_LINK_KEYS + ('partition', 'block', 'region', 'profile.<name>', 'link.<rA>-<rB>')})")
    if cfg_kwargs:
        out.cfg = NetChaosConfig(**cfg_kwargs)
    # a link mapping naming an undefined profile is a boot-time error,
    # not a silent clean wire at fault time
    for pair, name in list(out.links.items()) + (
            [(("default", "default"), out.default_link)]
            if out.default_link else []):
        if name not in out.profiles:
            raise ValueError(f"link {pair} names unknown profile {name!r}")
    return out


def _recompute_active_locked() -> None:
    global _active
    _active = bool((_cfg is not None and _cfg.any_active()) or _groups
                   or _blocked_links or _heal_pending
                   or (_region_links or _default_link_profile))


def _load_env_locked() -> None:
    global _env_loaded
    if _env_loaded:
        return
    _env_loaded = True
    spec = os.environ.get(_ENV, "")
    if not spec:
        return
    try:
        _arm_spec_locked(spec)
    except ValueError as e:
        # same floor as libs/chaos: a malformed env schedule surfacing as a
        # phantom network fault inside a send routine would be undebuggable
        from cometbft_tpu_torch.libs import log as _log

        _log.default().error(
            "ignoring malformed CBFT_NET_CHAOS schedule", spec=spec, err=str(e))


def _arm_spec_locked(spec: str) -> None:
    global _cfg, _default_link_profile
    parsed = parse_spec(spec)
    if parsed.cfg is not None:
        _cfg = parsed.cfg
    if parsed.groups:
        _set_partition_locked(parsed.groups)
    for link in parsed.blocks:
        _blocked_links.add(link)
    _profiles.update(parsed.profiles)
    _regions.update(parsed.regions)
    _region_links.update(parsed.links)
    if parsed.default_link is not None:
        _default_link_profile = parsed.default_link
    _recompute_active_locked()


def arm(cfg: NetChaosConfig) -> None:
    global _cfg
    with _lock:
        _load_env_locked()
        _cfg = cfg
        _recompute_active_locked()


def arm_spec(spec: str) -> None:
    with _lock:
        _load_env_locked()
        _arm_spec_locked(spec)


def disarm() -> None:
    """Drop the link-fault config; partitions stay (clear_partition heals)."""
    global _cfg
    with _lock:
        _cfg = None
        _recompute_active_locked()


def reset() -> None:
    """Back to a clean wire; forgets the env schedule (tests re-arm)."""
    global _cfg, _env_loaded, _heal_pending, _last_heal_seconds
    global _default_link_profile
    with _lock:
        _cfg = None
        _groups.clear()
        _blocked_links.clear()
        _profiles.clear()
        _regions.clear()
        _region_links.clear()
        _default_link_profile = None
        _heal_pending = False
        _heal_links.clear()
        _last_heal_seconds = None
        _env_loaded = True
        for k in _stats:
            _stats[k] = 0
        _recompute_active_locked()


# ------------------------------------------------------------- partitions


def _set_partition_locked(groups: dict[str, str]) -> None:
    global _heal_pending
    _groups.clear()
    _groups.update({k: str(v) for k, v in groups.items()})
    _heal_pending = False
    _heal_links.clear()


def set_partition(groups: dict[str, str]) -> None:
    """Install a partition map: node_id -> group label. Two known ids in
    different groups cannot exchange traffic; an id absent from the map is
    unrestricted (so a map only needs the nodes it isolates)."""
    with _lock:
        _load_env_locked()
        _set_partition_locked(groups)
        _recompute_active_locked()


def block_link(src: str, dst: str) -> None:
    """Asymmetric partition primitive: src's messages never reach dst."""
    with _lock:
        _load_env_locked()
        _blocked_links.add((src, dst))
        _recompute_active_locked()


def unblock_link(src: str, dst: str) -> None:
    with _lock:
        _blocked_links.discard((src, dst))
        _recompute_active_locked()


def clear_partition() -> None:
    """Heal: drop the partition map and directed blocks, and start the
    heal clock — stopped by the first write across a formerly-cut link."""
    global _heal_pending, _heal_t0
    with _lock:
        cut: set[tuple[str, str]] = set(_blocked_links)
        ids = list(_groups)
        for a in ids:
            for b in ids:
                if a != b and _groups[a] != _groups[b]:
                    cut.add((a, b))
        _groups.clear()
        _blocked_links.clear()
        if cut:
            _heal_pending = True
            _heal_t0 = time.monotonic()
            _heal_links.clear()
            _heal_links.update(cut)
        _recompute_active_locked()


def link_config(src: str, dst: str) -> NetChaosConfig | None:
    """The link-fault config governing traffic src -> dst: a region-pair
    profile when both nodes have regions and the pair (or the default
    link) is mapped, else the global config. None = clean wire."""
    if _region_links or _default_link_profile:
        with _lock:
            ra, rb = _regions.get(src), _regions.get(dst)
            if ra is not None and rb is not None:
                name = _region_links.get(tuple(sorted((ra, rb))),
                                         _default_link_profile)
                if name is not None:
                    prof = _profiles.get(name)
                    if prof is not None:
                        return prof
    return _cfg


def region_of(node_id: str) -> str | None:
    with _lock:
        return _regions.get(node_id)


def link_blocked(src: str, dst: str) -> bool:
    """True when traffic src -> dst is cut (directed block or group split)."""
    if not _active:
        if _env_loaded:
            return False
        # a node armed ONLY via CBFT_NET_CHAOS must enforce the partition
        # on its very first boot-time dial, before any conn was wrapped
        with _lock:
            _load_env_locked()
        if not _active:
            return False
    with _lock:
        if (src, dst) in _blocked_links:
            return True
        ga, gb = _groups.get(src), _groups.get(dst)
        return ga is not None and gb is not None and ga != gb


def dial_blocked(a: str, b: str) -> bool:
    """A dial needs both directions; blocked if either is cut."""
    return link_blocked(a, b) or link_blocked(b, a)


def _note_delivery(src: str, dst: str) -> None:
    """Called on every non-blocked write while a heal is pending; the first
    one across a formerly-cut link records partition_heal_seconds."""
    global _heal_pending, _last_heal_seconds
    with _lock:
        if not _heal_pending or (src, dst) not in _heal_links:
            return
        _heal_pending = False
        _heal_links.clear()
        _last_heal_seconds = time.monotonic() - _heal_t0
        _recompute_active_locked()
        secs = _last_heal_seconds
    from cometbft_tpu_torch.libs import metrics as cmtmetrics

    cmtmetrics.netchaos_metrics().partition_heal_seconds.set(secs)



def last_heal_seconds() -> float | None:
    with _lock:
        return _last_heal_seconds


def snapshot() -> dict:
    """Armed faults + fire counts (surfaced by the unsafe_net_chaos route)."""
    with _lock:
        _load_env_locked()
        cfg = None
        if _cfg is not None:
            cfg = {k: getattr(_cfg, k) for k in _LINK_KEYS}
        return {
            "config": cfg,
            "partition": dict(_groups),
            "blocked_links": sorted(f"{a}>{b}" for a, b in _blocked_links),
            "profiles": {
                name: {k: getattr(p, k) for k in _LINK_KEYS}
                for name, p in _profiles.items()},
            "regions": dict(_regions),
            "region_links": {f"{a}-{b}": name
                             for (a, b), name in _region_links.items()},
            "default_link_profile": _default_link_profile,
            "heal_pending": _heal_pending,
            "last_heal_seconds": _last_heal_seconds,
            "stats": dict(_stats),
        }


def _count(kind: str) -> None:
    with _lock:
        _stats[kind] += 1
    from cometbft_tpu_torch.libs import metrics as cmtmetrics

    cmtmetrics.netchaos_metrics().net_faults.labels(kind).inc()


# ------------------------------------------------------------ conn wrapper


class ChaosConn:
    """Wraps a SecretConnection between the MConnection and the socket.
    Reads the registry on every write, so faults armed mid-connection (the
    runtime partition route) apply to live conns. A held reordered frame is
    flushed by the next write; if the conn goes quiet first the frame is
    lost — indistinguishable from a drop, which is the point."""

    __slots__ = ("_conn", "local_id", "remote_id", "_rng", "_held")

    def __init__(self, conn, local_id: str, remote_id: str):
        self._conn = conn
        self.local_id = local_id
        self.remote_id = remote_id
        self._rng: random.Random | None = None
        self._held: bytes | None = None

    def _link_rng(self, seed: int) -> random.Random:
        if self._rng is None:
            if seed:
                # per-link deterministic stream (hashlib, not hash(): str
                # hashing is salted per process): the same seed + id pair
                # replays the same fault schedule
                import hashlib

                digest = hashlib.sha256(
                    f"{seed}|{self.local_id}|{self.remote_id}".encode()
                ).digest()
                self._rng = random.Random(int.from_bytes(digest[:8], "big"))
            else:
                self._rng = random.Random()
        return self._rng

    async def write(self, data: bytes) -> None:
        if not _active:
            await self._conn.write(data)
            return
        if link_blocked(self.local_id, self.remote_id):
            # a partitioned route must KILL the conn, not silently eat
            # bytes: mconn/reactor bookkeeping assumes TCP's delivered-or-
            # dead contract (PeerState marks gossiped votes as delivered
            # at send time), so a silent black hole wedges gossip forever.
            # The error tears the peer down; redial is then refused at the
            # transport until the partition heals — the TCP-reset analog.
            _count("blocked_writes")
            raise ConnectionResetError(
                f"net chaos: partitioned from {self.remote_id[:10]}")
        cfg = link_config(self.local_id, self.remote_id)
        if cfg is not None and cfg.any_active():
            rng = self._link_rng(cfg.seed)
            if cfg.bandwidth:
                await asyncio.sleep(len(data) / cfg.bandwidth)
            if cfg.latency or cfg.jitter:
                _count("delayed")
                await asyncio.sleep(cfg.latency + cfg.jitter * rng.random())
            r = rng.random()
            if r < cfg.drop:
                _count("dropped")
                return
            if r < cfg.drop + cfg.dup:
                _count("duplicated")
                await self._conn.write(data)
            elif r < cfg.drop + cfg.dup + cfg.reorder and self._held is None:
                _count("reordered")
                self._held = data
                return
        held, self._held = self._held, None
        await self._conn.write(data)
        if held is not None:
            await self._conn.write(held)
        if _heal_pending:
            _note_delivery(self.local_id, self.remote_id)

    async def readexactly(self, n: int) -> bytes:
        return await self._conn.readexactly(n)

    def close(self) -> None:
        self._conn.close()

    def __getattr__(self, name):
        return getattr(self._conn, name)


def wrap(conn, local_id: str, remote_id: str) -> ChaosConn:
    """Wrap a peer connection; cheap when nothing is armed (one flag test
    per write). Always wrapped so faults armed later reach live conns."""
    with _lock:
        _load_env_locked()
    return ChaosConn(conn, local_id, remote_id)
