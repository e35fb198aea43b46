"""Device-fault injection at named call sites: the port's copy of
cometbft_tpu/libs/chaos.py (standard library only).

A site is a seam where a device operation can fail. The port fires these:

  ed25519.dispatch / sr25519.dispatch / bls12381.dispatch
                     one mesh shard's dispatch (parallel/mesh.py), and the
                     BLS shard itself (ops/bls_kernel.mesh_shard_verify)
  ed25519.dispatch.devN / sr25519.dispatch.devN
                     the same shard's dispatch on mesh fault domain N, so a
                     schedule can kill or flap exactly one domain while the
                     others serve (N < MESH_CHAOS_DEVICES)
  dispatch.doublebuf the per-domain two-slot in-flight gate
                     (ops/dispatch.DoubleBuffer): a fault there degrades the
                     domain to one batch in flight until its breaker closes
  net.dial / net.accept / net.handshake
                     the p2p transport's dial, accept and upgrade
                     (p2p/transport.py)

The other names of SITES (fetch, challenge, pallas, mixed, sched and
light sites) are the reference's; the port accepts them in a schedule so
that one schedule string serves both packages, and fires none of them yet.

Arming, by the environment (`CBFT_CHAOS`, read at the first use) or by
arm()/arm_spec():

  CBFT_CHAOS="ed25519.dispatch.dev1=permanent,dispatch.doublebuf=transient:3"

`kind[:count]` a site: `count` firings (default: until disarmed), then the
site heals. Kinds:

  timeout     raise ChaosTimeout (a hung device)
  transient   raise ChaosTransientError (retryable)
  permanent   raise ChaosPermanentError (not retryable)
  corrupt     never raises at fire() (the reference's payload-perturbing
              kind; no site of the port consumes it yet)

Every fault is deterministic: a plain counter a site, no randomness.
Thread-safe: sites fire from the mesh's shard threads.
"""

from __future__ import annotations

import logging
import os
import threading

# per-domain mesh sites: the mesh fires the plain scheme site and the
# domain-indexed one inside every shard dispatch
MESH_CHAOS_DEVICES = 8

_MESH_SITES = tuple(
    f"{scheme}.dispatch.dev{i}"
    for scheme in ("ed25519", "sr25519")
    for i in range(MESH_CHAOS_DEVICES)
)

SITES = (
    "ed25519.dispatch",
    "ed25519.fetch",
    "ed25519.challenge",
    "dispatch.doublebuf",
    "sr25519.dispatch",
    "sr25519.fetch",
    "pallas.trace",
    "mixed.resolve",
    "sched.flush",
    "net.dial",
    "net.accept",
    "net.handshake",
    "light.fetch",
) + _MESH_SITES

KINDS = ("timeout", "transient", "permanent", "corrupt")

_ENV = "CBFT_CHAOS"


class ChaosTimeout(Exception):
    """Injected hung-device timeout."""


class ChaosTransientError(Exception):
    """Injected retryable device failure."""


class ChaosPermanentError(Exception):
    """Injected permanent device failure."""


class _Site:
    __slots__ = ("kind", "remaining", "fired")

    def __init__(self, kind: str, remaining: int | None):
        self.kind = kind
        self.remaining = remaining  # None = unlimited
        self.fired = 0


_lock = threading.Lock()
_sites: dict[str, _Site] = {}
_env_loaded = False


def parse_spec(spec: str) -> list[tuple[str, str, int | None]]:
    """A schedule string -> (site, kind, count) triples; ValueError on any
    malformed part."""
    out: list[tuple[str, str, int | None]] = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        site, _, fault = part.partition("=")
        kind, _, count = fault.partition(":")
        site, kind = site.strip(), kind.strip()
        if site not in SITES:
            raise ValueError(f"unknown chaos site {site!r} (sites: {SITES})")
        if kind not in KINDS:
            raise ValueError(f"unknown chaos kind {kind!r} (kinds: {KINDS})")
        if count:
            try:
                n = int(count)
            except ValueError:
                raise ValueError(f"bad chaos count {count!r} in {part!r}") from None
            if n < 0:
                raise ValueError(f"negative chaos count in {part!r}")
        else:
            n = None
        out.append((site, kind, n))
    return out


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
        # loaded lazily at the first fire(), where raising would count as a
        # device fault: log it and arm nothing
        logging.getLogger(__name__).error("ignoring malformed %s schedule %r: %s", _ENV,
                                          spec, e)


def _arm_spec_locked(spec: str) -> None:
    for site, kind, count in parse_spec(spec):
        _arm_locked(site, kind, count)


def _arm_locked(site: str, kind: str, count: int | None) -> None:
    if site not in SITES:
        raise ValueError(f"unknown chaos site {site!r} (sites: {SITES})")
    if kind not in KINDS:
        raise ValueError(f"unknown chaos kind {kind!r} (kinds: {KINDS})")
    _sites[site] = _Site(kind, count)


def arm(site: str, kind: str, count: int | None = None) -> None:
    """Arm `site` to fail `count` times (None = until disarmed)."""
    with _lock:
        _load_env_locked()
        _arm_locked(site, kind, count)


def arm_spec(spec: str) -> None:
    """Arm from a CBFT_CHAOS-syntax schedule string."""
    with _lock:
        _load_env_locked()
        _arm_spec_locked(spec)


def disarm(site: str) -> None:
    with _lock:
        _sites.pop(site, None)


def reset() -> None:
    """Disarm everything and forget the environment's schedule (tests arm
    their own)."""
    global _env_loaded
    with _lock:
        _sites.clear()
        _env_loaded = True


def armed(site: str) -> str | None:
    """The site's live fault kind, or None."""
    with _lock:
        _load_env_locked()
        s = _sites.get(site)
        return s.kind if s is not None and s.remaining != 0 else None


def fired(site: str) -> int:
    """How many times the site has fired (0 when not armed)."""
    with _lock:
        s = _sites.get(site)
        return s.fired if s is not None else 0


def snapshot() -> dict:
    """Armed sites and their fire counts (the crypto_health route's
    `chaos` section)."""
    with _lock:
        _load_env_locked()
        return {
            site: {"kind": s.kind, "remaining": s.remaining, "fired": s.fired}
            for site, s in _sites.items()
        }


def fire(site: str) -> None:
    """Raise the site's armed fault, if any, and count the firing (a site
    armed `corrupt` neither raises nor counts here)."""
    with _lock:
        _load_env_locked()
        s = _sites.get(site)
        if s is None or s.remaining == 0 or s.kind == "corrupt":
            return
        if s.remaining is not None:
            s.remaining -= 1
        s.fired += 1
        kind = s.kind
    if kind == "timeout":
        raise ChaosTimeout(f"chaos: injected device hang at {site}")
    if kind == "transient":
        raise ChaosTransientError(
            f"chaos: injected transient device failure at {site} (RESOURCE_EXHAUSTED)")
    raise ChaosPermanentError(f"chaos: injected permanent device failure at {site}")
