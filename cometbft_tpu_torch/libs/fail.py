"""Crash-site injection for WAL/handshake recovery testing.

Reference: libs/fail/fail.go:28-38 — `fail.Fail()` call sites indexed in
program order by FAIL_TEST_INDEX; when the running counter hits the
configured index the process dies immediately (os._exit, no cleanup —
simulating kill -9 at a precise point in the commit path).

Grown into a NAMED registry: every persistence boundary in the commit
path is a crash site, the legacy 5 indices are aliases into it, and the
crash-matrix harness (tests/test_storage_crash_matrix.py) arms sites
in-process with a hook instead of killing the OS process.

Sites (program order through one committed height; legacy index in
brackets — FAIL_TEST_INDEX still honors them):

  blockstore.save [0]  before the block is saved to the block store
  wal.endheight   [1]  after block save, before the WAL EndHeight fsync
  abci.apply      [2]  after the EndHeight fsync, before ApplyBlock
                       <- the committed-but-unapplied crash window
  state.finalize  [3]  after the FinalizeBlock response is persisted,
                       before the state save
  state.save      [4]  after the state save, before the app Commit
  app.commit           after the app Commit response, before the mempool
                       update (app and state agree; mempool rebuild)
  wal.write            before a WAL record is appended (any message)
  privval.save         after signing, before the sign-state file is
                       persisted (the signature must NOT have left yet —
                       crashing here must never enable a double-sign)

Arming: `CBFT_CRASH_SITE=site[:n]` dies on the site's n-th hit (default
1); `FAIL_TEST_INDEX=<0..4>` keeps the original semantics byte-for-byte
(same stderr marker, same exit code 99). In-proc: `arm(site, count,
hook)` — the hook replaces os._exit (the crash-matrix harness raises
libs.diskchaos.SimulatedCrash).

The port's copy of cometbft_tpu/libs/fail.py.
"""

from __future__ import annotations

import os
import sys
import threading

# legacy FAIL_TEST_INDEX -> named site (program order is load-bearing:
# the index IS the program-order position, fail.go:28)
LEGACY_SITES = (
    "blockstore.save",   # 0
    "wal.endheight",     # 1
    "abci.apply",        # 2
    "state.finalize",    # 3
    "state.save",        # 4
)

SITES = LEGACY_SITES + ("app.commit", "wal.write", "privval.save")

_ENV_INDEX = "FAIL_TEST_INDEX"
_ENV_SITE = "CBFT_CRASH_SITE"

_lock = threading.Lock()
_legacy_index: int | None = None
_armed: dict[str, dict] = {}  # site -> {"remaining": int, "hook": callable|None}
_hits: dict[str, int] = {}
_env_loaded = False


def _load_env_locked() -> None:
    global _env_loaded, _legacy_index
    if _env_loaded:
        return
    _env_loaded = True
    try:
        _legacy_index = int(os.environ.get(_ENV_INDEX, "-1"))
    except ValueError:
        _legacy_index = -1
    spec = os.environ.get(_ENV_SITE, "")
    if spec:
        site, _, count = spec.partition(":")
        site = site.strip()
        if site in SITES:
            try:
                n = int(count) if count else 1
            except ValueError:
                n = 1
            _armed[site] = {"remaining": max(1, n), "hook": None}


def arm(site: str, count: int = 1, hook=None) -> None:
    """Arm `site` to crash on its `count`-th hit. `hook` replaces the
    default os._exit(99) (in-proc harnesses raise SimulatedCrash)."""
    if site not in SITES:
        raise ValueError(f"unknown crash site {site!r} (sites: {SITES})")
    if count < 1:
        raise ValueError("crash count must be >= 1")
    with _lock:
        _load_env_locked()
        _armed[site] = {"remaining": count, "hook": hook}


def disarm(site: str) -> None:
    with _lock:
        _armed.pop(site, None)


def reset() -> None:
    """Disarm everything and forget the env (tests re-arm per case)."""
    global _env_loaded, _legacy_index
    with _lock:
        _armed.clear()
        _hits.clear()
        _env_loaded = True  # a reset() overrides the process env schedule
        _legacy_index = -1


def hits(site: str) -> int:
    """How many times the site has been passed (armed or not)."""
    with _lock:
        return _hits.get(site, 0)


def _die(site: str, legacy_index: int | None) -> None:
    if legacy_index is not None:
        sys.stderr.write(f"*** fail-point {legacy_index} triggered ***\n")
    else:
        sys.stderr.write(f"*** crash-site {site} triggered ***\n")
    sys.stderr.flush()
    os._exit(99)


def fail_point(site: str) -> None:
    """Call at a persistence boundary: dies (or fires the armed hook) iff
    this site is armed via env or arm(). Disarmed cost: one uncontended
    lock + two dict ops. The commit-path sites pay it a handful of times
    per height; wal.write pays it per WAL record, where it is noise next
    to the JSON encode + write the record itself costs (the hit counter
    is the crash-matrix's observability and is kept exact on purpose)."""
    hook = None
    trigger = False
    legacy = None
    with _lock:
        _load_env_locked()
        _hits[site] = _hits.get(site, 0) + 1
        try:
            idx = SITES.index(site)
        except ValueError:
            idx = -1
        if (_legacy_index is not None and _legacy_index >= 0
                and idx < len(LEGACY_SITES) and idx == _legacy_index):
            trigger, legacy = True, idx
        else:
            st = _armed.get(site)
            if st is not None:
                st["remaining"] -= 1
                if st["remaining"] <= 0:
                    _armed.pop(site, None)
                    trigger, hook = True, st["hook"]
    if not trigger:
        return
    if hook is not None:
        hook(site)
        return
    _die(site, legacy)


def fail(call_index: int) -> None:
    """Legacy indexed entry point (fail.go Fail): kept so old call sites
    and FAIL_TEST_INDEX fixtures keep working unchanged."""
    if 0 <= call_index < len(LEGACY_SITES):
        fail_point(LEGACY_SITES[call_index])
