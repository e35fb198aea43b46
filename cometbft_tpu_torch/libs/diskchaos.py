"""Disk-fault injection registry (the storage analog of libs/chaos.py
and p2p/netchaos.py).

chaos.py breaks the DEVICE, netchaos.py breaks the WIRE; diskchaos.py
breaks the DISK at the real file seams every committed height ultimately
rests on. Sites:

  wal.write          one consensus-WAL record append (libs/autofile
                     Group.write via consensus/wal.py)
  wal.fsync          the WAL group fsync (write_sync / EndHeight / flush)
  wal.rotate         the head->chunk rename inside Group.maybe_rotate
  wal.read           one WAL record read during replay (iter_records)
  db.write           one SQLiteDB set/delete/batch transaction
  db.read            one SQLiteDB get (value returned to the caller)
  privval.save       the sign-state durable_replace (privval/file_pv.py)
  blockstore.save    the block-store save batch (store/blockstore.py)
  addrbook.save      the PEX address-book durable write
                     (p2p/pex/addrbook.py AddrBook.save)

Kinds (not every kind applies at every seam; an armed kind waits,
un-consumed, at seams it does not apply to):

  torn_write   write a PREFIX of the bytes, then die (the power-loss torn
               write; at non-byte seams: die before the operation lands).
               Death = the crash hook — os._exit(99) by default, exactly
               like libs/fail.py; in-proc harnesses install a hook that
               raises SimulatedCrash instead and then apply the
               crash-file model (crash_truncate) before "rebooting".
  fsync_error  the fsync raises EIO
  fsync_lie    the fsync returns success but NOTHING was made durable: on
               a real disk this is an ack-then-drop firmware lie only a
               power cut exposes — the in-proc model records the last
               genuinely-durable size per file and crash_truncate()
               rewinds lied files to it at simulated-crash time
  enospc       the write raises ENOSPC
  eio          the write/read raises EIO
  bitrot       a read returns the stored bytes with one bit flipped
  slow         the operation sleeps SLOW_SECONDS first, then proceeds

Arming mirrors the other planes: `CBFT_DISK_CHAOS` env, the
`storage.chaos` config knob (node boot), or the `unsafe_disk_chaos` RPC
route, all using the `site=kind[:count]` schedule syntax. Faults are
deterministic (plain per-site counters, no randomness) and every firing
is counted into the storage metrics plane (libs/metrics.storage_metrics)
so `storage_health` can account for every injected fault.

The port's copy of cometbft_tpu/libs/diskchaos.py.
"""

from __future__ import annotations

import errno
import os
import threading
import time

SITES = (
    "wal.write",
    "wal.fsync",
    "wal.rotate",
    "wal.read",
    "db.write",
    "db.read",
    "privval.save",
    "blockstore.save",
    "addrbook.save",
)

KINDS = ("torn_write", "fsync_error", "fsync_lie", "enospc", "eio",
         "bitrot", "slow")

# seconds an injected `slow` fault stalls the seam (a degraded disk, not
# a dead one — long enough to surface in the fsync latency plane, short
# enough that liveness budgets absorb it)
SLOW_SECONDS = 0.05

_ENV = "CBFT_DISK_CHAOS"


class DiskChaosError(OSError):
    """An injected disk fault (errno carries ENOSPC/EIO like the real
    thing; `isinstance(e, DiskChaosError)` tells tests it was injected)."""


class SimulatedCrash(BaseException):
    """Raised by an in-proc crash hook instead of os._exit: the harness
    catches it, abandons the node's open handles, applies
    crash_truncate(), and reboots the node from disk. BaseException so
    no library except-Exception handler can swallow a 'power cut'."""

    def __init__(self, site: str):
        super().__init__(f"simulated power loss at {site}")
        self.site = site


class _Site:
    __slots__ = ("kind", "remaining", "fired")

    def __init__(self, kind: str, remaining: int | None):
        self.kind = kind
        self.remaining = remaining  # None = unlimited
        self.fired = 0


_lock = threading.Lock()
_sites: dict[str, _Site] = {}
_env_loaded = False
_crash_hook = None  # None -> os._exit(99)
# unlocked fast-path gate: the seams sit on per-record hot paths (every
# WAL append/fsync, every db op) — an unarmed process must not pay a
# lock per operation. Maintained under _lock wherever _sites mutates;
# the benign race (a stale False for one op right at arm time) cannot
# matter to the deterministic schedules, which arm before traffic.
_active = False

# the fsync-lie power-loss model: last genuinely durable size per path
# (updated by every real fsync through a seam) and the rewind list
# recorded when a lie fires — (path, durable_size, None) for append
# seams, (dst, old_content|None, src) for rename seams. crash_truncate()
# applies the rewinds.
_durable_sizes: dict[str, int] = {}
_lies: list[tuple[str, object, str | None]] = []


def parse_spec(spec: str) -> list[tuple[str, str, int | None]]:
    """Parse `site=kind[:count],...` into (site, kind, count) triples,
    raising ValueError on any malformed part — config validation uses
    this so a typo'd schedule fails at boot, not inside a WAL fsync."""
    out: list[tuple[str, str, int | None]] = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        site, _, fault = part.partition("=")
        kind, _, count = fault.partition(":")
        site, kind = site.strip(), kind.strip()
        if site not in SITES:
            raise ValueError(f"unknown disk-chaos site {site!r} (sites: {SITES})")
        if kind not in KINDS:
            raise ValueError(f"unknown disk-chaos kind {kind!r} (kinds: {KINDS})")
        if count:
            try:
                n = int(count)
            except ValueError:
                raise ValueError(f"bad disk-chaos count {count!r} in {part!r}") from None
            if n < 0:
                raise ValueError(f"negative disk-chaos count in {part!r}")
        else:
            n = None
        out.append((site, kind, n))
    return out


def _load_env_locked() -> None:
    global _env_loaded, _active
    if _env_loaded:
        return
    _env_loaded = True
    spec = os.environ.get(_ENV, "")
    if not spec:
        return
    try:
        for site, kind, count in parse_spec(spec):
            _sites[site] = _Site(kind, count)
        _active = bool(_sites)
    except ValueError as e:
        # same floor as libs/chaos.py: the env loads lazily at the first
        # seam, where raising would be misread as a real disk failure
        from cometbft_tpu_torch.libs import log as _log

        _log.default().error(
            "ignoring malformed CBFT_DISK_CHAOS schedule", spec=spec, err=str(e))


def arm(site: str, kind: str, count: int | None = None) -> None:
    if site not in SITES:
        raise ValueError(f"unknown disk-chaos site {site!r} (sites: {SITES})")
    if kind not in KINDS:
        raise ValueError(f"unknown disk-chaos kind {kind!r} (kinds: {KINDS})")
    global _active
    with _lock:
        _load_env_locked()
        _sites[site] = _Site(kind, count)
        _active = True


def arm_spec(spec: str) -> None:
    triples = parse_spec(spec)  # validate the WHOLE spec before arming any
    global _active
    with _lock:
        _load_env_locked()
        for site, kind, count in triples:
            _sites[site] = _Site(kind, count)
        _active = bool(_sites)


def disarm(site: str) -> None:
    global _active
    with _lock:
        _sites.pop(site, None)
        _active = bool(_sites)


def reset() -> None:
    """Disarm everything, forget the env, clear the crash-file model and
    the crash hook (tests re-arm per case)."""
    global _env_loaded, _crash_hook, _active
    with _lock:
        _sites.clear()
        _active = False
        _env_loaded = True  # a reset() overrides the process env schedule
        _durable_sizes.clear()
        _lies.clear()
        _crash_hook = None


def armed(site: str) -> str | None:
    with _lock:
        _load_env_locked()
        s = _sites.get(site)
        return s.kind if s is not None and s.remaining != 0 else None


def fired(site: str) -> int:
    with _lock:
        s = _sites.get(site)
        return s.fired if s is not None else 0


def snapshot() -> dict:
    """Armed sites + fire counts (the storage_health RPC section)."""
    with _lock:
        _load_env_locked()
        return {
            site: {"kind": s.kind, "remaining": s.remaining, "fired": s.fired}
            for site, s in _sites.items()
        }


def set_crash_hook(hook) -> None:
    """Install the death behavior for torn_write crashes. None restores
    the default os._exit(99). In-proc harnesses pass a callable raising
    SimulatedCrash(site)."""
    global _crash_hook
    with _lock:
        _crash_hook = hook


def _take(site: str, applicable: tuple) -> str | None:
    """Consume one firing iff the armed kind applies at this seam type —
    an inapplicable kind stays armed, waiting for its seam. Unarmed
    processes exit on the lock-free gate above the lock."""
    if _env_loaded and not _active:
        return None
    with _lock:
        _load_env_locked()
        s = _sites.get(site)
        if s is None or s.remaining == 0 or s.kind not in applicable:
            return None
        if s.remaining is not None:
            s.remaining -= 1
        s.fired += 1
        kind = s.kind
    _count_fault(site, kind)
    return kind


def _count_fault(site: str, kind: str) -> None:
    from cometbft_tpu_torch.libs import metrics as cmtmetrics

    cmtmetrics.storage_metrics().disk_faults.labels(site, kind).inc()


def _crash(site: str) -> None:
    hook = _crash_hook
    if hook is not None:
        hook(site)
        return  # a hook that returns leaves the process running
    import sys

    sys.stderr.write(f"*** disk-chaos crash at {site} ***\n")
    sys.stderr.flush()
    os._exit(99)


# ------------------------------------------------------------------ seams


def fault_write(site: str, fh, data: bytes) -> None:
    """The byte-append seam: write `data` to file object `fh`, honoring
    any armed fault. torn_write flushes a strict prefix to the OS, then
    dies — the half-record a power cut leaves behind."""
    kind = _take(site, ("torn_write", "enospc", "eio", "slow"))
    if kind is None:
        fh.write(data)
        return
    if kind == "enospc":
        raise DiskChaosError(errno.ENOSPC,
                             f"disk-chaos: injected ENOSPC at {site}")
    if kind == "eio":
        raise DiskChaosError(errno.EIO, f"disk-chaos: injected EIO at {site}")
    if kind == "slow":
        time.sleep(SLOW_SECONDS)
        fh.write(data)
        return
    # torn_write: a strict non-empty prefix (never the whole record)
    fh.write(data[:max(1, len(data) // 2)])
    fh.flush()
    _crash(site)


def fault_fsync(site: str, fd: int, path: str | None = None) -> None:
    """The fsync seam: os.fsync(fd) unless a fault is armed. A real fsync
    updates the path's durable size (the fsync-lie rewind anchor) AND
    cancels the path's pending append lies — an honest fsync flushes all
    dirty pages, including the ones an earlier lie dropped on the floor.
    A lie records the stale durable size for crash_truncate(); only the
    FIRST pending lie per path is kept (no real fsync ran in between, so
    later lies carry the identical anchor)."""
    kind = _take(site, ("fsync_error", "fsync_lie", "slow"))
    if kind == "fsync_error":
        raise DiskChaosError(errno.EIO,
                             f"disk-chaos: injected fsync failure at {site}")
    if kind == "fsync_lie":
        if path is not None:
            with _lock:
                if not any(p == path and src is None for p, _, src in _lies):
                    _lies.append((path, _durable_sizes.get(path, 0), None))
        return
    if kind == "slow":
        time.sleep(SLOW_SECONDS)
    os.fsync(fd)
    if path is not None:
        with _lock:
            _durable_sizes[path] = os.fstat(fd).st_size
            _lies[:] = [e for e in _lies
                        if not (e[0] == path and e[2] is None)]


def fault_replace(site: str, src: str, dst: str) -> None:
    """The durable-rename seam (libs/diskio.durable_replace): os.replace
    + containing-directory fsync, honoring armed faults. fsync_lie skips
    the directory fsync and records the OLD dst content — at simulated
    crash time the rename is rolled back (the power cut dropped the
    un-fsynced directory entry)."""
    kind = _take(site, ("torn_write", "enospc", "eio", "slow",
                        "fsync_error", "fsync_lie"))
    if kind == "enospc":
        raise DiskChaosError(errno.ENOSPC,
                             f"disk-chaos: injected ENOSPC at {site}")
    if kind == "eio":
        raise DiskChaosError(errno.EIO, f"disk-chaos: injected EIO at {site}")
    if kind == "slow":
        time.sleep(SLOW_SECONDS)
    if kind == "torn_write":
        # power dies mid-rename: the new name never lands
        _crash(site)
    old: bytes | None = None
    if kind == "fsync_lie":
        try:
            with open(dst, "rb") as f:
                old = f.read()
        except FileNotFoundError:
            old = None
    os.replace(src, dst)
    if kind == "fsync_lie":
        # the rename's directory entry never reached disk: at crash time
        # the OLD directory wins — src reappears with the new content and
        # dst reverts to its old content (or absence). Recording src is
        # load-bearing for WAL rotation, where "dst reverts" alone would
        # destroy a whole chunk of records no power cut could take.
        with _lock:
            _lies.append((dst, old, src))
        return
    d = os.path.dirname(os.path.abspath(dst))
    dfd = os.open(d, os.O_RDONLY)
    try:
        if kind == "fsync_error":
            raise DiskChaosError(
                errno.EIO, f"disk-chaos: injected directory-fsync failure at {site}")
        os.fsync(dfd)
    finally:
        os.close(dfd)
    with _lock:
        # an honest directory fsync persists EVERY pending rename in this
        # directory — cancel their recorded lies
        _lies[:] = [e for e in _lies
                    if not (e[2] is not None
                            and os.path.dirname(os.path.abspath(e[0])) == d)]
        try:
            _durable_sizes[dst] = os.path.getsize(dst)
        except OSError:
            pass


def fault_read(site: str, data: bytes) -> bytes:
    """The read seam: return `data` as stored, or with one bit flipped
    (bitrot), or raise EIO. The CRC planes above this seam must turn a
    flipped bit into a typed error, never a corrupt record."""
    kind = _take(site, ("bitrot", "eio", "slow"))
    if kind is None:
        return data
    if kind == "eio":
        raise DiskChaosError(errno.EIO, f"disk-chaos: injected EIO at {site}")
    if kind == "slow":
        time.sleep(SLOW_SECONDS)
        return data
    if not data:
        return data
    out = bytearray(data)
    out[0] ^= 0x01
    return bytes(out)


def fault_op(site: str) -> None:
    """The opaque-operation seam (SQLite transactions, block-store save):
    enospc/eio raise before anything lands; torn_write dies mid-operation
    (the caller placed this call where a power cut would tear — e.g.
    between the statements of a batch, where only a real transaction
    saves you); slow stalls."""
    kind = _take(site, ("torn_write", "enospc", "eio", "slow"))
    if kind is None:
        return
    if kind == "enospc":
        raise DiskChaosError(errno.ENOSPC,
                             f"disk-chaos: injected ENOSPC at {site}")
    if kind == "eio":
        raise DiskChaosError(errno.EIO, f"disk-chaos: injected EIO at {site}")
    if kind == "slow":
        time.sleep(SLOW_SECONDS)
        return
    _crash(site)


def track_open(path: str, fresh: bool = False) -> None:
    """Record a file's size at open as its durable baseline (everything
    already on disk at open is assumed durable). Called by the append
    seams (autofile Group) so a later fsync_lie knows where to rewind.
    `fresh=True` re-anchors unconditionally — rotation reopens the head
    path as a NEW empty file, and keeping the renamed-away chunk's
    anchor would rewind (and zero-extend!) the wrong file."""
    with _lock:
        if fresh or path not in _durable_sizes:
            try:
                _durable_sizes[path] = os.path.getsize(path)
            except OSError:
                _durable_sizes[path] = 0


def crash_truncate() -> list[str]:
    """Apply the power-loss model for every recorded fsync lie: append
    seams are truncated back to the last genuinely durable size, rename
    seams are rolled back to the old content (or unlinked when the file
    did not exist). Returns the repaired paths. The in-proc crash
    harness calls this between 'power cut' and 'reboot'; the OS-process
    path never needs it (a real kill leaves the kernel page cache
    intact — only real power loss exposes a lying fsync)."""
    with _lock:
        lies, _lies[:] = list(_lies), ()
    touched = []
    for path, state, src in lies:
        try:
            if src is not None:
                # rename rollback: the new content returns to the src
                # name, dst reverts to its old content or to absence
                if os.path.exists(path):
                    os.replace(path, src)
                if isinstance(state, bytes):
                    with open(path, "wb") as f:
                        f.write(state)
            elif isinstance(state, int):
                # clamp: power loss can only SHRINK a file — truncating
                # past the current size would zero-extend, and a zeroed
                # region is not something a dropped write leaves behind
                try:
                    size = os.path.getsize(path)
                except OSError:
                    continue
                with open(path, "r+b") as f:
                    f.truncate(min(state, size))
            else:
                with open(path, "wb") as f:
                    f.write(state)
        except OSError:
            continue
        touched.append(path)
    return touched
