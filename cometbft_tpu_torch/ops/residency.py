"""Device-resident key tables: a batch's pubkeys cross to the device as a
2-byte row index per lane, not as 32-byte keys or 320-byte decoded
coordinates. The port's counterpart of cometbft_tpu/ops/residency.py.

  KeyTable      one per (PubKeyCache, placement key): a (4, 20, cap) int32
                table of decoded coordinates and an (8, cap) plane of the
                keys' 32 encoding bytes as uint32 words (in an int32 tensor),
                on the cache's device, with a host key -> row map. Rows are
                content-keyed (exact pubkey bytes), so a row never serves
                another key. One row, cap - 1, is reserved for the identity
                encoding that padding lanes index.
  indexed send  a batch whose keys are resident ships a uint16 row index
                per lane; the device gathers the A coordinates (and, for
                the device challenges, the encoding words) by index.
  delta update  unseen keys are decoded through the cache and scattered into
                free or least-recently-used rows; rows the batch itself
                indexes are protected from eviction. The upload's checksum
                is taken on the device (K6) and must equal the host's.
  full path     a batch the table cannot hold (more unique keys than rows)
                returns None from stage(), and the caller takes the
                unique-key full path (ed25519_kernel._stage_gather).
  epoch pins    types/validation announces the validator set of every
                commit it verifies (announce_validator_set, keyed by
                ValidatorSet.hash()); a table pins the set's rows, so rider
                keys never evict them, and a new epoch pins its own rows,
                shipping only the keys it lacks. A known hash whose keys
                changed drops its pin and uploads the set again (counted);
                the rows are content-keyed, so no verdict depends on it.
                A table reconciles its pins when the announcements change,
                newest set first: the newest sets that fit together stay
                pinned. (The reference reconciles at every batch, oldest
                first, so two announced sets that do not fit together unpin
                and re-upload each other batch after batch: ROADMAP Queue
                3.)

The reference's device programs map to torch ops on the device: its table
init to zeros and ones, its scatter (_scatter_fn) to index_copy_, its
gathers (_gather_enc_fn, ed25519_kernel._gather_coords) to index_select.
JAX's scatter is functional; here the tables update in place, and stream
order gives the same snapshot: a batch's gathers are enqueued under the
table lock, before any later batch's scatter can be.

Placement keys: a table is keyed by its cache and a put_key. The single-card
path uses "", a mesh fault domain "devN" (parallel/mesh.py), so each domain
of a card holds its own tables; invalidate_device(N) drops domain N's, and
only its, when the mesh readmits it. The reference's config knob that turns
the indexed path off is not ported yet (ROADMAP Queue 1).

Send accounting: every host->device staging transfer is recorded under its
path, "indexed" (index vector + staged words), "delta" (row uploads) or
"full" (full-key path): ``send_stats()``.
"""

from __future__ import annotations

import hashlib
import threading
import weakref

import numpy as np
import torch

# ---------------------------------------------------------------- config

_cfg = {
    # rows per table: bounds device memory (352 B a row) and the uint16
    # index; one row is the identity padding row
    "rows": 16384,
}
_cfg_lock = threading.Lock()


def configure(rows: int | None = None) -> None:
    """Set the rows of tables built after the call (live tables keep
    theirs)."""
    with _cfg_lock:
        if rows is not None:
            if not 64 <= rows <= 65536:
                raise ValueError("rows must be in [64, 65536]")
            _cfg["rows"] = int(rows)


# ------------------------------------------------------- send accounting

_send_lock = threading.Lock()
_PATHS = ("indexed", "full", "delta")
_send_stats: dict[str, dict] = {p: {"sends": 0, "bytes": 0, "sigs": 0} for p in _PATHS}


def record_send(path: str, nbytes: int, sigs: int = 0) -> None:
    """Account a host->device staging transfer under its path. `sigs`
    counts live signature rows of the batch-carrying transfer only."""
    with _send_lock:
        s = _send_stats[path]
        s["sends"] += 1
        s["bytes"] += nbytes
        s["sigs"] += sigs


def send_stats() -> dict:
    """Per-path sends, bytes and signatures, with the bytes per signature
    of the indexed path (the steady state) and of the full path."""
    with _send_lock:
        out = {p: dict(v) for p, v in _send_stats.items()}
    for path, key in (("indexed", "steady_state_bytes_per_sig"),
                      ("full", "full_path_bytes_per_sig")):
        s = out[path]
        out[key] = round(s["bytes"] / s["sigs"], 2) if s["sigs"] else None
    return out


def reset_send_stats() -> None:
    with _send_lock:
        for p in _PATHS:
            _send_stats[p] = {"sends": 0, "bytes": 0, "sigs": 0}


# -------------------------------------------------------------- KeyTable


class _NoRoom(Exception):
    """The table cannot hold this batch: the caller takes the full path."""


def _id_coords(n: int) -> np.ndarray:
    """(4, 20, n) int32 extended identity coordinates (X=0, Y=1, Z=1,
    T=0): the padding of both schemes."""
    vals = np.zeros((4, 20, n), dtype=np.int32)
    vals[1, 0, :] = 1
    vals[2, 0, :] = 1
    return vals


def gather_coords(table: torch.Tensor, idx: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """(4, 20, cap) coordinate table and (B,) index -> the kernels' four
    contiguous (20, B) A coordinates."""
    g = table.index_select(2, idx)
    return tuple(g[i] for i in range(4))


class KeyTable:
    """One device-resident key table (see the module docstring). Public
    methods are serialized on the table lock."""

    def __init__(self, cache, rows: int, put_key: str = ""):
        self.scheme = cache.scheme.name
        self.cache = cache  # the scheme's PubKeyCache: the host decoder
        self.device = cache.device
        self.cap = int(rows)
        self.id_row = self.cap - 1  # the identity encoding, for padding lanes
        self.put_key = put_key
        self._lock = threading.RLock()
        self._rows: dict[bytes, int] = {}  # key -> row (dict order = LRU)
        self._ok: dict[bytes, bool] = {}
        self._free: list[int] = list(range(self.cap - 1))
        self._dev: tuple[torch.Tensor, torch.Tensor] | None = None
        # pinned epoch sets: set hash -> (content digest, keys), bounded so
        # that interleaved sets (light-client hops across epochs) keep theirs
        self._pinned_sets: dict[bytes, tuple[bytes, tuple]] = {}
        self._pin_count: dict[bytes, int] = {}  # key -> sets pinning it
        self._synced_version = -1  # the announcements the pins reflect
        self.counters = {"indexed_batches": 0, "delta_updates": 0, "delta_rows": 0,
                         "evictions": 0, "full_set_uploads": 0, "hash_mismatches": 0}

    _MAX_PINNED_SETS = 4

    def _build(self) -> tuple[torch.Tensor, torch.Tensor]:
        """The device tables, made on the device (no upload) at first use:
        every row the identity, coordinates and encoding (y = 1: word 0 is
        1, which both schemes' identity rows decode to)."""
        if self._dev is None:
            coords = torch.zeros((4, 20, self.cap), dtype=torch.int32, device=self.device)
            coords[1, 0] = 1
            coords[2, 0] = 1
            enc = torch.zeros((8, self.cap), dtype=torch.int32, device=self.device)
            enc[0] = 1
            self._dev = (coords, enc)
        return self._dev

    # ---------------------------------------------------------- eviction

    def _alloc_rows(self, n: int, protect: frozenset = frozenset()) -> list[int]:
        """Take n free rows, then evict for the rest the least-recently-used
        unpinned rows outside `protect` (the batch's own resident keys), in
        one pass over the LRU order: the rows that evicting one at a time
        from the oldest would take (the reference restarts its scan at each
        eviction, which is quadratic when many old rows are pinned). When
        too few rows are evictable, the evictable ones are evicted, every row
        taken goes back to the free list and _NoRoom is raised."""
        out = [self._free.pop() for _ in range(min(n, len(self._free)))]
        victims: list[bytes] = []
        if len(out) < n:
            for key in self._rows:  # dict order: oldest first
                if self._pin_count.get(key, 0) == 0 and key not in protect:
                    victims.append(key)
                    if len(out) + len(victims) == n:
                        break
        for key in victims:
            out.append(self._rows.pop(key))
            self._ok.pop(key, None)
        self.counters["evictions"] += len(victims)
        if len(out) < n:
            self._free.extend(out)
            raise _NoRoom("every resident row is pinned or staged by this batch")
        return out

    # ------------------------------------------------------------ deltas

    def _insert_keys(self, missing: list[bytes], protect: frozenset = frozenset(),
                     path: str = "delta") -> int:
        """Decode and scatter `missing` keys into free or LRU rows; returns
        the bytes uploaded, accounted under `path`."""
        if not missing:
            return 0
        if len(missing) > self.cap - 1:
            raise _NoRoom(f"{len(missing)} keys exceed the table")
        ok, coords = self.cache.lookup_or_decompress(missing)
        rows = self._alloc_rows(len(missing), protect=protect)
        try:
            return self._upload_rows(missing, ok, coords, rows, path)
        except Exception:
            self._free.extend(rows)  # a failed upload must not drain capacity
            raise

    def _upload_rows(self, missing, ok, coords, rows, path) -> int:
        from cometbft_tpu_torch.ops import ed25519_kernel as EK
        from cometbft_tpu_torch.ops import integrity

        db = EK.bucket_size(len(missing))
        # (4, 20, db) identity-padded; padding rewrites the identity row with
        # identity values, an idempotent no-op
        vals = _id_coords(db)
        vals[:, :, :len(missing)] = coords.transpose(1, 2, 0)
        enc = np.zeros((8, db), dtype=np.uint32)
        enc[0, :] = 1
        enc[:, :len(missing)] = np.frombuffer(
            b"".join(missing), dtype=np.uint8).reshape(-1, 32).view("<u4").T
        idx = np.full(db, self.id_row, dtype=np.int64)
        idx[:len(missing)] = rows
        expected = integrity.host_checksum(vals, enc)
        coords_t, enc_t = self._build()
        vals_d = torch.from_numpy(vals).to(self.device)
        enc_d = torch.from_numpy(enc.view(np.int32)).to(self.device)
        got = integrity.device_checksum(vals_d, enc_d)
        if got != expected:
            raise RuntimeError(f"key-table upload failed its checksum ({got:#x} on the "
                               f"device, {expected:#x} sent)")
        idx_d = torch.from_numpy(idx).to(self.device)
        coords_t.index_copy_(2, idx_d, vals_d)
        enc_t.index_copy_(1, idx_d, enc_d)
        for i, key in enumerate(missing):
            self._rows[key] = rows[i]
            self._ok[key] = bool(ok[i])
        self.counters["delta_updates"] += 1
        self.counters["delta_rows"] += len(missing)
        nbytes = vals.nbytes + enc.nbytes + 4 * db
        record_send(path, nbytes)
        return nbytes

    # --------------------------------------------------------- epoch pins

    def _sync_sets(self, announced: dict[bytes, tuple[bytes, tuple]]) -> None:
        """Reconcile the pinned sets with the announced ones (oldest first
        in `announced`): the newest sets are kept pinned while they fit the
        table together (at most _MAX_PINNED_SETS); every other set is
        unpinned (its rows stay as plain LRU rows). A kept set not yet
        pinned inserts its missing keys and pins; a kept hash whose keys
        changed unpins and uploads the set again (counted). The newest set
        never gives its room to an older one, so two sets too large to pin
        together do not evict each other at every reconciliation (the
        reference's loop pins them in age order, each evicting the other)."""
        keep: list[bytes] = []
        rows = 0
        for h, (_, keys) in reversed(list(announced.items())):
            n = len(dict.fromkeys(keys))
            if len(keep) < self._MAX_PINNED_SETS and rows + n <= self.cap - 1:
                keep.append(h)
                rows += n
        for h in list(self._pinned_sets):
            if h not in keep:
                self._unpin(h)
        for h in keep:
            digest, keys = announced[h]
            uniq = list(dict.fromkeys(keys))
            cur = self._pinned_sets.get(h)
            if cur is not None and cur[0] == digest:
                continue
            path = "delta"
            if cur is not None:
                self.counters["hash_mismatches"] += 1
                self.counters["full_set_uploads"] += 1
                self._unpin(h)
                path = "full"
            self._insert_keys([k for k in uniq if k not in self._rows],
                              protect=frozenset(uniq), path=path)
            self._pin(h, digest, uniq)

    def _pin(self, set_hash: bytes, digest: bytes, keys) -> None:
        keys = tuple(dict.fromkeys(keys))
        self._pinned_sets[set_hash] = (digest, keys)
        for k in keys:
            self._pin_count[k] = self._pin_count.get(k, 0) + 1

    def _unpin(self, set_hash: bytes) -> None:
        _, keys = self._pinned_sets.pop(set_hash)
        for k in keys:
            c = self._pin_count.get(k, 0) - 1
            if c <= 0:
                self._pin_count.pop(k, None)
            else:
                self._pin_count[k] = c

    # ------------------------------------------------------------ staging

    def stage(self, pubs: list[bytes], bucket: int, want_enc: bool = False,
              announced: dict | None = None, version: int | None = None):
        """The indexed send: (ok_a (N,), (ax, ay, az, at) (20, bucket)
        device tensors, index bytes), with want_enc the (8, bucket) int32
        encoding words between the coordinates and the byte count. The
        announced epoch sets are pinned first, then unseen keys
        delta-insert; raises _NoRoom when the batch does not fit. `version`
        names the announcements: the pins are
        reconciled only when it changes (always when it is None)."""
        with self._lock:
            if announced is not None and (version is None or version != self._synced_version):
                self._sync_sets(announced)
                self._synced_version = -1 if version is None else version
            uniq = dict.fromkeys(pubs)
            if len(uniq) > self.cap - 1:
                raise _NoRoom(f"{len(uniq)} unique keys exceed the table")
            missing = [k for k in uniq if k not in self._rows]
            for k in uniq:  # LRU-touch the batch's resident keys
                row = self._rows.pop(k, None)
                if row is not None:
                    self._rows[k] = row
            self._insert_keys(missing, protect=frozenset(uniq))
            idx = np.full(bucket, self.id_row, dtype=np.uint16)
            idx[:len(pubs)] = [self._rows[p] for p in pubs]
            ok_a = np.fromiter((self._ok[p] for p in pubs), dtype=bool, count=len(pubs))
            coords_t, enc_t = self._build()
            self.counters["indexed_batches"] += 1
            # the 2 B/lane index: uint16 bits in an int16 tensor, widened on
            # the device. The gathers are enqueued before the lock is let go,
            # so a later batch's eviction scatters after them.
            idx_d = torch.from_numpy(idx.view(np.int16)).to(self.device).to(torch.int64) & 0xFFFF
            coords = gather_coords(coords_t, idx_d)
            if want_enc:
                return ok_a, coords, enc_t.index_select(1, idx_d), idx.nbytes
            return ok_a, coords, idx.nbytes

    def rows_of(self, pubs: list[bytes]) -> list[int]:
        """The rows the keys `pubs` occupy (tests)."""
        with self._lock:
            return [self._rows[p] for p in pubs]

    def pinned(self) -> dict[bytes, int]:
        """Pinned set hash -> its keys (tests)."""
        with self._lock:
            return {h: len(v[1]) for h, v in self._pinned_sets.items()}

    def stats(self) -> dict:
        with self._lock:
            return dict(self.counters, rows=len(self._rows), capacity=self.cap,
                        pinned_sets=len(self._pinned_sets),
                        pinned_rows=len(self._pin_count), free_rows=len(self._free))


# ------------------------------------------------------ registry

_reg_lock = threading.Lock()
# cache -> {put_key: KeyTable}: a table lives as long as its cache
_tables: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
# announced epoch sets per scheme name: set hash -> (content digest, keys),
# the newest _MAX_ANNOUNCED
_announced: dict[str, dict[bytes, tuple[bytes, tuple]]] = {}
_MAX_ANNOUNCED = 4
_last_announced_hash: bytes | None = None
_announce_version = 0  # bumped at every change of _announced


def announce_validator_set(vals) -> None:
    """Register the active validator set for the key tables' epoch pins
    (types/validation calls this on every commit it verifies). A stamp on
    the object makes a repeated announcement of the same ValidatorSet free:
    ValidatorSet.hash() is an O(N) Merkle root. A set changed after its
    stamp pins one epoch late, which costs delta bytes, never a verdict
    (rows are content-keyed)."""
    global _last_announced_hash, _announce_version
    if getattr(vals, "_wire_announced", False):
        return
    h = vals.hash()
    if h != _last_announced_hash:
        by_scheme: dict[str, list[bytes]] = {}
        for v in vals.validators:
            by_scheme.setdefault(v.pub_key.type_(), []).append(v.pub_key.bytes_())
        with _reg_lock:
            for scheme, keys in by_scheme.items():
                if scheme not in ("ed25519", "sr25519"):
                    continue
                sets = _announced.setdefault(scheme, {})
                if h in sets:
                    continue
                while len(sets) >= _MAX_ANNOUNCED:
                    sets.pop(next(iter(sets)))
                sets[h] = (hashlib.sha256(b"".join(keys)).digest(), tuple(keys))
                _announce_version += 1
            _last_announced_hash = h
    vals._wire_announced = True


def register_set(scheme: str, set_hash: bytes, keys: list[bytes]) -> None:
    """Register an epoch set directly (tests, callers that know the set
    hash without a ValidatorSet)."""
    global _last_announced_hash, _announce_version
    with _reg_lock:
        sets = _announced.setdefault(scheme, {})
        sets.pop(set_hash, None)
        while len(sets) >= _MAX_ANNOUNCED:
            sets.pop(next(iter(sets)))
        sets[set_hash] = (hashlib.sha256(b"".join(keys)).digest(), tuple(keys))
        _last_announced_hash = None
        _announce_version += 1


def clear_announced() -> None:
    """Forget the announced epoch sets (the tables unpin them at their next
    batch); the tables and their rows stay."""
    global _last_announced_hash, _announce_version
    with _reg_lock:
        _announced.clear()
        _last_announced_hash = None
        _announce_version += 1


def table_for(cache, put_key: str = "") -> KeyTable:
    """The cache's table for `put_key`, built on first use with the rows
    configured then."""
    with _reg_lock:
        per = _tables.setdefault(cache, {})
        tbl = per.get(put_key)
        if tbl is None:
            tbl = per[put_key] = KeyTable(cache, _cfg["rows"], put_key=put_key)
        return tbl


def stage(cache, pubs: list[bytes], bucket: int, put_key: str = "", want_enc: bool = False):
    """The indexed path for a batch: KeyTable.stage's tuple, or None when
    the full path must serve it (more unique keys than the table holds).
    The scheme's announced epoch sets are pinned on the way. Any other
    failure raises."""
    tbl = table_for(cache, put_key)
    with _reg_lock:
        announced = dict(_announced.get(tbl.scheme, {}))
        version = _announce_version
    try:
        return tbl.stage(pubs, bucket, want_enc=want_enc, announced=announced, version=version)
    except _NoRoom:
        return None


def invalidate_device(index: int) -> int:
    """Drop every table of mesh fault domain `index` (put_key "devN"): its
    key tables over every cache and its device-challenge prefix tables
    (ops/challenge.py). The mesh calls it when it readmits the domain, so a
    healed domain serves no table staged before its fault; the other
    domains' tables stay. Returns the number of tables dropped."""
    from cometbft_tpu_torch.ops import challenge

    key = f"dev{index}"
    dropped = 0
    with _reg_lock:
        for per in _tables.values():
            if per.pop(key, None) is not None:
                dropped += 1
    return dropped + challenge.drop_tables(key)


def reset() -> None:
    """Forget every table, announcement and send counter (tests)."""
    global _last_announced_hash, _announce_version
    with _reg_lock:
        _tables.clear()
        _announced.clear()
        _last_announced_hash = None
        _announce_version += 1
    reset_send_stats()
