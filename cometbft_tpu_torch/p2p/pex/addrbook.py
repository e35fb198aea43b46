"""Address book (reference: p2p/pex/addrbook.go).

Known peer addresses bucketed NEW (heard about) vs OLD (connected
successfully), with attempt/success bookkeeping, biased random selection,
ban marking, and durable JSON persistence.

HASHED-BUCKET GEOMETRY (addrbook.go:70-140): the NEW set is 256 buckets
of 64 slots, the OLD set 64 buckets of 64 slots. A NEW address's bucket
index is keyed by a PERSISTED RANDOM BOOK NONCE plus the gossip SOURCE's
/16 group: for any one source group only NEW_BUCKETS_PER_GROUP (32) of
the 256 bucket indices are reachable, so an attacker controlling many
source identities behind one /16 can occupy at most 32*64 slots (12.5%
of the NEW bucket space) no matter how many identities or claimed
addresses it floods — the eclipse-precursor defense the flat-dict book
explicitly lacked. OLD bucket indices are keyed by the ADDRESS's own
group (OLD entries were dialed successfully; their host is earned, not
claimed). The nonce persists with the book so bucket placement survives
restarts; a fresh nonce (new book) re-shuffles the geometry, which is
exactly the reference behavior.

Eviction is bias-aware and bucket-local: a full NEW bucket evicts its
worst entry (most failed attempts, oldest attempt), never a PROTECTED
entry (persistent/unconditional peers the operator configured). NEW->OLD
graduation moves the entry between bucket arrays; a full OLD bucket
demotes its worst entry back to NEW to make room.

Persistence rides libs/diskio.atomic_write_durable through the
`addrbook.save` disk-chaos site: a torn/corrupt book file quarantines to
`<path>.corrupt` at load and the node boots with an empty book instead
of bricking (the flat book raised out of _load on one bad byte).

The port's copy of cometbft_tpu/p2p/pex/addrbook.py.
"""

from __future__ import annotations

import hashlib
import json
import os
import random
import time
from dataclasses import dataclass

# geometry (addrbook.go:70-140; bucket counts per the reference, sizes
# shared: 64 slots per bucket either set)
NEW_BUCKET_COUNT = 256
OLD_BUCKET_COUNT = 64
BUCKET_SIZE = 64
# buckets one SOURCE group can reach in the NEW set / one ADDRESS group
# in the OLD set (addrbook.go newBucketsPerGroup / oldBucketsPerGroup)
NEW_BUCKETS_PER_GROUP = 32
OLD_BUCKETS_PER_GROUP = 4

# dial-failure backoff: a failed address is not re-picked until
# BACKOFF_BASE * 2^(attempts-1) (capped) has passed since the attempt —
# ensure-peers must not hammer the same dead address every interval
BACKOFF_BASE = 10.0
BACKOFF_MAX = 600.0
# a NEW address that failed this many consecutive dials is expired from
# the book entirely (protected addresses never expire)
MAX_NEW_FAILURES = 8


def group16(host: str) -> str:
    """The /16 group of a host: 'a.b' for a dotted-quad IPv4, the literal
    host for names (a DNS name is its own routing domain for our
    purposes), 'local' when unknown/empty."""
    if not host:
        return "local"
    parts = host.split(".")
    if len(parts) == 4 and all(p.isdigit() for p in parts):
        return f"{parts[0]}.{parts[1]}"
    return host.lower()


@dataclass
class NetAddress:
    """pex/addrbook.go knownAddress + p2p.NetAddress."""

    node_id: str
    host: str
    port: int
    src_id: str = ""
    # the gossip source's SOCKET host (unforgeable, set by the PEX
    # reactor from the live connection) — the bucket key ingredient
    src_host: str = ""
    attempts: int = 0
    last_attempt: float = 0.0
    last_success: float = 0.0
    banned_until: float = 0.0
    is_old: bool = False  # graduated to the OLD (tried) set

    @property
    def addr(self) -> str:
        return f"{self.node_id}@{self.host}:{self.port}"

    @property
    def group(self) -> str:
        return group16(self.host)

    @property
    def src_group(self) -> str:
        return group16(self.src_host)

    @classmethod
    def parse(cls, s: str, src_id: str = "") -> "NetAddress":
        node_id, _, hostport = s.partition("@")
        host, _, port = hostport.rpartition(":")
        return cls(node_id=node_id, host=host or "127.0.0.1",
                   port=int(port), src_id=src_id)

    def is_banned(self, now: float) -> bool:
        return now < self.banned_until

    def dial_backoff(self) -> float:
        if self.attempts <= 0:
            return 0.0
        return min(BACKOFF_BASE * (2 ** (self.attempts - 1)), BACKOFF_MAX)

    def dial_eligible(self, now: float) -> bool:
        """Not banned and past the failure backoff window."""
        if self.is_banned(now):
            return False
        return now - self.last_attempt >= self.dial_backoff()


class AddrBook:
    """pex/addrbook.go:70-640 (hashed-bucket geometry)."""

    # addrbook.go getSelection: 23% of the book, at least 32 addresses
    # (all of a smaller book) and at most 250
    SELECT_PCT = 23
    MIN_SELECTION = 32
    MAX_SELECTION = 250

    def __init__(self, file_path: str = "", our_id: str = "",
                 rng: random.Random | None = None):
        self.file_path = file_path
        self.our_id = our_id
        self._rng = rng or random.Random()
        self._nonce = os.urandom(16).hex()
        self._addrs: dict[str, NetAddress] = {}  # id -> record (index)
        self._bucket_of: dict[str, int] = {}     # id -> bucket index
        self._new: list[dict[str, NetAddress]] = [
            {} for _ in range(NEW_BUCKET_COUNT)]
        self._old: list[dict[str, NetAddress]] = [
            {} for _ in range(OLD_BUCKET_COUNT)]
        # persistent/unconditional peers: never evicted, never expired
        self._protected: set[str] = set()
        self.metrics = None  # libs.metrics.P2PMetrics | None (node wires)
        # set when a corrupt book file was quarantined at load (the node
        # logs it; the boot continues with an empty book)
        self.load_error = ""
        self.quarantined_path = ""
        if file_path and os.path.exists(file_path):
            self._load()

    # ------------------------------------------------------------ geometry

    def _hash(self, *parts: str) -> int:
        h = hashlib.sha256("|".join((self._nonce,) + parts).encode())
        return int.from_bytes(h.digest()[:8], "big")

    def new_bucket_index(self, addr: NetAddress) -> int:
        """addrbook.go calcNewBucket: the inner hash (keyed by both the
        address and source groups) picks one of NEW_BUCKETS_PER_GROUP
        slots; the outer hash (keyed by the SOURCE group alone) maps that
        slot to a bucket — so a fixed source group reaches at most
        NEW_BUCKETS_PER_GROUP of the NEW_BUCKET_COUNT buckets."""
        slot = self._hash(addr.group, addr.src_group) % NEW_BUCKETS_PER_GROUP
        return self._hash(addr.src_group, str(slot)) % NEW_BUCKET_COUNT

    def old_bucket_index(self, addr: NetAddress) -> int:
        """addrbook.go calcOldBucket: keyed by the ADDRESS group (an OLD
        entry's host was dialed successfully — earned, not claimed)."""
        slot = self._hash(addr.addr) % OLD_BUCKETS_PER_GROUP
        return self._hash(addr.group, str(slot)) % OLD_BUCKET_COUNT

    def new_buckets_for_group(self, src_group: str) -> set[int]:
        """Every NEW bucket index reachable from one source group — the
        geometric occupancy bound the eclipse tests assert against."""
        return {self._hash(src_group, str(slot)) % NEW_BUCKET_COUNT
                for slot in range(NEW_BUCKETS_PER_GROUP)}

    # ------------------------------------------------------------- intake

    def add_address(self, addr: NetAddress) -> bool:
        """addrbook.go:178 AddAddress: new addresses land in NEW."""
        if not addr.node_id or addr.node_id == self.our_id:
            return False
        existing = self._addrs.get(addr.node_id)
        if existing is not None:
            if existing.is_old:
                # ADDRESS-HIJACK DEFENSE: gossip must not move an address
                # we have successfully dialed — an attacker would redirect
                # the next dial to a host it controls. The tried record
                # wins; the rejection is counted.
                if (addr.host, addr.port) != (existing.host, existing.port):
                    if self.metrics is not None:
                        self.metrics.addrbook_overwrite_rejected.inc()
                return False
            # both NEW: refresh the routable address (a peer moved)
            existing.host, existing.port = addr.host, addr.port
            return False
        b = self.new_bucket_index(addr)
        bucket = self._new[b]
        if len(bucket) >= BUCKET_SIZE and not self._evict_from_new(b):
            return False  # bucket pinned full by protected entries
        bucket[addr.node_id] = addr
        self._addrs[addr.node_id] = addr
        self._bucket_of[addr.node_id] = b
        self._publish_sizes()
        return True

    def _evict_from_new(self, b: int) -> bool:
        """Bias-aware in-bucket eviction: drop the entry with the most
        failed attempts (oldest attempt breaks ties); protected entries
        are never evicted. Returns False when nothing was evictable."""
        victims = [a for a in self._new[b].values()
                   if a.node_id not in self._protected]
        if not victims:
            return False
        worst = max(victims, key=lambda a: (a.attempts, -a.last_attempt))
        self._drop(worst.node_id)
        return True

    def _drop(self, node_id: str) -> None:
        a = self._addrs.pop(node_id, None)
        b = self._bucket_of.pop(node_id, None)
        if a is None or b is None:
            return
        (self._old if a.is_old else self._new)[b].pop(node_id, None)

    # ----------------------------------------------------------- lifecycle

    def mark_protected(self, node_id: str) -> None:
        """Exempt a persistent/unconditional peer from eviction and
        expiry (the id need not be in the book yet)."""
        if node_id:
            self._protected.add(node_id)

    def is_protected(self, node_id: str) -> bool:
        return node_id in self._protected

    def mark_attempt(self, node_id: str) -> None:
        a = self._addrs.get(node_id)
        if a is None:
            return
        a.attempts += 1
        a.last_attempt = time.time()
        # a NEW address that keeps failing is noise an attacker can mint
        # for free — expire it (addrbook.go isBad)
        if (not a.is_old and a.attempts > MAX_NEW_FAILURES
                and node_id not in self._protected):
            self._drop(node_id)
            self._publish_sizes()

    def mark_good(self, node_id: str) -> None:
        """addrbook.go MarkGood: graduate to OLD, reset attempts."""
        a = self._addrs.get(node_id)
        if a is None:
            return
        a.attempts = 0
        a.last_success = time.time()
        if a.is_old:
            return
        ob = self.old_bucket_index(a)
        if len(self._old[ob]) >= BUCKET_SIZE:
            # make room: demote the old bucket's worst entry back to NEW
            # (addrbook.go moveToOld displaces a random OLD entry)
            demotable = [x for x in self._old[ob].values()
                         if x.node_id not in self._protected]
            if not demotable:
                return  # stays NEW; still marked successful
            worst = max(demotable,
                        key=lambda x: (x.attempts, -x.last_success))
            self._demote(worst)
            if len(self._old[ob]) >= BUCKET_SIZE:
                return
        nb = self._bucket_of.get(node_id)
        if nb is not None:
            self._new[nb].pop(node_id, None)
        a.is_old = True
        self._old[ob][node_id] = a
        self._bucket_of[node_id] = ob
        self._publish_sizes()

    def _demote(self, a: NetAddress) -> None:
        """OLD -> NEW (ban, or displaced by a graduation)."""
        ob = self._bucket_of.get(a.node_id)
        if ob is not None:
            self._old[ob].pop(a.node_id, None)
        a.is_old = False
        nb = self.new_bucket_index(a)
        if len(self._new[nb]) >= BUCKET_SIZE and not self._evict_from_new(nb):
            # nowhere to land: the entry leaves the book
            self._addrs.pop(a.node_id, None)
            self._bucket_of.pop(a.node_id, None)
            return
        self._new[nb][a.node_id] = a
        self._bucket_of[a.node_id] = nb

    def mark_bad(self, node_id: str, ban_seconds: float = 24 * 3600) -> None:
        a = self._addrs.get(node_id)
        if a is None:
            return
        a.banned_until = time.time() + ban_seconds
        if a.is_old:
            self._demote(a)
        self._publish_sizes()

    def remove(self, node_id: str) -> None:
        self._drop(node_id)
        self._publish_sizes()

    # ----------------------------------------------------------- selection

    def pick_address(self, new_bias_pct: int = 50) -> NetAddress | None:
        """addrbook.go:260 PickAddress: choose OLD vs NEW with the given
        bias, then walk to a random non-empty bucket and pick uniformly
        within it. Banned and backoff-suppressed addresses are skipped —
        the dial loop never re-picks a freshly failed address."""
        now = time.time()
        pick_new = self._rng.randrange(100) < new_bias_pct
        for want_old in (not pick_new, pick_new):
            found = self._bucket_walk(old=want_old, now=now)
            if found is not None:
                return found
        return None

    def _bucket_walk(self, old: bool, now: float) -> NetAddress | None:
        buckets = self._old if old else self._new
        count = len(buckets)
        start = self._rng.randrange(count)
        for i in range(count):
            bucket = buckets[(start + i) % count]
            if not bucket:
                continue
            usable = [a for a in bucket.values() if a.dial_eligible(now)]
            if usable:
                return self._rng.choice(usable)
        return None

    def selection(self) -> list[NetAddress]:
        """addrbook.go:315 GetSelection: a random ~23% sample (at least
        MIN_SELECTION, capped) for answering a PEX request — collected by a
        shuffled bucket walk. The floor is CometBFT's minGetSelection: a
        small network learns every address in one exchange (the reference's
        copy answers one address a request below 9 addresses; ROADMAP
        Queue 3)."""
        now = time.time()
        usable = ([a for b in self._new for a in b.values()
                   if not a.is_banned(now)]
                  + [a for b in self._old for a in b.values()
                     if not a.is_banned(now)])
        if not usable:
            return []
        n = min(self.MAX_SELECTION,
                max(min(self.MIN_SELECTION, len(usable)),
                    len(usable) * self.SELECT_PCT // 100))
        return self._rng.sample(usable, min(n, len(usable)))

    def is_empty(self) -> bool:
        return not self._addrs

    def has(self, node_id: str) -> bool:
        return node_id in self._addrs

    def size(self) -> int:
        return len(self._addrs)

    # ---------------------------------------------------------- telemetry

    def _publish_sizes(self) -> None:
        if self.metrics is None:
            return
        new = sum(1 for a in self._addrs.values() if not a.is_old)
        self.metrics.addrbook_size.labels("new").set(new)
        self.metrics.addrbook_size.labels("old").set(len(self._addrs) - new)

    def stats(self) -> dict:
        """The discovery-plane rollup (net_telemetry's `discovery`
        section, bench --discovery, the eclipse tests): sizes, bucket
        occupancy, and the per-source-group NEW share — the number the
        hashed geometry bounds."""
        new_total, old_total = 0, 0
        by_src_group: dict[str, int] = {}
        src_group_buckets: dict[str, set[int]] = {}
        for b, bucket in enumerate(self._new):
            new_total += len(bucket)
            for a in bucket.values():
                g = a.src_group
                by_src_group[g] = by_src_group.get(g, 0) + 1
                src_group_buckets.setdefault(g, set()).add(b)
        for bucket in self._old:
            old_total += len(bucket)
        new_capacity = NEW_BUCKET_COUNT * BUCKET_SIZE
        worst_group = max(by_src_group, key=by_src_group.get) \
            if by_src_group else None
        return {
            "size": len(self._addrs),
            "new": new_total,
            "old": old_total,
            "protected": len(self._protected),
            "new_buckets_nonempty": sum(1 for b in self._new if b),
            "old_buckets_nonempty": sum(1 for b in self._old if b),
            "new_by_src_group": by_src_group,
            "new_buckets_by_src_group": {
                g: len(s) for g, s in src_group_buckets.items()},
            "worst_src_group": worst_group,
            # the eclipse headline: the largest single-source-group claim
            # on the NEW bucket space, vs. the geometric ceiling
            "max_src_group_occupancy_pct": round(
                100.0 * max(by_src_group.values()) / new_capacity, 3)
            if by_src_group else 0.0,
            "src_group_occupancy_bound_pct": round(
                100.0 * NEW_BUCKETS_PER_GROUP * BUCKET_SIZE
                / new_capacity, 3),
            "quarantined": bool(self.quarantined_path),
        }

    # ---------------------------------------------------------- persistence

    def save(self) -> None:
        if not self.file_path:
            return
        doc = {
            "nonce": self._nonce,
            "addrs": [
                {"id": a.node_id, "host": a.host, "port": a.port,
                 "src": a.src_id, "src_host": a.src_host,
                 "attempts": a.attempts,
                 "last_success": a.last_success, "old": a.is_old,
                 "banned_until": a.banned_until}
                for a in self._addrs.values()
            ],
        }
        os.makedirs(os.path.dirname(self.file_path) or ".", exist_ok=True)
        from cometbft_tpu_torch.libs.diskio import atomic_write_durable

        atomic_write_durable(self.file_path,
                             json.dumps(doc).encode(),
                             site="addrbook.save")

    def _load(self) -> None:
        try:
            with open(self.file_path) as f:
                doc = json.load(f)
            if isinstance(doc, dict):
                nonce = doc.get("nonce", "")
                if nonce:
                    self._nonce = str(nonce)
                entries = doc.get("addrs", [])
            else:
                entries = doc  # pre-geometry flat format (a list)
            for d in entries:
                a = NetAddress(
                    node_id=d["id"], host=d["host"], port=int(d["port"]),
                    src_id=d.get("src", ""),
                    src_host=d.get("src_host", ""),
                    attempts=int(d.get("attempts", 0)),
                    last_success=float(d.get("last_success", 0.0)),
                    banned_until=float(d.get("banned_until", 0.0)),
                )
                was_old = bool(d.get("old", False))
                if self.add_address(a) and was_old:
                    self.mark_good(a.node_id)
                    rec = self._addrs.get(a.node_id)
                    if rec is not None:
                        # mark_good stamps now; restore the saved truth
                        rec.last_success = a.last_success
                        rec.attempts = int(d.get("attempts", 0))
        except Exception as e:  # noqa: BLE001 - a corrupt book must not
            # brick the boot: quarantine the file and start empty
            self._addrs.clear()
            self._bucket_of.clear()
            self._new = [{} for _ in range(NEW_BUCKET_COUNT)]
            self._old = [{} for _ in range(OLD_BUCKET_COUNT)]
            self.load_error = str(e)
            quarantine = self.file_path + ".corrupt"
            try:
                os.replace(self.file_path, quarantine)
                self.quarantined_path = quarantine
            except OSError:
                pass
            if self.metrics is not None:
                self.metrics.addrbook_quarantined.inc()
