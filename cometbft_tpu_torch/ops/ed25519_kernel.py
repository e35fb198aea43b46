"""Batched Ed25519 ZIP-215 verification: host staging, the key tables and
cache, the device glue around the kernels, and the integrity header.

Per lane the device computes [8]([s]B - [k]A - R) == O (cofactored,
ZIP-215). verify_batch_async stages and launches a batch on the dispatch
stream (ops/dispatch.py) without waiting for the card; resolve_batches
fetches the headers of many launched batches in one copy, and their
payloads in one more only where a header is not happy (the reference's
verify_batch_async / resolve_batches, cometbft_tpu/ops/ed25519_kernel.py);
verify_rows is the two for one batch. A batch takes one of the reference's
two paths:

  device challenge  when ops/challenge.plan_batch gives a Plan (a commit's
                    factored sign-bytes, libs/prefixrows.PrefixedMsg): R, s
                    and a 2-byte descriptor plus ~13 variable bytes a lane
                    cross to the device in one flat block, and the challenge
                    kernel K5 derives k = SHA-512(R || A || M) mod L there,
                    A from the key table's encoding plane; the Plan's few
                    other lanes get host k, written after the derive;
  classic           when plan_batch gives None (plain bytes, ragged
                    messages, sr25519): k on the host through the native
                    rungs of ops/hashvec.py, r/s/k words in one transfer.

Pubkeys come from the device-resident key tables (ops/residency.py: a
2-byte row index a lane), or, when a batch overflows them, from the
unique-key full path over PubKeyCache. After the verify kernel, the
integrity kernel K6 (ops/integrity.py) folds the all-ok verdict into the
staging checksum: an 8-byte header crosses back, and the per-lane mask only
when the header is not "happy". The few lanes the device rejects are
re-verified by the exact host oracle (recheck_failed_lanes, with a budget
per producer group of a coalesced batch: apply_recheck); a lane it flips
back to valid means the device was wrong, and is counted.

There is no fallback: a kernel that fails raises, and a header or payload
whose checksum or echo fails raises. On the single-card path (domain "")
the stage and launch run under ops/dispatch.supervisor("device") behind the
chaos site "{scheme}.dispatch", and each fetch behind "{scheme}.fetch": a
transient retries in place, a timed-out fetch is issued again, and what is
left raises DeviceOpFailed, or DeviceUnavailable while the breaker is
open, to the caller. No mask is ever computed elsewhere. The counters say
which path ran: challenge.stats(), residency.send_stats(),
hashvec.active_rung(), fetch_stats().

Batch sizes are bucketed (powers of two from 8 up to 2048, then multiples
of 2048); padding lanes carry the identity encoding (y = 1) with zero
scalars, which verify valid, and are sliced off.

The tables, the device glue and the recheck serve sr25519 too
(ops/sr25519_kernel.py): a Scheme record names what differs.
"""

from __future__ import annotations

import contextlib
import contextvars
import hashlib
import threading
import time
from typing import Callable, NamedTuple

import numpy as np
import torch

from cometbft_tpu_torch import resolve_device
from cometbft_tpu_torch.crypto import ed25519_math as oracle
from cometbft_tpu_torch.libs import chaos
from cometbft_tpu_torch.libs.prefixrows import as_bytes
from cometbft_tpu_torch.ops import challenge
from cometbft_tpu_torch.ops import dispatch
from cometbft_tpu_torch.ops import hashvec
from cometbft_tpu_torch.ops import integrity
from cometbft_tpu_torch.ops import limbs as L
from cometbft_tpu_torch.ops import residency
from cometbft_tpu_torch.ops import verify_kernel as VK

MIN_BUCKET = 8
MAX_BUCKET_LOG2 = 17  # 128k lanes
_POW2_CAP = 2048  # above this, buckets are multiples of _POW2_CAP

_ID_ENC32 = (1).to_bytes(32, "little")  # y = 1: the identity point encoding
_ID_ROW32 = np.frombuffer(_ID_ENC32, dtype=np.uint8)


def bucket_size(n: int) -> int:
    """Power-of-two buckets up to 2048, then multiples of 2048 (a
    10,240-signature commit runs at exactly 10,240 lanes)."""
    if n > (1 << MAX_BUCKET_LOG2):
        raise ValueError(f"batch of {n} exceeds max bucket {1 << MAX_BUCKET_LOG2}")
    b = MIN_BUCKET
    while b < n and b < _POW2_CAP:
        b *= 2
    if b >= n:
        return b
    return (n + _POW2_CAP - 1) // _POW2_CAP * _POW2_CAP


# ------------------------------------------------------------ host staging

# L as 4 little-endian 64-bit words, most significant last
_L_WORDS64 = np.frombuffer(oracle.L.to_bytes(32, "little"), dtype="<u8")


def scalars_lt_l(s_rows: np.ndarray) -> np.ndarray:
    """(N, 32) uint8 little-endian scalars -> (N,) bool of (s < L)."""
    w = np.ascontiguousarray(s_rows).view("<u8")
    lt = np.zeros(w.shape[0], dtype=bool)
    decided = np.zeros(w.shape[0], dtype=bool)
    for i in (3, 2, 1, 0):
        lt |= ~decided & (w[:, i] < _L_WORDS64[i])
        decided |= w[:, i] != _L_WORDS64[i]
    return lt


def _structural_stage(pubs: list[bytes], sigs: list[bytes]):
    """Host-side structural checks (lengths, s < L — these never reach the
    device), with placeholder rows (identity R and A, zero s) for the lanes
    that fail. Returns (pre_ok, safe_pubs, sig_rows (N, 64), pub_rows
    (N, 32))."""
    n = len(sigs)
    ok_len = np.fromiter(map(len, sigs), np.int64, n) == 64
    ok_len &= np.fromiter(map(len, pubs), np.int64, n) == 32
    if ok_len.all():
        sig_rows = np.frombuffer(b"".join(sigs), dtype=np.uint8).reshape(n, 64)
        pub_rows = np.frombuffer(b"".join(pubs), dtype=np.uint8).reshape(n, 32)
        safe_pubs = list(pubs)
    else:
        sig_rows = np.zeros((n, 64), dtype=np.uint8)
        pub_rows = np.zeros((n, 32), dtype=np.uint8)
        sig_rows[:, :32] = _ID_ROW32
        pub_rows[:] = _ID_ROW32
        safe_pubs = [_ID_ENC32] * n
        for i in np.flatnonzero(ok_len):
            sig_rows[i] = np.frombuffer(sigs[i], dtype=np.uint8)
            pub_rows[i] = np.frombuffer(pubs[i], dtype=np.uint8)
            safe_pubs[i] = pubs[i]
    pre_ok = ok_len & scalars_lt_l(sig_rows[:, 32:])
    bad = np.flatnonzero(ok_len & ~pre_ok)  # s >= L rows need placeholders
    if bad.size:
        if not sig_rows.flags.writeable:
            sig_rows = sig_rows.copy()
        sig_rows[bad, :32] = _ID_ROW32
        sig_rows[bad, 32:] = 0
        safe_pubs = [p if pre_ok[i] else _ID_ENC32
                     for i, p in enumerate(safe_pubs)]
    return pre_ok, safe_pubs, sig_rows, pub_rows


def _challenge_words(r_rows, pub_rows, msgs, pre_ok) -> np.ndarray:
    """(N, 8) uint32 packed challenges k = SHA-512(R || A || M) mod L
    through the rungs of ops/hashvec.py; rows with pre_ok False get k = 0.
    Same-length messages (a commit's) hash as one (N, 64 + mlen) batch,
    factored rows reassembled with one broadcast of their prefix; ragged
    ones group inside sha512_many."""
    n = r_rows.shape[0]
    mlens = np.fromiter(map(len, msgs), np.int64, n)
    if n and (mlens == mlens[0]).all():
        msg_rows = hashvec.assemble_prefixed_rows(msgs, int(mlens[0]))
        digests = hashvec.sha512_rows(np.concatenate([r_rows, pub_rows, msg_rows], axis=1))
    else:
        r_blob, p_blob = r_rows.tobytes(), pub_rows.tobytes()
        digests = hashvec.sha512_many([r_blob[32 * i:32 * i + 32] + p_blob[32 * i:32 * i + 32]
                                       + as_bytes(m) for i, m in enumerate(msgs)])
    k_words = hashvec.reduce512_mod_l(digests)
    k_words[~pre_ok] = 0
    return k_words


def _pack_host_words(pre_ok, safe_pubs, sig_rows, pub_rows, msgs, bucket: int) -> np.ndarray:
    """The classic path's staged words: host challenges and the r/s/k
    planes, (3, 8, bucket) uint32, identity-padded (R = y 1, s = k = 0)."""
    n = sig_rows.shape[0]
    k_rows = _challenge_words(np.ascontiguousarray(sig_rows[:, :32]), pub_rows, msgs, pre_ok)
    sig_u4 = np.ascontiguousarray(sig_rows).view("<u4")  # (n, 16): R words 0-7, s 8-15
    out = np.zeros((3, 8, bucket), dtype=np.uint32)
    out[0, :, :n] = sig_u4[:, :8].T
    out[1, :, :n] = sig_u4[:, 8:].T
    out[2, :, :n] = k_rows.T
    out[0, 0, n:] = 1  # padding: identity encoding + zero scalars
    return out


def _pack_device_block(sig_rows: np.ndarray, bucket: int, plan, block: np.ndarray) -> None:
    """Pack a flat block of the device-challenge wire in place: R words and
    s words ((8, bucket) planes, identity-padded), then the descriptor
    stream (challenge.fill_stream). No k words: the device derives them."""
    n = sig_rows.shape[0]
    sig_u4 = np.ascontiguousarray(sig_rows).view("<u4")
    rw = block[:8 * bucket].reshape(8, bucket)
    sw = block[8 * bucket:16 * bucket].reshape(8, bucket)
    rw[:, :n] = sig_u4[:, :8].T
    sw[:, :n] = sig_u4[:, 8:].T
    rw[:, n:] = 0
    rw[0, n:] = 1
    sw[:, n:] = 0
    challenge.fill_stream(block, bucket, plan)


def stage_batch(pubs: list[bytes], msgs: list, sigs: list[bytes], bucket: int):
    """The classic path's host staging: structural checks, challenges, and
    the packed r/s/k words, batch-minor (8, bucket) uint32, identity-padded
    to `bucket`. Returns (pre_ok, safe_pubs, r_words, s_words, k_words)."""
    pre_ok, safe_pubs, sig_rows, pub_rows = _structural_stage(pubs, sigs)
    r, s, k = _pack_host_words(pre_ok, safe_pubs, sig_rows, pub_rows, msgs, bucket)
    return pre_ok, safe_pubs, r, s, k


def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host int32 array -> tensor on `device` (copied first when the array
    is not writable, as torch requires)."""
    return torch.from_numpy(np.require(a, np.int32, ("C", "W"))).to(device)


def _words_to_device(words: np.ndarray, device: torch.device) -> torch.Tensor:
    """(8, B) uint32 host words -> int32 tensor with the same bits."""
    return _to_device(np.ascontiguousarray(words, dtype=np.uint32).view(np.int32), device)


def staged_from_numpy(ax, ay, az, at, r_words, s_words, k_words,
                      device=None) -> tuple[torch.Tensor, ...]:
    """Staged numpy arrays — A coords (20, B) int32 and r/s/k words (8, B)
    uint32, as produced by a stage_batch/decompress_points pair (this
    package's or the JAX package's) — -> the kernel's input tensors."""
    dev = resolve_device(device)
    coords = tuple(_to_device(c, dev) for c in (ax, ay, az, at))
    words = tuple(_words_to_device(w, dev) for w in (r_words, s_words, k_words))
    return coords + words


# ------------------------------------------------------- pubkey decompression


class Scheme(NamedTuple):
    """What differs between the signature schemes the verify path runs;
    everything else (buckets, the key tables and cache, the device glue,
    the header, the recheck) is shared."""

    name: str
    id_enc: bytes  # identity encoding: padding lanes and placeholder pubkeys
    decompress: Callable  # kernel wrapper: (8, B) words -> ok, X, Y, Z, T
    structural: Callable  # (pubs, sigs) -> pre_ok, safe_pubs, sig_rows, pub_rows
    pack: Callable  # (pre_ok, safe_pubs, sig_rows, pub_rows, msgs, bucket) -> (3, 8, B) r/s/k
    verify_raw: Callable  # kernel wrapper: A coords + r/s/k words -> raw int32 mask, all-ok
    verify_one: Callable  # (pub, msg, sig) -> bool: the exact host oracle
    device_challenge: bool  # may k be derived on the device (ed25519 only)

    def stage(self, pubs: list[bytes], msgs: list, sigs: list[bytes], bucket: int):
        """The classic path's host staging: (pre_ok, safe_pubs, r_words,
        s_words, k_words), each word plane (8, bucket) uint32."""
        pre_ok, safe_pubs, sig_rows, pub_rows = self.structural(pubs, sigs)
        r, s, k = self.pack(pre_ok, safe_pubs, sig_rows, pub_rows, msgs, bucket)
        return pre_ok, safe_pubs, r, s, k


ED25519 = Scheme("ed25519", _ID_ENC32, VK.decompress, _structural_stage, _pack_host_words,
                 VK.verify_ok_raw, oracle.verify_zip215, True)


def decompress_points(enc: np.ndarray, device=None, scheme: Scheme = ED25519
                      ) -> tuple[np.ndarray, np.ndarray]:
    """(N, 32) uint8 encodings -> (ok (N,) bool, coords (N, 4, 20) int32),
    padded internally to a bucket with the scheme's identity encoding
    (always decodable) and decoded on `device`."""
    dev = resolve_device(device)
    n = enc.shape[0]
    b = bucket_size(n)
    rows = np.empty((b, 32), dtype=np.uint8)
    rows[:n] = enc
    rows[n:] = np.frombuffer(scheme.id_enc, dtype=np.uint8)
    ok, x, y, z, t = scheme.decompress(_words_to_device(L.bytes_to_words(rows).T, dev))
    coords = torch.stack([x, y, z, t], dim=0).permute(2, 0, 1).cpu().numpy()
    return ok.cpu().numpy()[:n], np.ascontiguousarray(coords[:n])


def pad_coords_batch_minor(coords: np.ndarray, bucket: int) -> tuple:
    """(N, 4, 20) int32 coords -> identity-padded, batch-minor (ax, ay, az,
    at) host arrays, each (20, bucket)."""
    pad = bucket - coords.shape[0]
    if pad:
        id_coords = np.zeros((pad, 4, L.NLIMBS), dtype=np.int32)
        id_coords[:, 1, 0] = 1  # Y = 1
        id_coords[:, 2, 0] = 1  # Z = 1
        coords = np.concatenate([coords, id_coords])
    return tuple(np.ascontiguousarray(coords[:, i].T) for i in range(4))




class PubKeyCache:
    """Two-level decompressed-pubkey cache for one device and one scheme:
    the host decoder of the key tables (ops/residency.py) and the full
    path's unique-key store.

    Host level: pubkey bytes -> (ok, (4, 20) int32 coords), bounded FIFO.
    Device level: digest of a padded unique-key set -> (ok, the four
    (20, B) coordinate tensors and the (8, B) encoding words on the
    device), used by the full path (_stage_gather) when a batch does not
    fit the key table. The same 32
    bytes decode to different points under each scheme, so a cache holds
    one scheme's keys only.
    """

    def __init__(self, device=None, scheme: Scheme = ED25519,
                 capacity: int = 65536, device_slots: int = 8):
        self.device = resolve_device(device)
        self.scheme = scheme
        self.capacity = capacity
        self.device_slots = device_slots
        self._lock = threading.RLock()
        self._map: dict[bytes, tuple[bool, np.ndarray]] = {}
        self._dev: dict[bytes, tuple] = {}
        self.counters = {
            "host_hits": 0, "host_misses": 0, "host_evictions": 0,
            "device_hits": 0, "device_misses": 0, "device_evictions": 0,
        }

    def stats(self) -> dict:
        with self._lock:
            return dict(self.counters, host_entries=len(self._map),
                        device_slots=len(self._dev))

    def _insert(self, keys: list[bytes], ok: np.ndarray, coords: np.ndarray) -> None:
        evict = len(self._map) + len(keys) - self.capacity
        for _ in range(max(0, min(evict, len(self._map)))):
            self._map.pop(next(iter(self._map)))
            self.counters["host_evictions"] += 1
        for i, p in enumerate(keys):
            self._map[p] = (bool(ok[i]), coords[i])

    def load(self, pubs: list[bytes], ok: np.ndarray, coords: np.ndarray) -> None:
        """Seed the host level with decompressed keys: ok (N,) bool and
        coords (N, 4, 20) int32, e.g. from the JAX package's
        decompress_points of the same scheme."""
        if coords.shape != (len(pubs), 4, L.NLIMBS):
            raise ValueError(f"coords must be ({len(pubs)}, 4, {L.NLIMBS})")
        with self._lock:
            self._insert(list(pubs), np.asarray(ok, dtype=bool),
                         np.asarray(coords, dtype=np.int32))

    def lookup_or_decompress(self, pubs: list[bytes]) -> tuple[np.ndarray, np.ndarray]:
        """Host level: (ok (N,) bool, coords (N, 4, 20) int32); missing keys
        are decompressed on the cache's device."""
        with self._lock:
            uniq = dict.fromkeys(pubs)
            missing = [p for p in uniq if p not in self._map]
            self.counters["host_misses"] += len(missing)
            self.counters["host_hits"] += len(uniq) - len(missing)
            if missing:
                enc = np.frombuffer(b"".join(missing), dtype=np.uint8).reshape(-1, 32)
                ok, coords = decompress_points(enc, self.device, self.scheme)
                self._insert(missing, ok, coords)
            oks = np.empty(len(pubs), dtype=bool)
            coords = np.empty((len(pubs), 4, L.NLIMBS), dtype=np.int32)
            for i, p in enumerate(pubs):
                oks[i], coords[i] = self._map[p]
            return oks, coords

    def stage(self, pubs: list[bytes], bucket: int
              ) -> tuple[np.ndarray, tuple, torch.Tensor]:
        """(ok_a (N,) host bool, (ax, ay, az, at) device tensors (20, bucket),
        the keys' encoding words (8, bucket) int32 on the device, for the
        device challenges), identity-padded past the N keys; an upload is
        accounted on the full path."""
        with self._lock:
            digest = hashlib.sha256(b"".join(pubs)).digest() + bucket.to_bytes(4, "little")
            hit = self._dev.get(digest)
            if hit is not None:
                self.counters["device_hits"] += 1
                return hit
            self.counters["device_misses"] += 1
            ok_a, coords = self.lookup_or_decompress(pubs)
            host = pad_coords_batch_minor(coords, bucket)
            enc = np.frombuffer(b"".join(pubs) + self.scheme.id_enc * (bucket - len(pubs)),
                                dtype="<u4").reshape(bucket, 8).T
            got = (ok_a, tuple(_to_device(a, self.device) for a in host),
                   _words_to_device(enc, self.device))
            residency.record_send("full", sum(a.nbytes for a in host) + enc.nbytes)
            if len(self._dev) >= self.device_slots:
                self._dev.pop(next(iter(self._dev)))
                self.counters["device_evictions"] += 1
            self._dev[digest] = got
            return got


_default_caches: dict[tuple[str, torch.device], PubKeyCache] = {}
_default_lock = threading.Lock()


def default_cache(device=None, scheme: Scheme = ED25519) -> PubKeyCache:
    """The process's pubkey cache for `device` and `scheme`."""
    dev = resolve_device(device)
    with _default_lock:
        cache = _default_caches.get((scheme.name, dev))
        if cache is None:
            cache = _default_caches[(scheme.name, dev)] = PubKeyCache(dev, scheme)
        return cache


def _gather_coords(dev_u: tuple, idx: torch.Tensor) -> tuple:
    """Unique-key coordinate tables (20, U) x 4 -> per-lane A coordinates
    (20, B) by index, on the device (index_select, no host round trip)."""
    return tuple(c.index_select(1, idx) for c in dev_u)


def _stage_gather(cache: PubKeyCache, pubs: list[bytes], bucket: int, put_key: str = "",
                  want_enc: bool = False) -> tuple:
    """A batch's pubkeys on the device: (ok_a (N,), (ax, ay, az, at) (20,
    bucket) tensors, send path, pubkey-staging bytes); with want_enc the
    (8, bucket) int32 encoding words (or None) between the coordinates and
    the path.

    Indexed path first (ops/residency.py): a uint16 row index a lane into
    the cache's key table, unseen keys delta-inserted; path "indexed".
    Full path otherwise: the batch's unique keys as one coordinate table
    and encoding plane (digest-cached in PubKeyCache), gathered on the
    device by an int32 index a lane; path "full"."""
    got = residency.stage(cache, pubs, bucket, put_key=put_key, want_enc=want_enc)
    if got is not None:
        if want_enc:
            ok_a, a_dev, enc_dev, tx = got
            return ok_a, a_dev, enc_dev, "indexed", tx
        ok_a, a_dev, tx = got
        return ok_a, a_dev, "indexed", tx
    uniq = list(dict.fromkeys(pubs))
    # an identity slot only when padding lanes exist: a batch that fills its
    # bucket exactly may have as many unique keys as lanes
    need_pad = bucket > len(pubs)
    bu = bucket_size(len(uniq) + 1 if need_pad else len(uniq))
    ok_u, dev_u, enc_u = cache.stage(uniq, bu)
    if cache.device.type == "cuda":
        # the cache serves every fault domain of its card: an entry that
        # another stream made, or that a later batch evicts, must not be
        # handed to a new allocation before this stream's gathers ran
        cur = torch.cuda.current_stream(cache.device)
        for t in (*dev_u, enc_u):
            t.record_stream(cur)
    pos = {p: i for i, p in enumerate(uniq)}
    idx = np.full(bucket, len(uniq), dtype=np.int32)  # padding -> identity
    idx[:len(pubs)] = [pos[p] for p in pubs]
    ok_a = np.asarray(ok_u)[idx[:len(pubs)]]
    idx_d = torch.from_numpy(idx).to(cache.device).to(torch.int64)
    a_dev = _gather_coords(dev_u, idx_d)
    if want_enc:
        return ok_a, a_dev, enc_u.index_select(1, idx_d), "full", idx.nbytes
    return ok_a, a_dev, "full", idx.nbytes


# ------------------------------------------------------- reduced fetch
#
# After the verify kernel, K6 (ops/integrity.py) folds the all-ok verdict
# into the staging checksum: token = checksum ^ (OK_MAGIC if every lane
# verified and the staged bytes checksummed, else BAD_MAGIC), header =
# [token, ~token]. The host knows the expected checksum, so 8 fetched bytes
# prove "staged bytes arrived intact and every lane verified"; the per-lane
# payload [mask, ~mask, checksum ok] crosses only when the header says
# otherwise.

OK_MAGIC = integrity.OK_MAGIC
_BAD_MAGIC = integrity.BAD_MAGIC
_host_checksum = integrity.host_checksum


class TransferIntegrityError(RuntimeError):
    """A reduced-fetch header or payload failed its staging checksum or its
    echo: the device saw other bytes than were sent, or the fetch was
    corrupted."""


def decode_header(header: np.ndarray, expected) -> str:
    """Header verdicts: "happy" (staging intact, every lane valid: the mask
    need not cross), "full" (staging intact, some lane failed: fetch the
    payload), "chk_mismatch" (the device saw other staged bytes than the
    host sent), "echo_corrupt" (the header's complement disagrees)."""
    h0, h1 = int(header[0]), int(header[1])
    if h1 != (~h0 & 0xFFFFFFFF):
        return "echo_corrupt"
    exp = int(expected)
    if h0 == exp ^ int(OK_MAGIC):
        return "happy"
    if h0 == exp ^ int(_BAD_MAGIC):
        return "full"
    return "chk_mismatch"


_fetch_lock = threading.Lock()
_fetch_stats = {"happy_fetches": 0, "full_fetches": 0, "happy_bytes": 0, "full_bytes": 0}


def _count_fetch(happy: bool, nbytes: int) -> None:
    key = "happy" if happy else "full"
    with _fetch_lock:
        _fetch_stats[key + "_fetches"] += 1
        _fetch_stats[key + "_bytes"] += nbytes


def fetch_stats() -> dict:
    """Header-only ("happy") and header + payload ("full") fetches and
    their bytes."""
    with _fetch_lock:
        return dict(_fetch_stats)


def reset_fetch_stats() -> None:
    with _fetch_lock:
        for k in _fetch_stats:
            _fetch_stats[k] = 0


# ------------------------------------------------------------------ verify

# Failed lanes are re-verified by the exact host oracle before they are
# reported invalid, up to this many per batch, or per recheck group of a
# coalesced batch (a group with more failures is genuinely bad). A lane the
# oracle accepts is flipped to valid and counted: it means the device
# computed a wrong verdict.
RECHECK_MAX = 32


def recheck_failed_lanes(mask: np.ndarray, eligible: np.ndarray, pubs, msgs,
                         sigs, verify_one: Callable = oracle.verify_zip215
                         ) -> tuple[np.ndarray, int]:
    """eligible: lanes that passed the host structural checks and pubkey
    decompression (a placeholder lane is the identity, which validly signs
    anything, and must never be flipped). verify_one is the scheme's host
    oracle; factored messages are materialized for it. Returns (mask,
    number of lanes flipped to valid)."""
    bad = np.flatnonzero(~mask & eligible)
    if len(bad) == 0 or len(bad) > RECHECK_MAX:
        return mask, 0
    flips = 0
    for i in bad:
        if verify_one(pubs[i], as_bytes(msgs[i]), sigs[i]):
            mask[i] = True
            flips += 1
    return mask, flips


def apply_recheck(mask: np.ndarray, eligible: np.ndarray, rows: tuple, verify_one: Callable,
                  groups: list[tuple[int, int]] | None = None) -> tuple[np.ndarray, int]:
    """The host-oracle recheck with a budget per group: a coalesced batch
    (a blocksync window, a scheduler flush) passes each producer's row
    bounds as `groups`, so each keeps its own RECHECK_MAX and one genuinely
    bad commit does not suppress the recheck of its neighbours. Returns
    (mask, flips). groups=None rechecks the whole batch as one group;
    lanes outside every group are not rechecked."""
    pubs, msgs, sigs = rows
    if groups is None:
        return recheck_failed_lanes(mask, eligible, pubs, msgs, sigs, verify_one)
    flips = 0
    for a, b in groups:
        mask[a:b], f = recheck_failed_lanes(mask[a:b], eligible[a:b], pubs[a:b], msgs[a:b],
                                            sigs[a:b], verify_one)
        flips += f
    return mask, flips


def decode_payload(payload: np.ndarray, n: int, pre_ok: np.ndarray, ok_a: np.ndarray,
                   rows: tuple, verify_one: Callable,
                   groups: list[tuple[int, int]] | None = None) -> tuple[np.ndarray, int]:
    """A fetched (2B + 1,) payload -> the final (N,) mask and the recheck's
    flips. A failed staging checksum or mask echo raises: the port retries
    nothing and has no host-oracle rung."""
    mask, chk_ok, echo_ok = integrity.decode_mask(payload)
    if not (chk_ok and echo_ok):
        raise TransferIntegrityError(f"device transfer integrity check failed: staging "
                                     f"checksum ok {chk_ok}, mask echo ok {echo_ok}")
    eligible = pre_ok & ok_a
    return apply_recheck(mask[:n] & eligible, eligible, rows, verify_one, groups)


_PARTS: contextvars.ContextVar = contextvars.ContextVar("verify_parts", default=None)


@contextlib.contextmanager
def timed_parts(out: dict | None):
    """While entered, the verify path (verify_batch_async, resolve_batches)
    and the layers above it that time themselves (the scheduler, commit
    validation) add each part's wall time in ms into `out`, summed by name,
    the device synchronised before and after each part. Nothing when `out`
    is None (an outer collector stays in force)."""
    if out is None:
        yield
        return
    token = _PARTS.set(out)
    try:
        yield
    finally:
        _PARTS.reset(token)


class _Parts:
    """Wall time of the verify path's parts into the collector of
    timed_parts (ms, summed by name), each part synchronised on the device
    before and after; nothing outside a collector."""

    def __init__(self, device: torch.device | None):
        self.device, self.out = device, _PARTS.get()

    @contextlib.contextmanager
    def __call__(self, name: str):
        if self.out is None:
            yield
            return
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        yield
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.out[name] = self.out.get(name, 0.0) + (time.perf_counter() - t0) * 1e3


def host_part(name: str):
    """A host-only part of a layer above the verify path (no device
    synchronisation), timed into the current collector."""
    return _Parts(None)(name)


def _fallback_k(plan, pre_ok, sig_rows, pub_rows, msgs, dev):
    """The host k of the Plan's live lanes that the device does not derive,
    as (fkw (8, fb) int32, fidx (fb,) int32) device tensors and their host
    arrays, fb a bucket, padded by repeating the last lane (the write is
    idempotent); all None when every live lane is planned."""
    lanes = np.flatnonzero(pre_ok & ~plan.eligible)
    if not lanes.size:
        return None, None, ()
    k = _challenge_words(np.ascontiguousarray(sig_rows[lanes, :32]),
                         np.ascontiguousarray(pub_rows[lanes]), [msgs[i] for i in lanes],
                         np.ones(lanes.size, dtype=bool))
    fb = bucket_size(int(lanes.size))
    fidx = np.full(fb, int(lanes[-1]), dtype=np.int32)
    fidx[:lanes.size] = lanes
    fkw = np.tile(k[-1:].T, (1, fb)).astype(np.uint32)
    fkw[:, :lanes.size] = k.T
    return _words_to_device(fkw, dev), _to_device(fidx, dev), (fkw, fidx)


class BatchThunk:
    """One staged and launched batch (verify_batch_async): what
    resolve_batches needs to decode it (the fault domain whose stream
    launched it among them), and every device tensor its kernels
    read or write, held until the fetch so that the caching allocator cannot
    hand their memory to a later batch while the card still uses it.
    Calling it resolves it alone. After resolution `mask` holds the (N,)
    verdicts, `flipped` the lanes the host recheck flipped to valid and
    `flips` their number."""

    __slots__ = ("scheme", "device", "domain", "n", "pre_ok", "ok_a", "rows", "groups",
                 "expected", "header", "payload", "keep", "mask", "flipped", "flips")

    def __init__(self, scheme: Scheme, device: torch.device, n: int, rows: tuple,
                 groups: list[tuple[int, int]] | None, domain: str = ""):
        self.scheme, self.device, self.n, self.rows, self.groups = scheme, device, n, rows, groups
        self.domain = domain
        self.pre_ok = self.ok_a = self.expected = self.header = self.payload = None
        self.keep: tuple = ()
        self.mask: np.ndarray | None = np.zeros(0, dtype=bool) if n == 0 else None
        self.flipped = np.zeros(0, dtype=np.intp)
        self.flips = 0

    def __call__(self) -> np.ndarray:
        return resolve_batches([self])[0]

    @property
    def eligible(self) -> np.ndarray:
        """The lanes the host recheck may flip: they passed the structural
        checks and their key decoded."""
        return self.pre_ok & self.ok_a


def _cache_for(scheme: Scheme, cache: PubKeyCache | None, device) -> PubKeyCache:
    if cache is None:
        return default_cache(device, scheme)
    if cache.scheme is not scheme:
        raise ValueError(f"cache holds {cache.scheme.name} keys, not {scheme.name}")
    if device is not None and resolve_device(device) != cache.device:
        raise ValueError(f"cache lives on {cache.device}, not {device}")
    return cache


def _fired(site: str, op: Callable):
    """One attempt of a supervised single-card operation: the chaos site
    `site` fires (libs/chaos.py), then op runs."""
    chaos.fire(site)
    return op()


def verify_batch_async(scheme: Scheme, pubs: list[bytes], msgs: list, sigs: list[bytes],
                       cache: PubKeyCache | None = None, device=None,
                       recheck_groups: list[tuple[int, int]] | None = None,
                       domain: str = "") -> BatchThunk:
    """Stage and launch a batch under `scheme` without waiting for the card:
    K5 (device challenges) -> K1/K2 -> K6 on the dispatch stream of fault
    domain `domain` (ops/dispatch.py; "" is the single-card path, "devN" a
    mesh domain, parallel/mesh.py, whose key and prefix tables are its
    own), under the dispatch lock. Returns the BatchThunk that
    resolve_batches fetches.
    Runs on the cache's device when a cache is given, else on `device`
    (default cuda). msgs may hold factored rows (libs/prefixrows.PrefixedMsg):
    they stay factored, and the host oracle alone materializes them.
    recheck_groups: the row bounds of a coalesced batch's producers
    (apply_recheck; None: the whole batch is one group)."""
    n = len(sigs)
    if len(pubs) != n or len(msgs) != n:
        raise ValueError("pubs, msgs and sigs differ in length")
    cache = _cache_for(scheme, cache, device)
    dev = cache.device
    thunk = BatchThunk(scheme, dev, n, (None, msgs, sigs), recheck_groups, domain)
    if n == 0:
        return thunk
    b = bucket_size(n)

    def launch() -> None:
        with dispatch.launching(dev, domain):
            part = _Parts(dev)
            with part("plan"):
                pre_ok, safe_pubs, sig_rows, pub_rows = scheme.structural(pubs, sigs)
                plan = (challenge.plan_batch(msgs, pre_ok, put_key=domain, device=dev)
                        if scheme.device_challenge else None)
            with part("pack"):
                if plan is None:  # classic: k on the host
                    words = scheme.pack(pre_ok, safe_pubs, sig_rows, pub_rows, msgs, b)
                    host = words.reshape(3 * 8, b)
                    fb_host: tuple = ()
                else:  # device challenge: k derived by K5
                    host = np.empty(challenge.block_words(b, plan.var), dtype=np.uint32)
                    _pack_device_block(sig_rows, b, plan, host)
            with part("keys"):
                staged = _stage_gather(cache, safe_pubs, b, put_key=domain,
                                       want_enc=scheme.device_challenge)
                if scheme.device_challenge:
                    ok_a, a_dev, enc_dev, path, key_bytes = staged
                else:
                    (ok_a, a_dev, path, key_bytes), enc_dev = staged, None
            with part("pack"):
                fkw = fidx = None
                if plan is not None:
                    fkw, fidx, fb_host = _fallback_k(plan, pre_ok, sig_rows, pub_rows, msgs, dev)
                expected = _host_checksum(host, *fb_host)
                block = _to_device(host.view(np.int32), dev)
                residency.record_send(path, key_bytes + host.nbytes
                                      + sum(a.nbytes for a in fb_host), sigs=n)
            if plan is None:
                block = block.view(3, 8, b)
                rw, sw, kw = block[0], block[1], block[2]
                chk_arrs: tuple = (rw, sw, kw)
            else:
                with part("derive"):
                    kw = challenge.derive(block, enc_dev, plan.dev_tab, b, plan.var, plan.plen,
                                          plan.tlen, fkw, fidx)
                rw = block[:8 * b].view(8, b)
                sw = block[8 * b:16 * b].view(8, b)
                chk_arrs = (block,) if fkw is None else (block, fkw, fidx)
            with part("verify"):
                mask_dev, allok_dev = scheme.verify_raw(*a_dev, rw, sw, kw)
            with part("header"):
                # K6 straight behind the verify kernel, on its raw verdicts; the
                # checksummed arrays were uploaded before the derive and verify
                # kernels ran, so K6 may start while the verify kernel's grid exits
                header_dev, payload_dev = integrity.integrity_parts(mask_dev, allok_dev, expected,
                                                                    *chk_arrs, overlap=True)
        thunk.pre_ok, thunk.ok_a, thunk.expected = pre_ok, ok_a, expected
        thunk.rows = (safe_pubs, msgs, sigs)
        thunk.header, thunk.payload = header_dev, payload_dev
        thunk.keep = (block, kw, a_dev, enc_dev, fkw, fidx, mask_dev, allok_dev,
                      None if plan is None else plan.dev_tab)

    if domain:  # a mesh shard: the mesh's supervisor and sites wrap it
        launch()
    else:
        dispatch.supervisor("device").run(_fired, f"{scheme.name}.dispatch", launch)
    return thunk


def _fetch(dev: torch.device, tensors: list[torch.Tensor], domain: str = "") -> np.ndarray:
    """One device->host copy of the tensors, concatenated on the device
    (no concatenation for one), on the dispatch stream of `domain`, which
    launched them: the copy waits for their kernels."""
    with dispatch.on_stream(dev, domain):
        t = tensors[0] if len(tensors) == 1 else torch.cat(tensors)
        return t.cpu().numpy()


def _supervised_fetch(dev: torch.device, tensors: list[torch.Tensor], domain: str,
                      sites: list[str]) -> np.ndarray:
    """_fetch under the single-card path's "device" supervisor: the chaos
    sites `sites` ({scheme}.fetch) fire, a transient failure retries in
    place, and a timed-out fetch, recorded as a failure, is issued again
    while the breaker admits it, up to the supervisor's retry attempts: the
    tensors it reads stay on the card until the batch resolves. A mesh
    domain's fetch is its shard's own (parallel/mesh.py)."""
    if domain:
        return _fetch(dev, tensors, domain)

    def op() -> np.ndarray:
        for site in sites:
            chaos.fire(site)
        return _fetch(dev, tensors, domain)

    sup = dispatch.supervisor("device")
    again = 0
    while True:
        try:
            return sup.run(op)
        except dispatch.DeviceOpFailed as exc:
            cause = exc.__cause__ if exc.__cause__ is not None else exc
            if dispatch.classify_failure(cause) != dispatch.TIMEOUT or again >= sup.retry_attempts:
                raise
            again += 1


def resolve_batches(thunks: list[BatchThunk]) -> list[np.ndarray]:
    """The (N,) masks of launched batches, with a two-phase reduced fetch:
    every batch's 8-byte header in one device->host copy, then the per-lane
    payloads, again in one copy, only for batches whose header is not
    happy. Thunks may mix schemes (a mixed commit's ed25519 and sr25519
    batches): each carries its own oracle for the recheck. Thunks of several
    devices or fault domains are fetched a (device, domain) at a time, each
    on the stream that launched them. One fetch is counted per call
    (fetch_stats), happy when no payload crossed. A header or payload that
    fails its checksum or echo raises."""
    todo = [t for t in thunks if t.mask is None]
    by_dev: dict[tuple[torch.device, str], list[BatchThunk]] = {}
    for t in todo:
        by_dev.setdefault((t.device, t.domain), []).append(t)
    for (dev, domain), ts in by_dev.items():
        part = _Parts(dev)
        with part("fetch"):
            sites = sorted({f"{t.scheme.name}.fetch" for t in ts} & set(chaos.SITES))
            headers = _supervised_fetch(dev, [t.header for t in ts], domain,
                                        sites).view(np.uint32)
            full = []
            for i, t in enumerate(ts):
                verdict = decode_header(headers[2 * i:2 * i + 2], t.expected)
                if verdict == "full":
                    full.append(t)
                elif verdict != "happy":
                    raise TransferIntegrityError(
                        f"reduced-fetch header of a {t.scheme.name} batch: {verdict}")
            payloads = (_supervised_fetch(dev, [t.payload for t in full], domain, sites)
                        if full else None)
            _count_fetch(not full, headers.nbytes + (payloads.nbytes if full else 0))
        with part("recheck"):
            off = 0
            for t in ts:
                if t in full:
                    size = t.payload.shape[0]
                    payload = payloads[off:off + size]
                    t.mask, t.flips = decode_payload(payload, t.n, t.pre_ok, t.ok_a, t.rows,
                                                     t.scheme.verify_one, t.groups)
                    t.flipped = np.flatnonzero(t.mask & ~payload[:t.n].astype(bool))
                    off += size
                else:
                    t.mask = t.pre_ok & t.ok_a
                t.header = t.payload = None
                t.keep = ()
    return [t.mask for t in thunks]


def verify_rows(scheme: Scheme, pubs: list[bytes], msgs: list, sigs: list[bytes],
                cache: PubKeyCache | None = None, device=None,
                parts: dict | None = None) -> tuple[np.ndarray, int]:
    """(N,) bool mask under `scheme` and the number of recheck flips: one
    verify_batch_async resolved alone. Runs on the cache's device when a
    cache is given, else on `device` (default cuda). `parts`, a dict,
    receives each part's wall time in ms (plan, keys, pack, derive, verify,
    header, fetch, recheck), synchronised around each."""
    with timed_parts(parts):
        t = verify_batch_async(scheme, pubs, msgs, sigs, cache, device)
        mask = resolve_batches([t])[0]
    return mask, t.flips


def verify_batch(pubs: list[bytes], msgs: list, sigs: list[bytes],
                 cache: PubKeyCache | None = None, device=None
                 ) -> tuple[bool, list[bool]]:
    """ZIP-215 batch verification with a per-signature mask."""
    mask, _ = verify_rows(ED25519, pubs, msgs, sigs, cache, device)
    return bool(mask.all()), mask.tolist()
