"""Batched Ed25519 ZIP-215 verification: host staging, the pubkey cache and
the device glue around the kernels of ops/verify_kernel.py.

Per lane the device computes [8]([s]B - [k]A - R) == O (cofactored,
ZIP-215). R, s and k cross to the device as packed (8, B) 32-bit words;
validator pubkeys are decompressed once (on the device) and kept in a
two-level cache, since a validator set re-verifies every height. The few
lanes the device rejects are re-verified by the exact host oracle before
they are reported (recheck_failed_lanes); a lane it flips back to valid
means the device was wrong, and is counted.

Batch sizes are bucketed (powers of two from 8 up to 2048, then multiples
of 2048); padding lanes carry the identity encoding (y = 1) with zero
scalars, which verify valid, and are sliced off.

The cache, the device glue and the recheck serve sr25519 too
(ops/sr25519_kernel.py): a Scheme record names what differs — identity
encoding, staging, the kernels, the host oracle.
"""

from __future__ import annotations

import hashlib
import threading
from typing import Callable, NamedTuple

import numpy as np
import torch

from cometbft_tpu_torch import resolve_device
from cometbft_tpu_torch.crypto import ed25519_math as oracle
from cometbft_tpu_torch.ops import limbs as L
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
        sig_rows = np.frombuffer(b"".join(sigs), dtype=np.uint8).reshape(n, 64).copy()
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
        sig_rows[bad, :32] = _ID_ROW32
        sig_rows[bad, 32:] = 0
        safe_pubs = [p if pre_ok[i] else _ID_ENC32
                     for i, p in enumerate(safe_pubs)]
    return pre_ok, safe_pubs, sig_rows, pub_rows


def _challenge_words(r_rows, pub_rows, msgs, pre_ok) -> np.ndarray:
    """(N, 8) uint32 packed challenges k = SHA-512(R || A || M) mod L;
    rows with pre_ok False get k = 0."""
    n = r_rows.shape[0]
    out = bytearray(32 * n)
    r_blob, p_blob = r_rows.tobytes(), pub_rows.tobytes()
    for i in range(n):
        if not pre_ok[i]:
            continue
        h = hashlib.sha512(r_blob[32 * i:32 * i + 32])
        h.update(p_blob[32 * i:32 * i + 32])
        h.update(msgs[i])
        k = int.from_bytes(h.digest(), "little") % oracle.L
        out[32 * i:32 * i + 32] = k.to_bytes(32, "little")
    return np.frombuffer(bytes(out), dtype="<u4").reshape(n, 8)


def stage_batch(pubs: list[bytes], msgs: list[bytes], sigs: list[bytes],
                bucket: int):
    """Structural checks, SHA-512 challenges, and the packed r/s/k words,
    batch-minor (8, bucket) uint32, identity-padded to `bucket`. Returns
    (pre_ok, safe_pubs, r_words, s_words, k_words)."""
    pre_ok, safe_pubs, sig_rows, pub_rows = _structural_stage(pubs, sigs)
    n = sig_rows.shape[0]
    k_rows = _challenge_words(sig_rows[:, :32], pub_rows, msgs, pre_ok)
    sig_u4 = sig_rows.view("<u4")  # (n, 16): words 0-7 = R, 8-15 = s
    out = np.zeros((3, 8, bucket), dtype=np.uint32)
    r_words, s_words, k_words = out[0], out[1], out[2]
    r_words[:, :n] = sig_u4[:, :8].T
    s_words[:, :n] = sig_u4[:, 8:].T
    k_words[:, :n] = k_rows.T
    r_words[0, n:] = 1  # padding: identity encoding + zero scalars
    return pre_ok, safe_pubs, r_words, s_words, k_words


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
    everything else (buckets, the key cache, the device glue, the recheck)
    is shared."""

    name: str
    id_enc: bytes  # identity encoding: padding lanes and placeholder pubkeys
    decompress: Callable  # kernel wrapper: (8, B) words -> ok, X, Y, Z, T
    stage: Callable  # (pubs, msgs, sigs, bucket) -> pre_ok, safe_pubs, r, s, k words
    verify_ok: Callable  # kernel wrapper: A coords + r/s/k words -> mask, all-ok
    verify_one: Callable  # (pub, msg, sig) -> bool: the exact host oracle


ED25519 = Scheme("ed25519", _ID_ENC32, VK.decompress, stage_batch, VK.verify_ok,
                 oracle.verify_zip215)


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
    """Two-level decompressed-pubkey cache for one device and one scheme.

    Host level: pubkey bytes -> (ok, (4, 20) int32 coords), bounded FIFO.
    Device level: digest of the padded pubkey batch -> (ok_a, the four
    (20, B) coordinate tensors already on the device) — the steady-state
    hit for commit verification, where the same validator set re-verifies
    every height and neither decompression nor the coordinate upload
    recurs. The same 32 bytes decode to different points under each
    scheme, so a cache holds one scheme's keys only.
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

    def stage(self, pubs: list[bytes], bucket: int) -> tuple[np.ndarray, tuple]:
        """(ok_a (N,) host bool, (ax, ay, az, at) device tensors (20, bucket))."""
        with self._lock:
            digest = hashlib.sha256(b"".join(pubs)).digest() + bucket.to_bytes(4, "little")
            hit = self._dev.get(digest)
            if hit is not None:
                self.counters["device_hits"] += 1
                return hit
            self.counters["device_misses"] += 1
            ok_a, coords = self.lookup_or_decompress(pubs)
            dev = tuple(_to_device(a, self.device)
                        for a in pad_coords_batch_minor(coords, bucket))
            if len(self._dev) >= self.device_slots:
                self._dev.pop(next(iter(self._dev)))
                self.counters["device_evictions"] += 1
            self._dev[digest] = (ok_a, dev)
            return ok_a, dev


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


# ------------------------------------------------------------------ verify

# Failed lanes are re-verified by the exact host oracle before they are
# reported invalid, up to this many per batch (a batch with more failures
# is genuinely bad). A lane the oracle accepts is flipped to valid and
# counted: it means the device computed a wrong verdict.
RECHECK_MAX = 32


def recheck_failed_lanes(mask: np.ndarray, eligible: np.ndarray, pubs, msgs,
                         sigs, verify_one: Callable = oracle.verify_zip215
                         ) -> tuple[np.ndarray, int]:
    """eligible: lanes that passed the host structural checks and pubkey
    decompression (a placeholder lane is the identity, which validly signs
    anything, and must never be flipped). verify_one is the scheme's host
    oracle. Returns (mask, number of lanes flipped to valid)."""
    bad = np.flatnonzero(~mask & eligible)
    if len(bad) == 0 or len(bad) > RECHECK_MAX:
        return mask, 0
    flips = 0
    for i in bad:
        if verify_one(pubs[i], msgs[i], sigs[i]):
            mask[i] = True
            flips += 1
    return mask, flips


def verify_rows(scheme: Scheme, pubs: list[bytes], msgs: list[bytes],
                sigs: list[bytes], cache: PubKeyCache | None = None,
                device=None) -> tuple[np.ndarray, int]:
    """(N,) bool mask under `scheme` and the number of recheck flips. Runs
    on the cache's device when a cache is given, else on `device` (default
    cuda)."""
    n = len(sigs)
    if len(pubs) != n or len(msgs) != n:
        raise ValueError("pubs, msgs and sigs differ in length")
    if cache is None:
        cache = default_cache(device, scheme)
    elif cache.scheme is not scheme:
        raise ValueError(f"cache holds {cache.scheme.name} keys, not {scheme.name}")
    elif device is not None and resolve_device(device) != cache.device:
        raise ValueError(f"cache lives on {cache.device}, not {device}")
    dev = cache.device
    if n == 0:
        return np.zeros(0, dtype=bool), 0
    b = bucket_size(n)
    msgs = [bytes(m) for m in msgs]
    pre_ok, safe_pubs, r_words, s_words, k_words = scheme.stage(pubs, msgs, sigs, b)
    ok_a, a_dev = cache.stage(safe_pubs, b)
    words = tuple(_words_to_device(w, dev) for w in (r_words, s_words, k_words))
    mask_dev, allok_dev = scheme.verify_ok(*a_dev, *words)
    full = mask_dev.cpu().numpy()
    if bool(allok_dev) != bool(full.all()):
        raise RuntimeError("device all-ok disagrees with its own mask")
    eligible = pre_ok & ok_a
    mask = full[:n] & eligible
    return recheck_failed_lanes(mask, eligible, safe_pubs, msgs, sigs,
                                scheme.verify_one)


def verify_batch(pubs: list[bytes], msgs: list[bytes], sigs: list[bytes],
                 cache: PubKeyCache | None = None, device=None
                 ) -> tuple[bool, list[bool]]:
    """ZIP-215 batch verification with a per-signature mask."""
    mask, _ = verify_rows(ED25519, pubs, msgs, sigs, cache, device)
    return bool(mask.all()), mask.tolist()
