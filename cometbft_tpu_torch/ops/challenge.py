"""Device-side ed25519 challenges: k = SHA-512(R || A || M) mod L derived on
the card from bytes it already holds, so only signature material crosses
to it. The port's counterpart of cometbft_tpu/ops/challenge.py.

  PrefixTable   a per-device table of TABLE_ROWS rows of prefix || tail
                bytes (a vote flush's shared sign-bytes prefix plus the
                batch-common trailer), content-keyed on the host, LRU with
                the in-flight plan's rows protected, dirty rows scattered to
                the device with a checksum.
  plan_batch    the plan-time choice of path: a Plan when most live lanes
                share one (prefix length, suffix length) and fit the
                geometry (MAX_MLEN, MAX_VAR), else None and the caller
                computes k on the host (the classic path). Lanes outside
                the plan get host k, scattered at `fidx` after the derive.
  fill_stream   packs the wire block's descriptor stream.
  derive        the wrapper of the challenge kernel K5 (csrc/
                challenge25519.cu) with its plain PyTorch version
                derive_plain; sha512_rows_device and reduce512_mod_l_device
                are K5's two thin standalone entries.

Source note. K5 replaces the XLA program ``challenge.py:730 derive_fn``
(and ``_digest_fn`` :328, ``_reduce_fn`` :351). It is bound by integer
issue and, at 10,240 lanes, by the latency of one lane's chain (SHA-512
rounds, the Barrett products): a warp builds each prefix-table row's
message template once in shared memory and a lane adds only its own bytes,
in blocks of at most 32 lanes that keep every SM busy, one thread a lane
(see the source).

Wire layout (ed25519_kernel._pack_device_block stages it), one flat uint32
block of a bucket of B lanes:

  words[0   : 8B ]  R encoding words, (8, B) word-major
  words[8B  : 16B]  s words, (8, B) word-major
  words[16B : W  ]  descriptor stream: 2B bytes of per-lane uint16 LE
                    descriptors (bit 15 = derive on the device, bits 0-14 =
                    prefix-table row), then B lanes of `var` variable
                    suffix bytes, lane-contiguous

The reference's challenge breaker has no counterpart: a derive that fails
raises. Nor has its config knob that turns device challenges off (it waits
for the node wiring, ROADMAP Queue 1). ``stats()`` counts plans, device and host-fallback lanes, and the
reasons a batch took the classic path.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from cometbft_tpu_torch.ops import _build, hashvec
from cometbft_tpu_torch.ops.integrity import to_int32

TABLE_ROWS = 256  # prefix/tail rows resident per table
PREFIX_CAP = 160  # prefix+tail bytes per row (vote prefixes are ~105)
MAX_VAR = 24      # variable suffix bytes shipped per lane
MAX_MLEN = 192    # message bytes (prefix+var+tail): 64 + 192 pads to <= 3 blocks
MIN_LANES = 4     # below this the classic path's fixed cost wins
MIN_ELIGIBLE_FRAC = 0.5  # mostly-fallback batches take the classic path

# device challenges on or off (config crypto.wire_device_challenge); off,
# every batch computes k on the host
_cfg = {"enabled": True}


def configure(enabled: bool | None = None) -> None:
    if enabled is not None:
        _cfg["enabled"] = bool(enabled)


def enabled() -> bool:
    return _cfg["enabled"]

_M32 = 0xFFFFFFFF

# ------------------------------------------------------------------- stats

_stats_lock = threading.Lock()
_stats: dict[str, int] = {}


def count(key: str, n: int = 1) -> None:
    with _stats_lock:
        _stats[key] = _stats.get(key, 0) + n


def stats() -> dict[str, int]:
    with _stats_lock:
        return dict(_stats)


def reset_stats() -> None:
    with _stats_lock:
        _stats.clear()


LAUNCHES = {"challenge_derive": 0, "challenge_sha512": 0, "challenge_reduce": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ------------------------------------------------------ prefix/tail table

_CHK_MULT = np.uint32(2654435761)  # position-weighted, as the staging checksum


def _host_tab_chk(idx: np.ndarray, vals: np.ndarray) -> int:
    w = np.arange(vals.size, dtype=np.uint32) * _CHK_MULT + np.uint32(1)
    chk = np.sum(vals.reshape(-1).astype(np.uint32) * w, dtype=np.uint32)
    chk += np.sum(idx.astype(np.uint32), dtype=np.uint32)
    return int(chk)


def _tab_scatter(tab: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor) -> int:
    """Write rows `vals` (db, PREFIX_CAP) uint8 at `idx` (db,) int64 into
    the device table in place, and the position-weighted checksum of what
    was written, taken on the device (_host_tab_chk's formula)."""
    tab.index_copy_(0, idx, vals)
    v = vals.reshape(-1).to(torch.int64)
    w = (torch.arange(v.numel(), dtype=torch.int64, device=v.device) * int(_CHK_MULT) + 1) & _M32
    return int(((v * w).sum() + idx.sum()) & _M32)


def _pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


class PrefixTable:
    """One device's prefix/tail dictionary: TABLE_ROWS rows of PREFIX_CAP
    bytes, a host mirror, and the dirty rows synced to the device.

    The reference's scatter is functional: an in-flight batch keeps its
    immutable snapshot. Here the device table is updated in place, so a
    plan takes its rows, syncs and copies the device table (40 KB) all under
    the table lock (snapshot): no other plan can evict its rows in between,
    and the copy is enqueued before any later scatter."""

    def __init__(self, put_key: str = "", device=None) -> None:
        from cometbft_tpu_torch import resolve_device

        self.put_key = put_key
        self.device = resolve_device(device)
        self._lock = threading.RLock()
        self._rows: dict[tuple[bytes, bytes], int] = {}  # content -> row
        self._lru: dict[tuple[bytes, bytes], None] = {}  # dict order = LRU
        self._host = np.zeros((TABLE_ROWS, PREFIX_CAP), dtype=np.uint8)
        self._dirty: set[int] = set()
        self._tab: torch.Tensor | None = None
        self.version = 0
        self.counters = {"inserts": 0, "hits": 0, "evictions": 0, "syncs": 0}

    def ensure(self, prefix: bytes, tail: bytes, protect: set[int] | None = None) -> int | None:
        """Row index for (prefix, tail), inserting (and evicting LRU) as
        needed. None when the content cannot be resident: over PREFIX_CAP,
        or every evictable row is protected by the plan being built."""
        if len(prefix) + len(tail) > PREFIX_CAP:
            return None
        key = (bytes(prefix), bytes(tail))
        with self._lock:
            row = self._rows.get(key)
            if row is not None:
                self.counters["hits"] += 1
                self._lru.pop(key, None)
                self._lru[key] = None
                return row
            if len(self._rows) < TABLE_ROWS:
                row = len(self._rows)
            else:
                victim = next((k for k in self._lru
                               if protect is None or self._rows[k] not in protect), None)
                if victim is None:
                    return None
                row = self._rows.pop(victim)
                self._lru.pop(victim)
                self.counters["evictions"] += 1
            self._rows[key] = row
            self._lru[key] = None
            self._host[row] = 0
            body = key[0] + key[1]
            self._host[row, :len(body)] = np.frombuffer(body, dtype=np.uint8)
            self._dirty.add(row)
            self.version += 1
            self.counters["inserts"] += 1
            return row

    def sync(self) -> torch.Tensor:
        """Scatter the dirty rows to the device and return the device table
        (TABLE_ROWS, PREFIX_CAP) uint8. The scatter's device checksum must
        equal the host's, else it raises."""
        from cometbft_tpu_torch.ops import residency

        with self._lock:
            if self._tab is None:
                self._tab = torch.zeros((TABLE_ROWS, PREFIX_CAP), dtype=torch.uint8,
                                        device=self.device)
            dirty = sorted(self._dirty)
            if not dirty:
                return self._tab
            db = _pow2(len(dirty))
            idx = np.full(db, dirty[-1], dtype=np.int64)
            idx[:len(dirty)] = dirty
            vals = self._host[idx]  # padding repeats the last row: idempotent
            got = _tab_scatter(self._tab, torch.from_numpy(idx).to(self.device),
                               torch.from_numpy(vals).to(self.device))
            residency.record_send("delta", vals.nbytes + 4 * db)
            if got != _host_tab_chk(idx, vals):
                raise RuntimeError("prefix-table upload failed its checksum "
                                   f"({got:#x} on the device)")
            self._dirty.clear()
            self.counters["syncs"] += 1
            return self._tab

    def snapshot(self, prefixes: list, tail: bytes, need: float
                 ) -> tuple[dict, torch.Tensor | None]:
        """One plan's rows and table: {prefix: row or None}, one ensure per
        distinct prefix of `prefixes` (a lane's each; the rows taken so far
        protected from one another), and, when at least `need` lanes got a
        row, a copy of the synced device table (else None). Held under the
        table lock from the first ensure to the copy."""
        with self._lock:
            rows: dict[bytes, int | None] = {}
            protect: set[int] = set()
            for p in prefixes:
                if p not in rows:
                    rows[p] = self.ensure(p, tail, protect=protect)
                    if rows[p] is not None:
                        protect.add(rows[p])
            if sum(rows[p] is not None for p in prefixes) < need:
                return rows, None
            return rows, self.sync().clone()

    def stats(self) -> dict:
        with self._lock:
            return dict(self.counters, rows=len(self._rows), capacity=TABLE_ROWS,
                        version=self.version, dirty=len(self._dirty))


_tables_lock = threading.Lock()
_tables: dict[tuple[str, torch.device], PrefixTable] = {}


def table(put_key: str = "", device=None) -> PrefixTable:
    """The prefix table of (put_key, device), built on first use."""
    from cometbft_tpu_torch import resolve_device

    dev = resolve_device(device)
    with _tables_lock:
        t = _tables.get((put_key, dev))
        if t is None:
            t = _tables[(put_key, dev)] = PrefixTable(put_key, dev)
        return t


def drop_tables(put_key: str) -> int:
    """Forget the prefix tables of `put_key` on every device (a mesh
    domain's, residency.invalidate_device). Returns how many."""
    with _tables_lock:
        keys = [k for k in _tables if k[0] == put_key]
        for k in keys:
            del _tables[k]
    return len(keys)


def reset() -> None:
    """Forget every table and counter (tests)."""
    with _tables_lock:
        _tables.clear()
    reset_stats()


# ------------------------------------------------------------ batch planning


class Plan:
    """One batch's device-challenge geometry, fixed at plan time: the
    message shape (plen, var, tlen), the per-lane prefix rows and
    eligibility, the variable bytes, and the device table they index."""

    __slots__ = ("plen", "tlen", "var", "slen", "pids", "eligible", "vbytes", "dev_tab",
                 "n", "n_eligible", "n_fallback", "put_key")

    def __init__(self, *, plen, tlen, var, slen, pids, eligible, vbytes, dev_tab, n,
                 n_eligible, n_fallback, put_key):
        self.plen = plen
        self.tlen = tlen
        self.var = var
        self.slen = slen
        self.pids = pids
        self.eligible = eligible
        self.vbytes = vbytes
        self.dev_tab = dev_tab
        self.n = n
        self.n_eligible = n_eligible
        self.n_fallback = n_fallback
        self.put_key = put_key


def plan_batch(msgs, pre_ok, put_key: str = "", device=None) -> Plan | None:
    """A Plan when device challenges serve this batch: the dominant
    (prefix-len, suffix-len) combination covers at least MIN_LANES and half
    the live lanes, the messages fit MAX_MLEN and the variable part
    MAX_VAR, and the table holds the prefixes. Else None: the caller
    computes every k on the host. Lanes outside the dominant combination
    or without a table row get host k inside the Plan. Plain bytes plan as
    an empty prefix with the whole message as suffix, which a commit's
    ~120-byte rows never fit (var > MAX_VAR)."""
    from cometbft_tpu_torch.libs.prefixrows import PrefixedMsg

    n = len(msgs)
    if not _cfg["enabled"]:
        count("plan_disabled")
        return None
    if n < MIN_LANES:
        count("plan_small")
        return None
    pre_ok = np.asarray(pre_ok, dtype=bool)
    prefixes: list = [None] * n
    suffixes: list = [None] * n
    combos: dict[tuple[int, int], int] = {}
    for i, m in enumerate(msgs):
        if not pre_ok[i]:
            continue
        p, s = (m.prefix, m.suffix) if isinstance(m, PrefixedMsg) else (b"", bytes(m))
        prefixes[i] = p
        suffixes[i] = s
        combos[(len(p), len(s))] = combos.get((len(p), len(s)), 0) + 1
    if not combos:
        count("plan_no_ok_lanes")
        return None
    (plen, slen), nc = max(combos.items(), key=lambda kv: kv[1])
    n_ok = int(pre_ok.sum())
    if plen + slen > MAX_MLEN or plen > PREFIX_CAP:
        count("plan_oversize")
        return None
    if nc < MIN_LANES or nc < MIN_ELIGIBLE_FRAC * n_ok:
        count("plan_low_eligibility")
        return None
    cidx = np.array([i for i in range(n) if prefixes[i] is not None
                     and len(prefixes[i]) == plen and len(suffixes[i]) == slen],
                    dtype=np.intp)
    sfx = np.frombuffer(b"".join(suffixes[i] for i in cidx),
                        dtype=np.uint8).reshape(len(cidx), slen)
    # the batch-common trailing run (vote rows: the chain-id trailer after
    # the per-lane timestamp) rides the table row, not the wire
    tlen = 0
    if slen:
        eqcols = (sfx == sfx[0]).all(axis=0)
        while tlen < slen and eqcols[slen - 1 - tlen]:
            tlen += 1
    tlen = min(tlen, PREFIX_CAP - plen)
    var = slen - tlen
    if var > MAX_VAR:
        count("plan_oversize_var")
        return None
    tail = sfx[0, slen - tlen:].tobytes() if tlen else b""
    rows, dev_tab = table(put_key, device).snapshot(
        [prefixes[i] for i in cidx], tail, max(MIN_LANES, MIN_ELIGIBLE_FRAC * n_ok))
    pids = np.full(n, -1, dtype=np.int32)
    misses = 0
    for i in cidx:
        pid = rows[prefixes[i]]
        if pid is None:
            misses += 1
            continue
        pids[i] = pid
    if misses:
        count("lane_table_miss", misses)
    eligible = pids >= 0
    ne = int(eligible.sum())
    if ne < MIN_LANES or ne < MIN_ELIGIBLE_FRAC * n_ok:
        count("plan_low_eligibility")
        return None
    vbytes = np.zeros((n, var), dtype=np.uint8)
    if var:
        vbytes[cidx] = sfx[:, :var]
    count("plans")
    count("lanes_device", ne)
    count("lanes_host_fallback", n_ok - ne)
    return Plan(plen=plen, tlen=tlen, var=var, slen=slen, pids=pids, eligible=eligible,
                vbytes=vbytes, dev_tab=dev_tab, n=n, n_eligible=ne, n_fallback=n_ok - ne,
                put_key=put_key)


# ------------------------------------------------------------- wire packing


def stream_words(bucket: int, var: int) -> int:
    """uint32 words of descriptor stream for a bucket: 2 descriptor bytes
    per lane plus `var` lane-contiguous suffix bytes per lane."""
    return (2 * bucket + var * bucket + 3) // 4


def block_words(bucket: int, var: int) -> int:
    """uint32 words of one flat device-challenge block: R words, s words,
    descriptor stream."""
    return 16 * bucket + stream_words(bucket, var)


def fill_stream(block: np.ndarray, bucket: int, plan: Plan) -> None:
    """Pack the descriptor stream of a flat block in place: per-lane uint16
    LE descriptors (bit 15 = derive on the device, bits 0-14 = prefix-table
    row; 0 for padding and host-k lanes), then the lane-contiguous variable
    suffix bytes."""
    sw = stream_words(bucket, plan.var)
    sb = block[16 * bucket:16 * bucket + sw].view(np.uint8)
    sb[:] = 0
    n = plan.n
    desc = sb[:2 * bucket].view("<u2")
    vals = np.zeros(n, dtype=np.uint16)
    el = plan.eligible
    vals[el] = (0x8000 | plan.pids[el]).astype(np.uint16)
    desc[:n] = vals
    if plan.var:
        sb[2 * bucket:2 * bucket + bucket * plan.var].reshape(bucket, plan.var)[:n] = plan.vbytes


# ------------------------------------------------- plain version: SHA-512
#
# 64-bit words as (hi, lo) pairs of int64 tensors, each half in [0, 2^32):
# every intermediate fits int64, where this CPU build of torch has no
# uint64 arithmetic. The same ring operations as the kernel's uint64_t.

_K512 = [int(k) for k in hashvec._SHA_K]
_H0 = [int(h) for h in hashvec._SHA_H0]


def _add(*xs):
    lo = sum(x[1] for x in xs)
    hi = sum(x[0] for x in xs) + (lo >> 32)
    return hi & _M32, lo & _M32


def _rotr(x, n: int):
    hi, lo = x
    if n >= 32:
        hi, lo, n = lo, hi, n - 32
    if n == 0:
        return hi, lo
    return ((hi >> n) | (lo << (32 - n))) & _M32, ((lo >> n) | (hi << (32 - n))) & _M32


def _shr(x, n: int):
    hi, lo = x
    return hi >> n, ((lo >> n) | (hi << (32 - n))) & _M32


def _xor(*xs):
    hi, lo = xs[0]
    for x in xs[1:]:
        hi, lo = hi ^ x[0], lo ^ x[1]
    return hi, lo


def _const(v: int, like: torch.Tensor):
    return (torch.full_like(like, v >> 32), torch.full_like(like, v & _M32))


def _compress(h: list, w: list) -> list:
    """One SHA-512 compression of the 16 big-endian message words w
    (pairs) into the state h (pairs)."""
    w = list(w)
    a, b, c, d, e, f, g, hh = h
    for t in range(80):
        if t >= 16:
            w15, w2 = w[(t - 15) % 16], w[(t - 2) % 16]
            s0 = _xor(_rotr(w15, 1), _rotr(w15, 8), _shr(w15, 7))
            s1 = _xor(_rotr(w2, 19), _rotr(w2, 61), _shr(w2, 6))
            w[t % 16] = _add(w[t % 16], s0, w[(t - 7) % 16], s1)
        s1e = _xor(_rotr(e, 14), _rotr(e, 18), _rotr(e, 41))
        ch = (g[0] ^ (e[0] & (f[0] ^ g[0])), g[1] ^ (e[1] & (f[1] ^ g[1])))
        k = (_K512[t] >> 32, _K512[t] & _M32)
        t1 = _add(hh, s1e, ch, k, w[t % 16])
        s0a = _xor(_rotr(a, 28), _rotr(a, 34), _rotr(a, 39))
        mj = ((a[0] & (b[0] | c[0])) | (b[0] & c[0]), (a[1] & (b[1] | c[1])) | (b[1] & c[1]))
        t2 = _add(s0a, mj)
        hh, g, f, e = g, f, e, _add(d, t1)
        d, c, b, a = c, b, a, _add(t1, t2)
    return [_add(x, y) for x, y in zip(h, (a, b, c, d, e, f, g, hh))]


def sha512_padded_plain(msg: torch.Tensor) -> torch.Tensor:
    """(N, nb*128) int64 bytes of padded messages -> (N, 64) int64 digest
    bytes."""
    n, ln = msg.shape
    be = msg.reshape(n, ln // 4, 4)
    words32 = (be[..., 0] << 24) | (be[..., 1] << 16) | (be[..., 2] << 8) | be[..., 3]
    like = words32[:, 0]
    h = [_const(v, like) for v in _H0]
    for bi in range(ln // 128):
        blk = words32[:, 32 * bi:32 * bi + 32]
        h = _compress(h, [(blk[:, 2 * t], blk[:, 2 * t + 1]) for t in range(16)])
    out = []
    for hi, lo in h:
        out += [(hi >> s) & 0xFF for s in (24, 16, 8, 0)] + [(lo >> s) & 0xFF for s in (24, 16, 8, 0)]
    return torch.stack(out, dim=1)


def sha512_pad_plain(rows: torch.Tensor) -> torch.Tensor:
    """(N, L) int64 bytes of same-length messages -> (N, nb*128) padded."""
    n, ln = rows.shape
    nb = (ln + 17 + 127) // 128
    buf = torch.zeros((n, nb * 128), dtype=torch.int64, device=rows.device)
    buf[:, :ln] = rows
    buf[:, ln] = 0x80
    bits = ln * 8
    for q in range(16):
        buf[:, nb * 128 - 1 - q] = (bits >> (8 * q)) & 0xFF
    return buf


# ------------------------------------------------ plain version: mod L

_MU17 = [int(v) for v in hashvec._MU17]
_L17 = [int(v) for v in hashvec._L17]


def _carry16(acc: list) -> list:
    c = torch.zeros_like(acc[0])
    for j in range(len(acc)):
        t = acc[j] + c
        acc[j] = t & 0xFFFF
        c = t >> 16
    return acc


def reduce512_plain(digest: torch.Tensor) -> torch.Tensor:
    """(N, 64) int64 bytes of little-endian 512-bit values -> (N, 8) int64
    words (uint32 values) of value mod L: the Barrett reduction in base
    2^16 limbs (products < 2^32, sums < 2^37), HAC 14.42, then at most two
    conditional subtractions."""
    x = [digest[:, 2 * j] | (digest[:, 2 * j + 1] << 8) for j in range(32)]
    zero = torch.zeros_like(x[0])
    q1 = x[15:]
    q2 = [zero] * 34
    for i in range(17):
        for j in range(17):
            q2[i + j] = q2[i + j] + q1[j] * _MU17[i]
    q3 = _carry16(q2)[17:]
    r2 = [zero] * 17
    for i in range(17):
        if _L17[i]:
            for j in range(17 - i):
                r2[i + j] = r2[i + j] + q3[j] * _L17[i]
    r2 = _carry16(r2)
    r, borrow = [], zero
    for j in range(17):
        t = x[j] - r2[j] - borrow
        r.append(t & 0xFFFF)
        borrow = (t < 0).to(torch.int64)
    for _ in range(2):
        t, borrow = [], zero
        for j in range(17):
            d = r[j] - _L17[j] - borrow
            t.append(d & 0xFFFF)
            borrow = (d < 0).to(torch.int64)
        ge = borrow == 0
        r = [torch.where(ge, tj, rj) for tj, rj in zip(t, r)]
    return torch.stack([r[2 * w] | (r[2 * w + 1] << 16) for w in range(8)], dim=1)


# --------------------------------------------- plain version: the derive


def _word_bytes(w: torch.Tensor) -> torch.Tensor:
    """(8, B) int32 words -> (B, 32) int64 little-endian bytes."""
    v = w.to(torch.int64) & _M32
    return torch.stack([(v >> (8 * k)) & 0xFF for k in range(4)], dim=-1).permute(1, 0, 2) \
        .reshape(w.shape[1], 32)


def derive_plain(flat: torch.Tensor, aw: torch.Tensor, ptab: torch.Tensor, bucket: int,
                 var: int, plen: int, tlen: int) -> torch.Tensor:
    """What K5 computes, in plain torch: (8, bucket) int32 k words (the
    uint32 bits), zero where the lane's descriptor bit 15 is clear."""
    dev = flat.device
    sw = stream_words(bucket, var)
    stream = flat[16 * bucket:16 * bucket + sw].to(torch.int64) & _M32
    sb = torch.stack([(stream >> (8 * k)) & 0xFF for k in range(4)], dim=-1).reshape(-1)
    desc = sb[0:2 * bucket:2] | (sb[1:2 * bucket:2] << 8)
    use = desc >> 15
    pid = torch.clamp(desc & 0x7FFF, max=TABLE_ROWS - 1)
    parts = [_word_bytes(flat[:8 * bucket].reshape(8, bucket)), _word_bytes(aw)]
    row = ptab.to(torch.int64)[pid]  # (bucket, PREFIX_CAP)
    parts.append(row[:, :plen])
    if var:
        lanes = torch.arange(bucket, dtype=torch.int64, device=dev)[:, None]
        parts.append(sb[2 * bucket + lanes * var + torch.arange(var, device=dev)[None, :]])
    parts.append(row[:, plen:plen + tlen])
    msg = sha512_pad_plain(torch.cat(parts, dim=1))
    k = reduce512_plain(sha512_padded_plain(msg))  # (bucket, 8)
    return to_int32(k.T * use[None, :]).contiguous()


# ------------------------------------------------------------------ kernel

_lib_cache: list = []


def _lib() -> ctypes.CDLL:
    if not _lib_cache:
        lib = _build.library("challenge25519")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.challenge_derive.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, vp]
        lib.challenge_sha512_rows.argtypes = [vp, ci, ci, vp, vp]
        lib.challenge_reduce512.argtypes = [vp, ci, vp, vp]
        lib.challenge_launch_shape.argtypes = [ci, ci, ctypes.POINTER(ci)]
        for f in (lib.challenge_derive, lib.challenge_sha512_rows, lib.challenge_reduce512,
                  lib.challenge_launch_shape):
            f.restype = ci
        _lib_cache.append(lib)
    return _lib_cache[0]


def _raise_on(err: int, entry: str) -> None:
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: cudaError_t {err}")


def _check(name: str, t: torch.Tensor, dtype, shape: tuple, dev: torch.device) -> None:
    if t.device != dev or t.dtype != dtype or t.shape != shape or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {dtype} tensor {shape} on {dev}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")


def derive(flat: torch.Tensor, aw: torch.Tensor, ptab: torch.Tensor, bucket: int, var: int,
           plen: int, tlen: int, fkw: torch.Tensor | None = None,
           fidx: torch.Tensor | None = None) -> torch.Tensor:
    """The counterpart of derive_fn: the staged block (block_words,) int32,
    the encoding words aw (8, bucket) int32, the prefix table (TABLE_ROWS,
    PREFIX_CAP) uint8 -> k words (8, bucket) int32, then the host k of the
    plan's fallback lanes (fkw (8, fb) int32) written at fidx (fb,). The
    plain version for CPU tensors, K5 for CUDA tensors."""
    dev = flat.device
    if dev.type == "cpu":
        kw = derive_plain(flat, aw, ptab, bucket, var, plen, tlen)
    elif dev.type == "cuda":
        _check("flat", flat, torch.int32, (block_words(bucket, var),), dev)
        _check("aw", aw, torch.int32, (8, bucket), dev)
        _check("ptab", ptab, torch.uint8, (TABLE_ROWS, PREFIX_CAP), dev)
        if plen + var + tlen > MAX_MLEN or var > MAX_VAR:
            raise ValueError(f"message of {plen} + {var} + {tlen} bytes exceeds MAX_MLEN or "
                             f"MAX_VAR")
        kw = torch.empty((8, bucket), dtype=torch.int32, device=dev)
        with _build.on_device(dev):
            err = _lib().challenge_derive(flat.data_ptr(), aw.data_ptr(), ptab.data_ptr(),
                                          kw.data_ptr(), bucket, plen, var, tlen,
                                          _build.raw_stream(dev))
        _raise_on(err, "challenge_derive")
        LAUNCHES["challenge_derive"] += 1
    else:
        raise ValueError(f"unsupported device {dev}")
    if fkw is not None:
        kw.index_copy_(1, fidx.to(torch.int64), fkw)
    return kw


def sha512_rows_device(rows: np.ndarray, device=None) -> np.ndarray:
    """(N, L) uint8 same-length rows -> (N, 64) uint8 digests on `device`
    (K5's digest entry on a card, the plain version on the CPU): bit for bit
    hashlib.sha512."""
    from cometbft_tpu_torch import resolve_device

    dev = resolve_device(device)
    n, ln = rows.shape
    if n == 0:
        return np.zeros((0, 64), dtype=np.uint8)
    if dev.type == "cpu":
        t = torch.from_numpy(np.ascontiguousarray(rows)).to(torch.int64)
        return sha512_padded_plain(sha512_pad_plain(t)).to(torch.uint8).numpy()
    nb = (ln + 17 + 127) // 128
    buf = np.zeros((n, nb * 128), dtype=np.uint8)
    buf[:, :ln] = rows
    buf[:, ln] = 0x80
    buf[:, -16:] = np.frombuffer((ln * 8).to_bytes(16, "big"), dtype=np.uint8)
    buf_d = torch.from_numpy(buf).to(dev)
    out = torch.empty((n, 64), dtype=torch.uint8, device=dev)
    with _build.on_device(dev):
        err = _lib().challenge_sha512_rows(buf_d.data_ptr(), n, nb, out.data_ptr(),
                                           _build.raw_stream(dev))
    _raise_on(err, "challenge_sha512_rows")
    LAUNCHES["challenge_sha512"] += 1
    return out.cpu().numpy()


def reduce512_mod_l_device(digests: np.ndarray, device=None) -> np.ndarray:
    """(N, 64) uint8 little-endian values -> (N, 8) uint32 words of (value
    mod L) on `device` (K5's reduction entry on a card, the plain version
    on the CPU)."""
    from cometbft_tpu_torch import resolve_device

    dev = resolve_device(device)
    n = digests.shape[0]
    if n == 0:
        return np.zeros((0, 8), dtype=np.uint32)
    if dev.type == "cpu":
        t = torch.from_numpy(np.ascontiguousarray(digests)).to(torch.int64)
        return reduce512_plain(t).numpy().astype(np.uint32)
    x = torch.from_numpy(np.ascontiguousarray(digests)).to(dev)
    out = torch.empty((n, 8), dtype=torch.int32, device=dev)
    with _build.on_device(dev):
        err = _lib().challenge_reduce512(x.data_ptr(), n, out.data_ptr(),
                                         _build.raw_stream(dev))
    _raise_on(err, "challenge_reduce512")
    LAUNCHES["challenge_reduce"] += 1
    return out.cpu().numpy().view(np.uint32)


_SHAPE_ENTRIES = ("challenge_derive", "challenge_sha512", "challenge_reduce")


def launch_shape(entry: str, n: int, dev: torch.device) -> dict[str, int]:
    """How K5's `entry` launches n lanes on CUDA device `dev` (the derive
    entry at MAX_BLOCKS message blocks): lanes per block, blocks, threads per
    block, resident blocks per SM, SMs, waves, local memory per thread and
    registers. Launches nothing."""
    out = (ctypes.c_int * 7)()
    with _build.on_device(dev):
        err = _lib().challenge_launch_shape(_SHAPE_ENTRIES.index(entry), n, out)
    _raise_on(err, f"{entry} launch shape")
    lanes, blocks, threads, per_sm, sms, local_bytes, registers = out
    if per_sm < 1:
        raise RuntimeError(f"{entry}: no block of {threads} threads fits an SM")
    return {"lanes_per_block": lanes, "blocks": blocks, "threads_per_block": threads,
            "blocks_per_sm": per_sm, "sms": sms, "waves": -(-blocks // (per_sm * sms)),
            "local_bytes": local_bytes, "registers": registers}
