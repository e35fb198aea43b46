"""On-card smoke run of the PyTorch/CUDA port (cometbft_tpu_torch).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds the port's CUDA kernels from csrc/, holds each kernel against its
plain PyTorch version on the card (bit for bit: all arithmetic is integer),
and drives the main paths through the entry points a node calls:

  - ed25519: crypto.batch.create_batch_verifier -> add -> verify on a
    10,240-validator commit and on 150-validator commits;
  - sr25519: the same on a 10,240-validator commit;
  - mixed: crypto.batch.create_mixed_batch_verifier on a 10,240-validator
    mega-commit, ed25519 and sr25519 validators interleaved;

with tampered lanes at known indices. It checks the masks, the launch and
lane counters and the host-oracle recheck, times the kernels, their plain
versions and verify() end to end, and prints one JSON line of kernel
records and, last, the device record. Any mismatch raises; without a card
it exits non-zero before printing a result.
"""

from __future__ import annotations

import hashlib
import json
import re
import statistics
import subprocess
import sys
import time
from typing import Callable, NamedTuple

import numpy as np
import torch

# Seeds of the synthetic validator sets (keys and nonces are random
# scalars derived from them).
SEED_BIG, SEED_SMALL, SEED_CHECK, SEED_SR, SEED_MIXED = 20240, 150, 7, 25519, 5
N_BIG, N_SMALL = 10_240, 150
N_MIXED_BUCKET = 6_144  # the mixed commit's per-scheme bucket (5,120 signatures)
CHAIN_ID = "cosmoshub-4"

# int32 multiply-add peak of one H100 SXM: 132 SMs x 64 IMAD results per
# clock per SM (CUDA C++ Programming Guide, arithmetic instruction
# throughput, compute capability 9.0) x 1.98 GHz boost clock (NVIDIA H100
# SXM5 data sheet).
IMAD_PER_S = 132 * 64 * 1.98e9
HBM_BYTES_PER_S = 3.35e12

# Field multiplications per lane, counted from csrc/ed25519_verify.cu:
#   ZIP-215 R decompression: 255 squarings + 19 multiplies (+1 where
#     v*x^2 != u, left out: the bound counts the least work);
#   ristretto255 R decoding: 256 squarings (s^2, u2^2, v^2, v3^2, the 251 of
#     pow22523, r^2) + 26 multiplies (d*u1*u1, v*u2^2, v3, v7, u*v3, u*v7,
#     the 11 of pow22523, the check, u*sqrt(-1), den_x, den_y 2, x, y, t;
#     +1 for the conditional r*sqrt(-1), left out);
#   -A table: 8 doublings (4 sq + 4 mul), 7 adds (9 mul), 17 T premuls;
#   ladder: 51 windows x (5 doublings = 20 sq + 16 mul, madd 7 mul, add 7
#     mul; the last add 8);
#   tail: one add (9 mul), then 3 doublings (12 sq + 12 mul) for ed25519's
#     cofactor 8, 2 (8 sq + 8 mul) for sr25519's cofactor 4.
# A multiply is 400 limb products, a square 210; each also folds 20 high
# limbs by a multiply (FOLD * hi).
SQ_DECOMP, MUL_DECOMP = 255, 19
SQ_DECODE_SR, MUL_DECODE_SR = 256, 26
SQ_LADDER, MUL_LADDER = 8 * 4 + 51 * 20, (8 * 4 + 7 * 9 + 17) + (51 * 30 + 1)
SQ_VERIFY = SQ_DECOMP + SQ_LADDER + 12
MUL_VERIFY = MUL_DECOMP + MUL_LADDER + (9 + 12)
SQ_VERIFY_SR = SQ_DECODE_SR + SQ_LADDER + 8
MUL_VERIFY_SR = MUL_DECODE_SR + MUL_LADDER + (9 + 8)
# bytes per lane, each input read once and each output written once: A
# coords 4 x 80 + r/s/k words 3 x 32 in, the mask out; for decoding, the
# encoding in, ok and X/Y/Z/T out
VERIFY_BYTES, DECOMP_BYTES = 4 * 80 + 3 * 32 + 4, 32 + 4 + 4 * 80


def _imads(sq: int, mul: int) -> int:
    """IMADs of the kernel's own radix-2^13 representation."""
    return sq * 210 + mul * 400 + (sq + mul) * 20


def _imads32(sq: int, mul: int) -> int:
    """IMADs of the same field work in 8 x 32-bit limbs: a multiply is 64
    32x32->64 products, a square 36, each plus 8 products folding the high
    half by 38; a product is two IMADs (mad.lo and mad.hi)."""
    return 2 * (sq * (36 + 8) + mul * (64 + 8))


def bound(imad_per_lane: int, bytes_per_lane: int, lanes: int) -> tuple[float, str]:
    """Least ms for `lanes` lanes: IMADs over the IMAD peak or bytes (each
    input read once, each output written once) over HBM, the larger. The
    kernel records take the IMADs of 32-bit limbs (_imads32), the least the
    field work needs; the kernel's own radix-2^13 count is printed beside."""
    ops = imad_per_lane * lanes / IMAD_PER_S * 1e3
    mem = bytes_per_lane * lanes / HBM_BYTES_PER_S * 1e3
    return (ops, "operations") if ops >= mem else (mem, "bytes")


def _smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def ptxas_summary(report: str) -> dict[str, list[str]]:
    """Kernel name -> its stack/spill and register lines of `nvcc -Xptxas
    -v` (the template kernels' names are mangled: verify_kernel<0> is
    ed25519, <1> sr25519)."""
    out: dict[str, list[str]] = {}
    cur = None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '_Z\d+(verify|decompress)_kernelILi(\d)E", line)
        if m:
            cur = f"{('ed25519', 'sr25519')[int(m.group(2))]}_{m.group(1)}"
            out[cur] = []
        elif cur and ("spill" in line or "registers" in line):
            out[cur].append(line.split(":", 1)[-1].strip() if "registers" in line
                            else line.strip())
            if "registers" in line:
                cur = None
    return out


# ------------------------------------------------------------------ data


def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _field(tag: int, payload: bytes) -> bytes:
    return bytes([tag]) + _varint(len(payload)) + payload


def vote_sign_bytes(height: int, block_hash: bytes, secs: int, nanos: int) -> bytes:
    """Length-delimited CanonicalVote (PRECOMMIT) protobuf, the sign-bytes
    of a commit signature: type, height, round, block id, timestamp, chain
    id."""
    psh = b"\x08" + _varint(1) + _field(0x12, hashlib.sha256(block_hash).digest())
    bid = _field(0x0A, block_hash) + _field(0x12, psh)
    ts = b"\x08" + _varint(secs) + b"\x10" + _varint(nanos)
    body = (b"\x08\x02" + b"\x11" + height.to_bytes(8, "little")
            + b"\x19" + (0).to_bytes(8, "little") + _field(0x22, bid)
            + _field(0x2A, ts) + _field(0x32, CHAIN_ID.encode()))
    return _varint(len(body)) + body


def commit_msgs(n: int, seed: int) -> list[bytes]:
    """The sign-bytes of n validators' precommits for block `seed`; nanos
    >= 2^28 keep the timestamp varint, and so the row, one length."""
    block_hash = hashlib.sha256(b"block-%d" % seed).digest()
    return [vote_sign_bytes(1_000_000 + seed, block_hash, 1_700_000_000,
                            (1 << 28) + 1_000 * i) for i in range(n)]


def _stepped_points(n: int, rng):
    """Secret scalars a_i = a0 + i and nonces r_i = r0 + i with their
    points stepped by adding B — two point additions per validator instead
    of two scalar multiplications."""
    from cometbft_tpu_torch.crypto import ed25519_math as O

    a0 = int.from_bytes(rng.bytes(32), "little") % O.L
    r0 = int.from_bytes(rng.bytes(32), "little") % O.L
    A = O.scalar_mult(a0, O.B_POINT)
    R = O.scalar_mult(r0, O.B_POINT)
    for i in range(n):
        if i:
            A = O.point_add(A, O.B_POINT)
            R = O.point_add(R, O.B_POINT)
        yield a0 + i, r0 + i, A, R


def make_commit(n: int, seed: int, msgs: list[bytes] | None = None):
    """n distinct validators signing one block: pubs, msgs, sigs —
    s_i = r_i + k_i * a_i mod L, valid Ed25519 signatures."""
    from cometbft_tpu_torch.crypto import ed25519_math as O

    msgs = commit_msgs(n, seed) if msgs is None else msgs
    pubs, sigs = [], []
    for i, (a, r, A, R) in enumerate(_stepped_points(n, np.random.default_rng(seed))):
        pub, renc = O.point_compress(A), O.point_compress(R)
        k = O.sha512_mod_l(renc, pub, msgs[i])
        pubs.append(pub)
        sigs.append(renc + ((r + k * a) % O.L).to_bytes(32, "little"))
    return pubs, list(msgs), sigs


def make_commit_sr(n: int, seed: int, msgs: list[bytes] | None = None):
    """n distinct sr25519 validators signing one block: pub_i =
    ristretto_encode(A_i), k_i from the batch Merlin transcript over the
    sign-bytes, s_i = r_i + k_i * a_i mod L with the schnorrkel marker
    (bit 255) set — valid schnorrkel signatures."""
    from cometbft_tpu_torch.crypto import sr25519_math as srm

    msgs = commit_msgs(n, seed) if msgs is None else msgs
    pubs, rencs, scalars = [], [], []
    for a, r, A, R in _stepped_points(n, np.random.default_rng(seed)):
        pubs.append(srm.ristretto_encode(A))
        rencs.append(srm.ristretto_encode(R))
        scalars.append((a, r))
    k_words = srm.batch_challenge_words(pubs, rencs, msgs)
    sigs = []
    for i, (a, r) in enumerate(scalars):
        k = int.from_bytes(k_words[i].tobytes(), "little")
        s = bytearray(((r + k * a) % srm.L).to_bytes(32, "little"))
        s[31] |= 0x80
        sigs.append(rencs[i] + bytes(s))
    return pubs, list(msgs), sigs


def tamper(pubs, msgs, sigs, idx: list[int]) -> None:
    """Make lanes idx invalid, cycling through a flipped s bit, a changed
    message byte and a flipped R bit."""
    for j, i in enumerate(idx):
        kind = j % 3
        if kind == 0:
            s = bytearray(sigs[i])
            s[33] ^= 0x01
            sigs[i] = bytes(s)
        elif kind == 1:
            m = bytearray(msgs[i])
            m[-1] ^= 0x01
            msgs[i] = bytes(m)
        else:
            s = bytearray(sigs[i])
            s[5] ^= 0x10
            sigs[i] = bytes(s)


def edge_lanes(pubs, msgs, sigs):
    """Overwrite lanes 0..7 with the edge cases of ZIP-215; returns the
    oracle's verdict for each."""
    from cometbft_tpu_torch.crypto import ed25519_math as O

    ident = (1).to_bytes(32, "little")
    noncanon_ident = (O.P + 1).to_bytes(32, "little")  # y = p + 1 = 1 mod p
    order2 = (O.P - 1).to_bytes(32, "little")  # (0, -1), small order
    no_sqrt = (2).to_bytes(32, "little")  # y = 2 has no x on the curve
    zero_s = bytes(32)
    cases = [
        # tampered signature
        (pubs[0], msgs[0], sigs[0][:40] + bytes([sigs[0][40] ^ 4]) + sigs[0][41:]),
        # signature over another message
        (pubs[1], msgs[1] + b"!", sigs[1]),
        # s >= L (rejected before the device)
        (pubs[2], msgs[2], sigs[2][:32] + (O.L + 5).to_bytes(32, "little")),
        # non-canonical y for R and A: ZIP-215 accepts
        (noncanon_ident, msgs[3], noncanon_ident + zero_s),
        # small-order pubkey (the identity) with R = identity, s = 0: valid
        (ident, msgs[4], ident + zero_s),
        # small-order pubkey of order 2 under an honest signature: invalid
        (order2, msgs[5], sigs[5]),
        # R fails decompression
        (pubs[6], msgs[6], no_sqrt + sigs[6][32:]),
        # pubkey fails decompression
        (no_sqrt, msgs[7], sigs[7]),
    ]
    for i, (p, m, s) in enumerate(cases):
        pubs[i], msgs[i], sigs[i] = p, m, s
    return [O.verify_zip215(p, m, s) for p, m, s in cases]


def edge_lanes_sr(pubs, msgs, sigs):
    """Overwrite lanes 0..7 with the edge cases of schnorrkel over
    ristretto255; returns the serial oracle's verdict for each."""
    from cometbft_tpu_torch.crypto import sr25519_math as srm

    def with_byte(b: bytes, i: int, v: int) -> bytes:
        out = bytearray(b)
        out[i] = v
        return bytes(out)

    no_sqrt = 2  # the smallest even canonical encoding that does not decode
    while srm.ristretto_decode(no_sqrt.to_bytes(32, "little")) is not None:
        no_sqrt += 2
    s_big = (srm.L + 5).to_bytes(32, "little")
    cases = [
        # tampered s
        (pubs[0], msgs[0], with_byte(sigs[0], 40, sigs[0][40] ^ 4)),
        # signature over another message
        (pubs[1], msgs[1] + b"!", sigs[1]),
        # s >= L (rejected before the device)
        (pubs[2], msgs[2], sigs[2][:32] + with_byte(s_big, 31, s_big[31] | 0x80)),
        # the schnorrkel marker bit cleared (rejected before the device)
        (pubs[3], msgs[3], with_byte(sigs[3], 63, sigs[3][63] & 0x7F)),
        # R not canonical: s = p + 1 >= p
        (pubs[4], msgs[4], (srm.P + 1).to_bytes(32, "little") + sigs[4][32:]),
        # R odd (negative)
        (pubs[5], msgs[5], (3).to_bytes(32, "little") + sigs[5][32:]),
        # R with bit 255 set
        (pubs[6], msgs[6], with_byte(sigs[6], 31, sigs[6][31] | 0x80)),
        # pubkey does not decode (no square root)
        (no_sqrt.to_bytes(32, "little"), msgs[7], sigs[7]),
    ]
    for i, (p, m, s) in enumerate(cases):
        pubs[i], msgs[i], sigs[i] = p, m, s
    return [srm.verify(p, m, s) for p, m, s in cases]


# ------------------------------------------------------------------ schemes


class Path(NamedTuple):
    """One scheme as the smoke run drives it."""

    scheme: object  # ops.ed25519_kernel.Scheme
    pub_key: Callable  # bytes -> crypto.PubKey
    make_commit: Callable
    edge_lanes: Callable
    verify: Callable  # kernel wrapper
    verify_plain: Callable
    decompress: Callable  # kernel wrapper
    decompress_plain: Callable


def _paths() -> dict[str, Path]:
    from cometbft_tpu_torch.crypto import ed25519, sr25519
    from cometbft_tpu_torch.ops import ed25519_kernel as K
    from cometbft_tpu_torch.ops import sr25519_kernel as SK
    from cometbft_tpu_torch.ops import verify_kernel as VK

    return {
        "ed25519": Path(K.ED25519, ed25519.PubKey, make_commit, edge_lanes,
                        VK.verify_ok, VK.verify_math_ok, VK.decompress,
                        VK.decompress_math),
        "sr25519": Path(SK.SR25519, sr25519.PubKey, make_commit_sr, edge_lanes_sr,
                        VK.verify_sr_ok, VK.verify_math_sr_ok, VK.decompress_sr,
                        VK.decompress_sr_math),
    }


def staged(path: Path, pubs, msgs, sigs, device):
    """The kernel inputs of one batch, as the verify path stages them."""
    from cometbft_tpu_torch.ops import ed25519_kernel as K

    n = len(sigs)
    b = K.bucket_size(n)
    pre_ok, safe, r, s, k = path.scheme.stage(pubs, msgs, sigs, b)
    enc = np.frombuffer(b"".join(safe), dtype=np.uint8).reshape(n, 32)
    ok_a, coords = K.decompress_points(enc, device, path.scheme)
    return K.staged_from_numpy(*K.pad_coords_batch_minor(coords, b), r, s, k,
                               device=device)


# ------------------------------------------------------------------ timing


def time_kernel(fn, reps: int = 20) -> float:
    """Median ms of `reps` launches, each timed with CUDA events."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_wall(fn, reps: int, device: torch.device) -> float:
    """Median ms of `reps` calls on the host clock, synchronised."""
    times = []
    for _ in range(reps):
        _sync(device)
        t0 = time.perf_counter()
        fn()
        _sync(device)
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _max_err(got, want) -> int:
    return max(int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
               for a, b in zip(got, want))


# ------------------------------------------------------------------ phases


def check_kernels(name: str, path: Path, n: int, device) -> dict[str, int]:
    """A scheme's verify and decode kernels against their plain versions on
    one batch of n lanes with the edge cases in lanes 0..7 and tampered
    lanes beyond; then the verify path's final mask against the oracle on
    a sample. Returns each kernel's largest |kernel - plain| (0 when
    equal)."""
    from cometbft_tpu_torch.ops import ed25519_kernel as K

    b = K.bucket_size(n)
    pubs, msgs, sigs = path.make_commit(n, SEED_CHECK + n)
    want_edge = path.edge_lanes(pubs, msgs, sigs)
    tampered = [n // 2, n - 1, n // 3]
    tamper(pubs, msgs, sigs, tampered)
    t = staged(path, pubs, msgs, sigs, device)
    kernel = path.verify(*t), path.decompress(t[4])
    plain = path.verify_plain(*t), path.decompress_plain(t[4])
    _sync(device)
    err = {f"{name}_verify": _max_err(kernel[0], plain[0]),
           f"{name}_decompress": _max_err(kernel[1], plain[1])}
    if any(err.values()):
        raise AssertionError(f"{name} {n} lanes: kernel and plain version differ {err}")
    got, flips = K.verify_rows(path.scheme, pubs, msgs, sigs,
                               cache=K.PubKeyCache(device, path.scheme))
    if flips:
        raise AssertionError(f"{name} {n} lanes: host recheck flipped {flips} lanes")
    sample = list(range(8)) + tampered + [8, 9, n // 4, n - 2]
    for i in sample:
        want = path.scheme.verify_one(pubs[i], msgs[i], sigs[i])
        if bool(got[i]) != want:
            raise AssertionError(f"{name} {n} lanes: lane {i} is {bool(got[i])}, oracle {want}")
    if [bool(got[i]) for i in range(8)] != want_edge:
        raise AssertionError(f"{name}: edge lanes disagree with the oracle")
    print(f"check {name} {n} signatures at {b} lanes: kernel == plain bit for bit "
          f"(mask, all-ok, decode ok/X/Y/Z/T); mask == oracle on {len(sample)} sampled "
          f"lanes; edge lanes {want_edge}; invalid lanes {np.flatnonzero(~got).tolist()}",
          flush=True)
    return err


def drive(label: str, make_verifier, keys, msgs, sigs, bad: list[int], device,
          verify_entries: list[str], decompress_entries: list[str]) -> dict:
    """One main path: make_verifier() -> add -> verify, cold (empty key
    cache) then 5 warm runs, every count set to 0 just before and read
    just after. The mask must equal the expected one (lanes `bad`
    invalid, which the serial oracle confirms on a sample), with 0
    recheck flips; each warm verify() launches each verify kernel once and
    no decode kernel. Returns wall times, the
    launches of the whole run and the lanes of one warm verify()."""
    from cometbft_tpu_torch.ops import verify_kernel as VK

    n = len(sigs)
    expected = [i not in bad for i in range(n)]

    def run():
        v = make_verifier()
        for key, m, s in zip(keys, msgs, sigs):
            v.add(key, m, s)
        ok, mask = v.verify()
        if mask != expected or ok != (not bad):
            wrong = [i for i in range(n) if mask[i] != expected[i]]
            raise AssertionError(f"{label}: ok {ok}, wrong lanes {wrong[:20]}")
        if v.recheck_flips:
            raise AssertionError(f"{label}: {v.recheck_flips} recheck flips")

    sample = sorted(set(bad[:3]) | {0, 1, n // 2, n - 3})
    for i in sample:
        if keys[i].verify_signature(msgs[i], sigs[i]) != expected[i]:
            raise AssertionError(f"{label}: the serial oracle disagrees on lane {i}")

    VK.reset_launches()
    cold_ms = time_wall(run, 1, device)
    cold = dict(VK.LAUNCHES)
    cold_lanes = dict(VK.LANES)
    warm_ms = time_wall(run, 5, device)
    launches = dict(VK.LAUNCHES)
    warm_lanes = {e: (VK.LANES[e] - cold_lanes[e]) // 5 for e in verify_entries}
    for e in verify_entries:
        if cold[e] != 1 or launches[e] != 6:
            raise AssertionError(f"{label}: {e} launched {cold[e]} cold, {launches[e]} in all")
    for e in decompress_entries:
        if cold[e] < 1:
            raise AssertionError(f"{label}: cold verify launched no {e}")
        if launches[e] != cold[e]:
            raise AssertionError(f"{label}: warm verify decompressed again {launches}")
    print(f"main path {label}: {n} validators, invalid lanes {bad} found exactly "
          f"(serial oracle agrees on lanes {sample}), 0 recheck flips; launches "
          f"cold {cold}, after 5 warm {launches}; lanes per warm verify() "
          f"{warm_lanes}", flush=True)
    return {"n": n, "cold_ms": cold_ms, "warm_ms": warm_ms, "launches": launches,
            "warm_lanes": warm_lanes}


def drive_commit(path: Path, n: int, seed: int, device, label: str,
                 tampered: bool = True) -> dict:
    """The main path of one scheme on one commit, through
    create_batch_verifier. With `tampered` a few lanes at known indices are
    made invalid, else every lane must verify and ok be True."""
    from cometbft_tpu_torch.crypto import batch as crypto_batch

    pubs, msgs, sigs = path.make_commit(n, seed)
    bad = sorted({3, n // 7, n // 3, n // 2, n - 1, (2 * n) // 3, n - 40, 11}
                 if n > 64 else {3, 11}) if tampered else []
    tamper(pubs, msgs, sigs, bad)
    keys = [path.pub_key(p) for p in pubs]
    name = path.scheme.name
    return drive(label, lambda: crypto_batch.create_batch_verifier(keys[0]), keys,
                 msgs, sigs, bad, device, [f"{name}_verify"], [f"{name}_decompress"])


def drive_mixed(paths: dict[str, Path], n: int, seed: int, device) -> dict:
    """BASELINE config 5: a mega-commit of n validators, even indices
    ed25519 and odd indices sr25519, all signing one block, through
    create_mixed_batch_verifier; tampered lanes in both schemes."""
    from cometbft_tpu_torch.crypto import batch as crypto_batch

    msgs = commit_msgs(n, seed)
    ed = paths["ed25519"].make_commit(n // 2, seed, msgs[0::2])
    sr = paths["sr25519"].make_commit(n // 2, seed + 1, msgs[1::2])
    pubs, sigs, keys = [None] * n, [None] * n, [None] * n
    for j, (half, path) in enumerate(((ed, paths["ed25519"]), (sr, paths["sr25519"]))):
        pubs[j::2], sigs[j::2] = half[0], half[2]
        keys[j::2] = [path.pub_key(p) for p in half[0]]
    bad = sorted({3, 10, 11, n // 3, n // 2 + 1, (2 * n) // 5, n - 2, n - 1})
    tamper(pubs, msgs, sigs, bad)
    if {i % 2 for i in bad} != {0, 1}:
        raise AssertionError("the mixed commit must tamper lanes of both schemes")
    return drive(f"mixed {n}", crypto_batch.create_mixed_batch_verifier, keys, msgs,
                 sigs, bad, device, ["ed25519_verify", "sr25519_verify"],
                 ["ed25519_decompress", "sr25519_decompress"])


def time_scheme(name: str, path: Path, lanes: tuple[int, ...], device, card: str,
                sq_mul_verify: tuple[int, int], sq_mul_decode: tuple[int, int]
                ) -> tuple[dict, dict]:
    """Kernel and plain times and bounds of a scheme at each lane count, on
    an untampered batch, where all-ok must be set by kernel and plain
    alike. Returns (times, bounds) keyed by lane count."""
    times, bounds = {}, {}
    for n in lanes:
        bounds[n] = {
            "verify": bound(_imads32(*sq_mul_verify), VERIFY_BYTES, n),
            "decompress": bound(_imads32(*sq_mul_decode), DECOMP_BYTES, n),
            "verify_13bit": bound(_imads(*sq_mul_verify), VERIFY_BYTES, n),
            "decompress_13bit": bound(_imads(*sq_mul_decode), DECOMP_BYTES, n),
        }
        pubs, msgs, sigs = path.make_commit(n, SEED_CHECK)
        t = staged(path, pubs, msgs, sigs, device)
        mask, allok = path.verify(*t)
        mask_p, allok_p = path.verify_plain(*t)
        if not (torch.equal(mask, mask_p) and bool(mask.all()) and bool(allok)
                and bool(allok_p)):
            raise AssertionError(f"{name} {n} valid lanes: mask all {bool(mask.all())}, "
                                 f"all-ok {bool(allok)}, plain {bool(allok_p)}")
        times[n] = {
            "verify": time_kernel(lambda: path.verify(*t)),
            "verify_plain": time_wall(lambda: path.verify_plain(*t), 3, device),
            "decompress": time_kernel(lambda: path.decompress(t[4])),
            "decompress_plain": time_wall(lambda: path.decompress_plain(t[4]), 3, device),
        }
        print(f"[{card}] {name} {n} lanes: verify kernel {times[n]['verify']:.4f} ms "
              f"(median of 20), plain {times[n]['verify_plain']:.3f} ms; "
              f"decompress kernel {times[n]['decompress']:.4f} ms, plain "
              f"{times[n]['decompress_plain']:.3f} ms; bounds (32-bit limbs) verify "
              f"{bounds[n]['verify'][0]:.4f} ms ({bounds[n]['verify'][1]}), "
              f"decompress {bounds[n]['decompress'][0]:.4f} ms "
              f"({bounds[n]['decompress'][1]}); in the kernel's radix-2^13 limbs "
              f"{bounds[n]['verify_13bit'][0]:.4f} and "
              f"{bounds[n]['decompress_13bit'][0]:.4f} ms; all-ok set by kernel and plain",
              flush=True)
    return times, bounds


def time_host_stages(name: str, path: Path, device, card: str) -> None:
    """The two host stages of a warm verify() of a 10,240-lane commit with
    8 rejected lanes: staging (challenges), and the oracle recheck."""
    from cometbft_tpu_torch.ops import ed25519_kernel as K

    pubs, msgs, sigs = path.make_commit(N_BIG, SEED_CHECK)
    bad = list(range(1, N_BIG, N_BIG // 8))
    tamper(pubs, msgs, sigs, bad)
    stage_ms = time_wall(lambda: path.scheme.stage(pubs, msgs, sigs, N_BIG), 3, device)
    mask = np.ones(N_BIG, dtype=bool)
    mask[bad] = False
    eligible = np.ones(N_BIG, dtype=bool)
    recheck_ms = time_wall(lambda: K.recheck_failed_lanes(
        mask.copy(), eligible, pubs, msgs, sigs, path.scheme.verify_one), 3, device)
    print(f"[{card}] {name} host stages at 10,240 lanes: staging (challenges) "
          f"{stage_ms:.3f} ms, oracle recheck of {len(bad)} rejected lanes "
          f"{recheck_ms:.3f} ms (medians of 3)", flush=True)


def _record(name: str, replaces: str, launches: int, err: int, times: dict,
            bounds: dict, key: str) -> dict:
    b_ms, b_by = bounds[N_BIG][key]
    return {"name": name, "route": "cuda",
            "source": "cometbft_tpu_torch/csrc/ed25519_verify.cu",
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": times[N_BIG][key], "plain_ms": times[N_BIG][f"{key}_plain"],
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from cometbft_tpu_torch.crypto import batch as crypto_batch
    from cometbft_tpu_torch.ops import _build

    device = torch.device("cuda")
    card = _smi()
    print(card, flush=True)
    t0 = time.perf_counter()
    _, report, nvcc_s = _build.build("ed25519_verify")
    print(f"kernel build: {time.perf_counter() - t0:.3f} s "
          f"(nvcc {nvcc_s:.3f} s)", flush=True)
    for kernel, lines in ptxas_summary(report).items():
        print(f"  ptxas {kernel}: {'; '.join(lines)}", flush=True)
    paths = _paths()
    ed, sr = paths["ed25519"], paths["sr25519"]

    # every lane count the main paths launch at, for both schemes: 128, 256
    # (the 150 commit's bucket, padding lanes included; ed25519), 6,144 (the
    # mixed commit's per-scheme bucket of 5,120 signatures) and 10,240
    checks = [check_kernels("ed25519", ed, n, device)
              for n in (128, N_SMALL, 5_120, N_BIG)]
    checks += [check_kernels("sr25519", sr, n, device) for n in (128, 5_120, N_BIG)]
    err = {k: max(c.get(k, 0) for c in checks) for c in checks for k in c}

    crypto_batch.set_backend("gpu")
    big = drive_commit(ed, N_BIG, SEED_BIG, device, "10k")
    small = drive_commit(ed, N_SMALL, SEED_SMALL, device, "150")
    drive_commit(ed, N_SMALL, SEED_SMALL + 1, device, "150 all valid", tampered=False)
    big_sr = drive_commit(sr, N_BIG, SEED_SR, device, "sr25519 10k")
    mixed = drive_mixed(paths, N_BIG, SEED_MIXED, device)
    lanes = mixed["warm_lanes"]
    if lanes != {"ed25519_verify": N_MIXED_BUCKET, "sr25519_verify": N_MIXED_BUCKET}:
        raise AssertionError(f"mixed 10k: lanes per warm verify() {lanes}")

    # kernel, plain and end-to-end times, beside each kernel's bound
    print(f"IMADs per lane, radix-2^13 limbs (the kernel's): ed25519 verify "
          f"{_imads(SQ_VERIFY, MUL_VERIFY)}, decompress {_imads(SQ_DECOMP, MUL_DECOMP)}; "
          f"sr25519 verify {_imads(SQ_VERIFY_SR, MUL_VERIFY_SR)}, decode "
          f"{_imads(SQ_DECODE_SR, MUL_DECODE_SR)}; 32-bit limbs: ed25519 verify "
          f"{_imads32(SQ_VERIFY, MUL_VERIFY)}, decompress "
          f"{_imads32(SQ_DECOMP, MUL_DECOMP)}; sr25519 verify "
          f"{_imads32(SQ_VERIFY_SR, MUL_VERIFY_SR)}, decode "
          f"{_imads32(SQ_DECODE_SR, MUL_DECODE_SR)}", flush=True)
    times, bounds = time_scheme("ed25519", ed, (N_BIG, 256), device, card,
                                (SQ_VERIFY, MUL_VERIFY), (SQ_DECOMP, MUL_DECOMP))
    times_sr, bounds_sr = time_scheme("sr25519", sr, (N_BIG, N_MIXED_BUCKET), device, card,
                                      (SQ_VERIFY_SR, MUL_VERIFY_SR),
                                      (SQ_DECODE_SR, MUL_DECODE_SR))
    for label, r in (("ed25519", big), ("ed25519", small), ("sr25519", big_sr),
                     ("mixed ed25519 + sr25519", mixed)):
        print(f"[{card}] verify() {label} {r['n']} validators: cold {r['cold_ms']:.3f} ms "
              f"(decode + upload included), warm {r['warm_ms']:.3f} ms "
              f"(median of 5, key cache hit) = "
              f"{r['n'] / r['warm_ms'] * 1e3:.0f} signatures/s", flush=True)
    time_host_stages("ed25519", ed, device, card)
    time_host_stages("sr25519", sr, device, card)

    kernels = {"kernels": [
        _record("ed25519_verify", "cometbft_tpu/ops/pallas_verify.py:198",
                big["launches"]["ed25519_verify"], err["ed25519_verify"],
                times, bounds, "verify"),
        _record("ed25519_decompress", "cometbft_tpu/ops/ed25519_kernel.py:97",
                big["launches"]["ed25519_decompress"], err["ed25519_decompress"],
                times, bounds, "decompress"),
        _record("sr25519_verify", "cometbft_tpu/ops/pallas_verify.py:198",
                big_sr["launches"]["sr25519_verify"], err["sr25519_verify"],
                times_sr, bounds_sr, "verify"),
        _record("sr25519_decompress", "cometbft_tpu/ops/sr25519_kernel.py:102",
                big_sr["launches"]["sr25519_decompress"], err["sr25519_decompress"],
                times_sr, bounds_sr, "decompress"),
    ]}
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
