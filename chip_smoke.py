"""On-card smoke run of the PyTorch/CUDA port (cometbft_tpu_torch).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds the port's CUDA kernels from csrc/, holds each kernel against its
plain PyTorch version on the card (bit for bit: all arithmetic is integer),
drives the main path — crypto.batch.create_batch_verifier -> add -> verify
on a 10,240-validator commit and on a 150-validator commit, with tampered
lanes at known indices — checks the masks, the launch counters and the
host-oracle recheck, times the kernels, their plain versions and verify()
end to end, and prints one JSON line of kernel records and, last, the
device record. Any mismatch raises; without a card it exits non-zero
before printing a result.
"""

from __future__ import annotations

import hashlib
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# Seeds of the synthetic validator sets (keys and nonces are random
# scalars derived from them).
SEED_BIG, SEED_SMALL, SEED_CHECK = 20240, 150, 7
N_BIG, N_SMALL = 10_240, 150
CHAIN_ID = "cosmoshub-4"

# int32 multiply-add peak of one H100 SXM: 132 SMs x 64 IMAD results per
# clock per SM (CUDA C++ Programming Guide, arithmetic instruction
# throughput, compute capability 9.0) x 1.98 GHz boost clock (NVIDIA H100
# SXM5 data sheet).
IMAD_PER_S = 132 * 64 * 1.98e9
HBM_BYTES_PER_S = 3.35e12

# Field multiplications per lane, counted from csrc/ed25519_verify.cu:
#   R decompression: 255 squarings + 19 multiplies (+1 where v*x^2 != u,
#     left out: the bound counts the least work);
#   -A table: 8 doublings (4 sq + 4 mul), 7 adds (9 mul), 17 T premuls;
#   ladder: 51 windows x (5 doublings = 20 sq + 16 mul, madd 7 mul, add 7
#     mul; the last add 8);
#   tail: one add (9 mul) and 3 doublings (12 sq + 12 mul).
# A multiply is 400 limb products, a square 210; each also folds 20 high
# limbs by a multiply (FOLD * hi).
SQ_DECOMP, MUL_DECOMP = 255, 19
SQ_VERIFY = SQ_DECOMP + 8 * 4 + 51 * 20 + 12
MUL_VERIFY = MUL_DECOMP + (8 * 4 + 7 * 9 + 17) + (51 * 30 + 1) + (9 + 12)


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
    input read once, each output written once) over HBM, the larger."""
    ops = imad_per_lane * lanes / IMAD_PER_S * 1e3
    mem = bytes_per_lane * lanes / HBM_BYTES_PER_S * 1e3
    return (ops, "operations") if ops >= mem else (mem, "bytes")


def _smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


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


def make_commit(n: int, seed: int):
    """n distinct validators signing one block: pubs, msgs, sigs. Keys and
    nonces step by the base point (a_i = a0 + i, r_i = r0 + i), so each
    costs two point additions instead of two scalar multiplications;
    s_i = r_i + k_i * a_i mod L — valid Ed25519 signatures."""
    from cometbft_tpu_torch.crypto import ed25519_math as O

    rng = np.random.default_rng(seed)
    a0 = int.from_bytes(rng.bytes(32), "little") % O.L
    r0 = int.from_bytes(rng.bytes(32), "little") % O.L
    block_hash = hashlib.sha256(b"block-%d" % seed).digest()
    A = O.scalar_mult(a0, O.B_POINT)
    R = O.scalar_mult(r0, O.B_POINT)
    pubs, msgs, sigs = [], [], []
    for i in range(n):
        if i:
            A = O.point_add(A, O.B_POINT)
            R = O.point_add(R, O.B_POINT)
        pub, renc = O.point_compress(A), O.point_compress(R)
        # nanos >= 2^28 keep the timestamp varint, and so the row, one length
        msg = vote_sign_bytes(1_000_000 + seed, block_hash, 1_700_000_000,
                              (1 << 28) + 1_000 * i)
        k = O.sha512_mod_l(renc, pub, msg)
        s = (r0 + i + k * (a0 + i)) % O.L
        pubs.append(pub)
        msgs.append(msg)
        sigs.append(renc + s.to_bytes(32, "little"))
    return pubs, msgs, sigs


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


def staged(pubs, msgs, sigs, device):
    """The kernel inputs of one batch, as the verify path stages them."""
    from cometbft_tpu_torch.ops import ed25519_kernel as K

    n = len(sigs)
    b = K.bucket_size(n)
    pre_ok, safe, r, s, k = K.stage_batch(pubs, msgs, sigs, b)
    enc = np.frombuffer(b"".join(safe), dtype=np.uint8).reshape(n, 32)
    ok_a, coords = K.decompress_points(enc, device)
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


# ------------------------------------------------------------------ phases


def check_kernels(n: int, device) -> dict[str, int]:
    """K1 and decompress against their plain versions on one batch of n
    lanes with the edge cases in lanes 0..7 and tampered lanes beyond;
    then the verify path's final mask against the oracle on a sample.
    Returns each kernel's largest |kernel - plain| (0 when equal)."""
    from cometbft_tpu_torch.crypto import ed25519_math as O
    from cometbft_tpu_torch.ops import ed25519_kernel as K
    from cometbft_tpu_torch.ops import verify_kernel as VK

    b = K.bucket_size(n)
    pubs, msgs, sigs = make_commit(n, SEED_CHECK + n)
    want_edge = edge_lanes(pubs, msgs, sigs)
    tampered = [n // 2, n - 1, n // 3]
    tamper(pubs, msgs, sigs, tampered)
    t = staged(pubs, msgs, sigs, device)
    mask, allok = VK.verify_ok(*t)
    mask_p, allok_p = VK.verify_math_ok(*t)
    words = t[4]
    dec = VK.decompress(words)
    dec_p = VK.decompress_math(words)
    _sync(device)

    def max_err(got, want) -> int:
        return max(int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
                   for a, b in zip(got, want))

    err = {"ed25519_verify": max_err((mask, allok), (mask_p, allok_p)),
           "ed25519_decompress": max_err(dec, dec_p)}
    if any(err.values()):
        raise AssertionError(f"{n} lanes: kernel and plain version differ {err}")
    got, flips = K.verify_mask(pubs, msgs, sigs, cache=K.PubKeyCache(device),
                               device=device)
    if flips:
        raise AssertionError(f"{n} lanes: host recheck flipped {flips} lanes")
    sample = list(range(8)) + tampered + [8, 9, n // 4, n - 2]
    for i in sample:
        want = O.verify_zip215(pubs[i], msgs[i], sigs[i])
        if bool(got[i]) != want:
            raise AssertionError(f"{n} lanes: lane {i} is {bool(got[i])}, oracle {want}")
    if [bool(got[i]) for i in range(8)] != want_edge:
        raise AssertionError("edge lanes disagree with the oracle")
    print(f"check {n} signatures at {b} lanes: kernel == plain bit for bit "
          f"(mask, all-ok, decompress ok/X/Y/Z/T); mask == oracle on {len(sample)} sampled "
          f"lanes; invalid lanes {np.flatnonzero(~got).tolist()}", flush=True)
    return err


def drive_commit(n: int, seed: int, device, label: str,
                 tampered: bool = True) -> dict:
    """The main path on one commit: create_batch_verifier -> add -> verify,
    cold (empty key cache) then warm. With `tampered` a few lanes at known
    indices are made invalid, else every lane must verify and ok be True.
    Returns wall times and launches."""
    from cometbft_tpu_torch.crypto import batch as crypto_batch
    from cometbft_tpu_torch.crypto import ed25519
    from cometbft_tpu_torch.ops import verify_kernel as VK

    pubs, msgs, sigs = make_commit(n, seed)
    bad = sorted({3, n // 7, n // 3, n // 2, n - 1, (2 * n) // 3, n - 40, 11}
                 if n > 64 else {3, 11}) if tampered else []
    tamper(pubs, msgs, sigs, bad)
    expected = [i not in bad for i in range(n)]
    keys = [ed25519.PubKey(p) for p in pubs]

    def run():
        v = crypto_batch.create_batch_verifier(keys[0])
        for key, m, s in zip(keys, msgs, sigs):
            v.add(key, m, s)
        ok, mask = v.verify()
        if mask != expected or ok != (not bad):
            wrong = [i for i in range(n) if mask[i] != expected[i]]
            raise AssertionError(f"{label}: ok {ok}, wrong lanes {wrong[:20]}")
        if v.recheck_flips:
            raise AssertionError(f"{label}: {v.recheck_flips} recheck flips")

    VK.reset_launches()
    cold_ms = time_wall(run, 1, device)
    cold = dict(VK.LAUNCHES)
    warm_ms = time_wall(run, 5, device)
    launches = dict(VK.LAUNCHES)
    if cold["ed25519_verify"] < 1 or cold["ed25519_decompress"] < 1:
        raise AssertionError(f"{label}: cold verify launched {cold}")
    if launches["ed25519_decompress"] != cold["ed25519_decompress"]:
        raise AssertionError(f"{label}: warm verify decompressed again {launches}")
    print(f"main path {label}: {n} validators, invalid lanes {bad} found "
          f"exactly, 0 recheck flips; launches cold {cold}, after 5 warm "
          f"{launches}", flush=True)
    return {"n": n, "cold_ms": cold_ms, "warm_ms": warm_ms, "launches": launches}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from cometbft_tpu_torch.crypto import batch as crypto_batch
    from cometbft_tpu_torch.ops import _build
    from cometbft_tpu_torch.ops import ed25519_kernel as K
    from cometbft_tpu_torch.ops import verify_kernel as VK

    device = torch.device("cuda")
    card = _smi()
    print(card, flush=True)
    t0 = time.perf_counter()
    _, report, nvcc_s = _build.build("ed25519_verify")
    print(f"kernel build: {time.perf_counter() - t0:.3f} s "
          f"(nvcc {nvcc_s:.3f} s)", flush=True)
    for line in report.splitlines():
        if "registers" in line or "spill" in line or "entry function" in line:
            print(f"  ed25519_verify: {line.strip()}", flush=True)

    # every lane count the main path launches at: 128, 256 (the 150
    # commit's bucket, padding lanes included) and 10,240
    checks = [check_kernels(n, device) for n in (128, N_SMALL, N_BIG)]
    err = {k: max(c[k] for c in checks) for k in checks[0]}

    crypto_batch.set_backend("gpu")
    big = drive_commit(N_BIG, SEED_BIG, device, "10k")
    small = drive_commit(N_SMALL, SEED_SMALL, device, "150")
    drive_commit(N_SMALL, SEED_SMALL + 1, device, "150 all valid", tampered=False)

    # kernel, plain and end-to-end times, beside each kernel's bound
    print(f"IMADs per lane, radix-2^13 limbs (the kernel's): verify "
          f"{_imads(SQ_VERIFY, MUL_VERIFY)}, decompress "
          f"{_imads(SQ_DECOMP, MUL_DECOMP)}; 32-bit limbs: verify "
          f"{_imads32(SQ_VERIFY, MUL_VERIFY)}, decompress "
          f"{_imads32(SQ_DECOMP, MUL_DECOMP)}", flush=True)
    times, bounds = {}, {}
    for n in (N_BIG, 256):
        bounds[n] = {
            "verify": bound(_imads(SQ_VERIFY, MUL_VERIFY), 4 * 80 + 3 * 32 + 4, n),
            "decompress": bound(_imads(SQ_DECOMP, MUL_DECOMP), 32 + 4 + 4 * 80, n),
            "verify_32bit": bound(_imads32(SQ_VERIFY, MUL_VERIFY), 4 * 80 + 3 * 32 + 4, n),
        }
        # an untampered batch: all-ok must be set, by kernel and plain alike
        pubs, msgs, sigs = make_commit(n, SEED_CHECK)
        t = staged(pubs, msgs, sigs, device)
        mask, allok = VK.verify_ok(*t)
        mask_p, allok_p = VK.verify_math_ok(*t)
        if not (torch.equal(mask, mask_p) and bool(mask.all()) and bool(allok)
                and bool(allok_p)):
            raise AssertionError(f"{n} valid lanes: mask all {bool(mask.all())}, "
                                 f"all-ok {bool(allok)}, plain {bool(allok_p)}")
        times[n] = {
            "verify": time_kernel(lambda: VK.verify_ok(*t)),
            "verify_plain": time_wall(lambda: VK.verify_math_ok(*t), 3, device),
            "decompress": time_kernel(lambda: VK.decompress(t[4])),
            "decompress_plain": time_wall(lambda: VK.decompress_math(t[4]), 3, device),
        }
        print(f"[{card}] {n} lanes: verify kernel {times[n]['verify']:.4f} ms "
              f"(median of 20), plain {times[n]['verify_plain']:.3f} ms; "
              f"decompress kernel {times[n]['decompress']:.4f} ms, plain "
              f"{times[n]['decompress_plain']:.3f} ms; bounds verify "
              f"{bounds[n]['verify'][0]:.4f} ms ({bounds[n]['verify'][1]}; "
              f"{bounds[n]['verify_32bit'][0]:.4f} ms in 32-bit limbs), "
              f"decompress {bounds[n]['decompress'][0]:.4f} ms "
              f"({bounds[n]['decompress'][1]})", flush=True)
    for r in (big, small):
        print(f"[{card}] verify() {r['n']} validators: cold {r['cold_ms']:.3f} ms "
              f"(decompress + upload included), warm {r['warm_ms']:.3f} ms "
              f"(median of 5, key cache hit) = "
              f"{r['n'] / r['warm_ms'] * 1e3:.0f} signatures/s", flush=True)

    # the two host stages of a warm verify() of a 10,240-lane commit with 8
    # rejected lanes: SHA-512 staging, and the oracle recheck of those lanes
    pubs, msgs, sigs = make_commit(N_BIG, SEED_CHECK)
    bad = list(range(1, N_BIG, N_BIG // 8))
    tamper(pubs, msgs, sigs, bad)
    stage_ms = time_wall(lambda: K.stage_batch(pubs, msgs, sigs, N_BIG), 3, device)
    mask = np.ones(N_BIG, dtype=bool)
    mask[bad] = False
    eligible = np.ones(N_BIG, dtype=bool)
    recheck_ms = time_wall(lambda: K.recheck_failed_lanes(
        mask.copy(), eligible, pubs, msgs, sigs), 3, device)
    print(f"[{card}] host stages at 10,240 lanes: stage_batch {stage_ms:.3f} ms, "
          f"oracle recheck of {len(bad)} rejected lanes {recheck_ms:.3f} ms "
          f"(medians of 3)", flush=True)

    v_bound, v_by = bounds[N_BIG]["verify"]
    d_bound, d_by = bounds[N_BIG]["decompress"]
    kernels = {"kernels": [
        {"name": "ed25519_verify", "route": "cuda",
         "source": "cometbft_tpu_torch/csrc/ed25519_verify.cu",
         "replaces": "cometbft_tpu/ops/pallas_verify.py:198",
         "launches": big["launches"]["ed25519_verify"],
         "max_abs_err": err["ed25519_verify"],
         "ms": times[N_BIG]["verify"], "plain_ms": times[N_BIG]["verify_plain"],
         "bound_ms": v_bound, "bound_by": v_by, "library_ms": None},
        {"name": "ed25519_decompress", "route": "cuda",
         "source": "cometbft_tpu_torch/csrc/ed25519_verify.cu",
         "replaces": "cometbft_tpu/ops/ed25519_kernel.py:97",
         "launches": big["launches"]["ed25519_decompress"],
         "max_abs_err": err["ed25519_decompress"],
         "ms": times[N_BIG]["decompress"],
         "plain_ms": times[N_BIG]["decompress_plain"],
         "bound_ms": d_bound, "bound_by": d_by, "library_ms": None},
    ]}
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
