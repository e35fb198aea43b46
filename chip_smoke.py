"""On-card smoke run of the PyTorch/CUDA port (cometbft_tpu_torch).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds the port's CUDA kernels from csrc/ (one nvcc per source, all at
once), checks that ptxas gave the verify kernels, the pubkey decoders and
every body of the microbench's loop kernel no stack frame and no spills
and that their launches at the main paths' lane counts are one wave (the
CUDA occupancy calculator), holds each
kernel against its plain PyTorch version on the card on batches whose
first lanes are edge cases (ZIP-215 encodings, torsion components, y = p
and y = p + 1, a sr25519 lane whose check lands on a multiple of p) — the
verify kernels bit for bit, the decoders by ok bit for bit and X, Y, Z, T
by canonical value (their limbs are canonical, the plain version's
carried) — and drives the main paths through the entry points a node
calls:

  - ed25519: crypto.batch.create_batch_verifier -> add -> verify on a
    10,240-validator commit and on 150-validator commits;
  - sr25519: the same on a 10,240-validator commit;
  - mixed: crypto.batch.create_mixed_batch_verifier on a 10,240-validator
    mega-commit, ed25519 and sr25519 validators interleaved;

with tampered lanes at known indices. It checks the masks, the launch and
lane counters and the host-oracle recheck, times the kernels (the
decoders at 10,240, 6,144 and 256 keys), their plain versions,
verify() end to end and one cold verify() by part (decoder kernel, the
copy back, the key cache's host loops, the coordinates' upload). Then the
device microbench (ops/microbench.py): its loop kernel (K3) for every
registered probe body (the value bodies on the verify kernels' 32-bit field
and quad by canonical value, the radix-2^13 limb bodies bit for bit) and its
stacked-conv kernel (K4) against their plain versions, K3's records for
mul, sq, double, 5 doublings and the ladder window, the verify kernel's
bench instantiation against
verify_math_bench, the probes at 1/MB_SCALE of the JAX module's iteration
counts and the verify kernel's bisection at 10,240 and 256 lanes. It
prints one JSON line of kernel records and, last, the device record. Any
mismatch raises; without a card it exits non-zero before printing a
result.
"""

from __future__ import annotations

import concurrent.futures
import functools
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
SEED_EDGE = 8  # the torsion edge lanes' key and nonce
# A valid sr25519 lane (pub, msg, sig; validator 6131 of
# make_commit_sr(10240, 7)) whose [4](sB - kA - R) comes out as a multiple
# of p that compares as zero only after a full carry ripple
# (test_torch_field._ZERO_RUN): a reduction that stops short rejects it.
RIPPLE_LANE = (
    "62c461cdc2a9675e3ca1c2e4a92ae2129a1dcf5f1bd22d72f56fad2d0d8a912f",
    "7908021147420f000000000019000000000000000022480a20bf60053ae6caed9fc3eb"
    "b46abd5f29ff37265b7b080592ea930ed46072e8f4b31224080112205c9ed1b55f9adf"
    "8a254ccffefca160f214f9191acdf4f58e589fe2ffcf35a29b2a0c0880e2cfaa0610b8"
    "9af68201320b636f736d6f736875622d34",
    "46006c5f60de779241d7cd210567667e8f58831a636776bdb298f2fb3c6cdc375544b1"
    "c8c3d600512f015f60f26a9e0a2e05c0397eb7fb5c14e62767aeb05a85",
)
N_BIG, N_SMALL = 10_240, 150
N_MIXED_BUCKET = 6_144  # the mixed commit's per-scheme bucket (5,120 signatures)
CHAIN_ID = "cosmoshub-4"

# int32 multiply-add peak of one H100 SXM: 132 SMs x 64 IMAD results per
# clock per SM (CUDA C++ Programming Guide, arithmetic instruction
# throughput, compute capability 9.0) x 1.98 GHz boost clock (NVIDIA H100
# SXM5 data sheet).
IMAD_PER_S = 132 * 64 * 1.98e9
HBM_BYTES_PER_S = 3.35e12

# Field multiplications per signature, the least the verification needs
# (the bound's count, the yardstick; as the plain version sequences
# them):
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
SQ_DECOMP, MUL_DECOMP = 255, 19
SQ_DECODE_SR, MUL_DECODE_SR = 256, 26
SQ_LADDER, MUL_LADDER = 8 * 4 + 51 * 20, (8 * 4 + 7 * 9 + 17) + (51 * 30 + 1)
SQ_VERIFY = SQ_DECOMP + SQ_LADDER + 12
MUL_VERIFY = MUL_DECOMP + MUL_LADDER + (9 + 12)
SQ_VERIFY_SR = SQ_DECODE_SR + SQ_LADDER + 8
MUL_VERIFY_SR = MUL_DECODE_SR + MUL_LADDER + (9 + 8)
# The verify kernels' own field work per signature (csrc/quad25519.cuh),
# summed over the quad's four threads, which all run every instruction:
#   -A table: 8 quad doublings (4 sq + 4 mul), 7 quad adds (8 mul), 18
#     cached conversions (4 mul: every thread forms T * 2d);
#   ladder: 51 windows x (5 quad doublings, T always: 20 sq + 20 mul; 2 quad
#     adds: 16 mul);
#   R decoded by all four threads: 4 x the decoding's squares and multiplies;
#   tail: -R in cached form on all four (4 mul), one quad add (8 mul), the
#     cofactor's 3 (ed25519) or 2 (sr25519) quad doublings.
SQ_QUAD, MUL_QUAD = 8 * 4 + 51 * 20, (8 * 4 + 7 * 8 + 18 * 4) + 51 * 36 + (4 + 8)
SQ_OWN, MUL_OWN = SQ_QUAD + 4 * SQ_DECOMP + 12, MUL_QUAD + 4 * MUL_DECOMP + 12
SQ_OWN_SR, MUL_OWN_SR = SQ_QUAD + 4 * SQ_DECODE_SR + 8, MUL_QUAD + 4 * MUL_DECODE_SR + 8
DECODE_LANES = (N_BIG, N_MIXED_BUCKET, 256)  # the decoders' launches on the main paths
SEED_COLD = 31  # the keys of the cold-path breakdown (seen nowhere else)
# The microbench phase: K3/K4 are held against their plain versions at
# these lane counts (128 is the JAX probe's block, 10,240 K1's width) and
# iteration counts; the probes run 1/MB_SCALE of the JAX module's
# iterations. The K3 records time the bodies of K3_RECORDS, the K4 record
# the stacked conv, at MB_RECORD_LANES lanes; the field multiplication at
# MB_RECORD_ITERS iterations per launch is the kernel table's K3 row, and
# the checks hold it at that count too.
MB_LANES = (128, 10_240)
MB_CHECK_ITERS = (1, 7)
MB_SCALE = 100
BISECT_LANES = (256, N_BIG)  # K1's stage bisection, by the bench kernel
MB_RECORD_LANES, MB_RECORD_ITERS = 10_240, 1_000
# K3's records: probe name, iterations per launch, and the (squares,
# multiplies) of one iteration as the plain version does them (the bound
# counts these in 32-bit limbs, _imads32), with the kernel's own count,
# from the same formulas, printed beside where it differs (not in the
# kernels line: it is not measured): the quad forms T in every doubling,
# and window_step runs radix-2^13 limbs. A window is 4 doublings without T
# (4 sq + 3 mul), one with (4 sq + 4 mul), the mixed add (7 mul) and the
# -A add without T (7 mul).
K3_RECORDS = (
    ("mul", MB_RECORD_ITERS, (0, 1), None),
    ("sq", MB_RECORD_ITERS, (1, 0), None),
    ("double", 200, (4, 4), (4, 4)),
    ("5 doublings only", 40, (20, 16), (20, 20)),
    ("window_step(out_t=False)", 40, (20, 30), "radix-2^13"),
)
# K4's multiply-adds per lane and iteration: 4 coordinates x the 210 limb
# products of the 20 low columns, which is all that the [:, :20] slice
# keeps of the 400-product convolution.
K4_IMADS = 4 * 210

# bytes per lane, each input read once and each output written once: A
# coords 4 x 80 + r/s/k words 3 x 32 in, the mask out; for decoding, the
# encoding in, ok and X/Y/Z/T out
VERIFY_BYTES, DECOMP_BYTES = 4 * 80 + 3 * 32 + 4, 32 + 4 + 4 * 80


def _imads32(sq: int, mul: int) -> int:
    """IMADs of the same field work in 8 x 32-bit limbs: a multiply is 64
    32x32->64 products, a square 36, each plus 8 products folding the high
    half by 38; a product is two IMADs (mad.lo and mad.hi)."""
    return 2 * (sq * (36 + 8) + mul * (64 + 8))


def bound(imad_per_lane: int, bytes_per_lane: int, lanes: int) -> tuple[float, str]:
    """Least ms for `lanes` lanes: IMADs over the IMAD peak or bytes (each
    input read once, each output written once) over HBM, the larger. The
    kernel records take the IMADs of 32-bit limbs (_imads32), the least the
    field work needs; the kernels' own counts are printed beside."""
    ops = imad_per_lane * lanes / IMAD_PER_S * 1e3
    mem = bytes_per_lane * lanes / HBM_BYTES_PER_S * 1e3
    return (ops, "operations") if ops >= mem else (mem, "bytes")


def _smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def _kernel_label(mangled: str) -> str | None:
    """A readable name for a mangled kernel of the port: verify_kernel<0>
    is ed25519_verify, <1> sr25519, <0, int, int> (knobs in its parameter
    pack) the bench entry; decompress_kernel<0/1> the decoders;
    loop_kernel<N> is K3 with body N."""
    m = re.match(r"_Z\d+(verify|decompress)_kernelILi(\d)E(?:J(i*)E)?", mangled)
    if m:
        label = f"{('ed25519', 'sr25519')[int(m.group(2))]}_{m.group(1)}"
        return label + ("_bench" if m.group(3) else "")
    m = re.match(r"_Z\d+loop_kernelILi(\d+)E", mangled)
    if m:
        from cometbft_tpu_torch.ops import microbench as MB

        names = [n for n, b in MB.BODIES.items() if b.body_id == int(m.group(1))]
        return f"loop_kernel<{names[0]}>"
    if "stacked_conv_kernel" in mangled:
        return "stacked_conv_kernel"
    return None


def ptxas_summary(report: str) -> dict[str, list[str]]:
    """Kernel name -> its stack/spill and register lines of `nvcc -Xptxas
    -v` (template kernels' mangled names read by _kernel_label)."""
    out: dict[str, list[str]] = {}
    cur = None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = _kernel_label(m.group(1))
            if cur:
                out[cur] = []
        elif cur and ("spill" in line or "registers" in line):
            out[cur].append(line.split(":", 1)[-1].strip() if "registers" in line
                            else line.strip())
            if "registers" in line:
                cur = None
    return out


DECODERS = ("ed25519_decompress", "sr25519_decompress")


def shape_entries() -> list[tuple[str, str, Callable[[int, torch.device], dict],
                                  tuple[int, ...]]]:
    """Every kernel held to no local memory and one-wave launches: its label
    (as ptxas_summary names it), the source whose ptxas report holds it, its
    launch shape at (lanes, device), and the lane counts it launches at. K1,
    K2 and the decoders at the main paths' lane counts, the bench kernel at
    the bisection's, each K3 body (under its first registered name, as
    _kernel_label) at MB_LANES."""
    from cometbft_tpu_torch.ops import microbench as MB
    from cometbft_tpu_torch.ops import verify_kernel as VK

    main_lanes = (256, N_MIXED_BUCKET, N_BIG)
    out = [(e, "verify25519", functools.partial(VK.launch_shape, e), main_lanes)
           for e in ("ed25519_verify", "sr25519_verify")]
    out.append(("ed25519_verify_bench", "verify25519",
                functools.partial(VK.launch_shape, "ed25519_verify_bench"), BISECT_LANES))
    out += [(e, "decompress25519", functools.partial(VK.launch_shape, e), main_lanes)
            for e in DECODERS]
    first: dict[int, str] = {}
    for name, body in MB.BODIES.items():
        first.setdefault(body.body_id, name)
    out += [(f"loop_kernel<{name}>", "microbench", functools.partial(MB.launch_shape, name),
             MB_LANES) for name in first.values()]
    return out


def check_kernel_shapes(reports: dict[str, str], device) -> None:
    """Every kernel of shape_entries must compile with no stack frame and no
    spills (ptxas's report, when this run built its source), load with no
    local memory (cudaFuncGetAttributes, on every run) and launch in one
    wave at each of its lane counts. Prints each launch's shape: lanes per
    block, threads, resident blocks per SM (the CUDA occupancy calculator),
    waves and registers."""
    for label, stem, shape_of, lanes in shape_entries():
        if reports[stem]:
            lines = " ".join(ptxas_summary(reports[stem]).get(label, []))
            if not re.search(r"\b0 bytes stack frame, 0 bytes spill stores, "
                             r"0 bytes spill loads", lines):
                raise AssertionError(f"ptxas {label}: local memory in use: {lines!r}")
        for n in lanes:
            shape = shape_of(n, device)
            print(f"  occupancy {label} {n} lanes: {shape}", flush=True)
            if shape["local_bytes"] or shape["waves"] != 1:
                raise AssertionError(f"{label} at {n} lanes: local memory or more than one "
                                     f"wave: {shape}")
    built = [s for s, report in reports.items() if report]
    print("  K1, K2, the bench kernel, the decoders and every loop_kernel<...> use 0 B stack "
          f"and 0 spills (ptxas report of {built or 'no fresh build'} and loaded library), "
          "one wave a launch", flush=True)


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


def order8_point():
    """A point of order 8, from the oracle: [L]Q for the first curve point Q
    (by y = 3, 4, ...) whose torsion component has order 8."""
    from cometbft_tpu_torch.crypto import ed25519_math as O

    y = 2
    while True:
        y += 1
        q = O.point_decompress_zip215(y.to_bytes(32, "little"))
        if q is None:
            continue
        t = O.scalar_mult(O.L, q)
        if not O.is_identity(O.scalar_mult(4, t)):
            return t


def torsion_cases(msgs: list[bytes], seed: int = SEED_EDGE):
    """Eight (pub, msg, sig) lanes that a new field representation can get
    wrong, with the oracle's verdict each: a torsion component in R or A
    (valid only under the cofactored check), the non-canonical encodings
    y = p (a point of order 4) and y = p + 1 (the identity) as R and as A,
    R = (x = 0, sign bit set), and an R moved off its signature. msgs
    supplies the eight messages."""
    from cometbft_tpu_torch.crypto import ed25519_math as O

    rng = np.random.default_rng(seed)
    t8 = order8_point()
    a, r = (int.from_bytes(rng.bytes(32), "little") % O.L for _ in range(2))
    A, R = O.scalar_mult(a, O.B_POINT), O.scalar_mult(r, O.B_POINT)
    a_enc, r_enc = O.point_compress(A), O.point_compress(R)
    y_p = O.P.to_bytes(32, "little")                      # order 4, x = sqrt(-1)
    y_p_odd = (O.P | 1 << 255).to_bytes(32, "little")     # its negation
    y_p1 = (O.P + 1).to_bytes(32, "little")               # the identity
    x0_signed = (1 | 1 << 255).to_bytes(32, "little")     # x = 0, sign 1

    def sig(r_bytes: bytes, a_bytes: bytes, m: bytes, s: int | None = None) -> bytes:
        """s = r + k a (or the given s), k over the encodings as sent."""
        if s is None:
            s = r + O.sha512_mod_l(r_bytes, a_bytes, m) * a
        return r_bytes + (s % O.L).to_bytes(32, "little")

    def k_times_a(r_bytes: bytes, m: bytes) -> int:
        return O.sha512_mod_l(r_bytes, a_enc, m) * a

    rt8 = O.point_compress(O.point_add(R, t8))
    at8 = O.point_compress(O.point_add(A, t8))
    m = msgs
    cases = [
        # R + T, T of order 8, signed over R + T: [s]B - [k]A - R' = -T
        (a_enc, m[0], sig(rt8, a_enc, m[0])),
        # A + T: [s]B - [k]A' - R = -kT
        (at8, m[1], sig(r_enc, at8, m[1])),
        # A of order 4 (y = p) under s = r: [s]B - [k]A - R = -kA
        (y_p, m[2], sig(r_enc, y_p, m[2], s=r)),
        # R of order 4 (y = p, sign 1) under s = k a
        (a_enc, m[3], sig(y_p_odd, a_enc, m[3], s=k_times_a(y_p_odd, m[3]))),
        # R = the identity as y = p + 1 under s = k a
        (a_enc, m[4], sig(y_p1, a_enc, m[4], s=k_times_a(y_p1, m[4]))),
        # A = the identity as y = p + 1 under s = r
        (y_p1, m[5], sig(r_enc, y_p1, m[5], s=r)),
        # R with x = 0 and the sign bit set: no such encoding
        (a_enc, m[6], sig(x0_signed, a_enc, m[6], s=k_times_a(x0_signed, m[6]))),
        # R + T sent with the signature made for R: k differs
        (a_enc, m[7], rt8 + sig(r_enc, a_enc, m[7])[32:]),
    ]
    return cases, [O.verify_zip215(pk, mm, sg) for pk, mm, sg in cases]


TORSION_VERDICTS = [True, True, True, True, True, True, False, False]


def edge_lanes(pubs, msgs, sigs):
    """Overwrite lanes 0..15 with the edge cases of ZIP-215 (8..15 the
    torsion and encoding cases of torsion_cases); returns the oracle's
    verdict for each."""
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
    torsion, want = torsion_cases(msgs[8:16])
    if want != TORSION_VERDICTS:
        raise AssertionError(f"torsion edge lanes: oracle gives {want}")
    for i, (p, m, s) in enumerate(cases + torsion):
        pubs[i], msgs[i], sigs[i] = p, m, s
    return [O.verify_zip215(p, m, s) for p, m, s in cases] + want


def edge_lanes_sr(pubs, msgs, sigs):
    """Overwrite lanes 0..8 with the edge cases of schnorrkel over
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
        # a valid lane whose [4](sB - kA - R) is a multiple of p that is zero
        # only after a full carry (ROADMAP Queue 3 item 1)
        tuple(bytes.fromhex(h) for h in RIPPLE_LANE),
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


def encoding_words(pubs: list[bytes], b: int, pad: bytes) -> np.ndarray:
    """The (b, 8) uint32 words of the encodings, padded to b with `pad`."""
    from cometbft_tpu_torch.ops import limbs as L

    rows = np.frombuffer(b"".join(pubs) + pad * (b - len(pubs)), dtype=np.uint8)
    return L.bytes_to_words(rows.reshape(b, 32))


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


def time_back_to_back(fn, n: int = 50) -> float:
    """Mean ms of n launches in a row between two CUDA events (the card kept
    busy: no host round trip between launches)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(n):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / n


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
    one batch of n lanes with the edge cases in its first lanes and tampered
    lanes beyond: the verify kernel bit for bit; the decoder, on the R
    encodings and on the pubkeys, by ok bit for bit and X, Y, Z, T by
    canonical value on every lane (its limbs are canonical, the plain
    version's carried). Then the verify path's final mask against the
    oracle on a sample. Returns each kernel's largest
    difference (0 when equal)."""
    from cometbft_tpu_torch.ops import ed25519_kernel as K
    from cometbft_tpu_torch.ops import verify_kernel as VK

    b = K.bucket_size(n)
    pubs, msgs, sigs = path.make_commit(n, SEED_CHECK + n)
    want_edge = path.edge_lanes(pubs, msgs, sigs)
    tampered = [n // 2, n - 1, n // 3]
    tamper(pubs, msgs, sigs, tampered)
    t = staged(path, pubs, msgs, sigs, device)
    pub_words = K._words_to_device(encoding_words(pubs, b, path.scheme.id_enc).T, device)
    err = {f"{name}_verify": _max_err(path.verify(*t), path.verify_plain(*t)),
           f"{name}_decompress": 0}
    for words in (t[4], pub_words):
        e = VK.decode_err(path.decompress(words), path.decompress_plain(words))
        err[f"{name}_decompress"] = max(err[f"{name}_decompress"], e)
    _sync(device)
    if any(err.values()):
        raise AssertionError(f"{name} {n} lanes: kernel and plain version differ {err}")
    got, flips = K.verify_rows(path.scheme, pubs, msgs, sigs,
                               cache=K.PubKeyCache(device, path.scheme))
    if flips:
        raise AssertionError(f"{name} {n} lanes: host recheck flipped {flips} lanes")
    n_edge = len(want_edge)
    sample = list(range(n_edge)) + tampered + [n_edge, n_edge + 1, n // 4, n - 2]
    for i in sample:
        want = path.scheme.verify_one(pubs[i], msgs[i], sigs[i])
        if bool(got[i]) != want:
            raise AssertionError(f"{name} {n} lanes: lane {i} is {bool(got[i])}, oracle {want}")
    if [bool(got[i]) for i in range(n_edge)] != want_edge:
        raise AssertionError(f"{name}: edge lanes disagree with the oracle")
    print(f"check {name} {n} signatures at {b} lanes: verify kernel == plain bit for bit "
          f"(mask, all-ok); decoder == plain on R and on the pubkeys (ok bit for bit, "
          f"X/Y/Z/T canonical on every lane); mask == oracle on {len(sample)} sampled "
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
                sq_mul_verify: tuple[int, int], sq_mul_own: tuple[int, int]
                ) -> tuple[dict, dict]:
    """Verify kernel and plain times and bounds of a scheme at each lane
    count, on an untampered batch, where all-ok must be set by kernel and
    plain alike. Returns (times, bounds) keyed by lane count."""
    times, bounds = {}, {}
    for n in lanes:
        bounds[n] = {
            "verify": bound(_imads32(*sq_mul_verify), VERIFY_BYTES, n),
            "verify_own": bound(_imads32(*sq_mul_own), VERIFY_BYTES, n),
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
        }
        print(f"[{card}] {name} {n} lanes: verify kernel {times[n]['verify']:.4f} ms "
              f"(median of 20), plain {times[n]['verify_plain']:.3f} ms; bound (32-bit "
              f"limbs) {bounds[n]['verify'][0]:.4f} ms ({bounds[n]['verify'][1]}), at the "
              f"quad's own count {bounds[n]['verify_own'][0]:.4f} ms; at "
              f"{bounds[n]['verify'][0] / times[n]['verify']:.1%} of its bound; all-ok set "
              f"by kernel and plain", flush=True)
    return times, bounds


def time_decoders(name: str, path: Path, device, card: str, sq_mul: tuple[int, int]
                  ) -> dict:
    """A scheme's decoder at DECODE_LANES keys (a commit's pubkeys): held
    against the plain version, then timed per launch (median of 20 CUDA
    event times, "ms") and back to back (mean of 50, "ms_back_to_back"),
    the plain version on the host clock (median of 3, "plain_ms"), and the
    bound. Returns these per lane count."""
    from cometbft_tpu_torch.ops import ed25519_kernel as K
    from cometbft_tpu_torch.ops import verify_kernel as VK

    out = {}
    for n in DECODE_LANES:
        pubs = path.make_commit(n, SEED_CHECK)[0]
        words = K._words_to_device(encoding_words(pubs, n, path.scheme.id_enc).T, device)
        if VK.decode_err(path.decompress(words), path.decompress_plain(words)):
            raise AssertionError(f"{name} decoder at {n} keys differs from plain")
        row = {"bound": bound(_imads32(*sq_mul), DECOMP_BYTES, n),
               "plain_ms": time_wall(lambda: path.decompress_plain(words), 3, device),
               "ms": time_kernel(lambda: path.decompress(words)),
               "ms_back_to_back": time_back_to_back(lambda: path.decompress(words))}
        out[n] = row
        print(f"[{card}] {name} decoder at {n} keys: {row['ms']:.4f} ms per launch (median "
              f"of 20), {row['ms_back_to_back']:.4f} back to back (mean of 50); plain "
              f"{row['plain_ms']:.3f} ms; bound (32-bit limbs) {row['bound'][0]:.4f} ms "
              f"({row['bound'][1]}), the kernel at {row['bound'][0] / row['ms']:.1%} / "
              f"{row['bound'][0] / row['ms_back_to_back']:.1%} of it", flush=True)
    return out


def time_cold_path(name: str, path: Path, device, card: str, seed: int) -> dict:
    """One cold verify() of a 10,240-validator commit of new keys through
    create_batch_verifier, by part (host clock, synchronised, but the
    kernel): the decoder kernel (CUDA events around its launch), what
    decompress_points does before it (padding, packing and uploading the
    encodings, allocating the outputs), the device->host copy of its output
    after it (stack, copy, slicing), PubKeyCache._insert plus the per-key
    lookup loop (lookup_or_decompress less decompress_points),
    pad_coords_batch_minor, and the rest of PubKeyCache.stage (the batch
    digest and the coordinates' upload). Returns the parts and the whole in
    ms."""
    from cometbft_tpu_torch.crypto import batch as crypto_batch
    from cometbft_tpu_torch.ops import ed25519_kernel as K
    from cometbft_tpu_torch.ops import verify_kernel as VK

    pubs, msgs, sigs = path.make_commit(N_BIG, seed)
    keys = [path.pub_key(p) for p in pubs]
    lib, entry = VK._lib("decompress25519"), f"{name}_decompress"
    ms = dict.fromkeys(("decompress_points", "lookup", "pad", "stage", "kernel"), 0.0)
    marks = {}

    def walled(label, fn):
        def wrapper(*a, **kw):
            _sync(device)
            t0 = marks[label] = time.perf_counter()
            out = fn(*a, **kw)
            _sync(device)
            ms[label] += (time.perf_counter() - t0) * 1e3
            marks[label + "_end"] = time.perf_counter()
            return out
        return wrapper

    launch = getattr(lib, entry)

    def timed_launch(*args):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        marks["launch"] = time.perf_counter()
        e0.record()
        err = launch(*args)
        e1.record()
        e1.synchronize()
        marks["kernel_end"] = time.perf_counter()
        ms["kernel"] += e0.elapsed_time(e1)
        return err

    saved = (K.decompress_points, K.pad_coords_batch_minor, K.PubKeyCache.lookup_or_decompress,
             K.PubKeyCache.stage)
    K.decompress_points = walled("decompress_points", saved[0])
    K.pad_coords_batch_minor = walled("pad", saved[1])
    K.PubKeyCache.lookup_or_decompress = walled("lookup", saved[2])
    K.PubKeyCache.stage = walled("stage", saved[3])
    setattr(lib, entry, timed_launch)
    try:
        v = crypto_batch.create_batch_verifier(keys[0])
        for key, m, sg in zip(keys, msgs, sigs):
            v.add(key, m, sg)
        _sync(device)
        t0 = time.perf_counter()
        ok, _ = v.verify()
        _sync(device)
        total = (time.perf_counter() - t0) * 1e3
    finally:
        (K.decompress_points, K.pad_coords_batch_minor, K.PubKeyCache.lookup_or_decompress,
         K.PubKeyCache.stage) = saved
        setattr(lib, entry, launch)
    if not ok or "launch" not in marks:
        raise AssertionError(f"{name} cold verify(): ok {ok}, decoder launched: "
                             f"{'launch' in marks}")
    parts = {
        "verify": total,
        "decoder_kernel": ms["kernel"],
        "before_kernel": (marks["launch"] - marks["decompress_points"]) * 1e3,
        "copy_to_host": (marks["decompress_points_end"] - marks["kernel_end"]) * 1e3,
        "insert_and_lookup": ms["lookup"] - ms["decompress_points"],
        "pad_coords": ms["pad"],
        "digest_and_upload": ms["stage"] - ms["lookup"] - ms["pad"],
    }
    parts["rest"] = total - ms["stage"]
    print(f"[{card}] cold verify() {name} {N_BIG} validators: {total:.3f} ms; decoder kernel "
          f"{parts['decoder_kernel']:.4f} ms ({parts['decoder_kernel'] / total:.3%}), before "
          f"it in decompress_points {parts['before_kernel']:.3f}, device->host copy "
          f"{parts['copy_to_host']:.3f}, _insert + lookup loop "
          f"{parts['insert_and_lookup']:.3f}, pad_coords_batch_minor {parts['pad_coords']:.3f}, "
          f"digest + upload {parts['digest_and_upload']:.3f}, the rest of verify() (staging, "
          f"K1/K2, recheck) {parts['rest']:.3f}", flush=True)
    return parts


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


# ------------------------------------------------------------ microbench


def k3_record_name(name: str) -> str:
    """The kernels line's name of K3's record of probe `name`: the field
    multiplication keeps the kernel table's name."""
    return "microbench_loop" if name == "mul" else f"microbench_loop[{name}]"


def check_microbench(device) -> dict[str, int]:
    """K3 for every registered body and K4 against their plain versions on
    the card, at MB_LANES lanes and MB_CHECK_ITERS iterations (the field
    multiplication at MB_RECORD_ITERS too), on the probes' seeded state: K3's
    limb bodies and K4 bit for bit, K3's value bodies by canonical value
    (microbench.loop_err: the kernel's canonical limbs against the plain
    version's, canonicalized; double_no_t's T zeros exactly); then the
    verify kernel's bench instantiation against verify_math_bench at 128
    lanes on a staged commit, and at N_BIG lanes on the verify probes'
    inputs with each of their knob settings. Returns each kernel's largest
    difference (0 when equal), K3's under each record's name too."""
    from cometbft_tpu_torch.ops import microbench as MB
    from cometbft_tpu_torch.ops import verify_kernel as VK

    err = {"microbench_loop": 0, "microbench_stacked": 0}
    for name, body in MB.BODIES.items():
        e_body = 0
        for lanes in MB_LANES:
            state = torch.from_numpy(MB.probe_state(body.n_state, lanes)).to(device)
            for iters in MB_CHECK_ITERS + ((MB_RECORD_ITERS,) if name == "mul" else ()):
                e = MB.loop_err(name, MB.loop(name, state, iters),
                                MB.loop_plain(name, state, iters))
                e_body = max(e_body, e)
                if e:
                    raise AssertionError(f"K3 {name!r} at {lanes} lanes, {iters} iterations: "
                                         f"kernel and plain differ by {e}")
        err[k3_record_name(name)] = e_body
        err["microbench_loop"] = max(err["microbench_loop"], e_body)
    rng = np.random.default_rng(0)
    for lanes in MB_LANES:
        a, b = (torch.from_numpy(rng.integers(0, 8000, size=(4, 20, lanes)).astype(np.int32))
                .to(device) for _ in range(2))
        for iters in MB_CHECK_ITERS:
            e = _max_err([MB.stacked(a, b, iters)], [MB.stacked_plain(a, b, iters)])
            err["microbench_stacked"] = max(err["microbench_stacked"], e)
            if e:
                raise AssertionError(f"K4 at {lanes} lanes, {iters} iterations: differ by {e}")
    n_value = sum(b.body_id in MB.VALUE_BODIES for b in MB.BODIES.values())
    print(f"check microbench: K3 == plain for all {len(MB.BODIES)} registered probe bodies "
          f"({MB.N_BODIES} kernel bodies; {n_value} names on the 32-bit field and quad by "
          f"canonical value, the rest bit for bit) and K4 == plain bit for bit, at "
          f"{' and '.join(map(str, MB_LANES))} lanes and {MB_CHECK_ITERS} iterations, mul "
          f"also at {MB_RECORD_ITERS}", flush=True)

    def held(args, knobs, label):
        got = VK.verify_bench(*args, n_windows=knobs[0], stages=knobs[1])
        e = _max_err(got, VK.verify_math_bench(*args, n_windows=knobs[0], stages=knobs[1]))
        if e:
            raise AssertionError(f"bench verify {knobs} {label}: kernel and plain differ by {e}")
        return got

    ed = _paths()["ed25519"]
    pubs, msgs, sigs = ed.make_commit(128, SEED_CHECK)
    tampered = [5, 64, 127]
    tamper(pubs, msgs, sigs, tampered)
    t = staged(ed, pubs, msgs, sigs, device)
    prod = VK.verify_ok(*t)[0]
    for knobs in ((26, "full"), (0, "nodecomp"), (51, "full")):
        got = held(t, knobs, "at 128 lanes")
    if not torch.equal(got[0], prod) or torch.nonzero(~prod).flatten().tolist() != tampered:
        raise AssertionError("bench verify (51, full) differs from the production mask")
    # the bisection's own shapes, inputs and knobs (drive_microbench)
    for lanes in BISECT_LANES:
        probe_args = MB.bench_verify_inputs(lanes, device)
        for knobs in ((0, "full"), (26, "full"), (0, "nodecomp")):
            held(probe_args, knobs, f"at {lanes} lanes")
    print(f"check bench verify: == verify_math_bench at 128 lanes for (26, full), "
          f"(0, nodecomp), (51, full), where (51, full) == the production K1 mask, invalid "
          f"lanes {tampered}; and at {' and '.join(map(str, BISECT_LANES))} lanes on the "
          f"verify probes' inputs for (0, full), (26, full), (0, nodecomp)", flush=True)
    return err


def drive_microbench(device, card: str) -> dict:
    """The microbench's main path: its probes, as `python -m
    cometbft_tpu_torch.ops.microbench` runs them, at 1/MB_SCALE of the JAX
    module's iteration counts (the loop probes at both MB_LANES), with
    every count set to 0 just before and read just after. Each of K3, K4 and
    the bench verify kernel must have launched."""
    from cometbft_tpu_torch.ops import microbench as MB
    from cometbft_tpu_torch.ops import verify_kernel as VK

    MB.reset_launches()
    VK.reset_launches()
    print("host staging (serial vs vectorized hashers), 2,048 rows:", flush=True)
    MB.probe_staging(n=2048)
    print("full verify:", flush=True)
    verify_s = MB.probe_full_verify(N_BIG)
    bisects = {}
    for lanes in BISECT_LANES:
        print(f"stage bisection at {lanes} lanes:", flush=True)
        bisects[lanes] = MB.probe_bisect(lanes)
    bisect_small, bisect = bisects[256], bisects[N_BIG]
    per = {}
    for lanes in MB_LANES:
        print(f"probe bodies at {lanes} lanes (iterations 1/{MB_SCALE} of the JAX probe's):",
              flush=True)
        for name, body in MB.BODIES.items():
            per[(name, lanes)] = MB.probe_loop(name, max(1, body.base_iters // MB_SCALE), lanes)
        per[("stacked", lanes)] = MB.probe_stacked(100_000 // MB_SCALE, lanes)
    MB.probe_select16(torch_iters=100)
    launches = {**MB.LAUNCHES, "ed25519_verify_bench": VK.LAUNCHES["ed25519_verify_bench"]}
    if min(launches.values()) < 1 or set(MB.LOOP_LAUNCHES) != set(MB.BODIES):
        raise AssertionError(f"microbench: a kernel never launched {launches} "
                             f"{MB.LOOP_LAUNCHES}")
    print(f"main path microbench: launches {launches}", flush=True)
    # K3's other records count their own body's launches; the mul record,
    # the kernel table's K3 row, counts every K3 launch
    launches.update({k3_record_name(name): MB.LOOP_LAUNCHES[name] for name, *_ in K3_RECORDS
                     if name != "mul"})
    for name in list(MB.BODIES) + ["stacked"]:
        print(f"[{card}] {name:<28} " + ", ".join(
            f"{lanes} lanes {per[(name, lanes)]:.4f} us/iter" for lanes in MB_LANES), flush=True)
    print(f"[{card}] bench verify at {N_BIG} lanes: full {verify_s * 1e3:.4f} ms (verify "
          f"probe), {bisect['full'] * 1e3:.4f} ms (bisect probe), 26 windows "
          f"{bisect['half'] * 1e3:.4f} ms, no R decompression "
          f"{bisect['nodecomp'] * 1e3:.4f} ms", flush=True)
    print(f"[{card}] bench verify at 256 lanes: full {bisect_small['full'] * 1e3:.4f} ms, 26 "
          f"windows {bisect_small['half'] * 1e3:.4f} ms, no R decompression "
          f"{bisect_small['nodecomp'] * 1e3:.4f} ms", flush=True)
    return {"launches": launches, "per": per}


def time_microbench(device, card: str) -> dict:
    """K3's K3_RECORDS bodies and K4 (MB_RECORD_ITERS iterations) at
    MB_RECORD_LANES lanes: kernel times per launch (median of 20) and back
    to back (mean of 50), plain times, and bounds (K3's from the plain
    version's field work in 32-bit limbs, the kernel's own count beside)."""
    from cometbft_tpu_torch.ops import microbench as MB

    lanes = MB_RECORD_LANES
    out = {}
    for name, iters, sq_mul, own in K3_RECORDS:
        n = MB.BODIES[name].n_state
        state = torch.from_numpy(MB.probe_state(n, lanes)).to(device)
        fn = functools.partial(MB.loop, name, state, iters)
        out[k3_record_name(name)] = {
            "body": name, "iters": iters, "ms": time_kernel(fn),
            "ms_back_to_back": time_back_to_back(fn),
            "plain_ms": time_wall(lambda: MB.loop_plain(name, state, iters), 3, device),
            "bound": bound(_imads32(*sq_mul) * iters, 2 * n * 80, lanes),
            "own": (own if isinstance(own, str) or own is None
                    else f"{_imads32(*own)} IMADs a lane an iteration")}
    rng = np.random.default_rng(0)
    a, b = (torch.from_numpy(rng.integers(0, 8000, size=(4, 20, lanes)).astype(np.int32))
            .to(device) for _ in range(2))
    fn = functools.partial(MB.stacked, a, b, MB_RECORD_ITERS)
    out["microbench_stacked"] = {
        "body": "stacked", "iters": MB_RECORD_ITERS, "ms": time_kernel(fn),
        "ms_back_to_back": time_back_to_back(fn),
        "plain_ms": time_wall(lambda: MB.stacked_plain(a, b, MB_RECORD_ITERS), 3, device),
        "bound": bound(K4_IMADS * MB_RECORD_ITERS, 3 * 4 * 80, lanes), "own": None}
    for name, r in out.items():
        ms = r["ms"]
        print(f"[{card}] {name} at {lanes} lanes, {r['iters']} iterations: kernel {ms:.4f} ms "
              f"(median of 20, {r['bound'][0] / ms:.1%} of the bound), back to back "
              f"{r['ms_back_to_back']:.4f} ms (mean of 50), plain {r['plain_ms']:.3f} ms, bound "
              f"{r['bound'][0]:.4f} ms ({r['bound'][1]}"
              + (f"; own: {r['own']}" if r["own"] else "") + ")", flush=True)
    return out


def _record(name: str, replaces: str, launches: int, err: int, ms: float,
            plain_ms: float, b: tuple[float, str], **extra) -> dict:
    stem = "decompress25519" if name.endswith("decompress") else "verify25519"
    return {"name": name, "route": "cuda",
            "source": f"cometbft_tpu_torch/csrc/{stem}.cu",
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b[0], "bound_by": b[1],
            "library_ms": None, **extra}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from cometbft_tpu_torch.crypto import batch as crypto_batch
    from cometbft_tpu_torch.ops import _build

    device = torch.device("cuda")
    card = _smi()
    print(card, flush=True)
    # one nvcc per source, all started together
    t0 = time.perf_counter()
    stems = ("verify25519", "decompress25519", "microbench")
    with concurrent.futures.ThreadPoolExecutor(len(stems)) as pool:
        builds = dict(zip(stems, pool.map(_build.build, stems)))
    print(f"kernel build: {time.perf_counter() - t0:.3f} s", flush=True)
    for stem, (_, report, nvcc_s) in builds.items():
        print(f"  {stem}.cu: nvcc {nvcc_s:.3f} s", flush=True)
        for kernel, lines in ptxas_summary(report).items():
            print(f"  ptxas {kernel}: {'; '.join(lines)}", flush=True)
    check_kernel_shapes({stem: report for stem, (_, report, _) in builds.items()}, device)
    paths = _paths()
    ed, sr = paths["ed25519"], paths["sr25519"]

    # every lane count the main paths launch at, for both schemes: 128, 256
    # (the 150 commit's bucket, padding lanes included), 6,144 (the mixed
    # commit's per-scheme bucket of 5,120 signatures) and 10,240
    checks = [check_kernels(name, path, n, device) for name, path in (("ed25519", ed),
              ("sr25519", sr)) for n in (128, N_SMALL, 5_120, N_BIG)]
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
    print(f"IMADs per lane in 32-bit limbs, the least the work needs (the bounds): "
          f"ed25519 verify {_imads32(SQ_VERIFY, MUL_VERIFY)}, decompress "
          f"{_imads32(SQ_DECOMP, MUL_DECOMP)}; sr25519 verify "
          f"{_imads32(SQ_VERIFY_SR, MUL_VERIFY_SR)}, decode "
          f"{_imads32(SQ_DECODE_SR, MUL_DECODE_SR)}; the verify kernels' own (four threads "
          f"a signature): ed25519 {_imads32(SQ_OWN, MUL_OWN)}, sr25519 "
          f"{_imads32(SQ_OWN_SR, MUL_OWN_SR)}; the decoders' own (one thread a key, 32-bit "
          f"limbs): ed25519 {_imads32(SQ_DECOMP, MUL_DECOMP)}, sr25519 "
          f"{_imads32(SQ_DECODE_SR, MUL_DECODE_SR)}, each +{_imads32(0, 1)} where the data take "
          f"the multiply by sqrt(-1)", flush=True)
    times, bounds = time_scheme("ed25519", ed, (N_BIG, 256), device, card,
                                (SQ_VERIFY, MUL_VERIFY), (SQ_OWN, MUL_OWN))
    times_sr, bounds_sr = time_scheme("sr25519", sr, (N_BIG, N_MIXED_BUCKET), device, card,
                                      (SQ_VERIFY_SR, MUL_VERIFY_SR), (SQ_OWN_SR, MUL_OWN_SR))
    dec = {"ed25519": time_decoders("ed25519", ed, device, card, (SQ_DECOMP, MUL_DECOMP)),
           "sr25519": time_decoders("sr25519", sr, device, card,
                                    (SQ_DECODE_SR, MUL_DECODE_SR))}
    for name, path in (("ed25519", ed), ("sr25519", sr)):
        time_cold_path(name, path, device, card, SEED_COLD)
    for label, r in (("ed25519", big), ("ed25519", small), ("sr25519", big_sr),
                     ("mixed ed25519 + sr25519", mixed)):
        print(f"[{card}] verify() {label} {r['n']} validators: cold {r['cold_ms']:.3f} ms "
              f"(decode + upload included), warm {r['warm_ms']:.3f} ms "
              f"(median of 5, key cache hit) = "
              f"{r['n'] / r['warm_ms'] * 1e3:.0f} signatures/s", flush=True)
    time_host_stages("ed25519", ed, device, card)
    time_host_stages("sr25519", sr, device, card)

    t_mb = time.perf_counter()
    err.update(check_microbench(device))
    mb = drive_microbench(device, card)
    mb_times = time_microbench(device, card)
    print(f"microbench phase: {time.perf_counter() - t_mb:.1f} s (checks, probes, timing)",
          flush=True)

    kernels = {"kernels": []}
    for name, run, t, b, d, replaces in (
            ("ed25519", big, times, bounds, dec["ed25519"], "ed25519_kernel.py:97"),
            ("sr25519", big_sr, times_sr, bounds_sr, dec["sr25519"], "sr25519_kernel.py:102")):
        kernels["kernels"] += [
            _record(f"{name}_verify", "cometbft_tpu/ops/pallas_verify.py:198",
                    run["launches"][f"{name}_verify"], err[f"{name}_verify"],
                    t[N_BIG]["verify"], t[N_BIG]["verify_plain"], b[N_BIG]["verify"]),
            _record(f"{name}_decompress", f"cometbft_tpu/ops/{replaces}",
                    run["launches"][f"{name}_decompress"], err[f"{name}_decompress"],
                    d[N_BIG]["ms"], d[N_BIG]["plain_ms"], d[N_BIG]["bound"],
                    ms_back_to_back=d[N_BIG]["ms_back_to_back"])]
    for name, r in mb_times.items():
        replaces = "microbench.py:280" if name == "microbench_stacked" else "microbench.py:88"
        kernels["kernels"].append({
            "name": name, "route": "cuda", "source": "cometbft_tpu_torch/csrc/microbench.cu",
            "replaces": f"cometbft_tpu/ops/{replaces}", "launches": mb["launches"][name],
            "max_abs_err": err[name], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound"][0], "bound_by": r["bound"][1], "library_ms": None,
            "body": r["body"], "lanes": MB_RECORD_LANES, "iters": r["iters"],
            "ms_back_to_back": r["ms_back_to_back"],
            "us_per_iter": mb["per"][(r["body"], MB_RECORD_LANES)]})
    print(f"chip_smoke: {time.perf_counter() - t0:.1f} s since the kernel build began",
          flush=True)
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
