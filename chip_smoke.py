"""On-card smoke run of the PyTorch/CUDA port (cometbft_tpu_torch).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds the port's CUDA kernels from csrc/ (one nvcc per source, all at
once), checks that ptxas gave the verify kernels, the pubkey decoders,
every body of the microbench's loop kernel, the challenge kernel K5 (its
three entries) and the integrity kernel
K6 no stack frame and no spills
and that their launches at the main paths' lane counts are one wave (the
CUDA occupancy calculator), and that the native host rungs (native/*.c,
built with cc) loaded. It holds each kernel against its plain PyTorch
version on the card: the verify kernels on batches whose first lanes are
edge cases (ZIP-215 encodings, torsion components, y = p and y = p + 1, a
sr25519 lane whose check lands on a multiple of p), bit for bit; the
decoders by ok bit for bit and X, Y, Z, T by canonical value; K5 over the
vote geometry and the SHA-512 block boundaries, and K6's header and
payload from raw int32 verdicts, in stream order and as a programmatic
launch, bit for bit. Then it drives the main paths through the entry
points a node calls:

  - ed25519: crypto.batch.create_batch_verifier -> add -> verify on a
    10,240-validator commit and on 150-validator commits, their sign-bytes
    factored (SharedPrefixRows: the device-challenge path, K5), the 150
    commit also untampered and as plain bytes (the classic path);
  - sr25519: the same on a 10,240-validator commit;
  - mixed: crypto.batch.create_mixed_batch_verifier on a 10,240-validator
    mega-commit, ed25519 and sr25519 validators interleaved;

with tampered lanes at known indices. It checks the masks, the launch and
lane counters, the path counters (device-challenge lanes, indexed key
sends, happy or full headers, the native hash rung) and the host-oracle
recheck, and holds K5 and K6 against their plain versions on each path's
own inputs; it records the aten ops of one verify_rows and fails if
anything but K6 launches between the verify kernel and the header fetch.

Then the commit phase drives the top of the main path,
types/validation.verify_commit* on real Commits and ValidatorSets (the
port's types/, chain cosmoshub-4, equal power, 1% ABSENT, 1% NIL and a few
off-length timestamps in the 10,240-validator commits) through the
scheduler: ed25519 10,240 (cold, warm, one tampered signature, by part
with the host parts rows and sched), verify_commit_light and
_light_trusting(1/3) on it, mixed 10,240 (5,120 ed25519 + 5,120
sr25519), ed25519 150, a blocksync window of 16 150-validator commits
(stage_verify_commit -> resolve_staged under SYNC, and one with a bad
signature in commit 9), and 64 mempool rows submitted beside a
150-validator consensus commit, then flushed alone by the deadline
worker. Every run's launches, lanes and fetches are asserted (one K5, one
K1 (+ one K2), one K6 a scheme, a header-only fetch when valid) and each
cell's time is printed beside the seam time of its own rows.
Then the BLS phase (bls_phase): the five BLS12-381 kernels B1-B5
(csrc/bls12381.cu) held against their plain versions by canonical value on
edge-case inputs (x >= p staged as the generator, a non-square x, points
outside G1/G2, both sign bits; 64 messages; 1,024 points in uneven groups
and one summing to infinity; 64 Miller pairs), then all-BLS verify_commit
at 150 validators (distinct timestamps: cold, warm, a tampered signature
pinpointed per lane through the scheduler, aggregate_verify_agg) and at
10,240 sharing one timestamp (cold, warm, tampered: the single-verify path
at full width), and a mixed 50 ed25519 + 50 sr25519 + 50 bls12381 commit,
every run's launches and errors asserted, each kernel timed at the main
path's largest shape beside its bound from its Fp-product count.
Then the mesh phase (mesh_phase): the fault-domain VerifyMesh
(parallel/mesh.py) of four domains on the one card, each with its own
stream, key tables, supervisor and breaker, routed through by the
scheduler: the 10,240 commit's rows (8 tampered) spread as 5 shards of
2,048 lanes, the 150 commit pinned to one domain, the mixed commit's
sr25519 rows and all its rows spread, a BLS 150 batch through the BLS shard
and the mixed 50 + 50 + 50 commit, a domain killed by a chaos site and
readmitted (its tables, and only its, dropped), every domain killed (the
single-card path), and the SPMD plane (K1 once a domain on its lane slice,
held against one unsharded launch and a slice against the plain version);
every run's shards, lanes, launches and launch streams asserted, the
spread flush timed with the mesh on and off.
Then the consumers phase (consumers_phase), the mesh off: VoteSet's
batch-first flush (types/vote_set.py) at 10,000 ed25519 validators (8
tampered votes, one valid equivocation raised as ErrVoteConflictingVotes
after the tally, one K5, K1 and K6 a flush, cold and 5 warm; make_commit
through verify_commit; the equivocation as DuplicateVoteEvidence through
verify_evidence, and with vote B tampered), at 150 with auto_flush (the
batch-size and 2/3 boundaries), with vote extensions (the second batch's
rows) and mixed ed25519 + sr25519 (K1 and K2); the light client's
bisection over BASELINE config 4 (100,000 heights x 500 validators, 8
versions of the set, a lazy provider, one witness, LightStore(MemDB())),
every non-adjacent hop one prefetch of two groups, a forged target and a
witness serving conflicting headers, whose LightClientAttackEvidence
verify_light_client_attack accepts against a stub block store; commit
certificates at 150 BLS validators (each hop decided by B1-B5, a flipped
signer bit and a forged aggregate falling back to the classic verdict);
and a commit with a secp256k1 validator on the serial path, no launch.
Then the consensus phase (consensus_phase), the mesh off: the port's
ConsensusState, BlockExecutor, kvstore app over its local ABCI client,
signature-checked mempool, stores and FilePV as in-process validator nets
(tests/torch_net_harness.py): 4 ed25519 validators for 10 heights with 64
signed txs (2 forged) through check_tx, the same net with vote extensions
from height 2, a mixed net (2 ed25519, 1 sr25519, 1 BLS12-381) for 3
heights, and one real node among 150 validators (149 stubs, one tampered
prevote, one equivocation committed as evidence) for 5 heights; every
batched vote flush and every validate_block must launch K1, K5 and K6 (the
mixed net K2 and B1, B2, B4, B5), no plain version may run, and the
per-height times, heightline phases and the 150-validator height's split
are printed. The wire phase (wire_phase) runs nets over TCP and block
sync, the node phase (node_phase) the port's Node from `testnet` homes.
Then the RPC phase (rpc_phase): four Nodes with the reference's default
RPC and PEX on, one reaching the others through PEX from its seed and one
served by `python -m cometbft_tpu_torch.abci.cli kvstore` over TCP, loaded
with txs through broadcast_tx_sync and broadcast_tx_commit while a
websocket counts the blocks (rpc4: every tx found by tx and tx_search,
/block and /commit against the stores, K5, K1 and K6 launched by the
commits); the node phase's synced Node serving the 1,000 x 150 chain
(rpc150: /commit against the chain's commits, /validators paged); and a
4-validator TCP net with one validator on the remote signer (signer4).
It times the kernels (the decoders at 10,240, 6,144 and 256 keys, K5 beside
its hashing alone, and K6 at 10,240 lanes, with the
wrappers' host time by step, and K6 behind K1 in stream order and as a
programmatic launch), their plain versions, verify() end to
end and by part, warm and cold (plan, keys, pack, derive, verify, header,
fetch, recheck). Then the device microbench (ops/microbench.py): its loop
kernel (K3) for every registered probe body (the value bodies on the
verify kernels' 32-bit field and quad by canonical value, the radix-2^13
limb bodies bit for bit) and its stacked-conv kernel (K4) against their
plain versions, K3's records for mul, sq, double, 5 doublings and the
ladder window, the verify kernel's bench instantiation against
verify_math_bench, the probes at 1/MB_SCALE of the JAX module's iteration
counts and the verify kernel's bisection at 10,240 and 256 lanes. It
prints one JSON line of kernel records and, last, the device record. Any
mismatch raises; without a card it exits non-zero before printing a
result.
"""

from __future__ import annotations

import base64
import collections
import concurrent.futures
import functools
import gc
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
    m = re.match(r"_Z\d+bls_(decompress|point_sum)_kernelILi(\d)E", mangled)
    if m:
        return f"bls_{m.group(1)}_g{m.group(2)}"
    m = re.match(r"_Z\d+bls_point_sum_part_kernelILi(\d)E", mangled)
    if m:
        return f"bls_point_sum_g{m.group(1)}_part"
    m = re.match(r"_Z\d+bls_decompress_trio_kernelILi(\d)E", mangled)
    if m:
        return f"bls_decompress_g{m.group(1)}_trio"
    m = re.match(r"_Z\d+bls_miller_group_kernelILi(\d+)E", mangled)
    if m:
        return {"6": "bls_miller_sextet", "16": "bls_miller_half"}.get(m.group(1))
    for kernel, label in (("bls_hash_to_g2_kernel", "bls_hash_to_g2"),
                          ("bls_hash_to_g2_lane_kernel", "bls_hash_to_g2_lane"),
                          ("bls_miller_kernel", "bls_miller"),
                          ("bls_final_exp_kernel", "bls_final_exp"),
                          ("bls_final_exp_lane_kernel", "bls_final_exp_lane"),
                          ("derive_kernel", "challenge_derive"),
                          ("sha512_rows_kernel", "challenge_sha512"),
                          ("reduce512_kernel", "challenge_reduce"),
                          ("integrity_kernel", "integrity")):
        if re.match(rf"_Z\d+{kernel}", mangled):
            return label
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
    from cometbft_tpu_torch.ops import challenge as CH
    from cometbft_tpu_torch.ops import integrity as IN
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
    # K5's three entries at the ed25519 lane counts of the main paths; K6
    # over the words of a device-challenge block there
    out += [(e, "challenge25519", functools.partial(CH.launch_shape, e), main_lanes)
            for e in ("challenge_derive", "challenge_sha512", "challenge_reduce")]
    out.append(("integrity", "integrity",
                lambda n, dev: IN.launch_shape(CH.block_words(n, CH.MAX_VAR), dev), main_lanes))
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
    print("  K1, K2, the bench kernel, the decoders, every loop_kernel<...>, K5's three "
          "entries and K6 use 0 B stack "
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


def vote_sign_bytes_parts(height: int, block_hash: bytes, secs: int, nanos: int
                          ) -> tuple[bytes, bytes]:
    """Length-delimited CanonicalVote (PRECOMMIT) protobuf, the sign-bytes
    of a commit signature, as (prefix, suffix): the length varint, type,
    height, round and block id, shared by a commit's votes; then the
    timestamp and the chain id."""
    psh = b"\x08" + _varint(1) + _field(0x12, hashlib.sha256(block_hash).digest())
    bid = _field(0x0A, block_hash) + _field(0x12, psh)
    ts = b"\x08" + _varint(secs) + b"\x10" + _varint(nanos)
    head = (b"\x08\x02" + b"\x11" + height.to_bytes(8, "little")
            + b"\x19" + (0).to_bytes(8, "little") + _field(0x22, bid))
    tail = _field(0x2A, ts) + _field(0x32, CHAIN_ID.encode())
    return _varint(len(head) + len(tail)) + head, tail


def commit_rows(n: int, seed: int):
    """The sign-bytes of n validators' precommits for block `seed` as
    SharedPrefixRows, one prefix and n suffixes, the way a commit's
    vote_sign_bytes_all builds them; nanos >= 2^28 keep the timestamp
    varint, and so the row, one length."""
    from cometbft_tpu_torch.libs.prefixrows import SharedPrefixRows

    block_hash = hashlib.sha256(b"block-%d" % seed).digest()
    parts = [vote_sign_bytes_parts(1_000_000 + seed, block_hash, 1_700_000_000,
                                   (1 << 28) + 1_000 * i) for i in range(n)]
    if len({p for p, _ in parts}) != 1:
        raise AssertionError("the votes of one commit must share one prefix")
    return SharedPrefixRows(parts[0][0], [s for _, s in parts])


def commit_msgs(n: int, seed: int) -> list[bytes]:
    """commit_rows as plain bytes rows."""
    return list(commit_rows(n, seed))


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
    message byte and a flipped R bit. A factored row keeps its form: a byte
    of its timestamp changes (the variable part), so it stays on the device
    challenges; a bytes row changes its last byte."""
    from cometbft_tpu_torch.libs.prefixrows import PrefixedMsg

    for j, i in enumerate(idx):
        kind = j % 3
        if kind == 0:
            s = bytearray(sigs[i])
            s[33] ^= 0x01
            sigs[i] = bytes(s)
        elif kind == 1 and isinstance(msgs[i], PrefixedMsg):
            sfx = bytearray(msgs[i].suffix)
            sfx[3] ^= 0x01
            msgs[i] = PrefixedMsg(msgs[i].prefix, bytes(sfx))
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


def time_launch(fn, reps: int = 20) -> float:
    """Median ms of `reps` launches on the card alone: each call is made
    while the card sleeps ~0.25 ms (torch.cuda._sleep) before the start
    event, so the wrapper's host work is hidden and the events bracket the
    device work it enqueued."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(500_000)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def time_host(fn, reps: int = 20) -> float:
    """Median ms of the host time of `reps` calls, unsynchronised: the
    wrapper's own cost (allocations, argument checks, the launch call)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
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


def _reset_counts() -> None:
    """Every launch count and path counter of the port set to 0."""
    from cometbft_tpu_torch.crypto import batch as crypto_batch
    from cometbft_tpu_torch.ops import challenge as CH
    from cometbft_tpu_torch.ops import integrity as IN
    from cometbft_tpu_torch.ops import verify_kernel as VK

    VK.reset_launches()
    CH.reset_launches()
    IN.reset_launches()
    crypto_batch.reset_path_stats()


def _launches() -> dict[str, int]:
    from cometbft_tpu_torch.ops import challenge as CH
    from cometbft_tpu_torch.ops import integrity as IN
    from cometbft_tpu_torch.ops import verify_kernel as VK

    return {**VK.LAUNCHES, **CH.LAUNCHES, **IN.LAUNCHES}


class Held:
    """While entered, every launch of K5 (challenge.derive) and K6
    (integrity.integrity_parts) that verify_rows makes is held against its
    plain version on the same device tensors, bit for bit (k words; header
    and payload), and the largest difference kept. Its launches are not the
    main path's: it runs outside the counted windows."""

    def __init__(self):
        self.err = {"challenge_derive": 0, "integrity_parts": 0}
        self.held = {"challenge_derive": 0, "integrity_parts": 0}

    def __enter__(self):
        from cometbft_tpu_torch.ops import challenge as CH
        from cometbft_tpu_torch.ops import integrity as IN

        self._saved = (CH.derive, IN.integrity_parts)
        derive, parts = self._saved

        def held_derive(flat, aw, ptab, bucket, var, plen, tlen, fkw=None, fidx=None):
            got = derive(flat, aw, ptab, bucket, var, plen, tlen, fkw, fidx)
            want = CH.derive_plain(flat, aw, ptab, bucket, var, plen, tlen)
            if fkw is not None:
                want.index_copy_(1, fidx.to(torch.int64), fkw)
            self._keep("challenge_derive", [got], [want])
            return got

        def held_parts(mask, allok, expected, *arrs, overlap=False):
            got = parts(mask, allok, expected, *arrs, overlap=overlap)
            self._keep("integrity_parts", got, IN.parts_plain(mask, allok, expected, *arrs))
            return got

        CH.derive, IN.integrity_parts = held_derive, held_parts
        return self

    def _keep(self, name, got, want):
        e = _max_err(got, want)
        self.err[name] = max(self.err[name], e)
        self.held[name] += 1
        if e:
            raise AssertionError(f"{name}: kernel and plain version differ by {e}")

    def __exit__(self, *exc):
        from cometbft_tpu_torch.ops import challenge as CH
        from cometbft_tpu_torch.ops import integrity as IN

        CH.derive, IN.integrity_parts = self._saved
        return False


def drive(label: str, make_verifier, keys, msgs, sigs, bad: list[int], device,
          verify_entries: list[str], decompress_entries: list[str], device_lanes: int,
          held: Held) -> dict:
    """One main path: make_verifier() -> add -> verify, cold (empty key
    table) then 5 warm runs, every count set to 0 just before and read just
    after. The mask must equal the expected one (lanes `bad` invalid, which
    the serial oracle confirms on a sample), with 0 recheck flips; each
    verify() launches each verify kernel and K6 once per scheme, K5 once
    when `device_lanes` > 0 (its device-challenge lanes a run), and no
    decoder warm. The path counters must say: every run's ed25519 lanes
    planned on the device (or none), every run's keys on the indexed path,
    the header happy without bad lanes and full with them. Then one more run
    with the kernels held against their plain versions (`held`). Returns
    wall times, the launches of the counted runs and the lanes of one warm
    verify()."""
    from cometbft_tpu_torch.crypto import batch as crypto_batch
    from cometbft_tpu_torch.libs.prefixrows import as_bytes
    from cometbft_tpu_torch.ops import verify_kernel as VK

    n = len(sigs)
    expected = [i not in bad for i in range(n)]
    schemes = len(verify_entries)

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
        if keys[i].verify_signature(as_bytes(msgs[i]), sigs[i]) != expected[i]:
            raise AssertionError(f"{label}: the serial oracle disagrees on lane {i}")

    _reset_counts()
    cold_ms = time_wall(run, 1, device)
    cold = _launches()
    cold_lanes = dict(VK.LANES)
    warm_ms = time_wall(run, 5, device)
    launches = _launches()
    paths = crypto_batch.path_stats()
    warm_lanes = {e: (VK.LANES[e] - cold_lanes[e]) // 5 for e in verify_entries}
    for e in verify_entries:
        if cold[e] != 1 or launches[e] != 6:
            raise AssertionError(f"{label}: {e} launched {cold[e]} cold, {launches[e]} in all")
    for e in decompress_entries:
        if cold[e] < 1:
            raise AssertionError(f"{label}: cold verify launched no {e}")
        if launches[e] != cold[e]:
            raise AssertionError(f"{label}: warm verify decompressed again {launches}")
    if launches["integrity_parts"] != 6 * schemes or launches["integrity_checksum"] < schemes:
        raise AssertionError(f"{label}: K6 launches {launches}")
    if launches["challenge_derive"] != (6 if device_lanes else 0):
        raise AssertionError(f"{label}: K5 launched {launches['challenge_derive']} times")
    ch = paths["challenge"]
    if ch.get("plans", 0) != (6 if device_lanes else 0) or \
            ch.get("lanes_device", 0) != 6 * device_lanes:
        raise AssertionError(f"{label}: device-challenge counters {ch}")
    if paths["sends"]["indexed"]["sigs"] != 6 * n or paths["sends"]["full"]["sigs"]:
        raise AssertionError(f"{label}: keys not on the indexed path {paths['sends']}")
    # one fetch a verify(), both schemes' headers in it: full when a lane failed
    fetch = paths["fetch"]
    if fetch["full_fetches"] != 6 * bool(bad) or fetch["happy_fetches"] != 6 * (not bad):
        raise AssertionError(f"{label}: header verdicts {fetch}")
    if paths["hash_rung"] != "native":
        raise AssertionError(f"{label}: host hash rung {paths['hash_rung']}")
    with held:
        run()
    print(f"main path {label}: {n} validators, invalid lanes {bad} found exactly "
          f"(serial oracle agrees on lanes {sample}), 0 recheck flips; launches "
          f"cold {cold}, after 5 warm {launches}; lanes per warm verify() "
          f"{warm_lanes}; paths: {ch}, sends {paths['sends']}, fetches {fetch}, hash rung "
          f"{paths['hash_rung']}; K5/K6 == plain on one more run", flush=True)
    return {"n": n, "cold_ms": cold_ms, "warm_ms": warm_ms, "launches": launches,
            "warm_lanes": warm_lanes}


def commit_cell(path: Path, n: int, seed: int, tampered: bool = True,
                factored: bool = True):
    """One scheme's commit of n validators: its sign-bytes factored
    (SharedPrefixRows.rows_for) or as bytes, and with `tampered` a few lanes
    at known indices made invalid. Returns (keys, msgs, sigs, bad)."""
    pubs, msgs, sigs = path.make_commit(n, seed)
    if factored:
        msgs = commit_rows(n, seed).rows_for(range(n))
    bad = sorted({3, n // 7, n // 3, n // 2, n - 1, (2 * n) // 3, n - 40, 11}
                 if n > 64 else {3, 11}) if tampered else []
    tamper(pubs, msgs, sigs, bad)
    return [path.pub_key(p) for p in pubs], msgs, sigs, bad


def drive_commit(path: Path, n: int, seed: int, device, label: str, held: Held,
                 tampered: bool = True, factored: bool = True) -> dict:
    """The main path of one scheme on one commit (commit_cell), through
    create_batch_verifier: factored sign-bytes take the device-challenge
    path for ed25519, bytes the classic path. Without `tampered` every lane
    must verify and ok be True."""
    from cometbft_tpu_torch.crypto import batch as crypto_batch

    keys, msgs, sigs, bad = commit_cell(path, n, seed, tampered, factored)
    name = path.scheme.name
    device_lanes = n if factored and path.scheme.device_challenge else 0
    return drive(label, lambda: crypto_batch.create_batch_verifier(keys[0]), keys,
                 msgs, sigs, bad, device, [f"{name}_verify"], [f"{name}_decompress"],
                 device_lanes, held)


def mixed_commit(paths: dict[str, Path], n: int, seed: int):
    """BASELINE config 5: a mega-commit of n validators, even indices
    ed25519 and odd indices sr25519, all signing one block (factored
    sign-bytes); tampered lanes in both schemes. Returns (keys, msgs, sigs,
    bad)."""
    rows = commit_rows(n, seed)
    msgs = rows.rows_for(range(n))
    plain = list(rows)
    ed = paths["ed25519"].make_commit(n // 2, seed, plain[0::2])
    sr = paths["sr25519"].make_commit(n // 2, seed + 1, plain[1::2])
    pubs, sigs, keys = [None] * n, [None] * n, [None] * n
    for j, (half, path) in enumerate(((ed, paths["ed25519"]), (sr, paths["sr25519"]))):
        pubs[j::2], sigs[j::2] = half[0], half[2]
        keys[j::2] = [path.pub_key(p) for p in half[0]]
    bad = sorted({3, 10, 11, n // 3, n // 2 + 1, (2 * n) // 5, n - 2, n - 1})
    tamper(pubs, msgs, sigs, bad)
    if {i % 2 for i in bad} != {0, 1}:
        raise AssertionError("the mixed commit must tamper lanes of both schemes")
    return keys, msgs, sigs, bad


def drive_mixed(paths: dict[str, Path], n: int, seed: int, device, held: Held) -> dict:
    """The mixed mega-commit through create_mixed_batch_verifier."""
    from cometbft_tpu_torch.crypto import batch as crypto_batch

    keys, msgs, sigs, bad = mixed_commit(paths, n, seed)
    return drive(f"mixed {n}", crypto_batch.create_mixed_batch_verifier, keys, msgs,
                 sigs, bad, device, ["ed25519_verify", "sr25519_verify"],
                 ["ed25519_decompress", "sr25519_decompress"], n // 2, held)


# ------------------------------------------------------------ commit phase
#
# The top of the port's main path: types/validation.verify_commit* on real
# Commits and ValidatorSets (the port's types/), through crypto.batch's
# scheduler client and the node-wide VerifyScheduler, down to K5, K1/K2 and
# K6. Equal voting power, chain CHAIN_ID, keys and nonces stepped as above,
# each validator signing the port's own vote_sign_bytes.

SEED_COMMIT = 9_000  # the commit phase's validator sets (seen nowhere else)
N_WINDOW = 16  # a blocksync window of 150-validator commits
BAD_COMMIT, BAD_IN_COMMIT = 9, 77  # the window's tampered commit and signature
N_RIDERS, RIDERS_BAD = 64, (5, 40)  # mempool rows beside a consensus commit
DEADLINE_SLACK_MS = 50  # a deadline flush must resolve within its deadline and this
BAD_SIG = 5_000  # the tampered signature of the 10,240 commit
COMMIT_PARTS = ("rows", "sched", "plan", "keys", "pack", "derive", "verify", "header", "fetch",
                "recheck")


def make_set(n: int, seed: int, kinds: str):
    """n validators of equal power (10), keys stepped from `seed`: kinds
    "ed25519", "sr25519" or "mixed" (alternate keys of each, n / 2 apiece).
    Returns (ValidatorSet, {address: (kind, a, r, R encoding, pub)})."""
    from cometbft_tpu_torch.crypto import ed25519, sr25519
    from cometbft_tpu_torch.crypto import ed25519_math as O
    from cometbft_tpu_torch.crypto import sr25519_math as srm
    from cometbft_tpu_torch.types import Validator, ValidatorSet

    secrets, vals = {}, []
    for i, (a, r, A, R) in enumerate(_stepped_points(n, np.random.default_rng(seed))):
        kind = kinds if kinds != "mixed" else ("ed25519", "sr25519")[i % 2]
        if kind == "ed25519":
            pub, renc, key = O.point_compress(A), O.point_compress(R), ed25519.PubKey(
                O.point_compress(A))
        else:
            pub, renc = srm.ristretto_encode(A), srm.ristretto_encode(R)
            key = sr25519.PubKey(pub)
        vals.append(Validator.new(key, 10))
        secrets[key.address()] = (kind, a, r, renc, pub)
    return ValidatorSet(vals), secrets


def commit_flags(n: int) -> tuple[set, set, set]:
    """The absent, NIL and off-length-timestamp indices of an n-validator
    commit: 1% each of ABSENT and NIL and six short timestamps from 1,000
    validators on, none below."""
    if n < 1_000:
        return set(), set(), set()
    return ({i for i in range(n) if i % 100 == 7}, {i for i in range(n) if i % 100 == 53},
            {11, 2_500, 5_003, 7_777, 9_001, n - 5})


def sign_commit(vals, secrets, height: int, seed: int, flags=(set(), set(), set()), bid=None):
    """A Commit of `vals` at `height` for block `seed` (or for the block ID
    `bid`), every non-absent validator signing its vote_sign_bytes (a NIL
    vote its NIL sign bytes, an off-length timestamp its own row). Returns
    (commit, block id)."""
    from cometbft_tpu_torch.crypto import ed25519_math as O
    from cometbft_tpu_torch.crypto import sr25519_math as srm
    from cometbft_tpu_torch.types import BlockID, BlockIDFlag, Commit, CommitSig, PartSetHeader
    from cometbft_tpu_torch.utils.cmttime import Timestamp

    absent, nil, off_len = flags
    if bid is None:
        block_hash = hashlib.sha256(b"commit-%d-%d" % (seed, height)).digest()
        bid = BlockID(block_hash, PartSetHeader(1, hashlib.sha256(block_hash).digest()))
    sigs = []
    for i, v in enumerate(vals.validators):
        if i in absent:
            sigs.append(CommitSig.absent())
            continue
        flag = BlockIDFlag.NIL if i in nil else BlockIDFlag.COMMIT
        nanos = 1_000 + i if i in off_len else (1 << 28) + 1_000 * i
        sigs.append(CommitSig(flag, v.address, Timestamp(1_700_000_000 + height, nanos)))
    commit = Commit(height, 0, bid, sigs)
    rows = commit.vote_sign_bytes_all(CHAIN_ID)
    sr = []
    for i, cs in enumerate(sigs):
        if i in absent:
            continue
        if cs.validator_address not in secrets:  # another scheme's validator
            continue
        kind, a, r, renc, pub = secrets[cs.validator_address]
        if kind == "ed25519":
            k = O.sha512_mod_l(renc, pub, rows[i])
            cs.signature = renc + ((r + k * a) % O.L).to_bytes(32, "little")
        else:
            sr.append((i, a, r, renc, pub))
    if sr:
        k_words = srm.batch_challenge_words([x[4] for x in sr], [x[3] for x in sr],
                                            [rows[x[0]] for x in sr])
        for (i, a, r, renc, _), kw in zip(sr, k_words):
            s = bytearray(((r + int.from_bytes(kw.tobytes(), "little") * a) % srm.L)
                          .to_bytes(32, "little"))
            s[31] |= 0x80
            sigs[i].signature = renc + bytes(s)
    return commit, bid


def with_bad_signature(commit, i: int):
    """A copy of `commit` whose signature i has one bit flipped."""
    import dataclasses

    from cometbft_tpu_torch.types import Commit

    sigs = [dataclasses.replace(cs) for cs in commit.signatures]
    s = bytearray(sigs[i].signature)
    s[40] ^= 1
    sigs[i].signature = bytes(s)
    return Commit(commit.height, commit.round_, commit.block_id, sigs)


def counted(fn, device) -> tuple[float, dict, dict, dict]:
    """fn() with every launch count and path counter set to 0 just before
    and read just after: (wall ms, launches, verify lanes, path counters:
    crypto.batch.path_stats())."""
    from cometbft_tpu_torch.crypto import batch as crypto_batch
    from cometbft_tpu_torch.ops import verify_kernel as VK

    _reset_counts()
    _sync(device)
    t0 = time.perf_counter()
    fn()
    _sync(device)
    ms = (time.perf_counter() - t0) * 1e3
    return ms, _launches(), dict(VK.LANES), crypto_batch.path_stats()


def expect_resident(label: str, paths: dict, new_block: bool = False) -> None:
    """Every key of the run was in the key table: indexed sends only, no
    delta upload, no full path. A new block's commit uploads its prefix-table
    row (a "delta" send of the prefix table, not of keys: the key tables'
    uploads launch K6's checksum, which the caller counts)."""
    sends = paths["sends"]
    if (sends["delta"]["sends"] > (1 if new_block else 0) or sends["full"]["sends"]
            or not sends["indexed"]["sends"]):
        raise AssertionError(f"{label}: keys not resident: sends {sends}")


def expect(label: str, launches: dict, want: dict) -> None:
    got = {k: launches[k] for k in want}
    if got != want:
        raise AssertionError(f"{label}: launches {got}, expected {want} (all: {launches})")


def expect_fetch(label: str, paths: dict, happy: bool, nbytes: int | None = None) -> None:
    fetch = paths["fetch"]
    ok = fetch["happy_fetches"] == int(happy) and fetch["full_fetches"] == int(not happy)
    if nbytes is not None:
        ok = ok and fetch["happy_bytes"] == nbytes
    if not ok:
        raise AssertionError(f"{label}: fetches {fetch}, expected one "
                             f"{'header-only' if happy else 'full'} fetch")


def seam_ms(rows, device, mixed: bool = False) -> float:
    """The seam of drive() on the same rows: create_batch_verifier (or
    create_mixed_batch_verifier) -> add x N -> verify(), every row valid;
    median of 5, warm."""
    from cometbft_tpu_torch.crypto import batch as crypto_batch

    pubs, msgs, sigs = rows

    def run():
        v = (crypto_batch.create_mixed_batch_verifier() if mixed
             else crypto_batch.create_batch_verifier(pubs[0]))
        for p, m, s in zip(pubs, msgs, sigs):
            v.add(p, m, s)
        if not v.verify()[0] or v.recheck_flips:
            raise AssertionError("seam: a valid row failed")

    run()
    return time_wall(run, 5, device)


def commit_rows_of(vals, commit, light: str = ""):
    """The rows _commit_rows gives verify_commit ("") or the light checks
    ("light", "trusting")."""
    from cometbft_tpu_torch.types import validation as V

    if not light:
        args = (vals.total_voting_power() * 2 // 3, V._ignore_absent, V._count_commit, True, True)
    elif light == "light":
        args = (vals.total_voting_power() * 2 // 3, V._ignore_not_commit, V._count_all, False,
                True)
    else:
        args = (vals.total_voting_power() // 3, V._ignore_not_commit, V._count_all, False, False)
    pubs, msgs, sigs, _ = V._commit_rows(CHAIN_ID, vals, commit, *args)
    return pubs, msgs, sigs


def drive_verify(label: str, call, device, want: dict, lanes: dict, held: Held,
                 cold_decoders: tuple[str, ...], nbytes: int) -> dict:
    """One commit-phase cell: call() once cold (its keys never seen: the
    decoders launch) and 5 times warm, each run counted on its own: the
    launches `want` (and no decoder warm), the verify lanes `lanes`, one
    header-only fetch of `nbytes`, every key resident (warm). Then one more
    run with K5/K6 held against their plain versions. Returns the times and
    the counts."""
    cold_ms, cold, _, paths = counted(call, device)
    expect(f"{label} cold", cold, want)
    if any(cold[d] < 1 for d in cold_decoders):
        raise AssertionError(f"{label}: the cold run decoded no key {cold}")
    expect_fetch(f"{label} cold", paths, True, nbytes)
    warm = []
    for _ in range(5):
        ms, launches, got_lanes, paths = counted(call, device)
        expect(f"{label} warm", launches, dict(want, ed25519_decompress=0, sr25519_decompress=0,
                                               integrity_checksum=0))
        if {k: got_lanes[k] for k in lanes} != lanes:
            raise AssertionError(f"{label}: verify lanes {got_lanes}, expected {lanes}")
        expect_fetch(f"{label} warm", paths, True, nbytes)
        expect_resident(f"{label} warm", paths)
        warm.append(ms)
    with held:
        call()
    return {"cold_ms": cold_ms, "warm_ms": statistics.median(warm), "cold": cold,
            "launches": launches}


def commit_parts(label: str, kind: str, call, runs: int, card: str) -> dict:
    """call() (a verify_commit) by part, median of `runs`,
    ed25519_kernel.timed_parts synchronising the card around each part:
    rows (_commit_rows), sched (the scheduler's grouping and slicing), then
    the verify path's parts."""
    from cometbft_tpu_torch.ops import ed25519_kernel as K

    got = []
    for _ in range(runs):
        got.append({})
        with K.timed_parts(got[-1]):
            call()
    parts = {k: statistics.median(r.get(k, 0.0) for r in got) for k in COMMIT_PARTS}
    print(f"[{card}] verify_commit {label} {kind} by part (ms, synchronised around each"
          f"{f', median of {runs}' if runs > 1 else ''}): "
          + ", ".join(f"{k} {parts[k]:.3f}" for k in COMMIT_PARTS)
          + f"; sum {sum(parts.values()):.3f}", flush=True)
    return parts


def commit_phase(device, card: str, held: Held) -> dict:
    """The commit phase: verify_commit of 10,240 ed25519
    validators (valid, a tampered signature, cold and warm, by part), the
    light checks on the same commit, verify_commit of a mixed 10,240 and of
    150 validators, a blocksync window of 16 150-validator commits, and the
    scheduler's mempool riders and deadline worker. Every launch count is
    asserted per run; each cell's time is printed beside the seam time of
    its own rows. Returns the records."""
    from cometbft_tpu_torch import sched
    from cometbft_tpu_torch.crypto import batch as crypto_batch
    from cometbft_tpu_torch.crypto import ed25519
    from cometbft_tpu_torch.crypto import ed25519_math as O
    from cometbft_tpu_torch.ops import ed25519_kernel as K
    from cometbft_tpu_torch.ops import residency
    from cometbft_tpu_torch.types import validation as V

    t_phase = time.perf_counter()
    sched.reset()
    ed = {"ed25519_verify": 1, "challenge_derive": 1, "integrity_parts": 1}
    out: dict = {}

    # 1. verify_commit, ed25519, 10,240 validators: first by part on a set of
    # its own (cold), then the cell's set, which the key tables then pin
    # (the newest announced set)
    flags = commit_flags(N_BIG)
    vals_b, secrets_b = make_set(N_BIG, SEED_COMMIT + 1, "ed25519")
    commit_b, bid_b = sign_commit(vals_b, secrets_b, 1_001, SEED_COMMIT + 1, flags)
    out["parts"] = {"cold": commit_parts(
        "ed25519 10k", "cold", lambda: V.verify_commit(CHAIN_ID, vals_b, bid_b, 1_001, commit_b),
        1, card)}
    vals, secrets = make_set(N_BIG, SEED_COMMIT, "ed25519")
    commit, bid = sign_commit(vals, secrets, 1_000, SEED_COMMIT, flags)
    h = commit.height
    n_rows = N_BIG - len(flags[0])
    big = drive_verify("verify_commit ed25519 10k",
                       lambda: V.verify_commit(CHAIN_ID, vals, bid, h, commit), device, ed,
                       {"ed25519_verify": K.bucket_size(n_rows)}, held, ("ed25519_decompress",),
                       8)
    big["seam_ms"] = seam_ms(commit_rows_of(vals, commit), device)
    ch = crypto_batch.path_stats()["challenge"]
    # a node verifies each height's commit once: a new Commit of the known
    # set a run (its sign rows and its block's prefix row are new), 5 runs
    fresh = [sign_commit(vals, secrets, 1_010 + j, SEED_COMMIT, flags) for j in range(5)]
    times = []
    for c, b in fresh:
        ms, launches, _, paths = counted(
            lambda: V.verify_commit(CHAIN_ID, vals, b, c.height, c), device)
        expect("verify_commit 10k new commit", launches,
               dict(ed, ed25519_decompress=0, integrity_checksum=0))
        expect_fetch("verify_commit 10k new commit", paths, True, 8)
        expect_resident("verify_commit 10k new commit", paths, new_block=True)
        times.append(ms)
    big["new_commit_ms"] = statistics.median(times)
    bad = with_bad_signature(commit, BAD_SIG)

    def tampered():
        try:
            V.verify_commit(CHAIN_ID, vals, bid, h, bad)
        except V.ErrInvalidCommitSignature as e:
            if not str(e).startswith(f"wrong signature (#{BAD_SIG})"):
                raise AssertionError(f"tampered 10k commit: {e}") from e
            return
        raise AssertionError("tampered 10k commit passed")

    bad_ms, launches, _, paths = counted(tampered, device)
    expect("verify_commit 10k tampered", launches, ed)
    expect_fetch("verify_commit 10k tampered", paths, False)
    print(f"commit phase ed25519 10k: {n_rows} signatures ({len(flags[0])} absent, "
          f"{len(flags[1])} NIL, {len(flags[2])} off-length timestamps) at "
          f"{K.bucket_size(n_rows)} lanes; valid: one K5, one K1, one K6 a run, header-only "
          f"fetch of 8 bytes (launches cold {big['cold']}, warm {big['launches']}); challenge "
          f"lanes of the last run {ch}; tampered #{BAD_SIG}: ErrInvalidCommitSignature names it, "
          f"one K1, one full fetch ({bad_ms:.3f} ms)", flush=True)
    out["parts"]["warm"] = commit_parts(
        "ed25519 10k", "warm", lambda: V.verify_commit(CHAIN_ID, vals, bid, h, commit), 5, card)
    out["ed25519 10k"] = big

    # 2. the light checks on the same commit: only the signatures they need
    light = {}
    for name, call, need in (
            ("light", lambda: V.verify_commit_light(CHAIN_ID, vals, bid, h, commit),
             vals.total_voting_power() * 2 // 3),
            ("light_trusting 1/3", lambda: V.verify_commit_light_trusting(
                CHAIN_ID, vals, commit, V.Fraction(1, 3)), vals.total_voting_power() // 3)):
        rows_before = sched.get().health()["rows_total"]
        times = []
        for _ in range(5):
            ms, launches, lanes, paths = counted(call, device)
            expect(f"verify_commit_{name}", launches,
                   dict(ed, ed25519_decompress=0, integrity_checksum=0))
            expect_fetch(f"verify_commit_{name}", paths, True, 8)
            expect_resident(f"verify_commit_{name}", paths)
            times.append(ms)
        rows = (sched.get().health()["rows_total"] - rows_before) // 5
        if rows != need // 10 + 1 or lanes["ed25519_verify"] != K.bucket_size(rows):
            raise AssertionError(f"verify_commit_{name}: {rows} rows at {lanes} lanes, "
                                 f"expected {need // 10 + 1}")
        seam = seam_ms(commit_rows_of(vals, commit, name.split()[0].replace("light_", "")),
                       device)
        light[name] = {"warm_ms": statistics.median(times), "rows": rows, "seam_ms": seam,
                       "lanes": lanes["ed25519_verify"]}
    out["light"] = light

    # 3. verify_commit, mixed 10,240 (5,120 ed25519 + 5,120 sr25519)
    vals_m, secrets_m = make_set(N_BIG, SEED_COMMIT + 2, "mixed")
    commit_m, bid_m = sign_commit(vals_m, secrets_m, 1_002, SEED_COMMIT + 2, flags)
    rows_m = commit_rows_of(vals_m, commit_m)
    per = {k: sum(p.type_() == k for p in rows_m[0]) for k in ("ed25519", "sr25519")}
    mixed = drive_verify(
        "verify_commit mixed 10k", lambda: V.verify_commit(CHAIN_ID, vals_m, bid_m, 1_002,
                                                           commit_m), device,
        dict(ed, sr25519_verify=1, integrity_parts=2),
        {"ed25519_verify": K.bucket_size(per["ed25519"]),
         "sr25519_verify": K.bucket_size(per["sr25519"])}, held,
        ("ed25519_decompress", "sr25519_decompress"), 16)
    if K.bucket_size(per["ed25519"]) != N_MIXED_BUCKET != K.bucket_size(per["sr25519"]):
        raise AssertionError(f"mixed 10k: rows per scheme {per}")
    mixed["seam_ms"] = seam_ms(rows_m, device, mixed=True)
    out["mixed 10k"] = mixed
    print(f"commit phase mixed 10k: {per} rows, one K1 + one K2 at {N_MIXED_BUCKET} lanes, two "
          f"K6, one combined header fetch of 16 bytes a run (warm {mixed['launches']})",
          flush=True)

    # 4. verify_commit, ed25519, 150 validators
    vals_c, secrets_c = make_set(N_SMALL, SEED_COMMIT + 3, "ed25519")
    commit_c, bid_c = sign_commit(vals_c, secrets_c, 1_003, SEED_COMMIT + 3)
    small = drive_verify("verify_commit ed25519 150",
                         lambda: V.verify_commit(CHAIN_ID, vals_c, bid_c, 1_003, commit_c),
                         device, ed, {"ed25519_verify": K.bucket_size(N_SMALL)}, held,
                         ("ed25519_decompress",), 8)
    small["seam_ms"] = seam_ms(commit_rows_of(vals_c, commit_c), device)
    out["ed25519 150"] = small

    # 5. a blocksync window: 16 consecutive 150-validator commits under SYNC
    vals_d, secrets_d = make_set(N_SMALL, SEED_COMMIT + 4, "ed25519")
    window = [sign_commit(vals_d, secrets_d, 2_000 + j, SEED_COMMIT + 4) for j in range(N_WINDOW)]

    def run_window(commits):
        staged = [V.stage_verify_commit(CHAIN_ID, vals_d, b, 2_000 + j, c)
                  for j, (c, b) in enumerate(commits)]
        V.resolve_staged(staged)
        return staged

    sync_before = sched.get().health()["class_rows"][sched.SYNC]
    win = drive_verify("window 16 x 150", lambda: run_window(window), device, ed,
                       {"ed25519_verify": K.bucket_size(N_WINDOW * N_SMALL)}, held,
                       ("ed25519_decompress",), 8)
    synced = sched.get().health()["class_rows"][sched.SYNC] - sync_before
    if synced != 7 * N_WINDOW * N_SMALL:  # cold, 5 warm, held
        raise AssertionError(f"window: {synced} SYNC rows")
    win_rows = [sum(r, []) for r in zip(*(commit_rows_of(vals_d, c) for c, _ in window))]
    win["seam_ms"] = seam_ms(win_rows, device)
    bad_window = list(window)
    bad_window[BAD_COMMIT] = (with_bad_signature(window[BAD_COMMIT][0], BAD_IN_COMMIT),
                              window[BAD_COMMIT][1])
    staged = [V.stage_verify_commit(CHAIN_ID, vals_d, b, 2_000 + j, c)
              for j, (c, b) in enumerate(bad_window)]

    def resolve_bad():
        try:
            V.resolve_staged(staged)
        except V.ErrInvalidCommitSignature as e:
            if not str(e).startswith(f"wrong signature (#{BAD_IN_COMMIT})"):
                raise AssertionError(f"bad window: {e}") from e
            return
        raise AssertionError("bad window passed")

    _, launches, _, paths = counted(resolve_bad, device)
    expect("bad window", launches, ed)
    expect_fetch("bad window", paths, False)
    if [s._passed for s in staged] != [True] * BAD_COMMIT + [False] * (N_WINDOW - BAD_COMMIT):
        raise AssertionError(f"bad window: not raised at commit {BAD_COMMIT} in window order")
    out["window"] = win
    print(f"commit phase window: {N_WINDOW} x {N_SMALL} = {N_WINDOW * N_SMALL} signatures, one "
          f"K5, one K1 at {K.bucket_size(N_WINDOW * N_SMALL)} lanes, one K6, one header-only "
          f"fetch a window, {synced} SYNC rows in 7 windows; a bad signature in commit "
          f"{BAD_COMMIT} raises there, the commits before it finished in window order",
          flush=True)

    # 6. the scheduler: mempool riders in a consensus drain, the deadline worker
    vals_e, secrets_e = make_set(N_RIDERS, SEED_COMMIT + 5, "ed25519")
    def valid_sig(j: int) -> bytes:
        _, a, r, renc, pub = secrets_e[vals_e.validators[j].address]
        return renc + ((r + O.sha512_mod_l(renc, pub, b"tx-%d" % j) * a) % O.L).to_bytes(
            32, "little")

    riders = []
    for j, v in enumerate(vals_e.validators):
        sig = valid_sig(j)
        if j in RIDERS_BAD:
            sig = sig[:40] + bytes([sig[40] ^ 1]) + sig[41:]
        riders.append((v.pub_key, b"tx-%d" % j, sig))
    want = [j not in RIDERS_BAD for j in range(N_RIDERS)]
    valid = [(k, m, valid_sig(j)) for j, (k, m, _) in enumerate(riders)]

    def rider_batch(rows, verdicts, split):
        futs = s.submit(rows, klass=sched.MEMPOOL)
        t0 = time.perf_counter()
        V.verify_commit(CHAIN_ID, vals_c, bid_c, 1_003, commit_c)
        # the consensus caller returns before the riders' host recheck,
        # which the deadline worker runs
        split["commit_ms"] = (time.perf_counter() - t0) * 1e3
        if [f.result(timeout=5) for f in futs] != verdicts:
            raise AssertionError("riders: wrong verdicts")
        split["futures_ms"] = (time.perf_counter() - t0) * 1e3

    # the rider keys' first sight (decode and upload) is not the cell's
    sched.reset()
    s = sched.get()
    rider_batch(valid, [True] * N_RIDERS, {})
    sched.reset()
    s = sched.get()
    gc.collect()
    rider_split: dict = {}
    rider_ms, launches, lanes, paths = counted(
        lambda: rider_batch(riders, want, rider_split), device)
    expect("riders", launches, dict(ed, ed25519_decompress=0))
    hs = s.health()
    lanes_both = K.bucket_size(N_SMALL + N_RIDERS)  # 256: one batch carries both
    if lanes["ed25519_verify"] != lanes_both or hs["batches"] != 1 or hs["worker_flushes"] or \
            hs["deferred_rechecks"] != 1 or \
            hs["class_rows"][sched.CONSENSUS] != N_SMALL or \
            hs["class_rows"][sched.MEMPOOL] != N_RIDERS or hs["lanes_total"] != lanes_both or \
            hs["frag_lanes_total"] != K.bucket_size(N_SMALL) + K.bucket_size(N_RIDERS):
        raise AssertionError(f"riders: lanes {lanes}, health {hs}")
    expect_fetch("riders", paths, False)
    # the same batch with every rider valid: nothing to recheck
    sched.reset()
    s = sched.get()
    valid_split: dict = {}
    _, launches, _, _ = counted(lambda: rider_batch(valid, [True] * N_RIDERS, valid_split),
                                device)
    expect("riders, all valid", launches, dict(ed, ed25519_decompress=0))
    if s.health()["deferred_rechecks"]:
        raise AssertionError(f"riders, all valid: {s.health()}")
    sched.reset()
    s = sched.get()
    # the deadline flushes carry valid rows only: a rejected lane's host
    # recheck (~4 ms a lane) is not the worker's latency

    def deadline_flush():
        t0 = time.perf_counter()
        futs = s.submit(valid, klass=sched.MEMPOOL)
        if not all(f.result(timeout=5) for f in futs):
            raise AssertionError("deadline flush: a valid row failed")
        return (time.perf_counter() - t0) * 1e3

    lat = []
    _, launches, _, _ = counted(lambda: lat.append(deadline_flush()), device)
    hs = s.health()
    expect("deadline flush", launches, ed)
    if hs["worker_flushes"] != 1 or \
            lat[0] > 1e3 * s.class_deadline[sched.MEMPOOL] + DEADLINE_SLACK_MS:
        raise AssertionError(f"deadline flush: {lat[0]:.3f} ms, health {hs}")
    # two more through the same worker thread (its first flush pays the
    # thread's first CUDA calls)
    lat += [deadline_flush(), deadline_flush()]
    hs = s.health()
    if hs["worker_flushes"] != 3:
        raise AssertionError(f"deadline flushes: {hs}")
    out["riders"] = {"ms": rider_ms, **rider_split, "valid_commit_ms": valid_split["commit_ms"],
                     "deadline_flush_ms": lat, "deadline_misses": hs["deadline_misses"]}
    print(f"commit phase riders: {N_RIDERS} mempool rows ({len(RIDERS_BAD)} bad) rode the "
          f"{N_SMALL}-validator consensus drain: one K1 at {lanes_both} lanes, one batch, "
          f"fragmented lanes {K.bucket_size(N_SMALL) + K.bucket_size(N_RIDERS)} vs "
          f"{lanes_both} ({rider_ms:.3f} ms from submit() to the last future); verify_commit "
          f"returned in {rider_split['commit_ms']:.3f} ms (beside {N_RIDERS} valid riders: "
          f"{valid_split['commit_ms']:.3f} ms; the commit alone, warm: {small['warm_ms']:.3f} ms), "
          f"the riders' futures, rechecked on the deadline worker, at "
          f"{rider_split['futures_ms']:.3f} ms; a mempool-only submit of the {N_RIDERS} rows, all "
          f"valid, flushed by the deadline worker (its first flush) in {lat[0]:.3f} ms, the "
          f"next two in "
          f"{lat[1]:.3f} and {lat[2]:.3f} ms from submit() to the last future (deadline 10 ms; "
          f"worker flushes {hs['worker_flushes']}, deadline misses {hs['deadline_misses']})",
          flush=True)

    sched.reset()
    residency.clear_announced()  # later phases' fresh key tables pin nothing
    for label, r in (("ed25519 10k", big), ("mixed 10k", mixed), ("ed25519 150", small),
                     ("window 16 x 150", win)):
        print(f"[{card}] verify_commit {label}: cold {r['cold_ms']:.3f} ms, warm "
              f"{r['warm_ms']:.3f} ms (median of 5); the seam on the same rows "
              f"(create_batch_verifier -> add -> verify, as drive() times it) "
              f"{r['seam_ms']:.3f} ms (median of 5)", flush=True)
    print(f"[{card}] verify_commit ed25519 10k, a new commit of the known set a run (the "
          f"per-height case): {big['new_commit_ms']:.3f} ms (median of 5)", flush=True)
    for name, r in light.items():
        print(f"[{card}] verify_commit_{name} ed25519 10k: {r['rows']} rows at {r['lanes']} "
              f"lanes, warm {r['warm_ms']:.3f} ms (median of 5); the seam on the same rows "
              f"{r['seam_ms']:.3f} ms", flush=True)
    print(f"commit phase: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return out


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


PARTS = ("plan", "keys", "pack", "derive", "verify", "header", "fetch", "recheck")


def parts_cell(path: Path, n: int, seed: int, factored: bool = True):
    """One scheme's batch of a verify() as ed25519_kernel.verify_rows takes
    it: (scheme, pubs, msgs, sigs), eight lanes tampered (two for n <= 64)."""
    pubs, msgs, sigs = path.make_commit(n, seed)
    if factored:
        msgs = commit_rows(n, seed).rows_for(range(n))
    bad = list(range(1, n, n // 8)) if n > 64 else [3, 11]
    tamper(pubs, msgs, sigs, bad)
    return path.scheme, pubs, msgs, sigs


def time_parts(label: str, cell: list, device, card: str) -> dict:
    """A verify() of `cell` (one batch per scheme, as parts_cell makes them)
    by part: cold (a fresh key cache and table: decoding and the delta
    upload in "keys") once, then warm 5 times, through
    ed25519_kernel.verify_rows(parts=...), which synchronises the card
    around each part: plan (structural checks, plan_batch), keys (key
    staging), pack (host words or block, host k, upload), derive (K5), verify
    (K1/K2), header (K6), fetch (header, and payload when not happy),
    recheck. Also the warm total without the per-part synchronisation
    (median of 5). Returns {"cold": parts, "warm": median parts, "warm_ms"}."""
    from cometbft_tpu_torch.ops import ed25519_kernel as K

    caches = [K.PubKeyCache(device, scheme) for scheme, *_ in cell]

    def run(parts):
        for cache, (scheme, pubs, msgs, sigs) in zip(caches, cell):
            K.verify_rows(scheme, pubs, msgs, sigs, cache=cache, parts=parts)

    cold: dict = {}
    run(cold)
    warm_runs = []
    for _ in range(5):
        warm_runs.append({})
        run(warm_runs[-1])
    warm = {k: statistics.median(r.get(k, 0.0) for r in warm_runs) for k in PARTS}
    warm_ms = time_wall(lambda: run(None), 5, device)
    for kind, parts in (("cold", cold), ("warm", warm)):
        total = sum(parts.values())
        print(f"[{card}] verify() {label} {kind} by part (ms, synchronised around each"
              f"{', median of 5' if kind == 'warm' else ''}): "
              + ", ".join(f"{k} {parts.get(k, 0.0):.3f}" for k in PARTS)
              + f"; sum {total:.3f}", flush=True)
    print(f"[{card}] verify() {label} warm without the per-part syncs: {warm_ms:.3f} ms "
          f"(median of 5)", flush=True)
    return {"cold": {k: cold.get(k, 0.0) for k in PARTS}, "warm": warm, "warm_ms": warm_ms}


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


# ------------------------------------------------------------- K5 and K6

# A vote row of commit_rows: a 95-byte prefix, 13 variable timestamp bytes,
# a 14-byte common tail (R || A || M = 186 bytes, two SHA-512 blocks).
VOTE_GEOMETRY = (95, 13, 14)  # plen, var, tlen
# K5's least work a lane, in 32-bit integer instructions (the integer pipe
# issues them at the IMAD rate, IMAD_PER_S), a 64-bit word being two 32-bit
# halves and sm_90's three-input LOP3 and IADD3 fused wherever they fit. A
# SHA-512 round is 28: Sigma1 and Sigma0 8 each (3 rotations of one funnel
# shift a half, one LOP3 a half for the 3-way xor), ch and maj 2 each (one
# LOP3 a half), t1 = h + Sigma1 + ch + K + W 4 (two IADD3 a half, carries
# in predicates), e = d + t1 2 and a = t1 + Sigma0 + maj 2. A schedule step
# is 20: sigma0 and sigma1 8 each (2 rotations and a shift, one LOP3 a
# half), 4 for the 4-operand sum. A block is 80 rounds, 64 steps and the 8
# feed-forward adds (16). The Barrett reduction is 40 64 x 64 -> 128-bit
# products of 8 IMADs each. The message assembly is not counted.
K5_OPS_BLOCK, K5_OPS_REDUCE = 80 * 28 + 64 * 20 + 8 * 2, 40 * 8


def _k5_bytes(lanes: int, var: int) -> int:
    """K5's bytes: R and A words and the descriptor stream in, k out, one
    prefix-table row read."""
    return lanes * (32 + 32 + 2 + var + 32) + 160


def k5_inputs(b: int, geometry: tuple[int, int, int], device, seed: int = 0, rows: int = 16):
    """A random wire block, encoding plane and prefix table of b lanes (every
    fifth lane left to the host, the rest over `rows` table rows)."""
    from cometbft_tpu_torch.ops import challenge as CH

    plen, var, tlen = geometry
    rng = np.random.default_rng(seed)
    block = rng.integers(0, 2**32, size=CH.block_words(b, var), dtype=np.uint64).astype(np.uint32)
    desc = (rng.integers(0, rows, size=b) | 0x8000).astype(np.uint16)
    desc[::5] &= 0x7FFF
    block[16 * b:].view(np.uint8)[:2 * b] = desc.view(np.uint8)
    aw = rng.integers(0, 2**32, size=(8, b), dtype=np.uint64).astype(np.uint32)
    ptab = rng.integers(0, 256, size=(CH.TABLE_ROWS, CH.PREFIX_CAP), dtype=np.uint8)
    return tuple(torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a).to(device)
                 for a in (block, aw, ptab))


def check_challenge_integrity(device) -> dict[str, int]:
    """K5's three entries and K6 against their plain versions on the card,
    bit for bit: derive at 256, 6,144 and 10,240 lanes over 16 prefix rows, the vote geometry and the one/two/three-block
    boundaries, with fallback k; the digest entry on rows of 0, 111, 112,
    186, 239 and 240 bytes; the reduction on edge values; K6's header and
    payload over one and three arrays, from raw int32 verdicts, all lanes
    valid and some failed, launched in stream order and as a programmatic
    launch, and its checksum alone. Returns the largest differences."""
    from cometbft_tpu_torch.crypto.ed25519_math import L as L_ORDER
    from cometbft_tpu_torch.ops import challenge as CH
    from cometbft_tpu_torch.ops import integrity as IN

    err = {"challenge_derive": 0, "challenge_sha512": 0, "challenge_reduce": 0,
           "integrity_parts": 0}

    def keep(name, e):
        err[name] = max(err[name], e)
        if e:
            raise AssertionError(f"{name}: kernel and plain version differ by {e}")

    for b in (256, N_MIXED_BUCKET, N_BIG):
        for geom in (VOTE_GEOMETRY, (20, 13, 14), (20, 13, 15), (100, 24, 51), (100, 24, 52),
                     (7, 24, 30), (103, 24, 50), (100, 0, 20)):
            flat, aw, ptab = k5_inputs(b, geom, device, seed=b + sum(geom))
            fidx = torch.arange(0, 40, 5, dtype=torch.int32, device=device)
            fkw = torch.randint(-2**31, 2**31, (8, 8), dtype=torch.int32, device=device)
            got = CH.derive(flat, aw, ptab, b, geom[1], geom[0], geom[2], fkw, fidx)
            want = CH.derive_plain(flat, aw, ptab, b, geom[1], geom[0], geom[2])
            want.index_copy_(1, fidx.to(torch.int64), fkw)
            keep("challenge_derive", _max_err([got], [want]))
    rng = np.random.default_rng(1)
    for ln in (0, 111, 112, 186, 239, 240):
        rows = rng.integers(0, 256, size=(N_BIG, ln), dtype=np.uint8)
        got = CH.sha512_rows_device(rows, device)
        want = CH.sha512_rows_device(rows[:512], "cpu")
        keep("challenge_sha512", int(np.abs(got[:512].astype(int) - want.astype(int)).max()))
        if [r.tobytes() for r in got[-3:]] != [hashlib.sha512(r.tobytes()).digest()
                                               for r in rows[-3:]]:
            raise AssertionError(f"challenge_sha512 at {ln} bytes differs from hashlib")
    d = rng.integers(0, 256, size=(N_BIG, 64), dtype=np.uint8)
    for i, v in enumerate((2**512 - 1, 0, L_ORDER - 1, L_ORDER, 3 * L_ORDER - 1)):
        d[i] = np.frombuffer(v.to_bytes(64, "little"), dtype=np.uint8)
    got = CH.reduce512_mod_l_device(d, device)
    want = CH.reduce512_mod_l_device(d[:512], "cpu")
    keep("challenge_reduce", int(np.abs(got[:512].astype(np.int64) - want.astype(np.int64)).max()))
    flat, aw, _ = k5_inputs(N_BIG, VOTE_GEOMETRY, device, seed=3)
    for arrs in ((flat,), (flat, aw, aw[0].contiguous())):
        for bad in ([], [5, N_BIG - 1]):
            mask = torch.ones(N_BIG, dtype=torch.int32, device=device)
            mask[bad] = 0
            allok = (mask != 0).all().to(torch.int32).reshape(1)
            expected = int(IN.checksum_plain(*arrs)) ^ (1 if bad else 0)
            for overlap in (False, True):
                keep("integrity_parts", _max_err(
                    IN.integrity_parts(mask, allok, expected, *arrs, overlap=overlap),
                    IN.parts_plain(mask, allok, expected, *arrs)))
        if IN.device_checksum(*arrs) != int(IN.checksum_plain(*arrs)):
            raise AssertionError("integrity checksum: kernel and plain version differ")
    print(f"check K5/K6: derive == plain bit for bit at 256, "
          f"{N_MIXED_BUCKET} and {N_BIG} lanes over 16 rows and 8 geometries with fallback k; "
          f"the digest entry == plain and hashlib at 6 lengths, the reduction == plain on edge "
          f"values ({N_BIG} rows); K6 header and payload == plain over 1 and 3 arrays from raw "
          f"int32 verdicts, happy, failed and mismatched, in stream order and programmatic; "
          f"its checksum alone == plain", flush=True)
    return err


# aten ops that launch nothing on the card: allocations and views
_NO_LAUNCH_OPS = {"empty.memory_format", "empty_strided.default", "view.default",
                  "select.int", "slice.Tensor", "alias.default", "_reshape_alias.default",
                  "reshape.default", "as_strided.default", "unsqueeze.default"}


def check_verify_to_header(path: Path, n: int, seed: int, device) -> list[str]:
    """One verify_rows of a tampered factored commit, every aten op it runs
    on the card recorded in order with the kernel wrappers' launches (the
    verify kernel's count, K6's launch): between the verify kernel and the
    header fetch only allocations and views may run, and K6, so nothing but
    K6 is launched there. Returns what ran between them."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from cometbft_tpu_torch.ops import ed25519_kernel as K
    from cometbft_tpu_torch.ops import integrity as IN
    from cometbft_tpu_torch.ops import verify_kernel as VK

    log: list[str] = []

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            log.append(func.overloadpacket.__name__ + "." + func._overloadname)
            return func(*args, **(kwargs or {}))

    _, pubs, msgs, sigs = parts_cell(path, n, seed)
    cache = K.PubKeyCache(device, path.scheme)
    K.verify_rows(path.scheme, pubs, msgs, sigs, cache=cache)  # the key table's first fill
    count, launch = VK._count, IN._launch

    def marked_count(entry, b):
        log.append(f"<{entry}>")
        count(entry, b)

    def marked_launch(args, dev, entry, overlap):
        log.append(f"<{entry}>")
        launch(args, dev, entry, overlap)

    VK._count, IN._launch = marked_count, marked_launch
    try:
        with Record():
            K.verify_rows(path.scheme, pubs, msgs, sigs, cache=cache)
    finally:
        VK._count, IN._launch = count, launch
    start = log.index(f"<{path.scheme.name}_verify>")
    end = next(i for i in range(start, len(log)) if log[i].startswith("_to_copy"))
    between = log[start + 1:end]
    if between.count("<integrity_parts>") != 1 or any(
            op not in _NO_LAUNCH_OPS for op in between if op != "<integrity_parts>"):
        raise AssertionError(f"{path.scheme.name}: launches between the verify kernel and the "
                             f"header fetch: {between}")
    print(f"verify path {path.scheme.name} {n}: between the verify kernel and the header fetch "
          f"only {between} (K6 alone launches)", flush=True)
    return between


def _k5_hash_only(device):
    """K5's hashing and reduction alone on the vote geometry's message: the
    standalone digest and reduction entries over 10,240 pre-padded rows of
    186 bytes (two blocks), no assembly. Returns the launch function (the
    entries' C interface is the same in every tree that has K5)."""
    from cometbft_tpu_torch.ops import challenge as CH

    plen, var, tlen = VOTE_GEOMETRY
    ln = 64 + plen + var + tlen
    nb = (ln + 17 + 127) // 128
    rows = np.random.default_rng(5).integers(0, 256, size=(N_BIG, nb * 128), dtype=np.uint8)
    rows[:, ln] = 0x80
    rows[:, ln + 1:] = 0
    rows[:, -2:] = np.frombuffer((ln * 8).to_bytes(2, "big"), dtype=np.uint8)
    buf = torch.from_numpy(rows).to(device)
    dig = torch.empty((N_BIG, 64), dtype=torch.uint8, device=device)
    out = torch.empty((N_BIG, 8), dtype=torch.int32, device=device)
    lib, stream = CH._lib(), torch.cuda.current_stream(device).cuda_stream

    def run():
        lib.challenge_sha512_rows(buf.data_ptr(), N_BIG, nb, dig.data_ptr(), stream)
        lib.challenge_reduce512(dig.data_ptr(), N_BIG, out.data_ptr(), stream)

    run()
    got = CH.reduce512_mod_l_device(dig.cpu().numpy(), "cpu")
    want = [hashlib.sha512(r[:ln].tobytes()).digest() for r in rows[:4]]
    if [r.tobytes() for r in dig[:4].cpu().numpy()] != want or \
            not np.array_equal(out.cpu().numpy().view(np.uint32), got):
        raise AssertionError("K5's standalone entries disagree with hashlib / the plain version")
    return run


def _host_steps(steps: dict) -> str:
    """Each step's host time a call (time_host, median of 20), printed."""
    return ", ".join(f"{name} {time_host(fn):.4f}" for name, fn in steps.items())


def time_k5_k6(device, card: str) -> dict:
    """K5 (derive, vote geometry) and K6 (header and payload over a
    device-challenge block) at 10,240 lanes: per launch on the card alone
    (time_launch, median of 20), back to back (mean of 50), the wrapper's
    host time a call (time_host, median of 20) and its split by step, the
    plain versions (median of 3, host clock, on the card), the bounds, and
    for K6 the library yardstick, the torch expression of the checksum alone
    (integrity.checksum_plain on the card, timed as the kernel). K5 also
    beside its hashing alone (_k5_hash_only); K6 behind K1 in stream order
    and as a programmatic launch."""
    from cometbft_tpu_torch.ops import _build
    from cometbft_tpu_torch.ops import challenge as CH
    from cometbft_tpu_torch.ops import integrity as IN

    plen, var, tlen = VOTE_GEOMETRY
    flat, aw, ptab = k5_inputs(N_BIG, VOTE_GEOMETRY, device)
    nb = (64 + plen + var + tlen + 17 + 127) // 128
    k5 = functools.partial(CH.derive, flat, aw, ptab, N_BIG, var, plen, tlen)
    k5_bound = bound(nb * K5_OPS_BLOCK + K5_OPS_REDUCE, 0, N_BIG)
    b_bytes = _k5_bytes(N_BIG, var) / HBM_BYTES_PER_S * 1e3
    if b_bytes > k5_bound[0]:
        k5_bound = (b_bytes, "bytes")
    hash_only = _k5_hash_only(device)
    hash_ms = {"ms": time_launch(hash_only), "ms_back_to_back": time_back_to_back(hash_only)}
    kw = torch.empty((8, N_BIG), dtype=torch.int32, device=device)
    lib, stream = CH._lib(), _build.raw_stream(device)
    bw = CH.block_words(N_BIG, var)

    def device_ctx():
        with torch.cuda.device(device):
            pass

    def new_ctx():
        with _build.on_device(device):
            _build.raw_stream(device)

    dev = flat.device  # the tensors' own device (with its index), as the wrapper checks
    k5_steps = {
        "checks": lambda: (CH._check("flat", flat, torch.int32, (bw,), dev),
                           CH._check("aw", aw, torch.int32, (8, N_BIG), dev),
                           CH._check("ptab", ptab, torch.uint8, (CH.TABLE_ROWS, CH.PREFIX_CAP),
                                     dev)),
        "torch.empty": lambda: torch.empty((8, N_BIG), dtype=torch.int32, device=device),
        "torch.cuda.device": device_ctx,
        "current_stream": lambda: torch.cuda.current_stream(device).cuda_stream,
        "on_device + raw_stream": new_ctx,
        "ctypes call": lambda: lib.challenge_derive(
            flat.data_ptr(), aw.data_ptr(), ptab.data_ptr(), kw.data_ptr(), N_BIG, plen, var,
            tlen, stream),
        "derive": k5}
    out = {"challenge_derive": {
        "ms": time_launch(k5), "ms_back_to_back": time_back_to_back(k5),
        "host_ms": time_host(k5),
        "plain_ms": time_wall(lambda: CH.derive_plain(flat, aw, ptab, N_BIG, var, plen, tlen),
                              3, device),
        "library_ms": None, "bound": k5_bound, "hash_only": hash_ms}}
    print(f"[{card}] challenge_derive host time a call by step (ms, median of 20): "
          f"{_host_steps(k5_steps)}", flush=True)
    print(f"[{card}] K5's hashing alone (standalone SHA-512 + reduction entries, {N_BIG} "
          f"pre-padded 186-byte rows): {hash_ms['ms']:.4f} ms alone, "
          f"{hash_ms['ms_back_to_back']:.4f} back to back", flush=True)

    mask = torch.ones(N_BIG, dtype=torch.int32, device=device)
    allok = torch.ones(1, dtype=torch.int32, device=device)
    expected = int(IN.checksum_plain(flat))
    k6 = functools.partial(IN.integrity_parts, mask, allok, expected, flat)
    words = flat.numel()
    k6_bytes = 4 * words + 4 * N_BIG + 4 + 8 + 2 * N_BIG + 1
    ops = 2 * words / IMAD_PER_S * 1e3  # a multiply-add and an add a word
    mem = k6_bytes / HBM_BYTES_PER_S * 1e3
    header = torch.empty(2, dtype=torch.int32, device=device)
    payload = torch.empty(2 * N_BIG + 1, dtype=torch.bool, device=device)
    args = IN._arrays((flat,), dev) + [mask.data_ptr(), allok.data_ptr(), N_BIG,
                                          expected, header.data_ptr(), payload.data_ptr()]
    k6_steps = {
        "checks": lambda: IN._arrays((flat,), dev),
        "2 x torch.empty": lambda: (torch.empty(2, dtype=torch.int32, device=device),
                                    torch.empty(2 * N_BIG + 1, dtype=torch.bool, device=device)),
        "scratch lookup": lambda: IN._scratch_of(device, stream),
        "torch.cuda.device": device_ctx,
        "current_stream": lambda: torch.cuda.current_stream(device).cuda_stream,
        "on_device + raw_stream": new_ctx,
        "ctypes call": lambda: IN._lib().integrity_parts(
            *args[:-2], IN._scratch_of(device, stream).data_ptr(), *args[-2:], 0, stream),
        "integrity_parts": k6}
    out["integrity_parts"] = {
        "ms": time_launch(k6), "ms_back_to_back": time_back_to_back(k6),
        "host_ms": time_host(k6),
        "plain_ms": time_wall(lambda: IN.parts_plain(mask, allok, expected, flat), 3, device),
        "library_ms": time_launch(lambda: IN.checksum_plain(flat)),
        "bound": (ops, "operations") if ops >= mem else (mem, "bytes")}
    print(f"[{card}] integrity_parts host time a call by step (ms, median of 20): "
          f"{_host_steps(k6_steps)}", flush=True)
    behind = _k6_behind_k1(device, flat, expected)
    out["integrity_parts"]["behind_k1"] = behind
    print(f"[{card}] K1 then K6 at {N_BIG} lanes, back to back (mean of 50): K6 in stream "
          f"order {behind['stream_order']:.4f} ms a pair, programmatic "
          f"{behind['programmatic']:.4f}; K1 alone {behind['k1_alone']:.4f}", flush=True)
    for name, r in out.items():
        print(f"[{card}] {name} at {N_BIG} lanes: kernel {r['ms']:.4f} ms (median of 20, "
              f"{r['bound'][0] / r['ms']:.1%} of the bound), back to back "
              f"{r['ms_back_to_back']:.4f} ms (mean of 50), wrapper host time "
              f"{r['host_ms']:.4f} ms a call, plain {r['plain_ms']:.3f} ms, "
              f"bound {r['bound'][0]:.5f} ms ({r['bound'][1]})"
              + (f", library (torch checksum expression) {r['library_ms']:.4f} ms"
                 if r["library_ms"] is not None else ""), flush=True)
    return out


def _k6_behind_k1(device, flat, expected) -> dict:
    """K1's raw verify at 10,240 lanes (untampered) followed by K6 over the
    wire block, in stream order and as a programmatic launch, each pair
    back to back (mean of 50), and K1 alone."""
    from cometbft_tpu_torch.ops import integrity as IN
    from cometbft_tpu_torch.ops import verify_kernel as VK

    pubs, msgs, sigs = _paths()["ed25519"].make_commit(N_BIG, SEED_CHECK)
    t = staged(_paths()["ed25519"], pubs, msgs, sigs, device)
    k1 = functools.partial(VK.verify_ok_raw, *t)

    def pair(overlap):
        mask, allok = k1()
        IN.integrity_parts(mask, allok, expected, flat, overlap=overlap)

    return {"stream_order": time_back_to_back(functools.partial(pair, False)),
            "programmatic": time_back_to_back(functools.partial(pair, True)),
            "k1_alone": time_back_to_back(k1)}


# ---------------------------------------------------------------- BLS phase

SEED_BLS = 12_381  # the BLS phase's keys (seen nowhere else)
BLS_BAD_SMALL, BLS_BAD_BIG = 77, BAD_SIG  # the tampered signatures of the 150 and 10k commits
BLS_CHECK_LANES = 64  # B2's messages and B4/B5's pairs in the checks
BLS_SUM_POINTS = 1_024  # B3's points in the checks
# IMADs of one 12 x 32-bit Montgomery product (csrc/fp381.cuh fp_mul: 144
# 32x32 -> 64-bit multiply-adds for a * b and 144 for m * p, two IMADs each,
# and the reduction's carries)
FP_MUL_IMADS = 590
# kernel record name -> the XLA program it replaces
BLS_RECORDS = {
    "bls_decompress_g1": "cometbft_tpu/ops/bls_kernel.py:180",
    "bls_decompress_g1_trio": "cometbft_tpu/ops/bls_kernel.py:191",
    "bls_decompress_g2": "cometbft_tpu/ops/bls_kernel.py:180",
    "bls_decompress_g2_trio": "cometbft_tpu/ops/bls_kernel.py:198",
    "bls_hash_to_g2": "cometbft_tpu/ops/bls_kernel.py:205",
    "bls_point_sum_g1": "cometbft_tpu/ops/bls12381/points.py:203",
    "bls_point_sum_g2": "cometbft_tpu/ops/bls12381/points.py:203",
    "bls_miller": "cometbft_tpu/ops/bls_kernel.py:221",
    "bls_miller_sextet": "cometbft_tpu/ops/bls_kernel.py:221",
    "bls_miller_half": "cometbft_tpu/ops/bls_kernel.py:221",
    "bls_final_exp": "cometbft_tpu/ops/bls12381/pairing.py:140",
}
# the records of the entries with more than one kernel: (entry, the
# wrapper's kernel argument that forces it, its launch count in
# bls_launch.LAUNCHES); B1's one-lane kernels and B4's one-pair kernel
# keep the record names they had as the only kernels of their entries
BLS_SPLIT = {
    "bls_decompress_g1": ("bls_decompress_g1", "lane", "bls_decompress_g1_lane"),
    "bls_decompress_g1_trio": ("bls_decompress_g1", "trio", "bls_decompress_g1_trio"),
    "bls_decompress_g2": ("bls_decompress_g2", "lane", "bls_decompress_g2_lane"),
    "bls_decompress_g2_trio": ("bls_decompress_g2", "trio", "bls_decompress_g2_trio"),
    "bls_miller": ("bls_miller", "lane", "bls_miller_lane"),
    "bls_miller_sextet": ("bls_miller", "sextet", "bls_miller_sextet"),
    "bls_miller_half": ("bls_miller", "half", "bls_miller_half"),
}


def _pow_w4_products(e: int) -> int:
    """Fp products of csrc/fp381.cuh fp_pow for the fixed e: a table of 16
    powers (14 products), then fixed 4-bit windows from the top, 4 squares a
    window and one product a non-zero digit."""
    top = (e.bit_length() - 1) & ~3
    return 14 + top + sum(1 for i in range(0, top, 4) if (e >> i) & 15)


def _gls_columns(digits: list[int]) -> tuple[int, int]:
    """(bits, non-zero columns) of a joint ladder over the first four base-x
    digits (csrc/curve381.cuh jac_mul_c; the fifth, one bit, is one more
    addition)."""
    bits = max(d.bit_length() for d in digits[:4])
    return bits, sum(1 for b in range(bits) if any((d >> b) & 1 for d in digits[:4]))


def _wnaf(k: int, w: int = 5) -> list[int]:
    """The width-w NAF of k > 0, most significant digit first."""
    out = []
    while k:
        d = 0
        if k & 1:
            d = k & ((1 << w) - 1)
            if d >= 1 << (w - 1):
                d -= 1 << w
            k -= d
        out.append(d)
        k >>= 1
    return out[::-1]


def _svdw_products() -> int:
    """Fp products of one SvdW map (csrc/curve381.cuh svdw_map): 61 around
    the root by the norm's two 4-bit-window exponentiations."""
    from cometbft_tpu_torch.crypto import bls12381_math as O

    p = O.BLS_P
    return 61 + _pow_w4_products((p + 1) // 4) + _pow_w4_products((p - 3) // 4)


def bls_fp_products() -> dict:
    """The kernels' own Fp products (12 x 32-bit Montgomery multiplications)
    a lane, counted from csrc/curve381.cuh's and group381.cuh's formulas
    (the "design" count; the bounds use bls_least_products): an Fp2
    product is 3, a square 2, an Fp6 product 18, an Fp12 product 54, a
    cyclotomic square 18 (three Fp4 squares of two Fp2 products); a G1
    doubling 8 and addition 12 products, G2 24 and 36 (RCB 2015); G2 in
    Jacobian coordinates (B2's cofactor, the G2 subgroup test) a doubling
    16 and an addition 44, psi 6; G1 in Jacobian coordinates a doubling 7
    and a mixed addition 11; a
    fixed exponent or scalar of n bits and weight w costs n squarings or
    doublings and w multiplications or additions, except fp_pow's 4-bit
    windows (_pow_w4_products); inverses and Legendre symbols are binary (no
    products; an inverse 1 to leave R^-1). Keys: g1/g2 decompression without
    the subgroup check (g2 a lane with a root: the root by the norm), sub1
    the check sigma(P) == [-x^2]P on an affine P (an [x^2] ladder of mixed
    additions, beta x, the Jacobian compare), sub2 psi(P) == [x]P (psi, an
    |x| ladder, the Jacobian compare), jac1/jac2 the move of a projective
    sum to Jacobian coordinates before it (B3), h2g (B2: two SvdW maps, the
    RCB sum, the cofactor by Budroni-Pintore (two |x| ladders, three psi,
    five additions) and [c], c = (3(x^2 - 1))^-1 mod r, by its base-x split
    over psi (a joint ladder of four 64-bit digits), to affine), add1/add2
    (a point sum's complete additions, RCB's algorithm 7) and
    add1_aff/add2_aff (its mixed ones from an affine point, algorithm 8: B3
    sums its lanes' points with these and its partials with the complete
    ones, b3_products), aff1/aff2 (a sum to affine), miller, fexp (B5 per
    check, its lanes' products not included), mul12 (one more lane in a
    check). B2's trios and B5's sextets split these products:
    bls_chain_products counts one thread's chain."""
    from cometbft_tpu_torch.crypto import bls12381_math as O
    from cometbft_tpu_torch.ops import bls_launch as BL

    p = O.BLS_P

    def nw(e):
        return e.bit_length(), bin(e).count("1")

    def ladder(dbl, add, e):
        n, w = nw(e)
        return n * dbl + w * add

    inv, f2_inv = 1, 5
    sqrt1 = _pow_w4_products((p + 1) // 4) + 1
    svdw = _svdw_products()
    # x^3 + b, the norm's Legendre symbol (its two squares), f2_sqrt_fast
    # (the norm, two 4-bit-window exponentiations, the candidate and its
    # check), the sign rule's two conversions
    root2 = 2 + _pow_w4_products((p + 1) // 4) + _pow_w4_products((p - 3) // 4) + 2 + 2
    x_ladder = ladder(16, 44, -O.BLS_X) - 16 - 44  # the top bit starts it
    x2 = O.BLS_X ** 2
    c = {"g1": 1 + 2 + sqrt1 + 1, "g2": 2 + 3 + 2 + root2 + 2,
         "sub1": ladder(7, 11, x2) - 7 - 11 + 5, "sub2": 6 + x_ladder + 22, "jac1": 3,
         "jac2": 8, "add1": 12, "add2": 36, "add1_aff": 11, "add2_aff": 33, "aff1": inv + 2,
         "aff2": f2_inv + 6}
    bits, cols = _gls_columns(BL.gls_digits(BL.cofactor_c()))
    cofactor = (2 * x_ladder + 3 * 6 + 16 + 5 * 44
                + 4 * 6 + 11 * 44 + (bits - 1) * 16 + (cols - 1) * 44 + 44)
    c["h2g"] = 4 + 2 * svdw + 36 + 8 + cofactor + 16
    xn, xw = nw(-O.BLS_X)
    # a doubling step: the Fp12 square 36, the tangent's and the doubling's
    # first products 16 (three Fp2 squares, two products, two Fp2-by-Fp) and
    # second 24, the sparse line product 42; the first step (f = 1) only the
    # 40; an addition step 18 + 22 (the chord and RCB's addition with
    # Q's Z = 1) and the line product 42
    c["miller"] = 40 + (xn - 2) * (36 + 16 + 24 + 42) + (xw - 1) * (18 + 22 + 42)
    exp_x = (xn - 1) * 18 + (xw - 1) * 54
    f12_inv = 4 * 18 + 38
    c["fexp"] = f12_inv + 54 + 18 + 54 + 5 * exp_x + 2 * 54 + 18 + 3 * 54 + 18 + 18 + 2 * 54
    c["mul12"] = 54
    return c


def bls_chain_products() -> dict:
    """Fp products on one thread's chain in the group kernels: B2 splits
    every Fp2 product three ways and runs its two SvdW maps at once; B5
    splits an Fp12 product six ways (three Fp2 products a thread) and a
    cyclotomic square six ways (one). h2g a message, fexp a check, mul12 a
    further value on one sextet (a check's T sextets take a stride each,
    then a tree). B1 G2 (g2 + sub2): every thread of the trio decompresses,
    then the psi test splits each Fp2 product or square three ways. B4
    (miller on a sextet, miller_half on a half-warp): each Miller step's
    batches deal their Fp products out six or sixteen ways, a thread taking
    the ceiling of its share. B1 G1 (g1 + sub1): every thread of the trio
    decompresses, then the sigma test's Jacobian steps run their Fp products
    in rounds of at most three, one product a thread a round (a doubling
    three rounds, a mixed addition five, the compare three). The widest
    calls run one lane a thread (bls_fp_products)."""
    from cometbft_tpu_torch.crypto import bls12381_math as O
    from cometbft_tpu_torch.ops import bls_launch as BL

    svdw = _svdw_products()
    x = -O.BLS_X
    bits, cols = _gls_columns(BL.gls_digits(BL.cofactor_c()))
    x_ladder = (x.bit_length() - 1) * 7 + (bin(x).count("1") - 1) * 16
    rounds = (2 * x_ladder + 3 * 2 + 7 + 5 * 16
              + 4 * 2 + 11 * 16 + (bits - 1) * 7 + (cols - 1) * 16 + 16)
    exp_x = (x.bit_length() - 1) * 3 + (bin(x).count("1") - 1) * 9
    fexp = 110 + 9 + 18 + 9 + 5 * exp_x + 2 * 9 + 18 + 3 * 9 + 18 + 3 + 2 * 9
    xn, xw = x.bit_length(), bin(x).count("1")
    psi_test = 2 + (xn - 1) * 7 + (xw - 1) * 16 + 8
    def miller(n):  # a thread's share of each batch of a group of n
        def share(k):
            return -(-k // n)
        return (share(16) + share(24) + (xn - 2) * (share(52) + share(24) + share(42))
                + (xw - 1) * (share(18) + share(22) + share(42)))
    x2 = x * x
    sigma_test = (x2.bit_length() - 1) * 3 + (bin(x2).count("1") - 1) * 5 + 3
    return {"h2g": 2 + svdw + 36 + 8 + rounds + 16, "fexp": fexp, "mul12": 9,
            "g1": bls_fp_products()["g1"], "sub1": sigma_test,
            "g2": bls_fp_products()["g2"], "sub2": psi_test, "miller": miller(6),
            "miller_half": miller(16)}


def _exp_products(e: int) -> int:
    """Fp products of a sliding-window exponentiation by the fixed e at its
    best window w: n - 1 squarings, one product a window but the first, and
    2^(w-1) for the odd powers."""
    bits = bin(e)[2:]
    best = None
    for w in range(1, 7):
        i = windows = 0
        while i < len(bits):
            if bits[i] == "0":
                i += 1
                continue
            j = min(i + w, len(bits))
            while bits[j - 1] == "0":
                j -= 1
            windows, i = windows + 1, j
        cost = len(bits) - 1 + windows - 1 + (1 << (w - 1) if w > 1 else 0)
        best = cost if best is None else min(best, cost)
    return best


def bls_least_products() -> dict:
    """The fewest Fp products (a squaring counted as a product) that each
    BLS kernel's function needs a lane, from the best known formulas; the
    bounds are worked out from these. Keys as bls_fp_products.
    - Fp2 product 3, square 2; Fp6 product 18; Fp12 product 54, square 36,
      cyclotomic square 18 (Granger-Scott), product by a sparse line 39.
    - An inversion 3 a lane (Montgomery's batch trick; the batch's one
      inversion is left out, a binary GCD needs no products); a Legendre
      symbol none (binary); an exponentiation by a fixed e as _exp_products.
    - Roots: Fp by (p + 1)/4 and a check; Fp2 by the norm (its root in Fp,
      then t^((p - 3)/4) for t = (a0 + s)/2: two exponentiations); is-square
      in Fp2 by the norm's Legendre symbol (the norm's two products).
    - G1 Jacobian doubling 7, mixed addition 11; G2 16, mixed 29, general 43;
      affine additions with a batched inversion 6 (G1) and 15 (G2), so a
      point sum stays affine.
    - Subgroup checks by endomorphism: G1 sigma(P) == [-x^2]P (Bowe 2019;
      the compare across Jacobian coordinates, beta x included, 5 products),
      G2 psi(P) == [x]P (Scott 2021).
    - Hash to G2: two SvdW maps (RFC 9380 F.1 straight line), one affine
      addition, cofactor clearing, to affine. The cofactor is the oracle's
      h2 = #E'(Fp2) / r (crypto/bls12381_math.py _bls_setup), and RFC 9380's
      h_eff = 3(x^2 - 1) h2, so Budroni-Pintore's psi formula (two |x|
      ladders) alone gives a different point. Counted: the fewer of (a)
      Budroni-Pintore, then [c], c = (3(x^2 - 1))^-1 mod r, on the G2 point
      by a GLS split (psi acts as [x] on G2; c's base-x digits: a joint
      table of the 15 sums of the four 64-bit ones normalised by one batched
      inversion, one doubling a bit and one mixed addition a non-zero
      column, one more for the last digit, a bit) and (b) a width-5 NAF
      ladder of h2 with a normalised table (mixed additions).
    - Miller loop over |x| (64 bits, weight 6): 63 doubling steps with their
      line (25, Aranha et al. 2011) and 5 addition steps (41), a sparse line
      product each (39), an Fp12 square each (36); the first step starts
      from f = 1 (no square, no product). Aranha's formulas scale each line
      otherwise than the plain version (and its T): they compute another
      Miller value, equal only after the final exponentiation. miller_floor:
      the least known that keeps the plain scalings, RCB's T and the plain
      sparse slots (c0, v w, v^2 w; their product by f is 42, not the
      39 of Aranha's slots), which is the kernel's own count (the tangent
      and the doubling 40 a step, sharing Y^2 and Y Z).
    - Final exponentiation by the reference's chain (the cubed pairing):
      the easy part (an Fp12 inversion 100, two products, a p^2 Frobenius
      10), the hard part: five cyclotomic powers by |x| or |x| + 1, five
      products, Frobenius maps 15 and 10, one cyclotomic square."""
    from cometbft_tpu_torch.crypto import bls12381_math as O
    from cometbft_tpu_torch.ops import bls_launch as BL

    p, x, r = O.BLS_P, -O.BLS_X, O.BLS_R
    h2 = O._bls_setup()["h2"]

    def ladder(dbl, add, e):
        return (e.bit_length() - 1) * dbl + (bin(e).count("1") - 1) * add

    e_sqrt, e_isq = (_exp_products(e) for e in ((p + 1) // 4, (p - 3) // 4))
    sqrt2 = 2 + e_sqrt + 1 + e_isq + 6
    svdw = 49 + 2 * 2 + sqrt2
    # (a) Budroni-Pintore, then [c] by GLS over psi
    bp = ladder(16, 29, x) + ladder(16, 43, x) + 6 + 4 + 16 + 3 * 29 + 2 * 43
    digits = BL.gls_digits(BL.cofactor_c())
    bits, cols = _gls_columns(digits)
    gls = (6 * (len(digits) - 1) + 11 * 43 + (9 + 8) * 15 + (bits - 1) * 16
           + (cols - 1) * 29 + (len(digits) - 4) * 29)
    # (b) the NAF ladder of h2, its 8 odd multiples normalised
    naf = _wnaf(h2)
    windowed = (16 + 7 * 43 + 3 * 3 * 8 + 8 * 8 + (len(naf) - 1) * 16
                + (sum(1 for d in naf if d) - 1) * 29)
    cofactor = min(bp + gls, windowed)
    n, w = x.bit_length(), bin(x).count("1")
    return {"g1": 2 + e_sqrt + 1, "g2": 5 + sqrt2,
            "sub1": ladder(7, 11, x * x) + 5, "sub2": ladder(16, 29, x) + 6 + 11,
            "add1": 6, "add2": 15, "aff1": 0, "aff2": 0,
            "h2g": 2 * svdw + 15 + cofactor + 18,
            "miller": (n - 1) * (25 + 39 + 36) - (36 + 39) + (w - 1) * (41 + 39),
            "miller_floor": 40 + (n - 2) * (40 + 42 + 36) + (w - 1) * (40 + 42),
            "fexp": (100 + 54 + 10 + 54 + 2 * ladder(18, 54, x + 1) + 3 * ladder(18, 54, x)
                     + 5 * 54 + 15 + 10 + 18),
            "mul12": 54}


def _sizes(starts: torch.Tensor) -> np.ndarray:
    return np.diff(starts.cpu().numpy().astype(np.int64))


SUM_THREADS = 64  # csrc/bls12381.cu: B3's threads a block


def _b3_block(n: int) -> tuple[int, int, int]:
    """One B3 block over n points or partials, a stride a thread, then a tree:
    (additions in series on its longest thread, the tree's levels, the
    additions made before the tree)."""
    if n <= 0:
        return 0, 0, 0
    active = min(n, SUM_THREADS)
    return -(-n // SUM_THREADS) - 1, (active - 1).bit_length(), n - active


def b3_products(g: int, sizes, slices: int, check: bool, c: dict, chain: bool = False) -> int:
    """B3's Fp products on a call of groups of `sizes` points with `slices`
    slices a group (launch_shape's; 1: a block a group alone) under the
    kernels' own counts c (bls_fp_products): each lane's point after a
    thread's first by a mixed addition, the rest (trees, partials) by
    complete ones, then the tail. With chain=True the longest group's
    critical path instead: a block's longest thread, its tree, phase 2's,
    and the tail, in which the sum's move to affine (warp 1) runs beside the
    check (warp 0; G2's on a trio, bls_chain_products' sub2)."""
    add, mixed = c[f"add{g}"], c[f"add{g}_aff"]
    sub = (c[f"jac{g}"] + (bls_chain_products()["sub2"] if chain and g == 2 else c[f"sub{g}"])
           if check else 0)
    total = longest = 0
    for n in (int(v) for v in sizes):
        ns = [n * (k + 1) // slices - n * k // slices for k in range(slices)] if slices > 1 else [n]
        blocks = [_b3_block(m) for m in ns]
        path = max(serial * mixed + levels * add for serial, levels, _ in blocks)
        work = sum(pre * mixed + max(min(m, SUM_THREADS) - 1, 0) * add
                   for (_, _, pre), m in zip(blocks, ns))
        if slices > 1:
            serial, levels, _ = _b3_block(slices)
            path += (serial + levels) * add
            work += (slices - 1) * add
        longest = max(longest, path + max(c[f"aff{g}"], sub))
        total += work + c[f"aff{g}"] + sub
    return longest if chain else total


def bls_call_products(name: str, args: tuple, c: dict, slices: int | None = None) -> int:
    """Fp products of one call of the BLS entry `name` on `args` (its
    wrapper's arguments) under the per-lane counts c; for B3 with `slices`
    (launch_shape's), the kernels' own way of summing (b3_products), else
    every addition at c's add count."""
    if name.startswith("bls_decompress"):
        g, x_raw, _, check = args
        return x_raw.shape[-1] * (c[f"g{g}"] + int(check) * c[f"sub{g}"])
    if name == "bls_hash_to_g2":
        return args[0].shape[-1] * c["h2g"]
    if name.startswith("bls_point_sum"):
        g, _, _, starts, check = args
        sizes = _sizes(starts)
        if slices is not None:
            return b3_products(g, sizes, slices, bool(check), c)
        return int((np.maximum(sizes, 1) - 1).sum()) * c[f"add{g}"] + len(sizes) * (
            c[f"aff{g}"] + int(check) * (c[f"sub{g}"] + c.get(f"jac{g}", 0)))
    if name.startswith("bls_miller"):
        return args[0].shape[-1] * c["miller"]
    sizes = _sizes(args[2])  # bls_final_exp
    return int((np.maximum(sizes, 1) - 1).sum()) * c["mul12"] + len(sizes) * c["fexp"]


def bls_bound(products: int, nbytes: int) -> tuple[float, str]:
    """Least ms for `products` Fp products at the IMAD peak or `nbytes` at
    the HBM rate, the larger."""
    ops = products * FP_MUL_IMADS / IMAD_PER_S * 1e3
    mem = nbytes / HBM_BYTES_PER_S * 1e3
    return (ops, "operations") if ops >= mem else (mem, "bytes")


def _bls_sign_many(items: list[tuple[int, bytes]]) -> list[bytes]:
    """bls_sign of (secret, message) pairs on every core (a spawned process
    pool: the oracle's pairing-free signing is pure Python)."""
    import multiprocessing

    from cometbft_tpu_torch.crypto import bls12381
    from cometbft_tpu_torch.crypto import bls12381_math as O

    if not items:
        return []
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(min(8, len(items)), mp_context=ctx) as pool:
        return list(pool.map(O.bls_sign, [k for k, _ in items], [m for _, m in items],
                             [bls12381.DST] * len(items), chunksize=4))


def _bls_cached_sigs(tag: str, items: list[tuple[int, bytes]]) -> list[bytes]:
    """_bls_sign_many, cached under build/ by tag (the seed and sizes): the
    file holds the signed (secret, message, signature) rows and is used only
    where they match."""
    import pathlib

    path = pathlib.Path(__file__).resolve().parent / "build" / f"chip_smoke_bls_{tag}.json"
    want = [[str(k), m.hex()] for k, m in items]
    if path.exists():
        try:
            got = json.loads(path.read_text())
            if [r[:2] for r in got] == want:
                return [bytes.fromhex(r[2]) for r in got]
        except (ValueError, IndexError):
            pass
    sigs = _bls_sign_many(items)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps([w + [s.hex()] for w, s in zip(want, sigs)]))
    return sigs


def _bls_stepped(n: int, seed: int):
    """Secrets sk_i = sk0 + i and their compressed pubkeys, stepped by
    adding g1 (one point addition a validator)."""
    from cometbft_tpu_torch.crypto import bls12381_math as O

    sk0 = int.from_bytes(hashlib.sha256(b"bls-%d" % seed).digest(), "big") % (O.BLS_R - n) + 1
    g1 = O._ec_from_affine(O.BLS_G1)
    pt = O._ec_mul(O._FpOps, sk0, g1)
    out = []
    for i in range(n):
        if i:
            pt = O._ec_add(O._FpOps, pt, g1)
        out.append((sk0 + i, O.bls_g1_compress(O._ec_affine(O._FpOps, pt))))
    return out


def bls_set(n: int, seed: int, extra: list | None = None):
    """n bls12381 validators of equal power (stepped secrets), plus the
    `extra` Validators: (ValidatorSet, {address: secret})."""
    from cometbft_tpu_torch.crypto import bls12381
    from cometbft_tpu_torch.types import Validator, ValidatorSet

    secrets, vals = {}, list(extra or [])
    for sk, pub in _bls_stepped(n, seed):
        key = bls12381.PubKey(pub)
        vals.append(Validator.new(key, 10))
        secrets[key.address()] = sk
    return ValidatorSet(vals), secrets


def bls_commit(vals, bls_secrets, height: int, seed: int, shared_ts: bool,
               ed_sr_secrets: dict | None = None, bid=None):
    """A Commit of `vals` (for block `seed`, or for the block ID `bid`): the
    ed25519/sr25519 validators sign as sign_commit does, the bls12381
    validators with their secrets. With
    shared_ts every vote carries one timestamp, so the sign-bytes are one
    message (D = 1); otherwise each its own (D = n), signed on every core
    and cached under build/. With shared_ts the signatures are stepped:
    sig_i = sig_{i-1} + H(m) for sk_i = sk_{i-1} + 1."""
    from cometbft_tpu_torch.crypto import bls12381
    from cometbft_tpu_torch.crypto import bls12381_math as O
    from cometbft_tpu_torch.types import BlockID, BlockIDFlag, Commit, CommitSig, PartSetHeader
    from cometbft_tpu_torch.utils.cmttime import Timestamp

    if ed_sr_secrets:
        commit, bid = sign_commit(vals, ed_sr_secrets, height, seed, bid=bid)
    else:
        if bid is None:
            block_hash = hashlib.sha256(b"commit-%d-%d" % (seed, height)).digest()
            bid = BlockID(block_hash, PartSetHeader(1, hashlib.sha256(block_hash).digest()))
        commit = Commit(height, 0, bid, [
            CommitSig(BlockIDFlag.COMMIT, v.address,
                      Timestamp(1_700_000_000 + height, 0 if shared_ts else (1 << 28) + 1_000 * i))
            for i, v in enumerate(vals.validators)])
    rows = commit.vote_sign_bytes_all(CHAIN_ID)
    idx = [i for i, cs in enumerate(commit.signatures) if cs.validator_address in bls_secrets]
    if shared_ts:
        msg = rows[idx[0]]
        h = O._ec_from_affine(O.bls_hash_to_g2(msg, bls12381.DST))
        sk_of = {bls_secrets[commit.signatures[i].validator_address]: i for i in idx}
        sk0 = min(sk_of)
        acc = O._ec_mul(O._Fp2Ops, sk0, h)
        for k in range(len(idx)):
            if k:
                acc = O._ec_add(O._Fp2Ops, acc, h)
            commit.signatures[sk_of[sk0 + k]].signature = O.bls_g2_compress(
                O._ec_affine(O._Fp2Ops, acc))
    else:
        items = [(bls_secrets[commit.signatures[i].validator_address], rows[i]) for i in idx]
        sigs = _bls_cached_sigs(f"{seed}_{height}_{len(idx)}", items)
        for i, s in zip(idx, sigs):
            commit.signatures[i].signature = s
    return commit, bid


def _bls_x_planes(encs: list[bytes], device):
    """Compressed encodings -> (raw x planes, sign flags) on the card, as
    bls_kernel stages them."""
    from cometbft_tpu_torch.ops import bls_kernel as BK

    rows = np.stack([np.frombuffer(e, np.uint8) for e in encs])
    x, sign = BK._x_planes(rows)
    return (torch.from_numpy(np.ascontiguousarray(x)).to(device),
            torch.from_numpy(sign).to(device))


def _bls_points(g: int, n: int, seed: int) -> list:
    """n affine points of G1 or G2, stepped from a seeded multiple of the
    generator by adding the generator."""
    from cometbft_tpu_torch.crypto import bls12381_math as O

    F = O._FpOps if g == 1 else O._Fp2Ops
    gen = O._ec_from_affine(O.BLS_G1 if g == 1 else O.BLS_G2)
    pt = O._ec_mul(F, seed, gen)
    out = []
    for i in range(n):
        if i:
            pt = O._ec_add(F, pt, gen)
        out.append(O._ec_affine(F, pt))
    return out


def _bls_coords(g: int, affs: list) -> list[list[int]]:
    if g == 1:
        return [[a[0] for a in affs], [a[1] for a in affs]]
    return [[a[k][j] for a in affs] for k in (0, 1) for j in (0, 1)]


BLS_H1 = 0x396c8c005555e1568c00aaab0000aaab  # the G1 cofactor, 3 11^2 10177^2 859267^2 52437899^2


def bls_g1_torsion(seed: int = SEED_BLS) -> list:
    """Points of E(Fp) outside G1: (0, 2) of order 3; points of order 11,
    10177 and 859267 ([h1 r / l^2]R of seeded random points R: l^2 divides
    h1 and that part of E(Fp) has exponent l); [r]R (its order all in h1's
    part); each of those plus a G1 point."""
    from cometbft_tpu_torch.crypto import bls12381_math as O

    p, F = O.BLS_P, O._FpOps
    rng = np.random.default_rng(seed)

    def mul(k, a):
        return O._ec_affine(F, O._ec_mul(F, k, O._ec_from_affine(a)))

    def curve_point():
        while True:
            x = int.from_bytes(rng.bytes(48), "big") % p
            t = (x ** 3 + 4) % p
            y = pow(t, (p + 1) // 4, p)
            if y * y % p == t:
                return x, y

    tors = [(0, 2)]
    for ell in (11, 10177, 859267):
        while True:
            t = mul(BLS_H1 * O.BLS_R // (ell * ell), curve_point())
            if t is not None:
                break
        if mul(ell, t) is not None:
            raise AssertionError(f"BLS checks: a point of order {ell} expected")
        tors.append(t)
    tors.append(mul(O.BLS_R, curve_point()))
    gen = O._ec_from_affine(O.BLS_G1)
    return tors + [O._ec_affine(F, O._ec_add(F, O._ec_from_affine(t), gen)) for t in tors]


class BlsHeld:
    """Kernel against plain version on the same card tensors: values by
    canonical value, flags bit for bit; the largest difference kept per
    entry."""

    def __init__(self):
        self.err: dict[str, int] = {}

    def hold(self, name: str, got: tuple, want_fn) -> tuple[tuple, float]:
        """(the plain version's outputs, its wall ms)."""
        from cometbft_tpu_torch.ops import bls_launch as BL

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = want_fn()
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        bad = 0
        for g, w in zip(got, want):
            if g.dim() == 2:  # planes: canonical values
                bad += sum(a != b for gc, wc in zip(BL.values(g), BL.values(w))
                           for a, b in zip(gc, wc))
            else:  # flags
                bad += int((g.to(torch.int64) != w.to(torch.int64)).sum())
        self.err[name] = max(self.err.get(name, 0), bad)
        if bad:
            raise AssertionError(f"{name}: kernel and plain version differ in {bad} values")
        return want, plain_ms


class BlsRecorder:
    """Records every BLS kernel call made under it: the kernel (B1 G2's and
    B4's by which of their two kernels ran), the entry, its arguments and
    its outputs, copied on the card, so that the main path's own calls can
    be held against their plain versions and timed."""

    ENTRIES = ("decompress", "hash_to_g2", "point_sum", "miller", "final_exp")

    def __init__(self):
        self.calls: list[tuple[str, str, tuple, tuple]] = []

    def __enter__(self):
        from cometbft_tpu_torch.ops import bls_launch as BL

        self._saved = {n: getattr(BL, n) for n in self.ENTRIES}
        for n, fn in self._saved.items():
            setattr(BL, n, self._wrap(n, fn))
        return self

    def __exit__(self, *exc):
        from cometbft_tpu_torch.ops import bls_launch as BL

        for n, fn in self._saved.items():
            setattr(BL, n, fn)

    def _wrap(self, n, fn):
        def copy(t):
            return t.clone() if isinstance(t, torch.Tensor) else t

        def run(*args):
            from cometbft_tpu_torch.ops import bls_launch as BL

            before = dict(BL.LAUNCHES)
            out = fn(*args)
            key = f"bls_{n}_g{args[0]}" if n in ("decompress", "point_sum") else f"bls_{n}"
            for group_key in ("bls_decompress_g1_trio", "bls_decompress_g2_trio",
                              "bls_miller_sextet", "bls_miller_half"):
                if BL.LAUNCHES[group_key] > before[group_key]:
                    key = group_key
            outs = out if isinstance(out, tuple) else (out,)
            self.calls.append((key, n, tuple(copy(a) for a in args),
                               tuple(copy(o) for o in outs)))
            return out
        return run


def _bls_call_shape(n: str, args: tuple) -> str:
    if n in ("decompress", "point_sum"):
        lanes = args[1].shape[-1]
    else:
        lanes = args[0].shape[-1]
    if n == "point_sum":
        return f"{lanes} points in {args[3].shape[0] - 1} groups"
    if n == "final_exp":
        return f"{lanes} Miller values in {args[2].shape[0] - 1} checks"
    return f"{lanes} lanes" + (f", subgroup check {bool(args[3])}" if n == "decompress" else "")


def hold_recorded(calls: list, held: BlsHeld, card: str) -> list[dict]:
    """Each recorded call's outputs against the plain version on the same
    card tensors. Returns one entry a call: key, entry, args, the plain
    version's ms."""
    from cometbft_tpu_torch.ops import bls_launch as BL

    def plain(n, args):
        want = getattr(BL, f"{n}_plain")(*args)
        return want if isinstance(want, tuple) else (want,)

    out = []
    for key, n, args, outs in calls:
        _, plain_ms = held.hold(key, outs, lambda: plain(n, args))
        print(f"[{card}] {key} held on the main path's own call ({_bls_call_shape(n, args)}): "
              f"equal to its plain version ({plain_ms:.1f} ms)", flush=True)
        out.append({"key": key, "entry": n, "args": args, "outs": outs, "plain_ms": plain_ms})
    return out


def check_bls(device, held: BlsHeld, card: str = "") -> None:
    """B1-B5 against their plain versions on the card, on inputs whose first
    lanes are edge cases: B1 (G1 and G2, with and without the subgroup
    check) on a key staged in place of an x >= p (the generator), an x with
    no square root, points on the curves outside G1/G2 (G1: components of
    order 3, 11, 10177 and 859267 and [r]R, alone and plus a G1 point) and
    both sign bits, each group on its trio and its one-lane kernel, on those
    lanes and on the lane count where the crossover takes one lane a
    thread; B2 on 64
    messages with the empty one, and on one message alone (one trio); B3
    (G1, and G2 with the subgroup check) on 1,024 points in 3 uneven groups,
    a group summing to infinity and (G2) a group whose sum lies outside G2,
    and on one group of 10,240 of them (repeated, a duplicate pair and a
    cancelling pair in blocks far apart) split over blocks and on one block;
    B4 and B5 on 64 pairs, 32 checks, half of them products equal to one, B4
    on its half-warp, sextet and one-pair kernels each, on those pairs and
    on the pair counts of its two crossovers; B5 on one check of 151 of those values
    (ten trios and their tree) and on checks whose product is zero or one,
    forced or not. Prints the launch shapes and the group kernels'
    crossovers."""
    from cometbft_tpu_torch.crypto import bls12381
    from cometbft_tpu_torch.crypto import bls12381_math as O
    from cometbft_tpu_torch.ops import bls_kernel as BK
    from cometbft_tpu_torch.ops import bls_launch as BL
    from cometbft_tpu_torch.ops.bls12381 import htc

    p = O.BLS_P
    # B1
    g1 = _bls_points(1, 6, 3)
    g1.append((g1[0][0], p - g1[0][1]))
    g2 = _bls_points(2, 6, 5)
    g2.append((g2[0][0], O.f2_neg(g2[0][1])))
    x_bad = p.to_bytes(48, "big")
    tors = bls_g1_torsion()
    e1 = [bytes([x_bad[0] | 0x80]) + x_bad[1:]] + [O.bls_g1_compress(a) for a in tors]
    e1 += [O.bls_g1_compress(a) for a in g1]
    e2 = [bytes([x_bad[0] | 0x80]) + x_bad[1:] + bytes(48),
          O.bls_g2_compress(O._svdw_map_fp2((3, 4), O._bls_setup()["svdw"]))]
    e2 += [O.bls_g2_compress(a) for a in g2]
    rng = np.random.default_rng(SEED_BLS)
    while True:  # an x with no root on G1, one on G2
        x = int.from_bytes(rng.bytes(47), "big")
        if pow((x ** 3 + 4) % p, (p - 1) // 2, p) == p - 1:
            e1.append(bytes([0x80]) + x.to_bytes(48, "big")[1:])
            break
    while True:
        x = (int.from_bytes(rng.bytes(47), "big"), int.from_bytes(rng.bytes(47), "big"))
        if not O.f2_legendre_is_square(O.f2_add(O.f2_mul(O.f2_sq(x), x), O._B2)):
            e2.append(bytes([0x80]) + x[1].to_bytes(48, "big")[1:] + x[0].to_bytes(48, "big"))
            break
    pre1, rows1, _ = BK._structural_check(e1, [BK._G2_GEN_ENC] * len(e1), len(e1))
    pre2, _, rows2 = BK._structural_check([BK._G1_GEN_ENC] * len(e2), e2, len(e2))
    if pre1[0] or pre2[0] or not pre1[1:].all() or not pre2[1:].all():
        raise AssertionError("BLS checks: the x >= p lane must be, and only it, a host reject")
    for g, rows in ((1, rows1), (2, rows2)):
        x, sign = _bls_x_planes([r.tobytes() for r in rows], device)
        if len(set(sign.tolist())) != 2:
            raise AssertionError("BLS checks: B1's lanes must carry both sign bits")
        for check in (True, False):
            for kernel in (None, "trio", "lane"):
                trios = BL.LAUNCHES[f"bls_decompress_g{g}_trio"]
                got = BL.decompress(g, x, sign, check, kernel=kernel)
                key = f"bls_decompress_g{g}" + (
                    "_trio" if BL.LAUNCHES[f"bls_decompress_g{g}_trio"] > trios else "")
                held.hold(key, got, lambda: BL.decompress_plain(g, x, sign, check))
                want_ok = [1] * (len(rows) - 1) + [0]
                if check:  # on the curve, outside the subgroup
                    want_ok[1:1 + (len(tors) if g == 1 else 1)] = [0] * (len(tors) if g == 1
                                                                         else 1)
                if got[0].tolist() != want_ok:
                    raise AssertionError(f"B1 g{g} check={check} {kernel}: ok {got[0].tolist()}")
    # B1 at its crossovers: the edge lanes repeated, both kernels
    cross = {}
    for g, rows in ((1, rows1), (2, rows2)):
        n1 = cross[g] = _bls_crossover(f"bls_decompress_g{g}", device,
                                       lambda s: s["lane_kernel"])
        x, sign = _bls_x_planes([rows[k % len(rows)].tobytes() for k in range(n1)], device)
        for kernel in (None, "trio"):
            got = BL.decompress(g, x, sign, True, kernel=kernel)
            held.hold(f"bls_decompress_g{g}" + ("_trio" if kernel else ""), got,
                      lambda: BL.decompress_plain(g, x, sign, True))
        print(f"  B1 G{g} held on both kernels at {len(rows)} lanes and at its crossover, {n1} "
              f"lanes (one lane a thread; a trio a lane below)", flush=True)
    n1 = cross[2]
    # B2
    msgs = [b""] + [b"bls-check-%d" % i for i in range(BLS_CHECK_LANES - 1)]
    u = torch.from_numpy(np.stack(htc.hash_to_field_limbs(msgs, bls12381.DST))).to(device)
    h, hid = BL.hash_to_g2(u)
    held.hold("bls_hash_to_g2", (h, hid), lambda: BL.hash_to_g2_plain(u))
    hv = BL.values(h)
    if ((hv[0][0], hv[1][0]), (hv[2][0], hv[3][0])) != O.bls_hash_to_g2(b"", bls12381.DST):
        raise AssertionError("B2: H(empty message) differs from the oracle")
    u1 = u[..., 1:2].contiguous()
    got = BL.hash_to_g2(u1)
    held.hold("bls_hash_to_g2", got, lambda: BL.hash_to_g2_plain(u1))
    if [v[0] for v in BL.values(got[0])] != [v[1] for v in hv]:
        raise AssertionError("B2: one message alone differs from the same message among 64")
    # B3: groups of 1000, 19 and 3 points, one of P, -P and (G2) one of a
    # G2 point and a twist point outside G2 (its sum outside G2)
    off_g2 = O._svdw_map_fp2((3, 4), O._bls_setup()["svdw"])
    for g in (1, 2):
        affs = _bls_points(g, BLS_SUM_POINTS - 2, 7 + g)
        neg = (affs[0][0], p - affs[0][1]) if g == 1 else (affs[0][0], O.f2_neg(affs[0][1]))
        affs = affs + [affs[0], neg] + ([off_g2] if g == 2 else [])
        sizes = [1000, 19, 3]
        extra = [[BLS_SUM_POINTS - 2, BLS_SUM_POINTS - 1]] + ([[1, BLS_SUM_POINTS]] if g == 2
                                                                else [])
        order = np.concatenate([rng.permutation(sum(sizes))] + extra)
        starts = np.cumsum([0] + sizes + [2] * len(extra))
        order_t = torch.from_numpy(order.astype(np.int32)).to(device)
        starts_t = torch.from_numpy(starts.astype(np.int32)).to(device)
        planes = BL.planes_of_ints(_bls_coords(g, affs), device)
        got = BL.point_sum(g, planes, order_t, starts_t, g == 2)
        held.hold(f"bls_point_sum_g{g}", got,
                  lambda: BL.point_sum_plain(g, planes, order_t, starts_t, g == 2))
        if got[1].tolist() != [0, 0, 0, 1] + [0] * (g - 1) or got[2].tolist() != (
                [1, 1, 1, 1, 0] if g == 2 else [1, 1, 1, 1]):
            raise AssertionError(f"B3 g{g}: identity flags {got[1].tolist()}, subgroup "
                                 f"{got[2].tolist()}")
        # one group of N_BIG points (the 10k commit's shape: phase 1 over
        # many blocks) from 1,022 distinct ones repeated, a duplicate pair and
        # a cancelling pair in blocks far apart; then the same group on one
        # block alone
        big = [k % (BLS_SUM_POINTS - 2) for k in range(N_BIG)]
        big[5], big[N_BIG - 5] = 3, 3
        big[7], big[N_BIG - 7] = 0, BLS_SUM_POINTS - 1  # P and -P
        order_b = torch.tensor(big, dtype=torch.int32, device=device)
        starts_b = torch.tensor([0, N_BIG], dtype=torch.int32, device=device)
        want_b = BL.point_sum_plain(g, planes, order_b, starts_b, True)
        for kernel in (None, "short"):
            split = BL.LAUNCHES[f"bls_point_sum_g{g}_split"]
            got = BL.point_sum(g, planes, order_b, starts_b, True, kernel=kernel)
            if (BL.LAUNCHES[f"bls_point_sum_g{g}_split"] > split) != (kernel is None):
                raise AssertionError(f"B3 g{g} on {N_BIG} points ({kernel}): phase 1 "
                                     f"{'did not run' if kernel is None else 'ran'}")
            held.hold(f"bls_point_sum_g{g}", got, lambda: want_b)
            if got[1].tolist() != [0] or got[2].tolist() != [1]:
                raise AssertionError(f"B3 g{g} on {N_BIG} points: identity flag "
                                     f"{got[1].tolist()}, subgroup {got[2].tolist()}")
    print(f"  B3 held on 1,000/19/3/2-point groups and on one group of {N_BIG} points split "
          f"over {BL.launch_shape('bls_point_sum_g2', 1, device, N_BIG)['part_blocks']} "
          f"blocks and on one block", flush=True)
    # B4/B5: checks c < 16 pair (P, Q) with (-P, Q): one; the others (P, Q)
    # with (P, Q'): not one
    n = BLS_CHECK_LANES
    p_aff, q_aff = [], []
    for c, a in enumerate(_bls_points(1, n // 2, 11)):
        one = c < n // 4
        p_aff += [a, (a[0], p - a[1]) if one else a]
        q_aff += [((hv[0][k], hv[1][k]), (hv[2][k], hv[3][k]))
                  for k in ((c, c) if one else (c, c + 1))]
    pk = BL.planes_of_ints(_bls_coords(1, p_aff), device)
    qk = BL.planes_of_ints(_bls_coords(2, q_aff), device)
    f = BL.miller(pk, qk)
    want = BL.miller_plain(pk, qk)
    held.hold("bls_miller_half", (f,), lambda: (want,))
    for kernel, key in (("sextet", "bls_miller_sextet"), ("lane", "bls_miller")):
        held.hold(key, (BL.miller(pk, qk, kernel=kernel),), lambda: (want,))
    # B4 at its crossovers, the pairs repeated: the half-warp's to the
    # sextet, the sextet's to one pair a thread, each kernel on both sides
    n_half = _bls_crossover("bls_miller", device, lambda s: s["group_threads"] != 16)
    n4 = _bls_crossover("bls_miller", device, lambda s: s["lane_kernel"])
    for m, kernels in ((n_half, (None, "half")), (n4, (None, "sextet"))):
        idx = torch.arange(m, device=device) % n
        pc, qc = pk[:, idx].contiguous(), qk[:, idx].contiguous()
        want_m = BL.miller_plain(pc, qc)
        for kernel in kernels:
            used = {k: BL.LAUNCHES[k] for k in ("bls_miller_half", "bls_miller_sextet")}
            got = BL.miller(pc, qc, kernel=kernel)
            key = next((k for k, v in used.items() if BL.LAUNCHES[k] > v), "bls_miller")
            held.hold(key, (got,), lambda: (want_m,))
    print(f"  B4 held on its three kernels at {n} pairs (a half-warp a pair), at the "
          f"half-warp's crossover, {n_half} pairs (a sextet a pair), and at the sextet's, "
          f"{n4} pairs (one pair a thread)", flush=True)
    lanes = torch.arange(n, dtype=torch.int32, device=device)
    starts = torch.arange(0, n + 1, 2, dtype=torch.int32, device=device)
    got = BL.final_exp(f, lanes, starts)
    held.hold("bls_final_exp", got, lambda: BL.final_exp_plain(f, lanes, starts))
    if got[0].tolist() != [1] * (n // 4) + [0] * (n // 4):
        raise AssertionError(f"B5: verdicts {got[0].tolist()}")
    # one check of 151 values (the 150 commit's aggregate shape: ten trios);
    # a pair of one-pairs at its head, so the tree meets both orders
    lanes151 = torch.tensor([k % n for k in range(151)], dtype=torch.int32, device=device)
    starts151 = torch.tensor([0, 151], dtype=torch.int32, device=device)
    got = BL.final_exp(f, lanes151, starts151)
    held.hold("bls_final_exp", got, lambda: BL.final_exp_plain(f, lanes151, starts151))
    # products of zero and of one: a Miller value 0 and one 1 beside two
    # pairs; checks [0] forced, [1], [0], [1, 0] forced, [pair 0]
    zero_one = BL.planes_of_ints([[0, 1]] + [[0, 0]] * 11, device)
    fz = torch.cat([f[:, :2], zero_one], 1).contiguous()
    lz = torch.tensor([2, 3, 2, 3, 2, 0, 1], dtype=torch.int32, device=device)
    sz = torch.tensor([0, 1, 2, 3, 5, 7], dtype=torch.int32, device=device)
    force = torch.tensor([1, 0, 0, 1, 0], dtype=torch.int32, device=device)
    got = BL.final_exp(fz, lz, sz, force=force)
    held.hold("bls_final_exp", got, lambda: BL.final_exp_plain(fz, lz, sz, force=force))
    if got[0].tolist() != [1, 1, 0, 1, 1] or got[2].tolist() != [0]:
        raise AssertionError(f"B5 zero/one checks: verdicts {got[0].tolist()}, all {got[2]}")
    for label, entry, units, values, check in (
            ("150 lanes, no subgroup check", "bls_decompress_g2", 150, None, False),
            ("256 lanes", "bls_decompress_g2", 256, None, True),
            (f"{n1} lanes", "bls_decompress_g2", n1, None, True),
            (f"{N_BIG} lanes", "bls_decompress_g2", N_BIG, None, True),
            ("150 lanes", "bls_decompress_g1", 150, None, True),
            ("256 lanes", "bls_decompress_g1", 256, None, True),
            (f"{cross[1]} lanes", "bls_decompress_g1", cross[1], None, True),
            (f"{N_BIG} lanes", "bls_decompress_g1", N_BIG, None, True),
            ("150 groups of 1", "bls_point_sum_g1", 150, 150, False),
            (f"one group of {N_BIG}", "bls_point_sum_g1", 1, N_BIG, False),
            ("one group of 150", "bls_point_sum_g2", 1, 150, True),
            (f"one group of {N_BIG}", "bls_point_sum_g2", 1, N_BIG, True),
            ("1 message", "bls_hash_to_g2", 1, 1, True),
            ("150 messages", "bls_hash_to_g2", 150, 150, True),
            (f"{N_BIG} messages", "bls_hash_to_g2", N_BIG, N_BIG, True),
            ("2 pairs", "bls_miller", 2, None, True), ("151 pairs", "bls_miller", 151, None, True),
            (f"{n_half} pairs", "bls_miller", n_half, None, True),
            (f"{n4} pairs", "bls_miller", n4, None, True),
            (f"{2 * N_BIG} pairs", "bls_miller", 2 * N_BIG, None, True),
            ("one check of 151", "bls_final_exp", 1, 151, True),
            ("one check of 2", "bls_final_exp", 1, 2, True),
            (f"{N_BIG} checks of 2", "bls_final_exp", N_BIG, 2 * N_BIG, True)):
        shape = BL.launch_shape(entry, units, device, values, check_subgroup=check)
        print(f"  launch shape {entry}, {label}: {shape}", flush=True)


def _bls_crossover(entry: str, device, past) -> int:
    """The fewest lanes (pairs) at which `entry` (with the subgroup check)
    launches as `past(launch_shape)` holds: a crossover, from launch_shape."""
    from cometbft_tpu_torch.ops import bls_launch as BL

    lo, hi = 1, 1 << 20
    while lo < hi:
        mid = (lo + hi) // 2
        if past(BL.launch_shape(entry, mid, device)):
            hi = mid
        else:
            lo = mid + 1
    return lo


def _bls_counted(fn, device):
    """fn() with every count set to 0 just before and read just after:
    (wall ms, launches of every kernel, path counters, the exception fn
    raised or None)."""
    from cometbft_tpu_torch.crypto import batch as crypto_batch
    from cometbft_tpu_torch.ops import bls_launch as BL

    _reset_counts()
    BL.reset_launches()
    _sync(device)
    t0 = time.perf_counter()
    err = None
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the cell asserts what it raised
        err = e
    _sync(device)
    return ((time.perf_counter() - t0) * 1e3, {**_launches(), **BL.LAUNCHES},
            crypto_batch.path_stats(), err)


def _bls_want(**kw) -> dict:
    base = dict.fromkeys(("bls_decompress_g1", "bls_decompress_g2", "bls_hash_to_g2",
                          "bls_point_sum_g1", "bls_point_sum_g2", "bls_miller",
                          "bls_final_exp", "integrity_parts", "ed25519_verify",
                          "sr25519_verify"), 0)
    base.update(kw)
    return base


_AGG = dict(bls_decompress_g2=1, bls_hash_to_g2=1, bls_point_sum_g1=1, bls_point_sum_g2=1,
            bls_miller=1, bls_final_exp=1)
# B3 on the 150 commit's sums (150 groups of one key, one group of 150
# signatures): a block a group alone; on the 10k commit's (one group each of
# 10,240): split over blocks first
_AGG_150 = dict(_AGG, bls_point_sum_g1_short=1, bls_point_sum_g2_short=1)
_AGG_10K = dict(_AGG, bls_point_sum_g1_split=1, bls_point_sum_g2_split=1)
_SINGLE = dict(bls_decompress_g1=1, bls_decompress_g2=1, bls_hash_to_g2=1, bls_miller=1,
               bls_final_exp=1, integrity_parts=1)


def bls_by_part(label: str, call, card: str) -> dict:
    """call() (a warm all-BLS verify_commit) once by part: the host parts of
    ed25519_kernel.timed_parts (rows, aggregate = the whole check, pack,
    keys, verify, fetch), and each BLS kernel's call synchronised around it
    (ms)."""
    from cometbft_tpu_torch.ops import bls_launch as BL
    from cometbft_tpu_torch.ops import ed25519_kernel as EK

    saved = {n: getattr(BL, n) for n in ("decompress", "hash_to_g2", "point_sum", "miller",
                                         "final_exp")}
    kernels: dict[str, float] = {}

    def timed(name, fn):
        def run(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            key = f"{name}_g{args[0]}" if name in ("decompress", "point_sum") else name
            kernels[key] = kernels.get(key, 0.0) + (time.perf_counter() - t0) * 1e3
            return out
        return run

    parts: dict[str, float] = {}
    for name, fn in saved.items():
        setattr(BL, name, timed(name, fn))
    try:
        with EK.timed_parts(parts):
            call()
    finally:
        for name, fn in saved.items():
            setattr(BL, name, fn)
    print(f"[{card}] BLS {label} by part (ms, synchronised around each): "
          + ", ".join(f"{k} {v:.3f}" for k, v in parts.items()) + "; kernels: "
          + ", ".join(f"{k} {v:.3f}" for k, v in kernels.items()), flush=True)
    return {"parts": parts, "kernels": kernels}


def bls_cell(label: str, call, device, want: dict, totals: dict, raises: str = "",
             card: str = "") -> float:
    """One BLS cell: call() counted on its own, its launches `want` exactly
    (and nothing of K1/K2 or K6 beyond them), its error `raises` (a message
    prefix) or none. Adds its launches to `totals`; prints and returns its
    wall time."""
    ms, launches, _, err = _bls_counted(call, device)
    expect(label, launches, want)
    if raises:
        if err is None or not str(err).startswith(raises):
            raise AssertionError(f"{label}: expected {raises!r}, got {err!r}")
    elif err is not None:
        raise err
    for k, v in launches.items():
        if k.startswith("bls_"):
            totals[k] = totals.get(k, 0) + v
    print(f"[{card}] BLS {label}: {ms:.3f} ms, launches "
          + ", ".join(f"{k} {v}" for k, v in launches.items() if v), flush=True)
    return ms


def bls_phase(device, card: str, report: str = "") -> dict:
    """The BLS phase: B1-B5 held against their plain versions, then the
    cells through verify_commit* and the scheduler, every run's launches,
    verdicts and errors asserted: an all-BLS 150-validator commit (distinct
    timestamps: D = 150, 151 Miller lanes) cold, warm, with one tampered
    signature (the aggregate fails, the per-lane pinpoint runs 150 rows at
    256 lanes through the scheduler and names the index) and through
    aggregate_verify_agg; a 10,240-validator commit sharing one timestamp
    (D = 1) cold, warm and tampered (the single-verify path at 10,240
    lanes); a mixed commit of 50 ed25519 + 50 sr25519 + 50 bls12381
    validators (one K1, one K2, the BLS pipeline, one combined header
    fetch) and its rows with a bad lane of each scheme (mask order). Then
    the cold 150, tampered 150 and tampered 10k commits once more, recorded:
    every kernel call held against its plain version on the same card
    tensors, each kernel timed (CUDA events) on its largest call and on
    every recorded call. Returns the kernel records."""
    from cometbft_tpu_torch import sched
    from cometbft_tpu_torch.crypto import batch as crypto_batch
    from cometbft_tpu_torch.ops import bls_kernel as BK
    from cometbft_tpu_torch.ops import bls_launch as BL
    from cometbft_tpu_torch.ops import ed25519_kernel as EK
    from cometbft_tpu_torch.types import validation as V

    t_phase = time.perf_counter()
    for kernel, lines in ptxas_summary(report).items():
        if kernel.startswith(("bls_decompress", "bls_hash_to_g2", "bls_point_sum",
                              "bls_miller", "bls_final_exp")):
            print(f"  ptxas {kernel}: {'; '.join(lines)}", flush=True)
    held = BlsHeld()
    check_bls(device, held, card)
    print(f"[{card}] BLS checks: B1-B5 held against their plain versions on edge cases "
          f"({time.perf_counter() - t_phase:.1f} s): differences {held.err}", flush=True)
    crypto_batch.set_backend("gpu")
    sched.reset()
    BK.reset_valset_cache()
    totals: dict[str, int] = {}
    cells: dict[str, float] = {}

    # 1. all-BLS 150, distinct timestamps
    t0 = time.perf_counter()
    vals, secrets = bls_set(N_SMALL, SEED_BLS)
    commit, bid = bls_commit(vals, secrets, 2_000, SEED_BLS, shared_ts=False)
    print(f"BLS 150 commit built and signed in {time.perf_counter() - t0:.1f} s", flush=True)
    h = commit.height
    call = lambda: V.verify_commit(CHAIN_ID, vals, bid, h, commit)  # noqa: E731
    cells["150 cold"] = bls_cell("verify_commit 150 cold", call, device,
                                 _bls_want(**_AGG_150, bls_decompress_g1=1), totals, card=card)
    cells["150 warm"] = statistics.median(
        bls_cell("verify_commit 150 warm", call, device, _bls_want(**_AGG_150), totals,
                 card=card)
        for _ in range(3))
    by_part = {"150 warm": bls_by_part("verify_commit 150 warm", call, card)}
    bad = with_bad_signature(commit, BLS_BAD_SMALL)
    bad.signatures[BLS_BAD_SMALL].signature = commit.signatures[BLS_BAD_SMALL + 1].signature
    lanes0 = sched.get().health()["lanes_total"]
    cells["150 tampered"] = bls_cell(
        "verify_commit 150 tampered", lambda: V.verify_commit(CHAIN_ID, vals, bid, h, bad),
        device, _bls_want(**{k: _AGG_150.get(k, 0) + _SINGLE.get(k, 0)
                             for k in set(_AGG_150) | set(_SINGLE)}), totals,
        raises=f"wrong signature (#{BLS_BAD_SMALL})", card=card)
    if sched.get().health()["lanes_total"] - lanes0 != 256:
        raise AssertionError("BLS 150 tampered: the pinpoint did not run 256 lanes")
    pubs, msgs, sigs = commit_rows_of(vals, commit)
    agg = BK.aggregate_signatures(sigs)

    def agg_call():
        if V._bls_aggregate_agg_ok(pubs, msgs, agg) is not True:
            raise AssertionError("aggregate_verify_agg rejected the commit's aggregate")
    cells["150 aggregate_verify_agg"] = bls_cell(
        "aggregate_verify_agg 150", agg_call, device,
        _bls_want(bls_decompress_g2=1, bls_hash_to_g2=1, bls_point_sum_g1=1,
                  bls_point_sum_g1_short=1, bls_miller=1, bls_final_exp=1), totals, card=card)

    # 2. all-BLS 10,240, one shared timestamp
    t0 = time.perf_counter()
    vals_b, secrets_b = bls_set(N_BIG, SEED_BLS + 1)
    commit_b, bid_b = bls_commit(vals_b, secrets_b, 2_001, SEED_BLS + 1, shared_ts=True)
    print(f"BLS 10k commit built and signed in {time.perf_counter() - t0:.1f} s", flush=True)
    hb = commit_b.height
    call_b = lambda: V.verify_commit(CHAIN_ID, vals_b, bid_b, hb, commit_b)  # noqa: E731
    cells["10k cold"] = bls_cell("verify_commit 10k cold", call_b, device,
                                 _bls_want(**_AGG_10K, bls_decompress_g1=1), totals, card=card)
    cells["10k warm"] = statistics.median(
        bls_cell("verify_commit 10k warm", call_b, device, _bls_want(**_AGG_10K), totals,
                 card=card)
        for _ in range(3))
    by_part["10k warm"] = bls_by_part("verify_commit 10k warm", call_b, card)
    bad_b = with_bad_signature(commit_b, BLS_BAD_BIG)
    bad_b.signatures[BLS_BAD_BIG].signature = commit_b.signatures[BLS_BAD_BIG + 1].signature
    cells["10k tampered"] = bls_cell(
        "verify_commit 10k tampered",
        lambda: V.verify_commit(CHAIN_ID, vals_b, bid_b, hb, bad_b), device,
        _bls_want(**{k: _AGG_10K.get(k, 0) + _SINGLE.get(k, 0)
                     for k in set(_AGG_10K) | set(_SINGLE)}),
        totals, raises=f"wrong signature (#{BLS_BAD_BIG})", card=card)

    # 3. mixed 150: 50 ed25519 + 50 sr25519 + 50 bls12381
    t0 = time.perf_counter()
    es_vals, es_secrets = make_set(100, SEED_BLS + 2, "mixed")
    vals_m, secrets_m = bls_set(50, SEED_BLS + 3, extra=es_vals.validators)
    commit_m, bid_m = bls_commit(vals_m, secrets_m, 2_002, SEED_BLS + 3, shared_ts=False,
                                 ed_sr_secrets=es_secrets)
    print(f"BLS mixed 150 commit built and signed in {time.perf_counter() - t0:.1f} s",
          flush=True)
    hm = commit_m.height
    EK.reset_fetch_stats()
    mixed_want = _bls_want(**dict(_SINGLE, integrity_parts=3, ed25519_verify=1,
                                  sr25519_verify=1))
    call_m = lambda: V.verify_commit(CHAIN_ID, vals_m, bid_m, hm, commit_m)  # noqa: E731
    bls_cell("verify_commit mixed 150 (first)", call_m, device,
             dict(mixed_want, ed25519_decompress=1, sr25519_decompress=1), totals, card=card)
    ms, launches, paths, err = _bls_counted(call_m, device)
    if err is not None:
        raise err
    expect("verify_commit mixed 150", launches, mixed_want)
    expect_fetch("verify_commit mixed 150", paths, True)
    cells["mixed 150"] = ms
    print(f"[{card}] BLS verify_commit mixed 150: {ms:.3f} ms, one header fetch "
          f"{paths['fetch']}", flush=True)
    rows = list(zip(*commit_rows_of(vals_m, commit_m)))
    bad_lanes = sorted([i for i, r in enumerate(rows) if r[0].type_() == kt][3]
                       for kt in ("ed25519", "sr25519", "bls12381"))
    for i in bad_lanes:
        p_, m_, s_ = rows[i]
        rows[i] = (p_, m_, s_[:40] + bytes([s_[40] ^ 1]) + s_[41:])
    v = crypto_batch.create_mixed_batch_verifier()
    for r in rows:
        v.add(*r)
    ok, mask = v.verify()
    if ok or [i for i, m in enumerate(mask) if not m] != bad_lanes:
        raise AssertionError(f"mixed 150 mask order: rejected "
                             f"{[i for i, m in enumerate(mask) if not m]}, expected {bad_lanes}")
    print(f"[{card}] BLS mixed 150 rows with a bad lane of each scheme at {bad_lanes}: "
          f"mask order kept", flush=True)
    missing = [k for k in BLS_RECORDS if totals.get(BLS_SPLIT.get(k, (k, None, k))[2], 0) < 1]
    if missing:
        raise AssertionError(f"BLS kernels never launched on the main path: {missing}")

    # 4. the main path's own calls: the 150 commit cold (the aggregate with
    # the keys' B1), the tampered 150 commit (its aggregate, then the
    # single-verify pinpoint at 256 lanes: B1 G2's trios, B4's sextets) and
    # the tampered 10k commit (its aggregate, then the single-verify path at
    # 10,240 lanes: one lane a thread), recorded; each call held against
    # its plain version on the same card tensors; each kernel timed on its
    # largest call, its bound worked out from that call's inputs
    t0 = time.perf_counter()
    BK.reset_valset_cache()
    with BlsRecorder() as rec:
        call()
        for label, run, index in (
                ("150", lambda: V.verify_commit(CHAIN_ID, vals, bid, h, bad), BLS_BAD_SMALL),
                ("10k", lambda: V.verify_commit(CHAIN_ID, vals_b, bid_b, hb, bad_b), BLS_BAD_BIG)):
            try:
                run()
            except Exception as e:  # noqa: BLE001 - asserted below
                if not str(e).startswith(f"wrong signature (#{index})"):
                    raise
            else:
                raise AssertionError(f"BLS {label} tampered: no error in the recorded run")
    held_calls = hold_recorded(rec.calls, held, card)
    single = [c for c in held_calls if c["key"] == "bls_final_exp"
              and c["args"][2].shape[0] - 1 == N_BIG]
    if len(single) != 1 or [i for i, v in enumerate(single[0]["outs"][0].tolist())
                            if not v] != [BLS_BAD_BIG]:
        raise AssertionError("BLS 10k single-verify: B5 must reject exactly the tampered lane")
    print(f"[{card}] BLS main-path calls held against their plain versions: "
          f"{len(held_calls)} calls in {time.perf_counter() - t0:.1f} s", flush=True)
    least, design, chain = bls_least_products(), bls_fp_products(), bls_chain_products()
    print(f"[{card}] Fp products a lane, least / the kernels' own / one thread's chain: B1 G2 "
          f"{least['g2']} + {least['sub2']} / {design['g2']} + {design['sub2']} / {chain['g2']} + "
          f"{chain['sub2']} (decompression + the subgroup test); B2 "
          f"{least['h2g']} / {design['h2g']} / {chain['h2g']} a message; B4 {least['miller']} "
          f"(Aranha's scalings; {least['miller_floor']} with the plain ones) / "
          f"{design['miller']} / {chain['miller_half']} (half-warp), {chain['miller']} "
          f"(sextet) a pair; B5 {least['fexp']} / "
          f"{design['fexp']} / {chain['fexp']} a check + {least['mul12']} / {design['mul12']} / "
          f"{chain['mul12']} a further Miller value (the widest calls: one lane a thread, the "
          f"own counts); B1 G1 {least['g1']} + {least['sub1']} / {design['g1']} + "
          f"{design['sub1']} / {chain['g1']} + {chain['sub1']} (a trio's rounds); B3 a point "
          f"{least['add1']} / "
          f"{design['add1_aff']} (mixed) or {design['add1']} (complete) in G1, {least['add2']} / "
          f"{design['add2_aff']} or {design['add2']} in G2 (B3's chains: each record)",
          flush=True)
    # every kernel on each of its recorded calls: the aggregates' (the 150
    # commit's and the 10k commit's: 150 keys in 150 groups or 10,240 in one,
    # 150 and 10,240 signatures, one message or 150, 151 or 2 pairs, one
    # check) and the single-verify path's (256 and 10,240 lanes, 20,480
    # pairs)
    by_call: dict[str, dict[str, float]] = {}
    for c in held_calls:
        if c["key"] in BLS_RECORDS:
            label = _bls_call_shape(c["entry"], c["args"])
            if label not in by_call.setdefault(c["key"], {}):
                args, fn = c["args"], getattr(BL, c["entry"])
                by_call[c["key"]][label] = time_kernel(lambda: fn(*args), reps=5)
                print(f"[{card}] {c['key']}: {by_call[c['key']][label]:.3f} ms on its recorded "
                      f"call of {label} (median of 5)", flush=True)
    records = []
    for name in BLS_RECORDS:
        mine = [c for c in held_calls if c["key"] == name]
        if not mine:
            raise AssertionError(f"{name}: no call on the recorded main path")
        c = max(mine, key=lambda c: bls_call_products(name, c["args"], least))
        entry, kernel, count = BLS_SPLIT.get(name, (name, None, name))
        args, fn = c["args"], functools.partial(getattr(BL, c["entry"]),
                                                **({"kernel": kernel} if kernel else {}))
        ms = time_kernel(lambda: fn(*args), reps=3)
        n = args[1].shape[-1] if c["entry"] in ("decompress", "point_sum") else args[0].shape[-1]
        units = (args[3].shape[0] - 1 if c["entry"] == "point_sum" else
                 args[2].shape[0] - 1 if c["entry"] == "final_exp" else n)
        shape = BL.launch_shape(entry, units, device,
                                n if c["entry"] == "final_exp" else
                                args[2].shape[0] if c["entry"] == "point_sum" else None,
                                check_subgroup=c["entry"] != "decompress" or bool(args[3]),
                                kernel=kernel)
        products = bls_call_products(name, args, least)
        nbytes = sum(t.numel() * t.element_size() for t in args + c["outs"]
                     if isinstance(t, torch.Tensor))
        b = bls_bound(products, nbytes)
        slices = shape["slices"] if c["entry"] == "point_sum" else None
        design_b = bls_bound(bls_call_products(name, args, design, slices), nbytes)
        b3 = {}
        if slices is not None:
            b3 = {"chain_products": b3_products(args[0], _sizes(args[3]), slices, bool(args[4]),
                                                design, chain=True),
                  "slices": slices, "part_blocks": shape["part_blocks"],
                  "part_registers": shape["part_registers"],
                  "part_stack_bytes": shape["part_local_bytes"]}
        print(f"[{card}] {name}: {ms:.3f} ms on {_bls_call_shape(c['entry'], args)} (median "
              f"of 3), plain {c['plain_ms']:.1f} ms on the same call; bound {b[0]:.4f} ms "
              f"({b[1]}: {products} Fp products x {FP_MUL_IMADS} IMADs, {nbytes} B), "
              f"{b[0] / ms:.1%}; the kernel's own formulas {design_b[0]:.4f} ms; "
              f"{shape['registers']} registers, {shape['local_bytes']} B stack, "
              f"{shape['blocks_per_sm']} blocks/SM"
              + (f"; {b3['slices']} slices a group ({b3['part_blocks']} phase-1 blocks, "
                 f"{b3['part_registers']} registers, {b3['part_stack_bytes']} B stack), chain "
                 f"{b3['chain_products']} Fp products" if b3 else ""), flush=True)
        records.append({
            "name": name, "route": "cuda", "source": "cometbft_tpu_torch/csrc/bls12381.cu",
            "replaces": BLS_RECORDS[name], "launches": totals[count],
            "max_abs_err": held.err[name], "ms": ms, "plain_ms": c["plain_ms"],
            "bound_ms": b[0], "bound_by": b[1], "library_ms": None, "lanes": n,
            "units": units, "fp_products": products, "design_bound_ms": design_b[0],
            "registers": shape["registers"], "stack_bytes": shape["local_bytes"], **b3,
            **({"ms_by_call": by_call[name]} if name in by_call else {})})
    print(f"[{card}] BLS cells (wall ms): " + ", ".join(f"{k} {v:.3f}" for k, v in cells.items())
          + f"; BLS phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    return {"records": records, "cells": cells, "launches": totals, "by_part": by_part}


# ------------------------------------------------------------------ mesh

N_DOMAINS = 4  # fault domains of the card in the mesh phase
MESH_COOLDOWN = 0.25  # s: a killed domain's breaker re-probes after this
MESH_BAD = (3, 1_000, 2_027, 2_029, 5_000, 7_777, 9_000, 10_100)  # the spread flush's tampered rows
SPMD_BAD = (5, 2_559, 2_560, 7_800, 10_239)  # the SPMD batch's tampered lanes (slice edges)


class StreamRecorder:
    """While entered, the CUDA stream of every launch of K1/K2 and the
    decoders (verify_kernel._count), K5 (challenge.derive) and K6
    (integrity.integrity_parts), by entry: {entry: [stream handle, ...]}.
    The launches count as before."""

    def __enter__(self):
        from cometbft_tpu_torch.ops import challenge as CH
        from cometbft_tpu_torch.ops import integrity as IN
        from cometbft_tpu_torch.ops import verify_kernel as VK

        self.seen: dict[str, list[int]] = {}
        self._saved = (VK._count, CH.derive, IN.integrity_parts)
        count, derive, parts = self._saved

        def rec(name):
            s = torch.cuda.current_stream().cuda_stream if torch.cuda.is_available() else 0
            self.seen.setdefault(name, []).append(s)

        def counted_launch(entry, lanes):
            rec(entry)
            count(entry, lanes)

        def derived(*a, **k):
            out = derive(*a, **k)
            rec("challenge_derive")
            return out

        def parted(*a, **k):
            out = parts(*a, **k)
            rec("integrity_parts")
            return out

        VK._count, CH.derive, IN.integrity_parts = counted_launch, derived, parted
        return self

    def __exit__(self, *exc):
        from cometbft_tpu_torch.ops import challenge as CH
        from cometbft_tpu_torch.ops import integrity as IN
        from cometbft_tpu_torch.ops import verify_kernel as VK

        VK._count, CH.derive, IN.integrity_parts = self._saved
        return False

    def by_stream(self, entry: str, names: dict) -> dict[str, int]:
        """Launches of `entry` by the name of their stream (names: handle
        -> name; "other" for any stream not named)."""
        out: dict[str, int] = {}
        for s in self.seen.get(entry, []):
            out[names.get(s, "other")] = out.get(names.get(s, "other"), 0) + 1
        return out


def mesh_phase(device, card: str) -> dict:
    """The mesh phase, after the BLS phase: the fault-domain VerifyMesh (parallel/mesh.py) of
    N_DOMAINS domains on the one card, installed as the process's mesh, so
    the scheduler routes through it. A 10,240-validator ed25519 commit's
    rows (8 tampered) as a SYNC flush spread over the domains (5 shards of
    2,048 lanes), the 150 commit pinned to one domain under CONSENSUS, the
    mixed commit's sr25519 rows and all its rows spread, a BLS 150 batch
    through the BLS shard and the mixed 50 + 50 + 50 commit; a domain
    killed (chaos, "ed25519.dispatch.dev1" permanent) and readmitted, every
    domain killed (the single-card path); the SPMD plane at 10,240 lanes.
    Every run's shards and lanes per domain, launches, the stream each
    launch went to and the masks are asserted; the spread flush is timed
    with the mesh on and off. Returns the launches of the first spread flush
    (K2's of the sr25519 flush) and the times."""
    from cometbft_tpu_torch import sched
    from cometbft_tpu_torch.crypto import batch as crypto_batch
    from cometbft_tpu_torch.libs import chaos
    from cometbft_tpu_torch.ops import bls_launch as BL
    from cometbft_tpu_torch.ops import dispatch as D
    from cometbft_tpu_torch.ops import ed25519_kernel as K
    from cometbft_tpu_torch.ops import residency
    from cometbft_tpu_torch.ops import verify_kernel as VK
    from cometbft_tpu_torch.parallel import mesh as M
    from cometbft_tpu_torch.types import validation as V

    t_phase = time.perf_counter()
    crypto_batch.set_backend("gpu")
    sched.reset()
    chaos.reset()
    D.reset_supervision()
    D.configure(retry_base=0.0, retry_cap=0.0, cooldown=30.0)
    dom_dev = (torch.device("cuda", torch.cuda.current_device()) if device.type == "cuda"
               else device)
    vm = M.VerifyMesh([dom_dev] * N_DOMAINS)
    M._set_for_testing(vm)
    doms = [f"dev{i}" for i in range(N_DOMAINS)]
    names = {}
    if dom_dev.type == "cuda":
        names = {D.stream(dom_dev, d).cuda_stream: d for d in doms}
        names[D.stream(dom_dev, "").cuda_stream] = "single-card"
        if len(names) != N_DOMAINS + 1:
            raise AssertionError("mesh: the domains do not have streams of their own")
    out: dict = {}

    def health_diff(h0, h1):
        return {d: (h1["chips"][d]["shards_total"] - h0["chips"][d]["shards_total"],
                    h1["chips"][d]["lanes_total"] - h0["chips"][d]["lanes_total"])
                for d in h1["chips"]}

    def flush(cols, klass):
        return sched.get().verify_many([cols], klass)[0]

    def planned(m, klass):
        """(shards, lanes) by domain of the next batch of m rows: the
        mesh's own plan at the present loads."""
        by = {str(c.index): (0, 0) for c in vm.chips}
        for c, lo, hi in vm._plan(m, klass, vm.live_chips()):
            s_, l_ = by[str(c.index)]
            by[str(c.index)] = (s_ + 1, l_ + K.bucket_size(hi - lo))
        return by

    def run(label, call, want_mask=None):
        """call() counted, its launches' streams recorded: (mask, ms,
        launches, lanes, per-domain (shards, lanes), recorder, health)."""
        h0 = vm.health()
        got = []
        with StreamRecorder() as rec:
            ms, launches, lanes, _ = counted(lambda: got.append(call()), device)
        h1 = vm.health()
        per = health_diff(h0, h1)
        mask = got[0]
        if want_mask is not None and np.asarray(mask).tolist() != list(want_mask):
            raise AssertionError(f"mesh {label}: wrong mask, rejected "
                                 f"{np.flatnonzero(~np.asarray(mask)).tolist()[:20]}")
        return mask, ms, launches, lanes, per, rec, h1

    def expect_streams(label, rec, per, entries):
        """Each entry launched once a shard, on its shard's domain stream."""
        if not names:
            return
        want = {f"dev{d}": s for d, (s, _) in per.items() if s}
        for e in entries:
            got = rec.by_stream(e, names)
            if got != want:
                raise AssertionError(f"mesh {label}: {e} by stream {got}, shards by domain "
                                     f"{want}")

    try:
        # the rows: the commit phase's 10,240 set, 8 rows tampered
        vals, secrets = make_set(N_BIG, SEED_COMMIT, "ed25519")
        commit, bid = sign_commit(vals, secrets, 1_000, SEED_COMMIT, commit_flags(N_BIG))
        pubs, msgs, sigs = (list(x) for x in commit_rows_of(vals, commit))
        n = len(sigs)
        tamper(pubs, msgs, sigs, list(MESH_BAD))
        cols = sched.RowColumns.of(list(zip(pubs, msgs, sigs)))
        want = [i not in MESH_BAD for i in range(n)]
        # the single-card path's mask on the same rows, mesh off
        M.configure(enabled=False)
        single = flush(cols, sched.SYNC)
        M.configure(enabled=True)
        if single.tolist() != want:
            raise AssertionError("mesh: the single-card path's mask is wrong")
        shards = len(vm._plan(n, sched.SYNC, vm.chips))
        if n > 4 * 2048 and shards != 5:  # the 10,240 commit: 5 shards of 2,048 lanes
            raise AssertionError(f"mesh spread: {shards} shards planned")

        # 1. spread: the shards over the domains, cold then warm
        spread = []
        for j in range(2):
            plan = planned(n, sched.SYNC)
            mask, ms, launches, lanes, per, rec, h = run(f"spread {j}",
                                                         lambda: flush(cols, sched.SYNC), want)
            if per != plan or sum(s for s, _ in per.values()) != shards or \
                    sum(1 for s, _ in per.values() if s) != min(shards, N_DOMAINS):
                raise AssertionError(f"mesh spread: (shards, lanes) by domain {per}, planned "
                                     f"{plan}")
            expect(f"mesh spread {j}", launches, {"ed25519_verify": shards,
                                                  "challenge_derive": shards,
                                                  "integrity_parts": shards})
            if lanes["ed25519_verify"] != sum(l for _, l in per.values()):
                raise AssertionError(f"mesh spread: K1 lanes {lanes}")
            expect_streams("spread", rec, per, ("ed25519_verify", "challenge_derive",
                                                "integrity_parts"))
            spread.append((ms, per, launches))
        out["launches"] = dict(spread[0][2])
        print(f"mesh phase spread: {n} ed25519 rows ({len(MESH_BAD)} tampered) as a SYNC flush "
              f"over {N_DOMAINS} domains of {dom_dev}: {shards} shards, "
              f"(shards, lanes) by domain {spread[0][1]} then {spread[1][1]}; one K5, K1 and K6 "
              f"a shard, each on its domain's stream; mask == the single-card path's "
              f"({spread[0][0]:.3f} / {spread[1][0]:.3f} ms)", flush=True)

        # the spread flush, warm median of 5, mesh on and off
        on = time_wall(lambda: flush(cols, sched.SYNC), 5, device)
        M.configure(enabled=False)
        try:
            off = time_wall(lambda: flush(cols, sched.SYNC), 5, device)
        finally:
            M.configure(enabled=True)
        out["spread_ms"] = {"mesh": on, "single_card": off}
        print(f"[{card}] mesh phase: the {n}-row SYNC flush ({len(MESH_BAD)} tampered, "
              f"rechecked), warm median of 5: mesh of {N_DOMAINS} domains on the card "
              f"{on:.3f} ms, mesh off (single-card path) {off:.3f} ms", flush=True)

        # 2. pinned: the 150 commit under CONSENSUS, one shard on one domain
        vals_c, secrets_c = make_set(N_SMALL, SEED_COMMIT + 3, "ed25519")
        commit_c, bid_c = sign_commit(vals_c, secrets_c, 1_003, SEED_COMMIT + 3)
        for j in range(2):
            plan = planned(N_SMALL, sched.CONSENSUS)
            _, ms, launches, lanes, per, rec, _ = run(
                "pinned", lambda: V.verify_commit(CHAIN_ID, vals_c, bid_c, 1_003, commit_c))
            if per != plan or sorted(s for s, _ in per.values()) != [0] * (N_DOMAINS - 1) + [1] \
                    or lanes["ed25519_verify"] != K.bucket_size(N_SMALL):
                raise AssertionError(f"mesh pinned: by domain {per}, lanes {lanes}")
            expect(f"mesh pinned {j}", launches, {"ed25519_verify": 1, "challenge_derive": 1,
                                                   "integrity_parts": 1})
            expect_streams("pinned", rec, per, ("ed25519_verify", "integrity_parts"))
        print(f"mesh phase pinned: the {N_SMALL} commit under CONSENSUS on one domain {per}, one "
              f"K5, K1 at {K.bucket_size(N_SMALL)} lanes and K6 on its stream ({ms:.3f} ms)",
              flush=True)

        # 3. sr25519 and mixed rows, spread
        vals_m, secrets_m = make_set(N_BIG, SEED_COMMIT + 2, "mixed")
        commit_m, _ = sign_commit(vals_m, secrets_m, 1_002, SEED_COMMIT + 2, commit_flags(N_BIG))
        rows_m = list(zip(*commit_rows_of(vals_m, commit_m)))
        rows_sr = [r for r in rows_m if r[0].type_() == "sr25519"]
        n_ed = len(rows_m) - len(rows_sr)
        for label, rows, ed_rows in (("sr25519", rows_sr, 0), ("mixed", rows_m, n_ed)):
            c = sched.RowColumns.of(rows)
            sr_shards = len(vm._plan(len(rows_sr), sched.SYNC, vm.chips))
            ed_shards = len(vm._plan(ed_rows, sched.SYNC, vm.chips)) if ed_rows else 0
            _, ms, launches, lanes, per, rec, _ = run(label, lambda: flush(c, sched.SYNC),
                                                      [True] * len(rows))
            if sum(s for s, _ in per.values()) != sr_shards + ed_shards or \
                    min(s for s, _ in per.values()) < 1:
                raise AssertionError(f"mesh {label}: by domain {per}")
            expect(f"mesh {label}", launches, {"sr25519_verify": sr_shards,
                                               "ed25519_verify": ed_shards,
                                               "challenge_derive": ed_shards,
                                               "integrity_parts": sr_shards + ed_shards})
            expect_streams(label, rec, per, ("integrity_parts",))
            if label == "sr25519":
                out["launches"]["sr25519_verify"] = launches["sr25519_verify"]
            print(f"mesh phase {label}: {len(rows)} rows ({len(rows_sr)} sr25519) spread, "
                  f"{sr_shards} K2 + {ed_shards} K1 shards, (shards, lanes) by domain {per}, "
                  f"each K6 on its domain's stream ({ms:.3f} ms)", flush=True)

        # 4. BLS: a 150 batch through the BLS shard, the mixed 50 + 50 + 50 commit
        vals_b, secrets_b = bls_set(N_SMALL, SEED_BLS)
        commit_b, _ = bls_commit(vals_b, secrets_b, 2_000, SEED_BLS, shared_ts=False)
        pb, mb, sb = commit_rows_of(vals_b, commit_b)
        pb = [p.bytes_() for p in pb]
        BL.reset_launches()
        _, ms, launches, _, per, rec, _ = run(
            "BLS 150", lambda: vm.verify("bls12381", pb, mb, sb, klass=sched.CONSENSUS),
            [True] * len(sb))
        bls = {k: BL.LAUNCHES[k] for k in BL.ENTRIES if BL.LAUNCHES[k]}
        if sorted(s for s, _ in per.values()) != [0] * (N_DOMAINS - 1) + [1] or \
                launches["integrity_parts"] != 1 \
                or bls != {"bls_decompress_g1": 1, "bls_decompress_g2": 1, "bls_hash_to_g2": 1,
                           "bls_miller": 1, "bls_final_exp": 1}:
            raise AssertionError(f"mesh BLS 150: by domain {per}, BLS launches {bls}")
        expect_streams("BLS 150", rec, per, ("integrity_parts",))
        es_vals, es_secrets = make_set(100, SEED_BLS + 2, "mixed")
        vals_x, secrets_x = bls_set(50, SEED_BLS + 3, extra=es_vals.validators)
        commit_x, bid_x = bls_commit(vals_x, secrets_x, 2_002, SEED_BLS + 3, shared_ts=False,
                                     ed_sr_secrets=es_secrets)
        BL.reset_launches()
        _, ms_x, launches, _, per_x, rec, _ = run(
            "mixed 150", lambda: V.verify_commit(CHAIN_ID, vals_x, bid_x, 2_002, commit_x))
        if sum(s for s, _ in per_x.values()) != 3 or BL.LAUNCHES["bls_final_exp"] != 1:
            raise AssertionError(f"mesh mixed 150: by domain {per_x}, BLS {BL.LAUNCHES}")
        expect("mesh mixed 150", launches, {"ed25519_verify": 1, "sr25519_verify": 1,
                                            "integrity_parts": 3})
        expect_streams("mixed 150", rec, per_x, ("integrity_parts",))
        print(f"mesh phase BLS: a {len(sb)}-row BLS batch through the BLS shard on one domain {per} "
              f"(B1 G1, B1 G2, B2, B4, B5 and K6 once; {ms:.3f} ms); verify_commit of the mixed "
              f"50 + 50 + 50 commit, one shard a scheme, by domain {per_x} ({ms_x:.3f} ms)",
              flush=True)

        # 5. kill dev1 in a flush, then readmit it; every invalidate_device
        # call recorded
        cache = K.default_cache(dom_dev)
        others = ("dev0", "dev2", "dev3")
        kept = {d: residency._tables[cache][d] for d in others}
        dropped: list[int] = []
        real_invalidate = residency.invalidate_device

        def invalidate(index):
            dropped.append(index)
            return real_invalidate(index)

        residency.invalidate_device = invalidate
        try:
            h0 = vm.health()
            chaos.arm("ed25519.dispatch.dev1", "permanent")
            futs = sched.get().submit(cols, klass=sched.SYNC)
            sched.get().flush()
            if [f.result(timeout=120) for f in futs] != want:
                raise AssertionError("mesh kill: a future resolved wrong")
            h1 = vm.health()
            if (h1["evictions"] - h0["evictions"], h1["live"], h1["chips"]["1"]["state"],
                    h1["fallbacks"] - h0["fallbacks"]) != (1, N_DOMAINS - 1, D.OPEN, 0) or \
                    h1["redispatched_batches"] <= h0["redispatched_batches"] or dropped != [1]:
                raise AssertionError(f"mesh kill: health {h1}, invalidated {dropped}")
            if "dev1" in residency._tables.get(cache, {}):
                raise AssertionError("mesh kill: dev1's key table outlived its eviction")
            chaos.disarm("ed25519.dispatch.dev1")
            D.configure(cooldown=MESH_COOLDOWN)
            time.sleep(1.5 * MESH_COOLDOWN)
            _, _, _, _, _, _, h2 = run("readmit", lambda: flush(cols, sched.SYNC), want)
        finally:
            residency.invalidate_device = real_invalidate
        if (h2["readmissions"] - h1["readmissions"], h2["live"], h2["chips"]["1"]["state"]) != \
                (1, N_DOMAINS, D.CLOSED) or dropped != [1, 1]:
            raise AssertionError(f"mesh readmit: health {h2}, invalidated {dropped}")
        tables = residency._tables.get(cache, {})
        if any(tables.get(d) is not kept[d] for d in others):
            raise AssertionError("mesh readmit: another domain's table was dropped")
        deltas = {d: tables[d].counters["delta_updates"] for d in others}
        _, _, _, _, per_n, _, _ = run("after readmission", lambda: flush(cols, sched.SYNC), want)
        tables = residency._tables.get(cache, {})
        resident = {d: tables[d].counters["delta_updates"] - deltas[d] for d in deltas}
        if any(resident.values()) or ("dev1" in tables) != (per_n["1"][0] > 0):
            raise AssertionError(f"mesh after readmission: delta uploads {resident}, dev1 "
                                 f"shards {per_n['1']}")
        print(f"mesh phase kill: dev1 armed permanent in a SYNC flush: evicted (live "
              f"{h1['live']}), its shard redispatched "
              f"({h1['redispatched_batches'] - h0['redispatched_batches']} redispatches), every "
              f"future right, its tables dropped; disarmed, after the {MESH_COOLDOWN} s cooldown "
              f"the next flush readmitted it (readmissions {h2['readmissions']}), "
              f"invalidate_device(1) dropped dev1's tables only; the next flush: dev0/dev2/dev3 "
              f"resident (delta uploads {resident}), dev1 shards {per_n['1']}", flush=True)

        # 6. every domain dead: the single-card path
        D.configure(cooldown=30.0)
        for d in range(N_DOMAINS):
            chaos.arm(f"ed25519.dispatch.dev{d}", "permanent")
        h0 = vm.health()
        _, ms, launches, lanes, _, rec, h1 = run("all dead", lambda: flush(cols, sched.SYNC),
                                                 want)
        if h1["fallbacks"] - h0["fallbacks"] != 1 or h1["live"] != 0:
            raise AssertionError(f"mesh all dead: health {h1}")
        expect("mesh all dead", launches, {"ed25519_verify": 1, "challenge_derive": 1,
                                           "integrity_parts": 1})
        if lanes["ed25519_verify"] != K.bucket_size(n) or (
                names and rec.by_stream("ed25519_verify", names) != {"single-card": 1}):
            raise AssertionError(f"mesh all dead: K1 lanes {lanes}, streams "
                                 f"{rec.by_stream('ed25519_verify', names)}")
        chaos.reset()
        print(f"mesh phase all dead: every domain armed permanent: fallbacks 1, the rows on the "
              f"single-card path (one K5, K1 at {lanes['ed25519_verify']} lanes and K6 on its "
              f"stream), mask right ({ms:.3f} ms)", flush=True)

        # 7. the SPMD plane: one batch, K1 once a domain on its lane slice
        ed = _paths()["ed25519"]
        pubs_s, msgs_s, sigs_s = ed.make_commit(N_BIG, SEED_BIG)
        tamper(pubs_s, msgs_s, sigs_s, list(SPMD_BAD))
        domains = M.batch_mesh([dom_dev] * N_DOMAINS)
        want_s = [i not in SPMD_BAD for i in range(N_BIG)]
        (ok_s, mask_s), ms_s, launches, lanes, _, rec, _ = run(
            "SPMD", lambda: M.sharded_verify_batch(pubs_s, msgs_s, sigs_s, mesh=domains))
        if mask_s != want_s or ok_s:
            raise AssertionError("mesh SPMD: wrong mask")
        expect("mesh SPMD", launches, {"ed25519_verify": N_DOMAINS})
        if lanes["ed25519_verify"] != N_BIG or (names and rec.by_stream(
                "ed25519_verify", names) != {d: 1 for d in doms}):
            raise AssertionError(f"mesh SPMD: K1 lanes {lanes}, streams "
                                 f"{rec.by_stream('ed25519_verify', names)}")
        planes = staged(ed, pubs_s, msgs_s, sigs_s, device)
        joined = M.shard_verify_kernel(domains)(*planes)
        whole = VK.verify_ok_raw(*planes)[0]
        err_join = _max_err([joined], [whole])
        w = N_BIG // N_DOMAINS
        sl = [t[:, w:2 * w].contiguous() for t in planes]
        k1 = VK.verify_ok_raw(*sl)
        plain = VK.verify_math_ok(*sl)
        err_slice = _max_err([k1[0] != 0, k1[1][0] != 0], [plain[0], plain[1]])
        if err_join or err_slice or ((whole != 0).cpu().numpy()[:N_BIG].tolist() != want_s):
            raise AssertionError(f"mesh SPMD: joined vs one launch {err_join}, dev1's slice vs "
                                 f"plain {err_slice}")
        out["spmd"] = {"ms": ms_s, "err_join": err_join, "err_slice": err_slice}
        print(f"mesh phase SPMD: sharded_verify_batch of {N_BIG} lanes over {N_DOMAINS} domains, "
              f"K1 once a domain on {w} lanes, each on its stream, mask right ({ms_s:.3f} ms); "
              f"the joined mask == one unsharded K1 launch (difference {err_join}); dev1's slice "
              f"[{w}, {2 * w}) == K1's plain version on the card (difference {err_slice})",
              flush=True)
        print(f"mesh phase: {vm.health()['batches']} mesh batches, "
              f"{time.perf_counter() - t_phase:.1f} s", flush=True)

    finally:
        chaos.reset()
        sched.reset()
        M.reset()
        M.configure(enabled=True)
        D.reset_supervision()
        D.configure(retry_base=0.05, retry_cap=1.0, cooldown=30.0)
    return out


# ---------------------------------------------------------- consumers phase
#
# The consumers of the verify path: types/vote_set.VoteSet's batch-first
# flush (vote extensions included), the light client's bisection
# (light/verifier, light/client), commit certificates (cert/) and evidence
# verification (evidence/verify), on the card through the scheduler with the
# mesh off. Keys and nonces stepped as in the commit phase; every vote signs
# the port's own sign bytes.

SEED_CONSUMERS = 15_000  # the consumers phase's keys (seen nowhere else)
N_VOTES = 10_000  # types/basic.MAX_VOTES_COUNT
VOTE_H = 3_000  # the vote sets' height
VOTE_ABSENT = 17  # the validator of the 10,000 set that sends no vote
VOTE_BAD = (5, 1_234, 2_500, 4_999, 5_001, 7_777, 9_000, 9_998)  # tampered votes
VOTE_EQUIVOCATOR = 4_321  # also signs a valid vote for another block
N_LIGHT, LC_HEIGHT, LC_VERSIONS = 500, 100_000, 8  # BASELINE config 4
LC_FORK = 99_000  # the lying witness's first conflicting height
N_CERT, CERT_HEIGHTS = 150, 4  # the certificate chain: 150 BLS validators, 4 heights
BASE_S = 1_700_000_000  # headers at BASE_S + height seconds
NOW_S = BASE_S + LC_HEIGHT + 1_000  # the light clients' now
PERIOD_NS = 10**18  # a trusting period no run reaches


def _consumer_reset() -> None:
    """Every launch count, the BLS kernels' too, set to 0."""
    from cometbft_tpu_torch.ops import bls_launch as BL

    _reset_counts()
    BL.reset_launches()


def _consumer_launches() -> dict[str, int]:
    from cometbft_tpu_torch.ops import bls_launch as BL

    return {**_launches(), **BL.LAUNCHES}


def consumer_counted(fn, device):
    """fn() with every launch count set to 0 just before and read just
    after: (its result, wall ms, launches)."""
    _consumer_reset()
    _sync(device)
    t0 = time.perf_counter()
    out = fn()
    _sync(device)
    return out, (time.perf_counter() - t0) * 1e3, _consumer_launches()


def _flip(sig: bytes, byte: int = 40) -> bytes:
    s = bytearray(sig)
    s[byte] ^= 1
    return bytes(s)


def _bid(tag: bytes):
    from cometbft_tpu_torch.types import BlockID, PartSetHeader

    h = hashlib.sha256(b"consumers-" + tag).digest()
    return BlockID(h, PartSetHeader(1, hashlib.sha256(h).digest()))


def make_votes(vals, height: int, bid, idxs, nil=()):
    """Unsigned precommits of the validators at `idxs` for `bid` (nil for
    those in `nil`), each its own timestamp."""
    from cometbft_tpu_torch.types import BlockID, SignedMsgType, Vote
    from cometbft_tpu_torch.utils.cmttime import Timestamp

    return [Vote(SignedMsgType.PRECOMMIT, height, 0, BlockID() if i in nil else bid,
                 Timestamp(BASE_S + height, (1 << 28) + 1_000 * i),
                 vals.validators[i].address, i) for i in idxs]


def sign_votes(votes, secrets, extension: bool = False) -> None:
    """Each vote's signature (with `extension`, its extension signature)
    from make_set's stepped secrets: s = r + k a mod L, one hash a
    signature; the sr25519 challenges in one batch transcript."""
    from cometbft_tpu_torch.crypto import ed25519_math as O
    from cometbft_tpu_torch.crypto import sr25519_math as srm

    sr = []
    for v in votes:
        kind, a, r, renc, pub = secrets[v.validator_address]
        msg = v.extension_sign_bytes(CHAIN_ID) if extension else v.sign_bytes(CHAIN_ID)
        if kind == "ed25519":
            sig = renc + ((r + O.sha512_mod_l(renc, pub, msg) * a) % O.L).to_bytes(32, "little")
            setattr(v, "extension_signature" if extension else "signature", sig)
        else:
            sr.append((v, a, r, renc, pub, msg))
    if sr:
        kw = srm.batch_challenge_words([x[4] for x in sr], [x[3] for x in sr],
                                       [x[5] for x in sr])
        for (v, a, r, renc, _, _), k in zip(sr, kw):
            s = bytearray(((r + int.from_bytes(k.tobytes(), "little") * a) % srm.L)
                          .to_bytes(32, "little"))
            s[31] |= 0x80
            v.signature = renc + bytes(s)


def _flush(vs):
    """flush_pending: (results, the ErrVoteConflictingVotes it raised or
    None)."""
    from cometbft_tpu_torch.types import vote_set as VS

    try:
        return vs.flush_pending(), None
    except VS.ErrVoteConflictingVotes as e:
        return e.results, e


def _statuses(results) -> dict[str, int]:
    out: dict[str, int] = {}
    for _, s in results:
        out[s] = out.get(s, 0) + 1
    return out


def vote_set_cells(device, card: str) -> dict:
    """VoteSet on the card: 10,000 ed25519 validators staged through
    add_pending (8 tampered votes, one valid equivocation) and one
    flush_pending, cold then 5 warm; 150 validators with auto_flush (the
    batch-size and 2/3 boundaries); 150 with vote extensions; a mixed
    ed25519 + sr25519 150. Returns launches and times."""
    from cometbft_tpu_torch import sched
    from cometbft_tpu_torch.crypto import batch as crypto_batch
    from cometbft_tpu_torch.evidence import verify as EV
    from cometbft_tpu_torch.ops import ed25519_kernel as K
    from cometbft_tpu_torch.state import State
    from cometbft_tpu_torch.types import SignedMsgType, Validator, ValidatorSet, VoteSet
    from cometbft_tpu_torch.types import commit as C
    from cometbft_tpu_torch.types import evidence as E
    from cometbft_tpu_torch.types import validation as V
    from cometbft_tpu_torch.types import vote_set as VS
    from cometbft_tpu_torch.utils.cmttime import Timestamp

    PRE = SignedMsgType.PRECOMMIT
    out: dict = {}
    t0 = time.perf_counter()
    vals, secrets = make_set(N_VOTES, SEED_CONSUMERS, "ed25519")
    bid_a, bid_b = _bid(b"vote-a"), _bid(b"vote-b")
    votes = make_votes(vals, VOTE_H, bid_a, [i for i in range(N_VOTES) if i != VOTE_ABSENT])
    conflicting = make_votes(vals, VOTE_H, bid_b, [VOTE_EQUIVOCATOR])
    sign_votes(votes + conflicting, secrets)
    for v in votes:
        if v.validator_index in VOTE_BAD:
            v.signature = _flip(v.signature)
    staged = votes + conflicting  # the equivocation last: its first vote is folded first
    print(f"consumers: {N_VOTES:,}-vote set built and signed in {time.perf_counter() - t0:.1f} s",
          flush=True)

    def flush_10k():
        vs = VoteSet(CHAIN_ID, VOTE_H, 0, PRE, vals, auto_flush=False)
        for v in staged:
            if not vs.add_pending(v):
                raise AssertionError("VoteSet 10k: a vote was not staged")
        (results, err), ms, launches = consumer_counted(lambda: _flush(vs), device)
        want = [VS.FLUSH_INVALID if v.validator_index in VOTE_BAD else VS.FLUSH_ADDED
                for v in votes] + [VS.FLUSH_CONFLICT]
        if [s for _, s in results] != want or [v for v, _ in results] != staged:
            raise AssertionError(f"VoteSet 10k: statuses {_statuses(results)}")
        if err is None or len(err.conflicts) != 1 or err.conflicts[0].vote_b is not conflicting[0]:
            raise AssertionError(f"VoteSet 10k: the equivocation raised {err!r}")
        return vs, err, ms, launches

    one = {"ed25519_verify": 1, "challenge_derive": 1, "integrity_parts": 1,
           "sr25519_verify": 0, "sr25519_decompress": 0}
    vs, err, cold_ms, cold = flush_10k()
    expect("VoteSet 10k flush cold", cold, one)
    if cold["ed25519_decompress"] < 1:
        raise AssertionError(f"VoteSet 10k: the cold flush decoded no key {cold}")
    warm = []
    for _ in range(5):
        vs, err, ms, flush_launches = flush_10k()
        expect("VoteSet 10k flush warm", flush_launches, dict(one, ed25519_decompress=0))
        warm.append(ms)
    sends = {k: v["sigs"] for k, v in crypto_batch.path_stats()["sends"].items()
             if isinstance(v, dict)}
    added = N_VOTES - 1 - len(VOTE_BAD)
    maj, ok = vs.two_thirds_majority()
    if not ok or maj != bid_a or vs.sum != added * 10:
        raise AssertionError(f"VoteSet 10k: 2/3 majority {maj} {ok}, tally {vs.sum}")
    commit = vs.make_commit()
    _, ms_c, launches = consumer_counted(
        lambda: V.verify_commit(CHAIN_ID, vals, bid_a, VOTE_H, commit), device)
    expect("VoteSet 10k make_commit -> verify_commit", launches, one)
    out["flush_10k"] = {"cold_ms": cold_ms, "warm_ms": statistics.median(warm)}
    out["launches_vote_flush"] = dict(flush_launches)
    print(f"[{card}] VoteSet {N_VOTES:,} ed25519: add_pending x {len(staged):,} then one "
          f"flush_pending: {added:,} added, {len(VOTE_BAD)} invalid (the tampered votes), 1 "
          f"conflict raised as ErrVoteConflictingVotes after the tally; launches K5 1, K1 1 "
          f"({K.bucket_size(len(staged))} lanes), K6 1 a flush; 2/3 majority for the block; "
          f"make_commit "
          f"({sum(cs.for_block() for cs in commit.signatures):,} signatures) verified by "
          f"verify_commit on the card ({ms_c:.3f} ms); flush_pending cold {cold_ms:.3f} ms, "
          f"warm {statistics.median(warm):.3f} ms (median of 5; a warm flush's key sends by "
          f"path, signatures: {sends})", flush=True)

    # the equivocation as evidence: a valid pair under SYNC (2 rows: the
    # host derives k below MIN_LANES, K1 and K6 once), then vote B tampered
    ev = E.DuplicateVoteEvidence.new(err.conflicts[0].vote_a, err.conflicts[0].vote_b,
                                     Timestamp(BASE_S + VOTE_H, 0), vals)
    state = State(chain_id=CHAIN_ID, initial_height=1, last_block_height=VOTE_H + 1,
                  last_block_time=Timestamp(BASE_S + VOTE_H + 1, 0), validators=vals,
                  next_validators=vals, last_validators=vals)
    _, _, launches = consumer_counted(
        lambda: EV.verify_evidence(ev, state, lambda h: vals if h == VOTE_H else None), device)
    expect("evidence duplicate vote", launches,
           {"ed25519_verify": 1, "integrity_parts": 1, "challenge_derive": 0})
    bad = E.DuplicateVoteEvidence.from_proto(ev.to_proto())
    bad.vote_b.signature = _flip(bad.vote_b.signature)
    try:
        EV.verify_duplicate_vote(bad, CHAIN_ID, vals)
        raise AssertionError("evidence: a tampered vote B verified")
    except EV.ErrInvalidEvidence as e:
        if str(e) != "invalid signature on vote B":
            raise AssertionError(f"evidence: vote B tampered gave {e}") from e
    out["launches_evidence_duplicate_vote"] = dict(launches)
    print(f"consumers evidence: verify_evidence of the equivocation's DuplicateVoteEvidence "
          f"(under SYNC) passes with K1 1, K6 1 (2 rows: k on the host); vote B tampered: "
          f"ErrInvalidEvidence naming B", flush=True)

    # 150 validators, auto_flush: 128 of power 10 staged first (a flush at
    # batch_flush_size 128, their 1,280 short of the 2,321 quorum), then 22
    # of power 100 (the 2/3 boundary after 11 of them), the last 11 by hand
    base, secrets_s = make_set(N_SMALL, SEED_CONSUMERS + 1, "ed25519")
    light = {v.address for v in base.validators[:128]}
    vals_s = ValidatorSet([Validator.new(v.pub_key, 10 if v.address in light else 100)
                           for v in base.validators])
    order = sorted(range(N_SMALL), key=lambda i: vals_s.validators[i].address not in light)
    votes_s = make_votes(vals_s, VOTE_H, bid_a, order)
    sign_votes(votes_s, secrets_s)

    def auto():
        vs = VoteSet(CHAIN_ID, VOTE_H, 0, PRE, vals_s)
        rows, boundaries = [], []
        for j, v in enumerate(votes_s):
            before = len(vs._pending)
            vs.add_pending(v)
            if not vs._pending:
                rows.append(before + 1)
                boundaries.append((j + 1, vs.has_two_thirds_majority()))
        rows.append(len(vs._pending))
        results, _ = _flush(vs)
        return rows, boundaries, results

    (rows, boundaries, results), _, launches = consumer_counted(auto, device)
    if rows != [128, 11, 11] or boundaries != [(128, False), (139, True)]:
        raise AssertionError(f"VoteSet 150 auto_flush: flush rows {rows}, boundaries {boundaries}")
    if _statuses(results) != {VS.FLUSH_ADDED: 11}:
        raise AssertionError(f"VoteSet 150 auto_flush: last flush {_statuses(results)}")
    expect("VoteSet 150 auto_flush", launches,
           {"ed25519_verify": 3, "challenge_derive": 3, "integrity_parts": 3})
    print(f"consumers VoteSet 150 auto_flush: flushes of {rows} rows (batch_flush_size at vote "
          f"128, the 2/3 boundary at vote 139, the rest by hand), K1/K5/K6 3 each", flush=True)

    # 150 equal validators: the flush timed; then extensions on: 142 for the
    # block with extensions (one extension signature bad, one 63 bytes), 8
    # nil; the second batch takes the 141 that passed, are not nil and not short
    vals_e, secrets_e = make_set(N_SMALL, SEED_CONSUMERS + 2, "ed25519")
    nil = {3, 20, 41, 62, 83, 104, 125, 146}
    plain = make_votes(vals_e, VOTE_H, bid_a, range(N_SMALL), nil)
    sign_votes(plain, secrets_e)

    def flush_150():
        vs = VoteSet(CHAIN_ID, VOTE_H, 0, PRE, vals_e, auto_flush=False)
        for v in plain:
            vs.add_pending(v)
        (results, _), ms, launches = consumer_counted(lambda: _flush(vs), device)
        if _statuses(results) != {VS.FLUSH_ADDED: N_SMALL}:
            raise AssertionError(f"VoteSet 150: {_statuses(results)}")
        return ms, launches

    flush_150()
    runs = [flush_150() for _ in range(5)]
    for _, launches in runs:
        expect("VoteSet 150 flush", launches,
               {"ed25519_verify": 1, "challenge_derive": 1, "integrity_parts": 1})
    out["flush_150"] = {"warm_ms": statistics.median(ms for ms, _ in runs)}
    ext = make_votes(vals_e, VOTE_H, bid_a, range(N_SMALL), nil)
    for v in ext:
        if v.validator_index not in nil:
            v.extension = b"ext-%04d" % v.validator_index
    sign_votes(ext, secrets_e)
    sign_votes([v for v in ext if v.extension], secrets_e, extension=True)
    ext[50].extension_signature = _flip(ext[50].extension_signature)
    ext[60].extension_signature = ext[60].extension_signature[:63]
    batches: list[int] = []
    create = crypto_batch.create_batch_verifier

    def counting(pub_key):
        bv = create(pub_key)
        verify = bv.verify

        def counted_verify():
            batches.append(bv.count())
            return verify()
        bv.verify = counted_verify
        return bv

    vs = VoteSet(CHAIN_ID, VOTE_H, 0, PRE, vals_e, extensions_enabled=True, auto_flush=False)
    for v in ext:
        vs.add_pending(v)
    crypto_batch.create_batch_verifier = counting
    try:
        (results, err), _, launches = consumer_counted(lambda: _flush(vs), device)
    finally:
        crypto_batch.create_batch_verifier = create
    want = [VS.FLUSH_INVALID if v.validator_index in (50, 60) else VS.FLUSH_ADDED for v in ext]
    if err is not None or [s for _, s in results] != want or \
            batches != [N_SMALL, N_SMALL - len(nil) - 1]:
        raise AssertionError(f"VoteSet 150 extensions: {_statuses(results)}, batches {batches}")
    expect("VoteSet 150 extensions", launches,
           {"ed25519_verify": 2, "challenge_derive": 2, "integrity_parts": 2})
    ec = vs.make_extended_commit()
    if C.ExtendedCommit.from_proto(ec.to_proto()).to_proto() != ec.to_proto() or \
            ec.extended_signatures[0].extension != b"ext-0000":
        raise AssertionError("VoteSet 150 extensions: make_extended_commit does not round-trip")
    ec.ensure_extensions(True)
    print(f"consumers VoteSet 150 extensions: batches of {batches} rows (the second without the "
          f"8 nil votes and the 63-byte extension signature), 148 added, 2 invalid (the bad "
          f"and the short extension signature); launches K1 {launches['ed25519_verify']}, K5 "
          f"{launches['challenge_derive']}, K6 {launches['integrity_parts']}; "
          f"make_extended_commit round-trips through its proto ({len(ec.to_proto())} B); "
          f"150-vote flush_pending {out['flush_150']['warm_ms']:.3f} ms (warm, median of 5)",
          flush=True)

    # a mixed set: 75 ed25519 + 75 sr25519, one of each tampered: one drain,
    # one batch a scheme
    vals_m, secrets_m = make_set(N_SMALL, SEED_CONSUMERS + 3, "mixed")
    votes_m = make_votes(vals_m, VOTE_H, bid_a, range(N_SMALL))
    sign_votes(votes_m, secrets_m)
    kinds = [secrets_m[v.validator_address][0] for v in votes_m]
    bad_m = (kinds.index("ed25519"), kinds.index("sr25519"))
    for i in bad_m:
        votes_m[i].signature = _flip(votes_m[i].signature)
    for _ in range(2):  # cold, then warm
        vs = VoteSet(CHAIN_ID, VOTE_H, 0, PRE, vals_m, auto_flush=False)
        for v in votes_m:
            vs.add_pending(v)
        (results, _), ms_m, launches = consumer_counted(lambda: _flush(vs), device)
    want = [VS.FLUSH_INVALID if i in bad_m else VS.FLUSH_ADDED for i in range(N_SMALL)]
    if [s for _, s in results] != want or not vs.has_two_thirds_majority():
        raise AssertionError(f"VoteSet mixed 150: {_statuses(results)}")
    expect("VoteSet mixed 150", launches, {"ed25519_verify": 1, "sr25519_verify": 1,
                                           "challenge_derive": 1, "integrity_parts": 2})
    print(f"consumers VoteSet mixed 150 (75 ed25519 + 75 sr25519, one drain): K1 1, K2 1, K5 1, "
          f"K6 2; 148 added, the 2 tampered invalid ({ms_m:.3f} ms warm)", flush=True)
    sched.reset()
    return out


def light_chain(n_vals: int, height: int, versions: int, seed: int):
    """BASELINE config 4's chain, built lazily: heights 1..height, version v
    = h // (height / versions) of the validator set is keys [v n/2, v n/2 +
    n) of a pool of n * versions stepped keys (each version replaces half
    the last, bench.py's shape), every validator signing each commit. A
    light.Provider; fork(lie_from) gives a witness serving conflicting
    headers (another app hash, the same keys) from that height on."""
    from cometbft_tpu_torch import light
    from cometbft_tpu_torch.crypto import ed25519
    from cometbft_tpu_torch.crypto import ed25519_math as O
    from cometbft_tpu_torch.types import BlockID, Header, PartSetHeader, Validator, ValidatorSet
    from cometbft_tpu_torch.types.light import LightBlock, SignedHeader
    from cometbft_tpu_torch.utils.cmttime import Timestamp

    pool, secrets = [], {}
    for a, r, A, R in _stepped_points(n_vals * versions, np.random.default_rng(seed)):
        pub, renc = O.point_compress(A), O.point_compress(R)
        key = ed25519.PubKey(pub)
        pool.append(key)
        secrets[key.address()] = ("ed25519", a, r, renc, pub)
    churn = max(height // versions, 1)
    sets: dict[int, object] = {}

    def vals_at(h: int):
        v = h // churn
        if v not in sets:
            start = (v * (n_vals // 2)) % (len(pool) - n_vals)
            sets[v] = ValidatorSet([Validator.new(k, 10) for k in pool[start:start + n_vals]])
        return sets[v]

    class Chain(light.Provider):
        def __init__(self, lie_from: int | None = None, blocks: dict | None = None):
            self.lie_from, self.blocks = lie_from, dict(blocks or {})
            self.evidence: list = []
            self.gen_s = 0.0  # block generation (the harness's signing, not client work)

        def block(self, h: int):
            lb = self.blocks.get(h)
            if lb is None:
                t0 = time.perf_counter()
                vals = vals_at(h)
                lie = self.lie_from is not None and h >= self.lie_from
                header = Header(
                    chain_id=CHAIN_ID, height=h, time=Timestamp(BASE_S + h, 0),
                    last_block_id=BlockID(b"\x07" * 32, PartSetHeader(1, b"\x08" * 32)),
                    validators_hash=vals.hash(), next_validators_hash=vals_at(h + 1).hash(),
                    consensus_hash=b"\x01" * 32, app_hash=(b"\xee" if lie else b"\x02") * 32,
                    last_results_hash=b"\x03" * 32, data_hash=b"\x04" * 32,
                    last_commit_hash=b"\x05" * 32, evidence_hash=b"\x06" * 32,
                    proposer_address=vals.validators[0].address)
                bid = BlockID(header.hash(), PartSetHeader(1, b"\x09" * 32))
                commit, _ = sign_commit(vals, secrets, h, 0, bid=bid)
                lb = self.blocks[h] = LightBlock(SignedHeader(header, commit), vals)
                self.gen_s += time.perf_counter() - t0
            return lb

        async def light_block(self, h: int):
            return self.block(h or height)

        async def report_evidence(self, ev) -> None:
            self.evidence.append(ev)

        def id_(self) -> str:
            return "light-chain" if self.lie_from is None else f"lying-from-{self.lie_from}"

        def fork(self, lie_from: int | None = None, blocks: dict | None = None):
            keep = {h: b for h, b in self.blocks.items() if lie_from is None or h < lie_from}
            return Chain(lie_from, {**keep, **(blocks or {})})

    return Chain(), vals_at


class _Prefetches:
    """While entered, every prefetch_staged of the light verifier is
    recorded: its unresolved groups and its wall time."""

    def __enter__(self):
        from cometbft_tpu_torch.light import verifier

        self.groups: list[int] = []
        self.s = 0.0
        self._orig = orig = verifier.prefetch_staged

        def spy(staged, klass=None):
            self.groups.append(sum(1 for s in staged if not s._passed and s._mask is None))
            t0 = time.perf_counter()
            try:
                return orig(staged, klass=klass)
            finally:
                self.s += time.perf_counter() - t0
        verifier.prefetch_staged = spy
        return self

    def __exit__(self, *exc):
        from cometbft_tpu_torch.light import verifier

        verifier.prefetch_staged = self._orig
        return False


def _client(primary, witnesses, root):
    import asyncio

    from cometbft_tpu_torch import light
    from cometbft_tpu_torch.store import MemDB
    from cometbft_tpu_torch.utils.cmttime import Timestamp

    c = light.Client(CHAIN_ID, light.TrustOptions(PERIOD_NS, root.height, root.hash()), primary,
                     witnesses, light.LightStore(MemDB()))
    asyncio.run(c.initialize(Timestamp(NOW_S, 0)))
    return c


def _verify_at(client, h: int):
    """client.verify_light_block_at_height(h): the block, or the exception."""
    import asyncio

    from cometbft_tpu_torch.utils.cmttime import Timestamp

    try:
        return asyncio.run(client.verify_light_block_at_height(h, Timestamp(NOW_S, 0)))
    except Exception as e:  # noqa: BLE001 - the caller asserts which
        return e


def light_cells(device, card: str) -> dict:
    """The light client on the card, BASELINE config 4: a bisection over
    100,000 heights of 500 ed25519 validators (8 versions of the set, half
    replaced at each) with one witness and LightStore(MemDB()); every
    non-adjacent hop one prefetch of two groups (one K5, K1, K6); a target
    whose commit carries one tampered signature (ErrInvalidHeader); a
    witness serving conflicting headers (LightClientAttackEvidence through
    make_attack_evidence), whose evidence verify_light_client_attack then
    accepts against a stub block store. Returns launches and times."""
    from types import SimpleNamespace

    from cometbft_tpu_torch import light
    from cometbft_tpu_torch.evidence import verify as EV
    from cometbft_tpu_torch.state import State
    from cometbft_tpu_torch.types import evidence as E
    from cometbft_tpu_torch.types import validation as V
    from cometbft_tpu_torch.types.light import LightBlock, SignedHeader
    from cometbft_tpu_torch.utils.cmttime import Timestamp

    out: dict = {}
    primary, vals_at = light_chain(N_LIGHT, LC_HEIGHT, LC_VERSIONS, SEED_CONSUMERS + 4)
    witness = primary.fork()
    root = primary.block(1)
    client = _client(primary, [witness], root)
    gen0 = primary.gen_s + witness.gen_s
    with _Prefetches() as pf:
        got, ms, launches = consumer_counted(lambda: _verify_at(client, LC_HEIGHT), device)
    gen_s = primary.gen_s + witness.gen_s - gen0
    if not isinstance(got, LightBlock) or got.hash() != primary.block(LC_HEIGHT).hash():
        raise AssertionError(f"light bisection: {got!r}")
    hops = len(pf.groups)
    heights = list(client.store._heights)
    if client.store.size() != hops + 1 or set(pf.groups) != {2}:
        raise AssertionError(f"light bisection: store {heights}, prefetches {pf.groups}")
    expect("light bisection", launches, {"ed25519_verify": hops, "challenge_derive": hops,
                                         "integrity_parts": hops, "sr25519_verify": 0})
    per_hop = {"block_generation": gen_s / hops * 1e3, "device_prefetch": pf.s / hops * 1e3,
               "rest": (ms / 1e3 - gen_s - pf.s) / hops * 1e3}
    out["bisection"] = {"wall_ms": ms, "hops": hops, "heights": heights, "per_hop_ms": per_hop}
    # a hop's launches: K5, K1, K6 and (each version brings new keys) the decoder
    out["launches_light_hop"] = {
        k: launches[k] // hops if launches[k] % hops == 0 else launches[k] / hops
        for k in ("ed25519_verify", "challenge_derive", "integrity_parts", "ed25519_decompress")}
    print(f"[{card}] light bisection, BASELINE config 4 ({LC_HEIGHT:,} heights x {N_LIGHT} "
          f"validators, {LC_VERSIONS} versions, half replaced at each): {ms / 1e3:.3f} s wall, "
          f"{hops} hops (stored heights {heights}), each one prefetch_staged of 2 groups: "
          f"K5/K1/K6 {hops} each, decoders {launches['ed25519_decompress']} (cold keys); per hop "
          f"(ms): block generation {per_hop['block_generation']:.3f}, device prefetch "
          f"{per_hop['device_prefetch']:.3f}, the rest {per_hop['rest']:.3f}", flush=True)

    # a target whose commit carries one tampered signature, in the +2/3
    # rows of the last hop and not in its trusting rows: ErrInvalidHeader
    target = primary.block(LC_HEIGHT)
    trusted_vals = vals_at(heights[-2])
    tv = target.validator_set
    trust = set(V._commit_rows(CHAIN_ID, trusted_vals, target.commit,
                               trusted_vals.total_voting_power() // 3, V._ignore_not_commit,
                               V._count_all, False, False)[3])
    rows = V._commit_rows(CHAIN_ID, tv, target.commit, tv.total_voting_power() * 2 // 3,
                          V._ignore_not_commit, V._count_all, False, True)[3]
    bad_i = next(i for i in rows if i not in trust)
    sigs = [type(cs)(cs.block_id_flag, cs.validator_address, cs.timestamp, cs.signature)
            for cs in target.commit.signatures]
    sigs[bad_i].signature = _flip(sigs[bad_i].signature)
    forged = LightBlock(SignedHeader(target.header, type(target.commit)(
        target.commit.height, target.commit.round_, target.commit.block_id, sigs)), tv)
    liar = primary.fork(blocks={LC_HEIGHT: forged})
    client_f = _client(liar, [witness], root)
    got, _, _ = consumer_counted(lambda: _verify_at(client_f, LC_HEIGHT), device)
    if not (isinstance(got, light.ErrVerificationFailed)
            and isinstance(got.cause, light.ErrInvalidHeader)
            and f"wrong signature (#{bad_i})" in str(got)):
        raise AssertionError(f"light forged target: {got!r}")
    print(f"consumers light: the target with signature #{bad_i} tampered raises "
          f"ErrVerificationFailed({type(got.cause).__name__}: wrong signature (#{bad_i}))",
          flush=True)

    # a witness serving conflicting headers from LC_FORK on
    lying = witness.fork(lie_from=LC_FORK)
    client_a = _client(primary.fork(), [lying], root)
    got, ms_a, launches_a = consumer_counted(lambda: _verify_at(client_a, LC_HEIGHT), device)
    to_primary = client_a.primary.evidence
    if not isinstance(got, light.ErrLightClientAttack) or len(to_primary) != 1 or \
            len(lying.evidence) != 1 or not all(
                isinstance(e, E.LightClientAttackEvidence) for e in to_primary + lying.evidence):
        raise AssertionError(f"light attack: {got!r}, evidence {to_primary} {lying.evidence}")
    ev = to_primary[0]
    if ev.conflicting_block.header.app_hash != b"\xee" * 32:
        raise AssertionError("light attack: the evidence does not hold the witness's block")
    data = ev.to_proto()
    if E.LightClientAttackEvidence.from_proto(data).to_proto() != data:
        raise AssertionError("light attack: the evidence does not round-trip")
    store = SimpleNamespace(
        load_block_meta=lambda h: (SimpleNamespace(header=primary.block(h).header)
                                   if 0 < h <= LC_HEIGHT else None),
        load_block_commit=lambda h: primary.block(h).commit if 0 < h <= LC_HEIGHT else None,
        height=lambda: LC_HEIGHT)
    state = State(chain_id=CHAIN_ID, initial_height=1, last_block_height=LC_HEIGHT,
                  last_block_time=Timestamp(BASE_S + LC_HEIGHT, 0), validators=tv,
                  next_validators=tv, last_validators=tv)
    common = vals_at(ev.common_height)
    _, ms_e, launches_e = consumer_counted(
        lambda: EV.verify_light_client_attack(ev, state, common, store), device)
    expect("evidence light-client attack", launches_e,
           {"ed25519_verify": 2, "challenge_derive": 2, "integrity_parts": 2})
    print(f"consumers light attack: the witness lying from {LC_FORK:,} on: ErrLightClientAttack, "
          f"one LightClientAttackEvidence each way (make_attack_evidence; common height "
          f"{ev.common_height:,}, conflicting height {ev.conflicting_block.height:,}, "
          f"{len(ev.byzantine_validators)} byzantine validators, {len(data):,} B) in "
          f"{ms_a / 1e3:.3f} s (K1 {launches_a['ed25519_verify']}); verify_light_client_attack "
          f"accepts the witness's evidence against the honest block store: K1/K5/K6 2 each "
          f"({ms_e:.3f} ms)", flush=True)
    return out


def cert_cells(device, card: str) -> dict:
    """Commit certificates on the card: a chain of 4 heights of 150 BLS
    validators (one timestamp a commit) whose provider serves
    commit_certificate; a client bisects 1 -> 3 -> 4, each hop decided by
    the certificate (one aggregate_verify_agg: B1, B3, B2, B4, B5); a
    certificate with a flipped signer bit and one with a forged aggregate
    fall back to the classic path with the classic verdict; a rebuilt
    certificate encodes equal. Returns launches and times."""
    import dataclasses

    from cometbft_tpu_torch import cert, light
    from cometbft_tpu_torch.libs.bits import BitArray
    from cometbft_tpu_torch.light import verifier
    from cometbft_tpu_torch.types import BlockID, Header, PartSetHeader
    from cometbft_tpu_torch.types.light import LightBlock, SignedHeader
    from cometbft_tpu_torch.utils.cmttime import Timestamp

    out: dict = {}
    vals, secrets = bls_set(N_CERT, SEED_CONSUMERS + 5)
    blocks, certs = {}, {}
    for h in range(1, CERT_HEIGHTS + 1):
        header = Header(chain_id=CHAIN_ID, height=h, time=Timestamp(BASE_S + h, 0),
                        validators_hash=vals.hash(), next_validators_hash=vals.hash(),
                        consensus_hash=b"\x01" * 32, app_hash=b"\x02" * 32,
                        proposer_address=vals.validators[0].address)
        bid = BlockID(header.hash(), PartSetHeader(1, b"\x09" * 32))
        commit, _ = bls_commit(vals, secrets, h, SEED_CONSUMERS + 5, shared_ts=True, bid=bid)
        blocks[h] = LightBlock(SignedHeader(header, commit), vals)
        certs[h] = cert.build_certificate(CHAIN_ID, vals, commit)
        if certs[h] is None or cert.build_certificate(
                CHAIN_ID, vals, commit).encode() != certs[h].encode() or \
                cert.CommitCertificate.decode(certs[h].encode()).encode() != certs[h].encode():
            raise AssertionError(f"certificate {h}: not built, or a rebuild encodes otherwise")

    class Certified(light.MemProvider):
        def __init__(self, served: dict):
            super().__init__(CHAIN_ID, blocks, "certified")
            self.certs = served

    def run(served, label):
        client = _client(Certified(served), [light.MemProvider(CHAIN_ID, blocks, "w")],
                         blocks[1])
        if served is None:
            client.cert_source = None
        hops = []
        for h in (3, CERT_HEIGHTS):
            got, ms, launches = consumer_counted(lambda: _verify_at(client, h), device)
            if not isinstance(got, LightBlock) or got.hash() != blocks[h].hash():
                raise AssertionError(f"certificates {label}: height {h} gave {got!r}")
            hops.append((ms, launches))
        return client, hops

    client, hops = run(certs, "served")
    if (client.cert_hits, client.cert_fallbacks) != (2, 0):
        raise AssertionError(f"certificates: hits {client.cert_hits}, fallbacks "
                             f"{client.cert_fallbacks}")
    for ms, launches in hops:
        expect("certificate hop", launches, {"bls_hash_to_g2": 1, "bls_miller": 1,
                                             "bls_final_exp": 1, "bls_decompress_g2": 1,
                                             "bls_point_sum_g2": 0, "ed25519_verify": 0})
    classic, hops_c = run(None, "classic")
    flipped = {h: dataclasses.replace(c, signers=BitArray.from_bools(
        [b != (i == 1) for i, b in enumerate(c.signers)])) for h, c in certs.items()}
    forged = {h: dataclasses.replace(c, agg_sig=certs[h % CERT_HEIGHTS + 1].agg_sig)
              for h, c in certs.items()}
    for served, label in ((flipped, "flipped signer bit"), (forged, "forged aggregate")):
        c, hops_x = run(served, label)
        if (c.cert_hits, c.cert_fallbacks) != (0, 2) or c.store._heights != classic.store._heights:
            raise AssertionError(f"certificates {label}: hits {c.cert_hits}, fallbacks "
                                 f"{c.cert_fallbacks}, stored {c.store._heights}")
        for (_, launches), (_, want) in zip(hops_x, hops_c):
            expect(f"certificates {label}", launches,
                   {k: want[k] for k in ("bls_point_sum_g2", "bls_miller", "bls_final_exp")})
    sh3, sh4 = blocks[3].signed_header, blocks[4].signed_header
    now = Timestamp(NOW_S, 0)

    def hop():
        if not verifier.verify_with_certificate(sh3, vals, sh4, vals, PERIOD_NS, now,
                                                10 * 10**9, verifier.DEFAULT_TRUST_LEVEL,
                                                certs[4]):
            raise AssertionError("certificate hop: not accepted")
    hop()
    hop_ms = time_wall(hop, 5, device)
    out["hop_ms"] = hop_ms
    out["launches_cert_hop"] = dict(hops[1][1])
    print(f"[{card}] certificates ({N_CERT} BLS validators): hops 1 -> 3 and 3 -> 4 each decided "
          f"by the certificate (cert_hits 2): B1 G2 1, B3 G1 {hops[1][1]['bls_point_sum_g1']}, "
          f"B2 1, B4 1, B5 1 a hop, no per-vote sum; a flipped signer bit and a forged aggregate "
          f"fall back (cert_fallbacks 2 each) to the classic path's verdict and launches (B3 G2 "
          f"{hops_c[1][1]['bls_point_sum_g2']} a hop); a rebuilt certificate encodes equal "
          f"({len(certs[4].encode())} B); one certificate hop (verify_with_certificate, warm, "
          f"median of 5): {hop_ms:.3f} ms", flush=True)
    return out


def secp_cell(device) -> None:
    """A 4-validator commit with one secp256k1 validator (its key carried
    through the validator set's proto): verify_commit takes the serial path
    and launches nothing."""
    from cometbft_tpu_torch.crypto import secp256k1
    from cometbft_tpu_torch.types import Validator, ValidatorSet
    from cometbft_tpu_torch.types import validation as V

    ed_vals, secrets = make_set(3, SEED_CONSUMERS + 6, "ed25519")
    priv = secp256k1.gen_priv_key_from_secret(b"consumers-secp256k1")
    vals = ValidatorSet.from_proto(ValidatorSet(
        ed_vals.validators + [Validator.new(priv.pub_key(), 10)]).to_proto())
    commit, bid = sign_commit(vals, secrets, VOTE_H, SEED_CONSUMERS + 6)
    i = next(j for j, v in enumerate(vals.validators) if v.pub_key.type_() == "secp256k1")
    commit.signatures[i].signature = priv.sign(commit.vote_sign_bytes(CHAIN_ID, i))
    _, ms, launches = consumer_counted(
        lambda: V.verify_commit(CHAIN_ID, vals, bid, VOTE_H, commit), device)
    if any(launches.values()):
        raise AssertionError(f"secp256k1 commit: launches {launches}")
    bad = with_bad_signature(commit, i)
    try:
        V.verify_commit(CHAIN_ID, vals, bid, VOTE_H, bad)
        raise AssertionError("secp256k1 commit: a tampered signature verified")
    except V.ErrInvalidCommitSignature as e:
        if f"wrong signature (#{i})" not in str(e):
            raise AssertionError(f"secp256k1 commit: {e}") from e
    print(f"consumers secp256k1: a commit of 3 ed25519 + 1 secp256k1 validators verified on the "
          f"serial path, no launch ({ms:.3f} ms); its secp256k1 signature tampered: "
          f"ErrInvalidCommitSignature (#{i})", flush=True)


def consumers_phase(device, card: str) -> dict:
    """The consumers phase, after the mesh phase (the mesh off): VoteSet
    (vote_set_cells), the light client and light-client attack evidence
    (light_cells), commit certificates (cert_cells), secp256k1
    (secp_cell). Returns each path's launches and the times."""
    from cometbft_tpu_torch import sched
    from cometbft_tpu_torch.crypto import batch as crypto_batch
    from cometbft_tpu_torch.parallel import mesh as M

    t_phase = time.perf_counter()
    crypto_batch.set_backend("gpu")
    M.reset()
    sched.reset()
    out = {"votes": vote_set_cells(device, card)}
    out["light"] = light_cells(device, card)
    out["cert"] = cert_cells(device, card)
    secp_cell(device)
    sched.reset()
    v, lc = out["votes"], out["light"]["bisection"]
    print(f"[{card}] consumers (measurements, not claims): VoteSet {N_VOTES:,} flush_pending "
          f"{v['flush_10k']['warm_ms']:.3f} ms (warm, median of 5), 150-vote flush "
          f"{v['flush_150']['warm_ms']:.3f} ms; light bisection {LC_HEIGHT:,} x {N_LIGHT} "
          f"{lc['wall_ms'] / 1e3:.3f} s in {lc['hops']} hops; certificate hop "
          f"{out['cert']['hop_ms']:.3f} ms; consumers phase {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return out


# ------------------------------------------------------------- consensus phase

SEED_CONSENSUS = 16  # the consensus phase's keys (torch_net_harness seeds, seen nowhere else)
NET_HEIGHTS, EXT_HEIGHTS, MIXED_HEIGHTS = 10, 5, 3
N_TXS, BAD_TXS = 64, (17, 45)  # signed txs through check_tx; the two forged
N_HUB, HUB_HEIGHTS = 150, 5  # BASELINE config 2: one real node among 150 validators
HUB_TAMPER = (2, 7)  # (height, validator index): the stub that signs one tampered prevote
HUB_EQUIVOCATE = (2, 11)  # (height, validator index): the stub that equivocates once
HUB_SIGNERS = 8  # processes signing the stubs' votes
NET_TIMEOUT_S = 120  # a cell's heights must commit within this
# the plain versions the consensus path must never take on the card
PLAIN_ON_PATH = (("verify_kernel", "verify_math_ok"), ("verify_kernel", "verify_math_sr_ok"),
                 ("verify_kernel", "decompress_math"), ("verify_kernel", "decompress_sr_math"),
                 ("challenge", "derive_plain"), ("integrity", "parts_plain"))


def _harness():
    """tests/torch_net_harness.py, as bench.py puts tests/ on the path."""
    import os

    here = os.path.dirname(os.path.abspath(__file__))
    if os.path.join(here, "tests") not in sys.path:
        sys.path.insert(0, os.path.join(here, "tests"))
    import torch_net_harness

    return torch_net_harness


class ConsensusProbe:
    """While entered: every ConsensusState vote flush, BlockExecutor
    validate_block and apply_block is timed (host clock; each ends on a
    fetch of its verdicts) with the launches made during it and the
    challenge planner's counters (ops/challenge.stats: a batch whose rows
    the planner declines, e.g. fewer than challenge.MIN_LANES rows of one
    geometry, takes host k and no K5, by design), and every call of a
    kernel's plain version is counted (the path must make none)."""

    def __init__(self):
        self.flushes, self.validates, self.applies = [], [], []
        self.plain = 0

    def __enter__(self):
        import importlib

        from cometbft_tpu_torch.consensus.state import ConsensusState
        from cometbft_tpu_torch.ops import challenge as CH
        from cometbft_tpu_torch.state.execution import BlockExecutor

        probe = self
        self._saved = [(ConsensusState, "_flush_vote_set", ConsensusState._flush_vote_set),
                       (BlockExecutor, "validate_block", BlockExecutor.validate_block),
                       (BlockExecutor, "apply_block", BlockExecutor.apply_block)]
        flush, validate, apply = (f for _, _, f in self._saved)
        self._nested = 0.0

        async def flush_probe(cs, vs):
            rows, ext = len(vs._pending), vs.extensions_enabled
            before, plan, t0 = _consumer_launches(), CH.stats(), time.perf_counter()
            await flush(cs, vs)
            probe.flushes.append(dict(node=id(cs), height=vs.height, rows=rows, ext=ext,
                                      kind=int(vs.signed_msg_type),
                                      ms=(time.perf_counter() - t0) * 1e3,
                                      launches=_delta(before, _consumer_launches()),
                                      plan=_delta(plan, CH.stats())))

        def validate_probe(ex, state, block, last_commit_verified=False):
            before, plan, t0 = _consumer_launches(), CH.stats(), time.perf_counter()
            validate(ex, state, block, last_commit_verified)
            ms = (time.perf_counter() - t0) * 1e3
            probe._nested += ms
            lc = block.last_commit
            probe.validates.append(dict(
                node=id(ex), height=block.header.height, ms=ms, lcv=last_commit_verified,
                sigs=sum(1 for s in lc.signatures if s.signature) if lc else 0,
                launches=_delta(before, _consumer_launches()), plan=_delta(plan, CH.stats())))

        async def apply_probe(ex, state, block_id, block, **kw):
            nested0, t0 = probe._nested, time.perf_counter()
            out = await apply(ex, state, block_id, block, **kw)
            ms = (time.perf_counter() - t0) * 1e3
            probe.applies.append(dict(node=id(ex), height=block.header.height,
                                      ms=ms - (probe._nested - nested0)))
            return out

        ConsensusState._flush_vote_set = flush_probe
        BlockExecutor.validate_block = validate_probe
        BlockExecutor.apply_block = apply_probe
        self._plain = []
        for mod, name in PLAIN_ON_PATH:
            m = importlib.import_module(f"cometbft_tpu_torch.ops.{mod}")
            fn = getattr(m, name)
            self._plain.append((m, name, fn))

            def counted(*a, _fn=fn, **k):
                probe.plain += 1
                return _fn(*a, **k)

            setattr(m, name, counted)
        return self

    def __exit__(self, *exc):
        for owner, name, fn in self._saved + self._plain:
            setattr(owner, name, fn)
        return False

    def calls(self) -> list[dict]:
        """The batched calls: flushes of >= 2 votes, validate_block with a
        LastCommit that block sync has not already verified."""
        return [f for f in self.flushes if f["rows"] >= 2] + \
            [v for v in self.validates if v["sigs"] >= 1 and not v["lcv"]]

    def check_launched(self, label: str) -> dict:
        """Every batched call launched K1 and K6 (riders and the deadline
        worker may add launches; none may be missing) and K5 unless the
        challenge planner declined its rows (a plan_* counter moved), and no
        plain version ran. Returns the calls with K5 and the planner's
        reasons for the others."""
        if self.plain:
            raise AssertionError(f"{label}: {self.plain} calls of a plain version")
        calls = self.calls()

        def host_k(c):
            return any(k.startswith("plan_") for k in c["plan"])

        bad = [c for c in calls
               if c["launches"].get("ed25519_verify", 0) < 1
               or c["launches"].get("integrity_parts", 0) < 1
               or (c["launches"].get("challenge_derive", 0) < 1 and not host_k(c))]
        if not calls or bad:
            raise AssertionError(f"{label}: {len(bad)} of {len(calls)} flushes and "
                                 f"validate_block calls without K1/K6, or without K5 and "
                                 f"no plan declined: {bad[:3]}")
        reasons = collections.Counter(k for c in calls if not c["launches"].get(
            "challenge_derive") for k in c["plan"] if k.startswith("plan_"))
        return {"calls": len(calls), "k5": sum(1 for c in calls
                                               if c["launches"].get("challenge_derive")),
                "host_k": dict(reasons)}


def _delta(before: dict, after: dict) -> dict:
    return {k: after[k] - before.get(k, 0) for k in after if after[k] != before.get(k, 0)}


def _heightline(nodes) -> dict:
    from cometbft_tpu_torch.consensus import timeline as TL

    docs = [{"node_id": n.name, "heights": n.cs.timeline.snapshot(), "skew": {}} for n in nodes]
    return TL.aggregate(docs).get("summary") or {}


def _net_config(**kw):
    from cometbft_tpu_torch.consensus.config import test_consensus_config

    cfg = test_consensus_config()
    cfg.batch_vote_verification = True
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


async def _net_cell(label: str, heights: int, device, card: str, txs: bool = False, **net_kw):
    """A 4-validator in-process net on the card until every node holds
    `heights` blocks: per-height gaps (bench.py:1213's stamps), the
    heightline, and with `txs` N_TXS signed txs through check_tx."""
    import asyncio

    H = _harness()
    from cometbft_tpu_torch.mempool.mempool import ErrTxBadSignature, MempoolConfig

    net_kw.setdefault("config", _net_config())
    if txs:
        net_kw.update(app_factory=H.SignedKVStoreApplication,
                      mempool_config=MempoolConfig(tx_verify="ed25519"))
    net = await H.make_net(4, chain_id=f"consensus-{label}", device=device,
                           seed=SEED_CONSENSUS, **net_kw)
    for n in net.nodes:
        n.cs.timeline.node = n.name
    keys = [H.gen_priv("ed25519", 100 + i, SEED_CONSENSUS) for i in range(4)]
    tx_out: list = []

    admit_ms: list[float] = []

    async def submit(i: int):
        tx = H.signed_tx(keys[i % 4], b"tx%d=%d" % (i, i), forge=i in BAD_TXS)
        t = time.perf_counter()
        try:
            res = await net.nodes[i % 4].mempool.check_tx(tx)
            tx_out.append((i, "ok" if res.is_ok() else f"code {res.code}"))
        except ErrTxBadSignature:
            tx_out.append((i, "bad signature"))
        admit_ms.append((time.perf_counter() - t) * 1e3)

    stamps, t0 = {}, time.perf_counter()
    await net.start()
    try:
        last, wave = 0, 0
        while last < heights:
            h = net.min_height()
            if h > last:
                stamps[h] = time.perf_counter()
                last = h
                if txs and wave < 4 and h >= 1:
                    # 16 txs a height from height 1 on, spread over the nodes
                    await asyncio.gather(*(submit(i) for i in range(16 * wave, 16 * wave + 16)))
                    wave += 1
            if net.failed():
                raise AssertionError(f"{label}: consensus failure on {net.failed()}")
            if time.perf_counter() - t0 > NET_TIMEOUT_S:
                raise AssertionError(f"{label}: {net.min_height()} of {heights} heights in "
                                     f"{NET_TIMEOUT_S} s")
            await asyncio.sleep(0.002)
    finally:
        await net.stop()
    wall = time.perf_counter() - t0
    hashes = [{n.block_store.load_block(h).hash() for n in net.nodes} for h in range(1, heights + 1)]
    if any(len(s) != 1 for s in hashes):
        raise AssertionError(f"{label}: the nodes' blocks differ: {hashes}")
    gaps = sorted(stamps[h + 1] - stamps[h] for h in stamps if h + 1 in stamps)
    return net, dict(wall_s=wall, gaps_ms=[g * 1e3 for g in gaps],
                     p50_ms=gaps[len(gaps) // 2] * 1e3 if gaps else None,
                     heightline=_heightline(net.nodes), txs=sorted(tx_out),
                     admit_ms=sorted(admit_ms))


def net4_cell(device, card: str) -> dict:
    """bench.py:1213's shape: 4 validators, NET_HEIGHTS heights, N_TXS signed
    txs (BAD_TXS forged) admitted through the scheduler's MEMPOOL class,
    riding the vote flushes or the deadline worker's batches."""
    import asyncio

    from cometbft_tpu_torch import sched

    with ConsensusProbe() as probe:
        _consumer_reset()
        net, r = asyncio.run(_net_cell("net4", NET_HEIGHTS, device, card, txs=True))
        launches = _consumer_launches()
    k5 = probe.check_launched("net4")
    # the mempool class's deadline misses (dispatched later than 10 ms + 5 ms
    # after submit) are measured, not asserted: the event loop that runs the
    # four nodes also holds the GIL the deadline worker needs (PERF.md §6)
    health = sched.get().health()
    if health["recheck_flips"]:
        raise AssertionError(f"net4: scheduler health {health}")
    good = sorted(set(range(N_TXS)) - set(BAD_TXS))
    want = [(i, "bad signature" if i in BAD_TXS else "ok") for i in range(N_TXS)]
    if r["txs"] != want:
        raise AssertionError(f"net4: check_tx outcomes {r['txs']}")
    for n in net.nodes:
        held = sorted(int(k[2:]) for k in n.app.state if k.startswith("tx"))
        if held != good:
            raise AssertionError(f"net4: {n.name}'s app holds txs {held}")
    _print_net(card, "net4", r, probe, launches, k5)
    adm = r["admit_ms"]
    print(f"[{card}] consensus net4 mempool: {len(adm)} check_tx, admission (check_tx call "
          f"to return) p50 {adm[len(adm) // 2]:.3f} ms, max {adm[-1]:.3f} ms; scheduler "
          f"deadline misses {health['deadline_miss_by_class']}, worker flushes "
          f"{health['worker_flushes']}, class rows {health['class_rows']}, recheck flips "
          f"{health['recheck_flips']}", flush=True)
    return dict(r, launches=launches, k5=k5, flushes=len(probe.flushes),
                validates=len(probe.validates), class_rows=health["class_rows"],
                deadline_misses=health["deadline_miss_by_class"])


def ext_cell(device, card: str) -> dict:
    """net4 with vote extensions from height 2: a precommit flush's
    extension batch is a second K1 launch."""
    import asyncio

    with ConsensusProbe() as probe:
        _consumer_reset()
        net, r = asyncio.run(_net_cell("net4-ext", EXT_HEIGHTS, device, card,
                                       ext_enable_height=2))
        launches = _consumer_launches()
    k5 = probe.check_launched("net4-ext")
    ext = [f for f in probe.flushes if f["ext"] and f["rows"] >= 2 and f["height"] >= 2]
    if not ext or any(f["launches"].get("ed25519_verify", 0) < 2 for f in ext):
        raise AssertionError(f"net4-ext: extension flushes {ext[:3]}")
    if any(net.nodes[0].block_store.load_block_extended_commit(h) is None
           for h in range(2, EXT_HEIGHTS)):
        raise AssertionError("net4-ext: no extended commit stored")
    _print_net(card, "net4-ext", r, probe, launches, k5)
    return dict(r, launches=launches, k5=k5, ext_flushes=len(ext))


def mixed_cell(device, card: str) -> dict:
    """2 ed25519, 1 sr25519 and 1 BLS12-381 validator: K2 and the BLS
    kernels on the consensus path."""
    import asyncio

    with ConsensusProbe() as probe:
        _consumer_reset()
        net, r = asyncio.run(_net_cell(
            "net4-mixed", MIXED_HEIGHTS, device, card,
            key_schemes=["ed25519", "ed25519", "sr25519", "bls12381"],
            config=_net_config(timeout_propose=3.0, timeout_prevote=1.0,
                               timeout_precommit=1.0)))
        launches = _consumer_launches()
    if probe.plain:
        raise AssertionError(f"net4-mixed: {probe.plain} calls of a plain version")
    for k in ("sr25519_verify", "ed25519_verify", "bls_decompress_g1", "bls_decompress_g2",
              "bls_hash_to_g2", "bls_miller", "bls_final_exp"):
        if launches.get(k, 0) < 1:
            raise AssertionError(f"net4-mixed: {k} never launched: {launches}")
    _print_net(card, "net4-mixed", r, probe, launches, {})
    return dict(r, launches=launches)


def hub_cell(device, card: str) -> dict:
    import asyncio
    import multiprocessing

    from cometbft_tpu_torch.crypto import ed25519_math

    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(HUB_SIGNERS, mp_context=ctx) as pool, \
            ConsensusProbe() as probe:
        # the signers start (a fresh interpreter each) before the run
        list(pool.map(ed25519_math.sign, [bytes(32)] * HUB_SIGNERS, [b""] * HUB_SIGNERS))
        out = asyncio.run(_hub_cell(device, card, pool, probe))
    out["k5"] = probe.check_launched("hub150")
    print(f"[{card}] consensus hub150: batched calls with K5 / host k (planner's reasons): "
          f"{out['k5']}", flush=True)
    return out


def consensus_phase(device, card: str) -> dict:
    """The consensus phase, after the consumers phase (the mesh off): the
    port's ConsensusState, BlockExecutor, kvstore over its local ABCI
    client, mempool, stores and FilePV as in-process validator nets
    (tests/torch_net_harness.py) on the card: net4 (bench.py:1213's shape,
    N_TXS signed txs), net4-ext (vote extensions from height 2), net4-mixed
    (ed25519, sr25519 and BLS12-381 validators) and hub150 (one real node
    among BASELINE config 2's 150 validators, 149 of them stubs). Every
    cell starts from a fresh scheduler and key tables. Returns each cell's
    launches and times."""
    from cometbft_tpu_torch import sched
    from cometbft_tpu_torch.consensus import timeline as TL
    from cometbft_tpu_torch.crypto import batch as crypto_batch
    from cometbft_tpu_torch.ops import residency
    from cometbft_tpu_torch.parallel import mesh as M

    t_phase = time.perf_counter()
    crypto_batch.set_backend("gpu")
    M.reset()
    TL.configure(enabled=True)
    out = {}
    try:
        for label, cell in (("net4", net4_cell), ("net4-ext", ext_cell),
                            ("net4-mixed", mixed_cell), ("hub150", hub_cell)):
            sched.reset()
            residency.reset()
            out[label] = cell(device, card)
    finally:
        TL.reset()
        sched.reset()
        residency.reset()
    print(f"[{card}] consensus phase (measurements, not claims): "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return out


def _print_net(card: str, label: str, r: dict, probe: ConsensusProbe, launches: dict,
               k5: dict) -> None:
    hl = r["heightline"]
    flush_ms = [f["ms"] for f in probe.flushes if f["rows"] >= 2]
    val_ms = [v["ms"] for v in probe.validates if v["sigs"]]
    print(f"[{card}] consensus {label}: {len(r['gaps_ms']) + 1} heights in {r['wall_s']:.3f} s, "
          f"per-height p50 {r['p50_ms']:.3f} ms (gaps {[round(g, 3) for g in r['gaps_ms']]}); "
          f"heightline phase_ms {hl.get('phase_ms')}, total {hl.get('phase_total_ms')}; "
          f"{len(flush_ms)} batched flushes (median {statistics.median(flush_ms):.3f} ms), "
          f"{len(val_ms)} validate_block with a LastCommit (median "
          f"{statistics.median(val_ms):.3f} ms); batched calls with K5 / host k (planner's "
          f"reasons): {k5}; launches {({k: v for k, v in launches.items() if v})}",
          flush=True)


async def _hub_cell(device, card: str, pool, probe: ConsensusProbe) -> dict:
    import asyncio

    H = _harness()
    from cometbft_tpu_torch.consensus import timeline as TL

    cfg = _net_config(timeout_propose=5.0, timeout_prevote=3.0, timeout_precommit=3.0)
    hub = await H.make_hub(N_HUB, real=0, config=cfg, device=device, seed=SEED_CONSENSUS,
                           tamper=HUB_TAMPER, equivocate=HUB_EQUIVOCATE, sign_pool=pool)
    hub.node.cs.timeline.node = "real"
    _consumer_reset()
    t0 = time.perf_counter()
    await hub.start()
    try:
        await hub.wait_for_height(HUB_HEIGHTS, timeout=NET_TIMEOUT_S)
    finally:
        await hub.stop()
    wall = time.perf_counter() - t0
    launches = _consumer_launches()
    bs = hub.node.block_store
    if hub.misbehavior != [(hub.stub_name(HUB_TAMPER[1]), "invalid-vote-signature")]:
        raise AssertionError(f"hub150: misbehavior {hub.misbehavior}")
    ev_heights = [h for h in range(1, bs.height() + 1) if bs.load_block(h).evidence.evidence]
    if len(ev_heights) != 1 or hub.equivocated != [HUB_EQUIVOCATE]:
        raise AssertionError(f"hub150: evidence in blocks {ev_heights}, {hub.equivocated}")
    ev = bs.load_block(ev_heights[0]).evidence.evidence[0]
    if (ev.height(), ev.vote_a.validator_index) != HUB_EQUIVOCATE:
        raise AssertionError(f"hub150: evidence {ev.string()}")
    stub_blocks = {h for idx, hs in hub.proposed.items() for h in hs}
    full = [v["sigs"] for v in probe.validates if v["height"] in stub_blocks and v["height"] > 1]
    if not full or any(s != N_HUB for s in full):
        raise AssertionError(f"hub150: validated LastCommits of {full} signatures")
    widest = max(f["rows"] for f in probe.flushes)
    # per height: proposal received -> apply done, split into flushes,
    # validate_block, apply_block (without its validate_block) and the rest
    rows = []
    for rec in hub.node.cs.timeline.snapshot():
        h, ev_marks = rec["height"], rec["events"]
        if h > HUB_HEIGHTS or TL.PROPOSAL_RECEIVED not in ev_marks or \
                TL.APPLY_DONE not in ev_marks:
            continue
        total = (ev_marks[TL.APPLY_DONE]["mono_ns"] -
                 ev_marks[TL.PROPOSAL_RECEIVED]["mono_ns"]) / 1e6
        fl = sum(f["ms"] for f in probe.flushes if f["height"] == h)
        va = sum(v["ms"] for v in probe.validates if v["height"] == h)
        ap = sum(a["ms"] for a in probe.applies if a["height"] == h)
        rows.append(dict(height=h, total_ms=total, flush_ms=fl, validate_ms=va, apply_ms=ap,
                         rest_ms=total - fl - va - ap,
                         flush_rows=[f["rows"] for f in probe.flushes if f["height"] == h]))
    for row in rows:
        print(f"[{card}] consensus hub150 height {row['height']}: proposal -> commit "
              f"{row['total_ms']:.3f} ms = flushes {row['flush_ms']:.3f} (rows "
              f"{row['flush_rows']}) + validate_block {row['validate_ms']:.3f} + apply_block "
              f"{row['apply_ms']:.3f} + rest {row['rest_ms']:.3f}", flush=True)
    print(f"[{card}] consensus hub150: {bs.height()} heights in {wall:.3f} s, widest flush "
          f"{widest} rows, LastCommits validated at {sorted(set(full))} signatures, evidence "
          f"committed at height {ev_heights[0]}, stubs' signing {hub.sign_s:.3f} s on "
          f"{HUB_SIGNERS} processes; launches { {k: v for k, v in launches.items() if v} }",
          flush=True)
    return dict(wall_s=wall, launches=launches, per_height=rows, widest_flush=widest,
                evidence_height=ev_heights[0], sign_s=hub.sign_s)


# ------------------------------------------------------------------ the wire

SEED_WIRE = 17  # the wire phase's keys (torch_tcp_harness seeds, seen nowhere else)
WIRE_HEIGHTS = 10  # tcp4's heights (more if the gossiped txs are not all committed by then)
N_SYNC, SYNC_VALS, SYNC_WINDOW = 1_000, 150, 32  # BASELINE config 3, its depth cut from 10,000
SYNC_BAD = 77  # the signature the lying peer flips in every LastCommit it serves
SYNC_TIMEOUT_S = 240  # the sync must reach the tip within this


def _tcp_harness():
    """tests/torch_tcp_harness.py (tests/ on the path, as for _harness)."""
    _harness()
    import torch_tcp_harness

    return torch_tcp_harness


def _mconn_bytes(nodes) -> tuple[int, int]:
    """Bytes sent and received over every node's peer connections
    (MConnection.status(): wire bytes of the encoded packets)."""
    sent = recv = 0
    for n in nodes:
        for p in n.switch.peers.values():
            st = p.status()
            sent += st["send"]["bytes_total"]
            recv += st["recv"]["bytes_total"]
    return sent, recv


async def _tcp4(device, card: str) -> dict:
    import asyncio

    H, T = _harness(), _tcp_harness()
    from cometbft_tpu_torch.mempool.mempool import ErrTxBadSignature, MempoolConfig

    net = await T.make_tcp_net(4, config=_net_config(), chain_id="wire-tcp4", device=device,
                               app_factory=H.SignedKVStoreApplication,
                               mempool_config=MempoolConfig(tx_verify="ed25519"),
                               seed=SEED_WIRE)
    for n in net.nodes:
        n.cs.timeline.node = n.name
    key = H.gen_priv("ed25519", 100, SEED_WIRE)
    txs = [H.signed_tx(key, b"tx%d=%d" % (i, i), forge=i in BAD_TXS) for i in range(N_TXS)]
    good = sorted(set(range(N_TXS)) - set(BAD_TXS))

    def committed_everywhere() -> bool:
        return all(sum(k.startswith("tx") for k in n.node.app.state) == len(good)
                   for n in net.nodes)

    async def submit_all():
        # all 64 to one node: the mempool reactor gossips the good ones,
        # each receiver admits them as MEMPOOL rows of its own
        for i, tx in enumerate(txs):
            try:
                res = await net.nodes[0].mempool.check_tx(tx)
                outcomes.append((i, "ok" if res.is_ok() else f"code {res.code}"))
            except ErrTxBadSignature:
                outcomes.append((i, "bad signature"))

    stamps, outcomes, submit, t0 = {}, [], None, time.perf_counter()
    await net.start()
    try:
        last = 0
        while last < WIRE_HEIGHTS or not committed_everywhere():
            h = min(n.block_store.height() for n in net.nodes)
            if h > last:
                stamps[h] = time.perf_counter()
                if submit is None:  # a task of its own: the stamps go on
                    submit = asyncio.get_running_loop().create_task(submit_all())
                last = h
            if net.failed():
                raise AssertionError(f"tcp4: consensus failure on {net.failed()}")
            if time.perf_counter() - t0 > NET_TIMEOUT_S:
                raise AssertionError(f"tcp4: {h} heights in {NET_TIMEOUT_S} s, txs committed "
                                     f"everywhere: {committed_everywhere()}")
            await asyncio.sleep(0.002)
        await submit
        sent, recv = _mconn_bytes(net.nodes)
    finally:
        if submit is not None and not submit.done():
            submit.cancel()
        await net.stop()
    wall = time.perf_counter() - t0
    heights = min(n.block_store.height() for n in net.nodes)
    for h in range(1, heights + 1):
        if len({n.block_store.load_block(h).hash() for n in net.nodes}) != 1:
            raise AssertionError(f"tcp4: the nodes' blocks differ at height {h}")
    want = [(i, "bad signature" if i in BAD_TXS else "ok") for i in range(N_TXS)]
    if outcomes != want:
        raise AssertionError(f"tcp4: check_tx outcomes {outcomes}")
    committed = [tx for h in range(1, heights + 1)
                 for tx in net.nodes[0].block_store.load_block(h).data.txs]
    if any(txs[i] in committed for i in BAD_TXS):
        raise AssertionError("tcp4: a forged tx is in a block")
    for n in net.nodes:
        held = sorted(int(k[2:]) for k in n.node.app.state if k.startswith("tx"))
        if held != good:
            raise AssertionError(f"tcp4: {n.name}'s app holds txs {held}")
    gaps = sorted(stamps[h + 1] - stamps[h] for h in stamps if h + 1 in stamps)
    return dict(wall_s=wall, heights=heights, gaps_ms=[g * 1e3 for g in gaps],
                p50_ms=gaps[len(gaps) // 2] * 1e3, heightline=_heightline(net.nodes),
                sent=sent, recv=recv)


def tcp4_cell(device, card: str) -> dict:
    """4 ed25519 validators over loopback TCP (SecretConnection, MConnection,
    Switch; the consensus, mempool and evidence reactors), WIRE_HEIGHTS
    heights, N_TXS signed txs (BAD_TXS forged) handed to one node."""
    import asyncio

    from cometbft_tpu_torch import sched
    from cometbft_tpu_torch.p2p.conn import secret_connection as SC

    with ConsensusProbe() as probe:
        _consumer_reset()
        r = asyncio.run(_tcp4(device, card))
        launches = _consumer_launches()
    k5 = probe.check_launched("tcp4")
    health = sched.get().health()
    # node 0 admits all N_TXS; the others admit what the mempool reactor
    # gossips them, as MEMPOOL-class rows of their own
    if health["class_rows"].get("mempool", 0) <= N_TXS:
        raise AssertionError(f"tcp4: scheduler class rows {health['class_rows']}")
    n_h = r["heights"]
    per_h = {k: round(launches.get(k, 0) / n_h, 3)
             for k in ("challenge_derive", "ed25519_verify", "integrity_parts")}
    hl = r["heightline"]
    print(f"[{card}] wire tcp4: {n_h} heights over loopback TCP in {r['wall_s']:.3f} s, "
          f"per-height gap ({len(r['gaps_ms'])} gaps) p50 {r['p50_ms']:.3f} ms, min "
          f"{r['gaps_ms'][0]:.3f}, max "
          f"{r['gaps_ms'][-1]:.3f} (PR 16's in-process net4: 224.8-237.7 ms p50); heightline "
          f"phase_ms {hl.get('phase_ms')}, total {hl.get('phase_total_ms')}; K5/K1/K6 launches "
          f"a height {per_h}; MConnection bytes a height sent {r['sent'] / n_h:.0f}, "
          f"received {r['recv'] / n_h:.0f} (all nodes); AEAD rung {SC.AEAD_RUNG}; "
          f"scheduler class rows {health['class_rows']}; batched calls with K5 / host k "
          f"{k5}; launches {({k: v for k, v in launches.items() if v})}", flush=True)
    return dict(r, launches=launches, k5=k5, per_height=per_h, aead=SC.AEAD_RUNG,
                class_rows=health["class_rows"])


async def _sync150(device, card: str) -> dict:
    import asyncio
    import re

    H, T = _harness(), _tcp_harness()
    from cometbft_tpu_torch.crypto import ed25519_math as O
    from cometbft_tpu_torch.types.genesis import GenesisDoc, GenesisValidator

    H.use_device(device)
    vals, secrets = make_set(SYNC_VALS, SEED_WIRE, "ed25519")
    gdoc = GenesisDoc(genesis_time=H.GENESIS_TIME, chain_id=CHAIN_ID, validators=[
        GenesisValidator(address=v.address, pub_key=v.pub_key, power=v.voting_power)
        for v in vals.validators])
    gdoc.validate_and_complete()

    def sign(address: bytes, msg: bytes) -> bytes:
        _, a, r, renc, pub = secrets[address]
        return renc + ((r + O.sha512_mod_l(renc, pub, msg) * a) % O.L).to_bytes(32, "little")

    t0 = time.perf_counter()
    chain = await T.build_chain(gdoc, N_SYNC, sign)
    build_s = time.perf_counter() - t0
    hkey, htr, hsw = T.serve_node("honest", gdoc, chain.block_store, SEED_WIRE)
    liar = T.LyingStore(chain.block_store, SYNC_BAD)
    lkey, ltr, lsw = T.serve_node("liar", gdoc, liar, SEED_WIRE)
    node = await T.sync_node(gdoc, SYNC_WINDOW, seed=SEED_WIRE)
    haddr, laddr = await htr.listen("127.0.0.1:0"), await ltr.listen("127.0.0.1:0")
    await node.transport.listen("127.0.0.1:0")
    for sw in (hsw, lsw, node.switch):
        await sw.start()
    top = N_SYNC - 1  # the tip waits for its successor's commit
    t0 = time.perf_counter()
    try:
        # the liar first, so that it is asked for blocks before the honest
        # peer is there to take them
        await node.switch.dial_peers_async([f"{lkey.id()}@{laddr}"])
        while liar.served == 0:
            if time.perf_counter() - t0 > SYNC_TIMEOUT_S:
                raise AssertionError("sync150: the lying peer served no block")
            await asyncio.sleep(0.005)
        await node.switch.dial_peers_async([f"{hkey.id()}@{haddr}"], persistent=True)
        while node.block_store.height() < top or node.reactor.active:
            if time.perf_counter() - t0 > SYNC_TIMEOUT_S:
                raise AssertionError(f"sync150: {node.block_store.height()} of {top} blocks in "
                                     f"{SYNC_TIMEOUT_S} s")
            await asyncio.sleep(0.01)
        wall = time.perf_counter() - t0
        await asyncio.sleep(0.05)  # the handed-over consensus enters its height
        rs_height = node.cs.rs.height
    finally:
        for sw in (node.switch, hsw, lsw):
            await sw.stop()
        await node.conns.stop()
    log = node.log.getvalue()
    caught = re.findall(r"invalid block in sync height=(\d+) err=\"[^\"]*#(\d+)\)", log)
    if not caught or any(int(i) != SYNC_BAD for _, i in caught):
        raise AssertionError(f"sync150: the tampered signature was not pinpointed: {log[-1500:]}")
    lid = lkey.id()
    if lid in node.switch.peers or lid not in node.switch.scorer.snapshot():
        raise AssertionError("sync150: the lying peer was not stopped for its blocks")
    for h in range(1, top + 1):
        mine, honest = node.block_store.load_block(h), chain.block_store.load_block(h)
        if mine.hash() != honest.hash() or mine.last_commit.hash() != honest.last_commit.hash():
            raise AssertionError(f"sync150: block {h} is not the honest chain's")
    state = node.state_store.load()
    if state.to_bytes() != chain.states[top] or \
            state.app_hash != chain.block_store.load_block(N_SYNC).header.app_hash:
        raise AssertionError("sync150: the synced State is not the honest chain's")
    if node.cons_reactor.wait_sync or rs_height != N_SYNC:
        raise AssertionError(f"sync150: consensus at height {rs_height}, not {N_SYNC}")
    bcr = node.reactor
    return dict(build_s=build_s, sign_s=chain.sign_s, wall_s=wall, blocks=top,
                sigs=top * SYNC_VALS, windows=bcr.windows, stage_s=bcr.stage_s,
                device_busy_s=bcr.device_busy_s, apply_s=bcr.apply_s, redone=len(caught),
                liar_served=liar.served, chain=chain)


def sync150_cell(device, card: str) -> dict:
    """BASELINE config 3 (cut to N_SYNC blocks): a fresh node syncs a
    150-validator chain from an honest peer and a lying one through
    BlocksyncReactor's SYNC windows, then switches to consensus."""
    import asyncio

    with ConsensusProbe() as probe:
        _consumer_reset()
        r = asyncio.run(_sync150(device, card))
        launches = _consumer_launches()
    if probe.plain:
        raise AssertionError(f"sync150: {probe.plain} calls of a plain version")
    if launches.get("ed25519_verify", 0) < r["windows"]:
        raise AssertionError(f"sync150: {launches} for {r['windows']} windows")
    w = max(r["windows"], 1)
    print(f"[{card}] wire sync150: {r['blocks']} blocks x {SYNC_VALS} validators in "
          f"{r['wall_s']:.3f} s = {r['blocks'] / r['wall_s']:.1f} blocks/s, "
          f"{r['sigs'] / r['wall_s']:.0f} signatures/s; {r['windows']} windows of up to "
          f"{SYNC_WINDOW}: stage {r['stage_s'] / w * 1e3:.3f} ms, prefetch (device wait) "
          f"{r['device_busy_s'] / w * 1e3:.3f} ms, finish + validate + apply "
          f"{r['apply_s'] / w * 1e3:.3f} ms a window; device_busy_s {r['device_busy_s']:.3f}; "
          f"K1 launches a window {launches.get('ed25519_verify', 0) / w:.3f}; the liar served "
          f"{r['liar_served']} blocks, {r['redone']} windows redone; chain build "
          f"{r['build_s']:.3f} s ({r['sign_s']:.3f} s signing); launches "
          f"{({k: v for k, v in launches.items() if v})}", flush=True)
    return dict(r, launches=launches)


def wire_phase(device, card: str) -> dict:
    """The wire phase, after the consensus phase: the port's p2p
    (SecretConnection, MConnection, Switch) with the consensus, mempool and
    evidence reactors as a 4-validator net over loopback TCP (tcp4), and
    BlocksyncReactor syncing BASELINE config 3's 150-validator chain from
    an honest and a lying peer through SYNC windows (sync150)."""
    from cometbft_tpu_torch import sched
    from cometbft_tpu_torch.consensus import timeline as TL
    from cometbft_tpu_torch.crypto import batch as crypto_batch
    from cometbft_tpu_torch.ops import residency
    from cometbft_tpu_torch.parallel import mesh as M

    t_phase = time.perf_counter()
    crypto_batch.set_backend("gpu")
    M.reset()
    TL.configure(enabled=True)
    out = {}
    try:
        for label, cell in (("tcp4", tcp4_cell), ("sync150", sync150_cell)):
            sched.reset()
            residency.reset()
            out[label] = cell(device, card)
    finally:
        TL.reset()
        sched.reset()
        residency.reset()
    print(f"[{card}] wire phase (measurements, not claims): "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return out


# ------------------------------------------------------------------ the node

NODE_HEIGHTS = 20  # node4's heights at the least
NODE_TXS = 40  # kvstore txs handed to one node of node4
NODE_RESTART_LAG = 3  # heights the others commit while node4's stopped node is down
NODE_PROC_HEIGHT = 5  # the four `start` processes' common chain at the least
NODE_TIMEOUT_S = 180  # a node cell must reach its heights within this
PROC_STOP_S = 30  # a `start` process must exit this long after SIGTERM


def _node_root() -> str:
    """build/node_phase in the checkout (build/ is not committed): the
    node homes of the phase, removed when it ends."""
    import os

    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "node_phase")


def _free_ports(n: int) -> list[int]:
    import socket

    socks = []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def _testnet_homes(root: str, n: int, chain_id: str) -> list[str]:
    """`testnet --v n` homes under `root` on the "gpu" backend that
    `testnet` writes, set as the port's node runs today: RPC, PEX and
    certificates off, free loopback ports wired as persistent peers, log
    level error, and the consensus timeouts of the harness nets
    (_net_config), so that node4 compares with tcp4. Stores (sqlite), the
    WAL, the kv indexer and metrics keep the reference's defaults."""
    import os

    from cometbft_tpu_torch.cmd import main as cli
    from cometbft_tpu_torch.config import Config
    from cometbft_tpu_torch.p2p.key import NodeKey

    if cli(["testnet", "--v", str(n), "--o", root, "--chain-id", chain_id]) != 0:
        raise AssertionError(f"testnet --v {n} failed")
    homes = [os.path.join(root, f"node{i}") for i in range(n)]
    ids = [NodeKey.load_or_gen(Config.load(h).node_key_path()).id() for h in homes]
    ports = _free_ports(n)
    for i, h in enumerate(homes):
        c = Config.load(h)
        if c.crypto.backend != "gpu":
            raise AssertionError(f"testnet wrote crypto.backend = {c.crypto.backend!r}")
        c.rpc.laddr = ""
        c.p2p.pex = False
        c.cert.enabled = False
        c.base.log_level = "error"
        c.p2p.laddr = f"tcp://127.0.0.1:{ports[i]}"
        c.p2p.persistent_peers = ",".join(f"{ids[j]}@127.0.0.1:{ports[j]}"
                                          for j in range(n) if j != i)
        c.consensus = _net_config()
        c.save()
    return homes


async def _node4(root: str) -> dict:
    import asyncio

    from cometbft_tpu_torch.config import Config
    from cometbft_tpu_torch.node import Node
    from cometbft_tpu_torch.types.block import tx_hash

    homes = _testnet_homes(root, 4, "node-net4")
    t0 = time.perf_counter()
    nodes = [Node(Config.load(h)) for h in homes]
    for n in nodes:
        await n.start()
    boot_s = time.perf_counter() - t0
    txs = [b"node%d=v%d" % (i, i) for i in range(NODE_TXS)]
    outcomes: list = []

    async def submit_all():
        for tx in txs:
            res = await nodes[0].mempool.check_tx(tx)
            outcomes.append(res.code)

    def in_apps(ns) -> bool:
        return all(sum(k.startswith("node") for k in n.app.state) == NODE_TXS for n in ns)

    def failed(ns):
        return [i for i, n in enumerate(ns) if n.consensus_state.failed]

    stamps, submit, t1 = {}, None, time.perf_counter()
    restarted = None
    try:
        last = 0
        while last < NODE_HEIGHTS or not in_apps(nodes):
            h = min(n.block_store.height() for n in nodes)
            if h > last:
                stamps[h] = time.perf_counter()
                if submit is None:
                    submit = asyncio.get_running_loop().create_task(submit_all())
                last = h
            if failed(nodes) or time.perf_counter() - t1 > NODE_TIMEOUT_S:
                raise AssertionError(f"node4: {h} heights, failed nodes {failed(nodes)}, txs "
                                     f"in every app: {in_apps(nodes)}")
            await asyncio.sleep(0.002)
        await submit
        wall = time.perf_counter() - t1
        heights = min(n.block_store.height() for n in nodes)
        # the consensus height gauge against the block store, sampled
        # between heights; every tx found by every node's indexer
        t2 = time.perf_counter()
        while any(n.consensus_metrics.height.value() != n.block_store.height() for n in nodes):
            if time.perf_counter() - t2 > 5.0:
                raise AssertionError("node4: the height gauge does not follow the block store: "
                                     f"{[(n.consensus_metrics.height.value(), n.block_store.height()) for n in nodes]}")
            await asyncio.sleep(0.001)
        await asyncio.sleep(0.2)  # the indexers drain the event bus
        missing = [(i, tx) for i, n in enumerate(nodes) for tx in txs
                   if n.tx_indexer.get(tx_hash(tx)) is None]
        if missing or outcomes != [0] * NODE_TXS:
            raise AssertionError(f"node4: check_tx codes {outcomes}, not indexed {missing[:4]}")
        # one node stopped and started again from its home: the handshake
        # replays the blocks its fresh kvstore app lacks, the WAL the
        # messages of the height it was in, block sync what the others
        # committed meanwhile
        down = nodes[3]
        h_stop = down.block_store.height()
        await down.stop()
        while min(n.block_store.height() for n in nodes[:3]) < h_stop + NODE_RESTART_LAG:
            if failed(nodes[:3]) or time.perf_counter() - t1 > NODE_TIMEOUT_S:
                raise AssertionError(f"node4: 3 nodes stalled at {h_stop}")
            await asyncio.sleep(0.01)
        t3 = time.perf_counter()
        restarted = nodes[3] = Node(Config.load(homes[3]))
        await restarted.start()
        target = max(n.block_store.height() for n in nodes[:3])
        while restarted.block_store.height() < target or not in_apps([restarted]):
            if failed(nodes) or time.perf_counter() - t3 > NODE_TIMEOUT_S:
                raise AssertionError(f"node4: the restarted node at "
                                     f"{restarted.block_store.height()} of {target}")
            await asyncio.sleep(0.005)
        catch_up = time.perf_counter() - t3
    finally:
        if submit is not None and not submit.done():
            submit.cancel()
        for n in nodes:
            if n.is_running:
                await n.stop()
    top = min(n.block_store.height() for n in nodes)
    for h in range(1, top + 1):
        if len({n.block_store.load_block(h).hash() for n in nodes}) != 1:
            raise AssertionError(f"node4: the nodes' blocks differ at height {h}")
    gaps = sorted(stamps[h + 1] - stamps[h] for h in stamps if h + 1 in stamps)
    return dict(boot_s=boot_s, wall_s=wall, heights=heights, top=top, h_stop=h_stop,
                target=target, catch_up_s=catch_up, gaps_ms=[g * 1e3 for g in gaps],
                p50_ms=gaps[len(gaps) // 2] * 1e3,
                restart_replayed=restarted.block_store.height() - h_stop)


def node4_cell(device, card: str, run: str = "node4") -> dict:
    """Four Nodes in one process from `testnet --v 4` homes on the card,
    NODE_TXS kvstore txs handed to one of them; one node stopped and
    started again from its home. `run` names the run and its homes."""
    import asyncio
    import os

    with ConsensusProbe() as probe:
        _consumer_reset()
        r = asyncio.run(_node4(os.path.join(_node_root(), run)))
        launches = _consumer_launches()
    k5 = probe.check_launched(run)
    for k in ("challenge_derive", "ed25519_verify", "integrity_parts"):
        if launches.get(k, 0) < 1:
            raise AssertionError(f"{run}: {k} never launched: {launches}")
    n_h = r["top"]
    per_h = {k: round(launches.get(k, 0) / n_h, 3)
             for k in ("challenge_derive", "ed25519_verify", "integrity_parts")}
    print(f"[{card}] node {run}: {r['heights']} heights through Node (sqlite, WAL, kv indexer, "
          f"metrics) in {r['wall_s']:.3f} s after a boot of {r['boot_s']:.3f} s, per-height gap "
          f"({len(r['gaps_ms'])} gaps) p50 {r['p50_ms']:.3f} ms, min {r['gaps_ms'][0]:.3f}, max "
          f"{r['gaps_ms'][-1]:.3f}; a node stopped at {r['h_stop']} and started again caught up "
          f"to {r['target']} in {r['catch_up_s']:.3f} s; K5/K1/K6 launches a height over "
          f"{n_h} heights {per_h}; batched calls with K5 / host k {k5}; launches "
          f"{({k: v for k, v in launches.items() if v})}", flush=True)
    return dict(r, launches=launches, per_height=per_h, k5=k5)


async def _node_sync150(root: str, chain, serve=None) -> dict:
    import asyncio
    import os

    T = _tcp_harness()
    from cometbft_tpu_torch.config import Config
    from cometbft_tpu_torch.node import Node, init_files

    home = os.path.join(root, "sync")
    init_files(home, chain_id=CHAIN_ID, moniker="sync")
    with open(os.path.join(home, "config", "genesis.json"), "w") as f:
        f.write(chain.gdoc.to_json())
    hkey, htr, hsw = T.serve_node("honest", chain.gdoc, chain.block_store, SEED_WIRE)
    haddr = await htr.listen("127.0.0.1:0")
    c = Config.load(home)
    c.rpc.laddr = ""
    c.p2p.pex = False
    c.cert.enabled = False
    c.base.log_level = "error"
    c.p2p.laddr = "tcp://127.0.0.1:0"
    c.p2p.persistent_peers = f"{hkey.id()}@{haddr}"
    c.save()
    await hsw.start()
    node = Node(Config.load(home))
    if not node.blocksync_active:
        raise AssertionError("node sync150: block sync is not active on a fresh non-validator")
    top = N_SYNC - 1  # the tip waits for its successor's commit
    t0 = time.perf_counter()
    try:
        await node.start()
        while node.block_store.height() < top or node.blocksync_reactor.active:
            if time.perf_counter() - t0 > SYNC_TIMEOUT_S:
                raise AssertionError(f"node sync150: {node.block_store.height()} of {top} blocks "
                                     f"in {SYNC_TIMEOUT_S} s")
            await asyncio.sleep(0.01)
        wall = time.perf_counter() - t0
        served = await serve(node, chain) if serve is not None else None
    finally:
        if node.is_running:
            await node.stop()
        await hsw.stop()
    for h in (1, top // 2, top):
        if node.block_store.load_block(h).hash() != chain.block_store.load_block(h).hash():
            raise AssertionError(f"node sync150: block {h} is not the chain's")
    state = node.state_store.load()
    if state.last_block_height < top or (state.last_block_height == top
                                         and state.to_bytes() != chain.states[top]):
        raise AssertionError(f"node sync150: the synced State at {state.last_block_height} is "
                             "not the chain's")
    bcr = node.blocksync_reactor
    return dict(wall_s=wall, blocks=top, window=bcr.window, windows=bcr.windows,
                stage_s=bcr.stage_s, device_busy_s=bcr.device_busy_s, apply_s=bcr.apply_s,
                rpc150=served)


async def _harness_sync_w8(chain) -> dict:
    """torch_tcp_harness.sync_node at the window a Node runs (blocksync's
    VERIFY_WINDOW) on the same chain from the same honest peer alone: the
    harness side of node sync150, with MemDB stores and no indexer,
    metrics or WAL."""
    import asyncio

    T = _tcp_harness()
    from cometbft_tpu_torch.blocksync.reactor import VERIFY_WINDOW

    hkey, htr, hsw = T.serve_node("honest", chain.gdoc, chain.block_store, SEED_WIRE)
    node = await T.sync_node(chain.gdoc, VERIFY_WINDOW, seed=SEED_WIRE)
    haddr = await htr.listen("127.0.0.1:0")
    await node.transport.listen("127.0.0.1:0")
    top = N_SYNC - 1
    t0 = time.perf_counter()
    try:
        for sw in (hsw, node.switch):
            await sw.start()
        await node.switch.dial_peers_async([f"{hkey.id()}@{haddr}"], persistent=True)
        while node.block_store.height() < top or node.reactor.active:
            if time.perf_counter() - t0 > SYNC_TIMEOUT_S:
                raise AssertionError(f"harness sync150 w{VERIFY_WINDOW}: "
                                     f"{node.block_store.height()} of {top} blocks in "
                                     f"{SYNC_TIMEOUT_S} s")
            await asyncio.sleep(0.01)
        wall = time.perf_counter() - t0
    finally:
        for sw in (node.switch, hsw):
            await sw.stop()
        await node.conns.stop()
    if node.state_store.load().to_bytes() != chain.states[top]:
        raise AssertionError(f"harness sync150 w{VERIFY_WINDOW}: the synced State is not the "
                             "chain's")
    bcr = node.reactor
    return dict(wall_s=wall, blocks=top, window=VERIFY_WINDOW, windows=bcr.windows,
                stage_s=bcr.stage_s, device_busy_s=bcr.device_busy_s, apply_s=bcr.apply_s)


def _print_sync_windows(r: dict, launches: dict) -> str:
    w = max(r["windows"], 1)
    return (f"{r['blocks']} blocks x {SYNC_VALS} validators in {r['wall_s']:.3f} s = "
            f"{r['blocks'] / r['wall_s']:.1f} blocks/s, {r['blocks'] * SYNC_VALS / r['wall_s']:.0f} "
            f"signatures/s; {r['windows']} windows: stage {r['stage_s'] / w * 1e3:.3f} ms, "
            f"prefetch (device wait) {r['device_busy_s'] / w * 1e3:.3f} ms, finish + validate + "
            f"apply {r['apply_s'] / w * 1e3:.3f} ms a window; K1 launches a window "
            f"{launches.get('ed25519_verify', 0) / w:.3f}")


def harness_sync_w8_cell(device, card: str, chain) -> dict:
    """The harness's sync of node sync150's chain at node sync150's window,
    run just before it: what the Node's own layers add to a sync is the
    difference between the two."""
    import asyncio

    with ConsensusProbe() as probe:
        _consumer_reset()
        r = asyncio.run(_harness_sync_w8(chain))
        launches = _consumer_launches()
    if probe.plain:
        raise AssertionError(f"harness sync150 w8: {probe.plain} calls of a plain version")
    if launches.get("ed25519_verify", 0) < r["windows"] or r["windows"] < 1:
        raise AssertionError(f"harness sync150 w8: {launches} for {r['windows']} windows")
    print(f"[{card}] node phase, harness sync150 at window {r['window']} (MemDB, no indexer, "
          f"metrics or WAL; honest peer only): {_print_sync_windows(r, launches)}", flush=True)
    return dict(r, k1_launches=launches.get("ed25519_verify", 0))


def node_sync150_cell(device, card: str, chain) -> dict:
    """A fresh non-validator Node (sqlite, block sync on) syncs the wire
    phase's BASELINE config 3 chain (N_SYNC blocks x 150 validators) from
    torch_tcp_harness.serve_node; then it turns on its RPC and serves the
    chain (the RPC phase's rpc150, _rpc150)."""
    import asyncio
    import os

    with ConsensusProbe() as probe:
        _consumer_reset()
        r = asyncio.run(_node_sync150(os.path.join(_node_root(), "sync150"), chain,
                                      serve=_rpc150))
        launches = _consumer_launches()
    if probe.plain:
        raise AssertionError(f"node sync150: {probe.plain} calls of a plain version")
    if launches.get("ed25519_verify", 0) < r["windows"] or r["windows"] < 1:
        raise AssertionError(f"node sync150: {launches} for {r['windows']} windows")
    print(f"[{card}] node sync150 through Node (sqlite, kv indexer, metrics, WAL; window "
          f"{r['window']}): {_print_sync_windows(r, launches)}; launches "
          f"{({k: v for k, v in launches.items() if v})}", flush=True)
    return dict(r, launches=launches)


def node_procs_cell(card: str) -> dict:
    """Four OS processes, `python -m cometbft_tpu_torch --home nodeI start
    --crypto_backend gpu`, on the card from `testnet --v 4` homes; stopped
    with SIGTERM once each has committed NODE_PROC_HEIGHT + 1 blocks.
    Their block stores must agree up to the lowest height."""
    import os
    import signal
    import subprocess

    from cometbft_tpu_torch.store import BlockStore
    from cometbft_tpu_torch.store.db import open_db

    root = os.path.join(_node_root(), "procs")
    homes = _testnet_homes(root, 4, "node-procs")
    repo = os.path.dirname(os.path.abspath(__file__))

    def heights() -> list[int]:
        out = []
        for h in homes:
            path = os.path.join(h, "data", "blockstore.db")
            if not os.path.exists(path):
                out.append(0)
                continue
            db = open_db("sqlite", path, checksum=True)
            out.append(BlockStore(db).height())
            db.close()
        return out

    procs, logs = [], []
    t0 = time.perf_counter()
    try:
        for i, h in enumerate(homes):
            log = open(os.path.join(root, f"node{i}.log"), "wb")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "cometbft_tpu_torch", "--home", h, "start",
                 "--crypto_backend", "gpu"], cwd=repo, stdout=log,
                stderr=subprocess.STDOUT))
        first = None
        while min(heights()) < NODE_PROC_HEIGHT + 1:
            if first is None and min(heights()) >= 1:
                first = time.perf_counter() - t0
            dead = [(i, p.returncode) for i, p in enumerate(procs) if p.poll() is not None]
            if dead or time.perf_counter() - t0 > NODE_TIMEOUT_S:
                tails = [open(os.path.join(root, f"node{i}.log"), "rb").read()[-1500:]
                         for i, _ in dead[:1]]
                raise AssertionError(f"node procs: heights {heights()}, exited {dead}: {tails}")
            time.sleep(0.25)
        wall = time.perf_counter() - t0
        for p in procs:
            p.send_signal(signal.SIGTERM)
        codes = [p.wait(timeout=PROC_STOP_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    if codes != [0] * 4:
        raise AssertionError(f"node procs: exit codes after SIGTERM {codes}")
    hs = heights()
    low = min(hs)
    stores = [open_db("sqlite", os.path.join(h, "data", "blockstore.db"), checksum=True)
              for h in homes]
    try:
        bss = [BlockStore(db) for db in stores]
        for height in range(1, low + 1):
            if len({bs.load_block(height).hash() for bs in bss}) != 1:
                raise AssertionError(f"node procs: the stores differ at height {height}")
    finally:
        for db in stores:
            db.close()
    if low < NODE_PROC_HEIGHT:
        raise AssertionError(f"node procs: common chain {low} < {NODE_PROC_HEIGHT}")
    print(f"[{card}] node procs: 4 `start` processes on the card, first block after "
          f"{first:.3f} s, {low} common heights (stores at {hs}) after {wall:.3f} s, "
          f"stopped with SIGTERM: exit codes {codes}", flush=True)
    return dict(wall_s=wall, first_block_s=first, heights=hs, common=low)


def node_phase(device, card: str, chain) -> dict:
    """The node phase, after the wire phase: the port's Node as a user runs
    it (node/node.py from `testnet` homes: sqlite stores, the WAL, the kv
    indexer, metrics; RPC, PEX and certificates off, as in PR 18, so that
    its cells compare with that PR's) on the card: node4 (four Nodes in one
    process over TCP, one restarted from its home), node sync150 (a fresh
    Node block-syncing the wire phase's 150-validator chain, which then
    serves it over RPC: the RPC phase's rpc150) and four `start`
    processes."""
    import shutil

    from cometbft_tpu_torch import sched
    from cometbft_tpu_torch.consensus import timeline as TL
    from cometbft_tpu_torch.crypto import batch as crypto_batch
    from cometbft_tpu_torch.ops import residency
    from cometbft_tpu_torch.parallel import mesh as M

    t_phase = time.perf_counter()
    crypto_batch.set_backend("gpu")
    M.reset()
    TL.reset()
    shutil.rmtree(_node_root(), ignore_errors=True)
    out = {}
    try:
        # node4 (once since the RPC phase came: PR 18 ran it twice for the
        # spread of its gap); the harness's sync at the Node's window, then
        # the Node's, on one chain
        for label, cell in (("node4", node4_cell),
                            ("harness_w8", functools.partial(harness_sync_w8_cell, chain=chain)),
                            ("sync150", functools.partial(node_sync150_cell, chain=chain))):
            sched.reset()
            residency.reset()
            out[label] = cell(device, card)
        if out["sync150"]["window"] != out["harness_w8"]["window"]:
            raise AssertionError(f"node sync150 window {out['sync150']['window']}, the harness's "
                                 f"{out['harness_w8']['window']}")
        out["procs"] = node_procs_cell(card)
    finally:
        sched.reset()
        residency.reset()
        shutil.rmtree(_node_root(), ignore_errors=True)
    print(f"[{card}] node phase (measurements, not claims): "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return out


# ------------------------------------------------------------- the RPC phase

SEED_SIGNER = 19  # signer4's keys (torch_tcp_harness seeds, seen nowhere else)
RPC_SYNC_TXS = 200  # kvstore txs through broadcast_tx_sync, across the four RPC ports
RPC_COMMIT_TXS = 20  # kvstore txs through broadcast_tx_commit, four at a time
RPC_CALLS = 20  # calls a route for its p50
RPC_PEER_WAIT_S = 60  # node 3 must have its second peer this long after its start
SIGNER_HEIGHTS = 8  # signer4's heights at the least
RPC150_HEIGHTS = 5  # the heights /commit is held against the chain at


def _rpc_client():
    """tests/torch_rpc_client.py (tests/ on the path, as for _harness)."""
    _harness()
    import torch_rpc_client

    return torch_rpc_client


def _p(xs: list[float], q: float) -> float:
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(q * len(xs)))]


def _grpc_missing() -> str:
    """Why the gRPC step cannot run here ("" when grpc imports)."""
    try:
        import grpc  # noqa: F401
    except Exception as e:  # noqa: BLE001 - any import failure skips the step
        return f"{type(e).__name__}: {e}"
    return ""


def _abci_cli_kvstore(port: int, log):
    """`python -m cometbft_tpu_torch.abci.cli --address tcp://127.0.0.1:PORT
    kvstore` in a child process, once its socket accepts."""
    import os
    import socket

    repo = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.Popen(
        [sys.executable, "-m", "cometbft_tpu_torch.abci.cli", "--address",
         f"tcp://127.0.0.1:{port}", "kvstore"], cwd=repo, stdout=log, stderr=subprocess.STDOUT)
    t0 = time.perf_counter()
    while True:
        try:
            socket.create_connection(("127.0.0.1", port), timeout=1.0).close()
            return proc
        except OSError:
            if proc.poll() is not None or time.perf_counter() - t0 > 60:
                proc.kill()
                proc.wait()
                raise AssertionError(f"rpc4: abci-cli kvstore did not listen (exit "
                                     f"{proc.returncode})")
            time.sleep(0.1)


def _rpc_homes(root: str) -> tuple[list[str], list[str]]:
    """`testnet --v 4` homes with the reference's defaults (RPC and PEX on)
    but cert.enabled = false: free loopback ports, log level error, the
    harness nets' consensus timeouts; nodes 0-2 persistent peers of each
    other, node 3 with none and node 0 as its only seed. Returns the homes
    and the node ids."""
    import os

    from cometbft_tpu_torch.cmd import main as cli
    from cometbft_tpu_torch.config import Config
    from cometbft_tpu_torch.p2p.key import NodeKey

    if cli(["testnet", "--v", "4", "--o", root, "--chain-id", "rpc-net4"]) != 0:
        raise AssertionError("testnet --v 4 failed")
    homes = [os.path.join(root, f"node{i}") for i in range(4)]
    ids = [NodeKey.load_or_gen(Config.load(h).node_key_path()).id() for h in homes]
    ports = _free_ports(9)
    for i, h in enumerate(homes):
        c = Config.load(h)
        if not (c.rpc.laddr and c.p2p.pex and c.crypto.backend == "gpu"):
            raise AssertionError(f"rpc4: testnet wrote rpc {c.rpc.laddr!r}, pex {c.p2p.pex}, "
                                 f"backend {c.crypto.backend!r}")
        c.cert.enabled = False
        c.base.log_level = "error"
        c.p2p.laddr = f"tcp://127.0.0.1:{ports[i]}"
        c.rpc.laddr = f"tcp://127.0.0.1:{ports[4 + i]}"
        c.consensus = _net_config()
        if i < 3:
            c.p2p.persistent_peers = ",".join(f"{ids[j]}@127.0.0.1:{ports[j]}"
                                              for j in range(3) if j != i)
        else:
            c.p2p.persistent_peers = ""
            c.p2p.seeds = f"{ids[0]}@127.0.0.1:{ports[0]}"
        if i == 2:
            c.base.proxy_app = f"tcp://127.0.0.1:{ports[8]}"
        if i == 0 and not _grpc_missing():
            c.grpc.laddr = f"tcp://127.0.0.1:{_free_ports(1)[0]}"
        c.save()
    return homes, ids


async def _rpc_load(addrs: list[str], ws_addr: str, heights_at_start: int) -> dict:
    """The client's side of rpc4 (its own event loop, in its own thread):
    a websocket on node 1 counting NewBlock events, RPC_SYNC_TXS
    broadcast_tx_sync calls spread over the four ports, RPC_COMMIT_TXS
    broadcast_tx_commit calls four at a time, then RPC_CALLS calls of each
    read route."""
    import asyncio

    R = _rpc_client()
    ws = await R.WS.connect(ws_addr)
    ack = await ws.subscribe("tm.event = 'NewBlock'")
    if "error" in ack:
        raise AssertionError(f"rpc4: the websocket refused the subscription: {ack}")
    seen: list[int] = []

    async def count_blocks():
        while True:
            ev = await ws.recv()
            seen.append(int(ev["result"]["data"]["value"]["block"]["header"]["height"]))

    counter = asyncio.get_running_loop().create_task(count_blocks())
    health0 = (await R.get(addrs[0], "/crypto_health"))["result"]["verify_sched"]
    txs = [b"rpc%d=v%d" % (i, i) for i in range(RPC_SYNC_TXS + RPC_COMMIT_TXS)]
    sync_ms, commit_ms, results = [], [], {}

    async def sync(i, tx):
        t0 = time.perf_counter()
        env = await R.post(addrs[i % 4], "broadcast_tx_sync", {"tx": R.b64(tx)})
        sync_ms.append((time.perf_counter() - t0) * 1e3)
        results[tx] = env

    async def commit(i, tx):
        t0 = time.perf_counter()
        env = await R.post(addrs[i % 4], "broadcast_tx_commit", {"tx": R.b64(tx)})
        commit_ms.append((time.perf_counter() - t0) * 1e3)
        results[tx] = env

    for k in range(0, RPC_SYNC_TXS, 8):
        await asyncio.gather(*(sync(i, txs[i]) for i in range(k, min(k + 8, RPC_SYNC_TXS))))
    for k in range(RPC_SYNC_TXS, len(txs), 4):
        await asyncio.gather(*(commit(i, txs[i]) for i in range(k, min(k + 4, len(txs)))))
    bad = {tx: env for tx, env in results.items()
           if "error" in env or (env["result"].get("code") or
                                 env["result"].get("check_tx", {}).get("code", 0))}
    if bad or len(results) != len(txs):
        raise AssertionError(f"rpc4: {len(bad)} txs refused, e.g. {list(bad.items())[:2]}")
    commit_heights = sorted(int(results[tx]["result"]["height"]) for tx in txs[RPC_SYNC_TXS:])
    # the sync txs: wait until every one is indexed on node 0
    t0 = time.perf_counter()
    while True:
        got = [await R.get(addrs[0], f"/tx?hash=0x{hashlib.sha256(tx).hexdigest()}")
               for tx in txs]
        missing = [tx for tx, env in zip(txs, got) if "error" in env]
        if not missing:
            break
        if time.perf_counter() - t0 > NODE_TIMEOUT_S:
            raise AssertionError(f"rpc4: {len(missing)} txs never found by `tx`: "
                                 f"{missing[:3]}")
        await asyncio.sleep(0.2)
    tx_heights = sorted({int(env["result"]["height"]) for env in got})
    search_total = 0
    for h in tx_heights:
        env = await R.get(addrs[1], f"/tx_search?query=%22tx.height%3D{h}%22&per_page=100")
        search_total += int(env["result"]["total_count"])
    if search_total != len(txs):
        raise AssertionError(f"rpc4: tx_search found {search_total} of {len(txs)} txs")
    health1 = (await R.get(addrs[0], "/crypto_health"))["result"]["verify_sched"]
    top = max(tx_heights)
    # /commit at `top` is the canonical commit, stored with block top + 1
    async def tip(a: str) -> int:
        env = await R.get(a, "/status")
        return int(env["result"]["sync_info"]["latest_block_height"])

    while min([await tip(a) for a in addrs]) <= top:
        if time.perf_counter() - t0 > NODE_TIMEOUT_S:
            raise AssertionError(f"rpc4: the chain did not pass height {top}")
        await asyncio.sleep(0.05)
    routes = {"status": "/status", "block": f"/block?height={top}",
              "commit": f"/commit?height={top}", "validators": "/validators",
              "tx_search": f"/tx_search?query=%22tx.height%3D{top}%22"}
    route_ms = {}
    for name, path in routes.items():
        ms = []
        for k in range(RPC_CALLS):
            t0 = time.perf_counter()
            env = await R.get(addrs[k % 4], path)
            ms.append((time.perf_counter() - t0) * 1e3)
            if "error" in env:
                raise AssertionError(f"rpc4: {path}: {env['error']}")
        route_ms[name] = statistics.median(ms)
    # the websocket saw every height from its first event to the last
    # committed one
    last = await tip(addrs[1])
    t0 = time.perf_counter()
    while not seen or seen[-1] < last:
        if time.perf_counter() - t0 > 10:
            break
        await asyncio.sleep(0.05)
    counter.cancel()
    await ws.close()
    if not seen or seen != list(range(seen[0], seen[-1] + 1)) or seen[-1] < last \
            or seen[0] > heights_at_start + 2:
        raise AssertionError(f"rpc4: the websocket saw heights {seen[:5]}..{seen[-5:]} of "
                             f"{heights_at_start}..{last}")
    return dict(sync_ms=sync_ms, commit_ms=commit_ms, route_ms=route_ms,
                commit_heights=commit_heights, tx_heights=tx_heights, seen=len(seen),
                batches=(health0["batches"], health1["batches"]), top=top)


async def _rpc4(root: str) -> dict:
    import asyncio
    import os
    import shutil

    from cometbft_tpu_torch.config import Config
    from cometbft_tpu_torch.node import Node

    R = _rpc_client()
    shutil.rmtree(root, ignore_errors=True)  # testnet keeps an old home's data
    homes, ids = _rpc_homes(root)
    cfg2 = Config.load(homes[2])
    app_log = open(os.path.join(root, "abci-cli.log"), "wb")
    app = _abci_cli_kvstore(int(cfg2.base.proxy_app.rsplit(":", 1)[1]), app_log)
    nodes = []
    t0 = time.perf_counter()
    try:
        nodes = [Node(Config.load(h)) for h in homes[:3]]
        for n in nodes:
            await n.start()
        nodes.append(Node(Config.load(homes[3])))
        t3 = time.perf_counter()
        await nodes[3].start()
        boot_s = time.perf_counter() - t0
        second_peer_s = None
        addrs = [n.rpc_server.bound_addr for n in nodes]
        stamps: dict[int, float] = {}

        def watch() -> None:
            nonlocal second_peer_s
            h = min(n.block_store.height() for n in nodes)
            if h not in stamps:
                stamps[h] = time.perf_counter()
            if second_peer_s is None and nodes[3].switch.n_peers() >= 2:
                second_peer_s = time.perf_counter() - t3
            failed = [i for i, n in enumerate(nodes) if n.consensus_state.failed]
            if failed:
                raise AssertionError(f"rpc4: consensus failure on nodes {failed}")

        while min(n.block_store.height() for n in nodes) < 2:
            watch()
            if time.perf_counter() - t0 > NODE_TIMEOUT_S:
                raise AssertionError("rpc4: the net did not reach height 2")
            await asyncio.sleep(0.005)
        h_start = min(n.block_store.height() for n in nodes)
        stamps.clear()
        load = asyncio.get_running_loop().run_in_executor(
            None, lambda: asyncio.run(_rpc_load(addrs, addrs[1], h_start)))
        while not load.done():
            watch()
            if time.perf_counter() - t0 > NODE_TIMEOUT_S:
                raise AssertionError("rpc4: the load did not finish")
            await asyncio.sleep(0.005)
        r = await load
        h_end = min(n.block_store.height() for n in nodes)
        load_stamps = dict(stamps)  # the heights committed under the load
        while second_peer_s is None:
            watch()
            if time.perf_counter() - t3 > RPC_PEER_WAIT_S:
                raise AssertionError(f"rpc4: node 3 has {nodes[3].switch.n_peers()} peers "
                                     f"{RPC_PEER_WAIT_S} s after its start")
            await asyncio.sleep(0.01)
        book = nodes[3].addr_book
        if not all(book.has(i) for i in ids[:3]):
            raise AssertionError(f"rpc4: node 3's address book holds "
                                 f"{sorted(book._addrs)} of {ids[:3]}")
        # /commit and /block against the node's block store at 3 heights
        for h in (h_start, (h_start + r["top"]) // 2, r["top"]):
            blk = nodes[0].block_store.load_block(h)
            commit = nodes[0].block_store.load_block_commit(h)
            env_b = await R.get(addrs[0], f"/block?height={h}")
            env_c = await R.get(addrs[2], f"/commit?height={h}")
            sigs = [base64.b64decode(s["signature"])
                    for s in env_c["result"]["signed_header"]["commit"]["signatures"]]
            if (env_b["result"]["block_id"]["hash"] != blk.hash().hex().upper()
                    or [base64.b64decode(t) for t in env_b["result"]["block"]["data"]["txs"]]
                    != list(blk.data.txs)
                    or sigs != [s.signature for s in commit.signatures]):
                raise AssertionError(f"rpc4: /block or /commit at {h} differs from the store")
        grpc_step = "not run: " + _grpc_missing() if _grpc_missing() else await _grpc_step(
            nodes[0], addrs[0], r["top"])
    finally:
        for n in nodes:
            if n.is_running:
                await n.stop()
        app.terminate()
        try:
            app.wait(timeout=10)
        except subprocess.TimeoutExpired:
            app.kill()
            app.wait()
        app_log.close()
    top = min(n.block_store.height() for n in nodes)
    for h in range(1, top + 1):
        if len({n.block_store.load_block(h).hash() for n in nodes}) != 1:
            raise AssertionError(f"rpc4: the nodes' blocks differ at height {h}")
    gaps = sorted(load_stamps[h + 1] - load_stamps[h] for h in load_stamps
                  if h + 1 in load_stamps)
    return dict(r, boot_s=boot_s, second_peer_s=second_peer_s, heights=h_end - h_start,
                h_start=h_start, h_end=h_end, top_all=top, gaps_ms=[g * 1e3 for g in gaps],
                p50_ms=gaps[len(gaps) // 2] * 1e3, grpc=grpc_step)


async def _grpc_step(node, addr: str, height: int) -> str:
    """GRPCServicesClient reads GetVersion and BlockService/GetByHeight off
    node 0, held against its /block."""
    from cometbft_tpu_torch import version
    from cometbft_tpu_torch.rpc.grpc_services import GRPCServicesClient

    R = _rpc_client()
    client = GRPCServicesClient(node.grpc_bound)
    try:
        v = await client.call("VersionService", "GetVersion")
        b = await client.call("BlockService", "GetByHeight", {"height": height})
    finally:
        await client.close()
    env = await R.get(addr, f"/block?height={height}")
    if v["node"] != version.CMTSemVer or v["block"] != version.BlockProtocol \
            or b["block_id"]["hash"].upper() != env["result"]["block_id"]["hash"]:
        raise AssertionError(f"rpc4 gRPC: {v}, block id {b['block_id']}, /block "
                             f"{env['result']['block_id']}")
    return f"GetVersion {v['node']} and GetByHeight({height}) agree with /block"


def rpc4_cell(device, card: str) -> dict:
    """Four Nodes from `testnet --v 4` homes on the card with RPC and PEX
    on (cert off): node 3 reaches the others through PEX from node 0 as its
    seed, node 2's app is abci-cli's kvstore in a child process over TCP;
    a client sends RPC_SYNC_TXS + RPC_COMMIT_TXS txs through the RPC."""
    import asyncio
    import os

    with ConsensusProbe() as probe:
        _consumer_reset()
        r = asyncio.run(_rpc4(os.path.join(_node_root(), "rpc4")))
        launches = _consumer_launches()
    k5 = probe.check_launched("rpc4")
    for k in ("challenge_derive", "ed25519_verify", "integrity_parts"):
        if launches.get(k, 0) < 1:
            raise AssertionError(f"rpc4: {k} never launched: {launches}")
    b0, b1 = r["batches"]
    if b1 <= b0:
        raise AssertionError(f"rpc4: crypto_health verify_sched batches {b0} -> {b1}")
    n_h = r["top_all"]  # every height the cell's nodes committed
    per_h = {k: round(launches.get(k, 0) / n_h, 3)
             for k in ("challenge_derive", "ed25519_verify", "integrity_parts")}
    print(f"[{card}] rpc rpc4: four Nodes (RPC and PEX on, node 2's app abci-cli kvstore over "
          f"TCP) booted in {r['boot_s']:.3f} s; {RPC_SYNC_TXS} broadcast_tx_sync p50 "
          f"{_p(r['sync_ms'], 0.5):.3f} ms, {RPC_COMMIT_TXS} broadcast_tx_commit p50 "
          f"{_p(r['commit_ms'], 0.5):.3f} ms, p90 {_p(r['commit_ms'], 0.9):.3f} ms; per-route "
          f"p50 ms over {RPC_CALLS} calls {({k: round(v, 3) for k, v in r['route_ms'].items()})}; "
          f"{r['heights']} heights during the load, per-height gap ({len(r['gaps_ms'])} gaps) "
          f"p50 {r['p50_ms']:.3f} ms; txs in heights {r['tx_heights'][0]}-{r['tx_heights'][-1]}, "
          f"all found by tx and tx_search; websocket NewBlock events {r['seen']}; "
          f"verify_sched batches {b0} -> {b1}; K5/K1/K6 launches a height over {n_h} heights "
          f"{per_h}; node 3's second peer {r['second_peer_s']:.3f} s after its start (PEX from "
          f"its seed); gRPC {r['grpc']}; batched calls with K5 / host k {k5}", flush=True)
    return dict(r, launches=launches, per_height=per_h, k5=k5)


async def _rpc150(node, chain) -> dict:
    """The synced node of node sync150 turns on its RPC and serves the
    chain: /commit at RPC150_HEIGHTS heights held against the chain's
    commits, /validators page 2 of 100, /blockchain over 20 heights,
    /block_results and /light_block; each route's p50 over RPC_CALLS."""
    from cometbft_tpu_torch.rpc.server import RPCServer

    R = _rpc_client()
    node.config.rpc.laddr = "tcp://127.0.0.1:0"
    node.rpc_server = RPCServer(node, node.config.rpc)
    await node.rpc_server.start()
    addr = node.rpc_server.bound_addr
    top = node.block_store.height() - 1
    commit_bytes = 0
    for h in np.linspace(2, top, RPC150_HEIGHTS).astype(int).tolist():
        raw = (await R.get_raw(addr, f"/commit?height={h}"))[1]
        commit_bytes = len(raw)
        env = json.loads(raw)
        sigs = [base64.b64decode(s["signature"])
                for s in env["result"]["signed_header"]["commit"]["signatures"]]
        want = chain.block_store.load_block_commit(h)
        if len(sigs) != SYNC_VALS or sigs != [s.signature for s in want.signatures]:
            raise AssertionError(f"rpc150: /commit at {h} is not the chain's commit")
    env = await R.get(addr, f"/validators?height={top}&per_page=100&page=2")
    if len(env["result"]["validators"]) != SYNC_VALS - 100 or env["result"]["total"] != str(
            SYNC_VALS):
        raise AssertionError(f"rpc150: /validators page 2: {env['result'].get('count')}")
    env = await R.get(addr, f"/blockchain?minHeight={top - 19}&maxHeight={top}")
    if len(env["result"]["block_metas"]) != 20:
        raise AssertionError("rpc150: /blockchain did not give 20 heights")
    routes = {"commit": f"/commit?height={top}", "block": f"/block?height={top}",
              "validators": f"/validators?height={top}&per_page=100&page=2",
              "blockchain": f"/blockchain?minHeight={top - 19}&maxHeight={top}",
              "block_results": f"/block_results?height={top}",
              "light_block": f"/light_block?height={top}", "status": "/status"}
    route_ms = {}
    for name, path in routes.items():
        ms = []
        for _ in range(RPC_CALLS):
            t0 = time.perf_counter()
            env = await R.get(addr, path)
            ms.append((time.perf_counter() - t0) * 1e3)
            if "error" in env:
                raise AssertionError(f"rpc150: {path}: {env['error']}")
        route_ms[name] = statistics.median(ms)
    return dict(route_ms=route_ms, commit_bytes=commit_bytes, top=top)


async def _signer4(device) -> dict:
    import asyncio
    import threading

    T = _tcp_harness()
    from cometbft_tpu_torch.privval.file_pv import FilePV
    from cometbft_tpu_torch.privval.remote import SignerClient, SignerServer

    net = await T.make_tcp_net(4, config=_net_config(), chain_id="rpc-signer4", device=device,
                               seed=SEED_SIGNER)
    cs = net.nodes[3].cs
    client = SignerClient(("127.0.0.1", 0), timeout=5.0, accept_timeout=10.0)
    server = SignerServer(FilePV(net.privs[3]), client.laddr)
    server.start()
    accept = threading.Thread(target=client.accept)
    accept.start()
    accept.join(timeout=15.0)
    if client._conn is None:
        raise AssertionError("signer4: the signer never dialed in")
    trips = []
    round_trip = client._round_trip

    def timed(tag, body):
        t0 = time.perf_counter()
        out = round_trip(tag, body)
        trips.append((time.perf_counter() - t0) * 1e3)
        return out

    client._round_trip = timed
    if client.get_pub_key().bytes_() != cs.priv_validator_pub_key.bytes_():
        raise AssertionError("signer4: the remote signer holds another key")
    cs.priv_validator = client
    stamps, t0 = {}, time.perf_counter()
    try:
        await net.start()
        last = 0
        while last < SIGNER_HEIGHTS:
            h = min(n.block_store.height() for n in net.nodes)
            if h > last:
                stamps[h] = time.perf_counter()
                last = h
            if net.failed() or time.perf_counter() - t0 > NET_TIMEOUT_S:
                raise AssertionError(f"signer4: {h} heights, failed {net.failed()}")
            await asyncio.sleep(0.002)
    finally:
        await net.stop()
        client.close()
        server.stop()
    heights = min(n.block_store.height() for n in net.nodes)
    signed = sum(1 for h in range(2, heights + 1)
                 for s in net.nodes[0].block_store.load_block(h).last_commit.signatures
                 if s.validator_address == cs.priv_validator_pub_key.address() and s.signature)
    if signed < SIGNER_HEIGHTS - 2:
        raise AssertionError(f"signer4: the remote validator signed {signed} commits")
    gaps = sorted(stamps[h + 1] - stamps[h] for h in stamps if h + 1 in stamps)
    return dict(heights=heights, trips_ms=trips, signed=signed,
                gaps_ms=[g * 1e3 for g in gaps], p50_ms=gaps[len(gaps) // 2] * 1e3)


def signer4_cell(device, card: str, tcp4_p50_ms: float) -> dict:
    """tcp4's net (torch_tcp_harness, no txs) with validator 3 signing
    through the port's SignerClient; its SignerServer holds the FilePV in a
    thread over loopback."""
    import asyncio

    with ConsensusProbe() as probe:
        _consumer_reset()
        r = asyncio.run(_signer4(device))
        launches = _consumer_launches()
    k5 = probe.check_launched("signer4")
    n_h = r["heights"]
    per_h = {k: round(launches.get(k, 0) / n_h, 3)
             for k in ("challenge_derive", "ed25519_verify", "integrity_parts")}
    print(f"[{card}] rpc signer4: {n_h} heights with validator 3 on the remote signer, "
          f"{len(r['trips_ms'])} signing round trips p50 {_p(r['trips_ms'], 0.5):.3f} ms (max "
          f"{max(r['trips_ms']):.3f}); per-height gap p50 {r['p50_ms']:.3f} ms against this "
          f"run's tcp4 {tcp4_p50_ms:.3f} ms; {r['signed']} commits carry its signature; K5/K1/K6 "
          f"launches a height {per_h}; batched calls with K5 / host k {k5}", flush=True)
    return dict(r, launches=launches, per_height=per_h, k5=k5)


def rpc_phase(device, card: str, node: dict, tcp4_p50_ms: float) -> dict:
    """The RPC phase, after the node phase: rpc4 (the reference's default
    deployment of four Nodes, RPC and PEX on, a socket app, load through
    the RPC), rpc150 (taken from the node phase, where the synced Node of
    node sync150 served its chain over RPC) and signer4 (a validator on the
    remote signer)."""
    import shutil

    from cometbft_tpu_torch import sched
    from cometbft_tpu_torch.ops import residency

    t_phase = time.perf_counter()
    out = {}
    r150 = node["sync150"]["rpc150"]
    print(f"[{card}] rpc rpc150: the synced Node served the {N_SYNC} x {SYNC_VALS} chain over "
          f"RPC: /commit at {RPC150_HEIGHTS} heights equal to the chain's commits ({SYNC_VALS} "
          f"signatures, {r150['commit_bytes']} response bytes), /validators page 2 of 100 gave "
          f"{SYNC_VALS - 100}; per-route p50 ms over {RPC_CALLS} calls "
          f"{({k: round(v, 3) for k, v in r150['route_ms'].items()})}", flush=True)
    try:
        for label, cell in (("rpc4", rpc4_cell),
                            ("signer4", functools.partial(signer4_cell,
                                                          tcp4_p50_ms=tcp4_p50_ms))):
            sched.reset()
            residency.reset()
            out[label] = cell(device, card)
    finally:
        sched.reset()
        residency.reset()
        shutil.rmtree(_node_root(), ignore_errors=True)
    out["rpc150"] = r150
    print(f"[{card}] rpc phase (measurements, not claims): "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
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
    stems = ("verify25519", "decompress25519", "microbench", "challenge25519", "integrity",
             "bls12381")
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
    # the native host rungs must have built: no quiet numpy or Python rung
    from cometbft_tpu_torch import native
    from cometbft_tpu_torch.crypto import sr25519_math as srm
    from cometbft_tpu_torch.ops import hashvec

    if hashvec.active_rung() != "native" or srm.serial_rung() != "native":
        raise AssertionError(f"native host rungs: hashvec {hashvec.active_rung()}, sr25519 "
                             f"serial {srm.serial_rung()}: {native.build_error('hashvec')} "
                             f"{native.build_error('strobe')}")
    print(f"native host rungs: hashvec {hashvec.active_rung()}, sr25519 serial "
          f"{srm.serial_rung()}", flush=True)

    # every lane count the main paths launch at, for both schemes: 128, 256
    # (the 150 commit's bucket, padding lanes included), 6,144 (the mixed
    # commit's per-scheme bucket of 5,120 signatures) and 10,240
    checks = [check_kernels(name, path, n, device) for name, path in (("ed25519", ed),
              ("sr25519", sr)) for n in (128, N_SMALL, 5_120, N_BIG)]
    err = {k: max(c.get(k, 0) for c in checks) for c in checks for k in c}
    err.update(check_challenge_integrity(device))

    # the main paths; each cell also holds K5/K6 against their plain
    # versions on one more run (Held), outside its counted window
    crypto_batch.set_backend("gpu")
    held = Held()
    big = drive_commit(ed, N_BIG, SEED_BIG, device, "10k", held)
    small = drive_commit(ed, N_SMALL, SEED_SMALL, device, "150", held)
    drive_commit(ed, N_SMALL, SEED_SMALL + 1, device, "150 all valid", held, tampered=False)
    drive_commit(ed, N_SMALL, SEED_SMALL + 2, device, "150 plain bytes", held, factored=False)
    big_sr = drive_commit(sr, N_BIG, SEED_SR, device, "sr25519 10k", held)
    mixed = drive_mixed(paths, N_BIG, SEED_MIXED, device, held)
    # the top of the main path, timed before the microbench and probe phases
    commit = commit_phase(device, card, held)
    bls = bls_phase(device, card, builds["bls12381"][1])
    mesh = mesh_phase(device, card)
    consumers = consumers_phase(device, card)
    consensus = consensus_phase(device, card)
    wire = wire_phase(device, card)
    node = node_phase(device, card, wire["sync150"].pop("chain"))
    rpc = rpc_phase(device, card, node, wire["tcp4"]["p50_ms"])
    if min(held.held.values()) < 1:
        raise AssertionError(f"K5/K6 not held on the main paths: {held.held}")
    for name, e in held.err.items():
        err[name] = max(err[name], e)
    print(f"K5/K6 held against their plain versions on the main paths' own inputs: "
          f"{held.held} launches, largest differences {held.err}", flush=True)
    lanes = mixed["warm_lanes"]
    if lanes != {"ed25519_verify": N_MIXED_BUCKET, "sr25519_verify": N_MIXED_BUCKET}:
        raise AssertionError(f"mixed 10k: lanes per warm verify() {lanes}")
    # K6 reads the verify kernel's raw verdicts: nothing else launches between
    check_verify_to_header(ed, N_BIG, SEED_COLD + 6, device)
    check_verify_to_header(sr, N_SMALL, SEED_COLD + 7, device)

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
    parts = {
        "ed25519 10k": time_parts("ed25519 10k", [parts_cell(ed, N_BIG, SEED_COLD)], device,
                                  card),
        "ed25519 150": time_parts("ed25519 150", [parts_cell(ed, N_SMALL, SEED_COLD + 1)],
                                  device, card),
        "ed25519 150 plain bytes": time_parts(
            "ed25519 150 plain bytes", [parts_cell(ed, N_SMALL, SEED_COLD + 2, factored=False)],
            device, card),
        "sr25519 10k": time_parts("sr25519 10k", [parts_cell(sr, N_BIG, SEED_COLD + 3)],
                                  device, card),
        "mixed 10k": time_parts("mixed 10k", [parts_cell(ed, N_BIG // 2, SEED_COLD + 4),
                                              parts_cell(sr, N_BIG // 2, SEED_COLD + 5)],
                                device, card)}
    k56 = time_k5_k6(device, card)
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

    from cometbft_tpu_torch.ops import challenge as CH

    kernels = {"kernels": []}
    # launches of one warm verify_commit (decoders: its cold run): ed25519
    # 10k, and the mixed 10k for sr25519
    on_commit = {**commit["ed25519 10k"]["launches"],
                 "ed25519_decompress": commit["ed25519 10k"]["cold"]["ed25519_decompress"],
                 "sr25519_verify": commit["mixed 10k"]["launches"]["sr25519_verify"],
                 "sr25519_decompress": commit["mixed 10k"]["cold"]["sr25519_decompress"]}
    for name, run, t, b, d, replaces in (
            ("ed25519", big, times, bounds, dec["ed25519"], "ed25519_kernel.py:97"),
            ("sr25519", big_sr, times_sr, bounds_sr, dec["sr25519"], "sr25519_kernel.py:102")):
        kernels["kernels"] += [
            _record(f"{name}_verify", "cometbft_tpu/ops/pallas_verify.py:198",
                    run["launches"][f"{name}_verify"], err[f"{name}_verify"],
                    t[N_BIG]["verify"], t[N_BIG]["verify_plain"], b[N_BIG]["verify"],
                    launches_verify_commit=on_commit[f"{name}_verify"],
                    launches_mesh=mesh["launches"].get(f"{name}_verify", 0)),
            _record(f"{name}_decompress", f"cometbft_tpu/ops/{replaces}",
                    run["launches"][f"{name}_decompress"], err[f"{name}_decompress"],
                    d[N_BIG]["ms"], d[N_BIG]["plain_ms"], d[N_BIG]["bound"],
                    ms_back_to_back=d[N_BIG]["ms_back_to_back"],
                    launches_verify_commit=on_commit[f"{name}_decompress"])]
    for name, source, replaces in (
            ("challenge_derive", "challenge25519.cu", "cometbft_tpu/ops/challenge.py:730"),
            ("integrity_parts", "integrity.cu", "cometbft_tpu/ops/ed25519_kernel.py:271")):
        r = k56[name]
        kernels["kernels"].append({
            "name": name, "route": "cuda", "source": f"cometbft_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": big["launches"][name], "max_abs_err": err[name],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
            "bound_by": r["bound"][1], "library_ms": r["library_ms"], "lanes": N_BIG,
            "ms_back_to_back": r["ms_back_to_back"], "host_ms": r["host_ms"],
            "launches_verify_commit": on_commit[name],
            "launches_mesh": mesh["launches"][name],
            **({"hash_only_ms": r["hash_only"]["ms"]} if name == "challenge_derive" else
               {"behind_k1_ms": r["behind_k1"]})})
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
    kernels["kernels"] += bls["records"]
    # each kernel's launches on the consumers' paths: one warm 10,000-vote
    # flush, one light hop, one certificate hop
    # and on the consensus cells: each whole run (all its nodes and heights)
    on_consumers = {"vote_flush_10k": consumers["votes"]["launches_vote_flush"],
                    "light_hop": consumers["light"]["launches_light_hop"],
                    "cert_hop": consumers["cert"]["launches_cert_hop"],
                    **{f"consensus_{label.replace('-', '_')}": cell["launches"]
                       for label, cell in consensus.items()},
                    **{f"wire_{label}": cell["launches"] for label, cell in wire.items()},
                    **{f"node_{label}": cell["launches"] for label, cell in node.items()
                       if "launches" in cell},
                    **{f"rpc_{label}": cell["launches"] for label, cell in rpc.items()
                       if "launches" in cell}}
    for r in kernels["kernels"]:
        count = BLS_SPLIT.get(r["name"], (None, None, r["name"]))[2]
        for path, launches in on_consumers.items():
            r[f"launches_{path}"] = launches.get(count, 0)
    print(f"chip_smoke: {time.perf_counter() - t0:.1f} s since the kernel build began",
          flush=True)
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
