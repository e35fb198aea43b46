"""Batched BLS12-381 verification: host staging, the device pipeline over the
kernels B1-B5 (ops/bls_launch.py) and the integrity header. The port's copy
of cometbft_tpu/ops/bls_kernel.py.

Two verify modes:

  verify_batch_async   batched SINGLE-verify (mempool rows, mixed-scheme
                       commits, the per-lane pinpoint of a failed aggregate):
                       per lane the pairing-product check
                       e(-g1, sig_i) * e(pk_i, H(m_i)) == 1. B1 decodes and
                       subgroup-checks every key and signature, B2 hashes
                       every lane's message, B4 runs the 2B Miller loops
                       (lanes [0, B) pair -g1 with sig, [B, 2B) pk with
                       H(m)), B5 multiplies each lane's two values,
                       exponentiates and gates the verdict with the B1 ok
                       bits (padding lanes forced valid); the port's K6
                       (ops/integrity.py) folds the verdicts and the staging
                       checksum of the block and flags into the header. The
                       thunk resolves with ed25519_kernel.resolve_batches,
                       beside the other schemes' batches, in one header
                       fetch.
  aggregate_verify     the one-pairing-product COMMIT check: the signatures
                       decoded (B1, no per-signature subgroup check) and
                       summed (B3, the sum subgroup-checked), the keys
                       decoded and subgroup-checked once per validator set
                       (B1, cached by the SHA-256 of the keys, FIFO of 64),
                       summed per distinct sign-bytes (B3, one segmented
                       launch for all D groups: proof-of-possession
                       semantics), the D distinct messages hashed (B2), D + 1
                       Miller lanes (B4) and ONE final exponentiation (B5).
                       It returns False on a structural reject, a key that
                       fails decoding or the subgroup check, a signature that
                       fails decoding, a signature sum outside the subgroup
                       or at infinity, and a key group summing to infinity.
  aggregate_verify_agg the same check on an already aggregated signature (a
                       commit certificate's): the one signature decoded and
                       subgroup-checked by B1, nothing summed.

Staging is the reference's bit for bit: a (7, 35, bucket) int32 block of
raw radix-2^11 limb planes [pk_x, sig_x.c0, sig_x.c1, u0.c0, u0.c1, u1.c0,
u1.c1] and (3, bucket) flags [pk sign, sig sign, is padding]; expand_message
and the reduction of each 64-byte chunk mod p are host work. Structural
rejects and padding lanes carry the generators' encodings.

There is no fallback: a kernel or staging error raises. The exact host
oracle runs only where the reference rechecks rejected lanes (at most
ed25519_kernel.RECHECK_MAX a group).

mesh_shard_verify is one mesh fault domain's shard (parallel/mesh.py): the
same pipeline on the domain's stream, its header and payload checked as
the reference checks them, with one fresh retry. Left out of the
reference: trace spans, link-model and residency accounting.
"""

from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict

import numpy as np
import torch

from cometbft_tpu_torch import resolve_device
from cometbft_tpu_torch.crypto import bls12381_math as oracle
from cometbft_tpu_torch.libs.prefixrows import as_bytes
from cometbft_tpu_torch.ops import bls_launch as BL
from cometbft_tpu_torch.ops import dispatch, integrity
from cometbft_tpu_torch.ops import ed25519_kernel as EK
from cometbft_tpu_torch.ops.bls12381 import fp, htc

SCHEME = "bls12381"
PUB_KEY_SIZE = 48
SIGNATURE_SIZE = 96


def _dst() -> bytes:
    from cometbft_tpu_torch.crypto import bls12381

    return bls12381.DST


def oracle_verify(pub: bytes, msg: bytes, sig: bytes) -> bool:
    """The exact host oracle of the recheck."""
    return oracle.bls_verify(bytes(pub), as_bytes(msg), bytes(sig), _dst())


# the scheme record the shared verify glue reads (name, recheck oracle)
BLS = EK.Scheme(SCHEME, b"", None, None, None, None, oracle_verify, False)

# the generators' encodings: the placeholder rows of structural rejects and
# padding lanes (decodable, in the subgroup; their verdicts are masked)
_G1_GEN_ENC = oracle.bls_g1_compress(oracle.BLS_G1)
_G2_GEN_ENC = oracle.bls_g2_compress(oracle.BLS_G2)


# ------------------------------------------------------------------ staging


def _structural_check(pubs, sigs, n):
    """Host structural pass: lengths, compression flags, infinity rejection,
    x < p: everything the oracle rejects before field math. Returns (pre_ok,
    pk_rows (n, 48) uint8, sig_rows (n, 96) uint8) with the generators'
    encodings in place of bad rows."""
    pre_ok = np.ones(n, dtype=bool)
    pk_rows = np.empty((n, PUB_KEY_SIZE), dtype=np.uint8)
    sig_rows = np.empty((n, SIGNATURE_SIZE), dtype=np.uint8)
    p = oracle.BLS_P
    for i in range(n):
        pk, sg = pubs[i], sigs[i]
        ok = len(pk) == PUB_KEY_SIZE and len(sg) == SIGNATURE_SIZE
        if ok:
            ok = bool(pk[0] & 0x80) and not (pk[0] & 0x40)
            ok = ok and bool(sg[0] & 0x80) and not (sg[0] & 0x40)
        if ok:
            ok = int.from_bytes(bytes([pk[0] & 0x1F]) + pk[1:], "big") < p
            ok = (ok and int.from_bytes(bytes([sg[0] & 0x1F]) + sg[1:48], "big") < p
                  and int.from_bytes(sg[48:], "big") < p)
        pre_ok[i] = ok
        pk_rows[i] = np.frombuffer(pk if ok else _G1_GEN_ENC, dtype=np.uint8)
        sig_rows[i] = np.frombuffer(sg if ok else _G2_GEN_ENC, dtype=np.uint8)
    return pre_ok, pk_rows, sig_rows


def _x_planes(rows: np.ndarray):
    """(n, 48) or (n, 96) compressed encodings -> (raw x limb planes, the
    sign flags (n,) int32): (35, n) for G1; (2, 35, n) [c0, c1] for G2, whose
    wire order is x_c1 || x_c0."""
    sign = ((rows[:, 0] & 0x20) != 0).astype(np.int32)
    x = rows.copy()
    x[:, 0] &= 0x1F
    if rows.shape[1] == PUB_KEY_SIZE:
        return fp.bytes_be_to_limbs(x), sign
    return np.stack([fp.bytes_be_to_limbs(np.ascontiguousarray(x[:, 48:])),
                     fp.bytes_be_to_limbs(np.ascontiguousarray(x[:, :48]))]), sign


def stage_batch_bls(pubs, msgs, sigs, bucket: int):
    """Host staging: structural checks, SHA-256 message expansion, limb
    packing. Returns (pre_ok (n,), block (7, 35, bucket) int32, flags (3,
    bucket) int32), flags rows [pk sign, sig sign, is_pad]. msgs=None
    zero-fills the u-planes (3..6)."""
    n = len(sigs)
    pre_ok, pk_rows, sig_rows = _structural_check(pubs, sigs, n)
    pad = bucket - n
    if pad:
        pk_rows = np.concatenate([pk_rows, np.broadcast_to(
            np.frombuffer(_G1_GEN_ENC, np.uint8), (pad, 48))])
        sig_rows = np.concatenate([sig_rows, np.broadcast_to(
            np.frombuffer(_G2_GEN_ENC, np.uint8), (pad, 96))])
    flags = np.zeros((3, bucket), dtype=np.int32)
    block = np.empty((7, fp.NLIMBS, bucket), dtype=np.int32)
    block[0], flags[0] = _x_planes(pk_rows)
    block[1:3], flags[1] = _x_planes(sig_rows)
    flags[2, n:] = 1
    if msgs is None:
        block[3:] = 0
    else:
        msg_bytes = [as_bytes(m) for m in msgs] + [b""] * pad
        block[3:7] = np.stack(htc.hash_to_field_limbs(msg_bytes, _dst()))
    return pre_ok, block, flags


# ------------------------------------------------------------ device pieces

_consts: dict = {}


def _neg_g1(dev: torch.device, lanes: int) -> torch.Tensor:
    """-g1's affine planes broadcast to `lanes` lanes."""
    t = _consts.get(dev)
    if t is None:
        x, y = oracle._NEG_G1
        t = _consts[dev] = BL.planes_of_ints([[x], [y]], dev)
    return t.expand(-1, lanes).contiguous()


def _i32(a, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(dev)


def verify_batch_async(pubs, msgs, sigs, device=None,
                       recheck_groups: list[tuple[int, int]] | None = None,
                       domain: str = "") -> EK.BatchThunk:
    """Stage and launch a batch of single verifies on `device` (default
    cuda; "cpu" runs the plain versions) under the dispatch lock, on the
    dispatch stream of fault domain `domain` ("" the single-card path):
    B1 (keys), B1 (signatures), B2, B4, B5, then K6. Returns
    the thunk that ed25519_kernel.resolve_batches fetches; every lane that
    passed the structural checks may be rechecked on the oracle, as in the
    reference. Host and device time go to the parts pack, verify, header."""
    n = len(sigs)
    if len(pubs) != n or len(msgs) != n:
        raise ValueError("pubs, msgs and sigs differ in length")
    dev = resolve_device(device)
    thunk = EK.BatchThunk(BLS, dev, n, (list(pubs), list(msgs), list(sigs)), recheck_groups,
                          domain)
    if n == 0:
        return thunk
    b = EK.bucket_size(n)
    with dispatch.launching(dev, domain):
        part = EK._Parts(dev)
        with part("pack"):
            pre_ok, block, flags = stage_batch_bls(pubs, msgs, sigs, b)
            expected = EK._host_checksum(block, flags)
            block_d, flags_d = _i32(block, dev), _i32(flags, dev)
            lanes = _i32(np.stack([np.arange(b), np.arange(b, 2 * b)], 1).reshape(-1), dev)
            starts = _i32(np.arange(0, 2 * b + 1, 2), dev)
        with part("verify"):
            okp, pk = BL.decompress(1, block_d[0], flags_d[0], True)
            oks, sg = BL.decompress(2, block_d[1:3], flags_d[1], True)
            h, _ = BL.hash_to_g2(block_d[3:7])
            f = BL.miller(torch.cat([_neg_g1(dev, b), pk], -1), torch.cat([sg, h], -1))
            ok, _, allok = BL.final_exp(f, lanes, starts, okp, oks, flags_d[2])
        with part("header"):
            header, payload = integrity.integrity_parts(ok, allok, expected, block_d, flags_d)
    thunk.pre_ok, thunk.ok_a, thunk.expected = pre_ok, np.ones(n, dtype=bool), expected
    thunk.header, thunk.payload = header, payload
    thunk.keep = (block_d, flags_d, lanes, starts, okp, pk, oks, sg, h, f, ok, allok)
    return thunk


def verify_batch(pubs, msgs, sigs, device=None) -> tuple[bool, list[bool]]:
    """Batched single-verify with a per-signature mask."""
    if len(sigs) == 0:
        return True, []
    mask = EK.resolve_batches([verify_batch_async(pubs, msgs, sigs, device)])[0]
    return bool(mask.all()), mask.tolist()


def mesh_shard_verify(device, pubs, msgs, sigs, domain: str):
    """One mesh fault domain's BLS shard (the counterpart of the
    reference's mesh_shard_verify): B1 -> B2 -> B4 -> B5 -> K6 on the
    domain's stream through verify_batch_async, the header and payload
    decoded by resolve_batches with no host recheck (the mesh rechecks the
    whole batch). A staging checksum or echo mismatch gets one fresh run;
    a second raises DeviceOpFailed, and the mesh redispatches the shard.
    Returns (mask (n,), eligible (n,)); fires the chaos site
    "bls12381.dispatch"."""
    from cometbft_tpu_torch.libs import chaos

    chaos.fire(f"{SCHEME}.dispatch")
    for _attempt in range(2):
        thunk = verify_batch_async(pubs, msgs, sigs, device=device, recheck_groups=[],
                                   domain=domain)
        try:
            mask = EK.resolve_batches([thunk])[0]
        except EK.TransferIntegrityError:
            continue
        return mask, thunk.eligible
    raise dispatch.DeviceOpFailed("bls12381 mesh shard transfer integrity check failed twice")


# ------------------------------------------------------------ aggregate path

# validator-set key cache: (device, SHA-256 of the keys) -> (ok (n,) int32
# with the subgroup check, affine planes). A validator set re-verifies every
# height; its keys are decoded and subgroup-checked once. FIFO.
_VALSET_CAP = 64
_valsets: OrderedDict = OrderedDict()
_valset_lock = threading.Lock()
VALSET_STATS = {"hits": 0, "misses": 0}


def reset_valset_cache() -> None:
    with _valset_lock:
        _valsets.clear()
        for k in VALSET_STATS:
            VALSET_STATS[k] = 0


def _valset_keys(pubs, pk_rows: np.ndarray, dev: torch.device):
    """(ok with the subgroup check, affine planes) of the keys: B1 with the
    subgroup check on a set's first sight, the cache after."""
    key = (dev, hashlib.sha256(b"".join(bytes(p) for p in pubs)).digest())
    with _valset_lock:
        hit = _valsets.get(key)
        VALSET_STATS["hits" if hit is not None else "misses"] += 1
    if hit is not None:
        return hit
    x, sign = _x_planes(pk_rows)
    ent = BL.decompress(1, _i32(x, dev), _i32(sign, dev), True)
    with _valset_lock:
        _valsets[key] = ent
        while len(_valsets) > _VALSET_CAP:
            _valsets.popitem(last=False)
    return ent


def aggregate_signatures(sigs) -> bytes:
    """Sum per-vote signatures into the one 96-byte aggregate a commit
    certificate carries (host point adds). Raises ValueError on undecodable
    or infinity inputs."""
    return oracle.bls_aggregate([bytes(s) for s in sigs])


def aggregate_verify(pubs, msgs, sigs, device=None) -> bool:
    """The one-pairing-product commit check over per-vote rows (see the
    module note) on `device` (default: the crypto backend's)."""
    n = len(sigs)
    if n == 0 or len(pubs) != n or len(msgs) != n:
        return False
    return _aggregate(pubs, msgs, sigs, False, device)


def aggregate_verify_agg(pubs, msgs, agg_sig, device=None) -> bool:
    """The certificate entry: the same check with the signature already
    aggregated."""
    n = len(pubs)
    if n == 0 or len(msgs) != n or len(agg_sig) != SIGNATURE_SIZE:
        return False
    return _aggregate(pubs, msgs, [bytes(agg_sig)] * n, True, device)


def _aggregate(pubs, msgs, sigs, presummed: bool, device) -> bool:
    from cometbft_tpu_torch.crypto import batch as crypto_batch

    dev = crypto_batch.backend_device() if device is None else resolve_device(device)
    n = len(sigs)
    with dispatch.launching(dev):
        part = EK._Parts(dev)
        with part("pack"):
            pre_ok, pk_rows, sig_rows = _structural_check(pubs, sigs, n)
            if not pre_ok.all():
                return False
            msg_b = [as_bytes(m) for m in msgs]
            distinct = list(dict.fromkeys(msg_b))
            group_of = {m: i for i, m in enumerate(distinct)}
            lane_group = np.fromiter((group_of[m] for m in msg_b), np.int64, n)
            order = _i32(np.argsort(lane_group, kind="stable"), dev)
            pk_starts = _i32(np.searchsorted(np.sort(lane_group), np.arange(len(distinct) + 1)),
                             dev)
            sx, ssign = _x_planes(sig_rows[:1] if presummed else sig_rows)
            u = _i32(np.stack(htc.hash_to_field_limbs(distinct, _dst())), dev)
            sx_d, ssign_d = _i32(sx, dev), _i32(ssign, dev)
            d = len(distinct)
            all_lanes = _i32(np.arange(max(n, d + 1)), dev)
            one_check, sig_group = _i32([0, d + 1], dev), _i32([0, n], dev)
        with part("keys"):
            okp, pk = _valset_keys(pubs, pk_rows, dev)
        with part("verify"):
            oks, sg = BL.decompress(2, sx_d, ssign_d, presummed)
            verdict = okp.all() & oks.all()
            if presummed:  # the one signature is the sum, subgroup-checked by B1
                sig_sum = sg
            else:
                sig_sum, sid, ssub = BL.point_sum(2, sg, all_lanes[:n], sig_group, True)
                verdict = verdict & (ssub[0] != 0) & (sid[0] == 0)
            pk_sum, pid, _ = BL.point_sum(1, pk, order, pk_starts, False)
            h, _ = BL.hash_to_g2(u)
            f = BL.miller(torch.cat([pk_sum, _neg_g1(dev, 1)], -1), torch.cat([h, sig_sum], -1))
            ok, _, _ = BL.final_exp(f, all_lanes[:d + 1], one_check)
            verdict = verdict & (pid == 0).all() & (ok[0] != 0)
        with part("fetch"):
            return bool(verdict.item())
