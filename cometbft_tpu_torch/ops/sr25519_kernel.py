"""Batched sr25519 (schnorrkel) verification: host staging with Merlin
challenges and the scheme record that runs it through the shared verify
path of ops/ed25519_kernel.py (pubkey cache, device glue, host recheck).

The schnorrkel equation over ristretto255 reduces to edwards25519
arithmetic,

    accept  iff  [4]( [s]B - [k]A - R ) == O

because two edwards points map to the same ristretto255 element exactly
when they differ by a 4-torsion point: the cofactor-4 coset check is
ristretto equality. So the device ladder is the ed25519 one (same limbs,
same packed words, same signed 5-bit windows); only the point decoding
(ristretto255 DECODE instead of ZIP-215 decompression) and the cofactor
(4 instead of 8) differ. The plain ristretto decode is
curve.ristretto_decode_device; the kernels are in ops/verify_kernel.py.

The host keeps what is host-shaped: the Merlin transcript challenges
(STROBE over Keccak, batched per message length by
crypto/sr25519_math.batch_challenge_words_rows through the native rungs:
hashvec's SIMD Keccak, strobe.c for small groups) and the structural checks
(lengths, the schnorrkel marker bit, s < L), which never reach the device.
So sr25519 always takes the classic path of verify_rows: pubkeys from the
key tables (ops/residency.py, the scheme's own cache), r/s/k words in one
transfer, and the r/s/k-form integrity header.
Padding and placeholder lanes carry the ristretto identity, whose encoding
is 32 zero bytes, with zero scalars: they verify valid.
"""

from __future__ import annotations

import numpy as np

from cometbft_tpu_torch.crypto import sr25519_math as srm
from cometbft_tpu_torch.libs.prefixrows import as_bytes
from cometbft_tpu_torch.ops import ed25519_kernel as EK
from cometbft_tpu_torch.ops import verify_kernel as VK

_ID_ENC32 = bytes(32)  # the ristretto identity encoding

# ------------------------------------------------------------ host staging


def structural_sr(pubs: list[bytes], sigs: list[bytes]):
    """Structural checks (lengths, marker bit 255 set, s < L with the marker
    cleared). Lanes that fail get R = 0, s = 0 and a zero pubkey (the
    identity). Returns (pre_ok, safe_pubs, sig_rows (N, 64) with s's marker
    cleared, None: no pubkey rows are needed)."""
    n = len(sigs)
    ok_len = np.fromiter(map(len, sigs), np.int64, n) == 64
    ok_len &= np.fromiter(map(len, pubs), np.int64, n) == 32
    if ok_len.all():
        sig_rows = np.frombuffer(b"".join(sigs), dtype=np.uint8).reshape(n, 64).copy()
        safe_pubs = list(pubs)
    else:
        sig_rows = np.zeros((n, 64), dtype=np.uint8)
        safe_pubs = [_ID_ENC32] * n
        for i in np.flatnonzero(ok_len):
            sig_rows[i] = np.frombuffer(sigs[i], dtype=np.uint8)
            safe_pubs[i] = pubs[i]
    # schnorrkel signature parse (srm.parse_signature): the marker must be
    # set, and s with the marker cleared must be < L
    marker = (sig_rows[:, 63] & 128) != 0
    sig_rows[:, 63] &= 127
    pre_ok = ok_len & marker & EK.scalars_lt_l(sig_rows[:, 32:])
    bad = np.flatnonzero(~pre_ok)
    if bad.size:
        sig_rows[bad] = 0
        safe_pubs = [p if pre_ok[i] else _ID_ENC32 for i, p in enumerate(safe_pubs)]
    return pre_ok, safe_pubs, sig_rows, None


def pack_sr(pre_ok, safe_pubs, sig_rows, pub_rows, msgs, bucket: int) -> np.ndarray:
    """The Merlin challenges of the whole batch and the packed r/s/k words,
    (3, 8, bucket) uint32, zero-padded (the identity encoding with zero
    scalars). Merlin absorbs exact bytes: factored rows are materialized
    here."""
    n = sig_rows.shape[0]
    r_rows = np.ascontiguousarray(sig_rows[:, :32])
    k_rows = srm.batch_challenge_words_rows(safe_pubs, r_rows, [as_bytes(m) for m in msgs])
    k_rows[~pre_ok] = 0
    out = np.zeros((3, 8, bucket), dtype=np.uint32)
    out[0, :, :n] = r_rows.view("<u4").T
    out[1, :, :n] = np.ascontiguousarray(sig_rows[:, 32:]).view("<u4").T
    out[2, :, :n] = k_rows.T
    return out


def stage_rows_sr(pubs: list[bytes], msgs: list, sigs: list[bytes], bucket: int):
    """The host staging of a batch: (pre_ok, safe_pubs, r_words, s_words,
    k_words), the word planes (8, bucket) uint32."""
    return SR25519.stage(pubs, msgs, sigs, bucket)


# ------------------------------------------------------------------ verify

SR25519 = EK.Scheme("sr25519", _ID_ENC32, VK.decompress_sr, structural_sr, pack_sr,
                    VK.verify_sr_ok_raw, srm.verify, False)


def decompress_points(enc: np.ndarray, device=None) -> tuple[np.ndarray, np.ndarray]:
    """(N, 32) uint8 ristretto encodings -> (ok (N,) bool, coords
    (N, 4, 20) int32), zero-padded internally to a bucket and decoded on
    `device`."""
    return EK.decompress_points(enc, device, SR25519)


def verify_batch_async(pubs: list[bytes], msgs: list, sigs: list[bytes],
                       cache: EK.PubKeyCache | None = None, device=None,
                       recheck_groups: list[tuple[int, int]] | None = None) -> EK.BatchThunk:
    """Stage and launch a schnorrkel batch without waiting for the card (the
    counterpart of cometbft_tpu/ops/sr25519_kernel.py verify_batch_async):
    the thunk resolves with ed25519_kernel.resolve_batches, alone or beside
    an ed25519 batch in one fetch."""
    return EK.verify_batch_async(SR25519, pubs, msgs, sigs, cache, device, recheck_groups)


def verify_batch(pubs: list[bytes], msgs: list[bytes], sigs: list[bytes],
                 cache: EK.PubKeyCache | None = None, device=None
                 ) -> tuple[bool, list[bool]]:
    """Schnorrkel batch verification with a per-signature mask. Runs on the
    cache's device when a cache is given (an sr25519 cache:
    ``PubKeyCache(device, SR25519)``), else on `device` (default cuda)."""
    mask, _ = EK.verify_rows(SR25519, pubs, msgs, sigs, cache, device)
    return bool(mask.all()), mask.tolist()
