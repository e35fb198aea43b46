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
crypto/sr25519_math.batch_challenge_words_rows) and the structural checks
(lengths, the schnorrkel marker bit, s < L), which never reach the device.
Padding and placeholder lanes carry the ristretto identity, whose encoding
is 32 zero bytes, with zero scalars: they verify valid.
"""

from __future__ import annotations

import numpy as np

from cometbft_tpu_torch.crypto import sr25519_math as srm
from cometbft_tpu_torch.ops import ed25519_kernel as EK
from cometbft_tpu_torch.ops import verify_kernel as VK

_ID_ENC32 = bytes(32)  # the ristretto identity encoding

# ------------------------------------------------------------ host staging


def stage_rows_sr(pubs: list[bytes], msgs: list[bytes], sigs: list[bytes],
                  bucket: int):
    """Structural checks (lengths, marker bit 255 set, s < L with the
    marker cleared), the Merlin challenges of the whole batch, and the
    packed r/s/k words batch-minor (8, bucket) uint32, zero-padded (the
    identity encoding with zero scalars). Lanes that fail the checks get
    R = 0, s = 0, k = 0 and a zero pubkey. Returns (pre_ok, safe_pubs,
    r_words, s_words, k_words)."""
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
    s_rows = np.ascontiguousarray(sig_rows[:, 32:])
    s_rows[:, 31] &= 127
    pre_ok = ok_len & marker & EK.scalars_lt_l(s_rows)
    bad = np.flatnonzero(~pre_ok)
    if bad.size:
        sig_rows[bad, :32] = 0
        s_rows[bad] = 0
        safe_pubs = [p if pre_ok[i] else _ID_ENC32 for i, p in enumerate(safe_pubs)]
    r_rows = np.ascontiguousarray(sig_rows[:, :32])
    k_rows = srm.batch_challenge_words_rows(safe_pubs, r_rows, msgs)
    k_rows[~pre_ok] = 0
    out = np.zeros((3, 8, bucket), dtype=np.uint32)
    r_words, s_words, k_words = out[0], out[1], out[2]
    r_words[:, :n] = r_rows.view("<u4").T
    s_words[:, :n] = s_rows.view("<u4").T
    k_words[:, :n] = k_rows.T
    return pre_ok, safe_pubs, r_words, s_words, k_words


# ------------------------------------------------------------------ verify

SR25519 = EK.Scheme("sr25519", _ID_ENC32, VK.decompress_sr, stage_rows_sr,
                    VK.verify_sr_ok, srm.verify)


def decompress_points(enc: np.ndarray, device=None) -> tuple[np.ndarray, np.ndarray]:
    """(N, 32) uint8 ristretto encodings -> (ok (N,) bool, coords
    (N, 4, 20) int32), zero-padded internally to a bucket and decoded on
    `device`."""
    return EK.decompress_points(enc, device, SR25519)


def verify_batch(pubs: list[bytes], msgs: list[bytes], sigs: list[bytes],
                 cache: EK.PubKeyCache | None = None, device=None
                 ) -> tuple[bool, list[bool]]:
    """Schnorrkel batch verification with a per-signature mask. Runs on the
    cache's device when a cache is given (an sr25519 cache:
    ``PubKeyCache(device, SR25519)``), else on `device` (default cuda)."""
    mask, _ = EK.verify_rows(SR25519, pubs, msgs, sigs, cache, device)
    return bool(mask.all()), mask.tolist()
