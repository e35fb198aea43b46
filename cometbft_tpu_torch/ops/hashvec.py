"""Batch-axis host hashing for sr25519 staging: N Keccak-f[1600] states
under one permutation call.

The port's copy of the numpy Keccak rung of cometbft_tpu/ops/hashvec.py.
It has no native rung and no rung selection: the numpy batch rung is the
only one, and it is bit-for-bit equal to the serial Keccak of
crypto/sr25519_math.py.
"""

from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------- keccak
#
# State layout matches crypto/sr25519_math.keccak_f1600: lane i = x + 5*y,
# little-endian uint64 lanes, as an (N, 25) uint64 array (one row per
# independent sponge).

_KECCAK_RC = np.array([
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
], dtype=np.uint64)

_ROTC = [[0, 36, 3, 41, 18], [1, 44, 10, 45, 2], [62, 6, 43, 15, 61],
         [28, 55, 25, 21, 56], [27, 20, 39, 8, 14]]

# rho+pi fused as one gather + one vector rotate: out[j] = rotl(in[SRC[j]])
_PI_SRC = np.zeros(25, dtype=np.intp)
_RHO = np.zeros((25, 1), dtype=np.uint64)
for _x in range(5):
    for _y in range(5):
        _PI_SRC[_y + 5 * ((2 * _x + 3 * _y) % 5)] = _x + 5 * _y
        _RHO[_y + 5 * ((2 * _x + 3 * _y) % 5), 0] = _ROTC[_x][_y]
# (64 - r) & 63 keeps the r == 0 lane shift-safe: t<<0 | t>>0 == t
_RHO_INV = (np.uint64(64) - _RHO) & np.uint64(63)
_CHI1 = np.array([(i % 5 + 1) % 5 + 5 * (i // 5) for i in range(25)],
                 dtype=np.intp)
_CHI2 = np.array([(i % 5 + 2) % 5 + 5 * (i // 5) for i in range(25)],
                 dtype=np.intp)
_D_IDX = np.array([i % 5 for i in range(25)], dtype=np.intp)
_C_L = np.array([(x - 1) % 5 for x in range(5)], dtype=np.intp)
_C_R = np.array([(x + 1) % 5 for x in range(5)], dtype=np.intp)
_U1 = np.uint64(1)
_U63 = np.uint64(63)


def _keccak_batch_numpy(states: np.ndarray) -> None:
    """In-place Keccak-f[1600] over (N, 25) uint64 states (all N sponges
    advance under one permutation)."""
    a = states.T.copy()  # (25, N): lane-major for whole-lane vector ops
    for r in range(24):
        c = np.bitwise_xor.reduce(a.reshape(5, 5, -1), axis=0)  # theta: (5,N)
        cr = c[_C_R]
        d = c[_C_L] ^ ((cr << _U1) | (cr >> _U63))
        a ^= d[_D_IDX]
        t = a[_PI_SRC]  # rho + pi
        t = (t << _RHO) | (t >> _RHO_INV)
        a = t ^ (~t[_CHI1] & t[_CHI2])  # chi
        a[0] ^= _KECCAK_RC[r]  # iota
    states[:] = a.T


def keccak_f1600_many(states: np.ndarray) -> None:
    """Advance N independent Keccak-f[1600] states (one (N, 25) uint64
    array, modified in place) under one permutation call."""
    if states.dtype != np.uint64 or states.ndim != 2 or states.shape[1] != 25:
        raise ValueError("states must be an (N, 25) uint64 array")
    if states.shape[0]:
        _keccak_batch_numpy(states)

