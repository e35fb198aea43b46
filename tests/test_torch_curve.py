"""The port's curve layer (cometbft_tpu_torch.ops.curve) against the JAX
package's: ZIP-215 decompression, the point formulas, the -A window table
and one ladder window, on identical seeded inputs.

All arithmetic is integer, so the tolerance is exact equality of every
limb of every coordinate, and of every ok flag.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cometbft_tpu.ops import curve as JC
from cometbft_tpu.ops import unpack as JU
from cometbft_tpu_torch.crypto import ed25519_math as oracle
from cometbft_tpu_torch.ops import curve as TC
from cometbft_tpu_torch.ops import limbs as TL
from cometbft_tpu_torch.ops import unpack as TU


def _eq(got, want) -> None:
    """Exact equality (integer arithmetic: no tolerance)."""
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _encodings(seed: int) -> np.ndarray:
    """(N, 32) uint8: honest points with both sign bits, non-canonical
    y >= p, small-order points, y with no square root, x = 0 with the sign
    bit set, and random bytes."""
    rng = np.random.default_rng(seed)
    encs = []
    for _ in range(6):
        k = int.from_bytes(rng.bytes(32), "little") % oracle.L
        encs.append(oracle.point_compress(oracle.scalar_mult(k, oracle.B_POINT)))
    encs += [v.to_bytes(32, "little") for v in (
        oracle.P + 1,                  # non-canonical identity
        oracle.P + 3,                  # non-canonical y = 3
        1,                             # identity
        oracle.P - 1,                  # (0, -1), order 2
        2,                             # no square root
        1 | (1 << 255),                # x = 0 with the sign bit: rejected
        (1 << 255) - 1,                # y = 2^255 - 1 >= p
    )]
    encs += [rng.bytes(32) for _ in range(3)]
    return np.frombuffer(b"".join(encs), dtype=np.uint8).reshape(-1, 32)


def _words(enc: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(TL.bytes_to_words(enc).T)


def _points(seed: int, n: int):
    """n random curve points as (JAX Point, port Point), extended
    coordinates with Z != 1 (a point times a random field factor)."""
    rng = np.random.default_rng(seed)
    cols = [[], [], [], []]
    for _ in range(n):
        k = int.from_bytes(rng.bytes(32), "little") % oracle.L
        x, y, z, t = oracle.scalar_mult(k, oracle.B_POINT)
        f = int.from_bytes(rng.bytes(32), "little") % oracle.P or 1
        for c, v in zip(cols, (x * f % oracle.P, y * f % oracle.P, z * f % oracle.P,
                               t * f % oracle.P)):
            c.append(TL.int_to_limbs(v))
    arrs = [np.stack(c, axis=1) for c in cols]
    return (JC.Point(*(jnp.asarray(a) for a in arrs)),
            TC.Point(*(torch.from_numpy(a.copy()) for a in arrs)))


def _eq_point(got: TC.Point, want: JC.Point) -> None:
    for g, w in zip(got, want):
        _eq(g, w)


def test_decompress_matches_jax_and_oracle():
    enc = _encodings(1)
    w = _words(enc)
    tw = torch.from_numpy(w.view(np.int32).copy())
    ok, p = TC.decompress_zip215(TU.words_to_y_limbs(tw), TU.words_sign(tw))
    jok, jp = JC.decompress_zip215(JU.words_to_y_limbs(jnp.asarray(w)),
                                   JU.words_sign(jnp.asarray(w)))
    _eq(ok, jok)
    _eq_point(p, jp)
    want = [oracle.point_decompress_zip215(bytes(e)) is not None for e in enc]
    assert ok.tolist() == want
    assert not all(want) and any(want)


@pytest.mark.parametrize("op", ["add", "double", "double_no_t", "neg",
                                "mul_by_cofactor", "is_identity"])
def test_point_ops_match_jax(op):
    jp, tp = _points(2, 8)
    jq, tq = _points(3, 8)
    if op == "add":
        got, want = TC.add(tp, tq), JC.add(jp, jq)
    else:
        got, want = getattr(TC, op)(tp), getattr(JC, op)(jp)
    if op == "is_identity":
        _eq(got, want)
    else:
        _eq_point(got, want)


def test_window_table_matches_jax():
    jp, tp = _points(4, 8)
    for g, w in zip(TC.build_point_table17(tp), JC.build_point_table17(jp)):
        _eq(g, w)
    for g, w in zip(TC.base_table17(torch.device("cpu")), JC._BASE_TABLE17):
        _eq(g, w)


@pytest.mark.parametrize("out_t", [False, True])
def test_window_step_matches_jax(out_t):
    """One ladder window over every signed digit value, both tables."""
    jacc, tacc = _points(5, 33)
    ja, ta = _points(6, 33)
    ds = np.arange(-16, 17, dtype=np.int32)
    dk = ds[::-1].copy()
    jtab_a = JC.build_point_table17(ja)
    ttab_a = TC.build_point_table17(ta)
    jtab_b = tuple(c + jnp.zeros_like(ja.x)[None] for c in JC._BASE_TABLE17)
    got = TC.window_step(tacc, torch.from_numpy(ds), torch.from_numpy(dk),
                         TC.base_table17(torch.device("cpu")), ttab_a, out_t)
    want = JC.window_step(jacc, jnp.asarray(ds), jnp.asarray(dk), jtab_b,
                          jtab_a, out_t)
    _eq_point(got, want)
