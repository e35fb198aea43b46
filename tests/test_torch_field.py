"""The port's field arithmetic and wire unpacking (cometbft_tpu_torch.ops
field / unpack) against the JAX package's, on identical seeded inputs.

All arithmetic is integer, so the tolerance is exact equality of every
limb: raw carried limbs, not just values mod p.
"""

from __future__ import annotations

import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cometbft_tpu.ops import field as JF
from cometbft_tpu.ops import unpack as JU
from cometbft_tpu_torch.crypto import ed25519_math as oracle
from cometbft_tpu_torch.ops import field as TF
from cometbft_tpu_torch.ops import limbs as TL
from cometbft_tpu_torch.ops import unpack as TU

B = 16


def _limbs(vals) -> np.ndarray:
    """Python ints -> (20, B) int32 limbs."""
    return np.stack([TL.int_to_limbs(v) for v in vals], axis=1)


def _carried_inputs(seed: int) -> list[np.ndarray]:
    """Canonical field elements, full 260-bit redundant values, the edge
    values 0, 1, p-1, p, and outputs of chained products (carried limbs
    above 13 bits, as the ladder produces them)."""
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(32), "little") % oracle.P for _ in range(B - 4)]
    vals += [0, 1, oracle.P - 1, oracle.P]
    canon = _limbs(vals)
    wide = rng.integers(0, TL.MASK + 1, size=(TL.NLIMBS, B), dtype=np.int32)
    chained = np.asarray(JF.mul(JF.sq(jnp.asarray(wide)), jnp.asarray(canon)))
    subbed = np.asarray(JF.sub(jnp.asarray(canon), jnp.asarray(chained)))
    return [canon, wide, chained, subbed]


def _jax(x: np.ndarray):
    return jnp.asarray(x)


def _torch(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def _eq(got: torch.Tensor, want) -> None:
    """Exact equality, limb for limb (integer arithmetic: no tolerance)."""
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("op", ["add", "sub", "mul"])
def test_binary_ops_match_jax(op):
    xs = _carried_inputs(1)
    for a in xs:
        for b in xs:
            _eq(getattr(TF, op)(_torch(a), _torch(b)),
                getattr(JF, op)(_jax(a), _jax(b)))


@pytest.mark.parametrize("op", ["sq", "neg", "canonicalize", "is_zero"])
def test_unary_ops_match_jax(op):
    for a in _carried_inputs(2):
        _eq(getattr(TF, op)(_torch(a)), getattr(JF, op)(_jax(a)))


# Y - Z of an identity point, as sub() leaves it: a multiple of p whose
# borrow at limb 13 must cross limbs 14..19 before the limbs are canonical.
_ZERO_RUN = [7603] + [8191] * 12 + [-1, 8192] + [8191] * 4 + [7935]


def test_canonicalize_carries_across_a_run_of_full_limbs():
    x = np.array(_ZERO_RUN, dtype=np.int32)[:, None]
    assert TL.limbs_to_int(x[:, 0]) % oracle.P == 0
    _eq(TF.canonicalize(_torch(x)), np.zeros((TL.NLIMBS, 1), dtype=np.int32))
    assert bool(TF.is_zero(_torch(x))[0])
    # every carried input: canonical limbs holding the value mod p
    for x in _carried_inputs(9) + [np.repeat(x, B, axis=1)]:
        c = TF.canonicalize(_torch(x)).numpy()
        assert ((c >= 0) & (c <= TL.MASK)).all()
        assert [TL.limbs_to_int(c[:, i]) for i in range(B)] == [
            TL.limbs_to_int(x[:, i]) % oracle.P for i in range(B)]


def test_pow22523_matches_jax_and_oracle():
    a = _carried_inputs(3)[0]
    got = TF.pow22523(_torch(a))
    _eq(got, JF.pow22523(_jax(a)))
    canon = TF.canonicalize(got).numpy()
    for i in range(B):
        z = TL.limbs_to_int(a[:, i]) % oracle.P
        assert TL.limbs_to_int(canon[:, i]) == pow(z, (oracle.P - 5) // 8, oracle.P)


def test_long_chain_stays_equal():
    """A ladder-length chain of mixed ops: every step equal to JAX."""
    a, b = (_carried_inputs(4)[i] for i in (2, 3))
    ta, tb, ja, jb = _torch(a), _torch(b), _jax(a), _jax(b)
    for _ in range(60):
        ta, ja = TF.mul(ta, tb), JF.mul(ja, jb)
        tb, jb = TF.sub(tb, ta), JF.sub(jb, ja)
        ta, ja = TF.sq(TF.add(ta, tb)), JF.sq(JF.add(ja, jb))
        tb, jb = TF.neg(tb), JF.neg(jb)
    _eq(ta, ja)
    _eq(tb, jb)


def test_constants_and_round_counts_match_jax():
    """Same constants and carry-round counts as the JAX field: the interval
    proof of tests/test_field_intervals.py then covers the port."""
    for name, jname in (("P", "P_LIMBS"), ("D", "D"), ("D2", "D2"),
                        ("SQRT_M1", "SQRT_M1"), ("ONE", "ONE"), ("M_SUB", "M_SUB")):
        assert TF.CONST_LIMBS[name] == np.asarray(getattr(JF, jname))[:, 0].tolist()
    for name in ("ADD_ROUNDS", "SUB_ROUNDS", "HI_ROUNDS", "CONV20_ROUNDS", "FOLD"):
        assert getattr(TF, name) == getattr(JF, name)


def test_kernel_source_constants_match_field():
    """The CUDA kernel's __constant__ tables hold the plain version's limbs."""
    src = (pathlib.Path(TF.__file__).parent.parent / "csrc"
           / "ed25519_verify.cu").read_text()
    for name in ("P", "D", "D2", "SQRT_M1", "M_SUB"):
        m = re.search(r"__constant__ int C_%s\[NL\] = \{([^}]*)\};" % name, src)
        assert m, name
        assert [int(v) for v in m.group(1).split(",")] == TF.CONST_LIMBS[name]


# ------------------------------------------------------------------ unpack


def _words(seed: int, n: int, scalars: bool) -> np.ndarray:
    """(8, n) uint32 words; about half of them with bit 31 set. Scalars are
    < L (what staging hands the device); point encodings are any 256 bits."""
    rng = np.random.default_rng(seed)
    if scalars:
        vals = [int.from_bytes(rng.bytes(32), "little") % oracle.L for _ in range(n - 3)]
        vals += [0, oracle.L - 1, (1 << 252) + (1 << 251) - 1]
        raw = b"".join(v.to_bytes(32, "little") for v in vals)
        w = np.frombuffer(raw, dtype="<u4").reshape(n, 8).T.copy()
    else:
        w = rng.integers(0, 1 << 32, size=(8, n), dtype=np.uint32)
        w[:, 0] = 0xFFFFFFFF
    assert (w >> 31).any()
    return w


@pytest.mark.parametrize("fn", ["words_to_y_limbs", "words_sign"])
def test_point_unpack_matches_jax(fn):
    w = _words(5, 64, scalars=False)
    _eq(getattr(TU, fn)(_torch(w.view(np.int32))), getattr(JU, fn)(_jax(w)))


def test_signed_digits_match_jax_and_value():
    w = _words(6, 64, scalars=True)
    got = TU.words_to_digits5_signed(_torch(w.view(np.int32)))
    _eq(got, JU.words_to_digits5_signed(_jax(w)))
    d = got.numpy()
    assert d.min() >= -16 and d.max() <= 15
    for i in range(w.shape[1]):
        value = int.from_bytes(w[:, i].astype("<u4").tobytes(), "little")
        assert sum(int(d[j, i]) * 32**j for j in range(TU.NDIGITS5)) == value
