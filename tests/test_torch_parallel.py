"""The port's SPMD plane (cometbft_tpu_torch/parallel/mesh.py
sharded_verify_batch: one staged batch, K1 once a domain on its lane
slice) on 8 CPU domains against the reference's shard_map program on its 8
forced CPU devices (tests/test_parallel.py's cases), on the same seeded
rows: (all-ok, mask) equal. Every batch here is at the 16-lane bucket, 2
lanes a domain, so the reference compiles its program once.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from cometbft_tpu.crypto import ed25519_math as joracle
from cometbft_tpu.parallel import batch_mesh as jbatch_mesh
from cometbft_tpu.parallel import sharded_verify_batch as jsharded
from cometbft_tpu.parallel.mesh import _mesh_bucket as jmesh_bucket
from cometbft_tpu_torch.ops import ed25519_kernel as TK
from cometbft_tpu_torch.parallel import batch_mesh, sharded_verify_batch
from cometbft_tpu_torch.parallel.mesh import _mesh_bucket


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def meshes(jax_cpu_devices):
    return jbatch_mesh(jax_cpu_devices[:8]), batch_mesh([torch.device("cpu")] * 8)


def _sign_n(n, seed):
    rng = np.random.default_rng(seed)
    pubs, msgs, sigs = [], [], []
    for i in range(n):
        sk = rng.bytes(32)
        pubs.append(joracle.public_key_from_seed(sk))
        msgs.append(b"mesh-vote-" + i.to_bytes(4, "big"))
        sigs.append(joracle.sign(sk, msgs[-1]))
    return pubs, msgs, sigs


def _both(meshes, pubs, msgs, sigs, cache=None):
    want = jsharded(pubs, msgs, sigs, mesh=meshes[0])
    got = sharded_verify_batch(pubs, msgs, sigs, mesh=meshes[1], cache=cache)
    assert got == want
    return got


def test_all_valid_divisible_k1_once_a_domain_on_its_slice(meshes, monkeypatch):
    from cometbft_tpu_torch.ops import verify_kernel as VK

    shapes = []
    real = VK.verify_ok_raw

    def spy(*planes):
        shapes.append([(tuple(p.shape), p.is_contiguous()) for p in planes])
        return real(*planes)

    monkeypatch.setattr(VK, "verify_ok_raw", spy)
    assert _both(meshes, *_sign_n(16, 1)) == (True, [True] * 16)
    assert shapes == [[((20, 2), True)] * 4 + [((8, 2), True)] * 3] * 8


def test_bad_signatures_pinpointed_across_shards(meshes):
    pubs, msgs, sigs = _sign_n(16, 2)
    bad = [1, 9, 15]  # the shards of domains 0, 4 and 7
    for i in bad:
        sigs[i] = sigs[i][:32] + sigs[(i + 1) % 16][32:]
    assert _both(meshes, pubs, msgs, sigs) == (False, [i not in bad for i in range(16)])


def test_non_divisible_batch_pads_to_mesh(meshes):
    assert _both(meshes, *_sign_n(11, 3)) == (True, [True] * 11)
    for n_dev in range(1, 9):
        for n in (1, 5, 8, 11, 16, 100, 2049, 10240):
            assert _mesh_bucket(n, n_dev) == jmesh_bucket(n, n_dev)
            assert _mesh_bucket(n, n_dev) % n_dev == 0


def test_structural_rejects_never_reach_device(meshes):
    pubs, msgs, sigs = _sign_n(9, 4)
    sigs[0] = sigs[0][:32] + joracle.L.to_bytes(32, "little")  # s >= L
    pubs[3] = b"\x00" * 31  # bad length
    want = [True] * 9
    want[0] = want[3] = False
    assert _both(meshes, pubs, msgs, sigs) == (False, want)


def test_matches_single_card_path_and_reuses_the_device_cache(meshes):
    pubs, msgs, sigs = _sign_n(10, 5)
    msgs[4] = msgs[4] + b"!"
    cache = TK.PubKeyCache("cpu")
    got = _both(meshes, pubs, msgs, sigs, cache=cache)
    assert got == TK.verify_batch(pubs, msgs, sigs, device="cpu")
    assert got[1] == [i != 4 for i in range(10)]
    assert len(cache._dev) == 1
    assert sharded_verify_batch(pubs, msgs, sigs, mesh=meshes[1], cache=cache) == got
    assert len(cache._dev) == 1  # the full batch's device entry, hit

