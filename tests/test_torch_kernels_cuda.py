"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Imports only the port (the card's machine has no JAX); without a
GPU every test here skips. Run on the card with

    pytest -m cuda tests/test_torch_kernels_cuda.py

All arithmetic is integer: equality is exact. The decoders' X, Y, Z, T are
canonical limbs and the plain version's carried ones, so they are compared
by canonical value (verify_kernel.decode_err), ok bit for bit.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from cometbft_tpu_torch.crypto import ed25519 as ted
from cometbft_tpu_torch.crypto import ed25519_math as oracle
from cometbft_tpu_torch.crypto import sr25519 as tsr
from cometbft_tpu_torch.crypto import sr25519_math as srm
from cometbft_tpu_torch.ops import ed25519_kernel as TK
from cometbft_tpu_torch.ops import microbench as MB
from cometbft_tpu_torch.ops import sr25519_kernel as TS
from cometbft_tpu_torch.ops import verify_kernel as VK


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _batch(n: int):
    privs = [ted.gen_priv_key_from_secret(b"card-%d" % i) for i in range(n)]
    pubs = [p.pub_key().bytes_() for p in privs]
    msgs = [b"msg-%d" % i for i in range(n)]
    sigs = [p.sign(m) for p, m in zip(privs, msgs)]
    sigs[0] = sigs[1]  # wrong signature
    pubs[2] = (oracle.P + 1).to_bytes(32, "little")  # non-canonical identity
    sigs[2] = pubs[2] + bytes(32)  # ... which validly signs anything
    sigs[3] = (2).to_bytes(32, "little") + sigs[3][32:]  # R not on the curve
    return pubs, msgs, sigs


@pytest.mark.cuda
@pytest.mark.parametrize("n", [5, 130])
def test_kernels_match_plain_and_oracle(cuda, n):
    pubs, msgs, sigs = _batch(n)
    b = TK.bucket_size(n)
    _, safe, r, s, k = TK.stage_batch(pubs, msgs, sigs, b)
    enc = np.frombuffer(b"".join(safe), dtype=np.uint8).reshape(n, 32)
    _, coords = TK.decompress_points(enc, cuda)
    t = TK.staged_from_numpy(*TK.pad_coords_batch_minor(coords, b), r, s, k,
                             device=cuda)
    mask, allok = VK.verify_ok(*t)
    pmask, pall = VK.verify_math_ok(*t)
    assert torch.equal(mask, pmask) and bool(allok) == bool(pall) is False
    # the decoder's limbs are canonical, the plain version's carried
    assert VK.decode_err(VK.decompress(t[4]), VK.decompress_math(t[4])) == 0
    final, flips = TK.verify_rows(TK.ED25519, pubs, msgs, sigs, cache=TK.PubKeyCache(cuda))
    assert flips == 0
    assert final.tolist() == [oracle.verify_zip215(p, m, s)
                              for p, m, s in zip(pubs, msgs, sigs)]


@pytest.mark.cuda
def test_wrapper_rejects_bad_inputs(cuda):
    words = torch.zeros((8, 16), dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        VK.decompress(words.to(torch.int64))
    with pytest.raises(ValueError):
        VK.decompress(words[:, ::2])
    with pytest.raises(ValueError):
        VK.decompress(words[:7])


@pytest.mark.cuda
@pytest.mark.parametrize("n", [5, 130])
def test_valid_batch_sets_all_ok(cuda, n):
    privs = [ted.gen_priv_key_from_secret(b"ok-%d" % i) for i in range(n)]
    pubs = [p.pub_key().bytes_() for p in privs]
    msgs = [b"msg-%d" % i for i in range(n)]
    sigs = [p.sign(m) for p, m in zip(privs, msgs)]
    b = TK.bucket_size(n)
    _, safe, r, s, k = TK.stage_batch(pubs, msgs, sigs, b)
    enc = np.frombuffer(b"".join(safe), dtype=np.uint8).reshape(n, 32)
    _, coords = TK.decompress_points(enc, cuda)
    t = TK.staged_from_numpy(*TK.pad_coords_batch_minor(coords, b), r, s, k,
                             device=cuda)
    mask, allok = VK.verify_ok(*t)
    pmask, pall = VK.verify_math_ok(*t)
    assert torch.equal(mask, pmask) and bool(mask.all())
    assert bool(allok) == bool(pall) is True
    final, flips = TK.verify_rows(TK.ED25519, pubs, msgs, sigs, cache=TK.PubKeyCache(cuda))
    assert flips == 0 and bool(final.all())


def _sr_batch(n: int, tampered: bool):
    """n schnorrkel signatures; with `tampered` the first four are bad:
    another lane's signature, R >= p, R odd, the marker bit cleared."""
    privs = [tsr.gen_priv_key_from_secret(b"sr-card-%d" % i) for i in range(n)]
    pubs = [p.pub_key().bytes_() for p in privs]
    msgs = [b"msg-%d" % i for i in range(n)]
    sigs = [p.sign(m) for p, m in zip(privs, msgs)]
    if tampered:
        sigs[0] = sigs[1]
        sigs[1] = (oracle.P + 1).to_bytes(32, "little") + sigs[1][32:]
        sigs[2] = (3).to_bytes(32, "little") + sigs[2][32:]
        sigs[3] = sigs[3][:63] + bytes([sigs[3][63] & 0x7F])
    return pubs, msgs, sigs


def _sr_staged(pubs, msgs, sigs, device):
    n = len(sigs)
    b = TK.bucket_size(n)
    _, safe, r, s, k = TS.stage_rows_sr(pubs, msgs, sigs, b)
    enc = np.frombuffer(b"".join(safe), dtype=np.uint8).reshape(n, 32)
    _, coords = TS.decompress_points(enc, device)
    return TK.staged_from_numpy(*TK.pad_coords_batch_minor(coords, b), r, s, k,
                                device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("n,valid", [(5, False), (130, False), (5, True), (130, True)])
def test_sr25519_kernels_match_plain_and_oracle(cuda, n, valid):
    """K2 and the ristretto decoder against their plain versions on
    tampered and all-valid batches; 5 and 130 signatures pad to 8 and 256
    lanes (zero encodings with zero scalars, which must verify valid)."""
    pubs, msgs, sigs = _sr_batch(n, tampered=not valid)
    t = _sr_staged(pubs, msgs, sigs, cuda)
    mask, allok = VK.verify_sr_ok(*t)
    pmask, pall = VK.verify_math_sr_ok(*t)
    assert torch.equal(mask, pmask) and bool(allok) == bool(pall) is valid
    assert VK.decode_err(VK.decompress_sr(t[4]), VK.decompress_sr_math(t[4])) == 0
    final, flips = TK.verify_rows(TS.SR25519, pubs, msgs, sigs,
                                  cache=TK.PubKeyCache(cuda, TS.SR25519))
    assert flips == 0
    assert final.tolist() == [srm.verify(p, m, s) for p, m, s in zip(pubs, msgs, sigs)]


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(MB.BODIES))
def test_microbench_loop_matches_plain(cuda, name):
    """K3 against its plain version for every registered body, on the
    probes' seeded state (130 lanes: a ragged second block) and on int32
    limbs anywhere in range, where sums and products wrap: limb bodies bit
    for bit, value bodies by canonical value (microbench.loop_err). A value
    body also takes the raw state at the edge of its domain, the largest
    limbs its plain version carries without wrapping; on the wide state the
    plain version takes its value mod p, which it carries without
    wrapping, where the kernel reads the raw limbs mod p."""
    body = MB.BODIES[name]
    value = body.body_id in MB.VALUE_BODIES
    rng = np.random.default_rng(7)
    wide = rng.integers(-2**31, 2**31, size=(body.n_state, 20, 130)).astype(np.int32)
    cases = [(MB.probe_state(body.n_state, 130), None),
             (wide, MB.state_mod_p(wide) if value else None)]
    if value:
        cases.append((MB.value_edge_state(name, 130), None))
    for state, plain_state in cases:
        s = torch.from_numpy(state).to(cuda)
        plain_in = torch.from_numpy(state if plain_state is None else plain_state)
        for iters in (0, 1, 7):
            got = MB.loop(name, s, iters)
            assert MB.loop_err(name, got.cpu(), MB.loop_plain(name, plain_in, iters)) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(MB.BODIES))
def test_microbench_launch_shape_is_one_wave(cuda, name):
    """Every K3 body launches one wave at the probes' lane counts, whole
    warps a block (four threads a lane for the quad bodies), with no local
    memory."""
    for lanes in (128, 130, 10_240):
        shape = MB.launch_shape(name, lanes, cuda)
        per_lane = 4 if MB.BODIES[name].body_id in (MB.DOUBLE, MB.DOUBLE_NO_T, MB.DBL5) else 1
        assert shape["waves"] == 1 and shape["threads_per_block"] % 32 == 0
        assert shape["threads_per_block"] == per_lane * shape["lanes_per_block"]
        assert shape["local_bytes"] == 0


@pytest.mark.cuda
def test_microbench_stacked_matches_plain(cuda):
    rng = np.random.default_rng(8)
    a, b = (torch.from_numpy(rng.integers(0, 8000, size=(4, 20, 130)).astype(np.int32))
            for _ in range(2))
    for iters in (1, 7):
        got = MB.stacked(a.to(cuda), b.to(cuda), iters)
        assert torch.equal(got.cpu(), MB.stacked_plain(a, b, iters))


@pytest.mark.cuda
@pytest.mark.parametrize("n_windows,stages", [(0, "full"), (26, "full"), (2, "nodecomp")])
def test_verify_bench_matches_plain(cuda, n_windows, stages):
    """The bench instantiation against verify_math_bench on a signed batch;
    with the default knobs it is the production kernel's mask."""
    pubs, msgs, sigs = _batch(130)
    b = TK.bucket_size(130)
    _, safe, r, s, k = TK.stage_batch(pubs, msgs, sigs, b)
    enc = np.frombuffer(b"".join(safe), dtype=np.uint8).reshape(130, 32)
    _, coords = TK.decompress_points(enc, cuda)
    t = TK.staged_from_numpy(*TK.pad_coords_batch_minor(coords, b), r, s, k, device=cuda)
    mask, allok = VK.verify_bench(*t, n_windows=n_windows, stages=stages)
    pmask, pall = VK.verify_math_bench(*t, n_windows=n_windows, stages=stages)
    assert torch.equal(mask, pmask) and bool(allok) == bool(pall)
    if n_windows == 0 and stages == "full":
        assert torch.equal(mask, VK.verify_ok(*t)[0])


def _edge_batch(name: str, n: int):
    """chip_smoke.py's batch of n signatures whose first lanes are the edge
    cases (ed25519: ZIP-215 encodings, torsion components, y = p and
    y = p + 1 as R and A; sr25519: with the lane whose check lands on a
    multiple of p), with the scheme's path and the oracle's verdicts."""
    import chip_smoke as CS

    path = CS._paths()[name]
    pubs, msgs, sigs = path.make_commit(n, CS.SEED_CHECK + n)
    want = path.edge_lanes(pubs, msgs, sigs)
    return path, (pubs, msgs, sigs), want


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["ed25519", "sr25519"])
@pytest.mark.parametrize("n", [128, 256, 10_240])
def test_edge_lanes_match_plain(cuda, name, n):
    """K1 / K2 against their plain versions on the edge lanes, at 128 lanes,
    the 150 commit's bucket (256) and a full commit (10,240); then the
    verify path's mask, with 0 host-recheck flips, against the oracle's."""
    import chip_smoke as CS

    path, rows, want = _edge_batch(name, n)
    t = CS.staged(path, *rows, cuda)
    mask, allok = path.verify(*t)
    pmask, pall = path.verify_plain(*t)
    assert torch.equal(mask, pmask) and bool(allok) == bool(pall) is False
    final, flips = TK.verify_rows(path.scheme, *rows, cache=TK.PubKeyCache(cuda, path.scheme))
    assert flips == 0 and final[: len(want)].tolist() == want


@pytest.mark.cuda
@pytest.mark.parametrize("n_windows,stages", [(26, "full"), (0, "nodecomp"), (51, "full")])
def test_verify_bench_matches_plain_on_edge_lanes(cuda, n_windows, stages):
    import chip_smoke as CS

    path, rows, _ = _edge_batch("ed25519", 128)
    t = CS.staged(path, *rows, cuda)
    mask, allok = VK.verify_bench(*t, n_windows=n_windows, stages=stages)
    pmask, pall = VK.verify_math_bench(*t, n_windows=n_windows, stages=stages)
    assert torch.equal(mask, pmask) and bool(allok) == bool(pall)


@pytest.mark.cuda
@pytest.mark.parametrize("n_windows,stages", [(0, "full"), (26, "full"), (0, "nodecomp")])
def test_verify_bench_matches_plain_on_probe_inputs(cuda, n_windows, stages):
    """The stage bisection's shape, inputs and knobs at 256 lanes."""
    from cometbft_tpu_torch.ops import microbench as MB

    t = MB.bench_verify_inputs(256, cuda)
    mask, allok = VK.verify_bench(*t, n_windows=n_windows, stages=stages)
    pmask, pall = VK.verify_math_bench(*t, n_windows=n_windows, stages=stages)
    assert torch.equal(mask, pmask) and bool(allok) == bool(pall)


@pytest.mark.cuda
def test_launch_shape_is_one_wave(cuda):
    for entry in ("ed25519_verify", "sr25519_verify", "ed25519_verify_bench"):
        for n in (128, 256, 6_144, 10_240):
            shape = VK.launch_shape(entry, n, cuda)
            assert shape["waves"] == 1 and shape["threads_per_block"] == 4 * shape["sigs_per_block"]
            assert shape["local_bytes"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ["ed25519_decompress", "sr25519_decompress"])
def test_decoder_launch_shape_is_one_wave(cuda, entry):
    for n in (128, 256, 6_144, 10_240):
        shape = VK.launch_shape(entry, n, cuda)
        assert shape["waves"] == 1 and shape["threads_per_block"] == shape["keys_per_block"]
        assert shape["threads_per_block"] % 32 == 0 and shape["local_bytes"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["ed25519", "sr25519"])
@pytest.mark.parametrize("n", [128, 256, 5_120, 10_240])
def test_decoders_match_plain_on_edge_lanes(cuda, name, n):
    """The decoder on chip_smoke.py's edge batch, its pubkeys and its R
    encodings at the bucket of n signatures: ok bit for bit, X, Y, Z, T by
    canonical value on every lane, the limbs canonical."""
    import chip_smoke as CS

    path, (pubs, _, sigs), _ = _edge_batch(name, n)
    b = TK.bucket_size(n)
    for encs in (pubs, [s[:32] for s in sigs]):
        words = TK._words_to_device(CS.encoding_words(encs, b, path.scheme.id_enc).T, cuda)
        got = path.decompress(words)
        assert VK.decode_err(got, path.decompress_plain(words)) == 0
        assert not bool(got[0][: len(encs)].all())
        for c in got[1:]:
            assert int(c[:19].min()) >= 0 and int(c[:19].max()) <= 8191
            assert int(c[19].min()) >= 0 and int(c[19].max()) < 256
