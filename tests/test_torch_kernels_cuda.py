"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Imports only the port (the card's machine has no JAX); without a
GPU every test here skips. Run on the card with

    pytest -m cuda tests/test_torch_kernels_cuda.py

All arithmetic is integer: equality is exact. The decoders' X, Y, Z, T are
canonical limbs and the plain version's carried ones, so they are compared
by canonical value (verify_kernel.decode_err), ok bit for bit.
"""

from __future__ import annotations

import hashlib

import numpy as np
import pytest
import torch

from cometbft_tpu_torch.crypto import ed25519 as ted
from cometbft_tpu_torch.crypto import ed25519_math as oracle
from cometbft_tpu_torch.crypto import sr25519 as tsr
from cometbft_tpu_torch.crypto import sr25519_math as srm
from cometbft_tpu_torch.libs.prefixrows import SharedPrefixRows
from cometbft_tpu_torch.ops import challenge as CH
from cometbft_tpu_torch.ops import ed25519_kernel as TK
from cometbft_tpu_torch.ops import integrity as IN
from cometbft_tpu_torch.ops import microbench as MB
from cometbft_tpu_torch.ops import residency as TR
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


# ------------------------------------------- K5 (challenge) and K6 (integrity)

def _k5_inputs(b: int, var: int, seed: int, device, rows: int = CH.TABLE_ROWS):
    """A random wire block, encoding plane and prefix table of b lanes, every
    third lane left to the host, the rest over `rows` table rows."""
    rng = np.random.default_rng(seed)
    block = rng.integers(0, 2**32, size=CH.block_words(b, var), dtype=np.uint64).astype(np.uint32)
    desc = (rng.integers(0, rows, size=b) | 0x8000).astype(np.uint16)
    desc[::3] &= 0x7FFF
    block[16 * b:].view(np.uint8)[:2 * b] = desc.view(np.uint8)
    aw = rng.integers(0, 2**32, size=(8, b), dtype=np.uint64).astype(np.uint32)
    ptab = rng.integers(0, 256, size=(CH.TABLE_ROWS, CH.PREFIX_CAP), dtype=np.uint8)
    return (torch.from_numpy(block.view(np.int32)).to(device),
            torch.from_numpy(aw.view(np.int32)).to(device), torch.from_numpy(ptab).to(device))


@pytest.mark.cuda
@pytest.mark.parametrize("b", [8, 256, 6144, 10240])
@pytest.mark.parametrize("geom", [(95, 13, 14), (20, 13, 14), (20, 13, 15), (100, 24, 52),
                                  (0, 0, 0)], ids=lambda g: "plen%d-var%d-tlen%d" % g)
def test_challenge_derive_matches_plain(cuda, b, geom):
    plen, var, tlen = geom
    flat, aw, ptab = _k5_inputs(b, var, b + plen + var, cuda)
    fidx = torch.tensor([0, b - 1, b - 1], dtype=torch.int32, device=cuda)
    fkw = torch.randint(-2**31, 2**31, (8, 3), dtype=torch.int32, device=cuda)
    fkw[:, 2] = fkw[:, 1]  # a padded fallback repeats its last lane
    got = CH.derive(flat, aw, ptab, b, var, plen, tlen, fkw, fidx)
    want = CH.derive(flat.cpu(), aw.cpu(), ptab.cpu(), b, var, plen, tlen, fkw.cpu(), fidx.cpu())
    assert torch.equal(got.cpu(), want)


# the variable bytes across 0-3 word boundaries (and the first block's end),
# 1-3 SHA-512 blocks, var = 0, odd var (source offsets that differ by lane)
K5_GEOMETRIES = [(95, 13, 14), (20, 13, 15), (100, 24, 52), (0, 0, 0), (100, 0, 20),
                 (0, 8, 5), (3, 5, 9), (5, 6, 10), (7, 24, 30), (60, 13, 20), (103, 24, 50)]


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 255, 256, 6144, 10240])
@pytest.mark.parametrize("geom", K5_GEOMETRIES, ids=lambda g: "plen%d-var%d-tlen%d" % g)
def test_challenge_derive_matches_plain_over_16_rows(cuda, b, geom):
    """K5 bit for bit against the plain version, lanes over 16 rows."""
    plen, var, tlen = geom
    flat, aw, ptab = _k5_inputs(b, var, 7 * b + plen + var, cuda, rows=16)
    want = CH.derive_plain(flat, aw, ptab, b, var, plen, tlen)
    assert torch.equal(CH.derive(flat, aw, ptab, b, var, plen, tlen), want)


@pytest.mark.cuda
def test_challenge_standalone_entries_match_hashlib(cuda):
    rng = np.random.default_rng(2)
    for ln in (0, 111, 112, 186, 239, 240):
        rows = rng.integers(0, 256, size=(300, ln), dtype=np.uint8)
        got = CH.sha512_rows_device(rows, cuda)
        assert [r.tobytes() for r in got] == [hashlib.sha512(r.tobytes()).digest() for r in rows]
        k = CH.reduce512_mod_l_device(got, cuda)
        np.testing.assert_array_equal(k, CH.reduce512_mod_l_device(got, "cpu"))


def _raw_mask(b: int, bad: list[int], device):
    """A verify kernel's raw verdicts: (b,) int32 mask, 1 valid (some lanes
    another non-zero word), and its (1,) int32 all-ok."""
    mask = torch.ones(b, dtype=torch.int32, device=device)
    mask[::5] = 3
    mask[bad] = 0
    return mask, (mask != 0).all().to(torch.int32).reshape(1)


@pytest.mark.cuda
@pytest.mark.parametrize("narrs", [1, 3])
@pytest.mark.parametrize("case", ["happy", "failed", "mismatch"])
def test_integrity_parts_matches_plain(cuda, narrs, case):
    b = 10240
    flat, aw, _ = _k5_inputs(b, 13, 5, cuda)
    arrs = (flat,) if narrs == 1 else (flat, aw, aw[3].contiguous())
    mask, allok = _raw_mask(b, [7, b - 1] if case == "failed" else [], cuda)
    expected = IN.host_checksum(*(a.cpu().numpy() for a in arrs)) ^ (case == "mismatch")
    for overlap in (False, True):
        got = IN.integrity_parts(mask, allok, expected, *arrs, overlap=overlap)
        want = IN.parts_plain(mask.cpu(), allok.cpu(), expected, *(a.cpu() for a in arrs))
        assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])
        verdict = TK.decode_header(got[0].cpu().numpy().view(np.uint32), expected)
        assert verdict == {"happy": "happy", "failed": "full", "mismatch": "chk_mismatch"}[case]
    assert IN.device_checksum(*arrs) == int(IN.checksum_plain(*(a.cpu() for a in arrs)))


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 6, 255, 10240])
def test_integrity_unaligned_arrays_and_odd_masks(cuda, b):
    """K6's 16-byte loads start at any 4-byte offset and stop at any length
    (scalar head and tail); a mask whose length is not a multiple of 4 takes
    the byte path."""
    flat, _, _ = _k5_inputs(max(b, 8), 13, 11, cuda)
    arrs = (flat[1:], flat[2:-3], flat[3:3 + b])
    mask, allok = _raw_mask(b, [b // 2], cuda)
    expected = IN.host_checksum(*(a.cpu().numpy() for a in arrs))
    got = IN.integrity_parts(mask, allok, expected, *arrs)
    want = IN.parts_plain(mask.cpu(), allok.cpu(), expected, *(a.cpu() for a in arrs))
    assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])


@pytest.mark.cuda
def test_integrity_pdl_waits_for_the_kernel_before_it(cuda):
    """K6 launched behind a slow kernel that writes the mask at its end (a
    2-GB row sum): with the programmatic launch it checksums early but
    reads the verdicts only after that kernel's grid is complete."""
    b = 10240
    flat, _, _ = _k5_inputs(b, 13, 17, cuda)
    expected = IN.host_checksum(flat.cpu().numpy())
    ones = torch.ones((b, 32768), dtype=torch.int32, device=cuda)
    ones[[3, b - 2]] = 0
    mask = torch.zeros(b, dtype=torch.int32, device=cuda)
    allok = torch.zeros(1, dtype=torch.int32, device=cuda)
    for _ in range(3):
        mask.zero_()
        torch.sum(ones, dim=1, dtype=torch.int32, out=mask)
        got = IN.integrity_parts(mask, allok, expected, flat, overlap=True)
        want = IN.parts_plain(mask.cpu(), allok.cpu(), expected, flat.cpu())
        assert torch.equal(got[1].cpu(), want[1]) and torch.equal(got[0].cpu(), want[0])
        assert int(got[1][:b].sum()) == b - 2


@pytest.mark.cuda
def test_integrity_scratch_is_zero_after_each_launch(cuda):
    """K6's launches on a stream share two scratch words that each launch's
    last block zeroes: launches in a row, programmatic or not, with and
    without a mask, give the plain version's results every time."""
    flat, aw, _ = _k5_inputs(6144, 13, 5, cuda)
    mask, allok = _raw_mask(6144, [9], cuda)
    expected = IN.host_checksum(flat.cpu().numpy())
    want = IN.parts_plain(mask.cpu(), allok.cpu(), expected, flat.cpu())
    chk = int(IN.checksum_plain(flat.cpu(), aw.cpu()))
    for i in range(3):
        got = IN.integrity_parts(mask, allok, expected, flat, overlap=bool(i % 2))
        assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])
        assert IN.device_checksum(flat, aw) == chk
    stream = torch.cuda.current_stream(cuda).cuda_stream
    assert IN._scratch_of(cuda, stream).tolist() == [0, 0]


def _staged_batch(n: int, bad: list[int], device, seed: bytes):
    """An ed25519 batch of n signatures (n a bucket: no padding lanes),
    lanes `bad` tampered, staged on the classic path: (A coords x4 on
    `device`, the host's (3, 8, n) r/s/k words, the expected mask)."""
    privs = [ted.gen_priv_key_from_secret(seed + b"-%d" % i) for i in range(n)]
    pubs = [p.pub_key().bytes_() for p in privs]
    msgs = [seed + b"-msg-%d" % i for i in range(n)]
    sigs = [p.sign(m) for p, m in zip(privs, msgs)]
    for i in bad:
        sigs[i] = sigs[i][:40] + bytes([sigs[i][40] ^ 1]) + sigs[i][41:]
    _, safe, r, s, k = TK.stage_batch(pubs, msgs, sigs, n)
    enc = np.frombuffer(b"".join(safe), dtype=np.uint8).reshape(n, 32)
    _, coords = TK.decompress_points(enc, device)
    staged = TK.staged_from_numpy(*TK.pad_coords_batch_minor(coords, n), r, s, k, device=device)
    want = np.ones(n, dtype=bool)
    want[bad] = False
    return staged[:4], np.stack([r, s, k]), want


@pytest.mark.cuda
def test_verify_to_header_race_back_to_back(cuda):
    """Many verifies in a row with no host sync: each uploads its r/s/k
    words, runs K1 (raw verdicts) and K6 (programmatic launch) on them,
    tampered and untampered batches alternating, with K6's checksum-only
    launches (the key-table uploads') interleaved. Only then does the host
    read: every header decodes to its own batch's verdict and every payload
    holds its own mask."""
    good = _staged_batch(64, [], cuda, b"race-good")
    bad = _staged_batch(64, [4, 31], cuda, b"race-bad")
    table_words = torch.from_numpy(np.arange(4096, dtype=np.int32)).to(cuda)
    table_chk = IN.host_checksum(table_words.cpu().numpy())
    runs = []
    for i in range(24):
        coords, words, want = (good, bad)[i % 2]
        block = torch.from_numpy(words.view(np.int32)).to(cuda)
        mask, allok = VK.verify_ok_raw(*coords, block[0], block[1], block[2])
        expected = IN.host_checksum(words)
        header, payload = IN.integrity_parts(mask, allok, expected, block[0], block[1], block[2],
                                             overlap=True)
        out = torch.empty(1, dtype=torch.int32, device=cuda)
        dev = table_words.device
        IN._launch(IN._arrays((table_words,), dev) + [None, None, 0, 0, out.data_ptr(), None],
                   dev, "integrity_checksum", False)
        runs.append((header, payload, out, expected, want))
    torch.cuda.synchronize(cuda)
    for i, (header, payload, out, expected, want) in enumerate(runs):
        verdict = TK.decode_header(header.cpu().numpy().view(np.uint32), expected)
        assert verdict == ("happy" if i % 2 == 0 else "full"), i
        got, chk_ok, echo_ok = IN.decode_mask(payload.cpu().numpy())
        assert chk_ok and echo_ok and got.tolist() == want.tolist(), i
        assert int(out[0]) & 0xFFFFFFFF == table_chk, i


@pytest.mark.cuda
def test_verify_rows_race_with_key_table_uploads(cuda):
    """verify_rows on factored commits (K5, K1, K6), tampered and untampered
    alternating, with a new validator key each time (a key-table delta
    upload, K6's checksum-only launch, before each verify): every mask is
    the oracle's and every header verdict its batch's."""
    n = 40
    prefix = b"\x79\x08\x02" + bytes(range(92))
    rows = SharedPrefixRows(prefix, [b"\x2a\x0c" + i.to_bytes(8, "big") + b"\x01\x02"
                                     + b"\x32\x0bcosmoshub-4" for i in range(n)])
    msgs = rows.rows_for(range(n))
    cache = TK.PubKeyCache(cuda)
    for run in range(8):
        privs = [ted.gen_priv_key_from_secret(b"rk-%d" % i) for i in range(n - 1)]
        privs.append(ted.gen_priv_key_from_secret(b"rk-new-%d" % run))
        pubs = [p.pub_key().bytes_() for p in privs]
        sigs = [p.sign(rows[i]) for i, p in enumerate(privs)]
        if run % 2:
            sigs[run] = sigs[run][:33] + bytes([sigs[run][33] ^ 1]) + sigs[run][34:]
        TK.reset_fetch_stats()
        checks = IN.LAUNCHES["integrity_checksum"]
        got, flips = TK.verify_rows(TK.ED25519, pubs, msgs, sigs, cache=cache)
        assert IN.LAUNCHES["integrity_checksum"] > checks
        assert flips == 0 and [i for i in range(n) if not got[i]] == ([run] if run % 2 else [])
        assert TK.fetch_stats()["full_fetches" if run % 2 else "happy_fetches"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("b", [256, 6144, 10240])
def test_k5_k6_launch_shape_one_wave(cuda, b):
    for entry in ("challenge_derive", "challenge_sha512", "challenge_reduce"):
        shape = CH.launch_shape(entry, b, cuda)
        assert shape["waves"] == 1 and shape["local_bytes"] == 0, (entry, shape)
    shape = CH.launch_shape("challenge_derive", b, cuda)  # every SM busy
    assert shape["blocks"] >= min(b, shape["sms"]), shape
    shape = IN.launch_shape(CH.block_words(b, CH.MAX_VAR), cuda)
    assert shape["waves"] == 1 and shape["local_bytes"] == 0, shape
    assert shape["blocks"] <= shape["sms"], shape


@pytest.mark.cuda
def test_factored_commit_on_the_card_matches_cpu(cuda):
    """A factored 40-validator commit through verify_rows on the card (K5,
    K1, K6) and on the CPU (their plain versions): equal masks, k derived
    on the device for every lane."""
    n = 40
    privs = [ted.gen_priv_key_from_secret(b"fc-%d" % i) for i in range(n)]
    prefix = b"\x79\x08\x02" + bytes(range(92))
    rows = SharedPrefixRows(prefix, [b"\x2a\x0c" + i.to_bytes(8, "big") + b"\x01\x02"
                                     + b"\x32\x0bcosmoshub-4" for i in range(n)])
    msgs = rows.rows_for(range(n))
    pubs = [p.pub_key().bytes_() for p in privs]
    sigs = [p.sign(rows[i]) for i, p in enumerate(privs)]
    sigs[5] = sigs[5][:33] + bytes([sigs[5][33] ^ 1]) + sigs[5][34:]
    CH.reset_stats()
    got, flips = TK.verify_rows(TK.ED25519, pubs, msgs, sigs, cache=TK.PubKeyCache(cuda))
    assert CH.stats()["lanes_device"] == n
    want, _ = TK.verify_rows(TK.ED25519, pubs, msgs, sigs, cache=TK.PubKeyCache("cpu"))
    assert got.tolist() == want.tolist() and flips == 0
    assert [i for i in range(n) if not got[i]] == [5]


@pytest.mark.cuda
def test_key_table_overflow_on_the_card_keeps_k5(cuda):
    """A factored commit of 64 unique keys on a table of 63 key rows takes
    the full key path on the card, and K5 still derives every k: the mask
    equals the CPU's."""
    n = 64
    prefix = b"\x79\x08\x02" + bytes(range(92))
    rows = SharedPrefixRows(prefix, [b"\x2a\x0c" + i.to_bytes(8, "big") + b"\x01\x02"
                                     + b"\x32\x0bcosmoshub-4" for i in range(n)])
    privs = [ted.gen_priv_key_from_secret(b"ov-%d" % i) for i in range(n)]
    pubs = [p.pub_key().bytes_() for p in privs]
    sigs = [p.sign(rows[i]) for i, p in enumerate(privs)]
    sigs[9] = sigs[9][:33] + bytes([sigs[9][33] ^ 1]) + sigs[9][34:]
    msgs = rows.rows_for(range(n))
    TR.reset()
    CH.reset_stats()
    TR.configure(rows=64)
    try:
        derives = CH.LAUNCHES["challenge_derive"]
        got, _ = TK.verify_rows(TK.ED25519, pubs, msgs, sigs, cache=TK.PubKeyCache(cuda))
        assert CH.LAUNCHES["challenge_derive"] == derives + 1
        want, _ = TK.verify_rows(TK.ED25519, pubs, msgs, sigs, cache=TK.PubKeyCache("cpu"))
        sends = TR.send_stats()
    finally:
        TR.configure(rows=16384)
        TR.reset()
    assert CH.stats()["lanes_device"] == 2 * n
    assert sends["indexed"]["sigs"] == 0 and sends["full"]["sigs"] == 2 * n
    assert got.tolist() == want.tolist() and [i for i in range(n) if not got[i]] == [9]


# ------------------------------------------------- commit verification


def _commit_256(scheme: str, bad: tuple = ()):
    """A signed 256-validator commit (the port's types/): ed25519 or mixed
    (alternate keys ed25519 and sr25519), one NIL vote and one off-length
    timestamp, signatures at `bad` tampered."""
    from cometbft_tpu_torch.types import (BlockID, BlockIDFlag, Commit, CommitSig,
                                          PartSetHeader, Validator, ValidatorSet)
    from cometbft_tpu_torch.utils.cmttime import Timestamp

    n = 256
    privs = [(ted if scheme == "ed25519" or i % 2 == 0 else tsr).gen_priv_key_from_secret(
        b"commit-card-%d" % i) for i in range(n)]
    by_addr = {p.pub_key().address(): p for p in privs}
    vals = ValidatorSet([Validator.new(p.pub_key(), 10) for p in privs])
    h = hashlib.sha256(b"card block").digest()
    bid = BlockID(h, PartSetHeader(1, hashlib.sha256(h).digest()))
    sigs = [CommitSig(BlockIDFlag.NIL if i == 30 else BlockIDFlag.COMMIT, v.address,
                      Timestamp(1_700_000_000, 1000 if i == 7 else (1 << 28) + i))
            for i, v in enumerate(vals.validators)]
    commit = Commit(77, 0, bid, sigs)
    for i, (cs, v) in enumerate(zip(sigs, vals.validators)):
        cs.signature = by_addr[v.address].sign(commit.vote_sign_bytes("card-chain", i))
        if i in bad:
            cs.signature = cs.signature[:40] + bytes([cs.signature[40] ^ 1]) + cs.signature[41:]
    return vals, bid, commit


def _outcome(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the outcome is compared
        return type(e).__name__, str(e)
    return ("pass",)


@pytest.mark.cuda
@pytest.mark.parametrize("scheme", ["ed25519", "mixed"])
@pytest.mark.parametrize("bad", [(), (200,), (3, 250)])
def test_verify_commit_on_the_card_equals_the_cpu(cuda, scheme, bad):
    """verify_commit and the light checks of a 256-validator commit through
    the scheduler on the card give the CPU port's outcome: passing, or the
    same wrong-signature error."""
    from cometbft_tpu_torch import sched
    from cometbft_tpu_torch.crypto import batch as cb
    from cometbft_tpu_torch.types import validation as V

    vals, bid, commit = _commit_256(scheme, bad)
    calls = (lambda: V.verify_commit("card-chain", vals, bid, 77, commit),
             lambda: V.verify_commit_light("card-chain", vals, bid, 77, commit),
             lambda: V.verify_commit_light_trusting("card-chain", vals, commit,
                                                    V.Fraction(1, 3)))
    try:
        got = []
        for backend in ("gpu", "cpu"):
            sched.reset()
            cb.set_backend(backend)
            got.append([_outcome(c) for c in calls])
    finally:
        cb.set_backend("gpu")
        sched.reset()
    assert got[0] == got[1]
    if bad:
        assert got[0][0][0] == "ErrInvalidCommitSignature"
        assert got[0][0][1].startswith(f"wrong signature (#{bad[0]})")
    else:
        assert got[0] == [("pass",)] * 3


@pytest.mark.cuda
def test_scheduler_launches_on_its_own_stream(cuda, monkeypatch):
    """Every launch of a verify_commit (K5, K1, K6) and of a deadline-worker
    flush goes to the scheduler's dispatch stream, not the default stream."""
    import threading

    from cometbft_tpu_torch import sched
    from cometbft_tpu_torch.crypto import batch as cb
    from cometbft_tpu_torch.ops import _build
    from cometbft_tpu_torch.ops import dispatch
    from cometbft_tpu_torch.types import validation as V

    vals, bid, commit = _commit_256("ed25519")
    seen: list[tuple[str, int]] = []
    raw = _build.raw_stream

    def recording(dev):
        handle = raw(dev)
        seen.append((threading.current_thread().name, handle))
        return handle

    verify_raw = TK.ED25519.verify_raw

    def recording_verify(*args):
        seen.append((threading.current_thread().name, torch.cuda.current_stream().cuda_stream))
        return verify_raw(*args)

    monkeypatch.setattr(_build, "raw_stream", recording)
    monkeypatch.setattr(TK, "ED25519", TK.ED25519._replace(verify_raw=recording_verify))
    cb.set_backend("gpu")
    sched.reset()
    try:
        V.verify_commit("card-chain", vals, bid, 77, commit)
        rows = [(v.pub_key, b"tx", bytes(64)) for v in vals.validators[:8]]
        futs = sched.get().submit(rows, klass=sched.MEMPOOL)
        assert [f.result(timeout=60) for f in futs] == [False] * 8
        stream = sched.get().stream()
        assert stream is dispatch.stream(cuda)
        assert stream.cuda_stream != torch.cuda.default_stream(cuda).cuda_stream
        assert {h for _, h in seen} == {stream.cuda_stream}
        assert {t for t, _ in seen} == {threading.main_thread().name, "verify-sched"}
    finally:
        sched.reset()


@pytest.mark.cuda
def test_scheduler_warmup_runs_the_ladder_on_the_card(cuda):
    """warmup() runs one valid batch at every rung up to its cap on the card
    (one verify launch each)."""
    from cometbft_tpu_torch import sched
    from cometbft_tpu_torch.crypto import batch as cb

    cb.set_backend("gpu")
    sched.reset()
    try:
        before = VK.LAUNCHES["ed25519_verify"]
        assert sched.get().warmup(256) == [8, 16, 32, 64, 128, 256]
        assert VK.LAUNCHES["ed25519_verify"] == before + 6
    finally:
        sched.reset()


# ------------------------------------------------------------- BLS12-381


class _BlsData:
    """Edge-case inputs for B1-B5 from the oracle (this module imports only
    the port)."""

    def __init__(self):
        import random

        from cometbft_tpu_torch.crypto import bls12381_math as o

        self.o, self.P, self.rng = o, o.BLS_P, random.Random(60)

    def points(self, g: int, n: int) -> list:
        o = self.o
        F = o._FpOps if g == 1 else o._Fp2Ops
        gen = o._ec_from_affine(o.BLS_G1 if g == 1 else o.BLS_G2)
        return [o._ec_affine(F, o._ec_mul(F, self.rng.randrange(1, o.BLS_R), gen))
                for _ in range(n)]

    def no_root_x(self, g: int):
        o, P = self.o, self.P
        while True:
            if g == 1:
                x = self.rng.randrange(P)
                if pow((x ** 3 + 4) % P, (P - 1) // 2, P) == P - 1:
                    return x
            else:
                x = (self.rng.randrange(P), self.rng.randrange(P))
                if not o.f2_legendre_is_square(o.f2_add(o.f2_mul(o.f2_sq(x), x), o._B2)):
                    return x


def _bls_inputs():
    """Edge lanes for B1: both sign bits, points on the curves outside G1/G2
    ((0, 2) of order 3; an SvdW image before cofactor clearing)."""
    H = _BlsData()
    g1 = H.points(1, 3)
    g1.append((g1[0][0], H.P - g1[0][1]))
    g2 = H.points(2, 3)
    g2.append((g2[0][0], H.o.f2_neg(g2[0][1])))
    off2 = H.o._svdw_map_fp2((3, 4), H.o._bls_setup()["svdw"])
    return H, g1 + [(0, 2)], g2 + [off2]


@pytest.mark.cuda
@pytest.mark.parametrize("g", [1, 2])
def test_bls_decompress_matches_plain(cuda, g):
    from cometbft_tpu_torch.ops import bls_launch as BL
    from cometbft_tpu_torch.ops.bls12381 import fp

    H, g1, g2 = _bls_inputs()
    if g == 1:
        encs = [H.o.bls_g1_compress(a) for a in g1]
        x = torch.from_numpy(fp.ints_to_limbs(
            [int.from_bytes(bytes([e[0] & 0x1F]) + e[1:], "big") for e in encs] +
            [H.no_root_x(1)]))
    else:
        encs = [H.o.bls_g2_compress(a) for a in g2]
        nx = H.no_root_x(2)
        x = torch.stack([torch.from_numpy(fp.ints_to_limbs(
            [int.from_bytes(e[48:], "big") for e in encs] + [nx[0]])),
            torch.from_numpy(fp.ints_to_limbs(
                [int.from_bytes(bytes([e[0] & 0x1F]) + e[1:48], "big") for e in encs] + [nx[1]]))])
    sign = torch.tensor([(e[0] >> 5) & 1 for e in encs] + [1], dtype=torch.int32)
    x, sign = x.to(cuda).contiguous(), sign.to(cuda)
    for check in (False, True):
        ok, xy = BL.decompress(g, x, sign, check)
        okp, xyp = BL.decompress_plain(g, x, sign, check)
        assert ok.tolist() == okp.tolist() == [1, 1, 1, 1, int(not check), 0]
        assert BL.values(xy) == BL.values(xyp)


def _bls_crossover(entry, cuda, past):
    """The fewest lanes at which `entry` launches as past(launch_shape)
    holds."""
    from cometbft_tpu_torch.ops import bls_launch as BL

    lo, hi = 1, 1 << 20
    while lo < hi:
        mid = (lo + hi) // 2
        if past(BL.launch_shape(entry, mid, cuda)):
            hi = mid
        else:
            lo = mid + 1
    return lo


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["trio", "lane"])
def test_bls_decompress_g2_trio_and_lane_match_plain(cuda, kernel):
    """B1 G2 on its trio kernel and its one-lane kernel, forced: the edge
    lanes (both signs, a point outside G2, no root), with and without the
    subgroup check (psi(P) == [x]P against the plain [r]P == O), and the
    same lanes repeated to the crossover's lane count."""
    from cometbft_tpu_torch.ops import bls_launch as BL
    from cometbft_tpu_torch.ops.bls12381 import fp

    H, _, g2 = _bls_inputs()
    encs = [H.o.bls_g2_compress(a) for a in g2]
    nx = H.no_root_x(2)
    x = torch.stack([torch.from_numpy(fp.ints_to_limbs(
        [int.from_bytes(e[48:], "big") for e in encs] + [nx[0]])),
        torch.from_numpy(fp.ints_to_limbs(
            [int.from_bytes(bytes([e[0] & 0x1F]) + e[1:48], "big") for e in encs] + [nx[1]]))])
    sign = torch.tensor([(e[0] >> 5) & 1 for e in encs] + [1], dtype=torch.int32)
    x, sign = x.to(cuda).contiguous(), sign.to(cuda)
    for check in (False, True):
        ok, xy = BL.decompress(2, x, sign, check, kernel=kernel)
        okp, xyp = BL.decompress_plain(2, x, sign, check)
        assert ok.tolist() == okp.tolist() == [1, 1, 1, 1, int(not check), 0]
        assert BL.values(xy) == BL.values(xyp)
    n = _bls_crossover("bls_decompress_g2", cuda, lambda s: s["lane_kernel"])
    assert BL.launch_shape("bls_decompress_g2", n - 1, cuda)["group_threads"] == 3
    assert BL.launch_shape("bls_decompress_g2", n, cuda)["group_threads"] == 1
    assert BL.launch_shape("bls_decompress_g2", 150, cuda, check_subgroup=False)["lane_kernel"]
    idx = torch.arange(n, device=cuda) % x.shape[-1]
    xs, ss = x[..., idx].contiguous(), sign[idx].contiguous()
    before = dict(BL.LAUNCHES)
    ok, xy = BL.decompress(2, xs, ss, True, kernel=kernel)
    assert BL.LAUNCHES[f"bls_decompress_g2_{kernel}"] == before[f"bls_decompress_g2_{kernel}"] + 1
    okp, xyp = BL.decompress_plain(2, xs, ss, True)
    assert ok.tolist() == okp.tolist()
    assert BL.values(xy) == BL.values(xyp)


@pytest.mark.cuda
def test_bls_miller_half_sextet_and_lane_match_plain(cuda):
    """B4 on its half-warp, sextet and one-pair kernels, each forced and as
    the crossovers pick them: 2 pairs, and the pair count of each crossover
    (the same pairs repeated), against the plain version."""
    from cometbft_tpu_torch.ops import bls_launch as BL

    H, g1, g2 = _bls_inputs()
    p = BL.planes_of_ints([[a[0] for a in g1[:3]], [a[1] for a in g1[:3]]], cuda)
    q = BL.planes_of_ints([[a[k][c] for a in g2[:3]] for k in (0, 1) for c in (0, 1)], cuda)
    n_half = _bls_crossover("bls_miller", cuda, lambda s: s["group_threads"] != 16)
    n = _bls_crossover("bls_miller", cuda, lambda s: s["lane_kernel"])
    assert BL.launch_shape("bls_miller", n_half - 1, cuda)["group_threads"] == 16
    assert BL.launch_shape("bls_miller", n_half, cuda)["group_threads"] == 6
    assert BL.launch_shape("bls_miller", n - 1, cuda)["group_threads"] == 6
    assert BL.launch_shape("bls_miller", n, cuda)["group_threads"] == 1
    for L in (2, n_half, n):
        idx = torch.arange(L, device=cuda) % 3
        pl, ql = p[:, idx].contiguous(), q[:, idx].contiguous()
        want = BL.values(BL.miller_plain(pl, ql))
        for kernel in (None, "half", "sextet", "lane"):
            assert BL.values(BL.miller(pl, ql, kernel=kernel)) == want


@pytest.mark.cuda
def test_bls_point_sum_g2_outside_g2(cuda):
    """B3 G2 with the subgroup check (the psi test on the sum) on a group of
    two G2 points and one of a G2 point and a twist point outside G2."""
    from cometbft_tpu_torch.ops import bls_launch as BL

    H, _, g2 = _bls_inputs()
    pts = g2[:2] + [g2[4]]  # two of G2, then the SvdW image outside it
    coords = [[a[k][c] for a in pts] for k in (0, 1) for c in (0, 1)]
    planes = BL.planes_of_ints(coords, cuda)
    order = torch.tensor([0, 1, 1, 2], dtype=torch.int32, device=cuda)
    starts = torch.tensor([0, 2, 4], dtype=torch.int32, device=cuda)
    got = BL.point_sum(2, planes, order, starts, True)
    want = BL.point_sum_plain(2, planes, order, starts, True)
    assert got[1].tolist() == want[1].tolist() == [0, 0]
    assert got[2].tolist() == want[2].tolist() == [1, 0]
    assert BL.values(got[0]) == BL.values(want[0])


def _g1_torsion(H):
    """Points of E(Fp) outside G1: (0, 2) of order 3, points of order 11,
    10177 and 859267 ([h1 r / l^2]R of random points R), [r]R, and each of
    those plus a G1 point; then two G1 points."""
    o, P = H.o, H.P
    F = o._FpOps
    h1 = 0x396c8c005555e1568c00aaab0000aaab

    def mul(k, a):
        return o._ec_affine(F, o._ec_mul(F, k, o._ec_from_affine(a)))

    def curve_point():
        while True:
            x = H.rng.randrange(P)
            t = (x ** 3 + 4) % P
            y = pow(t, (P + 1) // 4, P)
            if y * y % P == t:
                return x, y

    tors = [(0, 2)]
    for ell in (11, 10177, 859267):
        t = None
        while t is None:
            t = mul(h1 * o.BLS_R // (ell * ell), curve_point())
        assert mul(ell, t) is None
        tors.append(t)
    tors.append(mul(o.BLS_R, curve_point()))
    g1 = H.points(1, 2)
    mixed = [o._ec_affine(F, o._ec_add(F, o._ec_from_affine(t), o._ec_from_affine(g1[0])))
             for t in tors]
    return tors + mixed + g1


@pytest.mark.cuda
@pytest.mark.parametrize("n", [256, 0, 10_240])
def test_bls_decompress_g1_sigma_on_torsion_lanes(cuda, n):
    """B1 G1 with the subgroup check (sigma(P) == [-x^2]P) on its trio
    kernel and its one-lane kernel, forced and as the crossover picks, on
    points with components of order 3, 11, 10177 and 859267, [r]R, those
    plus a G1 point, and G1 points, repeated to n lanes (0: the crossover's
    lane count), against the plain version's [r]P == O."""
    from cometbft_tpu_torch.ops import bls_launch as BL
    from cometbft_tpu_torch.ops.bls12381 import fp

    if n == 0:
        n = _bls_crossover("bls_decompress_g1", cuda, lambda s: s["lane_kernel"])
        assert BL.launch_shape("bls_decompress_g1", n - 1, cuda)["group_threads"] == 3
        assert BL.launch_shape("bls_decompress_g1", n, cuda)["group_threads"] == 1
    H = _BlsData()
    affs = _g1_torsion(H)
    encs = [H.o.bls_g1_compress(a) for a in affs]
    idx = [k % len(encs) for k in range(n)]
    x = torch.from_numpy(fp.ints_to_limbs(
        [int.from_bytes(bytes([encs[k][0] & 0x1F]) + encs[k][1:], "big") for k in idx]))
    sign = torch.tensor([(encs[k][0] >> 5) & 1 for k in idx], dtype=torch.int32)
    x, sign = x.to(cuda).contiguous(), sign.to(cuda)
    okp, xyp = BL.decompress_plain(1, x, sign, True)
    want = [0] * (len(affs) - 2) + [1, 1]
    assert okp.tolist() == [want[k] for k in idx]
    for kernel in (None, "trio", "lane"):
        before = dict(BL.LAUNCHES)
        ok, xy = BL.decompress(1, x, sign, True, kernel=kernel)
        if kernel:
            key = f"bls_decompress_g1_{kernel}"
            assert BL.LAUNCHES[key] == before[key] + 1
        assert ok.tolist() == okp.tolist()
        assert BL.values(xy) == BL.values(xyp)


@pytest.mark.cuda
@pytest.mark.parametrize("g", [1, 2])
def test_bls_point_sum_one_group_split_matches_plain(cuda, g):
    """B3 on one group of 10,240 points (64 distinct ones repeated, so pairs
    P + P within a block and across blocks, a point and its negative in
    blocks far apart), split over blocks (phase 1 then phase 2) and forced
    to one block; and on small groups forced through both phases (slices
    with no point give identity partials); against the plain version."""
    from cometbft_tpu_torch.ops import bls_launch as BL

    H = _BlsData()
    o, P = H.o, H.P
    affs = H.points(g, 64)
    neg = (affs[0][0], P - affs[0][1]) if g == 1 else (affs[0][0], o.f2_neg(affs[0][1]))
    affs.append(neg)
    coords = ([[a[0] for a in affs], [a[1] for a in affs]] if g == 1 else
              [[a[k][c] for a in affs] for k in (0, 1) for c in (0, 1)])
    planes = BL.planes_of_ints(coords, cuda)
    n = 10_240
    big = [k % 64 for k in range(n)]
    big[n - 3] = 64  # -affs[0]: cancels big[0]
    order = torch.tensor(big, dtype=torch.int32, device=cuda)
    starts = torch.tensor([0, n], dtype=torch.int32, device=cuda)
    shape = BL.launch_shape(f"bls_point_sum_g{g}", 1, cuda, n)
    assert shape["slices"] > 1 and shape["part_blocks"] == shape["slices"]
    want = BL.point_sum_plain(g, planes, order, starts, True)
    assert want[1].tolist() == [0] and want[2].tolist() == [1]
    for kernel in (None, "short"):
        before = dict(BL.LAUNCHES)
        got = BL.point_sum(g, planes, order, starts, True, kernel=kernel)
        split = BL.LAUNCHES[f"bls_point_sum_g{g}_split"] - before[f"bls_point_sum_g{g}_split"]
        assert split == (kernel is None)
        assert got[1].tolist() == want[1].tolist() and got[2].tolist() == want[2].tolist()
        assert BL.values(got[0]) == BL.values(want[0])
    order = torch.tensor([0, 64, 1, 1, 2, 3, 4], dtype=torch.int32, device=cuda)
    starts = torch.tensor([0, 2, 4, 5, 7], dtype=torch.int32, device=cuda)
    want = BL.point_sum_plain(g, planes, order, starts, True)
    assert want[1].tolist() == [1, 0, 0, 0]
    for kernel in ("split", "short", None):
        got = BL.point_sum(g, planes, order, starts, True, kernel=kernel)
        assert got[1].tolist() == want[1].tolist() and got[2].tolist() == want[2].tolist()
        assert BL.values(got[0]) == BL.values(want[0])


@pytest.mark.cuda
def test_bls_hash_sum_miller_final_exp_match_plain(cuda):
    """B2 on three messages (the empty one among them), B3 on three groups
    with an identity sum, B4 and B5 on two checks (a product that is one and
    one that is not), by canonical value against the plain versions."""
    from cometbft_tpu_torch.crypto import bls12381 as tbls
    from cometbft_tpu_torch.ops import bls_launch as BL
    from cometbft_tpu_torch.ops.bls12381 import htc

    H, g1, _ = _bls_inputs()
    u = torch.from_numpy(np.stack(htc.hash_to_field_limbs([b"", b"a", b"b"], tbls.DST))).to(cuda)
    h, hid = BL.hash_to_g2(u)
    hp, hidp = BL.hash_to_g2_plain(u)
    assert hid.tolist() == hidp.tolist() == [0, 0, 0]
    assert BL.values(h) == BL.values(hp)
    pk = [g1[0], g1[3], g1[1], g1[2]]  # lanes 0 and 1 cancel
    coords = [[a[0] for a in pk], [a[1] for a in pk]]
    order = torch.tensor([0, 1, 2, 3], dtype=torch.int32, device=cuda)
    starts = torch.tensor([0, 2, 3, 4], dtype=torch.int32, device=cuda)
    planes = BL.planes_of_ints(coords, cuda)
    got = BL.point_sum(1, planes, order, starts, True)
    want = BL.point_sum_plain(1, planes, order, starts, True)
    assert got[1].tolist() == want[1].tolist() == [1, 0, 0]
    assert got[2].tolist() == want[2].tolist() == [1, 1, 1]
    assert BL.values(got[0]) == BL.values(want[0])
    # e(P, H) e(-P, H) = 1 and e(P, H) != 1
    p = [[g1[0][0]] * 2, [g1[0][1], H.P - g1[0][1]]]
    hv = [v[:1] * 2 for v in BL.values(h)]
    pq = BL.planes_of_ints(p, cuda), BL.planes_of_ints(hv, cuda)
    f = BL.miller(*pq)
    fp_ = BL.miller_plain(*pq)
    assert BL.values(f) == BL.values(fp_)
    lanes = torch.tensor([0, 1, 0], dtype=torch.int32, device=cuda)
    st = torch.tensor([0, 2, 3], dtype=torch.int32, device=cuda)
    ok, e, allok = BL.final_exp(f, lanes, st)
    okp, ep, allokp = BL.final_exp_plain(fp_, lanes, st)
    assert ok.tolist() == okp.tolist() == [1, 0] and allok.tolist() == allokp.tolist() == [0]
    assert BL.values(e) == BL.values(ep)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 10_240])
def test_bls_hash_to_g2_trios_match_plain(cuda, n):
    """B2 on one message (one trio of one warp) and on 10,240 (one message
    a thread), every lane by canonical value against the plain version."""
    from cometbft_tpu_torch.crypto import bls12381 as tbls
    from cometbft_tpu_torch.ops import bls_launch as BL
    from cometbft_tpu_torch.ops.bls12381 import htc

    msgs = [b"card-h2g-%d" % i for i in range(n)]
    u = torch.from_numpy(np.stack(htc.hash_to_field_limbs(msgs, tbls.DST))).to(cuda)
    h, hid = BL.hash_to_g2(u)
    hp, hidp = BL.hash_to_g2_plain(u)
    assert hid.tolist() == hidp.tolist() == [0] * n
    assert BL.values(h) == BL.values(hp)


@pytest.mark.cuda
def test_bls_final_exp_one_check_of_151_matches_plain(cuda):
    """B5 on one check of 151 seeded Fp12 values (ten trios, their strides
    and tree, then the final exponentiation on one trio), on 75 checks of 2
    of the same values (a trio a check) and on 6,144 checks of 2 (one check
    a thread), against the plain version."""
    from cometbft_tpu_torch.ops import bls_launch as BL

    rng = np.random.default_rng(61)
    w = rng.integers(0, 1 << 32, (144, 151), dtype=np.uint64).astype(np.uint32)
    w[11::12] &= 0x0FFFFFFF  # each value below p
    f = torch.from_numpy(w.view(np.int32)).to(cuda)
    lanes = torch.arange(151, dtype=torch.int32, device=cuda)
    for starts in ([0, 151], list(range(0, 151, 2))):
        st = torch.tensor(starts, dtype=torch.int32, device=cuda)
        got = BL.final_exp(f, lanes, st)
        want = BL.final_exp_plain(f, lanes, st)
        assert got[0].tolist() == want[0].tolist() == [0] * (len(starts) - 1)
        assert got[2].tolist() == want[2].tolist() == [0]
        assert BL.values(got[1]) == BL.values(want[1])
    w = rng.integers(0, 1 << 32, (144, 12_288), dtype=np.uint64).astype(np.uint32)
    w[11::12] &= 0x0FFFFFFF
    f = torch.from_numpy(w.view(np.int32)).to(cuda)
    lanes = torch.arange(12_288, dtype=torch.int32, device=cuda)
    st = torch.arange(0, 12_289, 2, dtype=torch.int32, device=cuda)
    assert BL.launch_shape("bls_final_exp", 6_144, cuda, 12_288)["lane_kernel"] == 1
    got = BL.final_exp(f, lanes, st)
    want = BL.final_exp_plain(f, lanes, st)
    assert got[0].tolist() == want[0].tolist() and got[2].tolist() == want[2].tolist()
    assert BL.values(got[1]) == BL.values(want[1])


@pytest.mark.cuda
def test_bls_verify_and_aggregate_on_the_card_match_oracle(cuda):
    """The whole device path: verify_batch's mask on the edge lanes and the
    aggregate check, against the oracle."""
    from cometbft_tpu_torch.crypto import bls12381 as tbls
    from cometbft_tpu_torch.crypto import bls12381_math as bo
    from cometbft_tpu_torch.ops import bls_kernel as BK

    keys = [tbls.gen_priv_key_from_secret(b"card-bls-%d" % i) for i in range(5)]
    msgs = [b"m-%d" % i for i in range(5)]
    pubs = [k.pub_key().bytes_() for k in keys]
    sigs = [k.sign(m) for k, m in zip(keys, msgs)]
    sigs[1] = keys[1].sign(b"wrong")
    sigs[2] = b"\x00" * 96
    sigs[3] = bytes([0xC0]) + bytes(95)
    want = [bo.bls_verify(p, m, s, tbls.DST) for p, m, s in zip(pubs, msgs, sigs)]
    assert BK.verify_batch(pubs, msgs, sigs, device=cuda)[1] == want
    good = [0, 4]
    ps, ms, ss = ([v[i] for i in good] for v in (pubs, msgs, sigs))
    assert BK.aggregate_verify(ps, ms, ss, device=cuda)
    assert not BK.aggregate_verify(ps, ms, [ss[0], sigs[1]], device=cuda)
    assert BK.aggregate_verify_agg(ps, ms, BK.aggregate_signatures(ss), device=cuda)
