"""The port's consensus WAL (consensus/wal.py over libs/autofile), held
against the JAX package's on the CPU.

- a single-validator chain run with a WAL and consensus metrics in each
  package, both packages' clocks on one stepping clock: the same WAL files,
  byte for byte, and the same metrics exposition;
- each package decodes the other's WAL, and the same message sequence
  written through either into a group of small chunks gives the same
  files (autofile heads, chunk names and the CRC framing);
- a torn tail is truncated the same way, mid-group damage raises the same
  typed error and `repair()` leaves the same files;
- EndHeight search and the catch-up replay's selection agree.
"""

from __future__ import annotations

import asyncio
import os
import shutil

import pytest

from cometbft_tpu.consensus import wal as jwal
from cometbft_tpu_torch.consensus import wal as twal
from tests.test_torch_consensus import run_chain_with_wal as _run_chain
from tests.test_torch_consensus import stepping_clocks
from tests.torch_consumers import fresh_backends


@pytest.fixture(autouse=True)
def _fresh():
    yield from fresh_backends()


def _files(d: str) -> dict[str, bytes]:
    return {n: open(os.path.join(d, n), "rb").read() for n in sorted(os.listdir(d))}


def test_chain_wal_and_metrics_are_byte_equal_to_the_reference_s(tmp_path):
    out = {}
    for side in ("jax", "port"):
        with stepping_clocks():
            out[side] = asyncio.run(_run_chain(side, 3, str(tmp_path / side / "wal")))
    jfiles, tfiles = _files(str(tmp_path / "jax")), _files(str(tmp_path / "port"))
    assert out["jax"][0] == out["port"][0]
    assert "cometbft_consensus_height 3" in out["port"][1]
    assert out["port"][1] == out["jax"][1]
    assert list(tfiles) == ["wal"] and len(tfiles["wal"]) > 1000
    assert tfiles == jfiles


@pytest.fixture(scope="module")
def chain_wal(tmp_path_factory):
    """A WAL the port wrote: 4 heights of one validator."""
    d = tmp_path_factory.mktemp("chain")
    gen = fresh_backends()
    next(gen)
    try:
        asyncio.run(_run_chain("port", 4, str(d / "wal")))
    finally:
        gen.close()
    return str(d / "wal")


def _records(mod, path) -> list[bytes]:
    w = mod.WAL(path)
    try:
        return [mod._encode_msg(m) for m in w.iter_records()]
    finally:
        w.close()


def test_each_package_decodes_the_other_s_wal(chain_wal, tmp_path):
    recs = _records(twal, chain_wal)
    assert _records(jwal, chain_wal) == recs
    kinds = {r.split(b'"t":"')[1].split(b'"')[0] for r in recs}
    assert kinds >= {b"v", b"p", b"bp", b"eh", b"to"}
    # the reference's decoding written back through either package: the
    # same rotated group of chunks
    msgs = {"jax": list(jwal.WAL(chain_wal).iter_records()),
            "port": list(twal.WAL(chain_wal).iter_records())}
    for side, mod in (("jax", jwal), ("port", twal)):
        w = mod.WAL(str(tmp_path / side / "wal"), chunk_size=2048)
        for i, msg in enumerate(msgs[side]):
            (w.write_sync if i % 5 == 0 else w.write)(msg)
        w.close()
    jfiles, tfiles = _files(str(tmp_path / "jax")), _files(str(tmp_path / "port"))
    assert len(tfiles) > 3 and "wal.000" in tfiles
    assert tfiles == jfiles
    assert _records(jwal, str(tmp_path / "port" / "wal")) == recs


@pytest.mark.parametrize("tear", ["half_header", "half_body", "crc", "zero_header", "huge"])
def test_torn_tail_is_repaired_as_the_reference_does(chain_wal, tmp_path, tear):
    tail = open(chain_wal, "rb").read()[-40:]
    out = {}
    for side, mod in (("jax", jwal), ("port", twal)):
        d = tmp_path / side
        d.mkdir()
        path = str(d / "wal")
        shutil.copyfile(chain_wal, path)
        with open(path, "ab") as f:
            if tear == "half_header":
                f.write(b"\x00\x01\x02")
            elif tear == "half_body":
                f.write(b"\x12\x34\x56\x78\x00\x00\x00\x40" + tail[:20])
            elif tear == "crc":
                f.write(b"\x00\x00\x00\x00\x00\x00\x00\x08" + b"12345678")
            elif tear == "zero_header":
                f.write(bytes(8) + tail)
            else:
                f.write(b"\x00\x00\x00\x00\x7f\x00\x00\x00" + tail)
        n = len(_records(mod, path))
        out[side] = (n, open(path, "rb").read())
    assert out["port"] == out["jax"]
    assert out["port"][1] == open(chain_wal, "rb").read()


def _chunked(mod, src: str, dst: str) -> None:
    w = mod.WAL(dst, chunk_size=1500)
    for msg in mod.WAL(src).iter_records():
        w.write(msg)
    w.close()


def test_mid_group_damage_raises_and_repairs_as_the_reference_does(chain_wal, tmp_path):
    out = {}
    for side, mod in (("jax", jwal), ("port", twal)):
        d = tmp_path / side
        path = str(d / "wal")
        _chunked(mod, chain_wal, path)
        chunk = path + ".001"
        data = bytearray(open(chunk, "rb").read())
        data[len(data) - 30] ^= 0xFF
        open(chunk, "wb").write(bytes(data))
        with pytest.raises(mod.WALCorruptionError) as e:
            _records(mod, path)
        err = (os.path.basename(e.value.chunk), e.value.offset, e.value.detail,
               str(e.value).replace(str(d), "<d>"))
        w = mod.WAL(path)
        rep = w.repair()
        w.close()
        out[side] = (err, os.path.basename(rep.corrupt_chunk), rep.offset, rep.truncated_bytes,
                     [os.path.basename(q) for q in rep.quarantined], _files(str(d)),
                     len(_records(mod, path)))
    assert out["port"][0][1] > 0 and out["port"][4]
    assert out["port"] == out["jax"]


def test_end_height_search_and_replay_are_the_reference_s(chain_wal):
    got = {}
    for side, mod in (("jax", jwal), ("port", twal)):
        w = mod.WAL(chain_wal)
        try:
            got[side] = [(h, w.search_for_end_height(h),
                          [mod._encode_msg(m) for m in w.replay_after_height(h)])
                         for h in range(-1, 7)]
        finally:
            w.close()
    assert [g[1] for g in got["port"]] == [False, False, True, True, True, True, False, False]
    assert got["port"][3][2]
    assert got["port"] == got["jax"]
