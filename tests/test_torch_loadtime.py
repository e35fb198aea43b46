"""The port's loadtime.py against the JAX package's: the stamped payload
(the same bytes for the same clock and padding), its round trip, the
report's statistics over the same blocks, the saturation generator's and
the rate-shaped generator's counts with a fake submitter, and how an RPC
answer is classified (accepted, shed, rejected, transport error).
"""

from __future__ import annotations

import asyncio
import io
import json
import types

import numpy as np
import pytest

from cometbft_tpu import loadtime as jlt
from cometbft_tpu_torch import loadtime as tlt

MODS = {"j": jlt, "t": tlt}


def _pin(monkeypatch, mod, seed: int) -> None:
    """A stepping clock and seeded padding in `mod`."""
    clock = iter(range(1_700_000_000_000_000_000, 1 << 62, 1_234_567))
    rng = np.random.default_rng(seed)
    monkeypatch.setattr(mod.time, "time_ns", lambda: next(clock))
    monkeypatch.setattr(mod.secrets, "token_hex",
                        lambda n: rng.integers(0, 256, n, dtype=np.uint8).tobytes().hex())


@pytest.mark.parametrize("size", [16, 100, 256, 1000])
def test_payload_is_the_reference_s_and_round_trips(size, monkeypatch):
    txs = {}
    for s, mod in MODS.items():
        _pin(monkeypatch, mod, size)
        txs[s] = [mod.make_tx("exp-1", seq, size, 50.0, 2) for seq in range(5)]
    assert txs["t"] == txs["j"]
    for tx in txs["t"]:
        assert len(tx) >= size and tx.startswith(tlt.PREFIX)
        doc = tlt.parse_tx(tx)
        assert doc == jlt.parse_tx(tx)
        assert doc["id"] == "exp-1" and doc["size"] == size and doc["conns"] == 2
    for junk in (b"", b"k=v", tlt.PREFIX + b"{not json", tlt.PREFIX + b"{}/x"):
        assert tlt.parse_tx(junk) == jlt.parse_tx(junk)


def _blocks(seed: int):
    rng = np.random.default_rng(seed)
    out = []
    for h in range(12):
        t_block = 1_700_000_000 * 10**9 + h * 700_000_000
        txs = [b"plain=%d" % h]
        for j in range(int(rng.integers(0, 6))):
            exp = "a" if j % 3 else "b"
            lat = int(rng.integers(-50_000_000, 3_000_000_000))
            doc = {"id": exp, "seq": h * 10 + j, "time_ns": t_block - lat, "rate": 5,
                   "conns": 1, "size": 64}
            txs.append(tlt.PREFIX + json.dumps(doc, separators=(",", ":")).encode() + b"/00")
        out.append((t_block, txs))
    return out


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_report_statistics_are_the_reference_s(seed):
    blocks = _blocks(seed)
    got = {s: {k: (r.txs, r.negative, r.stats()) for k, r in mod.report_from_blocks(blocks).items()}
           for s, mod in MODS.items()}
    assert got["t"] == got["j"] and got["t"]
    assert tlt.Report("none").stats() == jlt.Report("none").stats()


def test_blocks_from_store_walks_the_store_as_the_reference():
    blocks = _blocks(4)

    class Store:
        def base(self):
            return 3

        def height(self):
            return len(blocks)

        def load_block(self, h):
            if h == 5:
                return None  # pruned
            t, txs = blocks[h - 1]
            return types.SimpleNamespace(
                header=types.SimpleNamespace(time=types.SimpleNamespace(unix_ns=lambda t=t: t)),
                data=types.SimpleNamespace(txs=txs))

    for lo, hi in ((0, 0), (4, 9), (1, 100)):
        assert (list(tlt.blocks_from_store(Store(), lo, hi))
                == list(jlt.blocks_from_store(Store(), lo, hi)))


def test_saturation_counts_are_the_reference_s():
    async def run(mod):
        seen = []

        async def submit(tx):
            seq = mod.parse_tx(tx)["seq"]
            seen.append(seq)
            if seq % 7 == 3:
                raise OSError("connection reset")
            return seq % 5 != 0

        exp, res = await mod.generate_saturation(submit, waves=3, wave_size=20, size=64,
                                                 experiment_id="sat", max_inflight=4)
        return exp, (res.sent, res.accepted, res.rejected, res.errors), sorted(seen)

    got = {s: asyncio.run(run(mod)) for s, mod in MODS.items()}
    assert got["t"] == got["j"]
    assert got["t"][1] == (60, 41, 10, 9)


class _Resp(io.BytesIO):
    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


def _fake_urlopen(answers: list, calls: list):
    def urlopen(req, timeout=None):
        body = json.loads(req.data)
        calls.append(body["method"])
        ans = answers[(len(calls) - 1) % len(answers)]
        if isinstance(ans, Exception):
            raise ans
        return _Resp(json.dumps(ans).encode())

    return urlopen


ANSWERS = [{"jsonrpc": "2.0", "id": 1, "result": {"code": 0, "hash": "AB"}},
           {"jsonrpc": "2.0", "id": 1, "result": {"code": 7, "log": "bad tx"}},
           {"jsonrpc": "2.0", "id": 1, "error": {
               "code": -32005, "message": "overloaded",
               "data": {"plane": "mempool", "retry_after_ms": 50}}},
           OSError("connection refused")]


def test_rpc_answers_are_classified_as_the_reference(monkeypatch):
    got = {}
    for s, mod in MODS.items():
        calls: list = []
        monkeypatch.setattr(mod.urllib.request, "urlopen", _fake_urlopen(ANSWERS, calls))
        submit = mod.rpc_submitter("http://127.0.0.1:1")
        out = []
        for _ in ANSWERS:
            try:
                out.append(asyncio.run(submit(b"tx")))
            except OSError as e:
                out.append(type(e).__name__)
        got[s] = (out, calls)
    assert got["t"] == got["j"]
    assert got["t"][0] == [True, False, False, "OSError"]
    assert set(got["t"][1]) == {"broadcast_tx_sync"}


def test_rate_shaped_load_counts_as_the_reference(monkeypatch):
    """50 tx/s for 0.6 s against a fake endpoint: about rate x duration
    sends, classified as the answers say, one method throughout."""
    got = {}
    for s, mod in MODS.items():
        calls: list = []
        monkeypatch.setattr(mod.urllib.request, "urlopen", _fake_urlopen(ANSWERS, calls))
        exp, res = asyncio.run(mod.generate_load(["http://127.0.0.1:1", "http://127.0.0.1:2"],
                                                 rate=50.0, duration=0.6, size=128,
                                                 experiment_id="rate",
                                                 method="broadcast_tx_sync"))
        assert exp == "rate" and res.sent == len(calls)
        assert 10 <= res.sent <= 32
        assert res.accepted + res.rejected + res.errors == res.sent
        assert res.accepted >= res.sent // 4 and res.errors >= 1
        got[s] = set(calls)
    assert got["t"] == got["j"] == {"broadcast_tx_sync"}
    with pytest.raises(ValueError):
        asyncio.run(tlt.generate_load([], 1.0, 0.1))
