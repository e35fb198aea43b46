"""The port's fuzzed connection (p2p/fuzz.py) against the JAX package's:
for the same seed the same drop, sleep and kill decisions on the writer and
the reader; delay mode never drops; and a port Transport with a delay-mode
fuzz_config completes the secret handshake with another over loopback TCP
and carries channel messages both ways.
"""

from __future__ import annotations

import asyncio

import pytest

from cometbft_tpu.p2p import fuzz as jfuzz
from cometbft_tpu_torch.crypto import ed25519 as ted
from cometbft_tpu_torch.p2p import fuzz as tfuzz
from cometbft_tpu_torch.p2p.key import NodeKey as TNodeKey
from cometbft_tpu_torch.p2p.node_info import NodeInfo as TNodeInfo
from cometbft_tpu_torch.p2p.transport import Transport as TTransport


class _Writer:
    """A stream writer that records what reaches it."""

    def __init__(self):
        self.writes: list[bytes] = []
        self.closed = 0

    def write(self, data: bytes) -> None:
        self.writes.append(data)

    def close(self) -> None:
        self.closed += 1

    async def drain(self) -> None:
        pass


class _Reader:
    async def readexactly(self, n: int) -> bytes:
        return b"\x00" * n

    async def read(self, n: int = -1) -> bytes:
        return b"r"

    async def readline(self) -> bytes:
        return b"l\n"


def _trace(mod, cfg_kw: dict, seed: int, n: int = 400) -> list:
    """What n writes and n reads did: per write (reached the stream, closes
    so far, the sleep queued for the next drain), per read the sleeps the
    reader took and the closes."""
    cfg = mod.FuzzConnConfig(arm_after=0.0, **cfg_kw)
    w = _Writer()
    reader, writer = mod.fuzz_streams(_Reader(), w, cfg, seed=seed)
    out = []
    for i in range(n):
        before = len(w.writes)
        writer.write(i.to_bytes(2, "big"))
        out.append(("w", len(w.writes) - before, w.closed, round(writer._pending_sleep, 12)))
        writer._pending_sleep = 0.0
    sleeps = []

    async def fake_sleep(s):
        sleeps.append(round(s, 12))

    async def reads():
        real = mod.asyncio.sleep
        mod.asyncio.sleep = fake_sleep
        try:
            for i in range(n):
                call = (lambda: reader.readexactly(3), reader.read, reader.readline)[i % 3]
                got = await call()
                out.append(("r", len(got), w.closed, len(sleeps)))
        finally:
            mod.asyncio.sleep = real

    asyncio.run(reads())
    return out + [("sleeps", tuple(sleeps))]


CONFIGS = {
    "drop": dict(mode="drop", prob_drop_rw=0.05, prob_drop_conn=0.02, prob_sleep=0.1,
                 max_delay=0.03),
    "delay": dict(mode="delay", prob_drop_rw=0.05, prob_drop_conn=0.02, prob_sleep=0.3,
                  max_delay=0.03),
    "defaults": {},
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("seed", [0, 1, 2021])
def test_fuzz_decisions_are_the_reference_s(name, seed):
    got = _trace(tfuzz, CONFIGS[name], seed)
    assert got == _trace(jfuzz, CONFIGS[name], seed)
    writes = [e for e in got if e[0] == "w"]
    if CONFIGS[name].get("mode") == "delay":
        # latency only: every write reaches the stream, nothing is closed
        assert all(e[1] == 1 for e in writes) and got[-2][2] == 0
        assert any(e[3] > 0 for e in writes) and got[-1][1]
    elif name == "drop":
        assert any(e[1] == 0 for e in writes) and got[-2][2] > 0


def test_fuzz_is_quiet_before_it_arms():
    for mod in (tfuzz, jfuzz):
        w = _Writer()
        _, writer = mod.fuzz_streams(_Reader(), w, mod.FuzzConnConfig(
            prob_drop_rw=1.0, arm_after=3600.0), seed=1)
        for i in range(50):
            writer.write(b"x")
        assert len(w.writes) == 50 and w.closed == 0


def test_fuzzed_transports_carry_messages_in_delay_mode():
    """Two port Transports, each fuzzing its raw streams in delay mode
    (armed from the first byte, a sleep on a third of the writes and
    reads), complete the secret handshake both ways and exchange
    messages intact."""
    cfg = tfuzz.FuzzConnConfig(mode="delay", prob_sleep=0.3, max_delay=0.005, arm_after=0.0)

    def side(i: int):
        key = TNodeKey(ted.gen_priv_key_from_secret(b"fuzz-%d" % i))
        return TTransport(key, TNodeInfo(node_id=key.id(), network="fuzz-chain"),
                          fuzz_config=cfg)

    async def run():
        a, b = side(0), side(1)
        assert a.fuzz_config is cfg
        addr = await b.listen("127.0.0.1:0")
        try:
            up = await a.dial(f"{b.node_key.id()}@{addr}")
            down = await asyncio.wait_for(b.accept(), 10.0)
            assert up.node_info.node_id == b.node_key.id()
            assert down.node_info.node_id == a.node_key.id()
            msgs = [bytes([i]) * (1 + 97 * i) for i in range(12)]
            for m in msgs:
                await up.conn.write_msg(m)
            assert [await down.conn.read_msg() for _ in msgs] == msgs
            for m in msgs:
                await down.conn.write_msg(m[::-1])
            assert [await up.conn.read_msg() for _ in msgs] == [m[::-1] for m in msgs]
            up.conn.close()
            down.conn.close()
        finally:
            a.close()
            b.close()

    asyncio.run(asyncio.wait_for(run(), 30.0))
