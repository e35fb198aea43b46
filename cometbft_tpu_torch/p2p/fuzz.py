"""Fuzzed connection wrappers: random drop / delay / kill on p2p streams.

Reference: p2p/fuzz.go:12-67 FuzzedConnection + config.FuzzConnConfig —
wraps the raw conn before the secret-connection upgrade, with fuzzing armed
only after a delay so handshakes complete. Semantics mapped from Go's
net.Conn to asyncio streams:

  - write drop (ProbDropRW): the bytes silently vanish from the stream —
    the peer sees broken framing or a stall and must take its error path;
  - conn drop (ProbDropConn): the transport is closed underneath;
  - sleep (ProbSleep): a uniform random delay up to max_delay;
  - read fuzzing is delay/kill only: an asyncio readexactly() cannot
    "return no data" the way Go's Read returns (0, nil) without breaking
    the stream API, and in Go a dropped read loses nothing anyway (the
    bytes stay in the kernel buffer) — the observable fault there is also
    just latency.

Armed per-connection via Transport(fuzz_config=...), config knobs on the
P2P section (test_fuzz*, config.go:739-740).

The port's copy of cometbft_tpu/p2p/fuzz.py (asyncio and the standard
library only): for the same seed, the same random.Random decisions.
"""

from __future__ import annotations

import asyncio
import random
import time
from dataclasses import dataclass


@dataclass
class FuzzConnConfig:
    """config.go FuzzConnConfig. mode="drop" is the reference FuzzModeDrop
    (drops + conn kills + delays); mode="delay" is FuzzModeDelay — latency
    only, the soak profile that must NEVER cost liveness."""

    mode: str = "drop"  # "drop" | "delay"
    prob_drop_rw: float = 0.01
    prob_drop_conn: float = 0.003
    prob_sleep: float = 0.01
    max_delay: float = 0.05  # seconds
    arm_after: float = 3.0   # handshake grace (transport.go:223 uses 10 s)

    def drops_enabled(self) -> bool:
        return self.mode != "delay"


class _FuzzState:
    """Shared between the reader and writer of one connection."""

    def __init__(self, cfg: FuzzConnConfig, writer: asyncio.StreamWriter,
                 rng: random.Random):
        self.cfg = cfg
        self.writer = writer
        self.rng = rng
        self.armed_at = time.monotonic() + cfg.arm_after

    def active(self) -> bool:
        return time.monotonic() >= self.armed_at

    def kill(self) -> None:
        try:
            self.writer.close()
        except Exception:  # noqa: BLE001
            pass


class FuzzedWriter:
    def __init__(self, writer: asyncio.StreamWriter, state: _FuzzState):
        self._writer = writer
        self._state = state
        self._pending_sleep = 0.0

    def write(self, data: bytes) -> None:
        st = self._state
        if st.active():
            r = st.rng.random()
            cfg = st.cfg
            if cfg.drops_enabled():
                if r <= cfg.prob_drop_rw:
                    return  # bytes vanish
                if r < cfg.prob_drop_rw + cfg.prob_drop_conn:
                    st.kill()
                    return
            if r < cfg.prob_drop_rw + cfg.prob_drop_conn + cfg.prob_sleep:
                # write() is sync; the delay lands in the next drain()
                self._pending_sleep = st.rng.uniform(0, cfg.max_delay)
        self._writer.write(data)

    async def drain(self) -> None:
        if self._pending_sleep:
            delay, self._pending_sleep = self._pending_sleep, 0.0
            await asyncio.sleep(delay)
        await self._writer.drain()

    def __getattr__(self, name):
        return getattr(self._writer, name)


class FuzzedReader:
    def __init__(self, reader: asyncio.StreamReader, state: _FuzzState):
        self._reader = reader
        self._state = state

    async def _maybe_fuzz(self) -> None:
        st = self._state
        if not st.active():
            return
        r = st.rng.random()
        cfg = st.cfg
        if cfg.drops_enabled() and r < cfg.prob_drop_conn:
            st.kill()
        elif r < cfg.prob_drop_conn + cfg.prob_sleep:
            await asyncio.sleep(st.rng.uniform(0, cfg.max_delay))

    async def readexactly(self, n: int) -> bytes:
        await self._maybe_fuzz()
        return await self._reader.readexactly(n)

    async def read(self, n: int = -1) -> bytes:
        await self._maybe_fuzz()
        return await self._reader.read(n)

    async def readline(self) -> bytes:
        await self._maybe_fuzz()
        return await self._reader.readline()

    def __getattr__(self, name):
        return getattr(self._reader, name)


def fuzz_streams(
    reader: asyncio.StreamReader,
    writer: asyncio.StreamWriter,
    cfg: FuzzConnConfig | None = None,
    seed: int | None = None,
) -> tuple[FuzzedReader, FuzzedWriter]:
    cfg = cfg or FuzzConnConfig()
    state = _FuzzState(cfg, writer, random.Random(seed))
    return FuzzedReader(reader, state), FuzzedWriter(writer, state)
