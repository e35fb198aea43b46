"""Live profiler endpoint — the `pprof_laddr` analog.

Reference: node/node.go:868-882 wires net/http/pprof onto
config.RPC.PprofListenAddress. Python equivalents, served as plain HTTP on
the same config field:

  GET /debug/pprof/profile?seconds=N[&format=text]
      cProfile of the node's MAIN thread (the asyncio event loop — where
      all consensus/p2p/rpc Python work runs) for N seconds (default 5,
      max 120). Default response is the marshalled pstats dump (load with
      pstats.Stats(file)); format=text returns a cumulative-time table.
  GET /debug/pprof/heap[?format=text]
      tracemalloc snapshot. Tracing starts on the FIRST heap request (the
      reference's heap profile is likewise since-start-of-tracking);
      responses report top allocation sites since then.
  GET /debug/pprof/stacks
      every thread's current Python stack (the goroutine-dump analog; also
      available as SIGUSR1 on the process, cmd.py).

Profiling is on-demand and idle-cost-free except tracemalloc once /heap
has been requested (documented overhead, as with the reference's
mutex/block profiles).

The port's copy of cometbft_tpu/node/pprof.py (standard library only).
"""

from __future__ import annotations

import asyncio
import cProfile
import io
import marshal
import pstats
import sys
import traceback
import urllib.parse

from cometbft_tpu_torch.libs import log as cmtlog
from cometbft_tpu_torch.libs.service import BaseService

MAX_PROFILE_SECONDS = 120


def _all_stacks_text() -> str:
    import threading

    out = []
    names = {t.ident: t.name for t in threading.enumerate()}
    for ident, frame in sys._current_frames().items():
        out.append(f"--- thread {ident} ({names.get(ident, '?')}) ---")
        out.extend(line.rstrip() for line in traceback.format_stack(frame))
        out.append("")
    return "\n".join(out)


class PprofServer(BaseService):
    """Plain-HTTP profiler plane, separate from the RPC listener (like the
    reference's pprof mux)."""

    def __init__(self, laddr: str, logger: cmtlog.Logger | None = None):
        super().__init__("Pprof", logger or cmtlog.default().with_fields(
            module="pprof"))
        self.laddr = laddr
        self.bound_addr = ""
        self._server: asyncio.Server | None = None
        self._profiling = False
        self._started_tracemalloc = False

    async def on_start(self) -> None:
        addr = self.laddr.removeprefix("tcp://").removeprefix("http://")
        host, _, port = addr.rpartition(":")
        self._server = await asyncio.start_server(
            self._handle, host or "127.0.0.1", int(port))
        sock = self._server.sockets[0].getsockname()
        self.bound_addr = f"{sock[0]}:{sock[1]}"
        self.logger.info("pprof listening", addr=self.bound_addr)

    async def on_stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
        if self._started_tracemalloc:
            # tracemalloc taxes every allocation in the whole process;
            # never leave it running past the profiler's lifetime
            import tracemalloc

            tracemalloc.stop()
            self._started_tracemalloc = False

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        try:
            line = await reader.readline()
            while True:  # drain headers
                h = await reader.readline()
                if h in (b"\r\n", b"\n", b""):
                    break
            parts = line.decode("latin1").split()
            if len(parts) < 2 or parts[0] != "GET":
                await self._respond(writer, 405, b"method not allowed\n")
                return
            path, _, query = parts[1].partition("?")
            params = {k: v[0] for k, v in
                      urllib.parse.parse_qs(query).items()}
            if path == "/debug/pprof/profile":
                await self._profile(writer, params)
            elif path == "/debug/pprof/heap":
                await self._heap(writer, params)
            elif path == "/debug/pprof/stacks":
                await self._respond(writer, 200, _all_stacks_text().encode())
            elif path in ("/", "/debug/pprof", "/debug/pprof/"):
                await self._respond(
                    writer, 200,
                    b"pprof endpoints: /debug/pprof/profile?seconds=N"
                    b"[&format=text], /debug/pprof/heap[?format=text], "
                    b"/debug/pprof/stacks\n")
            else:
                await self._respond(writer, 404, b"unknown pprof route\n")
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        finally:
            writer.close()

    async def _profile(self, writer, params: dict) -> None:
        import math

        try:
            s = float(params.get("seconds", "5"))
        except ValueError:
            await self._respond(writer, 400, b"bad seconds\n")
            return
        if not math.isfinite(s):  # nan/inf must never reach asyncio.sleep
            await self._respond(writer, 400, b"bad seconds\n")
            return
        seconds = min(MAX_PROFILE_SECONDS, max(0.0, s))
        if self._profiling:
            await self._respond(writer, 409, b"profile already running\n")
            return
        self._profiling = True
        try:
            prof = cProfile.Profile()
            prof.enable()
            try:
                await asyncio.sleep(seconds)
            finally:
                prof.disable()
            prof.create_stats()
            if params.get("format") == "text":
                buf = io.StringIO()
                pstats.Stats(prof, stream=buf).sort_stats(
                    "cumulative").print_stats(60)
                await self._respond(writer, 200, buf.getvalue().encode())
            else:
                await self._respond(
                    writer, 200, marshal.dumps(prof.stats),
                    ctype="application/octet-stream")
        finally:
            self._profiling = False

    async def _heap(self, writer, params: dict) -> None:
        import tracemalloc

        if not tracemalloc.is_tracing():
            tracemalloc.start(12)
            self._started_tracemalloc = True
            await self._respond(
                writer, 200,
                b"tracemalloc started; request /debug/pprof/heap again for "
                b"allocations since now\n")
            return
        snap = tracemalloc.take_snapshot()
        stats = snap.statistics("lineno")
        lines = [f"heap: {len(stats)} allocation sites, "
                 f"{sum(s.size for s in stats)} bytes tracked"]
        lines += [str(s) for s in stats[:80]]
        await self._respond(writer, 200, ("\n".join(lines) + "\n").encode())

    @staticmethod
    async def _respond(writer, status: int, body: bytes,
                       ctype: str = "text/plain") -> None:
        reason = {200: "OK", 400: "Bad Request", 404: "Not Found",
                  405: "Method Not Allowed", 409: "Conflict"}.get(status, "")
        writer.write(
            (f"HTTP/1.1 {status} {reason}\r\nContent-Type: {ctype}\r\n"
             f"Content-Length: {len(body)}\r\nConnection: close\r\n\r\n"
             ).encode() + body)
        await writer.drain()
