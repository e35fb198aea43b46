"""Structured logfmt/JSON logger (reference: libs/log).

Module-scoped child loggers via with_fields(); lazy value rendering so hot
paths (vote ingestion) pay nothing when the level is filtered — the analog of
the reference's log.NewLazySprintf (consensus/state.go:1654).

Trace correlation: when the flight recorder (libs/trace.py) is armed and a
span is active on the emitting thread/task, every record is stamped with
`trace_id`/`span_id` — a slow-batch capture and its log lines correlate by
id. Consensus-path records additionally carry `height`/`round` from the
contextvar set by ConsensusState._new_step (set_height_round), so
grep-by-height works across the whole node log. JSON output is opt-in
process-wide via set_default_format("json") (node boot wires
base.log_format through it) or CBFT_LOG_FORMAT=json, so library code
calling default() follows the node's choice.

The port's copy of cometbft_tpu/libs/log.py.
"""

from __future__ import annotations

import contextvars
import io
import json
import os
import sys
import threading
import time
from typing import Any, Callable, Optional, TextIO

from cometbft_tpu_torch.libs import trace as _trace

# (height, round) of the consensus step the emitting task is in, or None
# outside the consensus path. A contextvar, so the stamp follows the
# consensus receive task without leaking into reactor/RPC tasks.
_height_ctx: contextvars.ContextVar[Optional[tuple]] = contextvars.ContextVar(
    "cbft_log_height", default=None)


def set_height_round(height: int, round_: int) -> None:
    """Stamp subsequent log records from this task with height/round."""
    _height_ctx.set((height, round_))


def clear_height_round() -> None:
    _height_ctx.set(None)


def current_height_round() -> Optional[tuple]:
    return _height_ctx.get()

DEBUG, INFO, WARN, ERROR, NONE = 0, 1, 2, 3, 4
_LEVEL_NAMES = {DEBUG: "debug", INFO: "info", WARN: "warn", ERROR: "error"}
_NAME_LEVELS = {v: k for k, v in _LEVEL_NAMES.items()} | {"none": NONE}


def parse_level(name: str) -> int:
    try:
        return _NAME_LEVELS[name.lower()]
    except KeyError:
        raise ValueError(f"unknown log level {name!r}") from None


class Lazy:
    """Defers fn() until the record is actually emitted."""

    __slots__ = ("fn",)

    def __init__(self, fn: Callable[[], Any]):
        self.fn = fn

    def __str__(self) -> str:
        return str(self.fn())


def lazy_hex(b: bytes) -> Lazy:
    return Lazy(lambda: b.hex().upper())


def _fmt_value(v: Any) -> str:
    if isinstance(v, Lazy):
        v = str(v)
    if isinstance(v, bytes):
        v = v.hex().upper()
    s = str(v)
    if any(c in ' ="' or ord(c) < 0x20 or c == "\x7f" for c in s):
        return json.dumps(s)
    return s


class Logger:
    """logfmt (default) or JSON lines to a stream."""

    def __init__(self, stream: Optional[TextIO] = None, level: int = INFO,
                 fields: tuple = (), fmt: str = "logfmt"):
        self._stream = stream if stream is not None else sys.stderr
        self.level = level
        self._fields = fields
        self._fmt = fmt
        self._lock = threading.Lock()

    def with_fields(self, **kv: Any) -> "Logger":
        child = Logger(self._stream, self.level, self._fields + tuple(kv.items()), self._fmt)
        child._lock = self._lock
        return child

    # alias matching the reference's logger.With(...)
    with_ = with_fields

    def _emit(self, level: int, msg: str, kv: dict) -> None:
        if level < self.level:
            return
        ts = time.strftime("%Y-%m-%dT%H:%M:%S", time.gmtime())
        ids = _trace.current_ids()  # None in two reads when tracing is off
        items = self._fields + tuple(kv.items())
        hr = _height_ctx.get()  # None outside the consensus path
        if hr is not None:
            items += (("height", hr[0]), ("round", hr[1]))
        if ids is not None:
            items += (("trace_id", ids[0]), ("span_id", ids[1]))
        if self._fmt == "json":
            rec = {"level": _LEVEL_NAMES[level], "ts": ts, "msg": msg}
            for k, v in items:
                if isinstance(v, bytes):
                    v = v.hex().upper()
                elif isinstance(v, Lazy):
                    v = str(v)
                rec[k] = v
            line = json.dumps(rec, default=str)
        else:
            buf = io.StringIO()
            buf.write(f"{_LEVEL_NAMES[level][0].upper()}[{ts}] {msg}")
            for k, v in items:
                buf.write(f" {k}={_fmt_value(v)}")
            line = buf.getvalue()
        with self._lock:
            self._stream.write(line + "\n")

    def debug(self, msg: str, **kv: Any) -> None:
        self._emit(DEBUG, msg, kv)

    def info(self, msg: str, **kv: Any) -> None:
        self._emit(INFO, msg, kv)

    def warn(self, msg: str, **kv: Any) -> None:
        self._emit(WARN, msg, kv)

    def error(self, msg: str, **kv: Any) -> None:
        self._emit(ERROR, msg, kv)


class _NopLogger(Logger):
    def __init__(self) -> None:
        super().__init__(stream=io.StringIO(), level=NONE)

    def _emit(self, level: int, msg: str, kv: dict) -> None:
        pass


_NOP = _NopLogger()


def nop() -> Logger:
    return _NOP


_default_fmt: str | None = None


def set_default_format(fmt: str) -> None:
    """Process-wide default output format for default()-constructed
    loggers ("logfmt" | "json"). Node boot routes base.log_format here so
    deep library log sites (kernels, scheduler, supervisors) emit in the
    node's configured format instead of hardcoded logfmt."""
    if fmt not in ("logfmt", "json"):
        raise ValueError(f"unknown log format {fmt!r}")
    global _default_fmt
    _default_fmt = fmt


def default(level: int = INFO, fmt: str | None = None) -> Logger:
    if fmt is None:
        # the env var is the operator overlay and wins over the config-
        # routed process default (the CBFT_TRACE-over-config pattern)
        fmt = os.environ.get("CBFT_LOG_FORMAT") or _default_fmt or "logfmt"
    return Logger(sys.stderr, level, (), fmt)


def test_logger() -> Logger:
    return Logger(sys.stdout, DEBUG)
