"""The port's support libraries against the JAX package's: the span tracer
(libs/trace.py: the span tree, parents through the contextvar, the slow
capture ring, attribution), the logger (libs/log.py: logfmt and JSON
records with the height/round and trace stamps), the event switch
(libs/events.py), crash points (libs/fail.py), services (libs/service.py)
and the consensus heightline (consensus/timeline.py). The same sequence of
calls on fake clocks gives the same records in both packages, exactly.
"""

from __future__ import annotations

import asyncio
import io
import itertools
import time

import pytest

from cometbft_tpu.consensus import timeline as jtimeline
from cometbft_tpu.libs import events as jevents
from cometbft_tpu.libs import fail as jfail
from cometbft_tpu.libs import log as jlog
from cometbft_tpu.libs import service as jservice
from cometbft_tpu.libs import trace as jtrace
from cometbft_tpu_torch.consensus import timeline as ttimeline
from cometbft_tpu_torch.libs import events as tevents
from cometbft_tpu_torch.libs import fail as tfail
from cometbft_tpu_torch.libs import log as tlog
from cometbft_tpu_torch.libs import service as tservice
from cometbft_tpu_torch.libs import trace as ttrace

PAIRS = [(jtrace, jlog), (ttrace, tlog)]


def _clock(step: int):
    c = itertools.count(0, step)
    return lambda: next(c)


@pytest.fixture(autouse=True)
def _reset():
    for m in (jtrace, ttrace, jtimeline, ttimeline, jfail, tfail):
        m.reset()
    yield
    for m in (jtrace, ttrace, jtimeline, ttimeline, jfail, tfail):
        m.reset()
    for m in (jlog, tlog):
        m.clear_height_round()


def _trace_run(trace, log):
    """One sequence of spans, events, bytes and accounting; a logger that
    writes inside them."""
    trace.configure(enabled=True, capacity=64, slow_ms=5.0, slow_captures=4,
                    clock=_clock(1_000_000))
    out = io.StringIO()
    lg = log.Logger(out, fmt="json").with_fields(module="consensus")
    root = trace.begin("consensus.height", cat="consensus", height=7)
    with trace.span("consensus.prevote_flush", cat="consensus", parent=root, rows=3) as sp:
        with trace.span("sched.batch", cat="stage", lanes=8):
            trace.add_bytes(tx=128, rx=8)
            lg.info("flushing", rows=3, key=b"\x01\xab")
            with trace.span("kernel", cat="compute"):
                pass
        sp.set(outcome="ok")
    trace.event("consensus.step.prevote", cat="consensus", parent=root, round=0)
    trace.account("queue", 0.25, rows=3, tx_bytes=16)
    log.set_height_round(7, 1)
    lg.error("late", peer="val2", msg_bytes=b"")
    root.set(rounds=1)
    root.finish()
    with trace.span("mempool.admit", cat="mempool", tx_bytes=97):
        pass
    return {"spans": trace.snapshot(), "slow": trace.slow_captures(),
            "attr": trace.attribution(), "chrome": trace.chrome_trace(),
            "log": out.getvalue(), "ids": trace.current_ids()}


def test_span_tree_records_and_log_lines_are_the_reference_s(monkeypatch):
    monkeypatch.setattr(time, "strftime", lambda fmt, t=None: "2026-01-01T00:00:00")
    got = [_trace_run(*p) for p in PAIRS]
    assert got[0] == got[1]
    names = [s["name"] for s in got[1]["spans"]]
    assert names == ["kernel", "sched.batch", "consensus.prevote_flush",
                     "consensus.step.prevote", "consensus.height", "mempool.admit"]
    assert got[1]["slow"] and got[1]["slow"][0]["root"] == "consensus.height"
    assert '"height": 7' in got[1]["log"] and '"trace_id"' in got[1]["log"]


@pytest.mark.parametrize("fmt", ["logfmt", "json"])
def test_logger_lines_are_the_reference_s(monkeypatch, fmt):
    monkeypatch.setattr(time, "strftime", lambda f, t=None: "2026-01-01T00:00:00")
    lines = []
    for log in (jlog, tlog):
        out = io.StringIO()
        lg = log.Logger(out, level=log.parse_level("debug"), fmt=fmt)
        lg.debug("a", x=1, s="with space", b=b"\x00\xff", lazy=log.lazy_hex(b"\x12"))
        log.set_height_round(3, 0)
        lg.with_fields(node="val0").warn("b", y=None)
        log.clear_height_round()
        log.nop().error("never")
        lines.append(out.getvalue())
    assert lines[0] == lines[1] and lines[1].count("\n") == 2


def test_event_switch_fires_as_the_reference_s():
    seen = []
    for events in (jevents, tevents):
        got = []
        sw = events.EventSwitch()
        sw.add_listener("a", "Vote", lambda d: got.append(("a", d)))
        sw.add_listener("b", "Vote", lambda d: got.append(("b", d)))
        sw.add_listener("b", "NewRoundStep", lambda d: got.append(("b-step", d)))
        sw.fire("Vote", 1)
        sw.remove_listener("a", "Vote")
        sw.fire_event("Vote", 2)
        sw.remove_listener("b")
        sw.fire("NewRoundStep", 3)
        seen.append(got)
    assert seen[0] == seen[1] == [("a", 1), ("b", 1), ("b", 2)]


def test_fail_points_count_and_fire_as_the_reference_s():
    got = []
    for fail in (jfail, tfail):
        fired = []
        fail.arm("privval.save", 2, hook=lambda site: fired.append(site))
        for _ in range(3):
            fail.fail_point("privval.save")
        fail.fail_point("abci.apply")
        got.append((fired, fail.hits("privval.save"), fail.hits("abci.apply")))
    assert got[0] == got[1]


def _timeline_run(timeline):
    timeline.configure(enabled=True, heights=2, slow_ms=1.0,
                       clock_mono=_clock(1_000_000), clock_wall=_clock(3_000_000))
    rec = timeline.Recorder(node="val1")
    for h in (5, 6, 7):
        for name in timeline.MARKS:
            rec.mark(h, name, round_=h % 2, peer="val0" if "received" in name else "")
        rec.vote_arrival(h, 0, 1, "val2", 1_000)
        rec.vote_arrival(h, 0, 2, "val2", 2_000)
        rec.height_done(h)
    rec.mark(8, timeline.NEW_HEIGHT)
    docs = [{"node_id": "val1", "heights": rec.snapshot(), "skew": {}}]
    return rec.snapshot(), rec.postmortems(), timeline.aggregate(docs)


def test_timeline_gives_the_reference_s_snapshot_and_phases():
    got = [_timeline_run(m) for m in (jtimeline, ttimeline)]
    assert got[0] == got[1]
    snap, _, agg = got[1]
    assert [r["height"] for r in snap] == [7, 8]
    assert set(agg["summary"]["phase_ms"]) <= set(ttimeline.PHASES)


def test_service_lifecycle_and_task_runner_as_the_reference_s():
    async def run(service):
        log = []

        class Svc(service.BaseService):
            async def on_start(self):
                log.append("start")

            async def on_stop(self):
                log.append("stop")

        s = Svc("svc")
        await s.start()
        running = s.is_running
        try:
            await s.start()
        except service.AlreadyStartedError:
            log.append("already-started")
        await s.stop()
        try:
            await s.stop()
        except service.AlreadyStoppedError:
            log.append("already-stopped")
        tasks = service.TaskRunner("t")
        tasks.spawn(asyncio.sleep(10), name="sleeper")
        n = len(tasks)
        await tasks.cancel_all()
        return log, running, s.is_running, n, len(tasks)

    assert asyncio.run(run(jservice)) == asyncio.run(run(tservice))
