"""The port's supervision layer (cometbft_tpu_torch/ops/dispatch.py:
CircuitBreaker, DeviceSupervisor, the registry and its knobs, the
DoubleBuffer gate) held step by step against the JAX package's
(cometbft_tpu/ops/dispatch.py) on the same fake clock and the same
sequences of failures and successes: states, counters, admissions and the
exceptions raised, equal.
"""

from __future__ import annotations

import threading

import pytest

from cometbft_tpu.libs import chaos as JC
from cometbft_tpu.ops import dispatch as JD
from cometbft_tpu_torch.libs import chaos as TC
from cometbft_tpu_torch.ops import dispatch as TD

KNOBS = dict(failure_threshold=3, cooldown=30.0, retry_attempts=2, retry_base=0.05,
             retry_cap=1.0, watchdog_timeout=120.0)


@pytest.fixture(autouse=True)
def _fresh():
    for chaos, d in ((JC, JD), (TC, TD)):
        chaos.reset()
        d.reset_supervision()
        d.configure(**KNOBS)
    yield
    for chaos, d in ((JC, JD), (TC, TD)):
        chaos.reset()
        d.reset_supervision()
        d.configure(**KNOBS)


class Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self) -> float:
        return self.t


# breaker steps: "ok", "T"/"P"/"O" (failure: transient, permanent, timeout),
# "allow", "peek", "+s" (the clock advances s seconds)
BREAKER_SEQS = [
    ["T", "T", "allow", "T", "allow", "peek", "+29", "allow", "+1", "peek", "allow", "allow",
     "peek", "ok", "allow"],
    ["P", "peek", "+30", "allow", "T", "peek", "+10", "allow", "+20", "allow", "ok", "T", "T",
     "ok", "T"],
    ["O", "O", "allow", "O", "allow", "+30", "peek", "allow", "O", "+30", "allow", "P", "+31",
     "peek", "allow", "ok", "peek"],
    ["ok", "T", "ok", "T", "T", "ok", "T", "T", "T", "+5", "allow", "+25", "allow", "allow"],
]

_FAIL = {"T": "transient", "P": "permanent", "O": "timeout"}


def _breaker_run(mod, seq, threshold, cooldown):
    clock = Clock()
    br = mod.CircuitBreaker("b", failure_threshold=threshold, cooldown=cooldown, clock=clock)
    out = []
    for step in seq:
        got = None
        if step == "ok":
            br.record_success()
        elif step in _FAIL:
            br.record_failure(_FAIL[step])
        elif step == "allow":
            got = br.allow()
        elif step == "peek":
            got = br.peek()
        else:
            clock.t += float(step[1:])
        out.append((step, got, br.state, br.consecutive_failures, br.health()))
    return out


@pytest.mark.parametrize("threshold, cooldown", [(3, 30.0), (1, 30.0), (2, 0.0)])
@pytest.mark.parametrize("seq", BREAKER_SEQS, ids=range(len(BREAKER_SEQS)))
def test_breaker_step_by_step(seq, threshold, cooldown):
    assert _breaker_run(TD, seq, threshold, cooldown) == \
        _breaker_run(JD, seq, threshold, cooldown)


# supervisor runs: each run is the outcomes of its attempts in order,
# "ok" or an error ("T" transient text, "P" permanent text, "CT"/"CP"/"CO"
# the package's chaos classes, "X" text with no marker); "+s" advances the
# clock between runs
SUPERVISOR_SEQS = [
    [["ok"], ["T", "ok"], ["T", "T", "ok"], ["T", "T", "T"], ["ok"]],
    [["P"], ["ok"], "+30", ["ok"], ["ok"]],
    [["CT", "CT", "CT"], ["CT", "CT", "CT"], ["CT", "CT", "CT"], ["ok"], "+30", ["CP"], ["ok"],
     "+30", ["ok"]],
    [["CO"], ["CO"], ["CO"], ["ok"], "+30", ["X", "ok"]],
    [["CP"], "+30", ["T", "T", "T"], "+30", ["ok"], ["CO"]],
]


def _exc(mod, chaos, code):
    return {
        "T": RuntimeError("RESOURCE_EXHAUSTED: transient"),
        "P": RuntimeError("INVALID_ARGUMENT: shape"),
        "X": RuntimeError("novel"),
        "CT": chaos.ChaosTransientError("chaos transient"),
        "CP": chaos.ChaosPermanentError("chaos permanent"),
        "CO": chaos.ChaosTimeout("chaos timeout"),
    }[code]


def _supervisor_run(mod, chaos, seq, threshold, attempts):
    clock = Clock()
    sleeps = []
    sup = mod.DeviceSupervisor("s", failure_threshold=threshold, cooldown=30.0,
                               retry_attempts=attempts, retry_base=0.05, retry_cap=1.0,
                               sleep=sleeps.append, clock=clock)
    out = []
    for run in seq:
        if isinstance(run, str):
            clock.t += float(run[1:])
            continue
        script = iter(run)

        def op():
            code = next(script)
            if code == "ok":
                return "done"
            raise _exc(mod, chaos, code)

        try:
            got = sup.run(op)
        except (mod.DeviceUnavailable, mod.DeviceOpFailed) as exc:
            cause = exc.__cause__
            got = (type(exc).__name__, str(exc),
                   None if cause is None else type(cause).__name__)
        out.append((got, sup.breaker.state, sup.retries, sup.failures, sup.successes,
                    sup.last_error, len(sleeps), sup.breaker.consecutive_failures))
    # the backoff: capped exponential with jitter in [0.5, 1] of the step
    return out, sleeps


@pytest.mark.parametrize("threshold, attempts", [(3, 2), (1, 0), (2, 1)])
@pytest.mark.parametrize("seq", SUPERVISOR_SEQS, ids=range(len(SUPERVISOR_SEQS)))
def test_supervisor_step_by_step(seq, threshold, attempts):
    got, got_sleeps = _supervisor_run(TD, TC, seq, threshold, attempts)
    want, want_sleeps = _supervisor_run(JD, JC, seq, threshold, attempts)
    assert got == want
    assert len(got_sleeps) == len(want_sleeps)
    # the same backoff steps, each jittered into [0.5, 1] of its step
    for a, b in zip(got_sleeps, want_sleeps):
        assert b / 2 <= a <= 2 * b <= 2.0


def test_supervisor_record_op_failure_and_health():
    outs = []
    for mod, chaos in ((TD, TC), (JD, JC)):
        sup = mod.DeviceSupervisor("w", failure_threshold=2, clock=Clock())
        classes = [sup.record_op_failure(TimeoutError("watchdog")),
                   sup.record_op_failure(chaos.ChaosTransientError("t"))]
        h = sup.health()
        outs.append((classes, sup.breaker.state, h["failures"], h["retries"], h["successes"],
                     h["last_error"], h["breaker"]["state"],
                     h["breaker"]["consecutive_failures"]))
    assert outs[0] == outs[1]
    assert outs[0][:2] == (["timeout", "transient"], "open")


def test_registry_knobs_equal_reference():
    outs = []
    for mod in (TD, JD):
        a = mod.supervisor("mesh.dev0")
        assert mod.supervisor("mesh.dev0") is a
        mod.configure(failure_threshold=1, cooldown=2.5, retry_attempts=4, retry_base=0.0,
                      retry_cap=0.0, watchdog_timeout=7.0)
        b = mod.supervisor("mesh.dev1")
        with pytest.raises(ValueError):
            mod.configure(no_such_knob=1)
        got = [(s.breaker.failure_threshold, s.breaker.cooldown, s.retry_attempts,
                s.retry_base, s.retry_cap) for s in (a, b)]
        allowed = mod.device_allowed()
        mod.supervisor("device").breaker.record_failure("permanent")
        outs.append((got, mod.watchdog_timeout(), allowed, mod.device_allowed()))
        mod.reset_supervision()
        assert mod.supervisor("mesh.dev0") is not a
    assert outs[0] == outs[1] == ([(1, 2.5, 4, 0.0, 0.0)] * 2, 7.0, True, False)


def _gate_run(mod, chaos, spec):
    """Acquire and release a domain's gate under a chaos schedule: two
    slots taken, a third acquire that must wait, then a fault that
    degrades the gate to one batch in flight."""
    db = mod.doublebuffer("dev1")
    assert mod.doublebuffer("dev1") is db
    out = []
    r1, r2 = db.acquire(), db.acquire()
    out.append((db.stats(), db._sem._value))
    got = []
    t = threading.Thread(target=lambda: got.append(db.acquire()))
    t.start()
    t.join(timeout=0.2)
    out.append(t.is_alive())
    r1()
    r1()  # a second release does nothing
    t.join(timeout=10)
    assert not t.is_alive()
    got[0]()
    r2()
    out.append((db.stats(), db._sem._value))
    chaos.arm_spec(spec)
    rel = db.acquire()  # the fault: one batch in flight
    out.append((db.stats(), db._sem._value, mod.supervisor("doublebuf.dev1").breaker.state))
    rel()
    rel = db.acquire()  # the breaker is open: still one in flight
    out.append((db.stats(), db._serial.locked(), db._sem._value))
    rel()
    mod.supervisor("doublebuf.dev1").breaker.cooldown = 0.0
    rel = db.acquire()  # the half-open probe closes the breaker: two slots again
    out.append((db.stats(), db._serial.locked(), db._sem._value,
                mod.supervisor("doublebuf.dev1").breaker.state))
    rel()
    out.append((mod.doublebuffer_stats(), db._sem._value))
    return out


@pytest.mark.parametrize("spec", ["dispatch.doublebuf=transient:1",
                                  "dispatch.doublebuf=permanent:1"])
def test_doublebuffer_gate_equals_reference(spec):
    for d in (TD, JD):
        d.configure(failure_threshold=1)
    got = _gate_run(TD, TC, spec)
    want = _gate_run(JD, JC, spec)
    assert got == want
    assert got[1] is True  # the third acquire waited for a slot
    assert TD.doublebuffer("dev1")._sem._value == 2
