"""The port's chaos sites (cometbft_tpu_torch/libs/chaos.py) and failure
classifier (ops/dispatch.classify_failure) against the JAX package's, in
one process on the same schedules and exceptions: parsed schedules, armed
kinds, fire outcomes and counts, the environment schedule, and the failure
classes, equal. The CUDA markers are the port's own and are checked
against their stated classes.
"""

from __future__ import annotations

import logging

import pytest
import torch

from cometbft_tpu.libs import chaos as JC
from cometbft_tpu.ops import dispatch as JD
from cometbft_tpu_torch.libs import chaos as TC
from cometbft_tpu_torch.ops import dispatch as TD


@pytest.fixture(autouse=True)
def _fresh():
    JC.reset()
    TC.reset()
    yield
    JC.reset()
    TC.reset()


def _parse(mod, spec):
    try:
        return mod.parse_spec(spec)
    except ValueError:
        return "ValueError"


SPECS = [
    "",
    "ed25519.dispatch=transient:3,pallas.trace=permanent",
    "ed25519.dispatch.dev3=permanent,sr25519.dispatch.dev7=timeout:2",
    " ed25519.dispatch.dev0 = corrupt : 1 , ,dispatch.doublebuf=transient",
    "ed25519.dispatch.dev99=permanent",
    "ed25519.dispatch.dev8=permanent",
    "bls12381.dispatch=permanent",
    "ed25519.dispatch=explode",
    "ed25519.dispatch=transient:x",
    "ed25519.dispatch=transient:-1",
    "ed25519.dispatch=transient:0",
    "sched.flush=timeout,light.fetch=transient:2,net.dial=permanent",
]


@pytest.mark.parametrize("spec", SPECS)
def test_parse_spec_equals_reference(spec):
    assert _parse(TC, spec) == _parse(JC, spec)


def test_sites_and_kinds_equal_reference():
    assert TC.SITES == JC.SITES
    assert TC.KINDS == JC.KINDS
    assert TC.MESH_CHAOS_DEVICES == JC.MESH_CHAOS_DEVICES == 8
    with pytest.raises(ValueError):
        TC.parse_spec("ed25519.dispatch.dev99=permanent")


def _fire(mod, site):
    try:
        mod.fire(site)
    except Exception as exc:  # noqa: BLE001 - the outcome is compared
        return type(exc).__name__
    return None


# every armed site of the schedules below, read after each step
WATCHED = ("ed25519.dispatch", "ed25519.dispatch.dev0", "ed25519.dispatch.dev1",
           "sr25519.dispatch.dev2", "sr25519.dispatch.dev3", "ed25519.fetch",
           "dispatch.doublebuf")

# each step: (op, site[, kind, count])
SCHEDULES = [
    [("arm", "ed25519.dispatch", "transient", 2)] + [("fire", "ed25519.dispatch")] * 4,
    [("arm", "ed25519.dispatch.dev1", "permanent", None)] + [("fire", "ed25519.dispatch.dev1")] * 3
    + [("disarm", "ed25519.dispatch.dev1"), ("fire", "ed25519.dispatch.dev1")],
    [("arm", "sr25519.dispatch.dev2", "timeout", 1), ("fire", "sr25519.dispatch.dev2"),
     ("fire", "sr25519.dispatch.dev2"), ("fire", "sr25519.dispatch.dev3")],
    [("arm", "ed25519.fetch", "corrupt", 2), ("fire", "ed25519.fetch"),
     ("fire", "ed25519.fetch"), ("fire", "ed25519.fetch")],
    [("arm", "dispatch.doublebuf", "transient", 0), ("fire", "dispatch.doublebuf")],
    [("spec", "ed25519.dispatch.dev0=transient:1,ed25519.dispatch.dev1=permanent"),
     ("fire", "ed25519.dispatch.dev0"), ("fire", "ed25519.dispatch.dev0"),
     ("fire", "ed25519.dispatch.dev1"), ("reset",), ("fire", "ed25519.dispatch.dev1")],
    [("arm", "nosuch.site", "transient", 1)],
    [("arm", "ed25519.dispatch", "melt", 1)],
]


def _run(mod, schedule):
    out = []
    for step in schedule:
        op = step[0]
        try:
            if op == "arm":
                mod.arm(step[1], step[2], step[3])
                got = None
            elif op == "spec":
                mod.arm_spec(step[1])
                got = None
            elif op == "fire":
                got = _fire(mod, step[1])
            elif op == "disarm":
                got = mod.disarm(step[1])
            else:
                got = mod.reset()
        except ValueError:
            got = "ValueError"
        out.append((got, [(s, mod.armed(s), mod.fired(s)) for s in WATCHED]))
    return out


@pytest.mark.parametrize("schedule", SCHEDULES, ids=range(len(SCHEDULES)))
def test_arm_fire_fired_equal_reference(schedule):
    assert _run(TC, schedule) == _run(JC, schedule)


def test_environment_schedule(monkeypatch, caplog):
    monkeypatch.setenv("CBFT_CHAOS", "ed25519.dispatch.dev1=permanent:2")
    for mod in (TC, JC):
        monkeypatch.setattr(mod, "_env_loaded", False)
    assert [TC.armed("ed25519.dispatch.dev1"), TC.armed("ed25519.dispatch.dev0")] == \
        [JC.armed("ed25519.dispatch.dev1"), JC.armed("ed25519.dispatch.dev0")] == \
        ["permanent", None]
    assert [_fire(TC, "ed25519.dispatch.dev1") for _ in range(3)] == \
        [_fire(JC, "ed25519.dispatch.dev1") for _ in range(3)] == \
        ["ChaosPermanentError", "ChaosPermanentError", None]
    # a malformed schedule arms nothing and is logged, not raised
    monkeypatch.setenv("CBFT_CHAOS", "ed25519.dispatch.dev1=permanent,ed25519.dispatch.dev99=x")
    TC.reset()
    monkeypatch.setattr(TC, "_env_loaded", False)
    with caplog.at_level(logging.ERROR):
        assert _fire(TC, "ed25519.dispatch.dev1") is None
    assert TC.armed("ed25519.dispatch.dev1") is None
    assert "CBFT_CHAOS" in caplog.text


def _exceptions(chaos):
    return [
        chaos.ChaosPermanentError("x"), chaos.ChaosTransientError("x"), chaos.ChaosTimeout("x"),
        TimeoutError("hung"),
        RuntimeError("RESOURCE_EXHAUSTED: out of HBM"), RuntimeError("DEADLINE_EXCEEDED"),
        RuntimeError("UNAVAILABLE: tunnel"), RuntimeError("connection reset by peer"),
        RuntimeError("Mosaic failed to compile"), RuntimeError("lowering error"),
        ValueError("Unsupported dtype"), RuntimeError("NOT_FOUND: executable"),
        RuntimeError("UNIMPLEMENTED"), RuntimeError("INVALID_ARGUMENT: shape"),
        RuntimeError("something novel"), KeyError("k"),
        RuntimeError("reduced-fetch header of a ed25519 batch: chk_mismatch"),
    ]


def test_classify_failure_equals_reference():
    got = [TD.classify_failure(e) for e in _exceptions(TC)]
    want = [JD.classify_failure(e) for e in _exceptions(JC)]
    assert got == want
    assert got[:4] == ["permanent", "transient", "timeout", "timeout"]


@pytest.mark.parametrize("exc, fclass", [
    (torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB"), "transient"),
    (RuntimeError("CUDA error: out of memory"), "transient"),
    (RuntimeError("CUDA error: an illegal memory access was encountered"), "permanent"),
    (RuntimeError("CUDA error: unspecified launch failure"), "permanent"),
    (RuntimeError("CUDA error: device-side assert triggered"), "permanent"),
    (RuntimeError("nvcc failed on verify25519.cu (exit 1)"), "permanent"),
    (RuntimeError("nvcc not found: the CUDA toolkit is required"), "permanent"),
    (RuntimeError("ed25519_verify launch failed: cudaError_t 2"), "transient"),
])
def test_classify_failure_cuda_markers(exc, fclass):
    assert TD.classify_failure(exc) == fclass
