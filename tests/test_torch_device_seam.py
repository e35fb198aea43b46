"""The single-card path's device-fault seam (ops/ed25519_kernel.py under
ops/dispatch.supervisor("device")), on the CPU backend where the same
wrappers run the plain versions:

- `{scheme}.dispatch` fires at each stage-and-launch and `{scheme}.fetch`
  at each fetch; a transient is retried in place and the mask is the one
  of an unarmed run; a timed-out fetch is recorded and issued again; a
  permanent fault raises DeviceOpFailed, and then an open breaker
  DeviceUnavailable, and no mask comes back;
- a device fault is never a verdict: both exceptions are RuntimeErrors,
  which every guard of the light verifier and the evidence checks
  re-raises unwrapped, and consensus and block sync stop on them instead
  of judging a vote, a block or a peer.

The reference answers a failed dispatch with its CPU rung; the port has
none (ROADMAP Queue 3).
"""

from __future__ import annotations

import asyncio
import types

import numpy as np
import pytest

from cometbft_tpu_torch.crypto import ed25519 as ted
from cometbft_tpu_torch.crypto import sr25519 as tsr
from cometbft_tpu_torch.evidence import verify as tverify
from cometbft_tpu_torch.libs import chaos
from cometbft_tpu_torch.light import verifier as tverifier
from cometbft_tpu_torch.ops import dispatch
from cometbft_tpu_torch.ops import ed25519_kernel as EK
from cometbft_tpu_torch.ops import sr25519_kernel as SRK
from cometbft_tpu_torch.types import validation as tval
from tests.torch_consumers import Chain, fresh_backends, now, port_vals
from tests.test_torch_evidence_state import _attack, _states, _Store
from tests.test_torch_light import DRIFT, _t

N = 12
BAD = (3, 9)


@pytest.fixture(autouse=True)
def _fresh():
    chaos.reset()
    dispatch.reset_supervision()
    dispatch.configure(failure_threshold=3, cooldown=30.0, retry_attempts=2, retry_base=0.0,
                       retry_cap=0.0, watchdog_timeout=120.0)
    yield from fresh_backends()
    chaos.reset()
    dispatch.reset_supervision()
    dispatch.configure(failure_threshold=3, cooldown=30.0, retry_attempts=2, retry_base=0.05,
                       retry_cap=1.0, watchdog_timeout=120.0)


def _rows(scheme_mod, n: int = N, seed: int = 0):
    rng = np.random.default_rng(seed)
    pubs, msgs, sigs = [], [], []
    for i in range(n):
        k = scheme_mod.gen_priv_key_from_secret(b"seam-%d-%d" % (seed, i))
        m = rng.integers(0, 256, 40 + i, dtype=np.uint8).tobytes()
        s = k.sign(m)
        if i in BAD:
            s = s[:10] + bytes([s[10] ^ 1]) + s[11:]
        pubs.append(k.pub_key().bytes_())
        msgs.append(m)
        sigs.append(s)
    return pubs, msgs, sigs


def _verify(scheme, rows):
    return EK.verify_rows(scheme, *rows, device="cpu")[0]


def _device() -> dict:
    return dispatch.supervisor("device").health()


@pytest.fixture(scope="module")
def ed_rows():
    return _rows(ted)


def test_unarmed_path_counts_successes_and_no_fault(ed_rows):
    mask = _verify(EK.ED25519, ed_rows)
    assert mask.tolist() == [i not in BAD for i in range(N)]
    h = _device()
    # one supervised dispatch and one header fetch, plus the payload fetch
    # a batch with failing lanes makes
    assert h["successes"] == 3 and h["failures"] == 0 and h["retries"] == 0
    assert h["breaker"]["state"] == "closed"


@pytest.mark.parametrize("scheme,mod", [(EK.ED25519, ted), (SRK.SR25519, tsr)],
                         ids=["ed25519", "sr25519"])
def test_transient_dispatch_is_retried_with_the_unarmed_mask(scheme, mod):
    rows = _rows(mod, seed=1)
    want = _verify(scheme, rows)
    dispatch.reset_supervision()
    chaos.arm(f"{scheme.name}.dispatch", "transient", 2)
    got = _verify(scheme, rows)
    assert got.tolist() == want.tolist()
    assert chaos.fired(f"{scheme.name}.dispatch") == 2
    h = _device()
    assert h["retries"] == 2 and h["failures"] == 0 and h["breaker"]["state"] == "closed"


def test_timed_out_fetch_is_recorded_and_issued_again(ed_rows):
    want = _verify(EK.ED25519, ed_rows)
    dispatch.reset_supervision()
    chaos.arm("ed25519.fetch", "timeout", 1)
    assert _verify(EK.ED25519, ed_rows).tolist() == want.tolist()
    h = _device()
    assert h["failures"] == 1 and h["breaker"]["state"] == "closed"
    assert h["breaker"]["consecutive_failures"] == 0
    assert "timeout" in h["last_error"]


def test_the_reference_s_flap_schedule_is_absorbed_with_four_retries(ed_rows):
    """e2e/runner.DEVICE_FLAP_CHAOS at the flap's retry attempts."""
    from cometbft_tpu_torch.e2e import runner

    want = _verify(EK.ED25519, ed_rows)
    dispatch.reset_supervision()
    dispatch.configure(retry_attempts=runner.DEVICE_FLAP_RETRIES)
    chaos.arm_spec(runner.DEVICE_FLAP_CHAOS)
    assert _verify(EK.ED25519, ed_rows).tolist() == want.tolist()
    h = _device()
    assert h["failures"] >= 1 and h["retries"] >= 1 and h["breaker"]["state"] == "closed"


def test_a_failed_check_in_the_launch_is_not_retried(ed_rows, monkeypatch):
    """An AssertionError raised inside the supervised launch (a kernel held
    against its plain version that differs) is the program's, not the
    card's: it reaches the caller at once, with no retry and no failure
    recorded, where the reference would retry it as an unknown error."""
    from cometbft_tpu_torch.ops import integrity

    calls = []

    def differs(*a, **k):
        calls.append(1)
        raise AssertionError("integrity_parts: kernel and plain version differ by 1")

    monkeypatch.setattr(integrity, "integrity_parts", differs)
    with pytest.raises(AssertionError, match="differ by 1"):
        _verify(EK.ED25519, ed_rows)
    assert len(calls) == 1
    h = _device()
    assert h["retries"] == 0 and h["failures"] == 0 and h["breaker"]["state"] == "closed"


@pytest.mark.parametrize("site", ["ed25519.dispatch", "ed25519.fetch"])
def test_permanent_fault_raises_typed_and_returns_no_mask(ed_rows, site):
    dispatch.configure(failure_threshold=1)
    chaos.arm(site, "permanent")
    with pytest.raises(dispatch.DeviceOpFailed) as e:
        _verify(EK.ED25519, ed_rows)
    assert isinstance(e.value, RuntimeError)
    assert isinstance(e.value.__cause__, chaos.ChaosPermanentError)
    h = _device()
    assert h["failures"] == 1 and h["breaker"]["state"] == "open"
    # the open breaker refuses the next batch before anything is staged
    fired = chaos.fired(site)
    with pytest.raises(dispatch.DeviceUnavailable):
        _verify(EK.ED25519, ed_rows)
    assert chaos.fired(site) == fired


def test_device_kill_schedule_names_pallas_trace_and_never_fires_it(ed_rows):
    from cometbft_tpu_torch.e2e import runner

    chaos.arm_spec(runner.DEVICE_KILL_CHAOS)
    with pytest.raises(dispatch.DeviceOpFailed):
        _verify(EK.ED25519, ed_rows)
    assert chaos.armed("pallas.trace") == "permanent" and chaos.fired("pallas.trace") == 0


# --------------------------------------------- the guards: never a verdict


@pytest.fixture(scope="module")
def light_chain():
    return Chain(12, n_vals=4, tag=b"seam")


def _raiser(exc):
    def fn(*a, **k):
        raise exc("device: injected")
    return fn


@pytest.mark.parametrize("exc", [dispatch.DeviceOpFailed, dispatch.DeviceUnavailable])
def test_light_adjacent_guard_reraises_a_device_fault(light_chain, exc, monkeypatch):
    monkeypatch.setattr(tverifier, "verify_commit_light", _raiser(exc))
    tr, un = _t(light_chain.blocks[4]), _t(light_chain.blocks[5])
    with pytest.raises(exc):
        tverifier.verify_adjacent(tr.signed_header, un.signed_header, un.validator_set,
                                  10**18, now(light_chain)[1], DRIFT)


@pytest.mark.parametrize("exc", [dispatch.DeviceOpFailed, dispatch.DeviceUnavailable])
def test_light_non_adjacent_staging_guard_reraises_a_device_fault(light_chain, exc,
                                                                  monkeypatch):
    monkeypatch.setattr(tverifier, "stage_verify_commit_light", _raiser(exc))
    tr, un = _t(light_chain.blocks[2]), _t(light_chain.blocks[8])
    with pytest.raises(exc):
        tverifier.verify_non_adjacent(tr.signed_header, tr.validator_set, un.signed_header,
                                      un.validator_set, 10**18, now(light_chain)[1], DRIFT)


@pytest.mark.parametrize("exc", [dispatch.DeviceOpFailed, dispatch.DeviceUnavailable])
def test_light_non_adjacent_finish_guard_reraises_a_device_fault(light_chain, exc,
                                                                 monkeypatch):
    stub = types.SimpleNamespace(finish=_raiser(exc))
    orig = tverifier.prefetch_staged
    monkeypatch.setattr(tverifier, "stage_verify_commit_light", lambda *a, **k: stub)
    monkeypatch.setattr(tverifier, "prefetch_staged",
                        lambda staged, klass=None: orig([s for s in staged if s is not stub],
                                                        klass=klass))
    tr, un = _t(light_chain.blocks[2]), _t(light_chain.blocks[8])
    with pytest.raises(exc):
        tverifier.verify_non_adjacent(tr.signed_header, tr.validator_set, un.signed_header,
                                      un.validator_set, 10**18, now(light_chain)[1], DRIFT)


@pytest.fixture(scope="module")
def attack_chains():
    honest = Chain(30, n_vals=4, tag=b"evidence")
    return honest, honest.forked(20)


@pytest.mark.parametrize("fn", ["verify_commit_light_trusting", "verify_commit_light"])
@pytest.mark.parametrize("exc", [dispatch.DeviceOpFailed, dispatch.DeviceUnavailable])
def test_evidence_guards_reraise_a_device_fault(attack_chains, fn, exc, monkeypatch):
    """The lunatic attack's skipping check (the trusting call) and the
    conflicting commit's check each re-raise a device fault unwrapped,
    where any other failure becomes ErrInvalidEvidence."""
    honest, _ = attack_chains
    tev, _ = _attack(attack_chains)
    ts, _ = _states(attack_chains)
    store = _Store(honest.port_blocks(), 30)
    vals1 = port_vals(honest.vals(1)[0])
    if fn == "verify_commit_light":  # the trusting check passes first
        monkeypatch.setattr(tval, "verify_commit_light_trusting", lambda *a, **k: None)
    monkeypatch.setattr(tval, fn, _raiser(exc))
    with pytest.raises(exc):
        tverify.verify_light_client_attack(tev, ts, vals1, store)
    monkeypatch.setattr(tval, fn, _raiser(ValueError))
    with pytest.raises(tverify.ErrInvalidEvidence):
        tverify.verify_light_client_attack(tev, ts, vals1, store)


@pytest.mark.parametrize("exc", [dispatch.DeviceOpFailed, dispatch.DeviceUnavailable])
def test_consensus_stops_on_a_device_fault_in_a_vote(exc):
    """A failed vote flush is a consensus failure, not a dropped vote."""
    from cometbft_tpu_torch.consensus.state import ConsensusState

    async def add_vote(vote, peer_id):
        raise exc("device: injected")

    cs = types.SimpleNamespace(_add_vote=add_vote, logger=None)
    with pytest.raises(exc):
        asyncio.run(ConsensusState._try_add_vote(cs, object(), "peer"))

    async def bad_vote(vote, peer_id):
        raise ValueError("a bad vote")

    infos = []
    cs = types.SimpleNamespace(_add_vote=bad_vote, logger=types.SimpleNamespace(
        info=lambda *a, **k: infos.append(a)))
    assert asyncio.run(ConsensusState._try_add_vote(cs, object(), "peer")) is False
    assert infos


@pytest.mark.parametrize("exc", [dispatch.DeviceOpFailed, dispatch.DeviceUnavailable])
def test_block_sync_halts_typed_on_a_device_fault(exc):
    """The pool routine stops, names the fault in its log and in
    device_fault, and punishes nobody."""
    from cometbft_tpu_torch.blocksync.reactor import BlocksyncReactor

    errors, punished = [], []

    async def loop():
        raise exc("device: injected")

    async def punish(pid, reason):
        punished.append(pid)

    r = types.SimpleNamespace(_pool_loop=loop, device_fault=None, _punish=punish,
                              logger=types.SimpleNamespace(
                                  error=lambda msg, **k: errors.append((msg, k))))
    asyncio.run(BlocksyncReactor._pool_routine(r))
    assert r.device_fault.startswith(exc.__name__)
    assert errors and exc.__name__ in errors[0][1]["err"] and not punished
