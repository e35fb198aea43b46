"""The port's fault-domain verify mesh (cometbft_tpu_torch/parallel/mesh.py)
against the JAX package's (cometbft_tpu/parallel/mesh.py): the cases of
tests/test_mesh.py that need no node, on port domains [cpu] * k beside the
reference's VerifyMesh(jax.devices("cpu")[:k]), each under the same chaos
schedule and supervision knobs, in one process.

  fault matrix  the verify kernel stubbed to all-valid on both sides (the
                reference's _stub_kernels; the port's stub replaces K1/K2 in
                the Scheme record, so structural checks, the key tables, K5,
                K6, the header, the chaos sites, supervisors, breakers,
                redispatch and the fallback all run): kill mid-flush,
                half-open regrow, every domain dead, slots free after a
                kill, a flapping domain absorbed, a timeout redispatched.
                Masks and health() (churn counters and every domain's
                state and load) equal.
  placement     _plan's shard bounds over a grid of rows, classes, policies
                and live-domain counts, equal.
  scheduler     the scheduler's mesh routing: no lost futures under a kill,
                mixed schemes, the "cpu" backend never touching the mesh.
  real kernels  the kernels' plain versions on 2 domains (ed25519, sr25519,
                one BLS shard): masks equal the JAX package's exact oracle
                lane for lane, health() the reference mesh's on the same
                placement (its kernel stubbed: a real XLA verify program
                costs ~30 s a device on the CPU).

The reference's fallback is its single-chip ladder; where every domain
dies, its ladder is given the JAX package's exact oracle verdicts, and the
port's fallback runs its single-card path's plain versions.
"""

from __future__ import annotations

import functools
import time

import jax
import numpy as np
import pytest
import torch

from cometbft_tpu import sched as jsched
from cometbft_tpu.crypto import batch as jbatch
from cometbft_tpu.crypto import bls12381 as jbls
from cometbft_tpu.crypto import ed25519 as jed
from cometbft_tpu.crypto import ed25519_math as joracle
from cometbft_tpu.crypto import sr25519 as jsr
from cometbft_tpu.crypto import sr25519_math as jsrm
from cometbft_tpu.libs import chaos as JC
from cometbft_tpu.ops import dispatch as JD
from cometbft_tpu.parallel import mesh as JM
from cometbft_tpu_torch import sched as tsched
from cometbft_tpu_torch.crypto import batch as tbatch
from cometbft_tpu_torch.crypto import bls12381 as tbls
from cometbft_tpu_torch.crypto import ed25519 as ted
from cometbft_tpu_torch.crypto import sr25519 as tsr
from cometbft_tpu_torch.libs import chaos as TC
from cometbft_tpu_torch.ops import challenge as TCH
from cometbft_tpu_torch.ops import dispatch as TD
from cometbft_tpu_torch.ops import ed25519_kernel as TK
from cometbft_tpu_torch.ops import residency as TR
from cometbft_tpu_torch.parallel import mesh as TM

KNOBS = dict(failure_threshold=3, cooldown=30.0, retry_attempts=2, retry_base=0.0,
             retry_cap=0.0, watchdog_timeout=120.0)


def _reset_all():
    for chaos, d, m in ((JC, JD, JM), (TC, TD, TM)):
        chaos.reset()
        d.reset_supervision()
        d.configure(**KNOBS)
        m.reset()
        m.configure(enabled=True, min_devices=2, placement="class_aware")


@pytest.fixture(autouse=True)
def _clean():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    TR.reset()
    TCH.reset()
    _reset_all()
    jsched.reset()
    tsched.reset()
    jbatch.set_backend("cpu")
    tbatch.set_backend("cpu")
    yield
    _reset_all()
    jsched.reset()
    tsched.reset()
    jbatch.set_backend("cpu")
    tbatch.set_backend("gpu")
    TR.reset()
    TCH.reset()
    torch.set_num_threads(n)


class Side:
    """One package's chaos, supervision and mesh modules, and its domains."""

    def __init__(self, name: str):
        self.name = name
        if name == "jax":
            self.chaos, self.D, self.M = JC, JD, JM
        else:
            self.chaos, self.D, self.M = TC, TD, TM

    def mesh(self, k: int):
        devs = jax.devices("cpu")[:k] if self.name == "jax" else [torch.device("cpu")] * k
        vm = self.M.VerifyMesh(devs)
        self.M._set_for_testing(vm)
        return vm


SIDES = (Side("jax"), Side("torch"))


def _both(case):
    """case(side) on the reference, then on the port: (want, got)."""
    want = case(SIDES[0])
    _reset_all()
    got = case(SIDES[1])
    return want, got


def _all_valid(ax, ay, az, at, rw, sw, kw):
    b = ax.shape[1]
    return torch.ones(b, dtype=torch.int32), torch.ones(1, dtype=torch.int32)


def _oracle_thunk(scheme, pubs, msgs, sigs, **_):
    """The reference ladder's verdicts, from the JAX package's exact oracle
    (its real XLA program would cost ~30 s to instantiate here)."""
    one = {"ed25519": joracle.verify_zip215, "sr25519": jsrm.verify}[scheme]
    mask = np.array([one(p, m, s) for p, m, s in zip(pubs, msgs, sigs)], dtype=bool)
    return lambda: mask


@pytest.fixture
def stubbed(monkeypatch):
    """The verify kernel all-valid on both sides; the reference's ladder
    on the oracle. Everything else runs."""
    jreal = JM.VerifyMesh._scheme_ops
    treal = TM.VerifyMesh._scheme_ops

    def jfake(scheme):
        ops = dict(jreal(scheme))
        ops["kernel"] = lambda ax, ay, az, at, rw, sw, kw: (np.ones(rw.shape[1], dtype=bool),
                                                           True)
        ops["fallback_async"] = functools.partial(_oracle_thunk, scheme)
        return ops

    def tfake(scheme):
        ops = dict(treal(scheme))
        ops["launch"] = functools.partial(TK.verify_batch_async,
                                          ops["scheme"]._replace(verify_raw=_all_valid))
        return ops

    monkeypatch.setattr(JM.VerifyMesh, "_scheme_ops", staticmethod(jfake))
    monkeypatch.setattr(TM.VerifyMesh, "_scheme_ops", staticmethod(tfake))


def _sign_n(n, tag=b"mesh"):
    pubs, msgs, sigs = [], [], []
    rng = np.random.default_rng(n * 1000 + len(tag))
    for i in range(n):
        seed = rng.bytes(32)
        pubs.append(joracle.public_key_from_seed(seed))
        msgs.append(tag + b"-%d" % i)
        sigs.append(joracle.sign(seed, msgs[-1]))
    return pubs, msgs, sigs


def _swap_s(sigs, bad):
    n = len(sigs)
    for i in bad:
        sigs[i] = sigs[i][:32] + sigs[(i + 1) % n][32:]


# ---------------------------------------------------------- the fault matrix


def test_domain_killed_mid_flush_redispatches_on_survivors(stubbed):
    def case(S):
        vm = S.mesh(8)
        S.D.configure(failure_threshold=1)
        S.chaos.arm("ed25519.dispatch.dev3", "permanent")
        pubs, msgs, sigs = _sign_n(64)
        mask = vm.verify("ed25519", pubs, msgs, sigs, klass="sync")
        return mask.tolist(), vm.health(), S.chaos.fired("ed25519.dispatch.dev3")

    want, got = _both(case)
    assert got == want
    mask, h, fired = got
    assert all(mask) and fired == 1
    assert (h["evictions"], h["fallbacks"], h["live"]) == (1, 0, 7)
    assert h["redispatched_batches"] >= 1
    assert h["chips"]["3"]["state"] == TD.OPEN and h["chips"]["3"]["successes"] == 0


def test_half_open_reprobe_regrows_mesh_and_drops_only_its_tables(stubbed):
    def case(S):
        vm = S.mesh(4)
        S.D.configure(failure_threshold=1)
        pubs, msgs, sigs = _sign_n(32)
        out = [vm.verify("ed25519", pubs, msgs, sigs, klass="sync").tolist()]
        S.chaos.arm("ed25519.dispatch.dev1", "permanent", count=1)
        out.append(vm.verify("ed25519", pubs, msgs, sigs, klass="sync").tolist())
        out.append(vm.health())
        if S.name == "torch":  # dev1's key and prefix tables dropped at its eviction
            before = {k: t for per in TR._tables.values() for k, t in per.items()}
            prefix = {k[0]: t for k, t in TCH._tables.items()}
            assert set(before) == set(prefix) == {"dev0", "dev2", "dev3"}
        vm.chips[1].supervisor.breaker.cooldown = 0.0
        out.append(vm.verify("ed25519", pubs, msgs, sigs, klass="sync").tolist())
        out.append(vm.health())
        out.append(vm.verify("ed25519", pubs, msgs, sigs, klass="sync").tolist())
        if S.name == "torch":  # the probe's tables dropped at readmission, then built
            after = {k: t for per in TR._tables.values() for k, t in per.items()}
            prefix_after = {k[0]: t for k, t in TCH._tables.items()}
            assert set(after) == set(prefix_after) == {"dev0", "dev1", "dev2", "dev3"}
            for d in ("dev0", "dev2", "dev3"):
                assert after[d] is before[d] and prefix_after[d] is prefix[d]
            assert after["dev1"].counters["delta_rows"] == 8
        return out

    want, got = _both(case)
    assert got == want
    h3, h5 = got[2], got[4]
    assert (h3["live"], h3["evictions"]) == (3, 1)
    assert (h5["live"], h5["readmissions"], h5["chips"]["1"]["state"]) == (4, 1, TD.CLOSED)


def test_invalidate_device_drops_one_domains_tables():
    dev = torch.device("cpu")
    caches = [TK.PubKeyCache(dev), TK.PubKeyCache(dev)]
    for c in caches:
        for key in ("", "dev0", "dev1", "dev2"):
            TR.table_for(c, key)
    for key in ("", "dev1", "dev2"):
        TCH.table(key, dev)
    assert TR.invalidate_device(1) == 3  # two key tables, one prefix table
    assert [sorted(TR._tables[c]) for c in caches] == [["", "dev0", "dev2"]] * 2
    assert sorted(k[0] for k in TCH._tables) == ["", "dev2"]
    assert TR.invalidate_device(1) == 0


def test_all_domains_dead_falls_to_single_card_path(stubbed):
    def case(S):
        vm = S.mesh(2)
        S.D.configure(failure_threshold=1)
        S.chaos.arm("ed25519.dispatch.dev0", "permanent")
        S.chaos.arm("ed25519.dispatch.dev1", "permanent")
        pubs, msgs, sigs = _sign_n(8)
        _swap_s(sigs, [2])
        mask = vm.verify("ed25519", pubs, msgs, sigs, klass="sync")
        return mask.tolist(), vm.health()

    want, got = _both(case)
    assert got == want
    mask, h = got
    assert mask == [i != 2 for i in range(8)]
    assert (h["fallbacks"], h["evictions"]) == (1, 2)
    assert {c["state"] for c in h["chips"].values()} == {TD.OPEN}


def test_all_dead_fallback_failure_raises(stubbed, monkeypatch):
    """No CPU rung under the port's fallback: if the single-card path fails,
    the batch raises."""
    vm = SIDES[1].mesh(2)
    TD.configure(failure_threshold=1)
    TC.arm("ed25519.dispatch.dev0", "permanent")
    TC.arm("ed25519.dispatch.dev1", "permanent")

    def broken(*a, **k):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    real = TM.VerifyMesh._scheme_ops
    monkeypatch.setattr(TM.VerifyMesh, "_scheme_ops",
                        staticmethod(lambda s: dict(real(s), fallback=broken)))
    pubs, msgs, sigs = _sign_n(8)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        vm.verify("ed25519", pubs, msgs, sigs, klass="sync")
    assert vm.health()["fallbacks"] == 1


def test_domain_kill_mid_flush_leaves_every_slot_free(stubbed):
    def case(S):
        vm = S.mesh(4)
        S.D.configure(failure_threshold=1)
        S.chaos.arm("ed25519.dispatch.dev2", "permanent")
        pubs, msgs, sigs = _sign_n(32)
        mask = vm.verify("ed25519", pubs, msgs, sigs, klass="sync").tolist()
        stats = S.D.doublebuffer_stats()
        free = {d: S.D.doublebuffer(d)._sem._value for d in stats}
        return mask, vm.health(), sorted(stats), free

    want, got = _both(case)
    assert got == want
    mask, h, domains, free = got
    assert all(mask) and h["live"] == 3
    assert domains == ["dev0", "dev1", "dev3"]
    assert set(free.values()) == {2}


def test_flapping_domain_absorbed_without_oscillation(stubbed):
    def case(S):
        vm = S.mesh(4)
        S.chaos.arm("ed25519.dispatch.dev0", "transient", count=2)
        pubs, msgs, sigs = _sign_n(32)
        masks = [vm.verify("ed25519", pubs, msgs, sigs, klass="sync").tolist()
                 for _ in range(3)]
        return masks, vm.health(), vm.chips[0].supervisor.retries

    want, got = _both(case)
    assert got == want
    _, h, retries = got
    assert (h["evictions"], h["redispatched_batches"], h["live"]) == (0, 0, 4)
    assert h["chips"]["0"]["state"] == TD.CLOSED and retries == 2


def test_timeout_shard_redispatches(stubbed):
    def case(S):
        vm = S.mesh(4)
        S.D.configure(failure_threshold=1, retry_attempts=0)
        S.chaos.arm("ed25519.dispatch.dev2", "timeout", count=1)
        pubs, msgs, sigs = _sign_n(32)
        mask = vm.verify("ed25519", pubs, msgs, sigs, klass="sync").tolist()
        return mask, vm.health()

    want, got = _both(case)
    assert got == want
    assert all(got[0]) and got[1]["redispatched_batches"] == 1


def test_doublebuffer_fault_degrades_a_domain_not_its_verdicts(stubbed):
    def case(S):
        vm = S.mesh(2)
        S.chaos.arm("dispatch.doublebuf", "permanent", count=1)
        pubs, msgs, sigs = _sign_n(16)
        mask = vm.verify("ed25519", pubs, msgs, sigs, klass="sync").tolist()
        stats = S.D.doublebuffer_stats()
        return mask, vm.health(), sum(s["degraded"] for s in stats.values())

    want, got = _both(case)
    assert got == want
    assert all(got[0]) and got[2] == 1 and got[1]["evictions"] == 0


# ------------------------------------------------------------------ placement


@pytest.mark.parametrize("placement", ["class_aware", "spread", "pinned"])
def test_plan_shard_bounds_equal_reference(placement):
    jvm = JM.VerifyMesh(jax.devices("cpu")[:4], placement=placement)
    tvm = TM.VerifyMesh([torch.device("cpu")] * 4, placement=placement)
    # some load, so that the least-loaded order is not the index order
    for vm, lanes in ((jvm, (64, 0, 8, 8)), (tvm, (64, 0, 8, 8))):
        for c, n in zip(vm.chips, lanes):
            c.lanes_total = n
    for m in (1, 7, 8, 15, 16, 17, 100, 2047, 2048, 2049, 4096, 10000, 10138, 10240, 20000):
        for klass in ("consensus", "sync", "light", "mempool"):
            for live in (1, 2, 3, 4):
                want = [(c.index, lo, hi) for c, lo, hi in jvm._plan(m, klass, jvm.chips[:live])]
                got = [(c.index, lo, hi) for c, lo, hi in tvm._plan(m, klass, tvm.chips[:live])]
                assert got == want, (m, klass, live)
                assert sum(hi - lo for _, lo, hi in got) == m
                if live > 1:  # one live domain takes the whole batch
                    assert all(hi - lo <= TM.MAX_SHARD_ROWS for _, lo, hi in got)
    # a 10,240-row flush: five shards of 2,048 round robin, whatever the
    # policy (a pin holds to PIN_MAX_ROWS)
    plan = tvm._plan(10240, "sync", tvm.chips)
    assert [(c.index, hi - lo) for c, lo, hi in plan] == \
        [(1, 2048), (2, 2048), (3, 2048), (0, 2048), (1, 2048)]


def test_min_devices_and_health_snapshot():
    for S in SIDES:
        assert S.M.health_snapshot()["built"] is False
        assert S.M._mesh is None
        S.mesh(2)
        S.M.configure(min_devices=3)
        assert S.M.active() is None and S.M.peek_active() is None
        S.M.configure(min_devices=2)
        assert S.M.active() is not None and S.M.peek_active() is not None
        with pytest.raises(ValueError):
            S.M.configure(min_devices=0)
        with pytest.raises(ValueError):
            S.M.configure(placement="everywhere")
    snap = {S.name: S.M.health_snapshot() for S in SIDES}
    assert snap["torch"] == snap["jax"]
    # one card, no mesh installed: one domain, under min_devices
    TM.reset()
    assert len(TM.VerifyMesh([torch.device("cpu")]).chips) < 2


# ------------------------------------------------------- the scheduler routing


def _rows(mods, n, tag=b"sched-mesh", scheme="ed25519"):
    rows = []
    for i in range(n):
        priv = mods[scheme].gen_priv_key_from_secret(b"%s-%d" % (tag, i))
        msg = tag + b"-%d" % i
        rows.append((priv.pub_key(), msg, priv.sign(msg)))
    return rows


JMODS = {"ed25519": jed, "sr25519": jsr}
TMODS = {"ed25519": ted, "sr25519": tsr}


def _sched_side(S):
    if S.name == "jax":
        return jsched, jbatch, "tpu", JMODS
    return tsched, tbatch, "gpu", TMODS


def test_scheduler_flush_rides_mesh_and_loses_no_futures(stubbed):
    def case(S):
        sched, cbatch, backend, mods = _sched_side(S)
        sched.reset()
        vm = S.mesh(4)
        cbatch.set_backend(backend)
        S.D.configure(failure_threshold=1)
        S.chaos.arm("ed25519.dispatch.dev0", "permanent")
        try:
            # a far deadline: the rows ride the drain, not a worker flush
            futs = sched.get().submit(_rows(mods, 4, b"mempool"), klass=sched.MEMPOOL,
                                      deadline=time.monotonic() + 3600)
            mask = sched.get().verify_now(_rows(mods, 6), sched.CONSENSUS).tolist()
            results = [f.result(timeout=30.0) for f in futs]
        finally:
            cbatch.set_backend("cpu")
        sh = sched.get().health()
        return (mask, results, vm.health(), sh["mesh"], sh["effective_max_lanes"],
                sh["max_lanes"])

    want, got = _both(case)
    assert got == want
    mask, results, h, view, eff, lanes = got
    assert all(mask) and results == [True] * 4
    assert (h["evictions"], h["fallbacks"]) == (1, 0)
    assert view == {"active": True, "devices": 4, "live": 3, "placement": "class_aware"}
    assert eff == 3 * lanes


def _mixed(S, n_sr):
    sched, cbatch, backend, mods = _sched_side(S)
    sched.reset()
    vm = S.mesh(2)
    cbatch.set_backend(backend)
    try:
        rows = _rows(mods, 5) + _rows(mods, n_sr, b"mixed-sr", "sr25519")
        mask = sched.get().verify_now(rows, sched.CONSENSUS).tolist()
    finally:
        cbatch.set_backend("cpu")
    return mask, vm.health()


def test_mixed_scheme_batch_routes_both_kernels_through_mesh(stubbed):
    want, got = _both(lambda S: _mixed(S, 2))
    assert got == want
    mask, h = got
    assert all(mask) and (h["rows_total"], h["batches"], h["evictions"]) == (7, 2, 0)
    # one sr25519 row: the reference's staging raises on a 1-row batch
    # (ROADMAP Queue 3 item 12: its shards fail, it evicts both domains and
    # falls back); the port's shard verifies it on the mesh
    mask, h = _mixed(SIDES[1], 1)
    assert all(mask) and (h["rows_total"], h["evictions"], h["fallbacks"]) == (6, 0, 0)


def test_cpu_backend_never_touches_mesh():
    def case(S):
        sched, cbatch, _, mods = _sched_side(S)
        sched.reset()
        vm = S.mesh(4)
        cbatch.set_backend("cpu")
        mask = sched.get().verify_now(_rows(mods, 3), sched.CONSENSUS).tolist()
        return mask, vm.health()["batches"]

    want, got = _both(case)
    assert got == want == ([True] * 3, 0)


def test_scheduler_rider_recheck_through_mesh():
    """A bad mempool rider of a consensus drain through the mesh: the
    drain's own rows are rechecked in the join, the rider's rejected lane
    on the deadline worker, as on the single-card path (the port's
    departure, ROADMAP Queue 3 item 6); verdicts equal the oracle."""
    vm = SIDES[1].mesh(2)
    tbatch.set_backend("gpu")
    try:
        s = tsched.get()
        riders = _rows(TMODS, 2, b"rider")
        riders[1] = (riders[1][0], riders[1][1], riders[0][2])  # wrong signature
        futs = s.submit(riders, klass=tsched.MEMPOOL, deadline=time.monotonic() + 3600)
        mask = s.verify_now(_rows(TMODS, 6), tsched.CONSENSUS)
        assert mask.all()
        assert [f.result(timeout=60) for f in futs] == [True, False]
    finally:
        tbatch.set_backend("cpu")
    h = s.health()
    assert h["deferred_rechecks"] == 1 and h["recheck_flips"] == 0
    assert vm.health()["batches"] == 1 and vm.health()["rows_total"] == 8


# --------------------------------------------------------------- real kernels


def _jax_health(k, scheme, flows, monkeypatch):
    """The reference mesh's health() after `flows` [(rows, klass)], its
    kernel stubbed: the placement and churn the port must match."""
    real = JM.VerifyMesh._scheme_ops

    def fake(s):
        ops = dict(real(s))
        ops["kernel"] = lambda ax, ay, az, at, rw, sw, kw: (np.ones(rw.shape[1], dtype=bool),
                                                           True)
        return ops

    with monkeypatch.context() as mp:
        mp.setattr(JM.VerifyMesh, "_scheme_ops", staticmethod(fake))
        vm = SIDES[0].mesh(k)
        for rows, klass in flows:
            vm.verify(scheme, *rows, klass=klass)
        return vm.health()


def test_real_spread_verify_pinpoints_across_shards(monkeypatch):
    pubs, msgs, sigs = _sign_n(16)
    _swap_s(sigs, [1, 12])  # one lane in each domain's shard
    vm = SIDES[1].mesh(2)
    mask = vm.verify("ed25519", pubs, msgs, sigs, klass="sync")
    want = [joracle.verify_zip215(p, m, s) for p, m, s in zip(pubs, msgs, sigs)]
    assert mask.tolist() == want == [i not in (1, 12) for i in range(16)]
    assert vm.health() == _jax_health(2, "ed25519", [((pubs, msgs, sigs), "sync")],
                                      monkeypatch)
    assert [c["shards_total"] for c in vm.health()["chips"].values()] == [1, 1]


def test_real_consensus_pins_then_balances_and_matches_single_card(monkeypatch):
    pubs, msgs, sigs = _sign_n(8)
    msgs[4] = msgs[4] + b"!"
    pubs[3] = b"\x00" * 31  # bad length: never reaches the device
    sigs[0] = sigs[0][:32] + joracle.L.to_bytes(32, "little")  # s >= L
    vm = SIDES[1].mesh(2)
    got = [vm.verify("ed25519", pubs, msgs, sigs, klass="consensus").tolist()
           for _ in range(2)]
    single, _ = TK.verify_rows(TK.ED25519, pubs, msgs, sigs, device="cpu")
    want = [joracle.verify_zip215(p, m, s) if len(p) == 32 else False
            for p, m, s in zip(pubs, msgs, sigs)]
    assert got == [want, want] == [single.tolist()] * 2
    assert want == [i not in (0, 3, 4) for i in range(8)]
    h = vm.health()
    assert h == _jax_health(2, "ed25519", [((pubs, msgs, sigs), "consensus")] * 2, monkeypatch)
    assert [c["shards_total"] for c in h["chips"].values()] == [1, 1]


def test_real_sr25519_shards_across_domains(monkeypatch):
    privs = [tsr.gen_priv_key_from_secret(b"sr-mesh-%d" % i) for i in range(16)]
    pubs = [p.pub_key().bytes_() for p in privs]
    msgs = [b"sr-mesh-%d" % i for i in range(16)]
    sigs = [p.sign(m) for p, m in zip(privs, msgs)]
    sigs[9] = sigs[9][:32] + sigs[10][32:]
    vm = SIDES[1].mesh(2)
    mask = vm.verify("sr25519", pubs, msgs, sigs, klass="sync")
    want = [jsrm.verify(p, m, s) for p, m, s in zip(pubs, msgs, sigs)]
    assert mask.tolist() == want == [i != 9 for i in range(16)]
    assert vm.health() == _jax_health(2, "sr25519", [((pubs, msgs, sigs), "sync")],
                                      monkeypatch)


def test_real_bls_shard_on_a_domain():
    """One BLS shard (consensus: pinned) through ops/bls_kernel
    .mesh_shard_verify on the plain B1-B5 and K6; a wrong-message lane
    rejected and rechecked on the oracle, the JAX package's verdicts."""
    keys = [tbls.gen_priv_key_from_secret(b"mesh-bls-%d" % i) for i in range(2)]
    pubs = [k.pub_key().bytes_() for k in keys] * 2
    msgs = [b"bls-a", b"bls-b", b"bls-a", b"bls-c"]
    sigs = [keys[0].sign(b"bls-a"), keys[1].sign(b"bls-b"), keys[0].sign(b"bls-a"),
            keys[1].sign(b"bls-b")]
    vm = SIDES[1].mesh(2)
    batch = vm.verify_async("bls12381", pubs, msgs, sigs, klass="consensus")
    mask = batch()
    want = [jbls.PubKey(p).verify_signature(m, s) for p, m, s in zip(pubs, msgs, sigs)]
    assert mask.tolist() == want == [True, True, True, False]
    assert batch.flips == 0 and batch.eligible.tolist() == [True] * 4
    h = vm.health()
    assert [c["shards_total"] for c in h["chips"].values()] == [1, 0]
    assert (h["batches"], h["evictions"], h["fallbacks"]) == (1, 0, 0)
