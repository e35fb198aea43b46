"""The port's verify scheduler (cometbft_tpu_torch/sched) on its "cpu"
backend: the cases of tests/test_sched.py that apply to one card with no
chaos site — masks in order, riders coalesced into an inline drain,
futures and deadline flushes, class priority, SchedulerSaturated
backpressure, the starvation guard, the bucket ladder, per-group recheck
budgets, a failing dispatch failing its futures and raising — plus the
crypto.batch routing and the health counters. Clocks are injected where a
case depends on time.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest
import torch

from cometbft_tpu.ops import ed25519_kernel as JK
from cometbft_tpu_torch import sched
from cometbft_tpu_torch.crypto import batch as crypto_batch
from cometbft_tpu_torch.crypto import ed25519, sr25519
from cometbft_tpu_torch.ops import challenge as TC
from cometbft_tpu_torch.ops import ed25519_kernel as TK
from cometbft_tpu_torch.ops import residency as TR
from cometbft_tpu_torch.sched.scheduler import (CONSENSUS, LIGHT, MEMPOOL, SYNC,
                                                VerifyScheduler)

FAR = 1e12  # a deadline no test reaches


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The plain versions' small tensors run faster on one intra-op thread,
    and the parallel test workers then do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fresh():
    sched.reset()
    sched.configure(enabled=True)
    crypto_batch.set_backend("cpu")
    yield
    sched.reset()
    sched.configure(enabled=True)
    crypto_batch.set_backend("gpu")
    TC.reset()
    TR.reset()


_PRIVS: dict = {}


def _priv(scheme: str, i: int):
    if (scheme, i) not in _PRIVS:
        mod = ed25519 if scheme == "ed25519" else sr25519
        _PRIVS[(scheme, i)] = mod.gen_priv_key_from_secret(b"sched-%s-%d" % (scheme.encode(), i))
    return _PRIVS[(scheme, i)]


def _rows(n: int, bad=frozenset(), scheme: str = "ed25519", tag: str = "r"):
    out = []
    for i in range(n):
        priv = _priv(scheme, i)
        msg = f"sched-{tag}-{i}".encode()
        out.append((priv.pub_key(), msg, priv.sign(msg if i not in bad else b"WRONG")))
    return out


class Clock:
    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


# ----------------------------------------------------------------- core


def test_masks_in_order():
    mask = sched.get().verify_now(_rows(6, bad={1, 4}), CONSENSUS)
    assert mask.tolist() == [True, False, True, True, False, True]


def test_verify_many_per_group_masks():
    m1, m2 = sched.get().verify_many([_rows(3), _rows(2, bad={0}, tag="g2")], SYNC)
    assert m1.tolist() == [True, True, True] and m2.tolist() == [False, True]
    assert sched.get().batches == 1


def test_mixed_schemes_one_batch_one_fetch():
    crypto_batch.reset_path_stats()
    rows = _rows(2) + _rows(2, scheme="sr25519") + _rows(1, bad={0}, tag="x")
    mask = sched.get().verify_now(rows, CONSENSUS)
    assert mask.tolist() == [True, True, True, True, False]
    assert sched.get().batches == 1
    fetch = crypto_batch.path_stats()["fetch"]
    assert fetch["full_fetches"] + fetch["happy_fetches"] == 1


def test_empty():
    assert sched.get().verify_many([[]], CONSENSUS)[0].tolist() == []
    assert sched.get().batches == 0


# ---------------------------------------------------------------- riders


def test_queued_mempool_rides_consensus_drain():
    s = sched.get()
    futs = s.submit(_rows(3, bad={2}, tag="m"), klass=MEMPOOL, deadline=FAR)
    assert not any(f.done() for f in futs)
    assert s.verify_now(_rows(2), CONSENSUS).tolist() == [True, True]
    assert s.batches == 1
    assert [f.result(timeout=1.0) for f in futs] == [True, True, False]
    h = s.health()
    assert h["class_rows"] == {CONSENSUS: 2, SYNC: 0, LIGHT: 0, MEMPOOL: 3}
    assert h["lanes_total"] == 8 and h["frag_lanes_total"] == 16
    assert h["fill_ratio_mean"] > h["fragmented_fill_ratio_mean"]


def test_rider_bigger_than_bucket_space_stays_queued():
    s = sched.get()
    s.max_lanes = 8
    futs = s.submit(_rows(8, tag="big"), klass=MEMPOOL, deadline=FAR)
    s.verify_now(_rows(2), CONSENSUS)
    assert not any(f.done() for f in futs)
    assert s.flush() == 8
    assert all(f.result(timeout=1.0) for f in futs)


def test_class_priority_fills_space_in_class_order():
    """Space for one 4-row rider beside 4 own rows at 8 lanes: of the queued
    mempool, light and sync groups the sync group rides."""
    clock = Clock()
    s = VerifyScheduler(max_lanes=8, clock=clock)
    try:
        m = s.submit(_rows(4, tag="m"), klass=MEMPOOL, deadline=FAR)
        lt = s.submit(_rows(4, tag="l"), klass=LIGHT, deadline=FAR)
        sy = s.submit(_rows(4, tag="s"), klass=SYNC, deadline=FAR)
        s.verify_now(_rows(4), CONSENSUS)
        assert all(f.done() for f in sy)
        assert not any(f.done() for f in m + lt)
        s.verify_now(_rows(4), CONSENSUS)
        assert all(f.done() for f in lt) and not any(f.done() for f in m)
        s.flush()
        assert all(f.result(0) for f in m)
    finally:
        s.stop()


# ------------------------------------------------------- futures, deadlines


def test_deadline_worker_flushes_when_the_clock_passes_the_deadline():
    clock = Clock(100.0)
    s = VerifyScheduler(mempool_deadline=0.01, clock=clock)
    try:
        futs = s.submit(_rows(2, tag="d"), klass=MEMPOOL)
        time.sleep(0.3)  # the injected clock stands still: the deadline is not due
        assert not any(f.done() for f in futs) and s.worker_flushes == 0
        clock.t = 100.02
        with s._cond:
            s._cond.notify_all()
        assert [f.result(timeout=30) for f in futs] == [True, True]
        assert s.worker_flushes == 1 and s.health()["worker_alive"]
        assert s.deadline_misses == 1  # flushed 0.01 after its deadline
    finally:
        s.stop()


def test_mempool_flushes_within_its_deadline():
    s = VerifyScheduler(mempool_deadline=0.02)
    try:
        futs = s.submit(_rows(2), klass=MEMPOOL)
        assert [f.result(timeout=30) for f in futs] == [True, True]
        assert s.worker_flushes == 1
    finally:
        s.stop()


def test_explicit_deadline_honored():
    fut = sched.get().submit(_rows(1), klass=SYNC, deadline=time.monotonic() + 0.01)[0]
    assert fut.result(timeout=30) is True


# ----------------------------------------------------------- backpressure


@pytest.mark.parametrize("first", [MEMPOOL, CONSENSUS])
def test_mempool_rejected_when_the_queues_are_full(first):
    s = VerifyScheduler(queue_limit=4)
    try:
        s.submit(_rows(4), klass=first, deadline=FAR)
        with pytest.raises(sched.SchedulerSaturated):
            s.submit(_rows(1, tag="x"), klass=MEMPOOL, deadline=FAR)
        assert s.health()["rejected"] == 1
        assert s.flush() == 4
    finally:
        s.stop()


def test_consensus_and_sync_never_rejected():
    s = VerifyScheduler(queue_limit=1)
    try:
        s.submit(_rows(3), klass=SYNC, deadline=FAR)
        s.submit(_rows(3, tag="c"), klass=CONSENSUS, deadline=FAR)
        assert s.health()["queue_depth"] == {CONSENSUS: 3, SYNC: 3, LIGHT: 0, MEMPOOL: 0}
        assert s.flush() == 6
    finally:
        s.stop()


# ------------------------------------------------------------ starvation


def test_overdue_mempool_promoted_over_fresh_sync():
    clock = Clock()
    s = VerifyScheduler(max_lanes=8, starvation_limit=0.1, clock=clock)
    try:
        old = s.submit(_rows(4, tag="old"), klass=MEMPOOL, deadline=FAR)
        clock.t = 1.0  # far past the starvation limit
        fresh = s.submit(_rows(4, tag="fresh"), klass=SYNC, deadline=FAR)
        s.verify_now(_rows(4), CONSENSUS)
        assert all(f.done() for f in old)
        assert not any(f.done() for f in fresh)
        s.flush()
    finally:
        s.stop()


# ---------------------------------------------------------------- buckets


def test_bucket_ladder_matches_the_kernels():
    s = sched.get()
    ladder = s.bucket_ladder(16384)
    assert ladder[:9] == [8, 16, 32, 64, 128, 256, 512, 1024, 2048]
    assert ladder[-1] == 16384 and len(ladder) == 16
    for b in ladder:
        assert TK.bucket_size(b) == b == JK.bucket_size(b)
    assert (s.bucket_lanes(3), s.bucket_lanes(129), s.bucket_lanes(2049)) == (8, 256, 4096)
    assert s.bucket_lanes(10_000) == 10_240


def test_dispatch_shapes_stay_on_the_ladder():
    s = sched.get()
    for n in (1, 7, 9, 17, 40, 3):
        s.verify_now(_rows(n, tag="shape"), CONSENSUS)
    h = s.health()
    assert h["dispatch_shapes"] == [8, 16, 32, 64]
    assert set(h["dispatch_shapes"]) <= set(s.bucket_ladder())


def test_chunks_at_max_lanes_and_never_splits_a_group():
    s = sched.get()
    s.max_lanes = 8
    f1 = s.submit(_rows(6, tag="a"), klass=MEMPOOL, deadline=FAR)
    f2 = s.submit(_rows(6, tag="b"), klass=MEMPOOL, deadline=FAR)
    assert s.flush() == 12 and s.batches == 2
    assert all(f.result(0) for f in f1 + f2)


def test_warmup_is_a_no_op_on_the_cpu_backend():
    assert sched.get().warmup() == []
    assert sched.get().stream() is None


# -------------------------------------------------------- recheck budgets


def test_each_group_keeps_its_own_recheck_budget(monkeypatch):
    """Group 1 has more bad signatures than one recheck budget; group 2 has
    a lane the (patched) kernel wrongly rejects. With a budget per group the
    host oracle rechecks group 2 and flips its lane back; one budget for the
    whole batch (34 failures) would recheck nothing."""
    n_bad = TK.RECHECK_MAX + 1
    g1 = _rows(n_bad, bad=set(range(n_bad)), tag="g1")
    g2 = _rows(3, tag="g2")
    wrong = n_bad + 1  # group 2's middle lane in the batch
    verify_raw = TK.ED25519.verify_raw

    def wrong_lane(*args):
        mask, allok = verify_raw(*args)
        mask = mask.clone()
        mask[wrong] = 0
        return mask, torch.zeros_like(allok)

    monkeypatch.setattr(TK, "ED25519", TK.ED25519._replace(verify_raw=wrong_lane))
    groups = sched.get().drain([g1, g2], SYNC)
    assert groups[0].mask.tolist() == [False] * n_bad and groups[0].flips == 0
    assert groups[1].mask.tolist() == [True, True, True] and groups[1].flips == 1
    assert sched.get().health()["recheck_flips"] == 1
    # the same rows as one client's group: one budget, 34 failures, no
    # recheck, and the wrong verdict stands
    v = crypto_batch.create_batch_verifier(g2[0][0])
    for row in g1 + g2:
        v.add(*row)
    ok, mask = v.verify()
    assert mask == [False] * n_bad + [True, False, True] and v.recheck_flips == 0
    # a client whose group fits the budget reports its own flip
    v = crypto_batch.create_batch_verifier(g2[0][0])
    for row in g1[:2] + g2:
        v.add(*row)
    monkeypatch.setattr(TK, "ED25519", TK.ED25519._replace(
        verify_raw=lambda *a: (lambda m, k: (m.index_fill(0, torch.tensor([3]), 0),
                                             torch.zeros_like(k)))(*verify_raw(*a))))
    ok, mask = v.verify()
    assert mask == [False, False, True, True, True] and v.recheck_flips == 1


def test_bad_riders_are_rechecked_on_the_worker_not_the_draining_thread(monkeypatch):
    """Mempool riders with bad signatures, and one lane the (patched) kernel
    wrongly rejects, ride a consensus drain: the drain returns the mask its
    rows get alone while the riders' host recheck is still held on the
    deadline worker, so the consensus caller never waits for it; released,
    the worker flips the wrongly rejected lane and resolves every future
    with its own verdict."""
    s = sched.get()
    own = _rows(4, bad={2}, tag="own")
    alone = s.verify_now(own, CONSENSUS).tolist()
    verify_raw = TK.ED25519.verify_raw
    wrong = 4 + 1  # the riders' second lane in the coalesced batch

    def wrong_lane(*args):
        mask, allok = verify_raw(*args)
        mask = mask.clone()
        mask[wrong] = 0
        return mask, torch.zeros_like(allok)

    release = threading.Event()
    ran_on: list[str] = []
    recheck = TK.recheck_failed_lanes

    def held(mask, eligible, pubs, msgs, sigs, verify_one):
        ran_on.append(threading.current_thread().name)
        if threading.current_thread() is not threading.main_thread():
            assert release.wait(30)
        return recheck(mask, eligible, pubs, msgs, sigs, verify_one)

    monkeypatch.setattr(TK, "ED25519", TK.ED25519._replace(verify_raw=wrong_lane))
    monkeypatch.setattr(TK, "recheck_failed_lanes", held)
    futs = s.submit(_rows(3, bad={0, 2}, tag="m"), klass=MEMPOOL, deadline=FAR)
    assert s.verify_now(own, CONSENSUS).tolist() == alone == [True, True, False, True]
    assert s.batches == 2 and not any(f.done() for f in futs)
    release.set()
    assert [f.result(timeout=30) for f in futs] == [False, True, False]
    assert ran_on == ["MainThread", "verify-sched"]
    h = s.health()
    assert h["deferred_rechecks"] == 1 and h["recheck_flips"] == 1
    assert h["class_rows"][MEMPOOL] == 3 and h["worker_flushes"] == 0


def test_apply_recheck_budget_per_group():
    rows = _rows(4, tag="ap")
    pubs = [r[0].bytes_() for r in rows]
    msgs = [r[1] for r in rows]
    sigs = [r[2] for r in rows]
    mask = np.array([False, True, False, True])
    eligible = np.ones(4, dtype=bool)
    got, flips = TK.apply_recheck(mask.copy(), eligible, (pubs, msgs, sigs),
                                  TK.ED25519.verify_one, [(0, 2), (2, 4)])
    assert got.tolist() == [True] * 4 and flips == 2
    got, flips = TK.apply_recheck(mask.copy(), eligible, (pubs, msgs, sigs),
                                  TK.ED25519.verify_one)
    assert got.tolist() == [True] * 4 and flips == 2


# --------------------------------------------------------------- failures


def test_failing_dispatch_fails_its_futures_and_raises(monkeypatch):
    """A flush split into two chunks: the failing chunk's futures fail, the
    other chunk still runs and resolves, then the error is raised."""
    s = sched.get()
    s.max_lanes = 8
    f1 = s.submit(_rows(6, tag="a"), klass=MEMPOOL, deadline=FAR)
    f2 = s.submit(_rows(6, tag="b"), klass=MEMPOOL, deadline=FAR)
    calls = {"n": 0}
    orig = VerifyScheduler._run_batch

    def flaky(self, groups):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("device went away")
        return orig(self, groups)

    monkeypatch.setattr(VerifyScheduler, "_run_batch", flaky)
    with pytest.raises(RuntimeError, match="device went away"):
        s.flush()
    assert all(f.done() for f in f1 + f2)
    with pytest.raises(RuntimeError):
        f1[0].result(0)
    assert all(f.result(0) for f in f2)


def test_worker_flush_failure_fails_futures_and_a_new_worker_serves_later_work(monkeypatch):
    clock = Clock(5.0)
    s = VerifyScheduler(clock=clock)
    orig = VerifyScheduler._run_batch
    fail = {"on": True}

    def flaky(self, groups):
        if fail["on"]:
            raise RuntimeError("launch failed")
        return orig(self, groups)

    monkeypatch.setattr(VerifyScheduler, "_run_batch", flaky)
    monkeypatch.setattr(threading, "excepthook", lambda args: None)
    try:
        futs = s.submit(_rows(2, tag="w"), klass=MEMPOOL, deadline=4.0)
        with pytest.raises(RuntimeError, match="launch failed"):
            futs[0].result(timeout=30)
        s._worker.join(timeout=30)
        assert not s.health()["worker_alive"]
        fail["on"] = False
        futs = s.submit(_rows(2, tag="w2"), klass=MEMPOOL, deadline=4.0)
        assert [f.result(timeout=30) for f in futs] == [True, True]
    finally:
        s.stop()


def test_unknown_key_type_raises():
    class Key(ed25519.PubKey):
        def type_(self):
            return "secp256k1"

    key = Key(_priv("ed25519", 0).pub_key().bytes_())
    from cometbft_tpu_torch import crypto

    with pytest.raises(crypto.ErrInvalidKey):
        sched.get().verify_now([(key, b"m", bytes(64))])


# ---------------------------------------------------------------- routing


def test_create_batch_verifier_routes_to_the_scheduler():
    pub = _priv("ed25519", 0).pub_key()
    assert type(crypto_batch.create_batch_verifier(pub)).__name__ == "ScheduledBatchVerifier"
    assert type(crypto_batch.create_mixed_batch_verifier()).__name__ == \
        "ScheduledBatchVerifier"
    sched.configure(enabled=False)
    assert type(crypto_batch.create_batch_verifier(pub)).__name__ == "CUDABatchVerifier"
    assert type(crypto_batch.create_mixed_batch_verifier()).__name__ == "MixedBatchVerifier"


def test_ambient_work_class_labels_the_group():
    rows = _rows(2)
    with sched.work_class(SYNC):
        assert sched.current_class() == SYNC
        v = crypto_batch.create_batch_verifier(rows[0][0])
    assert sched.current_class() == CONSENSUS
    for r in rows:
        v.add(*r)
    assert v.verify() == (True, [True, True])
    assert sched.get().health()["class_rows"][SYNC] == 2
    with pytest.raises(ValueError):
        with sched.work_class("bulk"):
            pass


def test_client_add_checks_signature_length():
    from cometbft_tpu_torch import crypto

    v = crypto_batch.create_batch_verifier(_priv("ed25519", 0).pub_key())
    with pytest.raises(crypto.ErrInvalidSignature):
        v.add(_priv("ed25519", 0).pub_key(), b"m", bytes(63))
    assert v.verify() == (True, []) and v.count() == 0


def test_configure_switches_the_routing_and_takes_no_knobs():
    # no knob outside the reference's six; those six reach the live
    # scheduler in place (the node's crypto.sched_* config)
    s = sched.get()
    with pytest.raises(ValueError):
        sched.configure(enabled=True, max_rows=64)
    sched.configure(max_lanes=64, mempool_deadline=0.02)
    assert s.max_lanes == 64 and s.class_deadline[MEMPOOL] == 0.02
    sched.configure(max_lanes=16384, mempool_deadline=0.010)
    sched.configure(enabled=False)
    assert not sched.enabled() and sched.health_snapshot()["enabled"] is False
    sched.configure(enabled=True)
    snap = sched.health_snapshot()
    assert snap["enabled"] is True and snap["max_lanes"] == 16384
    assert snap["deadlines"] == {CONSENSUS: 0.0, SYNC: 0.002, LIGHT: 0.004, MEMPOOL: 0.010}
    assert s.latency_quantiles()[CONSENSUS] is None


def test_concurrent_producers_lose_no_row(monkeypatch):
    """16 threads drain inline and submit with 1-ms deadlines at once, the
    interpreter switching threads every microsecond, against a batch that
    answers from the message: every mask and future gets its own rows'
    verdicts, and the counters add up to the rows handed in."""
    import sys

    def by_message(self, groups):
        return [np.array([m == b"ok" for m in g.rows.by_type["ed25519"][1]]) for g in groups]

    monkeypatch.setattr(VerifyScheduler, "_run_batch", by_message)
    s = VerifyScheduler(max_lanes=64, mempool_deadline=0.001)
    key = _priv("ed25519", 0).pub_key()
    errors: list = []
    total = [0]
    lock = threading.Lock()

    def producer(t: int) -> None:
        try:
            for j in range(25):
                rows = [(key, b"ok" if (t + j + k) % 3 else b"bad", b"s")
                        for k in range(1 + (t + j) % 5)]
                with lock:
                    total[0] += len(rows)
                if j % 2:
                    got = [f.result(timeout=30) for f in s.submit(rows, klass=MEMPOOL)]
                else:
                    got = s.verify_now(rows, CONSENSUS).tolist()
                if got != [m == b"ok" for _, m, _ in rows]:
                    errors.append((t, j))
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=producer, args=(t,)) for t in range(16)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
        s.stop()
    assert errors == []
    h = s.health()
    assert h["rows_total"] == total[0] == sum(h["class_rows"].values())
    assert h["queue_depth"] == {CONSENSUS: 0, SYNC: 0, LIGHT: 0, MEMPOOL: 0}
