"""The port's light fleet (light/fleet.py) against the JAX package's on the
CPU, on light chains carried into the port through their proto bytes.

- CheckpointCache: the skip lanes, nearest lookups, hit and miss counters,
  level-aware eviction and trust-period expiry of one sequence of puts;
- LightFleet.verify_height: concurrent requests for one height coalesce
  into one bisection with the same LightBlock bytes, provider fetches and
  counters; a later nearby height starts from the cached checkpoint; a
  validator-set pin serves or errors; a failed flight errors every waiter
  and the fleet recovers;
- saturation: a new unique height past fleet_max_inflight is shed, a
  duplicate is not;
- subscriptions: publish, from_height, backpressure and send budgets give
  the same heights, close reasons and counters.

Both packages verify on their "cpu" backends; latencies are left out of
every comparison.
"""

from __future__ import annotations

import asyncio

import pytest

from cometbft_tpu import light as jlight
from cometbft_tpu.light.provider import MemProvider as JMemProvider
from cometbft_tpu_torch import light as tlight
from cometbft_tpu_torch.light.provider import MemProvider as TMemProvider
from tests.torch_consumers import CHAIN, PERIOD_NS, Chain, fresh_backends

SIDES = {"jax": (jlight, JMemProvider), "port": (tlight, TMemProvider)}


@pytest.fixture(autouse=True)
def _fresh():
    yield from fresh_backends()


@pytest.fixture(scope="module")
def chain():
    """40 heights of 3 validators, all replaced every 10 heights by the
    next 3 (a hop trusts the next version only through its own set)."""
    return Chain(40, n_vals=3, churn_every=10, replace=1, tag=b"fleet")


def _blocks(side: str, chain) -> dict:
    return chain.blocks if side == "jax" else chain.port_blocks()


def _counting(side: str):
    MemProvider = SIDES[side][1]

    class Counting(MemProvider):
        def __init__(self, *a, delay: float = 0.0, **k):
            super().__init__(*a, **k)
            self.calls, self.delay = 0, delay
            self.gate: asyncio.Event | None = None  # fetches wait for it while set

        async def light_block(self, height):
            self.calls += 1
            if self.delay:
                await asyncio.sleep(self.delay)
            if self.gate is not None:
                await self.gate.wait()
            return await super().light_block(height)

    return Counting


def _fleet(side: str, blocks: dict, *, delay=0.0, **kw):
    light = SIDES[side][0]
    primary = _counting(side)(CHAIN, blocks, name="primary", delay=delay)
    opts = dict(cache_capacity=128, skip_base=4, trust_period_ns=PERIOD_NS,
                subscriber_queue=8, poll_interval=0.02)
    opts.update(kw)
    return light.LightFleet(
        CHAIN, primary, light.TrustOptions(period_ns=PERIOD_NS, height=1,
                                           hash_=blocks[1].hash()), **opts), primary


def _health(fleet) -> dict:
    h = fleet.health()
    h.pop("request_latency")
    return h


# --------------------------------------------------------- the skip-list cache


def _cache_script(side: str, chain) -> list:
    light = SIDES[side][0]
    blocks = _blocks(side, chain)
    out = []
    c = light.CheckpointCache(capacity=128, skip_base=4, trust_period_ns=PERIOD_NS)
    for h in (1, 3, 4, 8, 16, 20, 32):
        c.put(blocks[h])
    out.append([c.lane_heights(k) for k in range(4)])
    out.append([(lambda lb: lb and lb.height)(c.nearest_at_or_below(h))
                for h in (40, 31, 16, 7, 0)])
    out.append([c.get(h) is not None for h in (8, 9, 20, 21)] + [c.hits, c.misses, c.stats()])
    small = light.CheckpointCache(capacity=4, skip_base=4, trust_period_ns=PERIOD_NS)
    for h in (1, 10, 20, 30, 35, 40):
        small.put(blocks[h])
    out.append((small.size(), small.evictions, small.lane_heights(0), small.stats()))
    expired = light.CheckpointCache(capacity=16, trust_period_ns=1, skip_base=4)
    for h in (2, 4, 6):
        expired.put(blocks[h])
    out.append((expired.get(4), expired.nearest_at_or_below(9), expired.expired_pruned,
                expired.prune_expired(), expired.size()))
    return out


def test_checkpoint_cache_is_the_reference_s(chain):
    got = _cache_script("port", chain)
    assert got == _cache_script("jax", chain)
    assert got[0][1] == [4, 8, 16, 20, 32] and got[3][2][0] == 1


# ---------------------------------------------------------- verify_height


def _verify_script(side: str, chain) -> list:
    light = SIDES[side][0]
    blocks = _blocks(side, chain)

    async def main():
        out = []
        fleet, primary = _fleet(side, blocks, delay=0.002)
        await fleet.initialize()
        calls0 = primary.calls
        res = await asyncio.gather(*[fleet.verify_height(40) for _ in range(12)])
        out.append((primary.calls - calls0, {r.to_proto() for r in res} == {res[0].to_proto()},
                    res[0].to_proto(), _health(fleet)))
        warm = primary.calls
        lb = await fleet.verify_height(36)
        out.append((primary.calls - warm, lb.to_proto(), fleet.counters()))
        good = blocks[36].validator_set.hash()
        out.append((await fleet.verify_height(36, valset_hash=good)).height)
        try:
            await fleet.verify_height(36, valset_hash=b"\xee" * 32)
        except light.LightClientError as e:
            out.append(("pin", type(e).__name__, str(e)))
        primary.fail_after = 5
        try:
            await fleet.verify_height(25)
        except light.LightClientError as e:
            out.append(("failed", type(e).__name__))
        primary.fail_after = None
        out.append((await fleet.verify_height(25)).to_proto())
        out.append(_health(fleet))
        await fleet.stop()
        return out

    return asyncio.run(main())


def test_verify_height_coalesces_and_counts_as_the_reference(chain):
    got = _verify_script("port", chain)
    assert got == _verify_script("jax", chain)
    first = got[0][3]
    assert got[0][1] and first["verified"] == 1 and first["coalesced"] == 11
    assert got[0][2] == chain.blocks[40].to_proto()


def _saturation(side: str, chain) -> tuple:
    light = SIDES[side][0]
    blocks = _blocks(side, chain)

    async def main():
        fleet, primary = _fleet(side, blocks, max_inflight=1)
        await fleet.initialize()
        primary.gate = asyncio.Event()  # the first flight waits on its fetch
        t1 = asyncio.ensure_future(fleet.verify_height(30))
        await asyncio.sleep(0)
        t2 = asyncio.ensure_future(fleet.verify_height(30))
        await asyncio.sleep(0)
        try:
            await fleet.verify_height(15)
            shed = None
        except light.FleetSaturated as e:
            shed = str(e)
        primary.gate.set()
        r1, r2 = await asyncio.gather(t1, t2)
        h = _health(fleet)
        await fleet.stop()
        return shed, r1.to_proto() == r2.to_proto(), h

    return asyncio.run(main())


def test_saturation_sheds_new_heights_not_duplicates_as_the_reference(chain):
    got = _saturation("port", chain)
    assert got == _saturation("jax", chain)
    assert got[0] is not None and got[1] and got[2]["shed"] == 1


# ------------------------------------------------------------ subscriptions

SUBS = [
    ("backpressure", dict(subscriber_queue=2), (2, 3, 4), 0),
    ("budget", dict(subscriber_queue=8, send_budget=2), (2, 3, 4), 0),
    ("from_height", dict(subscriber_queue=8), (2, 3, 4, 5), 4),
]


def _subscription(side: str, chain, kw: dict, heights, from_height: int) -> list:
    light = SIDES[side][0]
    blocks = _blocks(side, chain)

    async def main():
        fleet, _ = _fleet(side, blocks, **kw)
        await fleet.initialize()
        sub = fleet.subscribe("client", from_height=from_height)
        for h in heights:
            fleet.publish(blocks[h])
        out = [sub.closed]
        for _ in range(len(heights) + 1):
            try:
                lb = await asyncio.wait_for(sub.next(), 0.2)
                out.append(lb.to_proto())
            except light.SubscriptionClosed as e:
                out.append(("closed", e.reason))
                break
            except asyncio.TimeoutError:
                out.append("idle")
                break
        out.append(_health(fleet))
        fleet.unsubscribe("client")
        out.append(fleet.health()["subscribers"])
        await fleet.stop()
        return out

    return asyncio.run(main())


@pytest.mark.parametrize("label,kw,heights,from_height", SUBS, ids=[s[0] for s in SUBS])
def test_subscription_streams_as_the_reference(chain, label, kw, heights, from_height):
    got = _subscription("port", chain, kw, heights, from_height)
    assert got == _subscription("jax", chain, kw, heights, from_height)
    if label != "from_height":
        assert ("closed", label) in got
    else:
        assert got[1] == chain.blocks[4].to_proto() and got[2] == chain.blocks[5].to_proto()
