"""The port's light client (light/verifier.py, light/client.py,
light/store.py, light/provider.py) against the JAX package's on the same
seeded chains: every error path of verify_adjacent, verify_non_adjacent
(the coalesce DoS guard included) and verify_backwards with the same
exception class and first line; a Client bisection over a churning chain
with the same hops and stored heights, each non-adjacent hop one
prefetch_staged of two groups; a forged target; a witness serving a
conflicting header, with equal attack-evidence bytes; the trusted store.

The port runs on its "cpu" backend (the kernels' plain versions) through
its scheduler, the reference on its "cpu" backend.
"""

from __future__ import annotations

import asyncio
import dataclasses

import pytest

from cometbft_tpu import light as jlight
from cometbft_tpu.light import verifier as jverifier
from cometbft_tpu.light.store import LightStore as JLightStore
from cometbft_tpu.store.db import MemDB as JMemDB
from cometbft_tpu.types.block import Header
from cometbft_tpu.types.light import LightBlock, SignedHeader
from cometbft_tpu.types.validation import Fraction as JFraction
from cometbft_tpu.utils import cmttime
from cometbft_tpu_torch import light as tlight
from cometbft_tpu_torch.light import verifier as tverifier
from cometbft_tpu_torch.store import MemDB
from cometbft_tpu_torch.types import light as ttypes_light
from cometbft_tpu_torch.types import validation as tval
from tests.torch_consumers import (BASE_S, CHAIN, PERIOD_NS, Chain, block_id, fresh_backends,
                                   now, outcome, port_vals, priv, signed_commit, tamper_commit,
                                   valset)

DRIFT = 10 * 10**9


@pytest.fixture(autouse=True)
def _fresh():
    yield from fresh_backends()


@pytest.fixture(scope="module")
def chain():
    """240 heights of 6 validators, 3 replaced every 40 heights: a version
    trusts the next (half its signers are known) and not the one after."""
    return Chain(240, n_vals=6, churn_every=40, replace=3, tag=b"light")


class _Prefetches:
    """The groups of every prefetch_staged the port's verifier makes."""

    def __init__(self, monkeypatch):
        self.groups: list[int] = []
        orig = tverifier.prefetch_staged

        def spy(staged, klass=None):
            self.groups.append(sum(1 for s in staged if not s._passed and s._mask is None))
            return orig(staged, klass=klass)
        monkeypatch.setattr(tverifier, "prefetch_staged", spy)


def _t(lb: LightBlock) -> ttypes_light.LightBlock:
    return ttypes_light.LightBlock.from_proto(lb.to_proto())


def _both(fn_name, chain, jargs, period=PERIOD_NS, drift=DRIFT, **kw):
    """verifier.fn_name on the JAX package's light blocks and on the port's
    copies of them: the two outcomes. jargs is a list of LightBlocks (their
    signed headers and sets are passed as the function takes them)."""
    jnow, tnow = now(chain)
    outs = []
    for mod, conv, tnow_ in ((jverifier, lambda x: x, jnow), (tverifier, _t, tnow)):
        blocks = [conv(b) for b in jargs]
        if fn_name == "verify_adjacent":
            args = (blocks[0].signed_header, blocks[1].signed_header, blocks[1].validator_set)
        else:
            args = (blocks[0].signed_header, blocks[0].validator_set,
                    blocks[1].signed_header, blocks[1].validator_set)
        outs.append(outcome(getattr(mod, fn_name), *args, period, tnow_, drift, **kw))
    return outs


def _copy(lb: LightBlock, **header) -> LightBlock:
    sh = lb.signed_header
    return LightBlock(SignedHeader(dataclasses.replace(sh.header, **header), sh.commit),
                      lb.validator_set)


def _with_commit(lb: LightBlock, commit) -> LightBlock:
    return LightBlock(SignedHeader(lb.signed_header.header, commit), lb.validator_set)


@pytest.mark.parametrize("case", ["ok", "bad signature", "expired", "not adjacent",
                                  "invalid header", "time not after", "from the future",
                                  "other validator set", "next validators"])
def test_verify_adjacent_equals_reference(chain, case, monkeypatch):
    trusted, untrusted = chain.blocks[40], chain.blocks[41]
    kw = {}
    if case == "bad signature":
        untrusted = _with_commit(untrusted, tamper_commit(untrusted.commit, 2))
    elif case == "expired":
        kw["period"] = 10**9
    elif case == "not adjacent":
        untrusted = chain.blocks[42]
    elif case == "invalid header":
        untrusted = _copy(untrusted, app_hash=b"\x07" * 32)
    elif case == "time not after":
        trusted = _copy(trusted, time=untrusted.header.time)
    elif case == "from the future":
        kw["drift"] = -(10**12) * 1_000
    elif case == "other validator set":
        untrusted = LightBlock(untrusted.signed_header, chain.vals(200)[0])
    elif case == "next validators":
        trusted = _copy(trusted, next_validators_hash=b"\x08" * 32)
    spy = _Prefetches(monkeypatch)
    got, want = _both("verify_adjacent", chain, [trusted, untrusted], **kw)
    assert got == want
    assert (want == ("ok", None)) == (case == "ok")
    assert spy.groups == []


@pytest.mark.parametrize("case", ["ok", "bad signature", "cannot be trusted", "adjacent",
                                  "expired", "trust level"])
def test_verify_non_adjacent_equals_reference(chain, case, monkeypatch):
    trusted, untrusted = chain.blocks[10], chain.blocks[45]
    kw = {}
    if case == "bad signature":
        untrusted = _with_commit(untrusted, tamper_commit(untrusted.commit, 4))
    elif case == "cannot be trusted":
        untrusted = chain.blocks[85]
    elif case == "adjacent":
        untrusted = chain.blocks[11]
    elif case == "expired":
        kw["period"] = 10**9
    spy = _Prefetches(monkeypatch)
    if case == "trust level":  # 2/3 of the old set must have signed: 1/2 did
        outs = []
        jnow, tnow = now(chain)
        for mod, conv, n_, frac in ((jverifier, lambda x: x, jnow, JFraction(2, 3)),
                                    (tverifier, _t, tnow, tval.Fraction(2, 3))):
            a, b = conv(trusted), conv(untrusted)
            outs.append(outcome(mod.verify_non_adjacent, a.signed_header, a.validator_set,
                                b.signed_header, b.validator_set, PERIOD_NS, n_, DRIFT,
                                trust_level=frac))
        got, want = outs
    else:
        got, want = _both("verify_non_adjacent", chain, [trusted, untrusted], **kw)
    assert got == want
    assert (want == ("ok", None)) == (case == "ok")
    # both checks of a hop resolve in one prefetch of two groups
    assert spy.groups == ([2] if case in ("ok", "bad signature") else [])


def _big_set_hop(n_old: int, n_new: int, bad: str = ""):
    """A trusted header of n_old validators and an untrusted one of n_new
    (n_old of them the old set) at height 10, outside any chain. `bad`
    tampers one signature: "trust" the first old-set signer in commit
    order (a row of the trusting check), "new" the first other one."""
    privs = [priv("ed25519", b"dos", i) for i in range(n_new)]
    old, old_privs = valset(privs[:n_old])
    new, new_privs = valset(privs)
    blocks = []
    for h, vs, ps in ((2, old, old_privs), (10, new, new_privs)):
        header = Header(chain_id=CHAIN, height=h, time=cmttime.Timestamp(BASE_S + h, 0),
                        validators_hash=vs.hash(), next_validators_hash=vs.hash(),
                        consensus_hash=b"\x01" * 32, app_hash=b"\x02" * 32,
                        proposer_address=vs.validators[0].address)
        bid = block_id(b"dos-%d" % h)
        bid = type(bid)(header.hash(), bid.part_set_header)
        commit = signed_commit(ps, h, bid)
        if bad and h == 10:
            in_old = [old.has_address(v.address) for v in new.validators]
            commit = tamper_commit(commit, in_old.index(bad == "trust"))
        blocks.append(LightBlock(SignedHeader(header, commit), vs))
    return blocks


@pytest.mark.parametrize("n_new,bad", [(12, ""), (12, "trust"), (13, ""), (13, "trust"),
                                       (13, "new")])
def test_coalesce_guard_equals_reference(chain, n_new, bad, monkeypatch):
    """A new set more than 4x the trusted one pays the trusted-set check in
    full before the +2/3 check (the trust rows alone, then the new set's
    in a prefetch of one group) instead of one prefetch of both. A bad
    signature among the trust rows then raises from the first check."""
    blocks = _big_set_hop(3, n_new, bad)
    spy = _Prefetches(monkeypatch)
    got, want = _both("verify_non_adjacent", chain, blocks)
    assert got == want
    assert (want == ("ok", None)) == (not bad)
    if n_new <= 4 * 3:
        assert spy.groups == [2]
    else:
        assert spy.groups == ([] if bad == "trust" else [1])


@pytest.mark.parametrize("case", ["ok", "other chain", "not older", "hash mismatch",
                                  "invalid header"])
def test_verify_backwards_equals_reference(chain, case):
    old, new = chain.blocks[100].header, chain.blocks[101].header
    if case == "other chain":
        old = dataclasses.replace(old, chain_id="other-chain")
    elif case == "not older":
        old = dataclasses.replace(old, time=new.time)
    elif case == "hash mismatch":
        old = chain.blocks[99].header
    elif case == "invalid header":
        old = dataclasses.replace(old, height=0)
    from cometbft_tpu_torch.types.block import Header as THeader

    t_old, t_new = THeader.from_proto(old.to_proto()), THeader.from_proto(new.to_proto())
    got = outcome(tverifier.verify_backwards, t_old, t_new)
    assert got == outcome(jverifier.verify_backwards, old, new)
    assert (got == ("ok", None)) == (case == "ok")


def _clients(chain, witness_chain=None, trust_height=1, mode="skipping"):
    """The JAX package's client and the port's over the same chain, one
    witness each (the same chain unless another is given)."""
    witness_chain = witness_chain or chain
    jprim = jlight.MemProvider(CHAIN, chain.blocks, "primary")
    jwit = jlight.MemProvider(CHAIN, witness_chain.blocks, "witness")
    tprim = tlight.MemProvider(CHAIN, chain.port_blocks(), "primary")
    twit = tlight.MemProvider(CHAIN, witness_chain.port_blocks(), "witness")
    root = chain.blocks[trust_height].hash()
    jc = jlight.Client(CHAIN, jlight.TrustOptions(PERIOD_NS, trust_height, root), jprim, [jwit],
                       JLightStore(JMemDB()), verification_mode=mode)
    tc = tlight.Client(CHAIN, tlight.TrustOptions(PERIOD_NS, trust_height, root), tprim, [twit],
                       tlight.LightStore(MemDB()), verification_mode=mode)
    return jc, tc


def _run(client, chain, *heights):
    async def go():
        n = now(chain)[0 if isinstance(client, jlight.Client) else 1]
        await client.initialize(n)
        out = []
        for h in heights:
            try:
                out.append(("ok", (await client.verify_light_block_at_height(h, n)).hash()))
            except Exception as e:  # noqa: BLE001 - the outcome is compared
                out.append((type(e).__name__, str(e).split("\n")[0]))
        return out
    return asyncio.run(go())


def test_client_bisection_equals_reference(chain, monkeypatch):
    jc, tc = _clients(chain)
    spy = _Prefetches(monkeypatch)
    got = _run(tc, chain, 240, 130)
    assert got == _run(jc, chain, 240, 130)
    assert got[0] == ("ok", chain.blocks[240].hash())
    assert tc.store._heights == jc.store._heights
    assert tc.store.size() == jc.store.size() == len(spy.groups) + 1  # + the trust root
    # every non-adjacent hop: one prefetch of its two checks
    assert set(spy.groups) == {2}
    assert (tc.cert_hits, tc.cert_misses, tc.cert_fallbacks) == \
        (jc.cert_hits, jc.cert_misses, jc.cert_fallbacks)
    assert tc.store.latest_light_block().to_proto() == jc.store.latest_light_block().to_proto()


def test_sequential_and_backwards_equal_reference(chain, monkeypatch):
    jc, tc = _clients(chain, trust_height=120, mode="sequential")
    spy = _Prefetches(monkeypatch)
    got = _run(tc, chain, 122, 117)
    assert got == _run(jc, chain, 122, 117)
    assert [g[0] for g in got] == ["ok", "ok"]
    assert tc.store._heights == jc.store._heights == [117, 118, 119, 120, 121, 122]
    assert spy.groups == []  # adjacent hops verify their commit alone


@pytest.mark.parametrize("bad,want", [
    (1, "ErrInvalidCommitSignature"),  # a row of the trusting check: raised as it is
    (4, "ErrVerificationFailed"),  # a row of the +2/3 check only
    (5, "ok"),  # past +2/3: the light check stops before it
])
def test_forged_target_equals_reference(chain, bad, want):
    jc, tc = _clients(chain)
    jbad = _with_commit(chain.blocks[30], tamper_commit(chain.blocks[30].commit, bad))
    jc.primary.blocks[30] = jbad
    tc.primary.blocks[30] = _t(jbad)
    got = _run(tc, chain, 30)
    assert got == _run(jc, chain, 30)
    assert got[0][0] == want
    if want != "ok":
        assert "wrong signature" in got[0][1]
    assert tc.store._heights == jc.store._heights == ([1, 30] if want == "ok" else [1])


def test_witness_divergence_equal_evidence():
    honest = Chain(30, n_vals=4, tag=b"diverge")
    lying = honest.forked(20)
    jc, tc = _clients(honest, witness_chain=lying)
    got = _run(tc, honest, 30)
    assert got == _run(jc, honest, 30)
    assert got[0][0] == "ErrLightClientAttack"
    for side in ("primary", "witnesses"):
        tp = tc.primary if side == "primary" else tc.witnesses[0] if tc.witnesses else None
        jp = jc.primary if side == "primary" else jc.witnesses[0] if jc.witnesses else None
        if tp is None:
            assert jp is None
            continue
        assert [e.to_proto() for e in tp.evidence] == [e.to_proto() for e in jp.evidence]
    twit, jwit = tc.witnesses[0], jc.witnesses[0]
    assert len(jwit.evidence) == 1 and len(jc.primary.evidence) == 1
    assert [e.hash() for e in twit.evidence] == [e.hash() for e in jwit.evidence]
    # make_attack_evidence on the same three blocks
    jev = jlight.make_attack_evidence(lying.blocks[30], honest.blocks[30], honest.blocks[1])
    tev = tlight.make_attack_evidence(lying.port(30), honest.port(30), honest.port(1))
    assert tev.to_proto() == jev.to_proto() and tev.hash() == jev.hash()


def test_light_store_equals_reference(chain):
    jstore, tstore = JLightStore(JMemDB()), tlight.LightStore(MemDB())
    for h in (5, 3, 9, 7, 11):
        jstore.save_light_block(chain.blocks[h])
        tstore.save_light_block(chain.port(h))
    for h in (1, 4, 8, 12):
        tb, jb = tstore.light_block_before(h), jstore.light_block_before(h)
        assert (tb and tb.to_proto()) == (jb and jb.to_proto())
    assert tstore.light_block_by_hash(chain.blocks[7].hash()).height == 7
    tstore.prune(3)
    jstore.prune(3)
    assert tstore._heights == jstore._heights == [7, 9, 11]
    jnow, tnow = now(chain)
    later = type(tnow)(BASE_S + 10, 0)
    assert tstore.prune_expired(10**9, later) == jstore.prune_expired(
        10**9, type(jnow)(BASE_S + 10, 0))
    assert tstore._heights == jstore._heights
    assert outcome(tstore.save_light_block, dataclasses.replace(
        chain.port(3), signed_header=ttypes_light.SignedHeader(
            dataclasses.replace(chain.port(3).header, height=0), chain.port(3).commit)))[0] \
        == "ValueError"
    assert port_vals(chain.vals(5)[0]).hash() == chain.vals(5)[0].hash()
