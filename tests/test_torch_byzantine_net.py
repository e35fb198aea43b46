"""The port's byzantine validator harness (consensus/byzantine.py) in a
small in-process port net on the CPU (tests/torch_net_harness.py): val2
equivocates and val3 floods forged votes, and the honest nodes commit
DuplicateVoteEvidence against val2 and ban val3 through their peer
scorers (p2p/switch.PeerScorer, fed by the consensus misbehaviour hook).
"""

from __future__ import annotations

import asyncio

import pytest

import torch_net_harness as H
from tests.torch_consumers import fresh_backends
from cometbft_tpu_torch.consensus import byzantine as tbyz
from cometbft_tpu_torch.consensus.config import ConsensusConfig as TConfig
from cometbft_tpu_torch.p2p.switch import PeerScorer
from cometbft_tpu_torch.types.evidence import DuplicateVoteEvidence

CHAIN = "byz-net-chain"


def _config():
    """Timeouts of seconds: a plain batch costs ~1 s on the CPU."""
    return TConfig(timeout_propose=8.0, timeout_propose_delta=1.0, timeout_prevote=4.0,
                   timeout_prevote_delta=1.0, timeout_precommit=4.0,
                   timeout_precommit_delta=1.0, timeout_commit=0.05,
                   skip_timeout_commit=True, batch_vote_verification=True)


@pytest.fixture(autouse=True)
def _fresh():
    """The CPU backends on one torch thread (the plain batches run faster)."""
    yield from fresh_backends()


async def _until(cond, timeout: float, what: str, net) -> None:
    async def poll():
        while not cond():
            if net.failed():
                raise AssertionError(f"consensus failure on {net.failed()} waiting for {what}")
            await asyncio.sleep(0.05)

    await asyncio.wait_for(poll(), timeout)


def _evidence(node) -> list:
    out = []
    for h in range(1, node.block_store.height() + 1):
        out += [(h, ev) for ev in node.block_store.load_block(h).evidence.evidence]
    return out


def test_equivocation_commits_evidence_and_flood_gets_banned_in_a_cpu_net():
    """val2 equivocates and val3 floods forged votes in one 4-validator
    net: every honest node's chain carries DuplicateVoteEvidence against
    val2, each honest node's scorer bans val3, and the flood's forged
    votes are all rejected (its validator's power is never counted twice)."""
    async def run():
        net = await H.make_net(4, config=_config(), chain_id=CHAIN, device="cpu", seed=21)
        harness = {i: tbyz.make_byzantine(net.nodes[i].cs, b)
                   for i, b in ((2, "equivocation"), (3, "flood"))}
        scorers = {i: PeerScorer(ban_threshold=3.0) for i in range(2)}
        banned: dict[int, set] = {0: set(), 1: set()}
        reasons: dict[int, set] = {0: set(), 1: set()}

        def hook(i):
            def report(peer, reason):
                reasons[i].add(reason)
                if scorers[i].record(peer):
                    banned[i].add(peer)
            return report

        for i in scorers:
            net.nodes[i].cs.misbehavior_hook = hook(i)
        await net.start()
        for h in harness.values():
            await h.start()
        try:
            await _until(lambda: all(_evidence(net.nodes[i]) for i in (0, 1)), 150.0,
                         "committed evidence", net)
            await _until(lambda: all("val3" in banned[i] for i in (0, 1)), 60.0,
                         "val3's ban", net)
        finally:
            for h in harness.values():
                await h.stop()
            await net.stop()
        return net, harness, banned, reasons

    net, harness, banned, reasons = asyncio.run(run())
    liar = net.privs[2].pub_key().address()
    for i in (0, 1):
        evs = _evidence(net.nodes[i])
        assert evs and all(isinstance(ev, DuplicateVoteEvidence) for _, ev in evs)
        assert {ev.vote_a.validator_address for _, ev in evs} == {liar}
        assert banned[i] == {"val3"} and reasons[i] == {"invalid-vote-signature"}
    assert harness[2].equivocations >= 1 and harness[3].floods >= 4
    low = net.min_height()
    assert len({n.block_store.load_block(low).hash() for n in net.nodes}) == 1
