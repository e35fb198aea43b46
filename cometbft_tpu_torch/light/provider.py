"""Light-block providers.

Reference: light/provider/provider.go (interface), light/provider/mock
(test double), light/provider/http (RPC-backed). Here are the interface,
the node-backed provider (duck-typed over a node's block, state and
certificate stores) and the deterministic in-memory provider used by tests
and the bench harness.

The port's copy of cometbft_tpu/light/provider.py. The RPC-backed provider
(light/rpc_provider.py), the serving fleet (light/fleet.py) and the proxy
(light/proxy.py) are the RPC serving plane and come in a later slice
(ROADMAP Queue 1).
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Optional

from cometbft_tpu_torch.types.light import LightBlock

from cometbft_tpu_torch.light.errors import ErrHeightTooHigh, ErrLightBlockNotFound


class Provider(ABC):
    """light/provider/provider.go:10-36."""

    @abstractmethod
    async def light_block(self, height: int) -> LightBlock:
        """Return the LightBlock at height (0 = latest). Raises
        ErrLightBlockNotFound / ErrHeightTooHigh / ErrBadLightBlock."""

    @abstractmethod
    async def report_evidence(self, ev) -> None:
        """Hand misbehavior proof to the provider's node."""

    def id_(self) -> str:
        return repr(self)


class NodeBackedProvider(Provider):
    """The fleet's primary on a serving node: wire-exact LightBlocks
    straight from the node's own stores — the rpc/core `light_block`
    route without the HTTP hop. `calls` counts fetches (the fleet's
    per-request bisection-budget accounting reads it)."""

    def __init__(self, node):
        self.node = node
        self.calls = 0

    async def light_block(self, height: int) -> LightBlock:
        from cometbft_tpu_torch.types.light import SignedHeader

        self.calls += 1
        n = self.node
        h = height or n.block_store.height()
        if height and height > n.block_store.height():
            raise ErrHeightTooHigh(
                f"node head is {n.block_store.height()}, want {height}")
        meta = n.block_store.load_block_meta(h)
        commit = (n.block_store.load_block_commit(h)
                  or n.block_store.load_seen_commit(h))
        vals = n.state_store.load_validators(h)
        if meta is None or commit is None or vals is None:
            raise ErrLightBlockNotFound(
                f"no light-block material at height {h}")
        return LightBlock(
            signed_header=SignedHeader(header=meta.header, commit=commit),
            validator_set=vals,
        )

    async def report_evidence(self, ev) -> None:
        pool = getattr(self.node, "evidence_pool", None)
        if pool is not None:
            pool.add_evidence(ev)

    async def commit_certificate(self, height: int):
        """The node's commit certificate at height, decoded, or None —
        the light client's short-circuit source (never raises; a missing
        certificate just means the per-vote path runs)."""
        plane = getattr(self.node, "cert_plane", None)
        if plane is None:
            return None
        try:
            raw = plane.serve(height)
            if raw is None:
                return None
            from cometbft_tpu_torch.cert import CommitCertificate

            return CommitCertificate.decode(raw)
        except Exception:  # noqa: BLE001 - absent/corrupt = no certificate
            return None

    def id_(self) -> str:
        return f"node:{getattr(getattr(self.node, 'node_info', None), 'moniker', '?')}"


class MemProvider(Provider):
    """light/provider/mock/mock.go: a provider over an in-memory chain map.
    Mutable so tests can fork it (serve conflicting headers past a height)."""

    def __init__(self, chain_id: str, blocks: dict[int, LightBlock], name: str = "mem"):
        self.chain_id = chain_id
        self.blocks = dict(blocks)
        self.name = name
        self.evidence: list = []
        self.fail_after: Optional[int] = None  # simulate a stalled provider
        # height -> CommitCertificate; tests populate to exercise the
        # light client's certificate short-circuit
        self.certs: dict[int, object] = {}
        self.cert_requests = 0

    async def commit_certificate(self, height: int):
        self.cert_requests += 1
        return self.certs.get(height)

    async def light_block(self, height: int) -> LightBlock:
        if self.fail_after is not None and height > self.fail_after:
            raise ErrLightBlockNotFound(f"{self.name}: no block at {height}")
        if height == 0:
            if not self.blocks:
                raise ErrLightBlockNotFound(f"{self.name}: empty chain")
            return self.blocks[max(self.blocks)]
        lb = self.blocks.get(height)
        if lb is None:
            if self.blocks and height > max(self.blocks):
                raise ErrHeightTooHigh(f"{self.name}: head is {max(self.blocks)}")
            raise ErrLightBlockNotFound(f"{self.name}: no block at {height}")
        return lb

    async def report_evidence(self, ev) -> None:
        self.evidence.append(ev)

    def id_(self) -> str:
        return self.name
