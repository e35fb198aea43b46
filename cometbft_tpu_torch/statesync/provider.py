"""StateProvider: trusted bootstrap data via the light client.

Reference: statesync/stateprovider.go:29-200. AppHash/Commit/State come
from light-client-VERIFIED light blocks (every hop device-batch-verified);
the snapshot's claimed app hash is never trusted from the wire.

The port's copy of cometbft_tpu/statesync/provider.py.
"""

from __future__ import annotations

from abc import ABC, abstractmethod

from cometbft_tpu_torch.state.state import State


class StateProvider(ABC):
    """stateprovider.go:29-37."""

    @abstractmethod
    async def app_hash(self, height: int) -> bytes: ...

    @abstractmethod
    async def commit(self, height: int): ...

    @abstractmethod
    async def state(self, height: int) -> State: ...


class LightClientStateProvider(StateProvider):
    """stateprovider.go:40-200 over light.Client."""

    def __init__(self, light_client, initial_height: int = 1,
                 consensus_params=None):
        self.lc = light_client
        self.initial_height = initial_height or 1
        self._consensus_params = consensus_params
        self._initialized = False

    async def _ensure_init(self) -> None:
        """Subjective initialization happens on first use — at node boot
        the trust root's providers may not be reachable yet."""
        if not self._initialized:
            await self.lc.initialize()
            self._initialized = True

    async def app_hash(self, height: int) -> bytes:
        """The app hash AFTER `height` commits lives in header height+1;
        also probe height+2 so State() can't fail later
        (stateprovider.go:88-110)."""
        await self._ensure_init()
        lb = await self.lc.verify_light_block_at_height(height + 1)
        await self.lc.verify_light_block_at_height(height + 2)
        return lb.header.app_hash

    async def commit(self, height: int):
        await self._ensure_init()
        lb = await self.lc.verify_light_block_at_height(height)
        return lb.commit

    async def state(self, height: int) -> State:
        """stateprovider.go:124-186: snapshot height h -> last block h,
        current h+1, next h+2 (valset changes at h land at h+2)."""
        await self._ensure_init()
        last = await self.lc.verify_light_block_at_height(height)
        current = await self.lc.verify_light_block_at_height(height + 1)
        next_ = await self.lc.verify_light_block_at_height(height + 2)
        state = State(
            chain_id=self.lc.chain_id,
            initial_height=self.initial_height,
            last_block_height=last.height,
            last_block_time=last.time,
            last_block_id=last.commit.block_id,
            app_hash=current.header.app_hash,
            last_results_hash=current.header.last_results_hash,
            last_validators=last.validator_set,
            validators=current.validator_set,
            next_validators=next_.validator_set,
            last_height_validators_changed=next_.height,
        )
        if self._consensus_params is not None:
            state.consensus_params = self._consensus_params
        return state
